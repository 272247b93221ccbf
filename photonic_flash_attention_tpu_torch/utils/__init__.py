"""JAX-free helpers copied from ``photonic_flash_attention_tpu.utils``."""
