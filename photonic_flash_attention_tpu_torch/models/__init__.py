"""Models: GPT-2 and T5 (dense forwards and paged-KV serving steps)."""
