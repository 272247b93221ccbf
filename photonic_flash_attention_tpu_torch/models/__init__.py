"""Models: GPT-2 (dense oracle and paged-KV serving steps)."""
