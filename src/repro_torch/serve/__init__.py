"""LM serving of the port: KV caches and the prefill/decode steps."""
