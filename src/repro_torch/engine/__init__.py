"""Serving engine of the port: paged KV cache and continuous batching."""
