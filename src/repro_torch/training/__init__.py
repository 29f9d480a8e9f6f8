"""AdamW in PyTorch, ported from ``repro.training``."""
