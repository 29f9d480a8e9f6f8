"""llama3.1-8b — the paper's primary testbed backend (Sec. 4.1).
32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=128256.
Copy of ``repro/configs/llama31_8b.py``.  [arXiv:2407.21783]"""
from repro_torch.configs.base import ModelConfig, uniform_stage

CONFIG = ModelConfig(
    name="llama3.1-8b",
    family="dense",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=128256,
    stages=uniform_stage(32),
    rope_theta=500000.0,
    act="silu",
    source="arXiv:2407.21783",
)
