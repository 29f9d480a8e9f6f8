"""qwen2.5-14b — the paper's second testbed backend (Sec. 4.1).
48L d_model=5120 40H (GQA kv=8) d_ff=13824 vocab=152064.
Copy of ``repro/configs/qwen25_14b.py``.  [arXiv:2412.15115]"""
from repro_torch.configs.base import ModelConfig, uniform_stage

CONFIG = ModelConfig(
    name="qwen2.5-14b",
    family="dense",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=13824,
    vocab_size=152064,
    stages=uniform_stage(48),
    rope_theta=1_000_000.0,
    act="silu",
    source="arXiv:2412.15115",
)
