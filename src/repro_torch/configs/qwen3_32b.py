"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936 — qk_norm, GQA.
Copy of ``repro/configs/qwen3_32b.py``.  [hf:Qwen/Qwen3-32B; hf]"""
from repro_torch.configs.base import ModelConfig, uniform_stage

CONFIG = ModelConfig(
    name="qwen3-32b",
    family="dense",
    num_layers=64,
    d_model=5120,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab_size=151936,
    stages=uniform_stage(64),
    qk_norm=True,
    rope_theta=1_000_000.0,
    act="silu",
    source="hf:Qwen/Qwen3-32B",
)
