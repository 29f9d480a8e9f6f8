"""minicpm-2b [dense] — 40L d_model=2304 36H (GQA kv=36, i.e. MHA)
d_ff=5760 vocab=122753 — llama-like arch, WSD schedule.
Copy of ``repro/configs/minicpm_2b.py``.  [arXiv:2404.06395; hf]"""
from repro_torch.configs.base import ModelConfig, uniform_stage

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    num_layers=40,
    d_model=2304,
    num_heads=36,
    num_kv_heads=36,
    head_dim=64,
    d_ff=5760,
    vocab_size=122753,
    stages=uniform_stage(40),
    rope_theta=10000.0,
    tie_embeddings=True,
    act="silu",
    lr_schedule="wsd",
    source="arXiv:2404.06395",
)
