"""internvl2-1b [vlm] — 24L d_model=896 14H (GQA kv=2) d_ff=4864
vocab=151655 — InternViT frontend + InternLM2/Qwen2-0.5B-like backbone.
The ViT frontend is a stub: the model takes precomputed patch embeddings
(256 prefix vectors) through ``prefix_proj``.
Copy of ``repro/configs/internvl2_1b.py``.  [arXiv:2404.16821; hf]"""
from repro_torch.configs.base import ModelConfig, uniform_stage

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    head_dim=64,
    d_ff=4864,
    vocab_size=151655,
    stages=uniform_stage(24),
    frontend="vision_stub",
    n_prefix_embeds=256,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    act="silu",
    source="arXiv:2404.16821",
)
