"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, 8 experts top-2, sliding-window attention (window 4096).
Copy of ``repro/configs/mixtral_8x22b.py``.  [arXiv:2401.04088; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig, uniform_stage

CONFIG = ModelConfig(
    name="mixtral-8x22b",
    family="moe",
    num_layers=56,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=16384,
    vocab_size=32768,
    stages=uniform_stage(56, mixer="window", ffn="moe", window=4096),
    moe=MoEConfig(num_experts=8, top_k=2, d_ff_expert=16384),
    rope_theta=1_000_000.0,
    act="silu",
    source="arXiv:2401.04088",
)
