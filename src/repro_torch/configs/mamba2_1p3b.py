"""mamba2-1.3b [ssm] — 48L d_model=2048 attn-free, ssm_state=128,
vocab=50280 — SSD (state-space duality).
Copy of ``repro/configs/mamba2_1p3b.py``.  [arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ModelConfig, SSMConfig, uniform_stage

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,          # unused (attn-free)
    num_kv_heads=1,
    head_dim=64,
    d_ff=0,
    vocab_size=50280,
    stages=uniform_stage(48, mixer="mamba", ffn="none"),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    tie_embeddings=True,
    act="silu",
    source="arXiv:2405.21060",
)
