"""musicgen-medium [audio] — 48L d_model=1536 24H (GQA kv=24, i.e. MHA)
d_ff=6144 vocab=2048 — decoder-only over EnCodec tokens.  The EnCodec
frontend is a stub: the model takes precomputed conditioning frame
embeddings (64 prefix vectors) through ``prefix_proj``.
Copy of ``repro/configs/musicgen_medium.py``.  [arXiv:2306.05284; hf]"""
from repro_torch.configs.base import ModelConfig, uniform_stage

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab_size=2048,
    stages=uniform_stage(48),
    frontend="audio_stub",
    n_prefix_embeds=64,
    rope_theta=10000.0,
    act="gelu",
    source="arXiv:2306.05284",
)
