"""gemma3-12b [dense] — 48L d_model=3840 16H (GQA kv=8) d_ff=15360
vocab=262144, 5:1 local:global (1024 window), 128k, head dim 256.
Copy of ``repro/configs/gemma3_12b.py``.
[hf:google/gemma-3-12b-pt; unverified]"""
from repro_torch.configs.base import ModelConfig, local_global_stages

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    num_layers=48,
    d_model=3840,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=15360,
    vocab_size=262144,
    stages=local_global_stages(48, local_per_global=5, window=1024),
    qk_norm=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
    act="gelu",
    source="hf:google/gemma-3-12b-pt",
)
