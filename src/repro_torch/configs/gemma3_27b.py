"""gemma3-27b [dense] — 62L d_model=5376 32H (GQA kv=16) d_ff=21504
vocab=262144, 5:1 local:global interleave (1024-token sliding window),
128k context.  Copy of ``repro/configs/gemma3_27b.py``.
[hf:google/gemma-3-27b-pt; unverified]"""
from repro_torch.configs.base import ModelConfig, local_global_stages

CONFIG = ModelConfig(
    name="gemma3-27b",
    family="dense",
    num_layers=62,
    d_model=5376,
    num_heads=32,
    num_kv_heads=16,
    head_dim=128,
    d_ff=21504,
    vocab_size=262144,
    stages=local_global_stages(62, local_per_global=5, window=1024),
    qk_norm=True,
    rope_theta=1_000_000.0,
    logit_softcap=None,
    tie_embeddings=True,
    act="gelu",
    source="hf:google/gemma-3-27b-pt",
)
