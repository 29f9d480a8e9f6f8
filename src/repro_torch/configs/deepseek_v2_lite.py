"""deepseek-v2-lite-16b [moe] — 27L d_model=2048 16H d_ff=1408 (per
routed expert) vocab=102400; MLA kv_lora=512 (+64 rope dim); 2 shared +
64 routed experts, top-6.  First layer uses a dense FFN (d_ff=10944).
Copy of ``repro/configs/deepseek_v2_lite.py``.  [arXiv:2405.04434; hf]"""
from repro_torch.configs.base import (BlockSpec, MLAConfig, ModelConfig,
                                      MoEConfig, Stage)

CONFIG = ModelConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,      # MLA: all heads share the latent cache
    head_dim=192,         # nope(128) + rope(64)
    d_ff=10944,           # dense FFN of layer 0
    vocab_size=102400,
    stages=(
        Stage(pattern=(BlockSpec("mla", "dense"),), repeat=1),
        Stage(pattern=(BlockSpec("mla", "moe"),), repeat=26),
    ),
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared=2, d_ff_shared=2816),
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128,
                  v_head_dim=128),
    rope_theta=10000.0,
    act="silu",
    source="arXiv:2405.04434",
)
