"""granite-4.0-h-small [hybrid] — 40L d_model=4096: 36 Mamba-2 mixers (128
heads x 64, d_state 128, one group, conv 4, chunk 256) and 4 GQA attention
layers without positions (32 heads over 8 KV heads, hd 128), at layers 5,
15, 25 and 35; an MoE FFN in every layer, 72 experts of 768 top-10 plus
one shared expert of 1536; tied vocabulary of 100352; the muP scalars
(embedding x 12, each mixer's and FFN's output x 0.22, attention scale
1/128, logits / 16).  A port-only configuration: the JAX package has no
NoPE and no muP scalars.
[hf:ibm-granite/granite-4.0-h-small]"""
from repro_torch.configs.base import (BlockSpec, ModelConfig, MoEConfig,
                                      SSMConfig, Stage)

# one period of ``layer_types``: attention at index 5
_PATTERN = tuple(BlockSpec("full" if i == 5 else "mamba", "moe")
                 for i in range(10))

CONFIG = ModelConfig(
    name="granite-4.0-h-small",
    family="hybrid",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=768,             # the expert width (config.json's intermediate_size)
    vocab_size=100352,
    stages=(Stage(pattern=_PATTERN, repeat=4),),
    moe=MoEConfig(num_experts=72, top_k=10, d_ff_expert=768, num_shared=1,
                  d_ff_shared=1536, capacity_factor=2.0),
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64, n_groups=1,
                  chunk=256),
    tie_embeddings=True,
    act="silu",
    norm_eps=1e-5,
    position_embedding="nope",
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.0078125,
    logits_scaling=16.0,
    source=("https://huggingface.co/ibm-granite/granite-4.0-h-small/blob/"
            "main/config.json"),
)
