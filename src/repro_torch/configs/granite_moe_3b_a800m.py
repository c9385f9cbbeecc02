"""granite-moe-3b-a800m — fine-grained MoE, 40 experts top-8
[hf:ibm-granite/granite-3.0-3b-a800m-base; assigned spec].

32L d_model=1536 24H (GQA kv=8) d_ff=512(per-expert) vocab=49155, 40e top-8.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    n_layers=32,
    d_model=1536,
    n_heads=24,
    n_kv_heads=8,
    head_dim=64,
    d_ff=512,
    d_ff_expert=512,
    vocab=49155,
    n_experts=40,
    top_k=8,
)
