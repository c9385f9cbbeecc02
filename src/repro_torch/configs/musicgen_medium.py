"""musicgen-medium — decoder-only transformer over EnCodec tokens
[arXiv:2306.05284; hf]. Backbone only: the EnCodec/conditioning frontend is a
stub; input_specs() provides precomputed frame embeddings (B, S, d_model).

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    family="audio",
    n_layers=48,
    d_model=1536,
    n_heads=24,
    n_kv_heads=24,
    head_dim=64,
    d_ff=6144,
    vocab=2048,
    embed_inputs=True,
)
