"""llama-3.2-vision-90b — cross-attention image layers
[hf:meta-llama/Llama-3.2-90B-Vision; unverified tier].

100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256. Every 5th layer is
a gated cross-attention layer over vision tokens. The ViT frontend is a stub:
input_specs() provides precomputed patch embeddings (B, 1600, d_model).
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=28672,
    vocab=128256,
    cross_attn_period=5,   # 4 self-attn + 1 cross-attn, x20 blocks
    n_image_tokens=1600,
    rope_theta=500000.0,
    loss_chunk=1024,
)
