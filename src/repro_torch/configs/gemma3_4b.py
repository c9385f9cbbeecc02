"""gemma3-4b — 5:1 local:global attention, 128k context
[hf:google/gemma-3-4b-pt; unverified tier].

34L d_model=2560 8H (GQA kv=4) d_ff=10240 vocab=262144, head_dim=256,
QK-norm, tied embeddings. local_global_period=6 => 5 local (window 1024)
+ 1 global per block.
"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    head_dim=256,
    d_ff=10240,
    vocab=262144,
    local_global_period=6,
    local_window=1024,
    use_qk_norm=True,
    tie_embeddings=True,
    rope_theta=1e6,
    loss_chunk=1024,  # 262k-vocab logits are CE'd in sequence chunks
)
