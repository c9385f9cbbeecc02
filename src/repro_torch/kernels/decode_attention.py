"""K6 wrapper: single-token decode attention over a KV cache, as one CUDA
kernel launch.

Counterpart of ``repro.kernels.decode_attention``. The kernel
(``csrc/decode_attention.cu``) cuts each (batch, KV head)'s cache into
n_split <= 8 chunks, one CTA each holding the G query rows of that KV head;
the chunks of a pair form one thread-block cluster, whose rank 0 merges
their partial (m, l, acc) through distributed shared memory and writes o,
m and l. One launch per call, counted as ``decode_attention`` in
``_build.LAUNCHES``; no scratch. The plain version is
``ref.decode_attention_plain``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8      # query rows per KV head the kernel holds in registers
MAX_HEAD_DIM = 256
MAX_SPLIT = 8      # CTAs per cluster (the portable cluster size)
#: Fewest cache positions per chunk.
MIN_CHUNK = 64


def split_plan(batch: int, kv_heads: int, capacity: int, sms: int) -> Tuple[int, int]:
    """The cluster plan (chunk, n_split): cut the cache length into n_split
    <= MAX_SPLIT chunks, one CTA each and one cluster per (batch, KV head),
    so that the launch has up to ~4 CTAs per SM on a card of ``sms`` SMs
    (batch 8 x 8 KV heads are 64 clusters of 8 for an H100's 132 SMs); each
    chunk a multiple of 16 positions and at least MIN_CHUNK, chunk x
    n_split >= capacity."""
    want = min(MAX_SPLIT, max(1, -(-4 * sms // max(batch * kv_heads, 1))))
    chunk = max(MIN_CHUNK, -(-capacity // want))
    chunk = -(-chunk // 16) * 16
    return chunk, max(1, -(-capacity // chunk))


def _aligned(t: torch.Tensor) -> torch.Tensor:
    # the kernel copies rows to shared memory in 16-byte pieces
    return t if t.data_ptr() % 16 == 0 else t.clone()


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                     lengths: torch.Tensor, *, sm_scale: Optional[float] = None,
                     window: int = 0):
    """q (B, Hq, D), caches (B, Hkv, S, D) on the card in one dtype (float32
    or bfloat16), lengths (B,) integer: the valid cache prefix of each
    sequence. Returns (o (B, Hq, D) in q's dtype, m (B, Hq) f32, l (B, Hq)
    f32), m in the pre-scaled-q domain as the TPU kernel's.

    Raises on anything the kernel does not take.
    """
    for name, t in (("q", q), ("k_cache", k_cache), ("v_cache", v_cache)):
        if t.device.type != "cuda" or t.dtype not in DTYPES:
            raise ValueError(
                f"decode_attention takes float32 or bfloat16 CUDA tensors, got "
                f"{name} {tuple(t.shape)} {t.dtype} on {t.device}")
    if q.ndim != 3 or k_cache.ndim != 4 or k_cache.shape != v_cache.shape:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} must be (B, Hq, D) and "
                         f"the caches {tuple(k_cache.shape)}, {tuple(v_cache.shape)} one "
                         f"(B, Hkv, S, D) shape")
    if not (q.dtype == k_cache.dtype == v_cache.dtype):
        raise ValueError("decode_attention: q and the caches must share a dtype")
    B, Hq, D = q.shape
    _, Hkv, S, _ = k_cache.shape
    if k_cache.shape[0] != B or k_cache.shape[3] != D:
        raise ValueError(f"decode_attention: q {tuple(q.shape)} and cache "
                         f"{tuple(k_cache.shape)} differ in batch or head dim")
    if Hkv == 0 or Hq % Hkv:
        raise ValueError(f"Hq={Hq} not a multiple of Hkv={Hkv}")
    if Hq // Hkv > MAX_GROUP or not 0 < D <= MAX_HEAD_DIM:
        raise ValueError(f"decode_attention: group {Hq // Hkv} (at most {MAX_GROUP}) or "
                         f"head dim {D} (at most {MAX_HEAD_DIM}) out of range")
    if lengths.shape != (B,) or lengths.dtype.is_floating_point:
        raise ValueError(f"decode_attention: lengths must be ({B},) integers, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")
    if lengths.device != q.device:
        raise ValueError(f"decode_attention: lengths on {lengths.device}, q on {q.device}")
    if window < 0:
        raise ValueError("window must be >= 0")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(D)
    q, k_cache, v_cache = (_aligned(t.contiguous()) for t in (q, k_cache, v_cache))
    lengths = lengths.to(torch.int32).contiguous()
    o = torch.empty_like(q)
    m = torch.empty((B, Hq), dtype=torch.float32, device=q.device)
    l = torch.empty_like(m)
    if not q.numel():
        return o, m, l
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chunk, n_split = split_plan(B, Hkv, S, sms)
    with torch.cuda.device(q.device):
        _build.launch("decode_attention", q.data_ptr(), k_cache.data_ptr(),
                      v_cache.data_ptr(), lengths.data_ptr(), o.data_ptr(), m.data_ptr(),
                      l.data_ptr(), B, Hq, Hkv, S, D, window, sm_scale, chunk, n_split,
                      DTYPES[q.dtype], torch.cuda.current_stream().cuda_stream)
    return o, m, l
