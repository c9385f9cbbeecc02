"""K5 and K6 on the card, timed beside PyTorch's scaled_dot_product_attention.

    PYTHONPATH=src python -m repro_torch.launch.attention_times

Times ``ops.flash_attention`` (K5) at internlm2-1.8b's serving prefill (8
x 16 query over 8 KV heads x 1024 x 128, causal) in bf16 and in f32, and
at hymba-1.5b's (4 x 25 over 5 x 1024 x 64, causal, window 1024) and
llama-3.2-vision's cross-attention (4 x 64 x 1024 over 8 x 1600 image keys
x 128, unmasked) in bf16;
and ``ops.decode_attention`` (K6) at internlm2's serving decode (q 8 x 16
x 128 over an 8 x 8 x 1088 x 128 bf16 cache, lengths in [1024, 1088)).
Each beside its plain version and beside ``scaled_dot_product_attention``
on the same inputs, a yardstick the port never calls: under PyTorch's own
choice of backend (named by the device kernels that call launches), and
pinned to each of FLASH_ATTENTION, EFFICIENT_ATTENTION and CUDNN_ATTENTION
where that backend takes the inputs (None where it refuses them).

K6 reads ~36 MB of cache per call, which the H100's 50 MB L2 holds, while
a real decode step streams every layer's cache through it (~850 MB for
internlm2's 24 layers). So K6 and its yardstick are timed twice: warm (one
cache, called back to back) and cold (COLD_COPIES distinct caches, ~143 MB
together, called in turn, so that each call finds its cache evicted). The
bound is the HBM bytes of the visible K and V in both.

``main`` prints one JSON line per case. Needs a CUDA card.
"""
from __future__ import annotations

import itertools
import json
import subprocess
import time
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops, ref

# Published H100 SXM peaks (NVIDIA data sheet, at a 700 W power limit).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS_PER_S = 989e12
F32_FLOPS_PER_S = 67e12
COLD_COPIES = 4
# tries of a covered measurement, each behind a sleep twice as long
COVER_ATTEMPTS = 3
BACKENDS = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION")


def gpu_ms(fn: Callable[[], object], n: int, cover: bool = True) -> float:
    """Device time of one call of ``fn``, in ms: n calls between two CUDA
    events, queued behind a device sleep (at least ~0.1 s at the H100's
    clocks, and twice the host time one warm call predicts for the n) so
    that the host's enqueue time does not leave the device idle between
    them. A measurement whose enqueue outlasted the sleep is not kept: it
    is taken again behind a sleep twice as long, and after
    ``COVER_ATTEMPTS`` such tries this raises. ``cover=False`` drops the sleep, for a function
    that issues more operations than the card's launch queue holds (the
    enqueue then blocks until the sleep ends): the events then span the
    host's enqueue gaps too."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    # one warm call's host time (the first calls may load modules)
    t0 = time.perf_counter()
    fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    # ~2e6 sleep cycles per ms at the card's clocks
    cycles = int(max(200_000_000, 4e6 * host_ms * n))
    for attempt in range(COVER_ATTEMPTS if cover else 1):
        asleep, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        t0 = time.perf_counter()
        asleep.record()
        if cover:
            torch.cuda._sleep(cycles << attempt)
        start.record()
        for _ in range(n):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        end.synchronize()
        if not cover or enqueue_ms < asleep.elapsed_time(start):
            return start.elapsed_time(end) / n
    raise RuntimeError(
        f"enqueueing {n} calls took {enqueue_ms:.3f} ms, longer than the "
        f"{asleep.elapsed_time(start):.3f} ms device sleep meant to cover it, "
        f"{COVER_ATTEMPTS} times")


def device_kernels(fn: Callable[[], object]) -> list:
    """Names of the device kernels one call of ``fn`` launches (a trace
    that comes back empty, as one after an earlier profiler session in the
    same process may, is taken again, up to 3 times)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    names: set = set()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                     acc_events=True) as prof:
            fn()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        if names:
            break
    return sorted(names)


def backend_of(kernels: list, ms: float, pinned: Dict[str, Optional[float]]) -> str:
    """The SDPA backend whose kernels these are, by name; where no kernel
    was traced, the pinned backend whose time is nearest ``ms``, so marked."""
    if not kernels:
        timed = {k: v for k, v in pinned.items() if v is not None}
        if not timed:
            return "MATH (no other backend takes the inputs)"
        near = min(timed, key=lambda k: abs(timed[k] - ms))
        return f"{near} (nearest pinned time; no device kernel traced)"
    names = " ".join(kernels).lower()
    # the efficient backend's kernels are fmha_cutlass*; a plain GEMM may be
    # a cutlass kernel too, so "cutlass" alone names none
    for key, label in (("cudnn", "CUDNN_ATTENTION"), ("flash", "FLASH_ATTENTION"),
                       ("fmha", "EFFICIENT_ATTENTION")):
        if key in names:
            return label
    return "MATH"


def pinned_ms(fn: Callable[[], object], n: int) -> Dict[str, Optional[float]]:
    """``fn`` (one SDPA call) timed under each backend of BACKENDS alone;
    None where that backend refuses the inputs."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    out: Dict[str, Optional[float]] = {}
    for name in BACKENDS:
        with sdpa_kernel([getattr(SDPBackend, name)]):
            try:
                fn()
                torch.cuda.synchronize()
            except RuntimeError:
                out[name] = None
                continue
            out[name] = gpu_ms(fn, n)
    return out


def _randn(gen, *shape, dtype):
    return torch.randn(shape, device="cuda", generator=gen).to(dtype)


def flash_case(B: int, Hq: int, Hkv: int, S: int, D: int, window: int = 0,
               dtype=torch.bfloat16, seed: int = 1, reps=(20, 3, 50),
               Sk: Optional[int] = None, causal: bool = True):
    """K5 over q (B, Hq, S, D), k and v (B, Hkv, Sk, D) (Sk = S by
    default), causal (and ``window``, which must be 0 or cover the whole
    prompt, so that SDPA's plain causal call computes the same function),
    or with ``causal=False`` unmasked (cross-attention, Sk image keys).
    Returns (record, (got, want)): the kernel's and the plain version's
    outputs for the caller to check."""
    if 0 < window < S:
        raise ValueError("the SDPA yardstick has no sliding window: window must be 0 or >= S")
    Sk = S if Sk is None else Sk
    if causal and Sk != S:
        raise ValueError("a causal case takes Sk == S")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn(gen, B, Hq, S, D, dtype=dtype)
    k, v = _randn(gen, B, Hkv, Sk, D, dtype=dtype), _randn(gen, B, Hkv, Sk, D, dtype=dtype)
    kern = lambda: ops.flash_attention(q, k, v, causal=causal, window=window)  # noqa: E731
    plain = lambda: ref.attention_plain(q, k, v, causal=causal, window=window)  # noqa: E731
    lib = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q, k, v, is_causal=causal, enable_gqa=True)
    got, want = kern(), plain()
    item = q.element_size()
    nbytes = item * (2 * q.numel() + k.numel() + v.numel())
    # q k^T and p v, over the causal half where causal
    nops = 4 * B * Hq * S * Sk * D / (2 if causal else 1)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    peak = BF16_FLOPS_PER_S if dtype == torch.bfloat16 else F32_FLOPS_PER_S
    t_ops = nops / peak * 1e3
    kernels = device_kernels(lib)
    rec = {
        "shape": [B, Hq, Hkv, S, D] if Sk == S else [B, Hq, Hkv, S, Sk, D],
        "causal": causal, "window": window, "dtype": str(dtype).split(".")[-1],
        "ms": gpu_ms(kern, reps[0]), "plain_ms": gpu_ms(plain, reps[1]),
        "library_ms": gpu_ms(lib, reps[2]), "library_kernels": kernels,
        "library_pinned_ms": pinned_ms(lib, reps[2]),
        "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    rec["library_backend"] = backend_of(kernels, rec["library_ms"], rec["library_pinned_ms"])
    return rec, (got, want)


def decode_case(B: int = 8, Hq: int = 16, Hkv: int = 8, prompt: int = 1024,
                cap: int = 1088, D: int = 128, seed: int = 1, reps=(200, 20, 200)):
    """K6 at one decode step: q (B, Hq, D) over caches (B, Hkv, cap, D) in
    bf16, lengths drawn in [prompt, cap). Warm: one cache; cold: a rotation
    of COLD_COPIES caches. Returns (record, (got, want)) as flash_case."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn(gen, B, Hq, D, dtype=torch.bfloat16)
    caches = [(_randn(gen, B, Hkv, cap, D, dtype=torch.bfloat16),
               _randn(gen, B, Hkv, cap, D, dtype=torch.bfloat16)) for _ in range(COLD_COPIES)]
    lengths = torch.randint(prompt, cap, (B,), device="cuda", generator=gen,
                            dtype=torch.int32)
    mask = (torch.arange(cap, device="cuda")[None, :] < lengths[:, None])[:, None, None, :]
    turn = itertools.count()

    def kern(kc, vc):
        return ops.decode_attention(q, kc, vc, lengths, return_stats=True)

    def lib(kc, vc):
        return F.scaled_dot_product_attention(q[:, :, None], kc, vc, attn_mask=mask,
                                              enable_gqa=True)

    def warm(fn):
        return lambda: fn(*caches[0])

    def cold(fn):
        return lambda: fn(*caches[next(turn) % COLD_COPIES])

    got = kern(*caches[0])[0]
    want = ref.decode_attention_plain(q, *caches[0], lengths)
    visible = int(lengths.sum())
    nbytes = 2 * 2 * visible * Hkv * D + 2 * 2 * q.numel() + 4 * B + 2 * 4 * B * Hq
    nops = 4 * visible * Hq * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = nops / BF16_FLOPS_PER_S * 1e3
    kernels = device_kernels(warm(lib))
    rec = {
        "shape": [B, Hq, Hkv, cap, D], "visible": visible, "dtype": "bfloat16",
        "cold_copies": COLD_COPIES,
        "cold_bytes": COLD_COPIES * 2 * caches[0][0].numel() * 2,
        "ms": gpu_ms(warm(kern), reps[0]), "cold_ms": gpu_ms(cold(kern), reps[0]),
        "plain_ms": gpu_ms(lambda: ref.decode_attention_plain(
            q, *caches[0], lengths, return_stats=True), reps[1]),
        "library_ms": gpu_ms(warm(lib), reps[2]),
        "library_cold_ms": gpu_ms(cold(lib), reps[2]), "library_kernels": kernels,
        "library_pinned_ms": pinned_ms(warm(lib), reps[2]),
        "library_pinned_cold_ms": pinned_ms(cold(lib), reps[2]),
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
    }
    rec["library_backend"] = backend_of(kernels, rec["library_ms"], rec["library_pinned_ms"])
    return rec, (got, want)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("attention_times: no CUDA device is available")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cases = (("K5 internlm2 bf16", lambda: flash_case(8, 16, 8, 1024, 128)),
             ("K5 hymba bf16", lambda: flash_case(4, 25, 5, 1024, 64, window=1024)),
             ("K5 internlm2 f32", lambda: flash_case(8, 16, 8, 1024, 128,
                                                     dtype=torch.float32, reps=(5, 3, 20))),
             ("K5 llama-vision cross-attention bf16",
              lambda: flash_case(4, 64, 8, 1024, 128, Sk=1600, causal=False)),
             ("K6 internlm2 bf16", decode_case))
    for label, case in cases:
        rec, (got, want) = case()
        rec["max_abs_err"] = (got.double() - want.double()).abs().max().item()
        rec["card"] = smi
        print(json.dumps({label: rec}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
