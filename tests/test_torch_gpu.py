"""Card-only tests of the PyTorch/CUDA port: each CUDA kernel against its
plain PyTorch version, the pipelined phases and schedule against the serial
ones bit for bit, the runtimes on the card against the CPU plain path, and
the LM serving paths (K5, K6; K7 for the ssm and hybrid kinds) on the card
against the same weights on the CPU. K5 is counted per form: the bf16 form
on the tensor cores as ``flash_attention``, the f32 form as
``flash_attention_f32``; K6 is one launch per call. Every test carries the ``gpu`` marker
and skips without a card.

Run on a machine with an NVIDIA card (the kernels build with nvcc at first
use):  PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports no JAX, so it also runs where JAX is not installed.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import KernelSpec, TaskGraph, get_runtime
from repro_torch.core.runtimes import pallas_step as ps
from repro_torch.configs.registry import get_config
from repro_torch.kernels import ops, ref
from repro_torch.kernels.flash_attention import ENTRY as K5_FORM  # form per dtype
from repro_torch.launch.serve import _grow_caches
from repro_torch.models.model import Model
from repro_torch.kernels.bodies import apply_body
from repro_torch.kernels.taskbench_step import (
    taskbench_step_blocked_plain,
    taskbench_step_plain,
)

pytestmark = pytest.mark.gpu

# K1: fmaf and multiply-then-add round alike (0.5*x is exact). K2/K3: sums
# in another order (the sweep's mean; the combine's fused multiply-adds).
TOL_K1 = 1e-6
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run with -m gpu on the card)")
    return torch.device("cuda")


def _rand(shape, seed, device):
    x = np.random.default_rng(seed).uniform(0.1, 1.0, shape).astype(np.float32)
    return torch.from_numpy(x).to(device)


@pytest.mark.parametrize("rows,payload", [(37, 13), (130, 64)])
@pytest.mark.parametrize("iterations", [0, 1, 16, 1024])
def test_fma_and_memory_kernels_match_plain(cuda, rows, payload, iterations):
    x = _rand((rows, payload), 0, cuda)
    got = ops.taskbench_compute(x, iterations)
    want = apply_body(x, "compute_bound", iterations, 0)
    assert (got - want).abs().max().item() <= TOL_K1
    got = ops.taskbench_memory(x, iterations, 200)
    want = apply_body(x, "memory_bound", iterations, 200)
    assert (got - want).abs().max().item() <= TOL


@pytest.mark.parametrize("combine", ["window", "gather", "onehot", "pair"])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 16),
                                             ("memory_bound", 3), ("empty", 0)])
@pytest.mark.parametrize("K", [1, 3])
def test_step_kernel_matches_plain(cuda, combine, kind, iterations, K):
    W, D, P = 45, 3, 13
    rng = np.random.default_rng(1)
    S = 2 * W if combine == "pair" else W + D - 1
    src = _rand((K, S, P), 2, cuda)
    idx = torch.from_numpy(rng.integers(0, S, (K, W, D), dtype=np.int32)).to(cuda)
    idx[:, ::2, 1] = idx[:, ::2, 0]  # duplicate slots
    wgt = _rand((K, W, D), 3, cuda) / D
    kw = dict(kind=kind, iterations=iterations, scratch=40, combine=combine)
    before = ops.launch_counts()["taskbench_step"]
    got = ops.taskbench_step(src, idx, wgt, **kw)
    assert ops.launch_counts()["taskbench_step"] == before + 1
    want = taskbench_step_plain(src, idx, wgt, **kw)
    assert got.shape == (K, W, P)
    assert (got - want).abs().max().item() <= TOL


def test_kernel_wrappers_raise_on_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="float32"):
        ops.taskbench_compute(torch.zeros(4, 4, dtype=torch.float64, device=cuda), 1)
    with pytest.raises(ValueError, match="float32"):
        ops.taskbench_memory(torch.zeros(4, 4, dtype=torch.int32, device=cuda), 1, 8)
    src = torch.zeros(1, 6, 4, device=cuda)
    with pytest.raises(ValueError, match="int32 idx"):
        ops.taskbench_step(src, torch.zeros(1, 4, 1, dtype=torch.int64, device=cuda),
                           torch.ones(1, 4, 1, device=cuda), combine="gather")


@pytest.mark.parametrize("pattern", ["stencil_1d", "nearest", "random_nearest", "trivial"])
def test_runtimes_on_card_match_cpu_plain_path(cuda, pattern):
    g = TaskGraph(steps=6, width=40, pattern=pattern, payload=16,
                  kernel=KernelSpec("compute_bound", 1), radius=3, seed=2)
    want = get_runtime("fused", device="cpu").execute(g)
    ops.reset_launch_counts()
    for combine in ("window", "gather", "onehot"):
        got = get_runtime("pallas_step", combine=combine).execute(g)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ops.launch_counts()["taskbench_step"] == 3 * g.steps
    got = get_runtime("fused", use_kernels=True).execute(g)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    assert ops.launch_counts()["taskbench_compute"] == g.steps


def test_memory_bound_runtimes_on_card(cuda):
    g = TaskGraph(steps=4, width=33, pattern="stencil_1d", payload=8,
                  kernel=KernelSpec("memory_bound", 3, scratch=20))
    want = get_runtime("fused", device="cpu").execute(g)
    for rt in (get_runtime("pallas_step"), get_runtime("fused", use_kernels=True)):
        np.testing.assert_allclose(rt.execute(g), want, atol=1e-5)


def _blocked_operands(combine, K, S, M, D, time_varying, seed, device):
    """Random K4 operands: duplicate slots, out-of-range slots (which the
    index rule wraps, clamps or drops) and an act mask with a masked tail
    and one frozen member."""
    rng = np.random.default_rng(seed)
    src = _rand((K, M, 13), seed, device)
    shape = (K, S, M, D) if time_varying else (K, M, D)
    idx = rng.integers(-2, M + 2, shape, dtype=np.int32)
    idx[..., ::2, 1] = idx[..., ::2, 0]
    wgt = rng.uniform(0, 1, shape).astype(np.float32) / D
    act = np.ones((K, S), np.float32)
    act[:, S - 1] = 0.0  # the masked tail of a run's last launch
    act[K - 1] = 0.0     # a frozen member
    return (src, torch.from_numpy(idx).to(device), torch.from_numpy(wgt).to(device),
            torch.from_numpy(act).to(device))


@pytest.mark.parametrize("combine,time_varying", [
    ("window", False), ("gather", False), ("onehot", False),
    ("gather", True), ("onehot", True)])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 16),
                                             ("memory_bound", 3), ("empty", 0)])
@pytest.mark.parametrize("S", [2, 5])
def test_blocked_kernel_matches_plain(cuda, combine, time_varying, kind, iterations, S):
    K, M, D = 3, 70, 5 if combine == "window" else 3
    src, idx, wgt, act = _blocked_operands(combine, K, S, M, D, time_varying, S, cuda)
    kw = dict(kind=kind, iterations=iterations, scratch=40, combine=combine)
    before = ops.launch_counts()["taskbench_blocked"]
    got = ops.taskbench_step(src, idx, wgt, act, steps_per_launch=S, **kw)
    assert ops.launch_counts()["taskbench_blocked"] == before + 1
    want = taskbench_step_blocked_plain(src, idx, wgt, act, **kw)
    assert got.shape == (K, M, 13)
    assert (got - want).abs().max().item() <= TOL
    assert torch.equal(got[K - 1], src[K - 1])  # the frozen member


@pytest.mark.parametrize("combine", ["gather", "onehot"])
def test_step_kernel_follows_the_index_rule(cuda, combine):
    """Out-of-range indices: gather wraps negatives once, then clamps;
    onehot drops the slot."""
    S, W = 6, 5
    src = _rand((1, S, 8), 4, cuda)
    idx = torch.tensor([[[-1, 0], [S, 1], [-S - 1, 2], [S + 3, -2], [-2, -2]]],
                       dtype=torch.int32, device=cuda)
    wgt = torch.full((1, W, 2), 0.5, device=cuda)
    kw = dict(kind="empty", iterations=0, combine=combine)
    got = ops.taskbench_step(src, idx, wgt, **kw)
    assert (got - taskbench_step_plain(src, idx, wgt, **kw)).abs().max().item() <= TOL
    s = src[0]
    if combine == "gather":
        want0 = (s[S - 1] + s[0]) * 0.5
    else:
        want0 = s[0] * 0.5
    assert (got[0, 0] - want0).abs().max().item() <= TOL


@pytest.mark.parametrize("combine", ["window", "gather", "onehot"])
@pytest.mark.parametrize("kind,iterations", [("compute_bound", 8), ("memory_bound", 2)])
def test_stitched_phases_equal_the_full_launch(cuda, combine, kind, iterations):
    g = TaskGraph(steps=9, width=40, pattern="random_nearest", payload=16,
                  kernel=KernelSpec(kind, iterations, scratch=40), radius=2, seed=1)
    rt = get_runtime("pallas_step", device=cuda, combine=combine)
    S, H = 3, 2
    depth = S * H
    idx, wgt, _, _ = (torch.from_numpy(a)[None].to(cuda)
                      for a in rt._blocked_operands(g, H))
    state = _rand((1, g.width, 16), 5, cuda)
    act = torch.ones((1, S), device=cuda)
    act[0, S - 1] = 0.0
    kw = dict(kind=kind, iterations=iterations, scratch=40, combine=combine,
              steps_per_launch=S)
    iext, wext = ps._extend_tables(idx, wgt, depth, combine, row_axis=1)
    ext = state.index_select(1, torch.from_numpy(ps._extend_rows(g.width, depth)).to(cuda))
    full = ops.taskbench_step(ext, iext, wext, act, **kw)[:, depth:depth + g.width]
    ph = ps._phase_tables(idx, wgt, depth, combine)
    hl, hr = ps._prologue_exchange(state, depth)
    for side in (None, torch.cuda.Stream()):
        stitched, _, _ = ps._pipelined_launch(state, hl, hr, act, ph, depth, kw, side)
        torch.cuda.synchronize()
        assert torch.equal(stitched, full)


@pytest.mark.parametrize("pattern", ["stencil_1d", "nearest", "random_nearest", "dom"])
@pytest.mark.parametrize("S", [2, 3, 8])
def test_pipelined_pallas_step_equals_serial_on_card(cuda, pattern, S):
    g = TaskGraph(steps=11, width=64, pattern=pattern, payload=16,
                  kernel=KernelSpec("compute_bound", 1), radius=2, seed=2)
    want = get_runtime("fused", device="cpu").execute(g)
    for combine in ("window", "gather", "onehot"):
        ops.reset_launch_counts()
        pipe = get_runtime("pallas_step", device=cuda, combine=combine,
                           steps_per_launch=S)
        got = pipe.execute(g)
        counts = ops.launch_counts()
        assert counts["taskbench_step"] + counts["taskbench_blocked"] == \
            pipe.dispatches_per_run(g)
        serial = get_runtime("pallas_step", device=cuda, combine=combine,
                             steps_per_launch=S, pipeline=False).execute(g)
        assert np.array_equal(got, serial)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ attention (K5, K6)
#
# Tolerances, against the plain version on the same inputs. f32: the same
# sums in another order (online softmax by tiles against one dense
# softmax; the K6 query pre-scaled before the product), atol 2e-5 on
# outputs of magnitude ~1. bf16: both compute in f32 (those sums, 2e-5
# apart) and round once to bf16, so each output is held to 2e-5 plus one
# bf16 ulp of its own plain value, 2^(floor(log2 |want|) - 7).


def _attn_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    tol = torch.full(want.shape, 2e-5, dtype=torch.float64, device=want.device)
    if want.dtype == torch.bfloat16:
        tol += torch.exp2(torch.floor(torch.log2(want.double().abs())) - 7)
    assert bool(((got.double() - want.double()).abs() <= tol).all())


def _normal(shape, seed, device, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(device=device, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5), (False, 70)])
@pytest.mark.parametrize("group,seq,D", [(1, 13, 16), (2, 100, 64), (4, 200, 128),
                                         (2, 65, 80), (1, 70, 256)])
def test_flash_kernel_matches_plain(cuda, dtype, causal, window, group, seq, D):
    q = _normal((2, 2 * group, seq, D), 1, cuda, dtype)
    k, v = _normal((2, 2, seq, D), 2, cuda, dtype), _normal((2, 2, seq, D), 3, cuda, dtype)
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    after = ops.launch_counts()
    for form in K5_FORM.values():
        assert after[form] == before[form] + (form == K5_FORM[dtype])
    _attn_close(got, ref.attention_plain(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("D", [64, 80, 128, 256])
@pytest.mark.parametrize("sq,sk,causal,window", [
    (130, 130, True, 0),    # neither a multiple of the 64-row or the key tile
    (200, 200, True, 64),   # the window edge on a tile edge
    (200, 200, True, 65),   # and one past it
    (97, 161, True, 33),    # Sq != Sk: rows past Sk see every key up to Sk
    (161, 97, True, 0),     # Sq > Sk: rows past Sk see all of k
    (70, 300, False, 0),    # no mask but the key length
    (300, 70, False, 130)])
def test_flash_tensor_core_form_at_served_widths(cuda, D, sq, sk, causal, window):
    """The bf16 form at every head dim a served config uses, with ragged
    lengths, causal and window edges and Sq != Sk."""
    q = _normal((2, 4, sq, D), D + sq, cuda, torch.bfloat16)
    k = _normal((2, 2, sk, D), D + sk + 1, cuda, torch.bfloat16)
    v = _normal((2, 2, sk, D), D + sk + 2, cuda, torch.bfloat16)
    before = ops.launch_counts()
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    after = ops.launch_counts()
    assert after["flash_attention"] == before["flash_attention"] + 1
    assert after["flash_attention_f32"] == before["flash_attention_f32"]
    _attn_close(got, ref.attention_plain(q, k, v, causal=causal, window=window))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("sq,sk", [(9, 40), (64, 200), (130, 129)])
def test_flash_kernel_with_other_query_and_key_lengths(cuda, dtype, sq, sk):
    q = _normal((1, 4, sq, 128), 4, cuda, dtype)
    k, v = _normal((1, 2, sk, 128), 5, cuda, dtype), _normal((1, 2, sk, 128), 6, cuda, dtype)
    for causal, window in ((True, 0), (False, 0), (True, 17)):
        _attn_close(ops.flash_attention(q, k, v, causal=causal, window=window, sm_scale=0.2),
                    ref.attention_plain(q, k, v, causal=causal, window=window, sm_scale=0.2))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 3, 300])
@pytest.mark.parametrize("group,S,D", [(1, 24, 16), (2, 1088, 128), (4, 300, 80),
                                       (8, 700, 64), (2, 40, 256),
                                       (2, 50, 20), (5, 33, 6)])  # rows copied by element
def test_decode_kernel_matches_plain(cuda, dtype, window, group, S, D):
    """o, m and l at lengths 0, 1, S - 1, S and one past S."""
    B, Hkv = 5, 2
    q = _normal((B, Hkv * group, D), 7, cuda, dtype)
    kc, vc = _normal((B, Hkv, S, D), 8, cuda, dtype), _normal((B, Hkv, S, D), 9, cuda, dtype)
    lengths = torch.tensor([0, 1, S - 1, S, S + 1], dtype=torch.int32, device=cuda)
    before = ops.launch_counts()
    o, m, l = ops.decode_attention(q, kc, vc, lengths, window=window, return_stats=True)
    after = ops.launch_counts()
    assert after["decode_attention"] == before["decode_attention"] + 1
    assert sum(after.values()) == sum(before.values()) + 1  # one launch, no combine
    wo, wm, wl = ref.decode_attention_plain(q, kc, vc, lengths, window=window,
                                            return_stats=True)
    _attn_close(o, wo)
    torch.testing.assert_close(m, wm, rtol=1e-5, atol=2e-5)
    torch.testing.assert_close(l, wl, rtol=1e-5, atol=2e-5)
    assert l[0].abs().max().item() == 0.0 and o[0].abs().max().item() == 0.0
    assert m[0].max().item() == np.float32(-1e30)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S,n_split", [(40, 1), (1088, 8)])
def test_decode_kernel_cluster_plan(cuda, dtype, S, n_split):
    """A cluster of one CTA (a short cache) and of eight (the serving
    cache), at the window's edges: lengths - window at 0, 1 and past S."""
    from repro_torch.kernels.decode_attention import split_plan

    B, Hkv, G, D = 3, 2, 2, 128
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    chunk, n = split_plan(B, Hkv, S, sms)
    assert n == n_split and chunk * n >= S
    q = _normal((B, Hkv * G, D), 16, cuda, dtype)
    kc, vc = _normal((B, Hkv, S, D), 17, cuda, dtype), _normal((B, Hkv, S, D), 18, cuda, dtype)
    window = 30
    lengths = torch.tensor([window, window + 1, S + 1], dtype=torch.int32, device=cuda)
    for w in (0, window):
        o, m, l = ops.decode_attention(q, kc, vc, lengths, window=w, return_stats=True)
        wo, wm, wl = ref.decode_attention_plain(q, kc, vc, lengths, window=w,
                                                return_stats=True)
        _attn_close(o, wo)
        torch.testing.assert_close(m, wm, rtol=1e-5, atol=2e-5)
        torch.testing.assert_close(l, wl, rtol=1e-5, atol=2e-5)


def test_attention_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(1, 3, 4, 16, device=cuda)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.flash_attention(x, x[:, :2], x[:, :2])
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention(*(torch.zeros(1, 2, 4, 24, device=cuda),) * 3)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(*(torch.zeros(1, 2, 4, 16, device=cuda, dtype=torch.float16),) * 3)
    c = torch.zeros(1, 1, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="group"):
        ops.decode_attention(torch.zeros(1, 9, 16, device=cuda), c, c,
                             torch.ones(1, dtype=torch.int32, device=cuda))


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "gemma3-4b"])
def test_reduced_serving_on_card_matches_cpu_and_counts_launches(cuda, arch):
    """One prefill and 3 decode steps of the reduced model (f32) on the card
    through K5 and K6, against the same weights on the CPU plain path: K5
    (its f32 form) launches n_layers times, K6 n_layers times per step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    cpu = Model(cfg, device="cpu", seed=3)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))).long()
    ops.reset_launch_counts()
    lg, cc = card.prefill(prompts.to(cuda))
    torch.cuda.synchronize()
    assert ops.launch_counts()["flash_attention_f32"] == cfg.n_layers
    want, pc = cpu.prefill(prompts)
    torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
    cc, pc = _grow_caches(card, cc, 2, 16), _grow_caches(cpu, pc, 2, 16)
    lengths = torch.full((2,), 12, dtype=torch.int32)
    tok = want.argmax(-1)[:, None]
    ops.reset_launch_counts()
    for _ in range(3):
        lg, cc = card.decode_step(tok.to(cuda), lengths.to(cuda), cc)
        want, pc = cpu.decode_step(tok, lengths, pc)
        torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
        tok, lengths = want.argmax(-1)[:, None], lengths + 1
    counts = ops.launch_counts()
    assert counts["decode_attention"] == 3 * cfg.n_layers
    assert counts["flash_attention"] == counts["flash_attention_f32"] == 0


def test_attention_kernels_at_hymba_shape(cuda):
    """GQA group 5 (25 query over 5 KV heads), head dim 64, window 1024:
    K5 over a 1100-token prompt, K6 at lengths around the window (one
    cluster of 8 CTAs per (batch, KV head))."""
    for dtype in (torch.float32, torch.bfloat16):
        q = _normal((2, 25, 1100, 64), 10, cuda, dtype)
        k, v = _normal((2, 5, 1100, 64), 11, cuda, dtype), _normal((2, 5, 1100, 64), 12,
                                                                   cuda, dtype)
        _attn_close(ops.flash_attention(q, k, v, causal=True, window=1024),
                    ref.attention_plain(q, k, v, causal=True, window=1024))
        lengths = torch.tensor([0, 1, 1023, 1024, 1025, 1100], dtype=torch.int32,
                               device=cuda)
        q6 = _normal((6, 25, 64), 13, cuda, dtype)
        kc, vc = _normal((6, 5, 1100, 64), 14, cuda, dtype), _normal((6, 5, 1100, 64), 15,
                                                                     cuda, dtype)
        o, m, l = ops.decode_attention(q6, kc, vc, lengths, window=1024, return_stats=True)
        wo, wm, wl = ref.decode_attention_plain(q6, kc, vc, lengths, window=1024,
                                                return_stats=True)
        _attn_close(o, wo)
        torch.testing.assert_close(m, wm, rtol=1e-5, atol=2e-5)
        torch.testing.assert_close(l, wl, rtol=1e-5, atol=2e-5)


# ----------------------------------------------------------- SSD (K7), RMSNorm (K8)
#
# Tolerances, against the plain version on the same inputs. Both compute in
# f32 (the kernel's FMAs from shared memory against the plain version's
# einsums: the same sums in another order), so an output is held to 2e-5
# of the output's scale, max(1, max |plain|); a bf16 y is rounded once from
# those f32 sums, so it also gets one bf16 ulp of its own plain value.


def _scaled_close(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    tol = 2e-5 * max(1.0, want.double().abs().max().item())
    tol = torch.full(want.shape, tol, dtype=torch.float64, device=want.device)
    if want.dtype == torch.bfloat16:
        tol += torch.exp2(torch.floor(torch.log2(want.double().abs())) - 7)
    assert bool(((got.double() - want.double()).abs() <= tol).all())


def _ssd_inputs(BC, H, G, T, N, P, seed, device, dtype):
    rng = np.random.default_rng(seed)
    x, b, c = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(device, dtype)
               for s in ((BC, H, T, P), (BC, G, T, N), (BC, G, T, N)))
    dt = rng.uniform(0.001, 0.1, (BC, H, T)).astype(np.float32)
    dta = dt * -rng.uniform(1.0, 16.0, (1, H, 1)).astype(np.float32)
    dta[:, :, ::7] = -35.0  # a decay that underflows: must stay finite
    return x, b, c, torch.from_numpy(dta).to(device), torch.from_numpy(dt).to(device)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("BC,H,G,T,N,P", [
    (4, 24, 1, 128, 128, 64),  # mamba2-130m's chunk
    (2, 50, 1, 128, 16, 64),   # hymba-1.5b's
    (3, 4, 2, 5, 8, 8),        # a 5-token prompt, two groups
    (2, 6, 2, 100, 16, 8),     # T not a multiple of the 64-row tile
    (1, 2, 1, 17, 128, 64)])
def test_ssd_chunk_kernel_matches_plain(cuda, dtype, BC, H, G, T, N, P):
    args = _ssd_inputs(BC, H, G, T, N, P, T + N + G, cuda, dtype)
    before = ops.launch_counts()["ssd_chunk"]
    y, state = ops.ssd_chunk(*args)
    assert ops.launch_counts()["ssd_chunk"] == before + 1
    wy, ws = ref.ssd_chunk_plain(*args)
    assert y.dtype == dtype and state.dtype == torch.float32
    _scaled_close(y, wy)
    _scaled_close(state, ws)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("rows,d", [(8192, 768), (37, 1000), (5, 33)])
def test_rmsnorm_kernel_matches_plain(cuda, dtype, rows, d):
    rng = np.random.default_rng(rows + d)
    x = torch.from_numpy(rng.standard_normal((rows, d)).astype(np.float32)).to(cuda, dtype)
    for w_dtype in (torch.float32, torch.bfloat16):
        w = torch.from_numpy(rng.standard_normal(d).astype(np.float32)).to(cuda, w_dtype)
        before = ops.launch_counts()["rmsnorm"]
        got = ops.rmsnorm(x, w, 1e-5)
        assert ops.launch_counts()["rmsnorm"] == before + 1
        _scaled_close(got, ref.rmsnorm_plain(x, w, 1e-5))


def test_ssd_and_rmsnorm_wrappers_raise_on_what_they_do_not_take(cuda):
    x = torch.zeros(1, 3, 4, 8, device=cuda)
    b = torch.zeros(1, 2, 4, 8, device=cuda)
    d = torch.zeros(1, 3, 4, device=cuda)
    with pytest.raises(ValueError, match="not a multiple"):
        ops.ssd_chunk(x, b, b, d, d)
    with pytest.raises(ValueError, match="share"):
        ops.ssd_chunk(x, b[:, :1].bfloat16(), b[:, :1], d, d)
    with pytest.raises(RuntimeError, match="ssd_chunk failed to launch"):
        big = torch.zeros(1, 1, 512, 512, device=cuda)  # tiles beyond shared memory
        ops.ssd_chunk(big, big, big, torch.zeros(1, 1, 512, device=cuda),
                      torch.zeros(1, 1, 512, device=cuda))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.rmsnorm(torch.zeros(2, 4, device=cuda, dtype=torch.float16),
                    torch.ones(4, device=cuda))


@pytest.mark.parametrize("arch", ["mamba2-130m", "hymba-1.5b"])
def test_reduced_ssm_serving_on_card_matches_cpu_and_counts_launches(cuda, arch):
    """One prefill (12 tokens, chunk 8: two chunks) and 3 decode steps of the
    reduced model (f32) on the card, against the same weights on the CPU
    plain path: K7 launches n_layers times in the prefill and never in
    decode; hymba also K5 n_layers times, and K6 per layer and step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(arch).reduced()
    hybrid = arch == "hymba-1.5b"
    cpu = Model(cfg, device="cpu", seed=3)
    card = Model(cfg, device=cuda)
    card.load_state_dict(cpu.state_dict())
    prompts = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 12))).long()
    ops.reset_launch_counts()
    lg, cc = card.prefill(prompts.to(cuda))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    assert counts["ssd_chunk"] == cfg.n_layers
    assert counts["flash_attention_f32"] == (cfg.n_layers if hybrid else 0)
    want, pc = cpu.prefill(prompts)
    torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
    cc, pc = _grow_caches(card, cc, 2, 16), _grow_caches(cpu, pc, 2, 16)
    lengths = torch.full((2,), 12, dtype=torch.int32)
    tok = want.argmax(-1)[:, None]
    ops.reset_launch_counts()
    for _ in range(3):
        lg, cc = card.decode_step(tok.to(cuda), lengths.to(cuda), cc)
        want, pc = cpu.decode_step(tok, lengths, pc)
        torch.testing.assert_close(lg.cpu(), want, rtol=1e-4, atol=1e-4)
        tok, lengths = want.argmax(-1)[:, None], lengths + 1
    counts = ops.launch_counts()
    assert counts["ssd_chunk"] == counts["flash_attention_f32"] == 0
    k6 = 3 * cfg.n_layers if hybrid else 0
    assert counts["decode_attention"] == k6
