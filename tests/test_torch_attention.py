"""The port's attention kernels' plain versions against the JAX package.

K5 (``ops.flash_attention`` -> ``ref.attention_plain`` on the CPU) against
``repro.kernels.flash_attention.flash_attention_pallas`` in interpret mode
and ``repro.kernels.ref.attention_ref``; K6 (``ops.decode_attention`` ->
``ref.decode_attention_plain``) against ``decode_attention_pallas`` in
interpret mode and ``decode_attention_ref(return_stats=True)``: o, m and l.
Inputs are drawn with numpy from a seed and handed to both.

Tolerance, f32: atol=2e-5, rtol=1e-5 — the same sums taken in another
order (blockwise online softmax against one dense softmax, and the TPU
kernel's pre-scaled q against scaling after the product).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import split_plan

ATOL, RTOL = 2e-5, 1e-5


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=ATOL, rtol=RTOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("group", [1, 2, 4])
@pytest.mark.parametrize("seq", [13, 40])
def test_flash_plain_matches_pallas_and_ref(causal, window, group, seq):
    rng = np.random.default_rng(seq * 100 + group * 10 + window + causal)
    B, Hkv, D = 2, 2, 16
    q = _rand(rng, (B, Hkv * group, seq, D))
    k, v = _rand(rng, (B, Hkv, seq, D)), _rand(rng, (B, Hkv, seq, D))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, window=window)
    assert got.shape == q.shape and got.dtype == torch.float32
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                       interpret=True))
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal, window=window))


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 5)])
def test_flash_plain_with_fewer_queries_than_keys(causal, window):
    """Sq < Sk: the row index starts at 0 with no offset, as the reference's."""
    rng = np.random.default_rng(7)
    q = _rand(rng, (1, 4, 9, 16))
    k, v = _rand(rng, (1, 2, 40, 16)), _rand(rng, (1, 2, 40, 16))
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal, window=window,
                              sm_scale=0.3)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    _close(got, flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                       sm_scale=0.3, interpret=True))
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal, window=window,
                                   sm_scale=0.3))


@pytest.mark.parametrize("window", [0, 3])
@pytest.mark.parametrize("group", [1, 2, 4])
def test_decode_plain_matches_pallas_and_ref(window, group):
    """o, m and l, at lengths 0 (nothing visible), 1, S - 1 and S (full)."""
    rng = np.random.default_rng(window * 10 + group)
    B, Hkv, S, D = 4, 2, 24, 16
    q = _rand(rng, (B, Hkv * group, D))
    kc, vc = _rand(rng, (B, Hkv, S, D)), _rand(rng, (B, Hkv, S, D))
    lengths = np.array([0, 1, S - 1, S], np.int32)
    o, m, l = ops.decode_attention(torch.from_numpy(q), torch.from_numpy(kc),
                                   torch.from_numpy(vc), torch.from_numpy(lengths),
                                   window=window, return_stats=True)
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lengths))
    for want in (decode_attention_pallas(*jargs, window=window, interpret=True),
                 jref.decode_attention_ref(*jargs, window=window, return_stats=True)):
        for g, w in zip((o, m, l), want):
            _close(g, w)
    assert float(l[0].abs().max()) == 0.0 and float(o[0].abs().max()) == 0.0
    assert torch.equal(ops.decode_attention(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.from_numpy(lengths), window=window), o)


def test_use_kernel_false_takes_the_plain_version():
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(_rand(rng, (1, 2, 8, 16))) for _ in range(3))
    assert torch.equal(ops.flash_attention(q, k, v, use_kernel=False),
                       ref.attention_plain(q, k, v))
    lengths = torch.tensor([5], dtype=torch.int32)
    got = ops.decode_attention(q[:, :, 0], k, v, lengths, use_kernel=False,
                               return_stats=True)
    want = ref.decode_attention_plain(q[:, :, 0], k, v, lengths, return_stats=True)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    jax.block_until_ready(jnp.zeros(1))  # JAX stays on the CPU here
    assert jax.default_backend() == "cpu"


def test_split_plan_covers_the_cache():
    """The cluster plan: n_split <= 8 chunks (a portable cluster) that cover
    the cache, each a multiple of 16 positions; the serving decodes take
    clusters of 8, a short cache a cluster of one."""
    for B, Hkv, S in ((8, 8, 1088), (1, 1, 5), (2, 2, 30), (64, 8, 32768), (4, 5, 1040)):
        chunk, n = split_plan(B, Hkv, S, 132)
        assert chunk % 16 == 0 and chunk * n >= S and (n - 1) * chunk < S
        assert 1 <= n <= 8
    assert split_plan(8, 8, 1088, 132) == (144, 8)  # internlm2's serving decode
    assert split_plan(4, 5, 1040, 132) == (144, 8)  # hymba's
    assert split_plan(3, 2, 40, 132)[1] == 1
    assert split_plan(64, 8, 32768, 132)[1] == 2   # 512 pairs already fill the card
