"""The port's kernel modules against the JAX reference, on the CPU: the
plain PyTorch versions that the ``repro_torch.kernels.ops`` wrappers take
for CPU tensors, held to the Pallas kernels (interpret mode, through
``repro.kernels.ops``) and to the ``ref.py`` oracles on the same numpy
inputs. The CUDA kernels themselves are held to these plain versions by
the ``gpu``-marked tests at the end, which run only on a card."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro_torch.core.store import quantize_rows
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (combine_splits,
                                                  decode_attention_plain,
                                                  decode_partials_plain)

MIPS_SHAPES = [
    (4, 100, 16, 5, 32),
    (8, 512, 384, 10, 128),
    (1, 33, 24, 3, 32),        # Q=1
    (16, 1024, 64, 16, 512),
    (2, 300, 100, 32, 32),     # k == tile_n, D not 128-aligned
    (1, 64, 48, 64, 512),      # N < tile_n, k == N
    (3, 200, 384, 1, 128),     # k=1 (the serving hot path)
]
DECODE_SHAPES = [
    (2, 64, 4, 2, 16, 4),
    (1, 100, 8, 8, 32, 8),
    (3, 33, 6, 2, 8, 2),
    (2, 128, 16, 4, 64, 16),
]


def _t(a):
    return torch.from_numpy(np.array(a))


# ---------------------------------------------------------------------------
# B1 mips_topk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Q,N,D,k,tile", MIPS_SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_mips_topk_plain_matches_jax_kernel(Q, N, D, k, tile, dtype):
    rng = np.random.default_rng(Q + N)
    q = rng.normal(size=(Q, D)).astype(np.float32)
    x = rng.normal(size=(N, D)).astype(dtype)
    v, i = ops.mips_topk(_t(q), _t(x), k, tile)
    vj, ij = jops.mips_topk(jnp.asarray(q), jnp.asarray(x), k, tile)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), rtol=1e-5,
                               atol=1e-5)
    vr, _ = ref.mips_topk_ref(_t(q), _t(x), k)
    np.testing.assert_allclose(v.numpy(), vr.numpy(), rtol=1e-5, atol=1e-5)
    # indices may differ only on exact ties: compare the scores they pick
    s = q @ x.astype(np.float32).T
    sel = np.take_along_axis(s, i.numpy().astype(np.int64), axis=1)
    np.testing.assert_allclose(sel, np.asarray(vj), rtol=1e-5, atol=1e-5)
    assert i.dtype == torch.int32 and v.shape == (Q, k)


def test_mips_topk_forced_ties_bitwise():
    """Small-integer data makes every score exact, so ties are exact: the
    (value desc, index asc) order must match the numpy oracle bitwise,
    and the JAX kernel too."""
    rng = np.random.default_rng(7)
    q = rng.integers(-2, 3, size=(5, 24)).astype(np.float32)
    x = rng.integers(-2, 3, size=(700, 24)).astype(np.float32)
    x[::5] = x[0]                                  # heavy exact ties
    for k, tile in [(1, 128), (7, 128), (40, 256), (64, 64)]:
        v, i = ops.mips_topk(_t(q), _t(x), k, tile)
        vr, ir = jref.topk_by_value_ref(q @ x.T, k)
        vj, ij = jops.mips_topk(jnp.asarray(q), jnp.asarray(x), k, tile)
        assert np.array_equal(v.numpy(), vr) and np.array_equal(i.numpy(), ir)
        assert np.array_equal(i.numpy(), np.asarray(ij))


def test_topk_by_value_matches_numpy_oracle_with_ties():
    rng = np.random.default_rng(3)
    for Q, T, k in [(4, 512, 10), (1, 128, 1), (3, 384, 16), (5, 512, 100)]:
        s = rng.normal(size=(Q, T)).astype(np.float32)
        s[:, ::7] = s[:, 0:1]
        v, i = ref.topk_by_value(_t(s), k)
        vr, ir = ref.topk_by_value_ref(s, k)
        assert np.array_equal(v.numpy(), vr) and np.array_equal(i.numpy(), ir)


# ---------------------------------------------------------------------------
# B2 mips_topk_int8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("Q,N,D,k,tile", MIPS_SHAPES[:6] + [(2, 700, 384,
                                                             1, 512)])
def test_mips_topk_int8_plain_bit_for_bit(Q, N, D, k, tile):
    rng = np.random.default_rng(Q * 7 + N)
    q8, qs = quantize_rows(rng.normal(size=(Q, D)).astype(np.float32))
    x8, xs = quantize_rows(rng.normal(size=(N, D)).astype(np.float32))
    v, i = ops.mips_topk_int8(_t(q8), _t(qs), _t(x8), _t(xs), k, tile)
    vr, ir = ref.mips_topk_int8_ref(q8, qs, x8, xs, k)
    assert np.array_equal(v.numpy(), vr) and np.array_equal(i.numpy(), ir)
    vj, ij = jops.mips_topk_int8(jnp.asarray(q8), jnp.asarray(qs),
                                 jnp.asarray(x8), jnp.asarray(xs), k, tile)
    assert np.array_equal(v.numpy(), np.asarray(vj))
    assert np.array_equal(i.numpy(), np.asarray(ij))


def test_mips_topk_rejects_k_above_rows_and_mixed_devices():
    q = torch.zeros((2, 8))
    x = torch.zeros((4, 8))
    with pytest.raises(ValueError):
        ops.mips_topk(q, x, 5)
    with pytest.raises(ValueError):
        ops._on_cuda(q, torch.empty(0, device="meta"))


# ---------------------------------------------------------------------------
# B3 decode_attention
# ---------------------------------------------------------------------------


def _decode_inputs(B, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    lengths = rng.integers(0, T, (B,)).astype(np.int32)
    return q, k, v, lengths


@pytest.mark.parametrize("B,T,Hq,Hkv,D,ns", DECODE_SHAPES)
def test_decode_attention_plain_matches_jax_kernel(B, T, Hq, Hkv, D, ns):
    q, k, v, lengths = _decode_inputs(B, T, Hq, Hkv, D, T + Hq)
    o = ops.decode_attention(_t(q), _t(k), _t(v), _t(lengths), ns)
    oj = jops.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               jnp.asarray(lengths), ns)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=2e-4,
                               atol=2e-4)
    o_ref = ref.decode_attention_ref(_t(q), _t(k), _t(v), _t(lengths))
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("B,T,Hq,Hkv,D,ns", DECODE_SHAPES)
def test_decode_partials_plain_match_pallas_partials(B, T, Hq, Hkv, D, ns):
    """The kernel's own split arithmetic (o, m, l per split) against the
    Pallas kernel's partials, f32 cache."""
    q, k, v, lengths = _decode_inputs(B, T, Hq, Hkv, D, T * 3 + Hq)
    o, m, l = decode_partials_plain(_t(q), _t(k), _t(v), _t(lengths), ns)
    oj, mj, lj = decode_attention_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lengths),
        n_splits=ns, interpret=True)
    # a fully-masked split has m = -1e30 and l = tc in both; it is
    # weighted by exp(-1e30 - m_g) = 0 in the merge
    np.testing.assert_allclose(m.numpy(), np.asarray(mj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(l.numpy(), np.asarray(lj), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=1e-4,
                               atol=1e-4)


def test_decode_attention_split_invariance():
    q, k, v, lengths = _decode_inputs(2, 64, 4, 2, 16, 5)
    lengths = np.asarray([10, 63], np.int32)
    args = (_t(q), _t(k), _t(v), _t(lengths))
    o1 = combine_splits(*decode_partials_plain(*args, n_splits=4))
    o2 = combine_splits(*decode_partials_plain(*args, n_splits=16))
    o3 = decode_attention_plain(*args)
    np.testing.assert_allclose(o1.numpy(), o2.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(o1.numpy(), o3.numpy(), rtol=1e-5, atol=1e-5)


def _jax_naive_decode(q, kc, vc, cache_len):
    """models/model.py:gqa_decode's attention lines (313-319), verbatim."""
    B, Hq, hd = q.shape
    Hkv = kc.shape[2]
    qg = q.reshape(B, Hkv, Hq // Hkv, hd)
    logits = jnp.einsum("bkgd,btkd->bkgt", qg, kc).astype(jnp.float32)
    T = kc.shape[1]
    mask = (jnp.arange(T) <= cache_len)[None, None, None, :]
    logits = jnp.where(mask, logits * hd ** -0.5, -1e30)
    probs = jax.nn.softmax(logits, axis=-1)
    out = jnp.einsum("bkgt,btkv->bkgv", probs.astype(vc.dtype), vc)
    return out.reshape(B, Hq, hd)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_attention_plain_is_the_reference_engine_math(cache_dtype):
    """The CPU path reproduces the naive decode math the reference engine
    runs, including the bf16 cache: f32 query x bf16 cache, probabilities
    rounded to bf16 before P.V, output in the cache dtype."""
    q, k, v, _ = _decode_inputs(4, 160, 16, 8, 32, 11)
    cache_len = 57
    kj = jnp.asarray(k).astype(cache_dtype)
    vj = jnp.asarray(v).astype(cache_dtype)
    want = np.asarray(_jax_naive_decode(jnp.asarray(q), kj, vj, cache_len)
                      .astype(jnp.float32))
    td = getattr(torch, cache_dtype)
    kt = _t(np.asarray(kj.astype(jnp.float32))).to(td)
    vt = _t(np.asarray(vj.astype(jnp.float32))).to(td)
    lengths = torch.full((4,), cache_len, dtype=torch.int32)
    got = ops.decode_attention(_t(q), kt, vt, lengths).to(td).float()
    tol = 1e-5 if cache_dtype == "float32" else 8e-3   # one bf16 ulp near 1
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)
