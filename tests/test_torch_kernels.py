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
from repro.models import layers as JLyr
from repro_torch.kernels.decode_attention import (combine_splits,
                                                  decode_attention_plain,
                                                  decode_partials_plain)
from repro_torch.kernels.flash_attention import (aligned16,
                                                 flash_attention_plain)

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
# the reference's flash_attention contract shapes (tests/test_kernels.py)
FLASH_SHAPES = [
    (2, 32, 32, 4, 2, 16, True),
    (1, 40, 40, 8, 8, 32, True),
    (2, 17, 17, 6, 2, 8, True),
    (2, 24, 24, 4, 4, 16, False),
    (1, 64, 64, 4, 1, 64, True),
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,T,Hq,Hkv,D,ns,lens", [
    (3, 64, 4, 2, 16, 8, (0, 1, 63)),
    (2, 100, 8, 4, 32, 16, (5, 40)),
    (4, 33, 6, 2, 8, 3, (0, 10, 11, 32)),
    (1, 160, 4, 2, 64, 8, (46,)),
])
def test_decode_split_plain_matches_jax_with_splits_past_the_length(
        dtype, B, T, Hq, Hkv, D, ns, lens):
    """The plain version the fused kernel is held to on the card, split
    partials then combine_splits, against the JAX reference's
    ops.decode_attention (Pallas in interpret mode), with whole splits
    past the length; B3's contract, 2e-4 (f32 cache) and 1e-2 (bf16)."""
    q, k, v, _ = _decode_inputs(B, T, Hq, Hkv, D, T + ns)
    lengths = np.asarray(lens, np.int32)
    kj, vj = (jnp.asarray(a).astype(dtype) for a in (k, v))
    want = jops.decode_attention(jnp.asarray(q), kj, vj, jnp.asarray(lengths),
                                 ns)
    td = getattr(torch, dtype)
    kt, vt = (_t(np.asarray(a.astype(jnp.float32))).to(td) for a in (kj, vj))
    got = combine_splits(*decode_partials_plain(_t(q), kt, vt, _t(lengths),
                                                ns))
    tol = 2e-4 if dtype == "float32" else 1e-2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


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


# ---------------------------------------------------------------------------
# B4 flash_attention
# ---------------------------------------------------------------------------


def _flash_inputs(B, S, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, S, Hq, D)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, D)).astype(np.float32),
            rng.normal(size=(B, T, Hkv, D)).astype(np.float32))


def _jax_flash_ref(q, k, v, causal):
    """ref.attention_ref of the JAX package, in the model layout."""
    qt, kt, vt = (jnp.transpose(jnp.asarray(a), (0, 2, 1, 3))
                  for a in (q, k, v))
    return jnp.transpose(jref.attention_ref(qt, kt, vt, causal=causal),
                         (0, 2, 1, 3))


@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,causal", FLASH_SHAPES)
def test_flash_attention_plain_matches_jax_kernel(B, S, T, Hq, Hkv, D,
                                                  causal):
    """The CPU path of ops.flash_attention against the Pallas kernel
    (interpret mode, 16 x 16 blocks as the reference test runs it) and
    both packages' attention oracles, at the f32 contract 2e-4."""
    q, k, v = _flash_inputs(B, S, T, Hq, Hkv, D, S + Hq)
    o = ops.flash_attention(_t(q), _t(k), _t(v), causal)
    assert o.shape == (B, S, Hq, D) and o.dtype == torch.float32
    oj = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              causal, 16, 16)
    np.testing.assert_allclose(o.numpy(), np.asarray(oj), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(o.numpy(), np.asarray(_jax_flash_ref(
        q, k, v, causal)), rtol=2e-4, atol=2e-4)
    o_ref = ref.attention_ref(*(_t(a).transpose(1, 2) for a in (q, k, v)),
                              causal=causal).transpose(1, 2)
    np.testing.assert_allclose(o.numpy(), o_ref.numpy(), rtol=2e-4,
                               atol=2e-4)


def test_flash_attention_plain_bf16():
    """bf16 inputs, against the Pallas kernel and the oracle at the bf16
    contract 5e-2; the output stays in the inputs' dtype."""
    q, k, v = (a.astype(jnp.bfloat16) for a in
               (jnp.asarray(x) for x in _flash_inputs(2, 32, 32, 4, 2, 16,
                                                      0)))
    tq, tk, tv = (_t(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16)
                  for a in (q, k, v))
    o = ops.flash_attention(tq, tk, tv, True)
    assert o.dtype == torch.bfloat16
    oj = jops.flash_attention(q, k, v, True, 16, 16)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(oj, np.float32), rtol=5e-2,
                               atol=5e-2)
    np.testing.assert_allclose(o.float().numpy(),
                               np.asarray(_jax_flash_ref(q, k, v, True),
                                          np.float32), rtol=5e-2, atol=5e-2)


@pytest.mark.parametrize("causal,S,T", [(True, 23, 23), (False, 23, 23),
                                        (False, 9, 30), (True, 12, 30)])
def test_flash_attention_plain_is_the_reference_naive_math(causal, S, T):
    """The plain version is the naive attention the reference engine and
    encoder run (layers.gqa_scores_softmax_out with the causal mask at
    offset 0), also where S != T."""
    q, k, v = _flash_inputs(2, S, T, 6, 3, 16, S * T)
    mask = JLyr.causal_mask(S, T, 0) if causal else None
    want = JLyr.gqa_scores_softmax_out(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), mask, 16 ** -0.5)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_flash_attention_cpu_takes_the_plain_version_uncounted():
    q, k, v = (_t(a) for a in _flash_inputs(1, 8, 8, 2, 1, 16, 3))
    n0 = ops.flash_attention.launches
    o = ops.flash_attention(q, k, v, False)
    assert ops.flash_attention.launches == n0
    assert torch.equal(o, flash_attention_plain(q, k, v, False))
    with pytest.raises(ValueError):
        ops.flash_attention(q, k.to("meta"), v)


# ---------------------------------------------------------------------------
# B4 on the tensor cores: the 3xTF32 split, emulated
# ---------------------------------------------------------------------------


def _tf32(x):
    """Round f32 to TF32 (10 mantissa bits) to nearest, ties away from zero,
    on the bit pattern, as cvt.rna.tf32.f32 does."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_matmul(a, b, passes):
    """a @ b as the tensor cores form it from TF32 operands: products exact
    in f32, sums in f32; 3 passes are the big/small split."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    a_s, b_s = _tf32(a - ab), _tf32(b - bb)
    return a_s @ bb + ab @ b_s + ab @ bb


@pytest.mark.parametrize("passes", [1, 3])
@pytest.mark.parametrize("B,S,Hq,Hkv,D,causal", [
    (2, 64, 6, 6, 64, False),       # the MiniLM encoder's shape, cut in B
    (1, 160, 16, 8, 64, True),
    (2, 64, 6, 6, 128, False),
    (1, 160, 16, 8, 128, True),     # qwen3-1.7b prefill at max_len
])
def test_flash_tf32_split_emulation_settles_the_f32_contract(
        passes, B, S, Hq, Hkv, D, causal):
    """B4's f32 arithmetic on the tensor cores, emulated in torch: both
    products (Q.K^T and P.V) from TF32 operands, softmax in f32. With unit
    scale inputs the 3xTF32 split holds the f32 contract, 2e-4 against the
    plain version in f64; one TF32 pass does not, which is why the kernel
    splits."""
    rng = np.random.default_rng(D + S)
    q, k, v = (_t(rng.normal(size=sh).astype(np.float32)) for sh in
               ((B, S, Hq, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    G = Hq // Hkv
    qh = q.transpose(1, 2)
    kh, vh = (t.transpose(1, 2).repeat_interleave(G, 1) for t in (k, v))
    s = _tf32_matmul(qh, kh.transpose(-1, -2), passes) * D ** -0.5
    if causal:
        s = s.masked_fill(torch.arange(S)[None, :] > torch.arange(S)[:, None],
                          -1e30)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    o = (_tf32_matmul(p, vh, passes) / p.sum(-1, keepdim=True)).transpose(1, 2)
    want = flash_attention_plain(q.double(), k.double(), v.double(), causal)
    err = float((o.double() - want).abs().max())
    if passes == 3:
        assert err <= 2e-4, err
    else:
        assert err > 2e-4, err


# ---------------------------------------------------------------------------
# B1 on the tensor cores: the 2xTF32 / 3xTF32 split, emulated
# ---------------------------------------------------------------------------


def _tf32_mips(q, x, passes):
    """q @ x^T as B1 forms it from TF32 operands, the products summed in
    f64 (the tensor cores' own f32 sums are left out): one pass rounds both
    operands to TF32; two split the query, q = big + small, and keep x as it
    is (a 16-bit store); three split both (an f32 store), leaving out
    small x small."""
    qb, xb = _tf32(q), _tf32(x)
    qs, xs = _tf32(q - qb), _tf32(x - xb)

    def dot(a, b):
        return a.double() @ b.double().T
    if passes == 1:
        return dot(qb, xb)
    if passes == 2:
        return dot(qs, x) + dot(qb, x)
    return dot(qs, xb) + dot(qb, xs) + dot(qb, xb)


def _unit_rows(rng, n, d):
    a = rng.normal(size=(n, d))
    return (a / np.linalg.norm(a, axis=1, keepdims=True)).astype(np.float32)


@pytest.mark.parametrize("passes,dtype", [
    (1, torch.float16), (2, torch.float16), (2, torch.bfloat16),
    (3, torch.float32)])
def test_mips_tf32_split_emulation_settles_the_contract(passes, dtype):
    """B1's arithmetic at the paper's width (D = 384, unit rows, Q = 32):
    against the f64 scores of the same store values, one TF32 pass misses
    the 1e-5 contract on many scores, 2xTF32 holds it for fp16 and bf16
    stores and 3xTF32 for an f32 store, with room to spare."""
    rng = np.random.default_rng(0)
    q = _t(_unit_rows(rng, 32, 384))
    x = _t(_unit_rows(rng, 4000, 384)).to(dtype).float()
    want = q.double() @ x.double().T
    err = (_tf32_mips(q, x, passes) - want).abs()
    outside = err > 1e-5 + 1e-5 * want.abs()
    if passes == 1:
        assert float(outside.double().mean()) > 0.1, float(err.max())
    else:
        assert not outside.any() and float(err.max()) < 1e-7, float(err.max())


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_16bit_store_values_are_exact_in_tf32(dtype):
    """Every finite fp16 and bf16 value, subnormals included, is its own
    TF32 rounding, which is why B1 splits only the query of a 16-bit
    store."""
    v = torch.arange(-2 ** 15, 2 ** 15, dtype=torch.int32).to(
        torch.int16).view(dtype).float()
    v = v[torch.isfinite(v)]
    assert torch.equal(_tf32(v), v)


def test_query_split_reproduces_q_to_2_pow_minus_22():
    """q_big + q_small, each a TF32 value, is q to 2^-22 relative, across
    f32's normal range."""
    rng = np.random.default_rng(1)
    q = _t((rng.normal(size=100000) *
            2.0 ** rng.integers(-100, 100, 100000)).astype(np.float32))
    big = _tf32(q)
    small = _tf32(q - big)
    assert torch.equal(_tf32(small), small)
    err = (big.double() + small.double() - q.double()).abs()
    assert bool((err <= 2.0 ** -22 * q.double().abs()).all())


def test_search_kernels_copy_granule():
    """The cp.async size the search wrappers hand their kernels: the largest
    of 16, 8 and 4 bytes that divides a row's bytes and the address, else 0
    (plain loads); so no store is copied or padded for its alignment."""
    from repro_torch.kernels.mips_topk import granule
    for d, dt, want in ((100, torch.float16, 8), (100, torch.int8, 4),
                        (99, torch.int8, 0), (99, torch.float16, 0),
                        (24, torch.float32, 16), (99, torch.float32, 4),
                        (384, torch.int8, 16), (384, torch.float16, 16)):
        x = torch.zeros((3, d), dtype=dt)
        assert x.data_ptr() % 16 == 0
        assert granule(x) == want, (d, dt)
    flat = torch.zeros(128, dtype=torch.int8)
    assert flat.data_ptr() % 16 == 0
    assert granule(flat[4:100].view(6, 16)) == 4      # 16-byte rows at +4
    assert granule(flat[8:104].view(6, 16)) == 8


@pytest.mark.parametrize("contiguous", [False, True])
def test_aligned16_copies_only_what_a_kernel_cannot_read(contiguous):
    """The one alignment helper of B3 (contiguous inputs) and B4 (strided):
    a tensor a kernel can read in 16-byte pieces passes through as itself,
    any other comes back as an equal contiguous copy."""
    base = torch.arange(4 * 6 * 3 * 16, dtype=torch.float32).reshape(
        4, 6, 3, 16)
    cases = [(base, True, True),
             (base[:, 2:5], True, False),       # 16-byte strides, a T slice
             (base[..., :12], True, False),     # 48-byte rows, strided
             (base[..., 1:13], False, False),   # pointer off by 4 bytes
             (base[..., ::2], False, False)]    # innermost stride 2
    for t, strided_ok, contiguous_ok in cases:
        out = aligned16(t, contiguous)
        if (contiguous_ok if contiguous else strided_ok):
            assert out is t
        else:
            assert out is not t and out.is_contiguous()
            assert out.data_ptr() % 16 == 0 and torch.equal(out, t)
