"""The port's CUDA kernels against their plain PyTorch versions, on the
card, the engine and MiniLM encoder on the card against the CPU, and the
mesh paths (sharded tier, seq-sharded decode, expert parallel) on four
shards of the card against one device. Every test here is marked ``gpu`` and skips without a CUDA device
(a CUDA kernel has no CPU mode); this file imports nothing of JAX, so it
runs where only the port is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.store import quantize_rows
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (combine_splits,
                                                  decode_attention_cuda,
                                                  decode_attention_plain,
                                                  decode_partials_plain)
from repro_torch.kernels.flash_attention import flash_attention_plain

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
FLASH_SHAPES = [
    (2, 32, 32, 4, 2, 16, True),
    (1, 40, 40, 8, 8, 32, True),
    (2, 17, 17, 6, 2, 8, True),
    (2, 24, 24, 4, 4, 16, False),
    (1, 64, 64, 4, 1, 64, True),
    (256, 64, 64, 6, 6, 64, False),     # MiniLM encode, one 256-row bucket
    (1, 160, 160, 16, 8, 128, True),    # qwen3-1.7b prefill at max_len
    (1, 13, 13, 16, 8, 128, True),      # a short prompt
    (3, 100, 100, 12, 4, 128, True),    # ragged tiles, G = 3
    (2, 70, 130, 6, 2, 96, False),      # S != T, D not a power of two
    (1, 46, 46, 16, 8, 128, True),      # a real prompt's length
    (1, 37, 37, 16, 8, 128, True),      # S not a multiple of 16
    (3, 23, 29, 4, 2, 64, False),       # S, T not multiples of 16
    (1, 21, 21, 4, 2, 100, True),       # D not a multiple of 8
    (1, 160, 160, 16, 8, 192, True),    # deepseek-v2-lite's head dim
    (1, 46, 46, 16, 8, 256, True),      # the widest head dim, key split
    (2, 70, 130, 6, 2, 256, False),
    (3, 37, 37, 4, 4, 200, True),       # 64-row blocks at D = 200
    (1, 300, 300, 16, 8, 128, True),    # the LM engine's prefill (TorchLM)
    (1, 512, 512, 16, 8, 128, True),    # ... at its max_len 512
] + [(1, 160, 160, h, hk, d, True) for h, hk, d in (
    (32, 8, 128),                       # storinfer-paper-8b's prefill
    (32, 8, 64),                        # storinfer-paper-1b's: D = 64
    (24, 8, 128),                       # llama3.2-3b's: G = 3
    (36, 4, 128),                       # starcoder2-7b's: G = 9
    (40, 8, 128))]                      # qwen2.5-32b's: G = 5
# the dense family's decode at full width over a 160-row cache
DENSE_DECODE_SHAPES = [(4, 160, h, hk, d, 8) for h, hk, d in (
    (32, 8, 128), (32, 8, 64), (24, 8, 128), (36, 4, 128), (40, 8, 128))]
DENSE_ARCHS = ["storinfer-paper-8b", "storinfer-paper-1b", "llama3.2-3b",
               "starcoder2-7b", "qwen2.5-32b"]
# the moe, ssm and hybrid families: grok-1's GQA (48/8 of 128, G = 6) and
# zamba2's shared block (32/32 of 64, G = 1) at full width, prefill at
# max_len and decode over a 160-row cache
FAMILY_FLASH_SHAPES = [(1, 160, 160, 48, 8, 128, True),
                       (1, 160, 160, 32, 32, 64, True)]
FAMILY_DECODE_SHAPES = [(4, 160, 48, 8, 128, 8), (4, 160, 32, 32, 64, 8)]
# MLA's prefill: q and k 192 wide (nope 128 + rope 64), v 128 wide
MLA_FLASH_SHAPES = [(1, 160, 160, 16, 16, 192, 128), (1, 47, 47, 16, 16, 192,
                                                      128),
                    (2, 37, 37, 4, 4, 24, 16)]
FAMILY_ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b", "mamba2-130m",
                "zamba2-1.2b"]
# the encdec and vlm families at full width: whisper-base's encoder (8
# heads of 64, S = T = 1500, non-causal, batch 1 and 4), its
# cross-attention prefill (a 12-token prompt over the 1500 frames) and
# decoder prefill; qwen2-vl-72b's prefill (64/8 heads of 128, G = 8)
ENCDEC_VLM_FLASH_SHAPES = [(1, 1500, 1500, 8, 8, 64, False),
                           (4, 1500, 1500, 8, 8, 64, False),
                           (1, 12, 1500, 8, 8, 64, False),
                           (4, 12, 1500, 8, 8, 64, False),
                           (1, 160, 160, 8, 8, 64, True),
                           (1, 160, 160, 64, 8, 128, True)]
# whisper's self-attention decode and qwen2-vl's (G = 8) over a 160-row
# cache; whisper's cross-attention decode over 1500 frames is its own test
ENCDEC_VLM_DECODE_SHAPES = [(4, 160, 8, 8, 64, 8), (4, 160, 64, 8, 128, 8)]
ENCDEC_VLM_ARCHS = ["whisper-base", "qwen2-vl-72b"]


def _t(a):
    return torch.from_numpy(np.array(a))


def _decode_inputs(B, T, Hq, Hkv, D, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, Hq, D)).astype(np.float32)
    k = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, T, Hkv, D)).astype(np.float32)
    lengths = rng.integers(0, T, (B,)).astype(np.int32)
    return q, k, v, lengths


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("Q,N,D,k,tile", MIPS_SHAPES)
def test_gpu_mips_topk_kernel_matches_plain(cuda, dtype, Q, N, D, k, tile):
    _check_mips(cuda, dtype, Q, N, D, k, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_gpu_mips_topk_paper_shape(cuda, dtype):
    """B1 at the paper's store: 32 queries, 150,000 x 384, k 1, tile 512
    (2xTF32 for a 16-bit store, 3xTF32 for f32)."""
    _check_mips(cuda, dtype, 32, 150000, 384, 1, 512)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("Q", [1, 9, 33, 64])
@pytest.mark.parametrize("D", [24, 100, 99])
def test_gpu_mips_topk_query_blocks_and_narrow_rows(cuda, dtype, Q, D):
    """Query blocks of 8, 16 and 32 (and Q above 32 in several), and store
    rows of 48-400 bytes: D = 100 in fp16 is 200 bytes a row, not a
    multiple of 16, and D = 99 an odd number of 16-bit words."""
    _check_mips(cuda, dtype, Q, 1000, D, 7, 512)


def _check_mips(cuda, dtype, Q, N, D, k, tile):
    from repro_torch.kernels.mips_topk import mips_topk_tiles_plain
    g = torch.Generator(device=cuda).manual_seed(Q + N)
    q = torch.randn((Q, D), generator=g, device=cuda)
    q = q / q.norm(dim=1, keepdim=True)
    x = torch.randn((N, D), generator=g, device=cuda)
    x = (x / x.norm(dim=1, keepdim=True)).to(dtype)
    n0 = ops.mips_topk.launches
    v, i = ops.mips_topk(q, x, k, tile)
    torch.cuda.synchronize()
    assert ops.mips_topk.launches == n0 + 1
    tile_n = ops._clamp_tile(N, k, tile)
    vp, ip = ops._combine_tiles(*mips_topk_tiles_plain(q, x, k, tile_n), k)
    torch.testing.assert_close(v, vp, rtol=1e-5, atol=1e-5)
    s = q @ x.float().T
    torch.testing.assert_close(torch.gather(s, 1, i.long()), vp, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("Q,N,D,k,tile", MIPS_SHAPES + [(32, 150000, 384, 1,
                                                         512)])
def test_gpu_mips_topk_int8_kernel_bit_for_bit(cuda, Q, N, D, k, tile):
    _check_mips_int8(cuda, Q, N, D, k, tile)


@pytest.mark.gpu
@pytest.mark.parametrize("Q", [1, 9, 33, 64])
@pytest.mark.parametrize("D", [24, 100, 99])
def test_gpu_mips_topk_int8_query_blocks_and_narrow_rows(cuda, Q, D):
    """D = 100 and 99: rows that are no multiple of the MMA's 32-deep step
    nor of 16 bytes, zero-filled in shared memory by the kernel."""
    _check_mips_int8(cuda, Q, 1000, D, 7, 512)


def _check_mips_int8(cuda, Q, N, D, k, tile):
    rng = np.random.default_rng(Q * 7 + N + D)
    q8, qs = quantize_rows(rng.normal(size=(Q, D)).astype(np.float32))
    x8, xs = quantize_rows(rng.normal(size=(N, D)).astype(np.float32))
    n0 = ops.mips_topk_int8.launches
    v, i = ops.mips_topk_int8(*(_t(a).to(cuda) for a in (q8, qs, x8, xs)),
                              k, tile)
    assert ops.mips_topk_int8.launches == n0 + 1
    vr, ir = ref.mips_topk_int8_ref(q8, qs, x8, xs, k)
    assert np.array_equal(v.cpu().numpy(), vr)
    assert np.array_equal(i.cpu().numpy(), ir)


@pytest.mark.gpu
def test_gpu_mips_topk_int8_copies_no_store(cuda):
    """At D = 100 (the kernel steps 32 deep, the old wrapper padded the
    store to a multiple of 4 bytes) the launch allocates its outputs and
    nothing near the store's size."""
    from repro_torch.kernels.mips_topk_int8 import (
        mips_topk_int8_tiles_cuda, mips_topk_int8_tiles_plain)
    rng = np.random.default_rng(3)
    q8, qs = quantize_rows(rng.normal(size=(4, 100)).astype(np.float32))
    x8, xs = quantize_rows(rng.normal(size=(200000, 100)).astype(np.float32))
    t = [_t(a).to(cuda) for a in (q8, qs, x8, xs)]
    lib = ops._lib("mips_topk_int8")
    mips_topk_int8_tiles_cuda(lib, *t, 1, 512)      # built and warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    v, i = mips_topk_int8_tiles_cuda(lib, *t, 1, 512)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - before
    assert extra <= v.numel() * 8 + 4096, extra      # the store: 20 MB
    vp, ip = mips_topk_int8_tiles_plain(*t, 1, 512)
    assert torch.equal(v, vp) and torch.equal(i, ip)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Hq,Hkv,D,ns", DECODE_SHAPES + [
    (4, 160, 16, 8, 128, 8),    # qwen3-1.7b decode
    (2, 50, 36, 4, 128, 8),     # starcoder2-7b's G = 9: two head groups
    (2, 40, 16, 1, 100, 4),     # G = 16, D not a multiple of 8
    (1, 33, 6, 2, 12, 20),      # more splits than a cluster holds
    (4, 160, 16, 8, 192, 8),    # deepseek-v2-lite's 192-wide heads
    (2, 40, 16, 2, 256, 20),    # the widest head dim, 20 splits
    (2, 50, 8, 8, 200, 3),      # D = 200: two 16-byte chunks a lane (f32)
] + DENSE_DECODE_SHAPES + FAMILY_DECODE_SHAPES + ENCDEC_VLM_DECODE_SHAPES)
def test_gpu_decode_attention_kernel_matches_plain(cuda, kv_dtype, B, T, Hq,
                                                   Hkv, D, ns):
    """The one launch ops.decode_attention makes (splits and their merge)
    against the plain split version and the naive math."""
    q, k, v, lengths = (_t(a).to(cuda) for a in
                        _decode_inputs(B, T, Hq, Hkv, D, T + Hq))
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    n0 = ops.decode_attention.launches
    got = ops.decode_attention(q, k, v, lengths, ns)
    torch.cuda.synchronize()
    assert ops.decode_attention.launches == n0 + 1
    assert got.dtype == torch.float32 and got.shape == (B, Hq, D)
    tol = 2e-4 if kv_dtype == torch.float32 else 1e-2
    split = combine_splits(*decode_partials_plain(q, k, v, lengths, ns))
    torch.testing.assert_close(got, split, rtol=tol, atol=tol)
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, lengths),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
def test_gpu_decode_attention_split_invariance(cuda):
    """f32 cache: the same output for n_splits 1, 3, 8 and 16 within 1e-5."""
    q, k, v, _ = (_t(a).to(cuda) for a in
                  _decode_inputs(4, 160, 16, 8, 128, 7))
    lengths = torch.tensor([45, 0, 159, 100], dtype=torch.int32, device=cuda)
    lib = ops._lib("decode_attention")
    outs = [decode_attention_cuda(lib, q, k, v, lengths, ns)
            for ns in (1, 3, 8, 16)]
    for o in outs[1:]:
        torch.testing.assert_close(o, outs[0], rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(outs[0], decode_attention_plain(q, k, v,
                                                               lengths),
                               rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_gpu_decode_attention_more_splits_than_a_cluster_holds(cuda):
    """n_splits above 16: each block of a 16-block cluster takes several
    splits; the same output as 16 splits within 1e-5 (f32)."""
    q, k, v, lengths = (_t(a).to(cuda) for a in
                        _decode_inputs(3, 160, 8, 2, 64, 5))
    got = ops.decode_attention(q, k, v, lengths, 20)
    torch.testing.assert_close(
        got, combine_splits(*decode_partials_plain(q, k, v, lengths, 20)),
        rtol=2e-4, atol=2e-4)
    lib = ops._lib("decode_attention")
    want = decode_attention_cuda(lib, q, k, v, lengths, 16)
    for ns in (17, 33, 160):
        torch.testing.assert_close(
            decode_attention_cuda(lib, q, k, v, lengths, ns), want,
            rtol=1e-5, atol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("lens", [(0, 0, 0, 0), (1, 1, 1, 1),
                                  (159, 159, 159, 159), (0, 1, 77, 159),
                                  (46, 51, 62, 3)])
def test_gpu_decode_attention_reads_nothing_past_the_length(cuda, kv_dtype,
                                                            lens):
    """Whole splits past the length, and ragged lengths across rows: every
    k and v row past lengths[b] is NaN, which any read that reached the
    output would carry into it."""
    q, k, v, _ = (_t(a).to(cuda) for a in
                  _decode_inputs(4, 160, 16, 8, 128, sum(lens)))
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    lengths = torch.tensor(lens, dtype=torch.int32, device=cuda)
    past = torch.arange(160, device=cuda)[None, :] > lengths[:, None]
    kn, vn = k.clone(), v.clone()
    kn[past], vn[past] = float("nan"), float("nan")
    tol = 2e-4 if kv_dtype == torch.float32 else 1e-2
    want = combine_splits(*decode_partials_plain(q, k, v, lengths, 8))
    got = decode_attention_cuda(ops._lib("decode_attention"), q, kn, vn,
                                lengths, 8)
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)
    torch.testing.assert_close(ops.decode_attention(q, kn, vn, lengths, 8),
                               decode_attention_plain(q, k, v, lengths),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("T", [160, 512])
def test_gpu_decode_attention_lengths_past_the_cache(cuda, kv_dtype, T):
    """A decode past the engine's ``max_len`` passes lengths of T and more:
    the kernel clamps them to T - 1 (attends the whole cache), as the
    plain version's inclusive mask does."""
    q, k, v, _ = (_t(a).to(cuda) for a in
                  _decode_inputs(4, T, 16, 8, 128, T))
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    lengths = torch.tensor([T, T + 1, 3 * T, T - 1], dtype=torch.int32,
                           device=cuda)
    clamped = lengths.clamp(max=T - 1)
    got = ops.decode_attention(q, k, v, lengths, 8)
    tol = 2e-4 if kv_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, lengths),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, clamped),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got, ops.decode_attention(q, k, v, clamped,
                                                         8), rtol=0, atol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B", [1, 4])
def test_gpu_decode_attention_cross_attention_over_1500_frames(cuda, kv_dtype,
                                                              B):
    """Whisper's cross-attention decode: one token over the 1500 static
    encoder keys and values (8 heads of 64, G = 1), ``lengths`` 1499 so
    the inclusive mask attends every frame; 8 splits of 188 rows fit the
    kernel's shared memory."""
    from repro_torch.models.model import DECODE_SPLITS
    q, k, v, _ = (_t(a).to(cuda) for a in _decode_inputs(B, 1500, 8, 8, 64,
                                                          B + 1500))
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    lengths = torch.full((B,), 1499, dtype=torch.int32, device=cuda)
    got = ops.decode_attention(q, k, v, lengths, DECODE_SPLITS)
    tol = 2e-4 if kv_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, lengths),
                               rtol=tol, atol=tol)
    torch.testing.assert_close(got, combine_splits(*decode_partials_plain(
        q, k, v, lengths, DECODE_SPLITS)), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,Hq,Hkv,D,causal",
                         FLASH_SHAPES + FAMILY_FLASH_SHAPES
                         + ENCDEC_VLM_FLASH_SHAPES)
def test_gpu_flash_attention_kernel_matches_plain(cuda, dtype, B, S, T, Hq,
                                                  Hkv, D, causal):
    rng = np.random.default_rng(S * 3 + T + D)
    q, k, v = (_t(rng.normal(size=shape).astype(np.float32)).to(cuda)
               .to(dtype) for shape in ((B, S, Hq, D), (B, T, Hkv, D),
                                        (B, T, Hkv, D)))
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (B, S, Hq, D)
    want = flash_attention_plain(q, k, v, causal)
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,S,T,H,D,Dv", [(b, s, t, h, d, dv) for
                                          b, s, t, h, _, d, dv in
                                          MLA_FLASH_SHAPES])
def test_gpu_flash_attention_narrow_values_match_plain(cuda, dtype, B, S, T,
                                                       H, D, Dv):
    """Values narrower than the queries and keys (MLA's prefill): one
    launch over v zero-padded to the q/k width, the first Dv columns
    returned, against the plain version on the narrow v."""
    rng = np.random.default_rng(S + D + Dv)
    q, k, v = (_t(rng.normal(size=shape).astype(np.float32)).to(cuda)
               .to(dtype) for shape in ((B, S, H, D), (B, T, H, D),
                                        (B, T, H, Dv)))
    n0 = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, True)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == n0 + 1
    assert got.dtype == dtype and got.shape == (B, S, H, Dv)
    want = flash_attention_plain(q, k, v, True)
    tol = 2e-4 if dtype == torch.float32 else 5e-2
    torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    with pytest.raises(ValueError):                   # v wider than q/k
        ops.flash_attention(q[..., :Dv], k[..., :Dv], v[..., :Dv].repeat(
            1, 1, 1, 2), True)


@pytest.mark.gpu
def test_gpu_flash_attention_reads_strided_inputs(cuda):
    """q, k, v as views of one fused projection (the model's layout with
    non-contiguous batch, sequence and head strides)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    B, S, Hq, Hkv, D = 2, 50, 8, 2, 64
    qkv = torch.randn((B, S, (Hq + 2 * Hkv) * D + 8), generator=g,
                      device=cuda)
    q = qkv[..., :Hq * D].unflatten(-1, (Hq, D))
    k = qkv[..., Hq * D:(Hq + Hkv) * D].unflatten(-1, (Hkv, D))
    v = qkv[..., (Hq + Hkv) * D:-8].unflatten(-1, (Hkv, D))
    assert not q.is_contiguous()
    for causal in (True, False):
        torch.testing.assert_close(
            ops.flash_attention(q, k, v, causal),
            flash_attention_plain(q, k, v, causal), rtol=2e-4, atol=2e-4)


@pytest.mark.gpu
def test_gpu_kernel_launch_refuses_bad_inputs(cuda):
    q = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError):
        ops.mips_topk(q, torch.zeros((4, 8)), 1)      # mixed devices
    with pytest.raises(TypeError):
        ops.mips_topk(q.half(), torch.zeros((4, 8), device=cuda), 1)
    qa = torch.zeros((1, 4, 2, 16), device=cuda)
    with pytest.raises(ValueError):                   # mixed devices
        ops.flash_attention(qa, qa.cpu(), qa)
    with pytest.raises(TypeError):                    # no fp16 path
        ops.flash_attention(qa.half(), qa.half(), qa.half())
    with pytest.raises(TypeError):                    # mixed dtypes
        ops.flash_attention(qa, qa.bfloat16(), qa)
    wide = torch.zeros((1, 4, 2, 264), device=cuda)
    with pytest.raises(ValueError, match="head dim"):   # D > 256
        ops.flash_attention(wide, wide, wide)
    with pytest.raises(ValueError):                   # Hq % Hkv != 0
        ops.flash_attention(torch.zeros((1, 4, 3, 16), device=cuda), qa, qa)
    qd = torch.zeros((1, 16, 12), device=cuda)
    kd = torch.zeros((1, 8, 8, 12), device=cuda)
    lens = torch.zeros((1,), dtype=torch.int32, device=cuda)
    kw = torch.zeros((1, 8, 8, 264), device=cuda)
    with pytest.raises(ValueError, match="head dim"):  # D > 256
        ops.decode_attention(torch.zeros((1, 16, 264), device=cuda), kw, kw,
                             lens)
    kl = torch.zeros((1, 20000, 1, 8), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):  # one long split
        ops.decode_attention(torch.zeros((1, 8, 8), device=cuda), kl, kl,
                             lens, 1)
    with pytest.raises(ValueError):                   # mixed devices
        ops.decode_attention(qd, kd.cpu(), kd, lens)
    with pytest.raises(TypeError):                    # fp16 cache
        ops.decode_attention(qd[..., :8], kd[..., :8].half(),
                             kd[..., :8].half(), lens)


@pytest.mark.gpu
def test_gpu_search_kernels_refuse_a_score_table_past_shared_memory(cuda):
    """k > 1 keeps a [queries][tile_n] score table in shared memory; the
    launcher refuses one that does not fit and the wrapper raises, while
    k = 1 (no table) takes the same tile."""
    from repro_torch.kernels.mips_topk import mips_topk_tiles_cuda
    from repro_torch.kernels.mips_topk_int8 import mips_topk_int8_tiles_cuda
    q = torch.zeros((4, 64), device=cuda)
    x = torch.zeros((8192, 64), device=cuda, dtype=torch.float16)
    lib = ops._lib("mips_topk")
    with pytest.raises(ValueError, match="shared memory"):
        mips_topk_tiles_cuda(lib, q, x, 2, 8192)
    assert mips_topk_tiles_cuda(lib, q, x, 1, 8192)[1].shape == (1, 4, 1)
    q8, x8 = q.to(torch.int8), x.to(torch.int8)
    qs, xs = torch.ones(4, device=cuda), torch.ones(8192, device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        mips_topk_int8_tiles_cuda(ops._lib("mips_topk_int8"), q8, qs, x8, xs,
                                  2, 8192)


@pytest.mark.gpu
def test_gpu_minilm_encode_matches_cpu(cuda):
    """The MiniLM encoder on the card (its layers' attention on the B4
    kernel) against the same weights on the CPU (the plain version)."""
    from repro_torch.core.embedder import MiniLMEncoder
    from repro_torch.core.tokenizer import Tokenizer
    texts = ["what is the height of aurora bridge?",
             "who founded the meridian institute?",
             "tell me the capital of port serrano " * 8, "", "zebra"]
    tok = Tokenizer.from_texts(texts)
    cpu = MiniLMEncoder(tok, seed=0, device="cpu")
    gpu = MiniLMEncoder(tok, params=_to(cpu.params, cuda), device=cuda)
    n0 = ops.flash_attention.launches
    got = gpu.encode(texts * 7)
    assert ops.flash_attention.launches - n0 == 6      # one 64-row bucket
    np.testing.assert_allclose(got, cpu.encode(texts * 7), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.gpu
def test_gpu_engine_greedy_tokens_match_cpu(cuda):
    """The smoke-arch engine on the card (prefill attention on the B4
    kernel, decode attention on the B3 kernel, f32 session cache) emits
    the same greedy tokens as on the CPU (the plain versions)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    tok = Tokenizer.from_texts(["what is the height of aurora bridge",
                                "who founded the meridian institute"])
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              vocab_size=tok.vocab_size, n_layers=2)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    on_gpu = _to(params, cuda)
    outs = []
    n0 = ops.decode_attention.launches
    f0 = ops.flash_attention.launches
    for p in (params, on_gpu):
        s = Engine(cfg, p, tok, max_len=64, chunk=4).start_session(
            "what is the height of aurora bridge?", max_new=20)
        while not s.done:
            s.step_chunk()
        outs.append(s.out_ids)
    assert outs[0] == outs[1]
    assert ops.decode_attention.launches > n0
    assert ops.flash_attention.launches == f0 + cfg.n_layers


@pytest.mark.gpu
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_gpu_dense_family_greedy_tokens_match_cpu(cuda, arch):
    """Each other dense arch's ``reduced()`` config (untied heads, QKV
    bias, the GELU MLP) on the card and on the CPU: the same greedy
    tokens through a session (the f32 cache; on the batch scheduler's
    bf16 cache B3 and the plain version round differently, within 1e-2,
    which may flip a near-tied argmax)."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    tok = Tokenizer.from_texts(["what is the height of aurora bridge",
                                "who founded the meridian institute"])
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              vocab_size=tok.vocab_size, n_layers=2)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    prompts = ["what is the height of aurora bridge?",
               "who founded the meridian institute?"]
    outs = []
    f0 = ops.flash_attention.launches
    for p in (params, _to(params, cuda)):
        e = Engine(cfg, p, tok, max_len=64, chunk=4)
        ids = []
        for prompt in prompts:
            s = e.start_session(prompt, max_new=20)
            while not s.done:
                s.step_chunk()
            ids.append(s.out_ids)
        outs.append(ids)
    assert outs[0] == outs[1] and all(len(i) > 4 for i in outs[0])
    assert ops.flash_attention.launches > f0


def _teacher_forced_logits(cfg, params, tok, prompts, out_ids, max_len,
                           n_steps=None):
    """The batch scheduler's path for one wave (each prompt prefilled and
    written into a slot of a ``cfg.dtype`` cache, then ``decode_step``
    over all slots), each step fed the given tokens (with ``out_ids``
    None, each slot's greedy pick of the step before, for ``n_steps``
    steps): the prefill's last logits (B, V) and each decode step's
    (n, B, V)."""
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    e = Engine(cfg, params, tok, max_len=max_len)
    ids = [tok.encode(p, bos=True) for p in prompts]
    cache = M.init_cache(cfg, len(ids), max_len, device=e.device)
    first = []
    for slot, i in enumerate(ids):
        logits, one = e._prefill(e.tokens(i))
        e._write_slot(cache, one, slot)
        first.append(logits[0, -1])
    live = torch.ones(len(ids), dtype=torch.bool, device=e.device)
    steps = []
    n = n_steps if out_ids is None else min(len(o) for o in out_ids) - 1
    token = torch.stack(first).argmax(-1)[:, None]
    with torch.no_grad():
        for t in range(n):
            if out_ids is not None:
                token = torch.tensor([[o[t]] for o in out_ids],
                                     device=e.device)
            logits, cache = M.decode_step(cfg, params, token, cache,
                                          len(ids[0]) + t, live=live)
            steps.append(logits[:, -1])
            token = logits[:, -1].argmax(-1)[:, None]
    return torch.stack(first).cpu(), torch.stack(steps).cpu()


# The 2-layer reduced configs' logits are of unit scale (std 1). Through
# the bf16 cache B3 rounds the unnormalised exp(s - m) to bf16 before P.V
# where the plain version rounds the normalised probability (the 1e-2
# contract on attention outputs), and the output is rounded to bf16 after
# it, so an element may land one bf16 ulp (2^-8 relative) away; the output
# projection, the MLP and the head sum many such. The kernel's function
# run on the CPU (decode_partials_plain, which rounds as the kernel does)
# lands a few hundredths from the plain version on these logits.
TOL_LOGITS_BF16 = 0.1


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "starcoder2-7b"])
def test_gpu_per_row_decode_positions(cuda, arch):
    """The continuous scheduler's decode on the card (bf16 cache, B3): a
    (B,) tensor of one position gives the int path's logits and cache bit
    for bit; unequal positions, a dead row at 0, give each live row's
    logits within TOL_LOGITS_BF16 of the CPU's and leave the dead row's
    cache as it was, with one B3 launch a layer."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    tok = Tokenizer.from_texts(["what is the height of aurora bridge",
                                "who founded the meridian institute"])
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              vocab_size=tok.vocab_size, n_layers=2)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    prompts = ["what is the height of aurora bridge?", "who founded it?",
               "who founded the meridian institute of aurora?"]

    def batch(p, dev):
        e = Engine(cfg, p, tok, max_len=64)
        cache = M.init_cache(cfg, len(prompts), 64, device=dev)
        lens = []
        for slot, text in enumerate(prompts):
            ids = tok.encode(text, bos=True)
            e._write_slot(cache, e._prefill(e.tokens(ids))[1], slot)
            lens.append(len(ids))
        return cache, lens

    token = torch.tensor([[5], [6], [7]])
    live = torch.tensor([True, True, False])
    on = _to(params, cuda)
    with torch.no_grad():
        a, lens = batch(on, cuda)
        b = {n: t.clone() for n, t in a.items()}
        lg, a = M.decode_step(cfg, on, token.to(cuda), a, 20,
                              live=live.to(cuda))
        tlg, b = M.decode_step(cfg, on, token.to(cuda), b,
                               torch.full((3,), 20, device=cuda),
                               live=live.to(cuda))
        assert torch.equal(lg, tlg)
        assert all(torch.equal(a[n], b[n]) for n in a)
        pos = torch.tensor(lens[:2] + [0])
        outs = []                           # the card's, then the CPU's
        for p, dev in ((on, cuda), (params, torch.device("cpu"))):
            cache, _ = batch(p, dev)
            before = {n: t.clone() for n, t in cache.items()}
            n0 = ops.decode_attention.launches
            lg, cache = M.decode_step(cfg, p, token.to(dev), cache,
                                      pos.to(dev), live=live.to(dev))
            if dev.type == "cuda":
                assert ops.decode_attention.launches - n0 == cfg.n_layers
            assert all(torch.equal(cache[n][:, 2], before[n][:, 2])
                       for n in cache)
            outs.append(lg[:2, -1].cpu())
    torch.testing.assert_close(outs[0], outs[1], rtol=0,
                               atol=TOL_LOGITS_BF16)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_gpu_dense_family_bf16_batch_logits_match_cpu(cuda, arch):
    """The batch scheduler's bf16-cache path of each other dense arch's
    ``reduced()`` config (untied heads, QKV bias, the GELU MLP) on the
    card, teacher-forced with the CPU scheduler's greedy tokens: every
    step's logits within TOL_LOGITS_BF16 of the CPU's, so a token the two
    pick differently is a near-tie."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    tok = Tokenizer.from_texts(["what is the height of aurora bridge",
                                "who founded the meridian institute"])
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              vocab_size=tok.vocab_size, n_layers=2)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    # one wave: both prompts tokenize to 9 ids
    prompts = ["what is the height of aurora bridge?",
               "who founded the meridian institute of aurora?"]
    s = Engine(cfg, params, tok, max_len=64, chunk=4).start_batch_session(
        prompts, max_new=20)
    assert s.sched.cache["k"].dtype == torch.bfloat16
    s.run()
    out_ids = [r.out_ids for r in s.results()]
    want = _teacher_forced_logits(cfg, params, tok, prompts, out_ids, 64)
    # the teacher-forced CPU run is the scheduler's: it picks its tokens
    assert want[0].argmax(-1).tolist() == [o[0] for o in out_ids]
    assert [w.argmax(-1).tolist() for w in want[1]] == [
        [o[t] for o in out_ids] for t in range(1, len(want[1]) + 1)]
    assert len(want[1]) >= 4
    n0 = ops.decode_attention.launches
    got = _teacher_forced_logits(cfg, _to(params, cuda), tok, prompts,
                                 out_ids, 64)
    assert ops.decode_attention.launches - n0 == len(want[1]) * cfg.n_layers
    picks = got[1].argmax(-1) != want[1].argmax(-1)
    top2 = want[1].topk(2, dim=-1).values
    gaps = (top2[..., 0] - top2[..., 1])[picks]
    print(f"{arch}: bf16-cache logits, card vs CPU over {len(want[1])} "
          f"steps x {len(prompts)} slots: max abs difference "
          f"{float((got[1] - want[1]).abs().max()):.4e} (prefill "
          f"{float((got[0] - want[0]).abs().max()):.4e}); the card picks "
          f"another token at {int(picks.sum())}, where the CPU's top-2 gap "
          f"is {[round(float(x), 5) for x in gaps]}")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL_LOGITS_BF16)


def _family_cfg(arch, tok):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)),
                               vocab_size=tok.vocab_size)


def _family_launches(cfg, steps):
    """(B4, B3) launches of one prefill and of ``steps`` decode steps:
    B4 per attention entry of the layer plan (MLA's expanded heads
    included; zamba2's shared block at each invocation), B3 per GQA
    decode entry (MLA decode is plain; mamba2 has no attention)."""
    from repro_torch.models import model as M
    n = sum(any(name in ("k", "ckv") for name, _, _ in e.cache)
            for e in M.layer_plan(cfg))
    return n, 0 if cfg.use_mla else steps * n


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_gpu_families_greedy_tokens_match_cpu(cuda, arch):
    """Each moe, ssm and hybrid arch's ``reduced()`` config on the card
    and on the CPU: the same greedy tokens through a session (f32
    cache), prefill on B4 and GQA decode on B3 where the arch has them."""
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    tok = Tokenizer.from_texts(["what is the height of aurora bridge",
                                "who founded the meridian institute"])
    cfg = _family_cfg(arch, tok)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    outs = []
    for p in (params, _to(params, cuda)):
        e = Engine(cfg, p, tok, max_len=64, chunk=4)
        ids, steps = [], 0
        ops.reset_launch_counts()
        for prompt in ("what is the height of aurora bridge?",
                       "who founded the meridian institute?"):
            s = e.start_session(prompt, max_new=20)
            while not s.done:
                s.step_chunk()
            ids.append(s.out_ids)
            steps += s.chunks_run * e.chunk
        outs.append(ids)
    counts = ops.launch_counts()
    assert outs[0] == outs[1] and all(len(i) > 4 for i in outs[0])
    b4, b3 = _family_launches(cfg, steps)
    assert (counts["flash_attention"], counts["decode_attention"]) == \
        (2 * b4, b3)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_gpu_families_bf16_batch_logits_match_cpu(cuda, arch):
    """The batch scheduler's bf16-cache path (``h`` f32) of each moe, ssm
    and hybrid arch's ``reduced()`` config on the card, teacher-forced
    with the CPU scheduler's greedy tokens: every step's logits within
    TOL_LOGITS_BF16 of the CPU's, as for the dense family."""
    from repro_torch.core.tokenizer import EOS, Tokenizer
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    tok = Tokenizer.from_texts(["what is the height of aurora bridge",
                                "who founded the meridian institute"])
    cfg = _family_cfg(arch, tok)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    prompts = ["what is the height of aurora bridge?",
               "who founded the meridian institute of aurora?"]
    s = Engine(cfg, params, tok, max_len=64, chunk=4).start_batch_session(
        prompts, max_new=20)
    for n, t in s.sched.cache.items():
        assert t.dtype == (torch.float32 if n == "h" else torch.bfloat16)
    s.run()
    # the CPU's greedy tokens through the scheduler's path, 19 steps: the
    # scheduler's own picks up to the first EOS, where its request ends
    # (ROADMAP C4), so its out_ids alone may hold too few steps to feed
    want = _teacher_forced_logits(cfg, params, tok, prompts, None, 64, 19)
    picks = [[int(x[b]) for x in [want[0].argmax(-1)] + [
        w.argmax(-1) for w in want[1]]] for b in range(len(prompts))]
    for r, p in zip(s.results(), picks):
        n = p.index(EOS) + 1 if EOS in p else len(p)
        assert r.out_ids == p[:n] and n >= 4
    ops.reset_launch_counts()
    got = _teacher_forced_logits(cfg, _to(params, cuda), tok, prompts, picks,
                                 64)
    assert ops.launch_counts()["decode_attention"] == \
        _family_launches(cfg, len(want[1]))[1]
    picks = got[1].argmax(-1) != want[1].argmax(-1)
    print(f"{arch}: bf16-cache logits, card vs CPU over {len(want[1])} "
          f"steps x {len(prompts)} slots: max abs difference "
          f"{float((got[1] - want[1]).abs().max()):.4e} (prefill "
          f"{float((got[0] - want[0]).abs().max()):.4e}); the card picks "
          f"another token at {int(picks.sum())}")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL_LOGITS_BF16)


@pytest.mark.gpu
def test_gpu_layer_pattern_decode_matches_cpu(cuda):
    """nemotron-3-nano-30b-a3b's ``reduced()`` stack (Mamba-2, MoE with
    four of eight experts held, GQA; ``MEM*EM*E``) through the batch
    scheduler's bf16-cache path on the card, teacher-forced with the
    CPU's greedy tokens: prefill on B4 and every decode step's logits
    within TOL_LOGITS_BF16 of the CPU's, one B3 launch per attention
    layer a step."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.models import model as M
    tok = Tokenizer.from_texts(["what is the height of aurora bridge",
                                "who founded the meridian institute"])
    cfg = dataclasses.replace(reduced(get_config("nemotron-3-nano-30b-a3b")),
                              vocab_size=tok.vocab_size)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    prompts = ["what is the height of aurora bridge?",
               "who is the height of aurora bridge?"]
    assert len({len(tok.encode(p, bos=True)) for p in prompts}) == 1
    want = _teacher_forced_logits(cfg, params, tok, prompts, None, 64, 16)
    picks = [[int(x[b]) for x in [want[0].argmax(-1)] + [
        w.argmax(-1) for w in want[1]]] for b in range(len(prompts))]
    ops.reset_launch_counts()
    got = _teacher_forced_logits(cfg, _to(params, cuda), tok, prompts, picks,
                                 64)
    n_attn = cfg.layer_pattern.count("*")
    counts = ops.launch_counts()
    assert (counts["flash_attention"], counts["decode_attention"]) == \
        (len(prompts) * n_attn, len(want[1]) * n_attn)
    print(f"layer pattern: bf16-cache logits, card vs CPU over "
          f"{len(want[1])} steps: max abs difference "
          f"{float((got[1] - want[1]).abs().max()):.4e} (prefill "
          f"{float((got[0] - want[0]).abs().max()):.4e})")
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=TOL_LOGITS_BF16)


@pytest.mark.gpu
def test_gpu_layer_pattern_continuous_admission_matches_waves(cuda):
    """nemotron-3-nano-30b-a3b's ``reduced()`` stack on the card (B4
    prefill, B3 decode over the bf16 cache): the continuous scheduler,
    whose waiting requests take freed slots mid-flight at per-row
    positions, gives each request the wave scheduler's greedy tokens, in
    fewer chunks."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.models import model as M
    from repro_torch.serving.engine import BatchScheduler, Engine, Request
    texts = ["what is the height of aurora bridge",
             "who founded the meridian institute of aurora bridge",
             "where is the meridian bridge"]
    tok = Tokenizer.from_texts(texts)
    cfg = dataclasses.replace(reduced(get_config("nemotron-3-nano-30b-a3b")),
                              vocab_size=tok.vocab_size)
    params = _to(M.init_model(cfg, torch.Generator().manual_seed(0),
                              dtype=torch.float32, device="cpu"), cuda)
    e = Engine(cfg, params, tok, max_len=64, chunk=4)
    prompts = [texts[0], texts[2], texts[1], texts[2].replace("where", "what"),
               texts[0].replace("what", "where"), texts[1]]
    max_news = [22, 5, 18, 9, 14, 6]
    out, chunks = [], []
    for continuous in (False, True):
        sched = BatchScheduler(e, 3, continuous=continuous)
        for i, (p, n) in enumerate(zip(prompts, max_news)):
            sched.submit(Request(rid=i, prompt=p, max_new=n))
        ran = 0
        while sched.step_chunk() or sched.waiting:
            ran += 1
        out.append({r.rid: r.out_ids for r in sched.finished})
        chunks.append(ran)
    assert out[1] == out[0] and len(out[1]) == len(prompts)
    assert chunks[1] < chunks[0] and max(sched.slot_uses) >= 2


@pytest.mark.gpu
def test_gpu_train_contrastive_matches_cpu(cuda):
    """Five steps of MiniLM contrastive training on the card (the plain
    attention under autograd, TF32 off) against the CPU from the same
    weights and batch draws: losses within 1e-4 relative, parameters
    within 1e-4."""
    from repro_torch.core.embedder import EncoderCfg, MiniLMEncoder
    from repro_torch.core.index import exact_fp32
    from repro_torch.core.kb import build_kb, render_query
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.models.convert import tree_leaves
    exact_fp32()
    kb = build_kb("squad", n_docs=6)
    tok = Tokenizer.from_texts([d.text() for d in kb.docs], max_vocab=512)
    cfg = EncoderCfg(vocab_size=tok.vocab_size, dim=64, n_layers=2,
                     n_heads=4, d_ff=128, max_len=24)
    pairs = [(render_query(f, 0), render_query(f, 2)) for f in kb.facts[:64]]
    cpu = MiniLMEncoder(tok, cfg, seed=0, device="cpu")
    gpu = MiniLMEncoder(tok, cfg, params=_to(cpu.params, cuda), device=cuda)
    n0 = ops.flash_attention.launches
    got = gpu.train_contrastive(pairs, steps=5, bs=16, lr=2e-3)
    assert ops.flash_attention.launches == n0      # no kernel under autograd
    want = cpu.train_contrastive(pairs, steps=5, bs=16, lr=2e-3)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    for a, b in zip(tree_leaves(gpu.params), tree_leaves(cpu.params)):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.gpu
def test_gpu_session_past_max_len_matches_cpu(cuda):
    """A prompt longer than ``max_len`` (cut to max_len - 1 tokens; every
    decode step then writes the cache's last slot and passes B3 a length
    past the cache): greedy tokens on the card equal the CPU's."""
    import dataclasses

    from repro_torch.configs import get_config, reduced
    from repro_torch.core.tokenizer import Tokenizer
    from repro_torch.models import model as M
    from repro_torch.serving.engine import Engine
    words = "what is the height of aurora bridge who founded the meridian"
    tok = Tokenizer.from_texts([words])
    cfg = dataclasses.replace(reduced(get_config("qwen3-1.7b")),
                              vocab_size=tok.vocab_size, n_layers=2)
    params = M.init_model(cfg, torch.Generator().manual_seed(1),
                          dtype=torch.float32, device="cpu")
    prompt = " ".join([words] * 10)
    assert len(tok.encode(prompt, bos=True)) > 64
    outs = []
    for p in (params, _to(params, cuda)):
        e = Engine(cfg, p, tok, max_len=64, chunk=4)
        s = e.start_session(prompt, max_new=20)
        while not s.done:
            s.step_chunk()
        outs.append((s.out_ids, e.generate(prompt, max_new=20)))
    assert outs[0] == outs[1] and len(outs[0][0]) > 4


def _unit_rows(n, d, seed=0):
    x = np.random.default_rng(seed).normal(size=(n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.gpu
def test_gpu_incremental_index_flat_matches_cpu(cuda):
    """The dedup index's flat mode on the card against the CPU: max_sim
    within 1e-6 (f32 summation order; TF32 off) and the same decisions at
    the 0.99 threshold, duplicates included."""
    from repro_torch.core.index import IncrementalIndex
    x = _unit_rows(3000, 384)
    idx = {d: IncrementalIndex(384, flat_max_rows=10_000, device=d)
           for d in ("cpu", cuda)}
    for lo in range(0, 3000, 32):
        for i in idx.values():
            i.add(x[lo:lo + 32])
    q = np.concatenate([_unit_rows(64, 384, seed=1), x[::50],
                        (x[:20] + 0.1 * _unit_rows(20, 384, 2)) / 1.005])
    a, b = idx["cpu"].max_sim(q), idx[cuda].max_sim(q)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(a >= 0.99, b >= 0.99)
    assert idx[cuda].mode == "flat" and (a >= 0.99).sum() >= 60


@pytest.mark.gpu
def test_gpu_incremental_ivf_state_independent_of_add_batching(cuda):
    """On the card: one add, shard-sized adds (a resumed build's rebuild)
    and wave-sized adds (the build) give the same centroids, the same
    lists and the same max_sim bits."""
    from repro_torch.core.index import IncrementalIndex
    x = _unit_rows(5000, 384)
    q = np.concatenate([_unit_rows(32, 384, seed=3), x[::157]])
    got = []
    for step in (5000, 1000, 32):
        idx = IncrementalIndex(384, flat_max_rows=512, device=cuda)
        for lo in range(0, 5000, step):
            idx.add(x[lo:lo + step])
        assert idx.mode == "ivf" and idx.refits == 4
        got.append((idx.centroids.cpu(), idx.assignment(), idx.max_sim(q)))
    for c, a, m in got[1:]:
        assert torch.equal(c, got[0][0])
        np.testing.assert_array_equal(a, got[0][1])
        np.testing.assert_array_equal(m, got[0][2])
    np.testing.assert_allclose(got[0][2][32:], 1.0, atol=1e-5)


@pytest.mark.gpu
def test_gpu_pipeline_build_independent_of_device(cuda, tmp_path):
    """A hash-embedded build with the dedup index on the card writes the
    same store, byte for byte, as one with it on the CPU (flat mode)."""
    from repro_torch.core.embedder import HashEmbedder
    from repro_torch.core.generator import SyntheticOracleLM, chunk_key
    from repro_torch.core.kb import build_kb
    from repro_torch.core.precompute import PrecomputeCfg, PrecomputePipeline
    from repro_torch.core.store import PrecomputedStore
    from repro_torch.core.tokenizer import Tokenizer
    kb = build_kb("squad", n_docs=20)
    tok = Tokenizer.from_texts([d.text() for d in kb.docs])
    chunks = [chunk_key(d.doc_id, d.text()) for d in kb.docs]
    for dev in ("cpu", "cuda"):
        st = PrecomputedStore(tmp_path / dev, dim=384, shard_rows=256)
        PrecomputePipeline(SyntheticOracleLM(kb), HashEmbedder(), tok,
                           cfg=PrecomputeCfg(wave=32), device=dev).run(
            chunks, 1024, store=st, seed=0)
        st.close()
    for f in sorted(p.name for p in (tmp_path / "cpu").iterdir()):
        if f != "manifest.json":
            assert (tmp_path / "cpu" / f).read_bytes() == \
                (tmp_path / "cuda" / f).read_bytes(), f


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    return x.to(device)


# ---------------------------------------------------------------------------
# encdec (whisper) and vlm (qwen2-vl, M-RoPE); single-device training
# ---------------------------------------------------------------------------


def _encdec_vlm_inputs(cfg, B, S, seed=0):
    """tokens (B, S), and whisper's frames (B, Te, d) or qwen2-vl's M-RoPE
    positions (a text prefix, a 2x2 image block, a text suffix)."""
    g = torch.Generator().manual_seed(seed)
    tokens = torch.randint(4, cfg.vocab_size, (B, S), generator=g)
    kw = {}
    if cfg.is_encoder_decoder:
        kw["frames"] = torch.randn((B, cfg.encoder_seq, cfg.d_model),
                                   generator=g)
    if cfg.rope_kind == "mrope":
        pos = [[i] * 3 for i in range(3)] + [[3, 3 + r, 3 + c] for r in
                                             range(2) for c in range(2)]
        pos += [[5 + i] * 3 for i in range(S - len(pos))]
        kw["mrope_positions"] = torch.tensor(pos).T[:, None, :].expand(
            3, B, S).contiguous()
    return tokens, kw


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ENCDEC_VLM_ARCHS)
def test_gpu_encdec_vlm_greedy_tokens_match_cpu(cuda, arch):
    """Each reduced config through the model API on the card and on the
    CPU: prefill (B4 for whisper's encoder layers, its decoder's self- and
    cross-attention, qwen2-vl's M-RoPE attention) and two chunks of 4
    greedy decode steps (B3 for the self-attention and whisper's
    cross-attention): the same tokens, the prefill logits within 1e-4,
    and the launches the layers call for."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import model as M
    cfg = reduced(get_config(arch))
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    tokens, kw = _encdec_vlm_inputs(cfg, 2, 12)
    outs, first = [], []
    for dev in ("cpu", cuda):
        ops.reset_launch_counts()
        p = params if dev == "cpu" else _to(params, dev)
        lg, cache = M.prefill(cfg, p, dict(
            {k: v.to(dev) for k, v in kw.items()}, tokens=tokens.to(dev)),
            max_len=40)
        first.append(lg.cpu())
        ids = [lg[:, -1].argmax(-1)]
        for t in range(8):
            lg, cache = M.decode_step(cfg, p, ids[-1][:, None], cache, 12 + t)
            ids.append(lg[:, -1].argmax(-1))
        outs.append(torch.stack(ids, 1).cpu())
    counts = ops.launch_counts()
    torch.testing.assert_close(first[1], first[0], rtol=1e-4, atol=1e-4)
    assert torch.equal(outs[0], outs[1])
    n_b4 = cfg.n_layers * (2 if cfg.is_encoder_decoder else 1) + \
        cfg.n_encoder_layers
    n_b3 = 8 * cfg.n_layers * (2 if cfg.is_encoder_decoder else 1)
    assert (counts["flash_attention"], counts["decode_attention"]) == \
        (n_b4, n_b3)


def _copy(tree, device, dtype=None):
    """A copy of a params tree on ``device`` (in ``dtype``)."""
    from repro_torch.models.convert import tree_map
    return tree_map(lambda t: t.to(device, dtype=dtype, copy=True), tree)


def _train_setup(arch="qwen3-1.7b"):
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.index import exact_fp32
    from repro_torch.models import model as M
    from repro_torch.training import data as D
    exact_fp32()
    cfg = reduced(get_config(arch))
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          dtype=torch.float32, device="cpu")
    data = D.SyntheticLMData(cfg.vocab_size, 4, 32, seed=0)
    return cfg, params, data


@pytest.mark.gpu
def test_gpu_train_step_matches_cpu(cuda):
    """Two train steps (blockwise attention over 16-row tiles, its
    hand-written backward, AdamW at lr 1e-3, TF32 off) on the card and
    on the CPU from the same weights and batches: losses within 1e-5
    relative, grad norms within 1e-4, the weights within 1e-4 (a tenth of
    lr: Adam's first steps move a weight by about lr times the sign of
    its gradient, which rounding decides where the gradient is near 0).
    B4 is never launched: it has no backward."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import tree_leaves
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as T
    cfg, params, data = _train_setup()
    run = M.RunCfg(attn_impl="blockwise", q_block=16, kv_block=16)
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=1)
    res = []
    for dev in ("cpu", cuda):
        ops.reset_launch_counts()
        p = _copy(params, dev)          # the step updates p in place
        o = O.init(p)
        step = T.make_train_step(cfg, run, ocfg, accum=2)
        ms = []
        for i in range(2):
            b = {k: torch.from_numpy(v).long().to(dev)
                 for k, v in data.batch(i).items()}
            p, o, m = step(p, o, b)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        res.append((ms, [t.cpu() for t in tree_leaves(p)]))
        assert ops.launch_counts()["flash_attention"] == 0
    for (l0, g0), (l1, g1) in zip(res[0][0], res[1][0]):
        np.testing.assert_allclose(l1, l0, rtol=1e-5)
        np.testing.assert_allclose(g1, g0, rtol=1e-4)
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_gpu_checkpoint_round_trip_on_the_card(cuda, tmp_path):
    """bf16 params and f32 AdamW state on the card: saved (the host copy
    now, the write on a thread), restored onto the card bit for bit, and
    the next step from the restored state equals the uninterrupted one
    bit for bit."""
    from repro_torch.models import model as M
    from repro_torch.models.convert import tree_leaves
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as T
    cfg, params, data = _train_setup()
    p = _copy(params, cuda, torch.bfloat16)
    o = O.init(p)
    step = T.make_train_step(cfg, M.RunCfg(q_block=16, kv_block=16),
                             O.AdamWCfg(lr=1e-3, warmup_steps=1))
    batch = [{k: torch.from_numpy(v).long().to(cuda) for k, v in
              data.batch(i).items()} for i in range(2)]
    p, o, _ = step(p, o, batch[0])
    ck = CK.Checkpointer(tmp_path / "ck")
    ck.save(1, {"params": p, "opt": o})
    ck.wait()
    st, meta = ck.restore(device=cuda)
    assert meta["keys"]["params/embed/w"][1] == "bfloat16"
    for a, b in zip(tree_leaves({"params": p, "opt": o}), tree_leaves(st)):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu())
    st["opt"]["step"] = st["opt"]["step"].cpu()
    p2, _, _ = step(st["params"], st["opt"], batch[1])
    p1, _, _ = step(p, o, batch[1])
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The mesh paths on four shards of one card (no bytes cross cards)
# ---------------------------------------------------------------------------


def _card_mesh(cuda, data=1, model=4):
    from repro_torch.launch.mesh import make_mesh
    return make_mesh((data, model), ("data", "model"),
                     devices=[cuda] * (data * model))


@pytest.mark.gpu
@pytest.mark.parametrize("emb_dtype,n", [("float16", 4096),
                                         ("float32", 4099), ("int8", 4099)])
def test_gpu_sharded_index_matches_plain_on_four_shards(cuda, tmp_path,
                                                        emb_dtype, n):
    """``ShardedIndex`` over four shards of the card: the float shards
    scan on B1 (one launch a shard), the int8 shards with a plain product
    on the card (no kernel), against the plain scan of every row on the
    card; an odd N pads and masks the last shard."""
    from repro_torch.core.index import ShardedIndex, exact_fp32
    from repro_torch.core.store import PrecomputedStore
    exact_fp32()
    x = _unit_rows(n, 384)
    st = PrecomputedStore(tmp_path / "s", dim=384, emb_dtype=emb_dtype,
                          shard_rows=1024)
    st.add_batch(x, [f"q{i}" for i in range(n)], [f"r{i}" for i in range(n)])
    st.flush()
    idx = ShardedIndex(st.embeddings(), _card_mesh(cuda))
    assert all(s.is_cuda for s in idx.embs.shards.flat)
    q = _unit_rows(16, 384, seed=3)
    ops.reset_launch_counts()
    v, i = idx.search(q, 5)
    counts = ops.launch_counts()
    assert counts["mips_topk"] == (0 if emb_dtype == "int8" else 4)
    assert counts["mips_topk_int8"] == 0
    qt = _t(q).to(cuda)
    if emb_dtype == "int8":
        vals, sc = st.embeddings().take_q(np.arange(n))
        s = (qt @ _t(vals).to(cuda).float().T) * _t(sc).to(cuda)[None, :]
    else:
        s = qt @ _t(np.asarray(st.embeddings(), np.float32)).to(cuda).T
    pv, pi = ref.topk_by_value(s, 5)
    np.testing.assert_array_equal(i, pi.cpu().numpy())
    np.testing.assert_allclose(v, pv.cpu().numpy(), rtol=1e-5, atol=1e-6)
    st.close()


def _reduced(arch, **kw):
    import dataclasses

    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)), **kw)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
def test_gpu_seq_sharded_decode_matches_one_device(cuda, arch):
    """One attention layer's decode (GQA: B3 on one device; MLA: the plain
    absorbed decode) against ``RunCfg(decode_attn="seq_sharded")`` over
    four shards of the card: a 160-row f32 cache, batch 4, the write at
    100 (shard 2) and at 200 (past the end: the last slot, in shard 3),
    a dead slot kept."""
    from repro_torch.core.index import exact_fp32
    from repro_torch.distributed.sharding import shard
    from repro_torch.models import model as M
    exact_fp32()
    cfg = _reduced(arch)
    p = M.init_model(cfg, torch.Generator().manual_seed(0),
                     dtype=torch.float32, device="cpu")["blocks"][0]["attn"]
    p = _to(p, cuda)
    run = M.RunCfg(decode_attn="seq_sharded", mesh=_card_mesh(cuda))
    names = ("ckv", "krope") if cfg.use_mla else ("k", "v")
    c = M.cache_struct(cfg, 4, 160, torch.float32)
    g = torch.Generator(device=cuda).manual_seed(1)
    for clen in (100, 200):
        x = torch.randn((4, 1, cfg.d_model), generator=g, device=cuda)
        one = [torch.randn(c[n][0][1:], generator=g, device=cuda)
               for n in names]
        sh = [shard(t, (None, "model"), run.mesh) for t in one]
        live = torch.tensor([True, True, False, True], device=cuda)
        lengths = torch.full((4,), min(clen, 159), dtype=torch.int32,
                             device=cuda)
        ops.reset_launch_counts()
        if cfg.use_mla:
            want = M.mla_decode(cfg, p, x, *one, clen, live)
            got = M.mla_decode(cfg, p, x, *sh, clen, live, run=run)
            tol = 1e-4
        else:
            want = M.gqa_decode(cfg, p, x, *one, clen, lengths, live)
            assert ops.launch_counts()["decode_attention"] == 1
            got = M.gqa_decode(cfg, p, x, *sh, clen, lengths, live, run=run)
            assert ops.launch_counts()["decode_attention"] == 1
            tol = 2e-4          # B3's f32 contract
        torch.testing.assert_close(got, want, rtol=tol, atol=tol)
        for a, b in zip(sh, one):
            assert torch.equal(a.full(), b)


@pytest.mark.gpu
def test_gpu_expert_parallel_moe_matches_scatter(cuda):
    """``moe_ffn_ep`` over four shards of the card against the one-device
    scatter ``moe_ffn``, with no drops (capacity factor 64) and with the
    full config's capacity (drops per shard: compared on the shards' own
    token sets)."""
    from repro_torch.core.index import exact_fp32
    from repro_torch.distributed.moe_parallel import moe_ffn_ep
    from repro_torch.models import moe as Moe
    exact_fp32()
    cfg = _reduced("deepseek-v2-lite-16b", moe_capacity_factor=64.0)
    p = _to(Moe.moe_init(torch.Generator().manual_seed(0), cfg,
                         torch.float32, "cpu"), cuda)
    x = torch.randn((4, 48, cfg.d_model), generator=torch.Generator(
        device=cuda).manual_seed(2), device=cuda)
    y, aux = moe_ffn_ep(cfg, p, x, mesh=_card_mesh(cuda))
    want, want_aux = Moe.moe_ffn(cfg, p, x, with_aux=True)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(aux, want_aux, rtol=1e-4, atol=0)
    # with drops: each shard (a quarter of the sequence) is its own
    # scatter call with its own capacity
    cfg = _reduced("deepseek-v2-lite-16b", moe_capacity_factor=1.0)
    y = moe_ffn_ep(cfg, p, x, mesh=_card_mesh(cuda))[0]
    want = torch.cat([Moe.moe_ffn(cfg, p, x[:, j * 12:(j + 1) * 12])
                      for j in range(4)], dim=1)
    torch.testing.assert_close(y, want, rtol=1e-4, atol=1e-4)


@pytest.mark.gpu
def test_gpu_mesh_mixing_devices_raises(cuda):
    from repro_torch.launch.mesh import make_local_mesh, make_mesh
    with pytest.raises(ValueError, match="one type"):
        make_mesh((2,), ("model",), devices=[cuda, "cpu"])
    with pytest.raises(ValueError, match="distinct cuda"):
        make_local_mesh(model=torch.cuda.device_count() + 1)


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "deepseek-v2-lite-16b"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)])
def test_gpu_mesh_train_step_matches_one_device(cuda, arch, shape):
    """Two train steps on four shards of the card (TP heads and MLP or MLA
    and expert parallel, FSDP, vocab-split logits, remat, sequence
    parallel on the second) against one device's, f32, TF32 off: losses
    within 1e-5 relative, grad norms within 1e-4, params within 1e-4 (a
    tenth of lr: Adam's first steps move a weight by about lr times the
    sign of its gradient, which rounding decides near 0). Neither B3 nor
    B4 is launched."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as Sh
    from repro_torch.launch.specs import make_runcfg
    from repro_torch.models.convert import tree_leaves
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as T
    cfg, params, data = _train_setup(arch)
    mesh = _card_mesh(cuda, *shape)
    run = make_runcfg(cfg, ShapeConfig("train", 32, 4, "train"), mesh,
                      q_block=16, kv_block=16)
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=1)
    res = []
    ops.reset_launch_counts()
    for r in (run.replace(mesh=None, moe_impl="scatter"), run):
        p = _copy(params, cuda)
        if r.mesh is not None:
            p = Sh.place(p, Sh.param_shardings(p, mesh, cfg))
        o = O.init(p)
        ms = []
        for i, sp in enumerate((False, True)):
            b = {k: torch.from_numpy(v).long().to(cuda)
                 for k, v in data.batch(i).items()}
            p, o, m = T.make_train_step(cfg, r.replace(seq_parallel=sp),
                                        ocfg)(p, o, b)
            ms.append((float(m["loss"]), float(m["grad_norm"])))
        res.append((ms, [t.cpu() for t in tree_leaves(Sh.gather(p))]))
    assert ops.launch_counts()["flash_attention"] == 0
    assert ops.launch_counts()["decode_attention"] == 0
    for (l0, g0), (l1, g1) in zip(res[0][0], res[1][0]):
        np.testing.assert_allclose(l1, l0, rtol=1e-5)
        np.testing.assert_allclose(g1, g0, rtol=1e-4)
    for a, b in zip(res[0][1], res[1][1]):
        torch.testing.assert_close(b, a, rtol=0, atol=1e-4)


@pytest.mark.gpu
def test_gpu_mesh_checkpoint_restores_across_meshes_bit_for_bit(cuda,
                                                                tmp_path):
    """bf16 params and f32 AdamW state on a (2, 2) mesh of the card, one
    step, saved; restored onto (1, 4) and onto one device: every leaf
    bit for bit; the next step's loss on (1, 4) within 1e-3 of the next
    on (2, 2) (bf16: the row-parallel products split over 4 shards, not
    2, and each partial sum is rounded to bf16, 2^-8 relative)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import sharding as Sh
    from repro_torch.launch.specs import make_runcfg
    from repro_torch.models.convert import tree_leaves
    from repro_torch.training import checkpoint as CK
    from repro_torch.training import optimizer as O
    from repro_torch.training import train as T
    cfg, params, data = _train_setup()
    ocfg = O.AdamWCfg(lr=1e-3, warmup_steps=1)
    batch = [{k: torch.from_numpy(v).long().to(cuda) for k, v in
              data.batch(i).items()} for i in range(2)]
    meshes = [_card_mesh(cuda, 2, 2), _card_mesh(cuda, 1, 4)]
    runs = [make_runcfg(cfg, ShapeConfig("train", 32, 4, "train"), m,
                        q_block=16, kv_block=16) for m in meshes]
    p = _copy(params, cuda, torch.bfloat16)
    pshard = Sh.param_shardings(p, meshes[0], cfg)
    p = Sh.place(p, pshard)
    o = O.init(p)
    p, o, _ = T.make_train_step(cfg, runs[0], ocfg)(p, o, batch[0])
    ck = CK.Checkpointer(tmp_path / "ck")
    ck.save(1, {"params": p, "opt": o}, blocking=True)
    want = [t.cpu() for t in tree_leaves(Sh.gather({"params": p,
                                                    "opt": o}))]
    ps_b = Sh.param_shardings(p, meshes[1], cfg)
    st, _ = ck.restore(shardings={"params": ps_b,
                                  "opt": O.state_shardings(ps_b)})
    assert all(t.shards.flat[0].device.type == cuda.type
               for t in tree_leaves(st["params"]))
    got = [t.cpu() for t in tree_leaves(Sh.gather(st))]
    one, _ = ck.restore(device=cuda)
    for a, b, c in zip(want, got, tree_leaves(one)):
        assert a.dtype == b.dtype and torch.equal(a, b)
        assert torch.equal(a, c.cpu())
    p1, _, m1 = T.make_train_step(cfg, runs[0], ocfg)(p, o, batch[1])
    p2, _, m2 = T.make_train_step(cfg, runs[1], ocfg)(st["params"],
                                                      st["opt"], batch[1])
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-3)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["mips_topk", "mips_topk_int8",
                                  "decode_attention", "flash_attention"])
def test_gpu_kernel_credit_same_on_card_and_cpu(cuda, name):
    """Under the cost counter (``launch/costs.py``) a wrapper call credits
    the kernel's own work: one launch on the card, the plain version on
    the CPU, and the same FLOPs and bytes either way (B3 at ragged
    lengths: the attended rows)."""
    from repro_torch.launch import costs
    g = torch.Generator().manual_seed(3)
    r = lambda *s: torch.randn(*s, generator=g)          # noqa: E731
    q8, qs = (torch.from_numpy(a) for a in quantize_rows(
        np.random.default_rng(0).standard_normal((5, 100), np.float32)))
    x8, xs = (torch.from_numpy(a) for a in quantize_rows(
        np.random.default_rng(1).standard_normal((700, 100), np.float32)))
    calls = {
        "mips_topk": (lambda q, x: ops.mips_topk(q, x, 7, 512),
                      (r(5, 100), r(700, 100).half())),
        "mips_topk_int8": (lambda *a: ops.mips_topk_int8(*a, 7, 512),
                           (q8, qs, x8, xs)),
        "decode_attention": (ops.decode_attention, (
            r(3, 8, 64), r(3, 90, 4, 64).bfloat16(),
            r(3, 90, 4, 64).bfloat16(),
            torch.tensor([5, 89, 200], dtype=torch.int32))),
        "flash_attention": (lambda *a: ops.flash_attention(*a, True),
                            (r(2, 70, 6, 64), r(2, 70, 2, 64),
                             r(2, 70, 2, 64))),
    }
    fn, ins = calls[name]
    ops.reset_launch_counts()
    on_card = costs.fn_costs(fn, *(t.to(cuda) for t in ins))
    assert ops.launch_counts()[name] == 1
    on_cpu = costs.fn_costs(fn, *ins)
    assert on_card["kernels"] == on_cpu["kernels"]
    for key in ("dot_flops", "bytes_min", "flops", "bytes"):
        assert on_card[key] == on_cpu[key], key
