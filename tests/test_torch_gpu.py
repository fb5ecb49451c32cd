"""The port's CUDA kernels against their plain PyTorch versions, on the
card. Every test here is marked ``gpu`` and skips without a CUDA device
(a CUDA kernel has no CPU mode); this file imports nothing of JAX, so it
runs where only the port is installed:

    python -m pytest -q -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.store import quantize_rows
from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (decode_attention_plain,
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
    rng = np.random.default_rng(Q * 7 + N)
    q8, qs = quantize_rows(rng.normal(size=(Q, D)).astype(np.float32))
    x8, xs = quantize_rows(rng.normal(size=(N, D)).astype(np.float32))
    v, i = ops.mips_topk_int8(*(_t(a).to(cuda) for a in (q8, qs, x8, xs)),
                              k, tile)
    vr, ir = ref.mips_topk_int8_ref(q8, qs, x8, xs, k)
    assert np.array_equal(v.cpu().numpy(), vr)
    assert np.array_equal(i.cpu().numpy(), ir)


@pytest.mark.gpu
@pytest.mark.parametrize("kv_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,T,Hq,Hkv,D,ns", DECODE_SHAPES + [(4, 160, 16, 8,
                                                               128, 8)])
def test_gpu_decode_attention_kernel_matches_plain(cuda, kv_dtype, B, T, Hq,
                                                   Hkv, D, ns):
    from repro_torch.kernels.decode_attention import decode_partials_cuda
    q, k, v, lengths = (_t(a).to(cuda) for a in
                        _decode_inputs(B, T, Hq, Hkv, D, T + Hq))
    k, v = k.to(kv_dtype), v.to(kv_dtype)
    o, m, l = decode_partials_cuda(ops._lib("decode_attention"), q, k, v,
                                   lengths, ns)
    op, mp, lp = decode_partials_plain(q, k, v, lengths, ns)
    tol = 2e-4 if kv_dtype == torch.float32 else 1e-2
    torch.testing.assert_close(m, mp, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(l, lp, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(o, op, rtol=tol, atol=tol)
    got = ops.decode_attention(q, k, v, lengths, ns)
    torch.testing.assert_close(got, decode_attention_plain(q, k, v, lengths),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
def test_gpu_kernel_launch_refuses_bad_inputs(cuda):
    q = torch.zeros((2, 8), device=cuda)
    with pytest.raises(ValueError):
        ops.mips_topk(q, torch.zeros((4, 8)), 1)      # mixed devices
    with pytest.raises(TypeError):
        ops.mips_topk(q.half(), torch.zeros((4, 8), device=cuda), 1)


@pytest.mark.gpu
def test_gpu_engine_greedy_tokens_match_cpu(cuda):
    """The smoke-arch engine on the card (decode attention on the B3
    kernel, f32 session cache) emits the same greedy tokens as on the CPU
    (the plain version)."""
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
    for p in (params, on_gpu):
        s = Engine(cfg, p, tok, max_len=64, chunk=4).start_session(
            "what is the height of aurora bridge?", max_new=20)
        while not s.done:
            s.step_chunk()
        outs.append(s.out_ids)
    assert outs[0] == outs[1]
    assert ops.decode_attention.launches > n0


def _to(x, device):
    if isinstance(x, dict):
        return {k: _to(v, device) for k, v in x.items()}
    if isinstance(x, list):
        return [_to(v, device) for v in x]
    return x.to(device)
