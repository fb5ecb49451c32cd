"""The port's layer-pattern stack (``nemotron-3-nano-30b-a3b``: Mamba-2,
MoE and GQA single-mixer blocks in a published order) against the
benchmark's plain PyTorch reference, ``storbench/reference/nemotron_h.py``,
on the CPU. The JAX package has no such arch, so nothing here imports it.

The config is the arch's ``reduced()`` one: the pattern ``MEM*EM*E``
(every block kind twice or more), two SSM groups, four of the router's
eight experts held, weights drawn from a seed by the benchmark's own
``weights.fill`` (so the correction bias, the norms and ``A_log`` are not
at their zero or one inits). The tests: the full forward against the
reference; prefill then decode through ``BatchScheduler``'s bf16 cache,
two prompt lengths in two waves, against the reference's one pass with
the cache's rounding; the two held halves of the experts, with the shared
expert counted once, summing to the uncut layer; the grouped gated norm
(one group: today's norm bit for bit); deepseek's routing and
``moe_ffn`` bit for bit against the code before layer patterns existed;
the spans and counters the stack records.

Tolerances (f32 on the CPU): 2e-5 on logits between the port's chunked
SSD and the reference's token-by-token recurrence (measured 5.0e-6 on
logits up to 4.2);
served tokens within 1e-4 of the reference's best logit (measured 0: the
reference keeps the cache's bf16 rounding as the port does).
"""
import dataclasses
import importlib.util
import sys
import types
from pathlib import Path

import pytest
import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.configs import get_config, reduced
from repro_torch.core.tokenizer import Tokenizer
from repro_torch.models import layers as Lyr
from repro_torch.models import model as M
from repro_torch.models import moe as Moe
from repro_torch.serving.engine import (BatchScheduler, Engine, Request,
                                        decode_rows_independent)
from repro_torch.serving.scheduler import ServingPipeline

ARCH = "nemotron-3-nano-30b-a3b"
BENCH = Path(__file__).resolve().parents[1] / "storbench"
TOL_LOGITS = 2e-5
TOL_SERVED = 1e-4


def _load(path: Path, name: str):
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# the reference imports its sibling ``lm`` by that name
_load(BENCH / "reference" / "lm.py", "lm")
REF = _load(BENCH / "reference" / "nemotron_h.py", "storbench_nemotron_h")
W = _load(BENCH / "weights.py", "storbench_weights")


def tiny(**kw):
    return dataclasses.replace(reduced(get_config(ARCH)), **kw)


def file_of(cfg) -> dict:
    """The configuration file's keys (the source's names) for ``cfg``."""
    return dict(REF._STATED, **{
        "name": cfg.name, "hidden_size": cfg.d_model,
        "num_hidden_layers": cfg.n_layers,
        "hybrid_override_pattern": cfg.layer_pattern,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
        "vocab_size": cfg.vocab_size, "mamba_num_heads": cfg.ssm_heads,
        "mamba_head_dim": cfg.ssm_head_dim, "n_groups": cfg.ssm_n_groups,
        "ssm_state_size": cfg.ssm_state, "conv_kernel": cfg.ssm_conv,
        "chunk_size": cfg.ssm_chunk,
        "moe_intermediate_size": cfg.d_ff_expert,
        "moe_shared_expert_intermediate_size": cfg.d_ff_shared,
        "n_routed_experts": cfg.n_experts,
        "published_n_routed_experts": cfg.n_router,
        "first_held_expert": cfg.first_expert,
        "num_experts_per_tok": cfg.experts_per_tok,
        "routed_scaling_factor": cfg.routed_scale,
        "moe_capacity_factor": cfg.moe_capacity_factor,
        "layer_norm_epsilon": cfg.norm_eps})


def weights(cfg, seed=2 ** 31 + 7):
    layout = W.layout_of(M.init_model(cfg, None, torch.float32, "meta"))
    return W.fill(layout, seed, torch.device("cpu"))


def test_the_arch_and_its_share_count_as_published():
    cfg = get_config(ARCH)
    assert cfg.layer_pattern.count("M") == cfg.layer_pattern.count("E") \
        == 23 and cfg.layer_pattern.count("*") == 6
    assert (cfg.d_inner_ssm, cfg.n_ssm_heads, cfg.shared_width) == \
        (4096, 64, 3712)
    assert cfg.param_count() == pytest.approx(31.58e9, rel=1e-3)
    held = dataclasses.replace(cfg, n_experts=64)
    assert held.param_count() == pytest.approx(16.89e9, rel=1e-3)
    # no assignment drops at any call size: capacity >= tokens
    for T in (1, 7, 23, 32, 160):
        assert Moe.capacity(held, T) >= T


def test_forward_matches_the_reference():
    cfg = tiny(dtype="float32")
    params = weights(cfg)
    ids = torch.randint(1, cfg.vocab_size, (12,),
                        generator=torch.Generator().manual_seed(1)).tolist()
    got = M.forward(cfg, params, {"tokens": torch.tensor([ids])},
                    M.SMOKE)[0][0]
    want = REF.served_logits(file_of(cfg), params, ids[:1], ids[1:] + [0],
                             cache_dtype=torch.float32)
    torch.testing.assert_close(got, want, rtol=0, atol=TOL_LOGITS)


@pytest.mark.parametrize("cache", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_prefill_and_decode_match_one_pass(cache):
    """The prefill's last logits and every decode step's, through the
    cache of ``cfg.dtype``, against the reference's pass with that
    cache's rounding."""
    cfg = tiny(dtype=str(cache).split(".")[1])
    params = weights(cfg)
    ids = torch.randint(1, cfg.vocab_size, (14,),
                        generator=torch.Generator().manual_seed(2)).tolist()
    S = 9
    want = REF.served_logits(file_of(cfg), params, ids[:S], ids[S:] + [0],
                             cache_dtype=cache)
    with torch.no_grad():
        lg, one = M.prefill(cfg, params, torch.tensor([ids[:S]]),
                            max_len=32)
        c = M.init_cache(cfg, 2, 32, device="cpu")
        for n, t in c.items():
            t[:, 1] = one[n][:, 0].to(t.dtype)      # slot 1; slot 0 dead
        got = [lg[0, -1]]
        live = torch.tensor([False, True])
        for j, t in enumerate(ids[S:]):
            tok = torch.tensor([[0], [t]])
            lg, c = M.decode_step(cfg, params, tok, c, S + j, live=live)
            got.append(lg[1, -1])
    torch.testing.assert_close(torch.stack(got), want, rtol=0,
                               atol=TOL_LOGITS)
    assert not c["h"][:, 0].any() and not c["k"][:, 0].any()


def test_waves_of_two_lengths_decode_the_reference_tokens():
    texts = ["what is the height of aurora bridge",
             "who founded the meridian institute of aurora",
             "where is the meridian bridge"]
    tok = Tokenizer.from_texts(texts)
    cfg = tiny()                       # bf16 cache, f32 weights
    params = weights(cfg)
    e = Engine(cfg, params, tok, max_len=48, chunk=4)
    prompts = [texts[0], texts[0].replace("what", "where"), texts[2],
               texts[2].replace("where", "what")]
    lens = [len(tok.encode(p, bos=True)) for p in prompts]
    assert lens[0] == lens[1] != lens[2] == lens[3]
    sched = BatchScheduler(e, 4)
    for i in range(4):
        sched.submit(Request(rid=i, prompt=prompts[i], max_new=10))
    sched.run_to_completion()
    assert sched.waves == 2 and len(sched.finished) == 4
    c = file_of(cfg)
    for r in sched.finished:
        ids = tok.encode(r.prompt, bos=True)
        lg = REF.served_logits(c, params, ids, r.out_ids,
                               cache_dtype=torch.bfloat16)
        picked = lg.gather(1, torch.tensor(r.out_ids)[:, None])[:, 0]
        assert float((lg.max(1).values - picked).max()) <= TOL_SERVED
        assert len(r.out_ids) >= 2


CONT_TEXTS = ["what is the height of aurora bridge",
              "who founded the meridian institute of aurora bridge",
              "where is the meridian bridge"]


def _both_schedulers(e, prompts, max_news, slots=3):
    """The wave and the continuous scheduler over ``slots`` slots and the
    prompts: per rid the tokens of each, the continuous one's
    ``admission.prefill`` spans and admissions per slot, and the chunks
    each ran."""
    out, chunks = [], []
    trace.clear()
    trace.enable()
    try:
        for continuous in (False, True):
            sched = BatchScheduler(e, slots, continuous=continuous)
            for i, (p, n) in enumerate(zip(prompts, max_news)):
                sched.submit(Request(rid=i, prompt=p, max_new=n))
            ran = 0
            while sched.step_chunk() or sched.waiting:
                ran += 1
            out.append({r.rid: r.out_ids for r in sched.finished})
            chunks.append(ran)
            if continuous:
                prefills = [x for x in trace.spans()
                            if x.name == "admission.prefill"]
            trace.clear()
    finally:
        trace.disable()
        trace.clear()
    return out, prefills, sched.slot_uses, chunks


def test_continuous_admission_decodes_the_wave_tokens():
    """Continuous admission on the pattern (bf16 cache, 3 slots, prompts
    of three lengths, ``max_new`` 5-22): short requests free their slots
    while long ones decode, and the waiting ones are prefilled into them
    mid-flight, over the previous request's ``h``, ``conv`` and
    ``k``/``v``. Each request's tokens are the wave scheduler's and the
    reference's greedy ones."""
    tok = Tokenizer.from_texts(CONT_TEXTS)
    cfg = tiny()                       # bf16 cache, f32 weights
    params = weights(cfg)
    e = Engine(cfg, params, tok, max_len=48, chunk=4)
    prompts = [CONT_TEXTS[0], CONT_TEXTS[2], CONT_TEXTS[1],
               CONT_TEXTS[2].replace("where", "what"),
               CONT_TEXTS[0].replace("what", "where"), CONT_TEXTS[1]]
    max_news = [22, 5, 18, 9, 14, 6]
    assert len({len(tok.encode(p, bos=True)) for p in prompts}) == 3
    (waves, cont), prefills, uses, (n_waves, n_cont) = _both_schedulers(
        e, prompts, max_news)
    assert cont == waves and len(cont) == len(prompts)
    assert [len(cont[i]) for i in range(len(prompts))] == max_news
    assert n_cont < n_waves
    assert len(prefills) == len(prompts) and max(uses) >= 2
    assert any(x.attrs["mid_flight"] for x in prefills)
    assert not prefills[0].attrs["mid_flight"]
    c = file_of(cfg)
    for rid, out in cont.items():
        ids = tok.encode(prompts[rid], bos=True)
        lg = REF.served_logits(c, params, ids, out,
                               cache_dtype=torch.bfloat16)
        picked = lg.gather(1, torch.tensor(out)[:, None])[:, 0]
        assert float((lg.max(1).values - picked).max()) <= TOL_SERVED


def _engine(cfg):
    tok = Tokenizer.from_texts(CONT_TEXTS)
    cfg = dataclasses.replace(cfg, vocab_size=tok.vocab_size)
    params = M.init_model(cfg, torch.Generator().manual_seed(0),
                          torch.float32, "cpu")
    return Engine(cfg, params, tok, max_len=32, chunk=4)


@pytest.mark.parametrize("cfg,independent", [
    (tiny(), True),
    # 16 tokens' assignments over 8 routed experts, 2 each: capacity 8
    (tiny(moe_capacity_factor=1.0), False),
    (reduced(get_config("deepseek-v2-lite-16b")), False),
], ids=["pattern_no_drop", "pattern_drops", "deepseek"])
def test_decode_rows_independent_at_the_slot_count(cfg, independent):
    """At 16 slots: the pattern whose capacity drops nothing admits
    continuously; the same pattern with a capacity under 16, and the MLA
    model, admit in waves, and a continuous scheduler refuses them."""
    slots = 16
    assert decode_rows_independent(cfg, batch=slots) is independent
    assert M.per_row_positions(cfg) is bool(cfg.layer_pattern)
    if cfg.layer_pattern:
        assert (Moe.capacity(cfg, slots) >= slots) is independent
    e = _engine(cfg)
    if independent:
        assert BatchScheduler(e, slots, continuous=True).continuous
    else:
        with pytest.raises(ValueError, match="independent decode rows"):
            BatchScheduler(e, slots, continuous=True)


def test_the_cells_models_admit_as_designed():
    """At the cells' 32 slots: nemotron's held share admits continuously
    (capacity 33), deepseek in waves (MLA, and capacity 8), starcoder2
    continuously, as before layer patterns did."""
    nemo = dataclasses.replace(get_config(ARCH), n_experts=64)
    assert Moe.capacity(nemo, 32) == 33
    assert decode_rows_independent(nemo, batch=32)
    ds = get_config("deepseek-v2-lite-16b")
    assert Moe.capacity(ds, 32) == 8
    assert not decode_rows_independent(ds, batch=32)
    assert decode_rows_independent(get_config("starcoder2-7b"), batch=32)
    assert decode_rows_independent(get_config("starcoder2-7b"))


def test_pipeline_admits_the_pattern_continuously():
    """``ServingPipeline`` builds a continuous scheduler for the pattern
    at the cell's 32 slots (its decode loop run to the sentinel)."""
    pipe = ServingPipeline(types.SimpleNamespace(engine=_engine(tiny())),
                           decode_slots=32)
    pipe._decode_q.put(None)
    pipe._decode_loop({})
    assert pipe.scheduler.continuous and pipe.scheduler.B == 32


def _moe_layer(seed=3):
    cfg = tiny(dtype="float32", n_experts=8)
    p = weights(cfg, seed)["blocks"][cfg.layer_pattern.index("E")]["moe"]
    x = torch.randn((2, 9, cfg.d_model),
                    generator=torch.Generator().manual_seed(seed))
    return cfg, p, x


def test_held_shares_sum_to_the_uncut_layer():
    """Experts 0-3 and 4-7 of 8, each layer routing over all eight, with
    the shared expert (which both compute) counted once, give what the
    layer holding all eight gives; the reference's layer agrees."""
    cfg, p, x = _moe_layer()
    whole = Moe.moe_ffn(cfg, p, x)
    shared = Lyr.mlp(cfg, p["shared"], x)
    parts, ref_parts = [], []
    c = file_of(cfg)
    for first in (0, 4):
        share = dataclasses.replace(cfg, n_experts=4, first_expert=first)
        ps = dict(p, experts={k: v[first:first + 4]
                              for k, v in p["experts"].items()})
        parts.append(Moe.moe_ffn(share, ps, x))
        ref_parts.append(REF._moe(
            dict(c, n_routed_experts=4, first_held_expert=first), ps,
            x[0], 9, [], [], lambda t: t))
    torch.testing.assert_close(parts[0] + parts[1] - shared, whole,
                               rtol=0, atol=1e-6)
    # the reference sums its experts in another order
    for got, want in zip(parts, ref_parts):
        torch.testing.assert_close(got[0], want, rtol=0, atol=1e-5)
    torch.testing.assert_close(ref_parts[0] + ref_parts[1] - shared[0],
                               REF._moe(c, p, x[0], 9, [], [], lambda t: t),
                               rtol=0, atol=1e-5)
    # each half is a real share: neither is the whole nor the shared alone
    for y in parts:
        assert (y - whole).abs().max() > 1e-3
        assert (y - shared).abs().max() > 1e-3


def test_the_correction_bias_chooses_and_does_not_weigh():
    cfg, p, x = _moe_layer()
    x2d = x.reshape(-1, cfg.d_model)
    w, idx, scores = Moe.route(cfg, p, x2d)
    choice = scores + p["router"]["bias"]
    assert torch.equal(idx, choice.topk(cfg.experts_per_tok).indices)
    assert not torch.equal(idx, scores.topk(cfg.experts_per_tok).indices)
    want = scores.gather(1, idx)
    want = want / want.sum(-1, keepdim=True) * cfg.routed_scale
    torch.testing.assert_close(w, want, rtol=1e-6, atol=0)


def test_grouped_gated_norm():
    g = torch.Generator().manual_seed(4)
    x, z = torch.randn((3, 5, 64), generator=g), torch.randn((3, 5, 64),
                                                            generator=g)
    p = {"scale": 1 + 0.1 * torch.randn(64, generator=g)}
    assert torch.equal(Lyr.gated_rmsnorm(p, x, z, 1e-5),
                       Lyr.rmsnorm(p, x * F.silu(z), 1e-5))
    assert torch.equal(Lyr.gated_rmsnorm(p, x, z, 1e-5, groups=1),
                       Lyr.rmsnorm(p, x * F.silu(z), 1e-5))
    got = Lyr.gated_rmsnorm(p, x, z, 1e-5, groups=2)
    one = {"scale": torch.ones(32)}
    want = torch.cat([Lyr.rmsnorm(one, h, 1e-5) for h in
                      (x * F.silu(z)).split(32, dim=-1)], -1) * p["scale"]
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    assert (got - Lyr.gated_rmsnorm(p, x, z, 1e-5)).abs().max() > 1e-3


# deepseek's router and moe_ffn as they were before layer patterns (the
# port's code then, copied): softmax routing, renormalised top-k, SwiGLU
# experts, the capacity drop


def _route_before(cfg, p, x2d):
    w_r = p["router"]["w"].to(x2d.dtype)
    logits = x2d.float() @ w_r.float()
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, idx = w[:, :cfg.experts_per_tok], idx[:, :cfg.experts_per_tok]
    w = w / (w.sum(-1, keepdim=True) + 1e-9)
    return w, idx, probs


def _moe_ffn_before(cfg, p, x):
    B, S, d = x.shape
    T = B * S
    x2d = x.reshape(T, d)
    w, idx, probs = _route_before(cfg, p, x2d)
    E, K = cfg.n_experts, cfg.experts_per_tok
    C = max(int(T * K / E * cfg.moe_capacity_factor), 8)
    flat_e = idx.reshape(-1)
    onehot = F.one_hot(flat_e, E)
    rank = (torch.cumsum(onehot, dim=0) - onehot).gather(
        1, flat_e[:, None])[:, 0]
    valid = rank < C
    slot = torch.where(valid, flat_e * C + rank,
                       torch.full_like(flat_e, E * C))
    xk = x2d.repeat_interleave(K, dim=0) * valid[:, None].to(x.dtype)
    buf = x.new_zeros((E * C + 1, d))
    buf[slot] = xk
    b = buf[:E * C].reshape(E, C, d)
    ex = p["experts"]
    out = torch.bmm(F.silu(torch.bmm(b, ex["w1"])) * torch.bmm(b, ex["w3"]),
                    ex["w2"])
    out = torch.cat([out.reshape(E * C, d), x.new_zeros((1, d))])
    yk = out[slot] * valid[:, None].to(x.dtype)
    y = torch.sum(yk.reshape(T, K, d) * w[..., None].to(x.dtype), dim=1)
    y = y + Lyr.mlp(cfg, p["shared"], x2d)
    return y.reshape(B, S, d), probs, idx


@pytest.mark.parametrize("capacity_factor", [1.25, 64.0],
                         ids=["drops", "no_drop"])
def test_deepseek_moe_is_unchanged(capacity_factor):
    cfg = dataclasses.replace(reduced(get_config("deepseek-v2-lite-16b")),
                              moe_capacity_factor=capacity_factor)
    p = Moe.moe_init(torch.Generator().manual_seed(5), cfg, torch.float32,
                     "cpu")
    assert set(p["experts"]) == {"w1", "w2", "w3"} and \
        "bias" not in p["router"]
    x = torch.randn((4, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(6))
    y_want, probs, idx = _moe_ffn_before(cfg, p, x)
    w, i, pr = Moe.route(cfg, p, x.reshape(-1, cfg.d_model))
    assert all(torch.equal(a, b) for a, b in
               zip((w, i, pr), _route_before(cfg, p, x.reshape(-1,
                                                               cfg.d_model))))
    y, aux = Moe.moe_ffn(cfg, p, x, with_aux=True)
    assert torch.equal(y, y_want)
    assert torch.equal(aux, Moe.load_balance_loss(cfg, probs, idx))


def test_decode_records_mixer_spans_and_held_counts():
    cfg = tiny(dtype="float32")
    params = weights(cfg)
    c = M.init_cache(cfg, 3, 16, device="cpu")
    tok = torch.tensor([[5], [6], [7]])
    trace.clear()
    with torch.no_grad():
        M.decode_step(cfg, params, tok, c, 0)      # not recording
        assert not trace.spans() and not trace.counts()
        trace.enable()
        try:
            M.decode_step(cfg, params, tok, c, 1)
        finally:
            trace.disable()
    s = [x for x in trace.spans() if x.name == "decode.mixer"]
    assert [x.attrs["layer"] for x in s] == list(range(cfg.n_layers))
    assert [x.attrs["kind"] for x in s] == [
        {"M": "ssm", "E": "moe", "*": "attn"}[k] for k in cfg.layer_pattern]
    n = trace.counts()
    K = cfg.experts_per_tok
    assert n["moe.routed"] == 3 * K * cfg.layer_pattern.count("E")
    assert 0 < n["moe.held"] < n["moe.routed"]
    trace.clear()
    assert not trace.counts()


def test_token_flops_count_the_held_share():
    c = file_of(get_config(ARCH))
    full = REF.token_flops(c, 16)
    held = REF.token_flops(dict(c, n_routed_experts=64), 16)
    # 23 layers x 3 of 6 routed experts x 2 x (2 x 2688 x 1856)
    assert full - held == 23 * 3 * 2 * 2 * 2688 * 1856
    # attention over more positions: 6 layers x 32 heads x 2 x 256
    assert REF.token_flops(c, 17) - full == 6 * 32 * 2 * 256
