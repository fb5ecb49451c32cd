"""Parity of the port's dense engine (repro_torch.models + serving.engine)
with the JAX reference on the dense family's ``reduced()`` archs (2
layers, the KB tokenizer's vocab, max_len 160, chunk 8), with the
reference's weights copied in through ``params_from_jax``: the configs
themselves, the converted parameters, prefill logits and greedy tokens
through ``Session`` (f32 cache) for each of the six registered archs
(qwen3-1.7b: tied, gated, ``qk_norm``; storinfer-paper-8b and
qwen2.5-32b: an untied head; starcoder2-7b: QKV bias and a non-gated GELU
MLP; qwen2.5-32b: QKV bias) and two head groupings ``reduced()`` hides
(G = 9 and G = 3); and on qwen3's, ``BatchScheduler`` (bf16 cache) and
the cancel/retire sequence of a scripted scheduler run. Everything runs
on the CPU, where the attention wrappers take their plain versions (the
reference engine's naive math).

An EOS inside a decode chunk ends a port request (ROADMAP C4): the last
tests force one with a logit bias on the EOS id and hold the port's
``Session``, ``BatchScheduler`` and ``generate_batch`` to the reference
with the same two-line change (``_eos_reference``), beside the
unpatched reference, which decodes on past it."""
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _eos_reference import EosBatchScheduler, EosEngine
from repro.configs import get_config, reduced
from repro.core.kb import build_kb
from repro.core.tokenizer import EOS, Tokenizer
from repro.models import model as M
from repro.serving import engine as E
from repro_torch.configs import get_config as t_get_config
from repro_torch.configs import reduced as t_reduced
from repro_torch import trace
from repro_torch.core.tokenizer import Tokenizer as TTokenizer
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import model as TM
from repro_torch.models.convert import params_from_jax, tree_leaves
from repro_torch.serving import engine as TE
from repro_torch.serving.scheduler import ServingPipeline

MAX_LEN, CHUNK = 160, 8
PROMPTS = ["what is the height of aurora bridge?",
           "who founded the meridian institute?",
           "tell me the capital of port serrano",
           "what is the founder of lake halcyon?",
           "zebra xylophone never stored anywhere at all",
           "what is the length of the iron canal?"]
ARCHS = ["qwen3-1.7b", "storinfer-paper-8b", "storinfer-paper-1b",
         "llama3.2-3b", "starcoder2-7b", "qwen2.5-32b"]
# head groupings the reduced configs (4 heads over 2) never reach:
# starcoder2-7b's G = 9 (with its GELU MLP and QKV bias), and G = 3
HEAD_SHAPES = {"starcoder2-7b:G9": dict(n_heads=9, n_kv_heads=1),
               "storinfer-paper-1b:G3": dict(n_heads=6, n_kv_heads=2)}
VARIANTS = ARCHS + list(HEAD_SHAPES)


@functools.lru_cache(maxsize=None)
def _engines(variant):
    """(reference engine, port engine) on one variant's reduced arch, the
    port holding the reference's weights."""
    arch = variant.split(":")[0]
    kb = build_kb("squad", n_docs=4)
    texts = [d.text() for d in kb.docs]
    tok = Tokenizer.from_texts(texts, max_vocab=512)
    kw = dict(vocab_size=tok.vocab_size, n_layers=2,
              **HEAD_SHAPES.get(variant, {}))
    cfg = dataclasses.replace(reduced(get_config(arch)), **kw)
    params = M.init_model(jax.random.PRNGKey(0), cfg, dtype=jnp.float32)
    ref = E.Engine(cfg, params, tok, M.RunCfg(attn_impl="naive", remat=False),
                   max_len=MAX_LEN, chunk=CHUNK)
    tcfg = dataclasses.replace(t_reduced(t_get_config(arch)), **kw)
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(cfg)
    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, params),
                              device="cpu")
    port = TE.Engine(tcfg, tparams, TTokenizer.from_texts(texts,
                                                         max_vocab=512),
                     max_len=MAX_LEN, chunk=CHUNK)
    return ref, port


@pytest.fixture(scope="module")
def engines():
    return _engines("qwen3-1.7b")


@pytest.fixture(scope="module", params=VARIANTS)
def family(request):
    return _engines(request.param)


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_are_the_reference_configs(arch):
    ref, port = reduced(get_config(arch)), t_reduced(t_get_config(arch))
    assert dataclasses.asdict(ref) == dataclasses.asdict(port)
    full, tfull = get_config(arch), t_get_config(arch)
    assert dataclasses.asdict(full) == dataclasses.asdict(tfull)
    assert tfull.padded_vocab == full.padded_vocab
    assert tfull.resolved_head_dim == full.resolved_head_dim
    assert tfull.param_count() == full.param_count()


# the families ported beside the dense one (tests/test_torch_families.py)
FAMILY_ARCHS = ["deepseek-v2-lite-16b", "grok-1-314b", "mamba2-130m",
                "zamba2-1.2b"]


def test_registered_archs_are_the_dense_family():
    """The registered archs are the dense family's six, the moe, ssm and
    hybrid configs and the encdec and vlm ones: every arch the reference
    registers, each with the reference's parameter count; beside them the
    port's own layer-pattern arch, which the reference does not have
    (tests/test_torch_nemotron_h.py holds it to a plain reference)."""
    from repro.configs import list_configs as ref_list_configs
    from repro_torch.configs import list_configs
    archs = ARCHS + FAMILY_ARCHS + ["whisper-base", "qwen2-vl-72b"]
    assert sorted(archs) == ref_list_configs()
    assert list_configs() == sorted(archs + ["nemotron-3-nano-30b-a3b"])
    for arch in archs:
        assert t_get_config(arch).param_count() == \
            get_config(arch).param_count()
    assert t_get_config("storinfer-paper-8b").param_count() == \
        pytest.approx(8.03e9, rel=1e-3)
    assert t_get_config("deepseek-v2-lite-16b").param_count() == \
        pytest.approx(15.71e9, rel=1e-3)


def test_converted_params_match_shapes(family):
    """Every reference leaf lands in the port with its shape and numbers:
    ``lm_head`` for the untied archs, the q/k/v biases where the arch has
    them, ``w3`` only for a gated MLP."""
    ref, port = family
    cfg = port.cfg
    flat = jax.tree_util.tree_leaves_with_path(ref.params)
    n_ref = sum(int(np.prod(a.shape)) for _, a in flat)
    n_port = sum(t.numel() for t in tree_leaves(port.params))
    assert n_ref == n_port
    assert len(port.params["blocks"]) == 2
    assert ("lm_head" in port.params) == (not cfg.tie_embeddings)
    if not cfg.tie_embeddings:
        assert np.array_equal(port.params["lm_head"]["w"].numpy(),
                              np.asarray(ref.params["lm_head"]["w"]))
    for blk in range(2):
        attn = port.params["blocks"][blk]["attn"]
        for name in ("wq", "wk", "wv", "wo"):
            want = ref.params["blocks"]["attn"][name]
            assert set(attn[name]) == set(want)
            for leaf in want:
                assert np.array_equal(attn[name][leaf].numpy(),
                                      np.asarray(want[leaf][blk]))
        assert ("b" in attn["wq"]) == cfg.attn_bias
        assert ("w3" in port.params["blocks"][blk]["mlp"]) == cfg.gated_mlp
    hd = cfg.resolved_head_dim
    assert tuple(port.params["blocks"][0]["attn"]["wq"]["w"].shape) == \
        (cfg.d_model, cfg.n_heads * hd)
    assert tuple(port.params["blocks"][0]["attn"]["wk"]["w"].shape) == \
        (cfg.d_model, cfg.n_kv_heads * hd)


@pytest.mark.parametrize("prompt", PROMPTS[:3])
def test_prefill_logits_and_cache_match(family, prompt):
    """XLA and torch sum in different orders: logits within 1e-4."""
    ref, port = family
    ids = ref.tok.encode(prompt, bos=True)
    lg, cache = ref._prefill(ref.params, jnp.asarray([ids], jnp.int32))
    tlg, tcache = port._prefill(port.tokens(ids))
    np.testing.assert_allclose(tlg.numpy(), np.asarray(lg), atol=1e-4,
                               rtol=1e-4)
    for name in ("k", "v"):
        assert tuple(tcache[name].shape) == cache[name].shape
        np.testing.assert_allclose(tcache[name].numpy(),
                                   np.asarray(cache[name]), atol=1e-4,
                                   rtol=1e-4)


@pytest.mark.parametrize("prompt", PROMPTS[:4])
def test_greedy_session_tokens_identical(family, prompt):
    ref, port = family
    s = ref.start_session(prompt, max_new=24)
    t = port.start_session(prompt, max_new=24)
    while not s.done:
        s.step_chunk()
    while not t.done:
        t.step_chunk()
    assert t.out_ids == s.out_ids
    assert t.chunks_run == s.chunks_run


def test_greedy_batch_scheduler_tokens_identical(engines):
    """bf16 batched cache, several waves over 3 slots."""
    ref, port = engines
    rs, ts = E.BatchScheduler(ref, batch_size=3), \
        TE.BatchScheduler(port, batch_size=3)
    for i, p in enumerate(PROMPTS):
        rs.submit(E.Request(rid=i, prompt=p, max_new=20))
        ts.submit(TE.Request(rid=i, prompt=p, max_new=20))
    got_r = {r.rid: r.out_ids for r in rs.run_to_completion()}
    got_t = {r.rid: r.out_ids for r in ts.run_to_completion()}
    assert got_t == got_r
    assert (ts.waves, ts.admitted, ts.slot_uses) == \
        (rs.waves, rs.admitted, rs.slot_uses)


# ---------------------------------------------------------------------------
# Per-row decode positions and continuous admission
# ---------------------------------------------------------------------------


def _batch_cache(port, lens=(9, 5, 11)):
    """A bf16 batched cache (the scheduler's) with one prefilled prompt per
    slot, cut to ``lens`` tokens: (cache, each row's next position)."""
    cache = TM.init_cache(port.cfg, len(lens), MAX_LEN, device="cpu")
    for slot, (prompt, n) in enumerate(zip(PROMPTS, lens)):
        ids = port.tok.encode(prompt, bos=True)[:n]
        assert len(ids) == n
        port._write_slot(cache, port._prefill(port.tokens(ids))[1], slot)
    return cache, list(lens)


def _step(port, cache, cache_len, live=None, token=(7, 11, 3)):
    token = torch.tensor(token, dtype=torch.long)[:, None]
    return TM.decode_step(port.cfg, port.params, token, cache, cache_len,
                          TM.RunCfg(), live=live)


def test_position_tensor_of_equal_entries_is_the_int_path(family):
    """``decode_step`` with a (B,) tensor of one position gives the int
    path's logits and cache bit for bit, a dead slot included."""
    _, port = family
    live = torch.tensor([True, False, True])
    for clen in (12, MAX_LEN + 3):                # inside, and past the end
        cache, _ = _batch_cache(port)
        twin = {n: t.clone() for n, t in cache.items()}
        lg, new = _step(port, cache, clen, live)
        tlg, tnew = _step(port, twin, torch.full((3,), clen), live)
        assert torch.equal(tlg, lg)
        for n in new:
            assert torch.equal(tnew[n], new[n])


def test_each_row_at_its_own_position_is_that_row_alone(family):
    """Unequal positions: each live row's logits and cache row are those of
    the row decoded alone (a one-row cache) at its own position, one past
    its prompt; the dead row, at position 0 as the scheduler puts it,
    keeps its cache entries bit for bit."""
    _, port = family
    cache, lens = _batch_cache(port)
    before = {n: t.clone() for n, t in cache.items()}
    live = torch.tensor([True, True, False])
    lg, new = _step(port, cache, torch.tensor([lens[0], lens[1], 0]), live)
    for slot in (0, 1):
        one = {n: t[:, slot:slot + 1].clone() for n, t in before.items()}
        tok = (7, 11, 3)[slot:slot + 1]
        want, wnew = _step(port, one, lens[slot], token=tok)
        torch.testing.assert_close(lg[slot], want[0], rtol=1e-5, atol=1e-5)
        assert int(lg[slot].argmax()) == int(want[0].argmax())
        for n in new:        # bf16 rows: an ulp apart where B=1 rounds
            torch.testing.assert_close(new[n][:, slot], wnew[n][:, 0])
    for n in new:
        assert torch.equal(new[n][:, 2], before[n][:, 2])


def test_every_step_hands_b3_fresh_lengths(engines, monkeypatch):
    """Each decode step builds its own ``lengths`` (the int path with
    ``torch.full``, the tensor path as a copy), so a caller that keeps one
    past the step reads that step's positions."""
    _, port = engines
    seen = []
    real = TM.ops.decode_attention

    def spy(q, k, v, lengths, n_splits=8):
        seen.append(lengths)
        return real(q, k, v, lengths, n_splits)

    monkeypatch.setattr(TM.ops, "decode_attention", spy)
    cache, lens = _batch_cache(port)
    pos = torch.tensor(lens)
    live = torch.ones(3, dtype=torch.bool)
    given = [pos, pos + 1, (pos + 2).to(torch.int32), 40]
    for at in given:
        _step(port, cache, at, live)
    per_step = [seen[i * 2] for i in range(4)]    # two layers a step
    assert [t.tolist() for t in per_step] == \
        [[n + i for n in lens] for i in range(3)] + [[40] * 3]
    assert len({id(t) for t in per_step}) == 4
    assert all(t is not at for t, at in zip(per_step, given))
    assert all(t.dtype == torch.int32 for t in seen)


MAX_NEWS = [12, 28, 9, 20, 16, 24]


def _waves_and_continuous(ref_sched, port, max_news, cancel_after=None,
                          ref_mod=E):
    """The reference's wave-mode scheduler and the port's continuous one
    over 3 slots and the six prompts: per rid (out_ids, chunks, cancelled)
    of each, the chunks each scheduler ran, and the port's
    ``admission.prefill`` spans."""
    out, chunks = [], []
    trace.clear()
    trace.enable()
    try:
        for sched, mod in ((ref_sched, ref_mod),
                           (TE.BatchScheduler(port, batch_size=3,
                                              continuous=True), TE)):
            for i, (p, n) in enumerate(zip(PROMPTS, max_news)):
                sched.submit(mod.Request(rid=i, prompt=p, max_new=n))
            ran = 0
            for step in range(200):
                if step == cancel_after:
                    sched.cancel(0)          # live: retires at the boundary
                    sched.cancel(5)          # waiting: never prefilled
                if sched.step_chunk():
                    ran += 1
                elif not sched.waiting:
                    break
            out.append({r.rid: (r.out_ids, r.chunks, r.cancelled)
                        for r in sched.finished})
            chunks.append(ran)
        prefills = [s for s in trace.spans() if s.name == "admission.prefill"]
    finally:
        trace.disable()
        trace.clear()
    return out, chunks, prefills


def test_continuous_scheduler_tokens_identical_to_waves(engines):
    """Continuous admission (bf16 cache, 3 slots, prompts of 12-39 tokens,
    ``max_new`` 9-28): every rid's greedy tokens are the reference wave
    scheduler's, in strictly fewer chunks, and a request joined a batch
    that was mid-decode."""
    ref, port = engines
    (want, got), (n_ref, n_port), prefills = _waves_and_continuous(
        E.BatchScheduler(ref, batch_size=3), port, MAX_NEWS)
    assert {r: v[0] for r, v in got.items()} == \
        {r: v[0] for r, v in want.items()}
    assert len(got) == len(PROMPTS)
    assert n_port < n_ref
    assert len(prefills) == len(PROMPTS)
    assert any(s.attrs["mid_flight"] for s in prefills)
    assert not prefills[0].attrs["mid_flight"]


def test_continuous_scheduler_retires_a_cancelled_slot(engines):
    """A live request cancelled after the first chunk retires at the next
    boundary with the reference's tokens so far, and its slot takes the
    next request; a waiting one cancelled is never prefilled; the rest
    decode the reference's tokens."""
    ref, port = engines
    (want, got), _, prefills = _waves_and_continuous(
        E.BatchScheduler(ref, batch_size=3), port, MAX_NEWS, cancel_after=1)
    assert got == want
    assert got[0][2] and len(got[0][0]) == 1 + CHUNK
    assert got[5] == ([], 0, True)
    assert 5 not in {s.rid for s in prefills}


def test_continuous_scheduler_retires_a_mid_chunk_eos():
    """With the EOS bias: each request that meets an EOS inside a chunk
    retires in that chunk, its tokens and chunk count the patched
    reference's (waves)."""
    _, patched, port = _eos_engines()
    (want, got), _, _ = _waves_and_continuous(
        EosBatchScheduler(patched, batch_size=3), port, [20] * 6)
    assert got == want
    assert any(ids[-1] == EOS and len(ids) < 20 for ids, _, _ in got.values())


def test_continuous_scheduler_temperature_gates_admission(engines):
    """Decode runs one temperature per chunk: a sampled request behind a
    greedy one waits at the head of ``waiting`` while the greedy slot
    decodes, though slots are free, and takes a slot once it drains."""
    _, port = engines
    sched = TE.BatchScheduler(port, batch_size=4, continuous=True)
    sched.submit(TE.Request(rid=0, prompt="same length prompt a", max_new=20))
    sched.submit(TE.Request(rid=1, prompt="same length prompt b", max_new=4,
                            temperature=1.0))
    sched.submit(TE.Request(rid=2, prompt="a greedy one behind it",
                            max_new=4))
    sched._admit()
    assert int(sched.live.sum()) == 1       # greedy first, sampled waits
    sched.step_chunk()
    assert int(sched.live.sum()) == 1 and len(sched.waiting) == 2
    done = sched.run_to_completion()
    assert sorted(r.rid for r in done) == [0, 1, 2]
    assert [len(r.out_ids) for r in sorted(done, key=lambda r: r.rid)] == \
        [20, 4, 4]


def _picked(engine):
    """Whether the pipeline's decode worker builds a continuous
    scheduler for ``engine`` (its loop run to the shutdown sentinel)."""
    pipe = ServingPipeline(types.SimpleNamespace(engine=engine),
                           decode_slots=2)
    pipe._decode_q.put(None)
    pipe._decode_loop({})
    return pipe.scheduler.continuous


def test_pipeline_admits_continuously_on_a_dense_model(engines):
    """``ServingPipeline`` picks continuous admission for a dense GQA
    model on one device and waves for the seq-sharded decode."""
    _, port = engines
    assert TE.decode_rows_independent(port.cfg)
    assert _picked(port)
    mesh = make_mesh((1, 2), ("data", "model"), devices=["cpu"] * 2)
    seq = TE.Engine(port.cfg, port.params, port.tok,
                    TM.RunCfg(decode_attn="seq_sharded", mesh=mesh),
                    max_len=32, chunk=4)
    assert not TE.decode_rows_independent(seq.cfg, seq.run)
    assert not _picked(seq)
    with pytest.raises(ValueError, match="per-row"):
        TE.BatchScheduler(seq, batch_size=2, continuous=True)


def _scripted(mod, engine):
    """Submit, cancel one live and one waiting request mid-run, and record
    (chunk, live slots, finished rids, cancelled flags) per chunk."""
    sched = mod.BatchScheduler(engine, batch_size=2)
    for i, p in enumerate(PROMPTS[:5]):
        sched.submit(mod.Request(rid=i, prompt=p, max_new=12 + 4 * i))
    trace = []
    for step in range(40):
        if step == 1:
            sched.cancel(0)          # live: retires at the next boundary
            sched.cancel(4)          # still waiting: never prefilled
        ran = sched.step_chunk()
        trace.append((step, tuple(sched.live.tolist()),
                      tuple((r.rid, r.cancelled, r.slot, len(r.out_ids),
                             r.chunks) for r in sched.drain_finished())))
        if not ran and not sched.waiting:
            break
    return trace, sched.waves, sched.slot_uses


def test_scripted_cancel_retire_sequence_identical(engines):
    ref, port = engines
    assert _scripted(TE, port) == _scripted(E, ref)


def test_sampled_tokens_follow_the_softmax():
    """Sampling is held by distribution only (jax.random's stream cannot
    be reproduced): frequencies of 20000 draws vs softmax(logits / T)."""
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    gen = torch.Generator().manual_seed(0)
    draws = torch.stack([TE.sample_token(logits, gen, 0.7)
                         for _ in range(20000)])
    freq = np.bincount(draws.numpy().ravel(), minlength=4) / 20000
    want = torch.softmax(logits / 0.7, -1)[0].numpy()
    np.testing.assert_allclose(freq, want, atol=0.015)
    assert TE.sample_token(logits, gen, None).item() == 0


def _prompt_of(tok, n_tokens):
    """A prompt of exactly ``n_tokens`` tokens (BOS included)."""
    words = [w for w in " ".join(PROMPTS).replace("?", "").split()
             if len(tok.encode(w)) == 1]         # one token each
    out = []
    while len(tok.encode(" ".join(out), bos=True)) < n_tokens:
        out.append(words[len(out) % len(words)])
    text = " ".join(out)
    assert len(tok.encode(text, bos=True)) == n_tokens
    return text


@pytest.mark.parametrize("n_tokens", [MAX_LEN - 6, MAX_LEN + 40])
def test_greedy_generate_past_max_len_identical(engines, n_tokens):
    """Decoding past ``max_len``: a prompt that ends 6 tokens short of it
    (decode crosses the end), and one 40 tokens past it (cut to
    ``max_len - 1``). Past the end every step writes the cache's last slot
    (the reference's clamped ``dynamic_update_slice``; the port's
    ``min(cache_len, M - 1)`` and B3's clamped length) and attends the
    whole cache: greedy tokens identical."""
    ref, port = engines
    prompt = _prompt_of(port.tok, n_tokens)
    assert port.generate(prompt, max_new=24) == \
        ref.generate(prompt, max_new=24)
    s = ref.start_session(prompt, max_new=24)
    t = port.start_session(prompt, max_new=24)
    while not s.done:
        s.step_chunk()
    while not t.done:
        t.step_chunk()
    assert t.out_ids == s.out_ids and len(t.out_ids) > 6
    assert t.cache_len + 1 > MAX_LEN - 1    # decoded at the clamped slot


def test_generate_and_generate_batch_match_reference(engines):
    """``Engine.generate`` (one Session) and ``generate_batch`` (a
    BatchSession over 3 slots, bf16 cache): greedy texts identical."""
    ref, port = engines
    for p in PROMPTS[:2]:
        assert port.generate(p, max_new=16) == ref.generate(p, max_new=16)
    got = port.generate_batch(PROMPTS, max_new=20, batch_size=3)
    assert got == ref.generate_batch(PROMPTS, max_new=20, batch_size=3)
    assert len(got) == len(PROMPTS) and all(isinstance(t, str) for t in got)
    text = port.generate(PROMPTS[0], max_new=10, temperature=0.8, seed=3)
    assert text == port.generate(PROMPTS[0], max_new=10, temperature=0.8,
                                 seed=3)      # one seed, one sample


# ---------------------------------------------------------------------------
# C4: an EOS inside a decode chunk ends the request
# ---------------------------------------------------------------------------

# the logit bias on the EOS id that makes the reduced qwen2.5-32b (an
# untied head, so the bias is a head bias in both packages) pick EOS as
# the 14th token of the first prompt: inside its second decode chunk
EOS_BIAS = 1.5


@functools.lru_cache(maxsize=None)
def _eos_engines():
    """(unpatched reference, reference with the port's EOS rule, port) on
    the reduced qwen2.5-32b with an EOS logit bias."""
    ref, port = _engines("qwen2.5-32b")
    bias = np.zeros(ref.cfg.padded_vocab, np.float32)
    bias[EOS] = EOS_BIAS
    params = dict(ref.params, lm_head={"w": ref.params["lm_head"]["w"],
                                       "b": jnp.asarray(bias)})
    run = M.RunCfg(attn_impl="naive", remat=False)
    plain = E.Engine(ref.cfg, params, ref.tok, run, max_len=MAX_LEN,
                     chunk=CHUNK)
    patched = EosEngine(ref.cfg, params, ref.tok, run, max_len=MAX_LEN,
                        chunk=CHUNK)
    tparams = dict(port.params, lm_head={"w": port.params["lm_head"]["w"],
                                         "b": torch.from_numpy(bias)})
    return plain, patched, TE.Engine(port.cfg, tparams, port.tok,
                                     max_len=MAX_LEN, chunk=CHUNK)


def _session(engine, prompt, max_new=24):
    s = engine.start_session(prompt, max_new=max_new)
    while not s.done:
        s.step_chunk()
    return s


def test_reference_decodes_past_a_mid_chunk_eos():
    """The unpatched reference meets the EOS inside its second chunk, drops
    it and decodes on to ``max_new`` tokens; with the EOS kept, the same
    stream ends there, in the chunk that produced it."""
    plain, patched, _ = _eos_engines()
    a, b = _session(plain, PROMPTS[0]), _session(patched, PROMPTS[0])
    n = len(b.out_ids)
    assert b.out_ids[-1] == EOS and 1 < n < 24 and n % CHUNK != 1
    assert b.chunks_run == -(-(n - 1) // CHUNK)
    assert EOS not in a.out_ids and len(a.out_ids) == 24
    assert a.out_ids[:n - 1] == b.out_ids[:-1]
    assert a.chunks_run > b.chunks_run


def test_eos_mid_chunk_ends_the_port_session():
    """The port's ``Session`` keeps the EOS and stops: token for token the
    patched reference, in as many chunks; the text skips the EOS."""
    plain, patched, port = _eos_engines()
    for prompt in PROMPTS[:3]:
        want, got = _session(patched, prompt), _session(port, prompt)
        assert got.out_ids == want.out_ids
        assert got.chunks_run == want.chunks_run
        assert got.text() == want.text()
    assert _session(port, PROMPTS[0]).out_ids[-1] == EOS


def test_eos_mid_chunk_retires_the_port_batch_slot():
    """``BatchScheduler`` (bf16 cache, 3 slots, several waves): each request
    that meets an EOS retires in that chunk, as in the patched reference;
    ``generate_batch`` gives the patched reference's texts."""
    _, patched, port = _eos_engines()
    rs, ts = EosBatchScheduler(patched, batch_size=3), \
        TE.BatchScheduler(port, batch_size=3)
    for i, p in enumerate(PROMPTS):
        rs.submit(E.Request(rid=i, prompt=p, max_new=20))
        ts.submit(TE.Request(rid=i, prompt=p, max_new=20))
    want = {r.rid: (r.out_ids, r.chunks) for r in rs.run_to_completion()}
    got = {r.rid: (r.out_ids, r.chunks) for r in ts.run_to_completion()}
    assert got == want
    assert any(ids[-1] == EOS and len(ids) < 20 for ids, _ in got.values())
    assert port.generate_batch(PROMPTS, max_new=20, batch_size=3) == \
        patched.generate_batch(PROMPTS, max_new=20, batch_size=3)
