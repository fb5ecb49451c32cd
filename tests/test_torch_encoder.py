"""The port's MiniLM encoder against the JAX reference on the CPU: the
sinusoidal position table bitwise, ``params_from_jax`` carrying the
encoder's pytree, ``MiniLMEncoder.encode`` with the reference's weights
copied in (over batches that cross a power-of-two bucket and the
``max_batch`` chunk, an empty list and a text longer than ``max_len``),
and ``StorInfer`` with ``embedder="minilm"`` in both packages on one store
and stream: the same hit/miss split, hit rows and greedy miss text; and
``train_contrastive`` against the reference's on the reference test's tiny
encoder: the same per-step losses and the same parameters afterwards
from copied weights and the same batch draws, and a falling loss over 80
steps. On the CPU the encoder's non-causal attention takes the plain
version of the ``flash_attention`` kernel (training runs it under
autograd on any device)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.api import EngineCfg as JEngineCfg
from repro.api import StorInfer as JStorInfer
from repro.api import SystemCfg as JSystemCfg
from repro.core import embedder as JE
from repro.core.kb import build_kb, render_query, sample_user_queries
from repro.core.tokenizer import Tokenizer as JTokenizer
from repro.models import layers as JLyr
from repro_torch.api import StorInfer, SystemCfg, make_embedder
from repro_torch.configs import get_config, reduced
from repro_torch.core import embedder as TE
from repro_torch.core.tokenizer import Tokenizer
from repro_torch.launch.serve import kb_pairs, write_kb_store
from repro_torch.models import layers as Lyr
from repro_torch.models.convert import params_from_jax, tree_leaves
from repro_torch.serving.engine import Engine

SMALL = dict(dim=64, n_layers=2, n_heads=2, d_ff=128, max_len=16)
LONG = ("what is the height of aurora bridge and who founded the meridian "
        "institute and where is the iron canal and what is the capital of "
        "port serrano today")


@pytest.fixture(scope="module")
def texts():
    kb = build_kb("squad", n_docs=4)
    return [d.text() for d in kb.docs]


@pytest.fixture(scope="module")
def encoders(texts):
    jtok = JTokenizer.from_texts(texts, max_vocab=512)
    tok = Tokenizer.from_texts(texts, max_vocab=512)
    assert tok.words == jtok.words
    ref = JE.MiniLMEncoder(jtok, JE.EncoderCfg(vocab_size=jtok.vocab_size,
                                               **SMALL), seed=0, max_batch=8)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             device="cpu")
    port = TE.MiniLMEncoder(tok, TE.EncoderCfg(vocab_size=tok.vocab_size,
                                               **SMALL), max_batch=8,
                            params=params, device="cpu")
    return ref, port


@pytest.mark.parametrize("seq_len,d_model", [(64, 384), (16, 64), (7, 10),
                                             (1, 2)])
def test_sinusoidal_positions_bitwise(seq_len, d_model):
    a = np.asarray(JLyr.sinusoidal_positions(seq_len, d_model))
    b = Lyr.sinusoidal_positions(seq_len, d_model)
    assert b.dtype == torch.float32 and np.array_equal(b.numpy(), a)


def test_encoder_cfg_is_the_reference_cfg():
    assert dataclasses.asdict(TE.EncoderCfg(vocab_size=100)) == \
        dataclasses.asdict(JE.EncoderCfg(vocab_size=100))
    j = dataclasses.asdict(JE._enc_model_cfg(JE.EncoderCfg(vocab_size=100)))
    t = dataclasses.asdict(TE._enc_model_cfg(TE.EncoderCfg(vocab_size=100)))
    assert t == j and t["norm_eps"] == 1e-5 and t["rope_kind"] == "none"


def test_params_from_jax_carries_the_encoder_pytree(encoders):
    ref, port = encoders
    assert set(port.params) == {"embed", "blocks", "final_norm"}
    assert len(port.params["blocks"]) == SMALL["n_layers"]
    for i in range(SMALL["n_layers"]):
        for path in (("attn", "wq", "w"), ("mlp", "w1", "w"),
                     ("ln2", "scale")):
            a, b = ref.params["blocks"], port.params["blocks"][i]
            for key in path:
                a, b = a[key], b[key]
            assert np.array_equal(b.numpy(), np.asarray(a)[i])
    assert np.array_equal(port.params["embed"]["w"].numpy(),
                          np.asarray(ref.params["embed"]["w"]))
    # a freshly initialised port encoder has the same tree and shapes
    own = TE.MiniLMEncoder(port.tok, port.cfg, seed=3, device="cpu")
    shapes = jax.tree_util.tree_map(
        lambda a: tuple(a.shape[1:]), ref.params["blocks"])
    assert jax.tree_util.tree_map(lambda t: tuple(t.shape),
                                  own.params["blocks"][0]) == shapes


@pytest.mark.parametrize("n", [0, 1, 3, 5, 8, 13])
def test_minilm_encode_matches_reference(encoders, texts, n):
    """Batches of n texts: 5 crosses the 4 -> 8 bucket, 13 the max_batch
    chunk of 8; the first text is longer than max_len (cut at 16 ids)."""
    ref, port = encoders
    words = " ".join(texts).split()
    batch = [LONG] + [" ".join(words[i:i + 3 + i % 5])
                      for i in range(0, 7 * max(n - 1, 0), 7)]
    batch = batch[:n]
    want = ref.encode(batch)
    got = port.encode(batch)
    assert got.shape == (n, SMALL["dim"]) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if n:
        np.testing.assert_allclose(np.linalg.norm(got, axis=1), 1.0,
                                   atol=1e-5)


def test_minilm_bucket_and_batch_padding(encoders):
    _, port = encoders
    assert [port._bucket(n) for n in (1, 2, 3, 5, 8, 9)] == [1, 2, 4, 8, 8,
                                                             16]
    toks, mask = port._batch(["aurora bridge", LONG], pad_to=4)
    assert toks.shape == (4, SMALL["max_len"]) and mask.shape == toks.shape
    assert mask[1].sum() == SMALL["max_len"] and mask[2:].sum() == 0


def test_minilm_factory_needs_a_tokenizer(texts):
    with pytest.raises(ValueError, match="tokenizer"):
        make_embedder("minilm")
    tok = Tokenizer.from_texts(texts, max_vocab=512)
    enc = make_embedder("minilm", tokenizer=tok, device="cpu",
                        cfg=TE.EncoderCfg(vocab_size=tok.vocab_size, **SMALL))
    assert isinstance(enc, TE.MiniLMEncoder) and enc.dim == SMALL["dim"]
    assert enc.device.type == "cpu"


def _port_engine(jax_engine):
    cfg = dataclasses.replace(reduced(get_config(jax_engine.cfg.name
                                                 .removesuffix("-smoke"))),
                              vocab_size=jax_engine.cfg.vocab_size,
                              n_layers=jax_engine.cfg.n_layers)
    params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                    jax_engine.params),
                             device="cpu")
    return Engine(cfg, params, Tokenizer(list(jax_engine.tok.words)),
                  max_len=jax_engine.max_len, chunk=jax_engine.chunk)


def test_storinfer_minilm_same_split_rows_and_miss_text(tmp_path):
    """One store of the KB's pairs embedded by the reference's MiniLM
    encoder (plus seeded filler rows), opened by both packages with
    ``embedder="minilm"`` (the port's encoder gets the reference's weights
    through ``embedder_kw``): the same stream gives the same hits, rows
    and greedy miss text. With random weights every score sits close to 1
    (the position table dominates the pooled vector: 0.9978-0.9986 for
    the misses here, 0.9999-1.0 for the hits), so the threshold sits
    between the two."""
    kb = build_kb("squad", n_docs=8)
    kb_texts = [d.text() for d in kb.docs]
    jtok = JTokenizer.from_texts(kb_texts, max_vocab=512)
    jcfg = JE.EncoderCfg(vocab_size=jtok.vocab_size, **SMALL)
    path = tmp_path / "store"
    write_kb_store(path, kb, JE.MiniLMEncoder(jtok, jcfg), 400,
                   seed=1).close()
    users = [q for q, _ in sample_user_queries(kb, 10, seed=3)]
    jsys = JSystemCfg(embedder="minilm", embedder_kw={"cfg": jcfg},
                      s_th_run=0.9995,
                      engine=JEngineCfg(smoke=True, max_len=64, chunk=4))
    with JStorInfer.open(path, jsys, tokenizer=jtok) as ref:
        stored = [kb_pairs(kb)[r][0] for r in (0, 7, 31)]
        stream = stored + users + ["zebra xylophone never stored anywhere"]
        rj = ref.query_batch(stream, max_new=8)
        tok = Tokenizer(list(jtok.words))
        params = params_from_jax(jax.tree_util.tree_map(
            np.asarray, ref.embedder.params), device="cpu")
        tsys = SystemCfg(embedder="minilm", device="cpu", s_th_run=0.9995,
                         embedder_kw={"cfg": TE.EncoderCfg(
                             vocab_size=tok.vocab_size, **SMALL),
                             "params": params})
        with StorInfer.open(path, tsys, tokenizer=tok,
                            engine=_port_engine(ref.engine)) as si:
            assert isinstance(si.embedder, TE.MiniLMEncoder)
            rt = si.query_batch(stream, max_new=8)
    summary = [[(r.hit, r.matched_query, r.response if r.hit else None)
                for r in rs] for rs in (rt, rj)]
    assert summary[0] == summary[1]
    np.testing.assert_allclose([r.score for r in rt], [r.score for r in rj],
                               atol=1e-5)
    assert all(r.hit for r in rt[:3]) and not all(r.hit for r in rt)
    misses = [(a.response, b.response) for a, b in zip(rt, rj) if not a.hit]
    assert misses and all(a == b for a, b in misses)


# the reference's own training test (tests/test_embedder.py): a tiny
# encoder, paraphrase pairs of one fact under templates 0 and 2
TRAIN = dict(dim=64, n_layers=2, n_heads=4, d_ff=128, max_len=24)


@pytest.fixture(scope="module")
def trainable():
    kb = build_kb("squad", n_docs=6)
    texts = [d.text() for d in kb.docs]
    jtok = JTokenizer.from_texts(texts, max_vocab=512)
    ref = JE.MiniLMEncoder(jtok, JE.EncoderCfg(vocab_size=jtok.vocab_size,
                                               **TRAIN), seed=0)
    pairs = [(render_query(f, 0), render_query(f, 2))
             for f in kb.facts[:64]]
    return ref, Tokenizer.from_texts(texts, max_vocab=512), pairs


def _port_copy(ref, tok):
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                             device="cpu")
    return TE.MiniLMEncoder(tok, TE.EncoderCfg(vocab_size=tok.vocab_size,
                                               **TRAIN),
                            params=params, device="cpu")


def test_train_contrastive_matches_reference(trainable):
    """5 steps from the same weights with the same seed: the per-step
    losses within 1e-4 relative, every parameter within 1e-4 afterwards
    (XLA and torch sum in different orders)."""
    ref0, tok, pairs = trainable
    ref = JE.MiniLMEncoder(ref0.tok, ref0.cfg, seed=0)
    port = _port_copy(ref, tok)
    want = ref.train_contrastive(pairs, steps=5, bs=16, lr=2e-3, seed=0)
    got = port.train_contrastive(pairs, steps=5, bs=16, lr=2e-3, seed=0)
    assert len(got) == 5 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    after = params_from_jax(jax.tree_util.tree_map(np.asarray, ref.params),
                            device="cpu")
    leaves = list(tree_leaves(port.params))
    want_leaves = list(tree_leaves(after))
    assert len(leaves) == len(want_leaves) > 10
    for a, b in zip(leaves, want_leaves):
        assert not a.requires_grad
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-4)
    # training moved the weights, and encode still runs on them
    init = _port_copy(ref0, tok)
    assert not np.allclose(leaves[0].numpy(),
                           init.params["embed"]["w"].numpy())
    np.testing.assert_allclose(port.encode([p[0] for p in pairs[:5]]),
                               ref.encode([p[0] for p in pairs[:5]]),
                               rtol=1e-4, atol=1e-4)


def test_train_contrastive_improves_alignment(trainable):
    """The reference's own test on the port: the loss falls over 80 steps
    and the gap between paired and all-pairs similarity does not."""
    ref0, tok, pairs = trainable
    enc = _port_copy(ref0, tok)

    def pair_sim():
        a = enc.encode([p[0] for p in pairs[:32]])
        b = enc.encode([p[1] for p in pairs[:32]])
        return float(np.mean(np.sum(a * b, axis=1))) - float(np.mean(a @ b.T))

    before = pair_sim()
    losses = enc.train_contrastive(pairs, steps=80, bs=16, lr=2e-3)
    after = pair_sim()
    assert np.mean(losses[-10:]) < np.mean(losses[:10]), \
        (losses[:3], losses[-3:])
    assert after > before - 0.02, (before, after)
