import collections

import numpy as np
import pytest

import closed_loop
import world
from conftest import tiny_mix
from reference.tokenizer import Tokenizer

SEEDS = [7, 2 ** 31 + 5, 3 * 10 ** 9 + 17]


@pytest.fixture(scope="module")
def store():
    return world.store_pairs("squad", 3000, seed=11)


@pytest.fixture(scope="module")
def tok():
    return Tokenizer.from_texts(world.vocabulary_corpus("squad", 3000))


def test_streams_repeat_per_seed_and_differ_across_seeds(store):
    mix = tiny_mix("faq.closed8")
    a = closed_loop.streams(mix, store[0], SEEDS[1])
    b = closed_loop.streams(mix, store[0], SEEDS[1])
    c = closed_loop.streams(mix, store[0], SEEDS[2])
    assert a == b
    assert a != c


@pytest.mark.parametrize("seed", SEEDS)
def test_faq_hit_share_is_exactly_nine_in_ten(store, seed):
    mix = dict(tiny_mix("faq.closed8"), block=10, novel_per_block=1)
    for s in closed_loop.streams(mix, store[0], seed):
        for b in range(0, len(s), 10):
            blk = s[b:b + 10]
            assert sum(r.row is None for r in blk) == 1
            for r in blk:
                if r.row is not None:
                    assert store[0][r.row] == r.text


@pytest.mark.parametrize("name", ["miss.closed32", "faq.closed8"])
def test_novel_questions_never_repeat_and_are_not_stored(store, name):
    mix = tiny_mix(name)
    texts = [r.text for s in closed_loop.streams(mix, store[0], SEEDS[0])
             for r in s if r.row is None]
    assert len(texts) == len(set(texts))
    assert not set(texts) & set(store[0])


@pytest.mark.parametrize("name", ["miss.closed32", "faq.closed8"])
def test_every_seed_sends_the_same_work_in_the_same_order(store, tok, name):
    mix = tiny_mix(name)

    def shape(seed):
        return [[(r.row is None, len(tok.encode(r.text, bos=True))
                  if r.row is None else 0, r.max_new) for r in s]
                for s in closed_loop.streams(mix, store[0], seed)]
    assert shape(SEEDS[0]) == shape(SEEDS[1]) == shape(SEEDS[2])
    lens = collections.Counter(x[1:] for s in shape(SEEDS[0]) for x in s
                               if x[0])
    assert len(lens) > 8          # still many sizes within a run


def test_no_prompt_falls_back_to_bytes_and_all_fit(store, tok):
    mix = tiny_mix("miss.closed32")
    mix.update(max_new_lo=32, max_new_hi=128)
    for s in closed_loop.streams(mix, store[0], SEEDS[0]):
        for r in s:
            ids = tok.encode(r.text, bos=True)
            assert all(i >= 4 + 256 for i in ids[1:])
            assert len(ids) + r.max_new <= 159


def test_max_new_is_log_uniform_quantiles():
    v = world.spread_quantiles(32, 128, 8)
    assert v == sorted(v) and 32 <= v[0] and v[-1] <= 128
    ratios = np.diff(np.log(v))
    assert np.allclose(ratios, ratios.mean(), atol=0.05)


def test_store_pairs_are_distinct(store):
    q, a = store
    assert len(q) == len(set(q)) == 3000 and len(a) == 3000
