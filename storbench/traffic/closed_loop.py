"""The one traffic generator: closed-loop clients, each with its own
stream of requests drawn from ``--seed``.

A mix file names this module and sets its parameters:

* ``clients`` waiting clients (each sends its next request when the last
  one is answered) and the pipeline's ``decode_slots``;
* ``block`` and ``novel_per_block``: a client's stream comes in blocks of
  ``block`` requests, ``novel_per_block`` of them novel questions and the
  rest stored questions asked verbatim, drawn by ``stored_profile``'s
  Zipf popularity over the store's rows. So the hit share is exactly
  1 - novel_per_block / block at every seed;
* ``novel_profile``: the hard share and template skew of the novel
  questions, rendered over entities the store does not hold;
* ``max_new_lo``/``max_new_hi``: each novel request's answer length, at
  the mid-quantiles of the log-uniform law between them;
* ``blocks_per_client``: the stream's length (a client that reaches its
  end stops).

Every seed sends the same work in the same order: each client's
sequence of prompt lengths and answer lengths, and where its novel
questions sit in its blocks, are the mix's, drawn once. The seed draws
which entities, relations and stored rows fill them: it changes which
questions are asked, not how much work they are or when they come. (A
closed loop admits misses into decode waves by arrival; sizes that came
in another order at every seed moved the waves, and with them a
window's tokens, by 15-20% from seed to seed.)
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

import world
from kb import PROFILES


SHAPE_SEED = 20250920


@dataclasses.dataclass(frozen=True)
class Req:
    text: str
    max_new: int
    row: Optional[int]       # the stored row it must hit; None: a miss


def streams(mix: dict, questions: List[str], seed: int) -> List[List[Req]]:
    clients, block = mix["clients"], mix["block"]
    n_novel = mix["novel_per_block"]
    n_blocks = mix["blocks_per_client"]
    per_client = n_blocks * n_novel
    # the work's shape is the mix's, drawn once: each client's sequence of
    # novel specs (the i-th spec always asks for the i-th answer length)
    # and the novel positions in its blocks. The seed draws the content:
    # entities, relations of the spec's word count, stored rows.
    shape = np.random.default_rng(SHAPE_SEED)
    specs = world.novel_specs(mix["novel_profile"], per_client)
    lengths = world.spread_quantiles(mix["max_new_lo"], mix["max_new_hi"],
                                     per_client)
    orders = [shape.permutation(per_client) for _ in range(clients)]
    at = [[set(shape.choice(block, n_novel, replace=False).tolist())
           for _ in range(n_blocks)] for _ in range(clients)]
    rng = np.random.default_rng([int(seed), 0x5EED])
    serials = rng.permutation(32 ** 4)[:clients * per_client]
    n_hits = n_blocks * (block - n_novel)
    hit_rows = world.zipf_rows(
        len(questions), PROFILES[mix["stored_profile"]]["zipf_a"],
        clients * n_hits, rng) if n_hits else np.zeros(0, np.int64)
    out = []
    for c in range(clients):
        novel = []
        for j, i in enumerate(orders[c]):
            kind, tmpl, filler, words = specs[i]
            text = world.novel_question(kind, tmpl, filler,
                                        world.relation_of(words, rng),
                                        int(serials[c * per_client + j]))
            novel.append(Req(text, int(lengths[i]), None))
        hits = [Req(questions[r], int(mix["max_new_lo"]), int(r))
                for r in hit_rows[c * n_hits:(c + 1) * n_hits]]
        stream = []
        for b in range(n_blocks):
            for pos in range(block):
                stream.append(novel.pop(0) if pos in at[c][b]
                              else hits.pop(0))
        out.append(stream)
    return out
