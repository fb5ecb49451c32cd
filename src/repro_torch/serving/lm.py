"""TorchLM: the QueryLM interface driven through the port's engine (the
counterpart of the JAX package's ``serving/lm.py:TinyJaxLM``).

Prompt -> tokens -> chunked decode -> detokenize. On a CUDA engine the
prompt's prefill runs on the flash attention kernel (B4) and every decode
step on the decode attention kernel (B3). With random weights the text is
gibberish (no pretrained weights ship here), so the paper-reproduction
builds use the SyntheticOracleLM for semantics; this class proves the
offline generator runs an actual LLM end to end, and is what real weights
would be swapped into.
"""
from __future__ import annotations

from repro_torch.serving.engine import Engine

PROMPT = ("you are a user asking questions about the following document. "
          "do not repeat any of these earlier questions: {masked}. "
          "document: {chunk}. question:")


class TorchLM:
    """``generate_query`` samples at the generator's temperature, seeded by
    a counter that starts at 0 and steps once per call (its tokens match
    ``TinyJaxLM``'s in distribution only: ``jax.random`` streams cannot be
    reproduced); ``answer`` is greedy."""

    def __init__(self, engine: Engine, max_new: int = 12):
        self.engine = engine
        self.max_new = max_new
        self._seed = 0

    @staticmethod
    def query_prompt(chunk_text, masked) -> str:
        chunk = chunk_text.split("\x00", 1)[-1]
        return PROMPT.format(masked="; ".join(masked[:8]), chunk=chunk)

    @staticmethod
    def answer_prompt(query, chunk_text) -> str:
        chunk = chunk_text.split("\x00", 1)[-1]
        return f"document: {chunk}. question: {query}. answer:"

    def generate_query(self, chunk_text, masked, temperature, rng):
        self._seed += 1
        return self.engine.generate(self.query_prompt(chunk_text, masked),
                                    max_new=self.max_new,
                                    temperature=float(temperature),
                                    seed=self._seed)

    def answer(self, query, chunk_text):
        return self.engine.generate(self.answer_prompt(query, chunk_text),
                                    max_new=self.max_new, temperature=None,
                                    seed=0)
