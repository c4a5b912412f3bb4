"""Speculative decoding drafters (ISSUE 15): propose ``k`` tokens per
slot for the engine's batched verify step.

The division of labor: a :class:`Drafter` is pure HOST bookkeeping —
it sees each request's confirmed token stream (prompt at ``begin``,
every emitted token at ``observe``) and proposes up to ``k``
continuation tokens per decode round.  The DEVICE side never changes
with the drafter: the target engine scores whatever was proposed in
its one compiled verify executable
(:func:`~apex_tpu.inference.engine.make_verify_fn`), accepts the
longest matching prefix, and emits the bonus token — so a weak draft
can only cost speculation upside, never correctness (the emitted
stream is the target's own greedy stream, always).

Drafters shipped:

* :class:`NGramDrafter` — prompt-lookup ("self-drafting") after
  PAPERS.md's repeated-structure observation: the longest recent
  n-gram is matched against the request's OWN earlier tokens (prompt +
  generated) and the continuation that followed last time is proposed.
  Zero device work, zero extra compiles; acceptance tracks how
  self-similar the stream is (templated/structured output: high).
* :class:`ReplayDrafter` — drafts from a scripted continuation per
  prompt.  The measurement harness: a script recorded from a base
  (non-speculative) run gives acceptance ~1.0 — the machinery ceiling
  any model-based drafter is bounded by — and a poisoned script
  deterministically exercises the reject/rollback path in tests.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

__all__ = ["default_spec_k", "Drafter", "NGramDrafter", "ReplayDrafter"]

_SPEC_K_ENV = "APEX_TPU_SPEC_K"


def default_spec_k() -> int:
    """``APEX_TPU_SPEC_K``: drafted tokens per decode round (0 =
    speculation off, the default).  The engine compiles ONE verify
    executable per value (slab width ``k + 1`` is static)."""
    env = os.environ.get(_SPEC_K_ENV)
    if not env:
        return 0
    try:
        val = int(env)
    except ValueError as e:
        raise ValueError(
            f"{_SPEC_K_ENV} must be an int, got {env!r}") from e
    if val < 0:
        raise ValueError(f"{_SPEC_K_ENV} must be >= 0, got {val}")
    return val


class Drafter:
    """Base drafter: the host-side lifecycle the scheduler drives.

    ``begin(slot, prompt, first_token)`` opens a slot's stream (the
    prompt plus the target's prefill-sampled first token);
    ``observe(slot, tokens)`` appends every CONFIRMED emitted token
    (accepted drafts + bonus — the target's stream, never the
    drafts); ``draft(slot, k)`` proposes up to ``k`` continuation
    tokens (fewer or none is fine — the scheduler pads, and padding
    merely rejects); ``retire(slot)`` closes the stream.  The base
    class never drafts (every round emits exactly the bonus token =
    plain decode correctness at verify-step cost)."""

    def begin(self, slot: int, prompt: Sequence[int],
              first_token: int) -> None:
        pass

    def observe(self, slot: int, tokens: Sequence[int]) -> None:
        pass

    def retire(self, slot: int) -> None:
        pass

    def draft(self, slot: int, k: int) -> List[int]:
        return []

    def draft_batch(self, active, k) -> np.ndarray:
        """``[slots, k]`` int32 draft matrix for one verify round:
        per-slot :meth:`draft` results, zero-padded (a padding draft
        just rejects — correctness never depends on the drafter)."""
        active = np.asarray(active, bool)
        out = np.zeros((active.shape[0], k), np.int32)
        for s in range(active.shape[0]):
            if active[s]:
                d = list(self.draft(s, k))[:k]
                out[s, :len(d)] = d
        return out


class NGramDrafter(Drafter):
    """Prompt-lookup drafting: match the stream's recent suffix against
    its own history, propose what followed the last occurrence.

    ``max_ngram`` bounds the match length tried (longest first — a
    longer matched context predicts better); ``min_ngram`` refuses
    single-token coincidences when > 1.  Pure python over per-slot int
    lists: O(history · ngram) per draft, trivial at serving scale next
    to a device step."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{min_ngram}/{max_ngram}")
        self.max_ngram = int(max_ngram)
        self.min_ngram = int(min_ngram)
        self._hist: Dict[int, List[int]] = {}

    def begin(self, slot, prompt, first_token):
        self._hist[slot] = [int(t) for t in prompt] + [int(first_token)]

    def observe(self, slot, tokens):
        if slot in self._hist:
            self._hist[slot].extend(int(t) for t in tokens)

    def retire(self, slot):
        self._hist.pop(slot, None)

    def draft(self, slot, k):
        hist = self._hist.get(slot)
        if not hist or k < 1:
            return []
        n = len(hist)
        for m in range(min(self.max_ngram, n - 1), self.min_ngram - 1,
                       -1):
            pat = hist[-m:]
            # latest earlier occurrence wins (recency: loops repeat
            # their most recent period)
            for i in range(n - m - 1, -1, -1):
                if hist[i:i + m] == pat:
                    out = hist[i + m:i + m + k]
                    if out:
                        return out
        return []


class ReplayDrafter(Drafter):
    """Drafts from a scripted continuation per prompt: ``script`` maps
    ``tuple(prompt)`` to the expected generated-token list (first
    token included).  A script recorded from a base greedy run yields
    acceptance ~1.0 (the harness ceiling); a deliberately wrong
    script exercises rejection deterministically."""

    def __init__(self, script: Dict[tuple, Sequence[int]]):
        self.script = {tuple(int(t) for t in k): [int(t) for t in v]
                       for k, v in script.items()}
        self._seq: Dict[int, List[int]] = {}
        self._pos: Dict[int, int] = {}

    def begin(self, slot, prompt, first_token):
        self._seq[slot] = self.script.get(
            tuple(int(t) for t in prompt), [])
        self._pos[slot] = 1            # first_token is generated[0]

    def observe(self, slot, tokens):
        if slot in self._pos:
            self._pos[slot] += len(tokens)

    def retire(self, slot):
        self._seq.pop(slot, None)
        self._pos.pop(slot, None)

    def draft(self, slot, k):
        seq = self._seq.get(slot)
        if not seq:
            return []
        pos = self._pos[slot]
        return seq[pos:pos + k]

