"""Speculative decoding drafters (ISSUE 15): propose ``k`` tokens per
slot for the engine's batched verify step.

The division of labor: a :class:`Drafter` is pure HOST bookkeeping —
it sees each request's confirmed token stream (prompt at ``begin``,
every emitted token at ``observe``) and proposes up to ``k``
continuation tokens per decode round.  The DEVICE side never changes
with the drafter: the target engine scores whatever was proposed in
its one compiled verify executable
(:func:`~apex_tpu_torch.inference.engine.make_verify_fn`), accepts the
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
* :class:`EngineDrafter` — a SMALL draft model restored beside the
  target: a second (dense-cache) :class:`~apex_tpu_torch.inference.
  engine.InferenceEngine` drafts ``k`` tokens with ``k`` batched greedy
  decode steps, then rolls its own cache back to the pre-draft
  lengths (:func:`~apex_tpu_torch.inference.kv_cache.set_lengths`) so
  only CONFIRMED tokens ever stay resident — the draft-side mirror of
  the target's page-table rollback.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np

from apex_tpu_torch.inference import kv_cache

__all__ = ["default_spec_k", "Drafter", "NGramDrafter", "ReplayDrafter",
           "EngineDrafter"]

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


class EngineDrafter(Drafter):
    """A small draft model beside the target: batched greedy decode
    steps on a second (dense-cache) engine propose ``k`` tokens, then
    the draft cache rolls back to the pre-draft lengths so only
    confirmed tokens stay resident.

    The draft engine must share the target's tokenizer/vocab, run the
    DENSE cache (its rollback is a pure length reset — no page
    bookkeeping to mirror), greedy sampling, and at least the target's
    slot count.  Confirmed tokens the target emits land in a pending
    queue and are fed through catch-up decode steps before the next
    draft round (a reference implementation: it re-decodes accepted
    tokens on the draft side rather than trusting draft-side rows
    that may diverge from the confirmed stream).  The rollback is the
    port's in-place :func:`~apex_tpu_torch.inference.kv_cache.
    set_lengths`."""

    def __init__(self, engine):
        if engine.kind == "bert":
            raise ValueError("the draft engine must be generative")
        if engine.paged:
            raise ValueError(
                "EngineDrafter drafts on the DENSE slot cache (its "
                "rollback is a pure length reset); build the draft "
                "engine without paged kwargs")
        if not engine.sampling.is_greedy:
            raise ValueError("the draft engine must sample greedily")
        self.engine = engine
        self.cache = engine.init_cache()
        self._len = np.zeros((engine.slots,), np.int32)
        self._pending: Dict[int, List[int]] = {}

    def begin(self, slot, prompt, first_token):
        self.cache, _, _ = self.engine.prefill(
            self.cache, list(prompt), slot)
        self._len[slot] = len(prompt)
        self._pending[slot] = [int(first_token)]

    def observe(self, slot, tokens):
        if slot in self._pending:
            self._pending[slot].extend(int(t) for t in tokens)

    def retire(self, slot):
        self._pending.pop(slot, None)
        self._len[slot] = 0

    def _catch_up(self):
        """Feed confirmed-but-unfed tokens (all but each slot's last)
        through batched decode steps; outputs are discarded."""
        slots = self.engine.slots
        while True:
            feed = np.zeros((slots,), np.int32)
            act = np.zeros((slots,), bool)
            for s, pend in self._pending.items():
                if len(pend) > 1:
                    feed[s] = pend.pop(0)
                    act[s] = True
            if not act.any():
                return
            self.cache, _, _, _ = self.engine.decode(self.cache, feed,
                                                     act)
            self._len[act] += 1

    def draft(self, slot, k):           # pragma: no cover - use batch
        out = self.draft_batch(
            np.eye(self.engine.slots, dtype=bool)[slot], k)
        return [int(t) for t in out[slot]]

    def draft_batch(self, active, k) -> np.ndarray:
        """``k`` greedy draft tokens for every active slot in ``k``
        batched decode steps, cache rolled back afterwards."""
        slots = self.engine.slots
        act = np.zeros((slots,), bool)
        feed = np.zeros((slots,), np.int32)
        for s, pend in self._pending.items():
            if active[s] and pend:
                act[s] = True
                feed[s] = pend[-1]
        drafts = np.zeros((slots, k), np.int32)
        if not act.any() or k < 1:
            return drafts
        self._catch_up()
        for s, pend in self._pending.items():   # refresh post-catch-up
            if act[s]:
                feed[s] = pend[-1]
        for j in range(k):
            self.cache, toks, _, _ = self.engine.decode(self.cache,
                                                        feed, act)
            toks = np.asarray(toks)
            drafts[:, j] = np.where(act, toks, 0)
            feed = np.where(act, toks, feed).astype(np.int32)
        # the rollback: drafted rows go dead-by-mask, pending stays
        # intact (its last token is still the next confirmed input)
        self.cache = kv_cache.set_lengths(self.cache, self._len.copy())
        return drafts
