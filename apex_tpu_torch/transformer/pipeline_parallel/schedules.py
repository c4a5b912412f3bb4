"""Pipeline-parallel forward/backward executors.

Port of ``apex_tpu/transformer/pipeline_parallel/schedules.py``
(reference: ``apex/transformer/pipeline_parallel/schedules/`` — three
interchangeable executors behind ``get_forward_backward_func()``:
no pipelining, 1F1B without interleaving, and interleaved 1F1B over
virtual model chunks).

Functional contract, the JAX package's:

* ``stage_fn(stage_params, hidden, microbatch) -> hidden`` — one pipeline
  stage; runs on every rank with its own stage's params.
* ``input_fn(microbatch) -> hidden`` — the first stage's entry (the
  embedding, say); not differentiated.
* ``loss_fn(hidden, microbatch) -> scalar`` — the last stage's exit, or
  ``loss_fn(hidden, microbatch, params)``: with three required
  positional parameters the loss is differentiated with respect to the
  stage's params too (a head on the last stage, a tied embedding).  A
  parameter a loss reads through a closure gets no grad, as in JAX.
* ``params`` — this rank's stage params, a tree (dicts, lists, tuples) of
  tensors; ``batch`` — a tree of tensors whose leading dim is the
  microbatch.

Every executor returns ``(mean_loss, grads)``, or ``(mean_loss, None)``
with ``forward_only``: grads are this rank's stage grads in ``params``'
layout, as new tensors (no ``.grad`` is touched); the pipelined loss is
the last stage's sum over the microbatches, divided by their number and
summed over the pipe group, so every rank returns the same loss.  The
pipelined executors run one process a rank over the pipe group of
``axis_name`` (:func:`~apex_tpu_torch.transformer.parallel_state.resolve_group`:
without the topology a pipe axis raises ``RuntimeError`` naming
``initialize_model_parallel``; a pipeline never runs quietly as one
rank).

The schedules are JAX's tick for tick.  Where JAX carries each
microbatch's vjp residuals in circular buffers through a ``lax.scan``,
here the microbatch's autograd graph is the stash: a forward keeps its
stage input (a leaf that requires grad) and its output, and the
backward calls ``torch.autograd.grad`` on them, which frees the graph.
A tick in a bubble computes nothing, but every rank joins every hop of
every tick in the same order (a ring rotation of
:mod:`~apex_tpu_torch.transformer.pipeline_parallel.p2p_communication`,
with zeros where a rank has nothing to send), so the ranks stay in
lockstep.  ``input_fn`` of microbatch 0 is evaluated once on every
rank, without grad, for the shape and type of the ring's messages (the
stage output must have its input's); the first stage reuses it.

Dropout: give each microbatch its own seed as a leaf of ``batch`` and
fold the stage into it in ``stage_fn`` (the pipe rank; under
interleaving, rank times v plus the chunk, which
``parallel_state.get_virtual_pipeline_model_parallel_rank()`` gives
while the chunk's forward or backward runs).  The graph keeps the
masks, so nothing is drawn again in the backward.

:func:`last_run_stats` gives what the last executor call of this
process did: ``max_in_flight``, the most microbatch graphs it held at
once (1F1B: at most ``2 (pp - 1) + 1`` on a rank, whatever the number
of microbatches; the GPipe oracle ``use_1f1b=False``: all of them), and
its ticks.  With ``timeline=`` a list, each tick appends ``(tick,
forward seconds, backward seconds)`` of this rank's compute (``None``
where it ran none), the device synchronised around each.
"""
from __future__ import annotations

import contextlib
import inspect
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from apex_tpu_torch.parallel import _comm
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.parallel_state import PIPE_AXIS
from apex_tpu_torch.transformer.pipeline_parallel import \
    p2p_communication as p2p
from apex_tpu_torch.transformer.pipeline_parallel.common import (
    _grad_leaves, _grads)
from apex_tpu_torch.transformer.pipeline_parallel.utils import (
    tree_leaves, tree_map, tree_unflatten_like)

__all__ = [
    "get_forward_backward_func",
    "forward_backward_no_pipelining",
    "forward_backward_pipelining_without_interleaving",
    "forward_backward_pipelining_with_interleaving",
    "embedding_grads_all_reduce",
    "interleaved_phase_ticks",
]

_LAST_RUN: dict = {}


def last_run_stats() -> dict:
    """What the last executor call of this process did:
    ``max_in_flight`` and ``ticks`` (the module docstring)."""
    return dict(_LAST_RUN)


def _pipe(axis_name):
    """The pipe group of ``axis_name``, its size and this rank's place."""
    group = parallel_state.resolve_group(axis_name)
    return group, dist.get_world_size(group), dist.get_rank(group)


def embedding_grads_all_reduce(embed_grads, *, axis_name=PIPE_AXIS):
    """Tied input/output embedding gradient reduction (reference:
    ``allreduce_word_embedding_grads`` over the group of the first and
    last pipeline stages).

    As JAX's masked psum: a sum over the pipe group to which only the
    first and last stages contribute their grads (the others zeros), so
    every stage receives the sum.  With one stage the grads come back
    as they are.
    """
    group, n, stage = _pipe(axis_name)
    if n == 1:
        return embed_grads
    member = stage in (0, n - 1)
    return tree_map(
        lambda g: _comm.all_reduce(
            g.clone() if member else torch.zeros_like(g), group),
        embed_grads)


def get_forward_backward_func(
        virtual_pipeline_model_parallel_size: Optional[int] = None,
        pipeline_model_parallel_size: Optional[int] = None):
    """The executor for the current topology (reference:
    ``schedules/__init__.py :: get_forward_backward_func``).  Without a
    topology the pipeline has one stage."""
    if pipeline_model_parallel_size is None:
        pipeline_model_parallel_size = (
            parallel_state.get_pipeline_model_parallel_world_size()
            if parallel_state.model_parallel_is_initialized() else 1)
    if virtual_pipeline_model_parallel_size is None:
        virtual_pipeline_model_parallel_size = (
            parallel_state.get_virtual_pipeline_model_parallel_world_size())
    if pipeline_model_parallel_size > 1:
        if virtual_pipeline_model_parallel_size is not None and \
                virtual_pipeline_model_parallel_size > 1:
            return forward_backward_pipelining_with_interleaving
        return forward_backward_pipelining_without_interleaving
    return forward_backward_no_pipelining


def _microbatch(batch, idx: int):
    return tree_map(
        lambda x: x[idx] if isinstance(x, torch.Tensor) else x, batch)


def _normalize_loss_fn(loss_fn):
    """Loss contract: ``loss_fn(y, mb)`` or ``loss_fn(y, mb, params)``.

    Only REQUIRED positional parameters count: ``loss_fn(y, mb, w=None)``
    or ``(y, mb, *, s=0.1)`` stay on the 2-arg contract.  Returns a
    uniform ``f(y, mb, params)`` plus whether params gradients flow
    through the loss."""
    try:
        sig = inspect.signature(loss_fn)
        n = sum(1 for p in sig.parameters.values()
                if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
                and p.default is p.empty)
    except (TypeError, ValueError):  # builtins without a signature
        n = 2
    if n >= 3:
        return loss_fn, True
    return (lambda y, mb, params: loss_fn(y, mb)), False


def forward_backward_no_pipelining(
        stage_fn: Callable, loss_fn: Callable, params, batch, *,
        num_microbatches: int, input_fn: Callable = None,
        forward_only: bool = False, **_parity_kwargs):
    """Microbatch loop with gradient accumulation, no pipelining
    (reference: ``fwd_bwd_no_pipelining.py``).  Runs anywhere, no process
    group needed.  Each microbatch's loss is differentiated alone and
    the grads summed in the params' dtype, then scaled by
    ``1 / num_microbatches``, as in JAX."""
    input_fn = input_fn or (lambda mb: mb)
    lf, _ = _normalize_loss_fn(loss_fn)
    n = num_microbatches
    if forward_only:
        total = None
        with torch.no_grad():
            for i in range(n):
                mb = _microbatch(batch, i)
                loss = lf(stage_fn(params, input_fn(mb), mb), mb,
                          params).float()
                total = loss if total is None else total + loss
        _LAST_RUN.clear()
        _LAST_RUN.update(max_in_flight=0, ticks=n)
        return total / n, None

    leaves = _grad_leaves(params)
    p = tree_unflatten_like(params, leaves)
    acc = [torch.zeros_like(t) for t in leaves]
    total = None
    for i in range(n):
        mb = _microbatch(batch, i)
        x = tree_map(lambda t: t.detach() if isinstance(t, torch.Tensor)
                     else t, input_fn(mb))
        with torch.enable_grad():
            loss = lf(stage_fn(p, x, mb), mb, p)
        for a, g in zip(acc, _grads([loss], [torch.ones_like(loss)],
                                    leaves)):
            if g is not None:
                a.add_(g)
        loss = loss.detach().float()
        total = loss if total is None else total + loss
    _LAST_RUN.clear()
    _LAST_RUN.update(max_in_flight=1, ticks=n)
    inv = 1.0 / n
    return total * inv, tree_unflatten_like(params, [a * inv for a in acc])


class _Rank:
    """One executor call's state on this rank: the pipe group, the
    ring's zero message, the stash of in-flight microbatch graphs, the
    loss sum and the grads' accumulators."""

    def __init__(self, axis_name, input_fn, batch, loss_fn, n: int,
                 params, timeline, track: bool = True):
        self.group, self.pp, self.stage = _pipe(axis_name)
        self.input_fn = input_fn
        self.lf, _ = _normalize_loss_fn(loss_fn)
        self.n = n
        self.track = track
        with torch.no_grad():
            self.x0 = input_fn(_microbatch(batch, 0))
        self.zeros = tree_map(torch.zeros_like, self.x0)
        first = tree_leaves(self.x0)[0]
        self.loss_acc = torch.zeros((), dtype=torch.float32,
                                    device=first.device)
        self.leaves = _grad_leaves(params) if track else \
            [t.detach() for t in tree_leaves(params)]
        self.acc = [torch.zeros_like(t) for t in self.leaves] if track \
            else None
        self.stash: dict = {}
        self.max_in_flight = 0
        self.ticks = 0
        self.timeline = timeline
        self.sync = first.is_cuda
        self.cur = None

    # -- ticks and hops ---------------------------------------------------
    def begin(self, t: int) -> None:
        self.ticks += 1
        self.cur = [t, None, None]

    def end(self) -> None:
        if self.timeline is not None:
            self.timeline.append(tuple(self.cur))

    def _timed(self, slot: int, fn):
        if self.timeline is None:
            return fn()
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        if self.sync:
            torch.cuda.synchronize()
        self.cur[slot] = (self.cur[slot] or 0.0) + time.perf_counter() - t0
        return out

    def hop(self, payload, direction: int):
        """This tick's rotation: ``payload`` (zeros when ``None``) to the
        next (+1) or previous (-1) rank; what arrived."""
        send = self.zeros if payload is None else payload
        if direction > 0:
            return p2p.send_forward_recv_forward(send, axis_name=self.group)
        return p2p.send_backward_recv_backward(send, axis_name=self.group)

    def input(self, mb, m: int):
        """The first stage's input of microbatch ``m``."""
        return self.x0 if m == 0 else self.input_fn(mb)

    # -- one microbatch on one stage --------------------------------------
    def forward(self, key, stage_fn, p, inputs: list, x, mb, last: bool,
                needs_dx: bool):
        """``stage_fn`` of microbatch ``mb`` on stage params ``p`` (whose
        leaves are ``inputs``) and input ``x``; on the last (virtual)
        stage the loss, added to the sum.  When the call tracks grads the
        graph is stashed under ``key``; returns the output (detached)."""
        def run():
            if not self.track:
                with torch.no_grad():
                    y = stage_fn(p, x, mb)
                    if last:
                        self.loss_acc += self.lf(y, mb, p).float()
                return y
            xl = [t.detach().requires_grad_(
                needs_dx and t.is_floating_point())
                if isinstance(t, torch.Tensor) else t
                for t in tree_leaves(x)]
            with torch.enable_grad():
                y = stage_fn(p, tree_unflatten_like(x, xl), mb)
                out = self.lf(y, mb, p) if last else y
            if last:
                self.loss_acc += out.detach().float()
            self.stash[key] = (x, xl, out, inputs)
            self.max_in_flight = max(self.max_in_flight, len(self.stash))
            return tree_map(lambda t: t.detach(), y)
        return self._timed(1, run)

    def backward(self, key, dy):
        """The stashed microbatch ``key``'s backward, seeded with ``dy``
        (the received output grad), or on the last stage (``dy`` None)
        with the loss cotangent ``1 / n`` in the loss's dtype.  Returns
        the input grad (zeros where none flows) and the inputs' grads."""
        def run():
            x, xl, out, inputs = self.stash.pop(key)
            if dy is None:
                outs = [out]
                seeds = [torch.full((), 1.0 / self.n, dtype=out.dtype,
                                    device=out.device)]
            else:
                outs, seeds = tree_leaves(out), tree_leaves(dy)
            g = _grads(outs, seeds, xl + list(inputs))
            dx = [torch.zeros_like(t) if d is None else d
                  for t, d in zip(xl, g[:len(xl)])]
            return tree_unflatten_like(x, dx), g[len(xl):]
        return self._timed(2, run)

    def add_grads(self, grads: list, chunk: Optional[int] = None) -> None:
        """Add a backward's params grads to the accumulators (rows
        ``chunk`` of the stacked ones under interleaving)."""
        for a, d in zip(self.acc, grads):
            if d is not None:
                (a if chunk is None else a[chunk]).add_(d)

    def mean_loss(self):
        """The loss sum over ``n``, summed over the pipe group."""
        loss = self.loss_acc / self.n
        return _comm.all_reduce(loss.reshape(1), self.group).reshape(())

    def record(self) -> None:
        _LAST_RUN.clear()
        _LAST_RUN.update(max_in_flight=self.max_in_flight, ticks=self.ticks)


def _pipeline_1f1b(stage_fn, loss_fn, input_fn, params, batch, *,
                   num_microbatches: int, axis_name, timeline):
    """True-1F1B pipelined forward and backward (reference:
    ``fwd_bwd_pipelining_without_interleaving.py``), JAX's
    ``_pipeline_1f1b_local`` tick for tick.

    ``n + 2 (pp - 1)`` ticks: forward-only warmup ``[0, pp - 1)``, the
    steady state ``[pp - 1, n + pp - 1)`` where stage s runs the forward
    of microbatch ``t - s`` and then the backward of microbatch
    ``t - 2 (pp - 1) + s``, and backward-only cooldown.  A microbatch is
    in flight on stage s from its forward (tick ``m + s``) to its
    backward (tick ``m + 2 (pp - 1) - s``): at most ``2 (pp - 1) + 1``
    at once, whatever ``n`` is."""
    n = num_microbatches
    r = _Rank(axis_name, input_fn, batch, loss_fn, n, params, timeline)
    pp, s = r.pp, r.stage
    last = s == pp - 1
    p = tree_unflatten_like(params, r.leaves)
    warm_end, fwd_end, n_ticks = pp - 1, n + pp - 1, n + 2 * (pp - 1)
    fwd_msg = bwd_msg = None
    for t in range(n_ticks):
        r.begin(t)
        if t < fwd_end:
            f, send = t - s, None
            if 0 <= f < n:
                mb = _microbatch(batch, f)
                x = r.input(mb, f) if s == 0 else fwd_msg
                y = r.forward(f, stage_fn, p, r.leaves, x, mb, last,
                              needs_dx=s > 0)
                send = None if last else y
            fwd_msg = r.hop(send, +1)
        if t >= warm_end:
            b, send = t - 2 * (pp - 1) + s, None
            if 0 <= b < n:
                dx, g = r.backward(b, None if last else bwd_msg)
                r.add_grads(g)
                send = dx if s > 0 else None
            bwd_msg = r.hop(send, -1)
        r.end()
    r.record()
    return r.mean_loss(), tree_unflatten_like(params, r.acc)


def _pipeline_gpipe(stage_fn, loss_fn, input_fn, params, batch, *,
                    num_microbatches: int, axis_name, timeline,
                    forward_only: bool = False):
    """The GPipe oracle (JAX: the gradient of ``_pipeline_local_loss``'s
    forward scan): ``n + pp - 1`` forward ticks, stage s running
    microbatch ``t - s``, then ``n + pp - 1`` backward ticks, stage s
    running the backward of microbatch ``t - (pp - 1 - s)``.  Every
    microbatch is in flight at once.  The backwards take the
    microbatches in 1F1B's order, so the grads are summed in the same
    order and their bits are 1F1B's (JAX's transposed scan sums them in
    reverse, which rounds otherwise in bf16).  With ``forward_only`` the
    forward ticks alone, without grad."""
    n = num_microbatches
    r = _Rank(axis_name, input_fn, batch, loss_fn, n, params, timeline,
              track=not forward_only)
    pp, s = r.pp, r.stage
    last = s == pp - 1
    p = tree_unflatten_like(params, r.leaves)
    n_ticks = n + pp - 1
    msg = None
    for t in range(n_ticks):
        r.begin(t)
        f, send = t - s, None
        if 0 <= f < n:
            mb = _microbatch(batch, f)
            x = r.input(mb, f) if s == 0 else msg
            y = r.forward(f, stage_fn, p, r.leaves, x, mb, last,
                          needs_dx=s > 0)
            send = None if last else y
        msg = r.hop(send, +1)
        r.end()
    if forward_only:
        r.record()
        return r.mean_loss(), None
    msg = None
    for t in range(n_ticks):
        r.begin(t)
        b, send = t - (pp - 1 - s), None
        if 0 <= b < n:
            dx, g = r.backward(b, None if last else msg)
            r.add_grads(g)
            send = dx if s > 0 else None
        msg = r.hop(send, -1)
        r.end()
    r.record()
    return r.mean_loss(), tree_unflatten_like(params, r.acc)


def forward_backward_pipelining_without_interleaving(
        stage_fn: Callable, loss_fn: Callable, params, batch, *,
        num_microbatches: int, input_fn: Callable = None,
        forward_only: bool = False, axis_name=PIPE_AXIS,
        use_1f1b: bool = True, timeline: Optional[list] = None,
        **_parity_kwargs):
    """1F1B pipelined executor (reference:
    ``fwd_bwd_pipelining_without_interleaving.py``).

    ``params`` is this rank's stage.  The backward is the 1F1B schedule
    (bounded in-flight microbatches); ``use_1f1b=False`` runs the GPipe
    oracle (all forwards, then all backwards), which gives the same loss
    and grads.  ``forward_only`` runs the forward ticks alone."""
    input_fn = input_fn or (lambda mb: mb)
    if forward_only or not use_1f1b:
        return _pipeline_gpipe(
            stage_fn, loss_fn, input_fn, params, batch,
            num_microbatches=num_microbatches, axis_name=axis_name,
            timeline=timeline, forward_only=forward_only)
    return _pipeline_1f1b(
        stage_fn, loss_fn, input_fn, params, batch,
        num_microbatches=num_microbatches, axis_name=axis_name,
        timeline=timeline)


def interleaved_phase_ticks(num_microbatches: int, pp: int, v: int):
    """Static phase boundaries of the interleaved schedule, in chunk-ticks:
    ``(warmup, steady, cooldown)`` where warmup ticks run forward-only,
    steady ticks run one chunk-forward AND one chunk-backward (true 1F1B),
    and cooldown ticks run backward-only.

    Each chunk-tick costs ``1/v`` of a full-stage tick (a chunk is ``1/v``
    of the rank's layers), so total time in full-stage fwd+bwd units is
    ``(warmup + cooldown)/(2v) + steady/v  =  n + (pp-1)/v`` — the
    reference's interleaved bubble ``(pp-1)/v`` (vs ``pp-1`` without
    interleaving).
    """
    n = num_microbatches
    t0 = v * pp                    # first backward anywhere
    f_end = n * v + pp - 1         # forward window end (exclusive)
    total = t0 + pp - 1 + n * v    # last backward tick + 1
    return t0, f_end - t0, total - f_end


@contextlib.contextmanager
def _virtual_rank(chunk: int):
    """The virtual pipeline rank set to ``chunk`` while a chunk runs."""
    before = parallel_state.get_virtual_pipeline_model_parallel_rank()
    parallel_state.set_virtual_pipeline_model_parallel_rank(chunk)
    try:
        yield
    finally:
        parallel_state.set_virtual_pipeline_model_parallel_rank(before)


def _pipeline_interleaved(stage_fn, loss_fn, input_fn, params, batch, *,
                          num_microbatches: int, v: int, axis_name,
                          forward_only: bool, timeline):
    """Interleaved 1F1B over ``v`` virtual chunks a rank (reference:
    ``fwd_bwd_pipelining_with_interleaving.py``), JAX's
    ``_pipeline_interleaved_local`` tick for tick.

    Virtual stage ``c * pp + r`` is chunk c on rank r.  Rank r's forward
    sequence index ``i`` runs at tick ``r + i`` and decodes as
    ``g = i // (pp v)``, ``c = (i % (pp v)) // pp``, ``m = g pp + i % pp``;
    every producer-consumer edge is a +1 rotation consumed one tick
    later (the hand-off from rank pp - 1 to rank 0 rides the
    wrap-around).  Backwards mirror it with -1 rotations from tick
    ``v pp + (pp - 1 - r)``, chunks in reverse order.  The params'
    leaves lead with the chunk dim ``[v, ...]``; chunk c's forward reads
    the views ``leaf[c]``, and its grads land in rows c of the
    accumulators."""
    n = num_microbatches
    r = _Rank(axis_name, input_fn, batch, loss_fn, n, params, timeline,
              track=not forward_only)
    pp, s = r.pp, r.stage
    if n % pp != 0:
        raise ValueError(
            "interleaved pipelining requires num_microbatches to be a "
            f"multiple of the pipeline size (got {n} % {pp}); the "
            "reference asserts the same")
    group = pp * v
    t0, steady, cooldown = interleaved_phase_ticks(n, pp, v)
    f_end = t0 + steady
    total = f_end + cooldown
    views = [[leaf[c] for leaf in r.leaves] for c in range(v)]
    chunk_p = [tree_unflatten_like(params, views[c]) for c in range(v)]
    fwd_msg = bwd_msg = None
    for t in range(f_end if forward_only else total):
        r.begin(t)
        if t < f_end:
            i, send = t - s, None
            if 0 <= i < n * v:
                g_idx, j = divmod(i, group)
                c, m = j // pp, g_idx * pp + j % pp
                mb = _microbatch(batch, m)
                inject = s == 0 and c == 0
                last = s == pp - 1 and c == v - 1
                x = r.input(mb, m) if inject else fwd_msg
                with _virtual_rank(c):
                    y = r.forward((c, m), stage_fn, chunk_p[c], views[c], x,
                                  mb, last, needs_dx=not inject)
                send = None if last else y
            fwd_msg = r.hop(send, +1)
        if not forward_only and t >= t0:
            ib, send = t - t0 - (pp - 1 - s), None
            if 0 <= ib < n * v:
                g_b, j_b = divmod(ib, group)
                c_b = v - 1 - j_b // pp
                m_b = g_b * pp + j_b % pp
                last = s == pp - 1 and c_b == v - 1
                with _virtual_rank(c_b):
                    dx, g = r.backward((c_b, m_b), None if last else bwd_msg)
                r.add_grads(g, c_b)
                send = None if (s == 0 and c_b == 0) else dx
            bwd_msg = r.hop(send, -1)
        r.end()
    r.record()
    grads = None if forward_only else tree_unflatten_like(params, r.acc)
    return r.mean_loss(), grads


def forward_backward_pipelining_with_interleaving(
        stage_fn: Callable, loss_fn: Callable, params, batch, *,
        num_microbatches: int, input_fn: Callable = None,
        forward_only: bool = False, axis_name=PIPE_AXIS,
        virtual_pipeline_model_parallel_size: Optional[int] = None,
        timeline: Optional[list] = None, **_parity_kwargs):
    """Virtual-pipeline interleaved-1F1B executor (reference:
    ``fwd_bwd_pipelining_with_interleaving.py``): the model is split into
    ``v`` chunks a rank, chunk c on rank r being virtual stage
    ``c * pp + r``, and the bubble shrinks to ``(pp - 1) / v`` of a stage
    tick (:func:`interleaved_phase_ticks`).

    Params leaves carry a leading chunk dim ``[v, ...]``, and the grads
    come back in that layout.  ``v`` is the argument, else
    ``parallel_state``'s virtual size, else the leaves' leading dim.
    Requires ``num_microbatches % pp == 0`` (``ValueError``, as the
    reference asserts).  ``v == 1`` is 1F1B over chunk 0."""
    input_fn = input_fn or (lambda mb: mb)
    v = virtual_pipeline_model_parallel_size
    if v is None:
        v = (parallel_state.get_virtual_pipeline_model_parallel_world_size()
             or tree_leaves(params)[0].shape[0])
    if v == 1:
        chunk0 = tree_map(lambda x: x[0], params)
        loss, grads = forward_backward_pipelining_without_interleaving(
            stage_fn, loss_fn, chunk0, batch,
            num_microbatches=num_microbatches, input_fn=input_fn,
            forward_only=forward_only, axis_name=axis_name,
            timeline=timeline)
        if grads is not None:
            grads = tree_map(lambda g: g[None], grads)
        return loss, grads
    return _pipeline_interleaved(
        stage_fn, loss_fn, input_fn, params, batch,
        num_microbatches=num_microbatches, v=v, axis_name=axis_name,
        forward_only=forward_only, timeline=timeline)
