"""Loss scaling — functional core and the imperative wrapper.

Port of ``apex_tpu/amp/scaler.py``: the dynamic schedule (initial scale
2^16, x2 growth after 2000 clean steps, x0.5 backoff on overflow,
clamped to [1, 2^24]).  :class:`LossScaleState` holds 0-d device
tensors, and every function here runs as device ops: the overflow flag
comes from :func:`apex_tpu_torch.ops.fused_update.fused_scale` and the
schedule is ``torch.where`` over device scalars, so a training step
reads nothing back to the host between its backward and its update.

Where the JAX functions return new arrays, :func:`unscale_flat_grads`
unscales the flat grad buffer in place (the counterpart of donating
it).  The cross-rank flag reduction (``axis_name=``) and the per-leaf
nonfinite counts of the numerics probes are not ported (ROADMAP queue
1, items 6 and 7).
"""
from __future__ import annotations

import dataclasses

import torch

from apex_tpu_torch.ops.fused_update import fused_scale
from apex_tpu_torch.utils import resolve_device, tree_ravel

__all__ = ["LossScaleState", "init_loss_scale", "scale_loss_value",
           "unscale_grads", "unscale_flat_grads", "update_scale",
           "LossScaler"]

DEFAULT_INIT_SCALE = 2.0 ** 16
DEFAULT_GROWTH_FACTOR = 2.0
DEFAULT_BACKOFF_FACTOR = 0.5
DEFAULT_GROWTH_INTERVAL = 2000
MAX_SCALE = 2.0 ** 24
MIN_SCALE = 1.0


@dataclasses.dataclass(frozen=True)
class LossScaleState:
    """Scaler state: 0-d device tensors plus the static ``dynamic``."""
    loss_scale: torch.Tensor       # f32: the current scale
    growth_tracker: torch.Tensor   # i32: clean steps since last growth
    found_inf: torch.Tensor        # f32: overflow flag of the last unscale
    dynamic: bool = True

    def replace(self, **kw) -> "LossScaleState":
        return dataclasses.replace(self, **kw)


def init_loss_scale(loss_scale="dynamic", device=None) -> LossScaleState:
    """Scaler state on ``device`` (CUDA unless ``"cpu"`` is asked for).
    ``loss_scale``: ``"dynamic"`` or a fixed float."""
    dev = resolve_device(device)
    dynamic = loss_scale == "dynamic"
    scale = DEFAULT_INIT_SCALE if dynamic else float(loss_scale)
    return LossScaleState(
        loss_scale=torch.full((), scale, dtype=torch.float32, device=dev),
        growth_tracker=torch.zeros((), dtype=torch.int32, device=dev),
        found_inf=torch.zeros((), dtype=torch.float32, device=dev),
        dynamic=dynamic)


def scale_loss_value(loss, state: LossScaleState):
    """``loss * scale``."""
    return loss * state.loss_scale.to(loss.dtype)


def unscale_grads(grads, state: LossScaleState):
    """Unscale a grad tree (a nested dict of tensors) by
    1/scale with fused overflow detection.  Returns ``(unscaled tree,
    new state with found_inf set)``."""
    flat, unravel = tree_ravel(grads)
    out, flag = fused_scale(flat, 1.0 / state.loss_scale, out=flat)
    return unravel(out), state.replace(found_inf=flag)


def unscale_flat_grads(flat_grads, state: LossScaleState, axis_name=None):
    """Flat-native unscale: ``flat_grads`` is multiplied by 1/scale IN
    PLACE by the fused kernel, which also sets the overflow flag.
    Returns ``(flat_grads, new state with found_inf set)``."""
    if axis_name is not None:
        raise NotImplementedError(
            "the cross-rank overflow flag (axis_name=, ZeRO) is not "
            "ported yet (ROADMAP queue 1, item 6)")
    out, flag = fused_scale(flat_grads, 1.0 / state.loss_scale,
                            out=flat_grads)
    return out, state.replace(found_inf=flag)


def update_scale(state: LossScaleState,
                 growth_factor=DEFAULT_GROWTH_FACTOR,
                 backoff_factor=DEFAULT_BACKOFF_FACTOR,
                 growth_interval=DEFAULT_GROWTH_INTERVAL,
                 min_scale=MIN_SCALE, max_scale=MAX_SCALE) -> LossScaleState:
    """Post-step scale update (parity: ``LossScaler.update_scale``), as
    device ops."""
    zero = torch.zeros_like(state.found_inf)
    if not state.dynamic:
        return state.replace(found_inf=zero)
    overflow = state.found_inf > 0
    tracker = torch.where(overflow, 0, state.growth_tracker + 1)
    grow = tracker >= growth_interval
    scale = torch.where(
        overflow,
        torch.clamp(state.loss_scale * backoff_factor, min=min_scale),
        torch.where(grow,
                    torch.clamp(state.loss_scale * growth_factor,
                                max=max_scale),
                    state.loss_scale))
    tracker = torch.where(grow, 0, tracker)
    return LossScaleState(scale.to(torch.float32), tracker.to(torch.int32),
                          zero, state.dynamic)


class LossScaler:
    """Imperative wrapper over :class:`LossScaleState` with the
    reference's method surface."""

    def __init__(self, loss_scale="dynamic", init_scale=None,
                 scale_factor=DEFAULT_GROWTH_FACTOR,
                 scale_window=DEFAULT_GROWTH_INTERVAL,
                 min_loss_scale=MIN_SCALE, max_loss_scale=MAX_SCALE,
                 device=None):
        if init_scale is not None:
            loss_scale = "dynamic" if loss_scale == "dynamic" else init_scale
        self.state = init_loss_scale(loss_scale, device=device)
        if init_scale is not None and self.state.dynamic:
            self.state = self.state.replace(loss_scale=torch.full_like(
                self.state.loss_scale, float(init_scale)))
        self._scale_factor = scale_factor
        self._scale_window = scale_window
        self._min_scale = MIN_SCALE if min_loss_scale is None \
            else float(min_loss_scale)
        self._max_scale = MAX_SCALE if max_loss_scale is None \
            else float(max_loss_scale)

    def loss_scale(self) -> float:
        return float(self.state.loss_scale)

    def scale_loss(self, loss):
        return scale_loss_value(loss, self.state)

    def unscale_(self, grads):
        out, self.state = unscale_grads(grads, self.state)
        return out

    def update_scale(self):
        self.state = update_scale(
            self.state, growth_factor=self._scale_factor,
            growth_interval=self._scale_window,
            min_scale=self._min_scale, max_scale=self._max_scale)

    @property
    def found_inf(self):
        return self.state.found_inf

    def state_dict(self) -> dict:
        return {"loss_scale": float(self.state.loss_scale),
                "unskipped": int(self.state.growth_tracker),
                "dynamic": self.state.dynamic}

    def load_state_dict(self, sd: dict) -> None:
        dev = self.state.loss_scale.device
        self.state = LossScaleState(
            loss_scale=torch.full((), float(sd["loss_scale"]),
                                  dtype=torch.float32, device=dev),
            growth_tracker=torch.full((), int(sd.get("unskipped", 0)),
                                      dtype=torch.int32, device=dev),
            found_inf=torch.zeros((), dtype=torch.float32, device=dev),
            dynamic=bool(sd.get("dynamic", True)))
