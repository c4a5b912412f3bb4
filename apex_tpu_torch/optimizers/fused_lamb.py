"""FusedLAMB — two-phase LAMB with per-tensor trust ratios.

Parity: ``apex/optimizers/fused_lamb.py :: FusedLAMB`` over
``amp_C.multi_tensor_l2norm`` + ``amp_C.multi_tensor_lamb``.  The math
lives in the functional core
(:func:`apex_tpu_torch.optimizers.functional.fused_lamb`): the grad norm
and the per-leaf weight and direction norms on the L2-norm kernel, the
moments and direction on the LAMB phase-1 kernel, the trust ratios
applied leaf by leaf in place.  This class is the stateful torch-parity
shell over it (see ``FusedOptimizerBase``).

Scope notes (shared by the torch-mode twin in ``_torch_mode.py``):

* the grad-norm clip is PER PARAM GROUP here (each group's flat buffer
  owns its norm); the twin clips by the GLOBAL norm across its groups,
  as the reference does — single-group construction, the common case,
  gives the same result on both;
* the trust ratio applies to every param with nonzero ``|w|``/``|u|``
  regardless of that group's weight-decay setting (and ``use_nvlamb``
  uses ``|w|/max(|u|, 1e-12)``) — the simplification the JAX package
  makes.
"""
from __future__ import annotations

from apex_tpu_torch.optimizers import functional
from apex_tpu_torch.ops.fused_update import _scalar
from apex_tpu_torch.optimizers.base import FusedOptimizerBase

__all__ = ["FusedLAMB"]


def _lamb_step(p, m, v, g, step, lr, beta1, beta2, eps, weight_decay,
               max_grad_norm, noop_flag, grad_scale, *, bias_correction,
               offsets, sizes, use_nvlamb, grad_averaging=True):
    """Flat-args entry over the functional core: one LAMB update of the
    flat fp32 ``p``, ``m`` and ``v`` (updated IN PLACE and returned)
    with flat grads ``g``; ``step`` is the update's 1-based step count.
    ``offsets`` is accepted for the JAX signature; ``sizes`` defines the
    leaves."""
    tx = functional._LambTx(
        bias_correction=bool(bias_correction), use_nvlamb=bool(use_nvlamb),
        grad_averaging=bool(grad_averaging))
    count = _scalar(step, p.device) - 1.0
    state = functional.FlatState(
        master=p, count=count, slots={"exp_avg": m, "exp_avg_sq": v},
        sizes=tuple(sizes))
    state = tx.update(state, g, noop_flag=noop_flag, grad_scale=grad_scale,
                      lr=lr, beta1=beta1, beta2=beta2, eps=eps,
                      weight_decay=weight_decay,
                      max_grad_norm=max_grad_norm)
    return state.master, state.slots["exp_avg"], state.slots["exp_avg_sq"]


class FusedLAMB(FusedOptimizerBase):
    #: nn.Parameters (reference BERT: ``FusedLAMB(model.parameters())``)
    #: route to the torch-mode twin — see ``_torch_mode.py``
    _TORCH_IMPL = "FusedLAMBTorch"

    def __init__(self, params, lr=1e-3, bias_correction=True,
                 betas=(0.9, 0.999), eps=1e-6, weight_decay=0.01,
                 amsgrad=False, adam_w_mode=True, grad_averaging=True,
                 set_grad_none=True, max_grad_norm=1.0, use_nvlamb=False):
        if amsgrad:
            raise RuntimeError("FusedLAMB does not support the AMSGrad "
                               "variant.")
        defaults = dict(lr=lr, bias_correction=bias_correction, betas=betas,
                        eps=eps, weight_decay=weight_decay,
                        max_grad_norm=max_grad_norm,
                        grad_averaging=grad_averaging)
        self.use_nvlamb = bool(use_nvlamb)
        super().__init__(params, defaults)

    def _make_tx(self, options):
        return functional.fused_lamb(
            lr=options["lr"], betas=options["betas"], eps=options["eps"],
            weight_decay=options["weight_decay"],
            max_grad_norm=options["max_grad_norm"],
            bias_correction=bool(options["bias_correction"]),
            grad_averaging=bool(options.get("grad_averaging", True)),
            use_nvlamb=self.use_nvlamb)

    def _traced_hyper(self, options, device):
        beta1, beta2 = options["betas"]
        return {"lr": _scalar(options["lr"], device),
                "beta1": _scalar(beta1, device),
                "beta2": _scalar(beta2, device),
                "eps": _scalar(options["eps"], device),
                "weight_decay": _scalar(options["weight_decay"], device),
                "max_grad_norm": _scalar(options["max_grad_norm"] or 0.0,
                                      device)}
