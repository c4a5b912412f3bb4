"""Standalone Megatron-style GPT of the port, at tp = 1, with context
and expert parallelism.

Port of ``apex_tpu/transformer/testing/standalone_gpt.py``:
:class:`GPTConfig` (with its ``ffn`` property), :class:`ParallelMLP`,
:class:`ParallelAttention`, :class:`ParallelTransformerLayer`,
:class:`GPTEmbedding`, :class:`GPTModel` and :func:`gpt_model_provider`
as ``nn.Module``s whose named parameters map one to one onto the flax
tree's key paths (``layer_0.self_attention.query_key_value.weight`` is
``layer_0/self_attention/query_key_value/weight``,
``embedding.position_embeddings`` the learned position table).  Same op
sequence: activations ``[s, b, h]``; a vocab-parallel word embedding
plus learned positions; pre-LN blocks on the fused LayerNorm (fp32
affine parameters whatever ``params_dtype``); the qkv projection
interleaved per head (``[q(d), k(d), v(d)]`` for each head); the flash
kernels with the optional boolean mask (True = masked); a GELU MLP in
the tanh approximation, as ``jax.nn.gelu`` computes it; a final
LayerNorm and logits tied to the word embedding; the tp = 1 cross
entropy over fp32 logits when labels are given.

Training mode (``deterministic=False``) applies the JAX module's
dropout: hidden dropout after the embedding, after attention and after
the MLP (``hidden_dropout``), and attention dropout on the
probabilities inside the flash kernels (``attention_dropout``), one
seed drawn for each layer and each call.  Randomness comes from the
``torch.Generator`` the caller passes (``generator=``, the counterpart
of flax's ``rngs={"dropout": key}``), which lives on the activations'
device: the hidden masks are ``torch.rand`` draws from it, and each
attention seed is an int32 drawn from it as a one-element tensor on
that device and handed to the kernels as their seed operand, so a
training step never syncs with the host for its randomness.  The
attention keep mask is the JAX package's bit for bit given the same
seed; the hidden masks cannot be (a ``torch.Generator`` does not draw
flax's bits), so they are the same distribution.

With labels and ``fused_head_xent`` > 0 (or ``APEX_TPU_XENT_CHUNK``) the
loss is the chunked fused head (:mod:`apex_tpu_torch.ops.fused_lm_xent`)
on the tied word embedding; otherwise ``ce_half_residuals`` keeps the
cross entropy's softmax residual in bf16.  ``remat`` recomputes each
layer in the backward (:func:`apex_tpu_torch.utils.remat`), replaying
the generators so the recompute draws the forward's masks and seeds.

``context_parallel`` (under a topology whose context group has cp > 1
ranks; one rank: the plain model): the tokens ``[b, s]`` are this
rank's shard of a ``cp * s`` sequence, positions start at ``rank * s``,
attention runs over the ring (:func:`apex_tpu_torch.ops.ring_attention`,
exact; a padding mask raises, as JAX's assert does).  The attention
seeds come from ``generator`` on every rank alike (the ring's dropout is
the dense run's only with one seed across the ranks); the hidden masks
from a stream with the context rank folded in (:func:`~apex_tpu_torch.
transformer.tensor_parallel.random.fold_generator`), so each rank's
shard draws its own, as JAX folds the rank into the key.
The loss is the rank's mean; the grads are reduced over the context
group with the data group's (``parallel_state.get_dense_param_grad_axes``).

``sequence_parallel``: the JAX regions, a scatter of the sequence after
the embedding and a gather before the final LayerNorm, over the tensor
axis; GPT and BERT refuse tp > 1 (ROADMAP queue 3, "tied heads at tp >
1"), so on a model both are the identity and the layers' sequence
parallelism (``tensor_parallel.layers``) runs at tp > 1 on its own.

``scan_layers``: the layers' parameters stacked along a leading
``[num_layers]`` dim under JAX's tree path ``layers.layer.<...>``
(``inference.weights.to_scan_layout`` moves a loop-layout tree there),
one layer body applied to each slice in turn
(``torch.func.functional_call``; with ``remat`` each step recomputed).
The layers draw their seeds and masks from the generators in layer
order, as the loop does: the same weights and generator give the loop's
loss (flax's ``split_rngs`` bits are not reproduced).

``num_moe_experts``: each layer's ``mlp`` is a
:class:`~apex_tpu_torch.transformer.moe.MoELayer` (children ``router``
and ``experts``, so the parameters are ``layer_<i>.mlp.router.weight``
and ``layer_<i>.mlp.experts.{w1,b1,w2,b2}``, JAX's tree paths) with
``moe_top_k``, ``moe_capacity_factor`` and ``moe_load_balancing_type``;
with ``expert_model_parallel`` its experts are sharded over the
topology's expert group (``ep = get_expert_model_parallel_world_size()``,
each rank holding ``num_moe_experts / ep``).  The router's aux losses
are what JAX sows into ``"intermediates"``: pass ``intermediates={}`` to
:meth:`GPTModel.forward` and it is filled with each layer's
``layer_<i>.moe_lb_loss`` and ``layer_<i>.moe_z_loss`` (scalars), or
under ``scan_layers`` ``layers.layer.moe_lb_loss`` and
``layers.layer.moe_z_loss`` stacked ``[num_layers]`` (JAX's paths, its
one-element tuples unwrapped).  They are differentiable: the caller
scales them and adds them to the loss; a layer under ``remat`` hands
back the forward's values once (the recompute's are discarded).  The
grads of an expert-parallel model are reduced with
:func:`~apex_tpu_torch.transformer.moe.reduce_moe_grads`.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch import nn

from apex_tpu_torch.normalization import FusedLayerNorm
from apex_tpu_torch.ops.attention import flash_attention
from apex_tpu_torch.ops.fused_lm_xent import (fused_lm_head_cross_entropy,
                                              xent_chunk_default)
from apex_tpu_torch.ops.ring_attention import ring_attention
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer.tensor_parallel import (
    ColumnParallelLinear,
    RowParallelLinear,
    VocabParallelEmbedding,
    mappings,
    vocab_parallel_cross_entropy,
)
from apex_tpu_torch.transformer.tensor_parallel.random import fold_generator
from apex_tpu_torch.utils import remat, resolve_device

__all__ = ["GPTConfig", "ParallelMLP", "ParallelAttention",
           "ParallelTransformerLayer", "GPTEmbedding", "GPTModel",
           "gpt_model_provider", "model_device", "hidden_dropout"]

_MULTI = "ROADMAP queue 1, item 6 (multi-GPU layers over NCCL)"


@dataclasses.dataclass(frozen=True)
class GPTConfig:
    """Megatron-style hyperparameters, the JAX package's defaults.
    GPT-3 1.3B: hidden 2048, 24 layers, 16 heads, max_seq 2048, vocab
    51200."""
    vocab_size: int = 51200
    hidden_size: int = 1024
    ffn_hidden_size: Optional[int] = None      # default 4*hidden
    num_layers: int = 12
    num_attention_heads: int = 16
    max_seq_length: int = 1024
    hidden_dropout: float = 0.1
    attention_dropout: float = 0.1
    params_dtype: Any = torch.float32
    sequence_parallel: bool = False
    context_parallel: bool = False
    remat: bool = False
    scan_layers: bool = False
    embedding_grad_via_matmul: bool = False
    ce_half_residuals: bool = False
    # chunked fused LM head + cross entropy: the token chunk; None reads
    # APEX_TPU_XENT_CHUNK (default 0, the unfused head)
    fused_head_xent: Optional[int] = None
    num_moe_experts: Optional[int] = None
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_load_balancing_type: str = "aux_loss"
    expert_model_parallel: bool = False

    @property
    def ffn(self) -> int:
        return self.ffn_hidden_size or 4 * self.hidden_size


def _tp() -> int:
    if parallel_state.model_parallel_is_initialized():
        return parallel_state.get_tensor_model_parallel_world_size()
    return 1


def _cp() -> int:
    if parallel_state.model_parallel_is_initialized():
        return parallel_state.get_context_parallel_world_size()
    return 1


def _context_parallel(cfg) -> bool:
    """Whether the sequence is sharded over a context group of cp > 1."""
    return bool(getattr(cfg, "context_parallel", False)) and _cp() > 1


def _sequence_region(h, cfg, region):
    """``region`` (a sequence-parallel mapping over the tensor axis)
    under ``sequence_parallel`` at tp > 1; the identity at tp = 1, as
    JAX's regions are on an axis of one rank."""
    if getattr(cfg, "sequence_parallel", False) and _tp() > 1:
        return region(h)
    return h


def model_device(device) -> torch.device:
    """The device a standalone model is built on: CUDA unless ``"cpu"``
    is asked for, or ``"meta"`` for a model with no storage, whose
    forward is then run over a parameter tree with
    ``torch.func.functional_call`` (the serving engines do)."""
    if device is not None and torch.device(device).type == "meta":
        return torch.device("meta")
    return resolve_device(device)


def _need_generator(generator):
    if generator is None:
        raise ValueError(
            "dropout in training mode (deterministic=False) needs "
            "generator=, a torch.Generator on the activations' device (the "
            "counterpart of flax's rngs={'dropout': key})")
    return generator


def hidden_dropout(x, rate: float, deterministic: bool, generator=None):
    """flax ``nn.Dropout``: in training mode with ``rate > 0``, each
    element kept with probability ``1 - rate`` (a ``torch.rand`` draw
    from ``generator``) and scaled by ``1 / (1 - rate)``; else ``x``."""
    if deterministic or rate <= 0.0:
        return x
    u = torch.rand(x.shape, generator=_need_generator(generator),
                   device=x.device)
    return torch.where(u < 1.0 - rate, x / (1.0 - rate),
                       torch.zeros_like(x))


def attention_seed(generator, device):
    """One attention-dropout seed: an int32 drawn from ``generator`` as a
    one-element tensor on ``device`` (no host sync), the counterpart of
    ``jax.random.bits(make_rng("dropout"))``."""
    return torch.randint(-2 ** 31, 2 ** 31, (1,),
                         generator=_need_generator(generator), device=device,
                         dtype=torch.int32)


def gelu(x):
    """``jax.nn.gelu``: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


class ParallelMLP(nn.Module):
    """h -> 4h (column) -> gelu -> h (row)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        kw = dict(params_dtype=cfg.params_dtype, device=device)
        self.dense_h_to_4h = ColumnParallelLinear(
            cfg.hidden_size, cfg.ffn, gather_output=False, **kw)
        self.dense_4h_to_h = RowParallelLinear(
            cfg.ffn, cfg.hidden_size, input_is_parallel=True, **kw)

    def forward(self, x, deterministic: bool = True, generator=None):
        h, _ = self.dense_h_to_4h(x)
        out, _ = self.dense_4h_to_h(gelu(h))
        return out


class ParallelAttention(nn.Module):
    """Self-attention: the interleaved qkv projection, the flash
    kernels (causal or not, with the optional boolean mask, and in
    training mode attention dropout from one seed drawn from
    ``generator`` a call; under context parallelism ring attention over
    the context group, the seed the same on every rank), the output
    projection."""

    def __init__(self, cfg: GPTConfig, causal: bool = True, device=None):
        super().__init__()
        self.cfg, self.causal = cfg, causal
        kw = dict(params_dtype=cfg.params_dtype, device=device)
        self.query_key_value = ColumnParallelLinear(
            cfg.hidden_size, 3 * cfg.hidden_size, gather_output=False, **kw)
        self.dense = RowParallelLinear(
            cfg.hidden_size, cfg.hidden_size, input_is_parallel=True, **kw)

    def forward(self, x, attention_mask=None, deterministic: bool = True,
                generator=None):
        cfg = self.cfg
        s, b = x.shape[0], x.shape[1]
        heads = cfg.num_attention_heads
        head_dim = cfg.hidden_size // heads
        qkv, _ = self.query_key_value(x)
        qkv = qkv.reshape(s, b, heads, 3 * head_dim)
        q, k, v = torch.split(qkv, head_dim, dim=-1)
        # [s, b, n, d] -> [b, n, s, d]
        q, k, v = (t.permute(1, 2, 0, 3) for t in (q, k, v))
        rate = (cfg.attention_dropout
                if not deterministic and cfg.attention_dropout > 0.0 else 0.0)
        seed = attention_seed(generator, x.device) if rate else None
        if _context_parallel(cfg):
            # the sequence sharded over the context group: exact
            # attention over the K/V ring, dropout at global coordinates
            if attention_mask is not None:
                raise AssertionError(
                    "context_parallel supports causal masking only")
            ctx = ring_attention(q, k, v, causal=self.causal,
                                 dropout_rate=rate, dropout_seed=seed)
        else:
            ctx = flash_attention(q, k, v, causal=self.causal,
                                  mask=attention_mask, dropout_rate=rate,
                                  dropout_seed=seed)
        ctx = ctx.permute(2, 0, 1, 3).reshape(s, b, -1)
        out, _ = self.dense(ctx)
        return out


def _ep() -> int:
    if parallel_state.model_parallel_is_initialized():
        return parallel_state.get_expert_model_parallel_world_size()
    return 1


def _moe_layer(cfg, device):
    """The MoE FFN of a layer (``cfg.num_moe_experts`` set)."""
    from apex_tpu_torch.transformer.moe import MoELayer
    return MoELayer(
        num_experts=cfg.num_moe_experts, hidden_size=cfg.hidden_size,
        ffn_hidden_size=cfg.ffn, top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor,
        expert_parallel_size=_ep() if cfg.expert_model_parallel else 1,
        tensor_parallel_size=_tp(),
        sequence_parallel=cfg.sequence_parallel and _tp() > 1,
        load_balancing_type=cfg.moe_load_balancing_type,
        params_dtype=cfg.params_dtype, device=device)


class ParallelTransformerLayer(nn.Module):
    """Pre-LN transformer block; its ``mlp`` a :class:`ParallelMLP`, or
    with ``num_moe_experts`` an ``MoELayer`` (``moe``)."""

    def __init__(self, cfg: GPTConfig, causal: bool = True, device=None):
        super().__init__()
        self.cfg = cfg
        self.moe = bool(getattr(cfg, "num_moe_experts", None))
        self.input_layernorm = FusedLayerNorm(cfg.hidden_size, device=device)
        self.self_attention = ParallelAttention(cfg, causal=causal,
                                                device=device)
        self.post_attention_layernorm = FusedLayerNorm(cfg.hidden_size,
                                                       device=device)
        self.mlp = (_moe_layer(cfg, device) if self.moe
                    else ParallelMLP(cfg, device=device))

    def forward(self, x, attention_mask=None, deterministic: bool = True,
                generator=None, hidden_generator=None, intermediates=None):
        """``hidden_generator`` draws the hidden masks (default
        ``generator``, which draws the attention seed).  With an MoE FFN
        its aux losses go into ``intermediates`` (a dict, where given)
        as ``moe_lb_loss`` and ``moe_z_loss``."""
        rate = self.cfg.hidden_dropout
        hgen = generator if hidden_generator is None else hidden_generator
        h = self.self_attention(self.input_layernorm(x), attention_mask,
                                deterministic, generator)
        x = x + hidden_dropout(h, rate, deterministic, hgen)
        h = self.post_attention_layernorm(x)
        if self.moe:
            h, aux = self.mlp(h, deterministic=deterministic)
            if intermediates is not None:
                intermediates["moe_lb_loss"] = aux["load_balancing_loss"]
                intermediates["moe_z_loss"] = aux["z_loss"]
        else:
            h = self.mlp(h, deterministic)
        return x + hidden_dropout(h, rate, deterministic, hgen)


class GPTEmbedding(nn.Module):
    """Vocab-parallel word embedding + learned positions; tokens ``[b,
    s]`` -> hidden ``[s, b, h]``.  Under context parallelism the tokens
    are rank r's shard and its positions start at ``r * s``."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        self.cfg = cfg
        self.word_embeddings = VocabParallelEmbedding(
            cfg.vocab_size, cfg.hidden_size, params_dtype=cfg.params_dtype,
            device=device)
        pos = torch.empty(cfg.max_seq_length, cfg.hidden_size,
                          dtype=cfg.params_dtype, device=device)
        with torch.no_grad():
            pos.normal_(0.0, 0.02)
        self.position_embeddings = nn.Parameter(pos)

    def forward(self, tokens, deterministic: bool = True, generator=None):
        cfg = self.cfg
        s = tokens.shape[1]
        off = 0
        if _context_parallel(cfg):
            off = parallel_state.get_context_parallel_rank() * s
            if _cp() * s > cfg.max_seq_length:
                raise ValueError(
                    f"sequence length {_cp()} x {s} exceeds "
                    f"max_seq_length {cfg.max_seq_length}")
        h = self.word_embeddings(tokens) + \
            self.position_embeddings[None, off:off + s]
        h = _sequence_region(h.transpose(0, 1), cfg,
                             mappings.scatter_to_sequence_parallel_region)
        return hidden_dropout(h, cfg.hidden_dropout, deterministic,
                              generator)                   # [s, b, h]


def _check_config(cfg) -> None:
    if parallel_state.model_parallel_is_initialized() and \
            parallel_state.get_tensor_model_parallel_world_size() > 1:
        raise NotImplementedError(
            "GPT and BERT at tensor_model_parallel_size "
            f"{parallel_state.get_tensor_model_parallel_world_size()} are "
            f"not ported ({_MULTI}): the JAX reference's tied raw-einsum "
            "head leaves each rank a rank-partial dhidden, so its grads at "
            "tp > 1 are not tp = 1's (ROADMAP queue 3, \"tied heads at "
            "tp > 1\")")


def _replayed(generator, hidden_generator):
    """The generators a recomputed layer replays (None: none)."""
    gens = [g for g in (generator, hidden_generator) if g is not None]
    if len(gens) == 2 and gens[0] is gens[1]:
        gens = gens[:1]
    return gens or None


_AUX = ("moe_lb_loss", "moe_z_loss")


def _layer_step(layer, h, attention_mask, deterministic: bool, generator,
                hidden_generator=None):
    """One layer's output, and with an MoE FFN its two aux losses: ``h``
    or ``(h, moe_lb_loss, moe_z_loss)``, all outputs of the call (so that
    a recompute hands back nothing twice)."""
    if not getattr(layer, "moe", False):
        return layer(h, attention_mask, deterministic, generator,
                     hidden_generator)
    aux = {}
    h = layer(h, attention_mask, deterministic, generator, hidden_generator,
              intermediates=aux)
    return (h, *(aux[k] for k in _AUX))


def _run_layers(layers, h, attention_mask, deterministic: bool,
                generator, recompute: bool, hidden_generator=None,
                intermediates=None, names=None):
    """``h`` through each layer in turn; with ``recompute`` each layer
    under :func:`apex_tpu_torch.utils.remat` (the generators
    replayed).  An MoE layer's aux losses go into ``intermediates`` (a
    dict, where given) under ``<name>.moe_lb_loss`` and
    ``<name>.moe_z_loss``, ``names`` the layers' names."""
    for i, layer in enumerate(layers):
        args = (layer, h, attention_mask, deterministic, generator,
                hidden_generator)
        if recompute:
            out = remat(_layer_step, *args,
                        generator=_replayed(generator, hidden_generator))
        else:
            out = _layer_step(*args)
        if isinstance(out, tuple):
            h = out[0]
            if intermediates is not None:
                for key, v in zip(_AUX, out[1:]):
                    intermediates[f"{names[i]}.{key}"] = v
        else:
            h = out
    return h


class _ScanLayers(nn.Module):
    """``num_layers`` layers as one body over stacked parameters: each
    parameter of ``layer`` is ``[num_layers, ...]`` (JAX's ``nn.scan``
    tree, ``layers/layer/...``), and step ``i`` runs ``layer`` on the
    ``i``-th slices (``torch.func.functional_call``).  The layers are
    built one by one and stacked, so one seed gives the loop layout's
    initial weights."""

    def __init__(self, cfg: GPTConfig, causal: bool = True, device=None):
        super().__init__()
        self.num_layers = cfg.num_layers
        built = [ParallelTransformerLayer(cfg, causal=causal, device=device)
                 for _ in range(cfg.num_layers)]
        self.layer = built[0]
        for name in [n for n, _ in self.layer.named_parameters()]:
            stacked = torch.stack([b.get_parameter(name).detach()
                                   for b in built])
            owner, _, leaf = name.rpartition(".")
            setattr(self.layer.get_submodule(owner), leaf,
                    nn.Parameter(stacked))
        del built

    def forward(self, h, attention_mask, deterministic: bool, generator,
                recompute: bool, hidden_generator=None, intermediates=None):
        """``h`` through the layers; an MoE layer's aux losses go into
        ``intermediates`` (where given) as ``layers.layer.moe_lb_loss``
        and ``layers.layer.moe_z_loss``, stacked ``[num_layers]``."""
        # one unbind a forward: its backward is one stack, where a select
        # a layer would add num_layers zero-filled full-stack grads
        slices = {n: p.unbind(0) for n, p in self.layer.named_parameters()}

        def step(i, h):
            params = {n: s[i] for n, s in slices.items()}
            aux = {}
            h = torch.func.functional_call(
                self.layer, params, (h, attention_mask, deterministic,
                                     generator, hidden_generator),
                {"intermediates": aux} if self.layer.moe else {})
            return (h, *(aux[k] for k in _AUX)) if aux else h

        aux = []
        for i in range(self.num_layers):
            if recompute:
                out = remat(step, i, h,
                            generator=_replayed(generator, hidden_generator))
            else:
                out = step(i, h)
            if isinstance(out, tuple):
                h = out[0]
                aux.append(out[1:])
            else:
                h = out
        if aux and intermediates is not None:
            for key, vals in zip(_AUX, zip(*aux)):
                intermediates[f"layers.layer.{key}"] = torch.stack(vals)
        return h


class GPTModel(nn.Module):
    """embedding -> N layers -> final LayerNorm -> logits tied to the
    word embedding ``[s, b, vocab]``, or the mean cross entropy with
    ``labels [b, s]``.  Built on CUDA unless ``device="cpu"`` (or
    ``"meta"``, see :func:`model_device`).  ``deterministic=False``
    with ``generator=`` is training mode (the module docstring).  The
    layers are ``layer_<i>``, or with ``scan_layers`` one stacked
    ``layers`` (:class:`_ScanLayers`)."""

    def __init__(self, cfg: GPTConfig, device=None):
        super().__init__()
        device = model_device(device)
        _check_config(cfg)
        self.cfg = cfg
        self.embedding = GPTEmbedding(cfg, device=device)
        if cfg.scan_layers:
            self.layers = _ScanLayers(cfg, device=device)
        else:
            for i in range(cfg.num_layers):
                setattr(self, f"layer_{i}",
                        ParallelTransformerLayer(cfg, device=device))
        self.final_layernorm = FusedLayerNorm(cfg.hidden_size, device=device)

    def forward(self, tokens, labels=None, attention_mask=None,
                deterministic: bool = True, generator=None,
                intermediates=None):
        """``intermediates``: a dict that an MoE model fills with its aux
        losses (the module docstring; flax's ``mutable=["intermediates"]``)."""
        cfg = self.cfg
        if tokens.shape[1] > cfg.max_seq_length:
            raise ValueError(
                f"sequence length {tokens.shape[1]} exceeds "
                f"max_seq_length {cfg.max_seq_length}")
        hgen = generator
        if not deterministic and cfg.hidden_dropout > 0.0 \
                and _context_parallel(cfg):
            # each context rank's shard draws its own hidden masks
            hgen = fold_generator(_need_generator(generator),
                                  parallel_state.get_context_parallel_rank())
        h = self.embedding(tokens, deterministic, hgen)
        if cfg.scan_layers:
            h = self.layers(h, attention_mask, deterministic, generator,
                            cfg.remat, hgen, intermediates)
        else:
            names = [f"layer_{i}" for i in range(cfg.num_layers)]
            h = _run_layers([getattr(self, n) for n in names], h,
                            attention_mask, deterministic, generator,
                            cfg.remat, hgen, intermediates, names)
        h = _sequence_region(h, cfg, lambda t: (
            mappings.gather_from_sequence_parallel_region(
                t, tensor_parallel_output_grad=False)))
        h = self.final_layernorm(h)
        emb = self.embedding.word_embeddings.weight
        if labels is None:
            return torch.einsum("sbh,vh->sbv", h, emb)
        chunk = cfg.fused_head_xent
        if chunk is None:
            chunk = xent_chunk_default()
        if chunk > 0:
            loss = fused_lm_head_cross_entropy(h, emb, labels.T,
                                               token_chunk=chunk)
            return loss.mean()
        logits = torch.einsum("sbh,vh->sbv", h, emb)
        loss = vocab_parallel_cross_entropy(
            logits.float(), labels.T, half_residuals=cfg.ce_half_residuals)
        return loss.mean()


def gpt_model_provider(cfg: GPTConfig = GPTConfig(),
                       device=None) -> GPTModel:
    return GPTModel(cfg, device=device)
