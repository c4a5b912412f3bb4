"""Tensor-parallel training on the port against the JAX package (CPU).

The port's counterparts of ``tests/L0/run_transformer/
test_{mapping,layers,cross_entropy,random,data,memory}.py``,
``test_llama_minimal.py``'s tp > 1 cases and
``test_fused_lm_xent.py``'s vocab-parallel head.  The JAX side runs in
this process under ``jax.shard_map`` on the 8 host devices that
``tests/conftest.py`` pins (a mesh of the first tp of them); the port's
ranks run one process a rank, spawned over gloo with ``device="cpu"``
(:func:`apex_tpu_torch.transformer.testing.distributed_test_base.spawn_ranks`).
One spawn of 4 ranks runs every rank-side case (the ``port_runs``
fixture): first at tp = 4, then with the topology rebuilt at tp = 2 x dp
= 2.  The spawned ranks import this module, torch and the port only:
every JAX import sits inside a JAX-side helper.  Both sides take the
same seeded numpy inputs and weights.

Tolerances (fp32 unless stated): the mappings, layers, cross entropies
and the model's loss and grads within 1e-5 relative of their largest
magnitude (the gloo sums and XLA's are both fp32, in other orders); the
bf16 softmax residual's grads (``half_residuals``) within 2^-8 of
theirs (one bf16 ulp of a rounding an fp32 ulp can flip); ``ring_psum``
equal to the fused all-reduce bit for bit at n = 2 and within 4 fp32
ulps of its magnitude at n = 4; the ring row-parallel matmul's
backward equal bit for bit to the unchunked layer's and its forward
within 1e-6 relative; three Adam steps' masters as
``tests/test_torch_training.py`` holds them (within 2 lr steps
everywhere and 1e-5 on all but 0.1% of the elements), their losses
within 1e-5 relative.
"""
import functools

import numpy as np
import pytest
import torch

from apex_tpu_torch.inference.weights import (llama_param_shapes,
                                              load_jax_params,
                                              shard_llama_params)
from apex_tpu_torch.transformer import parallel_state
from apex_tpu_torch.transformer import tensor_parallel as ttp
from apex_tpu_torch.transformer.tensor_parallel import mappings as tmap
from apex_tpu_torch.transformer.testing import (LlamaConfig,
                                                llama_model_provider)
from apex_tpu_torch.transformer.testing.distributed_test_base import \
    spawn_ranks

from _torch_isolation import restore_torch_from_amp  # noqa: F401

TOL = 1e-5
TOL_HALF = 2.0 ** -8
LR, STEPS = 1e-3, 3
#: the mappings: name -> (port op, out shape from in shape at tp n)
X_SHAPE = (8, 3, 8)
MAPPINGS = {
    "copy_to": lambda s, n: s,
    "reduce_from": lambda s, n: s,
    "scatter_to": lambda s, n: s[:-1] + (s[-1] // n,),
    "gather_from": lambda s, n: s[:-1] + (s[-1] * n,),
    "scatter_to_sequence": lambda s, n: (s[0] // n,) + s[1:],
    "gather_from_sequence": lambda s, n: (s[0] * n,) + s[1:],
    "gather_from_sequence_split": lambda s, n: (s[0] * n,) + s[1:],
    "reduce_scatter_to_sequence": lambda s, n: (s[0] // n,) + s[1:],
}
#: the small LLaMA: 2 layers, hidden 32, 4 heads, vocab 96, fp32
LLAMA = dict(vocab_size=96, hidden_size=32, num_layers=2,
             num_attention_heads=4, max_seq_length=16)
BATCH, SEQ = 2, 16
#: the replicated-kv cases: (tp, kv heads)
REPLICATED = ((2, 1), (4, 2))
#: the cross entropies' cases: (smoothing, half_residuals)
CE_CASES = ((0.0, False), (0.1, False), (0.0, True), (0.1, True))


def _port_op(name):
    return {
        "copy_to": tmap.copy_to_tensor_model_parallel_region,
        "reduce_from": tmap.reduce_from_tensor_model_parallel_region,
        "scatter_to": tmap.scatter_to_tensor_model_parallel_region,
        "gather_from": tmap.gather_from_tensor_model_parallel_region,
        "scatter_to_sequence": tmap.scatter_to_sequence_parallel_region,
        "gather_from_sequence": tmap.gather_from_sequence_parallel_region,
        "gather_from_sequence_split": functools.partial(
            tmap.gather_from_sequence_parallel_region,
            tensor_parallel_output_grad=False),
        "reduce_scatter_to_sequence":
            tmap.reduce_scatter_to_sequence_parallel_region,
    }[name]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    """A numpy copy (an fp32 CPU tensor's ``.numpy()`` shares its
    storage, which a step updates in place)."""
    return np.array(t.detach().float().cpu())


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


# -- inputs ----------------------------------------------------------------

def _mapping_inputs(n):
    rng = np.random.RandomState(10 + n)
    xs = rng.randn(n, *X_SHAPE).astype(np.float32)
    gs = {name: rng.randn(n, *fn(X_SHAPE, n)).astype(np.float32)
          for name, fn in MAPPINGS.items()}
    return dict(xs=xs, gs=gs)


def _ce_inputs(n, seed=20):
    rng = np.random.RandomState(seed + n)
    vocab = 8 * n
    logits = rng.randn(4, 5, vocab).astype(np.float32) * 2
    target = rng.randint(0, vocab, (4, 5)).astype(np.int64)
    g = rng.rand(4, 5).astype(np.float32)
    hidden = rng.randn(10, 6).astype(np.float32)
    head = rng.randn(vocab, 6).astype(np.float32) * 0.5
    labels = rng.randint(0, vocab, (10,)).astype(np.int64)
    labels[[2, 7]] = -100
    dloss = rng.rand(10).astype(np.float32)
    return dict(logits=logits, target=target, g=g, hidden=hidden, head=head,
                labels=labels, dloss=dloss)


def _layer_inputs():
    rng = np.random.RandomState(30)
    return dict(x=rng.randn(4, 3, 8).astype(np.float32),
                xp=rng.randn(2, 4, 3, 4).astype(np.float32),
                wc=rng.randn(12, 8).astype(np.float32) * 0.3,
                bc=rng.randn(12).astype(np.float32),
                wr=rng.randn(6, 8).astype(np.float32) * 0.3,
                br=rng.randn(6).astype(np.float32),
                gc=rng.randn(4, 3, 12).astype(np.float32),
                gcp=rng.randn(2, 4, 3, 6).astype(np.float32),
                gr=rng.randn(4, 3, 6).astype(np.float32),
                emb=rng.randn(16, 6).astype(np.float32),
                ids=rng.randint(0, 16, (3, 5)).astype(np.int64),
                gemb=rng.randn(3, 5, 6).astype(np.float32))


def _llama_tree(kvh):
    """A seeded numpy LLaMA tree at tp = 1: linears N(0, 1/fan_in),
    norms 1 + N(0, 0.1^2), the embedding N(0, 1)."""
    shapes = llama_param_shapes(LlamaConfig(**LLAMA, num_kv_heads=kvh))
    rng = np.random.RandomState(40 + kvh)
    tree: dict = {}
    for path, shape in sorted(shapes.items()):
        t = rng.randn(*shape)
        if len(shape) == 1:
            t = 1 + 0.1 * t
        elif path[0] != "embed_tokens":
            t = t / np.sqrt(shape[1])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.astype(np.float32)
    return tree


def _llama_batch(seed=50, rows=BATCH):
    rng = np.random.RandomState(seed)
    t = rng.randint(0, LLAMA["vocab_size"], (STEPS, rows, SEQ + 1))
    return dict(tokens=t[..., :-1].astype(np.int32),
                labels=t[..., 1:].astype(np.int32))


# -- the port side (spawned ranks) -----------------------------------------

def _mappings_port(inp, rank):
    n = tmap.axis_size()
    out = {}
    for name in MAPPINGS:
        x = _t(inp["xs"][rank]).requires_grad_()
        y = _port_op(name)(x)
        y.backward(_t(inp["gs"][name][rank]))
        out[name] = (_np(y), _np(x.grad))
    # the ring against the fused all-reduce, at 1 and 2 chunk groups
    x = _t(inp["xs"][rank])
    fused = tmap.ring_psum(x, "tensor", 1)          # the fused all-reduce
    out["ring"] = {c: (tmap.ring_psum(x, "tensor", c), fused)
                   for c in (n, 2 * n)}
    return out


def _ring_row_port(rank, n):
    """RowParallelLinear with ``overlap_chunks`` 2n against 1, fp32 and
    with the fp32-wgrad fusion on bf16 activations."""
    out = {}
    gen = torch.Generator().manual_seed(60 + rank)
    for fusion in (False, True):
        x = torch.randn(4 * n, 2, 6, generator=gen)
        dy = torch.randn(4 * n, 2, 5, generator=gen)
        w = torch.randn(5, 6, generator=gen)
        if fusion:
            x, dy = x.to(torch.bfloat16), dy.to(torch.bfloat16)
        res = {}
        for chunks in (1, 2 * n):
            layer = ttp.RowParallelLinear(
                6 * n, 5, bias=False, input_is_parallel=True, device="cpu",
                gradient_accumulation_fusion=fusion, overlap_chunks=chunks)
            with torch.no_grad():
                layer.weight.copy_(w)
            xi = x.clone().requires_grad_()
            y, _ = layer(xi)
            y.backward(dy)
            res[chunks] = (y.detach(), xi.grad, layer.weight.grad)
        out[fusion] = res
    return out


def _ce_port(inp, rank, n):
    vp = inp["logits"].shape[-1] // n
    sl = slice(rank * vp, (rank + 1) * vp)
    out = {}
    for smoothing, half in CE_CASES:
        x = _t(inp["logits"][..., sl]).requires_grad_()
        loss = ttp.vocab_parallel_cross_entropy(
            x, _t(inp["target"]), smoothing, half_residuals=half)
        loss.backward(_t(inp["g"]))
        out["ce", smoothing, half] = (_np(loss), _np(x.grad))
    from apex_tpu_torch.ops.fused_lm_xent import (
        fused_lm_head_vocab_parallel_cross_entropy as fused)
    for smoothing in (0.0, 0.1):
        for psum in (False, True):
            h = _t(inp["hidden"]).requires_grad_()
            w = _t(inp["head"][sl]).requires_grad_()
            loss = fused(h, w, _t(inp["labels"]), smoothing=smoothing,
                         token_chunk=4, grad_input_psum=psum)
            loss.backward(_t(inp["dloss"]))
            out["fused", smoothing, psum] = (_np(loss), _np(h.grad),
                                             _np(w.grad))
    return out


def _layers_port(inp, rank):
    """ColumnParallelLinear, RowParallelLinear and VocabParallelEmbedding
    at tp = 2 on the JAX layers' weights: output, input and weight
    grads of ``sum(out * g)``."""
    out = {}
    for bias, gather, skip in ((True, True, False), (True, False, True),
                               (False, False, False)):
        layer = ttp.ColumnParallelLinear(8, 12, bias=bias,
                                         gather_output=gather,
                                         skip_bias_add=skip, device="cpu")
        with torch.no_grad():
            layer.weight.copy_(_t(inp["wc"][rank * 6:(rank + 1) * 6]))
            if bias:
                layer.bias.copy_(_t(inp["bc"][rank * 6:(rank + 1) * 6]))
        x = _t(inp["x"]).requires_grad_()
        y, ob = layer(x)
        g = inp["gc"] if gather else inp["gcp"][rank]
        loss = (y * _t(g)).sum() + (ob.sum() if ob is not None else 0)
        loss.backward()
        out["col", bias, gather, skip] = (
            _np(y), _np(x.grad), _np(layer.weight.grad),
            None if layer.bias is None else _np(layer.bias.grad))
    for parallel, skip, chunks in ((False, False, 1), (True, True, 1),
                                   (True, False, 2)):
        layer = ttp.RowParallelLinear(8, 6, bias=True,
                                      input_is_parallel=parallel,
                                      skip_bias_add=skip, device="cpu",
                                      overlap_chunks=chunks)
        with torch.no_grad():
            layer.weight.copy_(_t(inp["wr"][:, rank * 4:(rank + 1) * 4]))
            layer.bias.copy_(_t(inp["br"]))
        x = _t(inp["xp"][rank] if parallel else inp["x"]).requires_grad_()
        y, ob = layer(x)
        loss = (y * _t(inp["gr"])).sum() + (ob.sum() if ob is not None
                                            else 0)
        loss.backward()
        out["row", parallel, skip, chunks] = (
            _np(y), _np(x.grad), _np(layer.weight.grad),
            _np(layer.bias.grad))
    # the fp32-wgrad fusion: fp32 master weights, bf16 activations
    for kind in ("col", "row"):
        if kind == "col":
            layer = ttp.ColumnParallelLinear(8, 12, bias=False,
                                             gather_output=False,
                                             device="cpu",
                                             gradient_accumulation_fusion=True)
            w = inp["wc"][rank * 6:(rank + 1) * 6]
            x, g = inp["x"], inp["gcp"][rank]
        else:
            layer = ttp.RowParallelLinear(8, 6, bias=False,
                                          input_is_parallel=True,
                                          device="cpu",
                                          gradient_accumulation_fusion=True)
            w = inp["wr"][:, rank * 4:(rank + 1) * 4]
            x, g = inp["xp"][rank], inp["gr"]
        with torch.no_grad():
            layer.weight.copy_(_t(w))
        xb = _t(x).to(torch.bfloat16).requires_grad_()
        y, _ = layer(xb)
        y.backward(_t(g).to(torch.bfloat16))
        out["fusion", kind] = (_np(y), _np(xb.grad), _np(layer.weight.grad),
                               layer.weight.grad.dtype)
    for via in (False, True):
        emb = ttp.VocabParallelEmbedding(16, 6, device="cpu",
                                         grad_via_matmul=via)
        with torch.no_grad():
            emb.weight.copy_(_t(inp["emb"][rank * 8:(rank + 1) * 8]))
        y = emb(_t(inp["ids"]))
        (y * _t(inp["gemb"])).sum().backward()
        out["emb", via] = (_np(y), _np(emb.weight.grad))
    return out


def _llama_port(rank, n, kvh, tree, batch, fused=0, reduce=True):
    """The port's LLaMA at tp = n on rank ``rank``'s shard: the loss and
    each parameter's grad (``reduce_llama_grads`` applied, with
    ``reduce``) on the first batch."""
    from apex_tpu_torch.transformer.testing.standalone_llama import \
        reduce_llama_grads
    cfg = LlamaConfig(**LLAMA, num_kv_heads=kvh, fused_head_xent=fused)
    model = llama_model_provider(cfg, device="cpu")
    load_jax_params(model, shard_llama_params(tree, cfg, n, rank))
    loss = model(_t(batch["tokens"][0]), _t(batch["labels"][0]))
    loss.backward()
    grads: dict = {}
    for name, p in model.named_parameters():
        node = grads
        keys = name.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = p.grad
    if reduce:
        grads = reduce_llama_grads(grads, cfg)
    flat = {name: _np(p.grad) for name, p in model.named_parameters()}
    return float(loss), flat


def _kv_drift_port(rank, n, kvh, tree, batch):
    """Three SGD steps on the rank's shard with and without
    ``reduce_llama_grads`` (flat grads through ``leaf_offsets``): the
    first layer's kv weights after them."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.transformer.testing.standalone_llama import \
        reduce_llama_grads
    cfg = LlamaConfig(**LLAMA, num_kv_heads=kvh)
    out = {}
    for reduce in (True, False):
        model = llama_model_provider(cfg, device="cpu")
        load_jax_params(model, shard_llama_params(tree, cfg, n, rank))
        offsets = train_step.leaf_offsets(model)
        params = [p for _, p in sorted(
            ((tuple(k.split(".")), p) for k, p in model.named_parameters()),
            key=lambda kv: kv[0])]
        for _ in range(3):
            model.zero_grad()
            model(_t(batch["tokens"][0]), _t(batch["labels"][0])).backward()
            flat = torch.cat([p.grad.reshape(-1) for p in params])
            if reduce:
                flat = reduce_llama_grads(flat, cfg, offsets=offsets)
            with torch.no_grad():
                off = 0
                for p in params:
                    p -= 3e-3 * flat[off:off + p.numel()].view_as(p)
                    off += p.numel()
        out[reduce] = _np(model.layer_0.attention.kv_proj.weight)
        # a flat length other than the layout's (a ZeRO shard), or flat
        # grads without offsets, raise
        out["refusals"] = []
        for args, kw in (((flat[:-1], cfg), dict(offsets=offsets)),
                         ((flat, cfg), {})):
            try:
                reduce_llama_grads(*args, **kw)
                out["refusals"].append(None)
            except ValueError as e:
                out["refusals"].append(str(e))
    return out


def _train_port(rank, n, tree, batch):
    """Three ``make_train_step`` Adam steps at tp = n (dynamic loss
    scale): the losses and the rank's master after each step."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import functional
    cfg = LlamaConfig(**LLAMA, num_kv_heads=2)
    model = llama_model_provider(cfg, device="cpu")
    load_jax_params(model, shard_llama_params(tree, cfg, n, rank))
    tx = functional.fused_adam(lr=LR)
    state = train_step.init_train_state(tx, model, loss_scale="dynamic")
    step = train_step.make_train_step(
        lambda m, b: m(b["tokens"], b["labels"]), tx)
    losses, masters = [], []
    for i in range(STEPS):
        state, loss = step(state, {"tokens": _t(batch["tokens"][i]),
                                   "labels": _t(batch["labels"][i])})
        losses.append(float(loss))
        masters.append(_np(state.opt.master))
    return dict(losses=losses, masters=masters)


def _tpdp_port(rank, tree, batch):
    """tp = 2 x dp = 2: the ZeRO step over the data group on this data
    rank's rows, three Adam steps; the losses and the tensor rank's
    params afterwards."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import functional
    cfg = LlamaConfig(**LLAMA, num_kv_heads=2)
    tr = parallel_state.get_tensor_model_parallel_rank()
    dr = parallel_state.get_data_parallel_rank()
    model = llama_model_provider(cfg, device="cpu")
    load_jax_params(model, shard_llama_params(tree, cfg, 2, tr))
    tx = functional.fused_adam(lr=LR)
    state = train_step.init_train_state(tx, model, loss_scale="dynamic",
                                        shard=("data", 2))
    step = train_step.make_train_step(
        lambda m, b: m(b["tokens"], b["labels"]), tx, zero=True)
    rows = slice(dr * BATCH, (dr + 1) * BATCH)
    losses = []
    for i in range(STEPS):
        state, loss = step(state, {"tokens": _t(batch["tokens"][i, rows]),
                                   "labels": _t(batch["labels"][i, rows])})
        losses.append(float(loss))
    params = state.params()
    flat = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (k,))
        else:
            flat[".".join(path)] = _np(node)
    walk(params, ())
    return dict(losses=losses, params=flat, tensor_rank=tr, data_rank=dr)


def _misc_port(rank, n):
    """``broadcast_data``, the RNG tracker's streams and a checkpointed
    dropout's replay, ``axis_name`` as a ``ProcessGroup``, and the GPT
    and BERT models' refusal at tp > 1."""
    from apex_tpu_torch.transformer.testing import (BertConfig, BertModel,
                                                    GPTConfig, GPTModel)
    tr = parallel_state.get_tensor_model_parallel_rank()
    data = {"a": np.full((2, 3), tr + 1), "b": np.arange(4) * (tr + 1)}
    got = ttp.broadcast_data(["a", "b"], data, torch.int64)
    out = {"bcast": {k: _np(v) for k, v in got.items()},
           "bcast_dtype": got["a"].dtype}
    ttp.model_parallel_seed(123, device="cpu")
    tracker = ttp.get_rng_tracker()
    with tracker.fork() as g:
        out["mp_draw"] = _np(torch.rand(64, generator=g))
    with tracker.fork("default") as g:
        out["default_draw"] = _np(torch.rand(64, generator=g))
    x = torch.randn(16, 8, generator=torch.Generator().manual_seed(5),
                    requires_grad=True)
    with tracker.fork() as g:
        masks = []

        def dropped(t):
            keep = torch.rand(t.shape, generator=g) >= 0.5
            masks.append(keep)
            return t * keep * 2.0

        y = ttp.checkpoint(dropped, False, x)
        y.sum().backward()
        after = torch.rand(4, generator=g)
    out["replay_equal"] = torch.equal(masks[0], masks[1])
    out["grad_is_mask"] = torch.equal(x.grad, masks[0].float() * 2.0)
    ttp.model_parallel_seed(123, device="cpu")
    with tracker.fork() as g:       # the draws above, without recompute
        torch.rand(64, generator=g)
        torch.rand(16, 8, generator=g)
        out["after_equal"] = torch.equal(torch.rand(4, generator=g), after)
    # a ProcessGroup as axis_name; and its size disagreeing
    group = parallel_state.get_tensor_model_parallel_group()
    layer = ttp.ColumnParallelLinear(4, 2 * n, axis_name=group,
                                     device="cpu", gather_output=True)
    out["group_shape"] = tuple(layer(torch.ones(3, 4))[0].shape)
    try:
        ttp.ColumnParallelLinear(4, 8, tensor_model_parallel_size=n + 1,
                                 device="cpu")
        out["mismatch"] = None
    except ValueError as e:
        out["mismatch"] = str(e)
    for name, build in (
            ("gpt", lambda: GPTModel(GPTConfig(
                vocab_size=64, hidden_size=32, num_layers=1,
                num_attention_heads=4, max_seq_length=16), device="cpu")),
            ("bert", lambda: BertModel(BertConfig(
                vocab_size=64, hidden_size=32, num_layers=1,
                num_attention_heads=4, max_seq_length=16), device="cpu"))):
        try:
            build()
            out[name] = None
        except NotImplementedError as e:
            out[name] = str(e)
    return out


def _tp_cases(rank, n, inp):
    tr = parallel_state.get_tensor_model_parallel_rank()
    out = {"mappings": _mappings_port(inp["mappings"], tr),
           "ring_row": _ring_row_port(tr, n),
           "ce": _ce_port(inp["ce"], tr, n),
           "misc": _misc_port(rank, n)}
    for tp, kvh in REPLICATED:
        if tp == n:
            tree = inp["trees"][kvh]
            out["replicated"] = {
                reduce: _llama_port(tr, n, kvh, tree, inp["batch"],
                                    reduce=reduce)
                for reduce in (True, False)}
            out["drift"] = _kv_drift_port(tr, n, kvh, tree, inp["batch"])
    if n == 2:
        out["layers"] = _layers_port(inp["layers"], tr)
        out["llama"] = {fused: _llama_port(tr, 2, 2, inp["trees"][2],
                                           inp["batch"], fused=fused)
                        for fused in (0, 8)}
        out["train"] = _train_port(tr, 2, inp["trees"][2], inp["batch"])
        out["tpdp"] = _tpdp_port(rank, inp["trees"][2], inp["tpdp_batch"])
    return out


def _rank_main(rank, inputs):
    out = {4: _tp_cases(rank, 4, inputs[4])}
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(2)
    out[2] = _tp_cases(rank, 2, inputs[2])
    return out


def _inputs():
    trees = {k: _llama_tree(k) for k in (1, 2)}
    common = dict(trees=trees, batch=_llama_batch())
    return {n: dict(common, mappings=_mapping_inputs(n), ce=_ce_inputs(n),
                    layers=_layer_inputs(),
                    tpdp_batch=_llama_batch(51, 2 * BATCH))
            for n in (2, 4)}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every rank-side case: ``[rank][tp] -> {case: result}`` (tp 4
    first, then tp 2 x dp 2; at tp 2 ranks 0 and 1 are data rank 0's
    tensor ranks)."""
    inputs = _inputs()
    return inputs, spawn_ranks(4, _rank_main, inputs,
                               tensor_model_parallel_size=4,
                               tmp_dir=str(tmp_path_factory.mktemp("tp")))


# -- the JAX side (JAX imported here only) -----------------------------------

def _jax_tp(n, fn, *stacked, replicated=()):
    """``fn`` on each of ``n`` tensor ranks under ``shard_map`` (JAX's
    topology at tp = n on the first n host devices): ``stacked`` arrays
    lead with the rank, ``replicated`` ones are every rank's; the
    outputs stacked by rank."""
    import jax
    from jax.sharding import PartitionSpec as P
    from apex_tpu.transformer import parallel_state as jps
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(n, devices=jax.devices()[:n])
    mesh = jps.get_mesh()

    def body(*args):
        local = [jax.tree.map(lambda x: x[0], a)
                 for a in args[:len(stacked)]] + list(args[len(stacked):])
        return jax.tree.map(lambda o: o[None], fn(*local))

    try:
        return jax.tree.map(np.asarray, jax.jit(functools.partial(
            jax.shard_map, check_vma=False)(
            body, mesh=mesh,
            in_specs=tuple([P("tensor")] * len(stacked)
                           + [P()] * len(replicated)),
            out_specs=P("tensor")))(*stacked, *replicated))
    finally:
        jps.destroy_model_parallel()


def _jax_op(name):
    from apex_tpu.transformer.tensor_parallel import mappings as jmap
    ops = {
        "copy_to": jmap.copy_to_tensor_model_parallel_region,
        "reduce_from": jmap.reduce_from_tensor_model_parallel_region,
        "scatter_to": jmap.scatter_to_tensor_model_parallel_region,
        "gather_from": jmap.gather_from_tensor_model_parallel_region,
        "scatter_to_sequence": jmap.scatter_to_sequence_parallel_region,
        "gather_from_sequence": jmap.gather_from_sequence_parallel_region,
        "gather_from_sequence_split": functools.partial(
            jmap.gather_from_sequence_parallel_region,
            tensor_parallel_output_grad=False),
        "reduce_scatter_to_sequence":
            jmap.reduce_scatter_to_sequence_parallel_region}
    return ops[name]


def _jax_vjp(f, primals, cotangent):
    import jax
    y, vjp = jax.vjp(f, *primals)
    return y, vjp(cotangent)


def _jax_shard_tree(tree, cfg_kw, n):
    """JAX's tp = n trees of ``tree`` stacked by rank (the port's
    ``shard_llama_params`` layouts; a replicated ``kv_proj`` as JAX's
    ``nn.Dense`` kernel ``[in, out]``)."""
    import jax
    cfg = LlamaConfig(**cfg_kw)
    shards = [shard_llama_params(tree, cfg, n, r) for r in range(n)]
    if cfg.kv_heads % n:
        for s in shards:
            for key, layer in s.items():
                if key.startswith("layer_"):
                    kv = layer["attention"]["kv_proj"]
                    kv["kernel"] = np.ascontiguousarray(kv.pop("weight").T)

    return jax.tree.map(lambda *leaves: np.stack(leaves), *shards)


_JAX_GRADS: dict = {}


def _jax_llama_grads(n, kvh, tree, batch, fused=0):
    """JAX's loss, grads and ``reduce_llama_grads``' grads at tp = n
    (stacked by rank) of the first batch, computed once a case."""
    key = (n, kvh, fused)
    if key in _JAX_GRADS:
        return _JAX_GRADS[key]
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.testing import LlamaConfig as JCfg
    from apex_tpu.transformer.testing import llama_model_provider as jllama
    from apex_tpu.transformer.testing.standalone_llama import \
        reduce_llama_grads as jreduce
    cfg_kw = dict(LLAMA, num_kv_heads=kvh, fused_head_xent=fused)
    jcfg = JCfg(**cfg_kw)
    model = jllama(jcfg)
    tokens, labels = (jnp.asarray(batch[k][0]) for k in ("tokens", "labels"))

    def fn(p, tokens, labels):
        loss, g = jax.value_and_grad(
            lambda q: model.apply({"params": q}, tokens, labels))(p)
        return loss, g, jreduce(g, jcfg)

    if n == 1:
        from apex_tpu.transformer import parallel_state as jps
        jps.destroy_model_parallel()
        jps.initialize_model_parallel(1, devices=jax.devices()[:1])
        try:
            out = jax.tree.map(np.asarray, jax.jit(fn)(tree, tokens, labels))
        finally:
            jps.destroy_model_parallel()
    else:
        out = _jax_tp(n, fn, _jax_shard_tree(tree, cfg_kw, n),
                      replicated=(tokens, labels))
    _JAX_GRADS[key] = out
    return out


def _leaf(tree, dotted):
    node = tree
    for k in dotted.split("."):
        node = node[k]
    return node


def _gather_dim(cfg, name, tp):
    """The dim rank shards of ``name`` are put together along (``None``:
    replicated), as ``shard_llama_params`` cut them."""
    probe = {}
    node = probe
    keys = name.split(".")
    for k in keys[:-1]:
        node = node.setdefault(k, {})
    shape = _leaf(llama_param_shapes_tree(cfg), name)
    node[keys[-1]] = np.zeros(shape, np.float32)
    cut = _leaf(shard_llama_params(probe, cfg, tp, 0), name)
    if cut.shape == shape:
        return None
    return 0 if cut.shape[0] != shape[0] else 1


def llama_param_shapes_tree(cfg):
    tree: dict = {}
    for path, shape in llama_param_shapes(cfg).items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = shape
    return tree


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("name", list(MAPPINGS))
@pytest.mark.parametrize("n", [2, 4])
def test_mappings_forward_and_backward_match_jax(port_runs, n, name):
    """Each mapping's forward and backward on every rank against JAX's
    custom-VJP op under ``shard_map`` on the same per-rank inputs."""
    inputs, ranks = port_runs
    inp = inputs[n]["mappings"]
    want_y, (want_dx,) = _jax_tp(
        n, lambda x, g: _jax_vjp(_jax_op(name), (x,), g), inp["xs"],
        inp["gs"][name])
    for r in range(n):
        y, dx = ranks[r][n]["mappings"][name]
        _close(y, want_y[r])
        _close(dx, want_dx[r])


@pytest.mark.parametrize("n", [2, 4])
def test_ring_psum_against_the_fused_all_reduce(port_runs, n):
    """``ring_psum`` at one and two chunk groups: bit for bit the fused
    all-reduce at n = 2, within 4 fp32 ulps of the magnitude at n = 4;
    JAX's ring on the same inputs within 1e-6."""
    from apex_tpu.transformer.tensor_parallel import mappings as jmap
    inputs, ranks = port_runs
    xs = inputs[n]["mappings"]["xs"]
    for chunks in (n, 2 * n):
        want = _jax_tp(n, lambda x: jmap.ring_psum(x, "tensor", chunks), xs)
        for r in range(n):
            ring, fused = ranks[r][n]["mappings"]["ring"][chunks]
            if n == 2:
                assert torch.equal(ring, fused)
            else:
                ulp = 4 * np.finfo(np.float32).eps * float(fused.abs().max())
                assert float((ring - fused).abs().max()) <= ulp
            _close(_np(ring), want[r], 1e-6)


@pytest.mark.parametrize("fusion", [False, True])
@pytest.mark.parametrize("n", [2, 4])
def test_ring_row_matmul_backward_is_the_fused_path(port_runs, n, fusion):
    """RowParallelLinear with ``overlap_chunks`` = 2n against the fused
    all-reduce: dx and dw equal bit for bit (one backward); the forward
    equal bit for bit at n = 2 and, at n = 4, where the ring adds the
    partials in another order, within 1e-6 of its max in fp32 and 2^-6
    in bf16 (the fusion's activations: 4 bf16 ulps); under the
    fp32-wgrad fusion dw is fp32."""
    _, ranks = port_runs
    for r in range(n):
        res = ranks[r][n]["ring_row"][fusion]
        (y1, dx1, dw1), (y2, dx2, dw2) = res[1], res[2 * n]
        assert torch.equal(dx1, dx2) and torch.equal(dw1, dw2)
        if n == 2:
            assert torch.equal(y1, y2)
        _close(_np(y2), _np(y1), 2.0 ** -6 if fusion else 1e-6)
        assert dw1.dtype == torch.float32       # the fp32 (master) weight


def _jax_layer_run(kind, variant, inp):
    """JAX's layer at tp = 2 on the shards of ``inp``'s weights: output,
    input grad, weight grad (and bias grad) of ``sum(out * g)``."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.tensor_parallel import (
        ColumnParallelLinear as JCol, RowParallelLinear as JRow,
        VocabParallelEmbedding as JEmb)
    if kind == "col":
        bias, gather, skip = variant
        layer = JCol(8, 12, bias=bias, gather_output=gather,
                     skip_bias_add=skip)
        w = np.stack(np.split(inp["wc"], 2))
        b = np.stack(np.split(inp["bc"], 2))
        g = np.stack([inp["gc"]] * 2) if gather else inp["gcp"]
        x = np.stack([inp["x"]] * 2)
    elif kind == "row":
        parallel, skip, chunks = variant
        layer = JRow(8, 6, bias=True, input_is_parallel=parallel,
                     skip_bias_add=skip, overlap_chunks=chunks)
        w = np.stack(np.split(inp["wr"], 2, axis=1))
        b = np.stack([inp["br"]] * 2)
        g = np.stack([inp["gr"]] * 2)
        x = inp["xp"] if parallel else np.stack([inp["x"]] * 2)
    else:
        layer = JEmb(16, 6, grad_via_matmul=variant)
        w = np.stack(np.split(inp["emb"], 2))
        b = w[:, :1, 0]
        g = np.stack([inp["gemb"]] * 2)
        x = np.stack([inp["ids"]] * 2)

    def fn(w, b, g, x):
        params = {"weight": w}
        if kind != "emb" and (kind == "row" or variant[0]):
            params["bias"] = b

        def loss(params, x):
            out = layer.apply({"params": params}, x)
            if kind == "emb":
                return jnp.sum(out * g), out
            y, ob = out
            extra = jnp.sum(ob) if ob is not None else 0.0
            return jnp.sum(y * g) + extra, y

        argnums = (0,) if kind == "emb" else (0, 1)
        (_, y), grads = jax.value_and_grad(loss, argnums=argnums,
                                           has_aux=True)(params, x)
        return y, grads

    return _jax_tp(2, fn, w, b, g, x)


def test_layers_match_jax_at_tp2(port_runs):
    """ColumnParallelLinear (``gather_output``, ``skip_bias_add``, no
    bias), RowParallelLinear (the input scattered, ``skip_bias_add``,
    ``overlap_chunks``) and VocabParallelEmbedding (``grad_via_matmul``
    either way) against JAX's flax layers at tp = 2."""
    inputs, ranks = port_runs
    inp = inputs[2]["layers"]
    for key, got0 in ranks[0][2]["layers"].items():
        if key[0] == "fusion":
            continue
        kind, variant = key[0], key[1:] if key[0] != "emb" else key[1]
        y, grads = _jax_layer_run(kind, variant, inp)
        for r in range(2):
            got = ranks[r][2]["layers"][key]
            _close(got[0], y[r])
            if kind == "emb":
                _close(got[1], grads[0]["weight"][r])
                continue
            _close(got[1], grads[1][r])
            _close(got[2], grads[0]["weight"][r])
            if got[3] is not None:
                _close(got[3], grads[0]["bias"][r])


def test_gradient_accumulation_fusion_makes_fp32_wgrads(port_runs):
    """Under ``gradient_accumulation_fusion`` (fp32 master, bf16
    activations) the weight grad is fp32, JAX's within 2^-8 relative (the
    bf16 dx and output round alike); a 16-bit weight raises JAX's
    ValueError."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.tensor_parallel import (
        ColumnParallelLinear as JCol, RowParallelLinear as JRow)
    inputs, ranks = port_runs
    inp = inputs[2]["layers"]
    for kind in ("col", "row"):
        if kind == "col":
            layer = JCol(8, 12, bias=False, gather_output=False,
                         gradient_accumulation_fusion=True)
            w, x, g = (np.stack(np.split(inp["wc"], 2)),
                       np.stack([inp["x"]] * 2), inp["gcp"])
        else:
            layer = JRow(8, 6, bias=False, input_is_parallel=True,
                         gradient_accumulation_fusion=True)
            w, x, g = (np.stack(np.split(inp["wr"], 2, axis=1)), inp["xp"],
                       np.stack([inp["gr"]] * 2))

        def fn(w, x, g):
            xb = x.astype(jnp.bfloat16)

            def f(w, xb):
                return layer.apply({"params": {"weight": w}}, xb)[0]
            y, vjp = jax.vjp(f, w, xb)
            dw, dx = vjp(g.astype(jnp.bfloat16))
            return y.astype(jnp.float32), dx.astype(jnp.float32), dw

        y, dx, dw = _jax_tp(2, fn, w, x, g)
        for r in range(2):
            gy, gdx, gdw, dtype = ranks[r][2]["layers"]["fusion", kind]
            assert dtype == torch.float32 and dw.dtype == np.float32
            _close(gy, y[r], TOL_HALF)
            _close(gdx, dx[r], TOL_HALF)
            _close(gdw, dw[r], TOL_HALF)
    for layer in (ttp.ColumnParallelLinear(8, 8, params_dtype=torch.bfloat16,
                                           gradient_accumulation_fusion=True,
                                           device="cpu"),
                  ttp.RowParallelLinear(8, 8, params_dtype=torch.bfloat16,
                                        gradient_accumulation_fusion=True,
                                        device="cpu")):
        with pytest.raises(ValueError, match="fp32"):
            layer(torch.ones(2, 8, dtype=torch.bfloat16))


@pytest.mark.parametrize("n", [2, 4])
def test_vocab_parallel_cross_entropy_matches_jax(port_runs, n):
    """The sharded cross entropy with and without smoothing and the bf16
    residual: the loss and each rank's logits grad against JAX's."""
    from apex_tpu.transformer.tensor_parallel.cross_entropy import \
        vocab_parallel_cross_entropy as jce
    inputs, ranks = port_runs
    inp = inputs[n]["ce"]
    shards = np.stack(np.split(inp["logits"], n, axis=-1))
    for smoothing, half in CE_CASES:
        def fn(x, t, g):
            return _jax_vjp(lambda x: jce(x, t, smoothing,
                                          half_residuals=half), (x,), g)
        loss, (dx,) = _jax_tp(n, fn, shards,
                              replicated=(inp["target"], inp["g"]))
        for r in range(n):
            got_loss, got_dx = ranks[r][n]["ce"]["ce", smoothing, half]
            _close(got_loss, loss[r])
            _close(got_dx, dx[r], TOL_HALF if half else TOL)


@pytest.mark.parametrize("n", [2, 4])
def test_fused_vocab_parallel_head_matches_jax(port_runs, n):
    """The fused vocab-parallel head (token chunk 4, two padded rows) with
    and without smoothing and ``grad_input_psum``: the loss, each rank's
    dhidden (its partial, or all-reduced) and its dhead against JAX's;
    the padded rows 0 loss and 0 grad."""
    from apex_tpu.ops.fused_lm_xent import \
        fused_lm_head_vocab_parallel_cross_entropy as jfused
    inputs, ranks = port_runs
    inp = inputs[n]["ce"]
    heads = np.stack(np.split(inp["head"], n))
    pad = inp["labels"] == -100
    for smoothing in (0.0, 0.1):
        for psum in (False, True):
            def fn(w, h, y, d):
                return _jax_vjp(lambda h, w: jfused(
                    h, w, y, smoothing=smoothing, token_chunk=4,
                    grad_input_psum=psum), (h, w), d)
            loss, (dh, dw) = _jax_tp(n, fn, heads, replicated=(
                inp["hidden"], inp["labels"], inp["dloss"]))
            for r in range(n):
                got = ranks[r][n]["ce"]["fused", smoothing, psum]
                _close(got[0], loss[r])
                _close(got[1], dh[r])
                _close(got[2], dw[r])
                assert not got[0][pad].any() and not got[1][pad].any()
            if psum:
                np.testing.assert_array_equal(
                    ranks[0][n]["ce"]["fused", smoothing, psum][1],
                    ranks[1][n]["ce"]["fused", smoothing, psum][1])


@pytest.mark.parametrize("fused", [0, 8])
def test_llama_tp2_matches_jax_at_tp2_and_tp1(port_runs, fused):
    """The port's LLaMA at tp = 2 (4 heads over 2 kv heads, each rank its
    kv head): the loss and each rank's grads against JAX's at tp = 2,
    and the grads put together along the shard dims against JAX's tp = 1
    grads (the unfused head and the fused one, token chunk 8)."""
    inputs, ranks = port_runs
    tree, batch = inputs[2]["trees"][2], inputs[2]["batch"]
    cfg = LlamaConfig(**LLAMA, num_kv_heads=2)
    loss2, grads2, _ = _jax_llama_grads(2, 2, tree, batch, fused)
    loss1, grads1, _ = _jax_llama_grads(1, 2, tree, batch, fused)
    got = [ranks[r][2]["llama"][fused] for r in range(2)]
    assert got[0][0] == got[1][0]
    for r in range(2):
        assert abs(got[r][0] - float(loss2[r])) <= TOL * float(loss2[r])
    assert abs(got[0][0] - float(loss1)) <= TOL * float(loss1)
    for name in got[0][1]:
        for r in range(2):
            _close(got[r][1][name], _leaf(grads2, name)[r])
        dim = _gather_dim(cfg, name, 2)
        whole = got[0][1][name] if dim is None else np.concatenate(
            [got[r][1][name] for r in range(2)], axis=dim)
        _close(whole, _leaf(grads1, name))


@pytest.mark.parametrize("tp,kvh", REPLICATED)
def test_replicated_kv_matches_jax_and_reduce_llama_grads(port_runs, tp,
                                                          kvh):
    """tp above the kv heads (MQA at tp = 2; tp = 4 over 2 kv heads): the
    kv projection replicated.  With ``reduce_llama_grads`` each rank's
    grads are JAX's and, put together, JAX's tp = 1 grads; without it the
    kv grads are each rank's partial (JAX's too), and three SGD steps
    part the ranks' kv weights where the reduced ones stay equal bit for
    bit."""
    inputs, ranks = port_runs
    tree, batch = inputs[tp]["trees"][kvh], inputs[tp]["batch"]
    cfg = LlamaConfig(**LLAMA, num_kv_heads=kvh)
    loss1, grads1, _ = _jax_llama_grads(1, kvh, tree, batch)
    jloss, unreduced, reduced = _jax_llama_grads(tp, kvh, tree, batch)
    for reduce in (True, False):
        jgrads = reduced if reduce else unreduced
        got = [ranks[r][tp]["replicated"][reduce] for r in range(tp)]
        for r in range(tp):
            assert abs(got[r][0] - float(jloss[r])) <= TOL * float(jloss[r])
            for name, g in got[r][1].items():
                jname = name.replace("kv_proj.weight", "kv_proj.kernel")
                want = _leaf(jgrads, jname)[r]
                _close(g, want.T if jname != name else want)
        if reduce:
            assert abs(got[0][0] - float(loss1)) <= TOL * float(loss1)
            for name in got[0][1]:
                dim = _gather_dim(cfg, name, tp)
                whole = got[0][1][name] if dim is None else np.concatenate(
                    [got[r][1][name] for r in range(tp)], axis=dim)
                _close(whole, _leaf(grads1, name))
    drift = [ranks[r][tp]["drift"] for r in range(tp)]
    short, no_offsets = drift[0]["refusals"]
    assert "ZeRO" in short and "offsets=" in no_offsets
    for r in range(1, tp):
        np.testing.assert_array_equal(drift[r][True], drift[0][True])
        assert np.abs(drift[r][False] - drift[0][False]).max() > 1e-7


def test_three_train_steps_at_tp2_match_jax(port_runs):
    """``make_train_step`` with ``fused_adam`` and a dynamic loss scale at
    tp = 2: each step's loss and each rank's master against JAX's step
    under ``shard_map`` on the same shards."""
    import jax.numpy as jnp
    from apex_tpu import train_step as jtrain
    from apex_tpu.optimizers import functional as jfunctional
    from apex_tpu.transformer.testing import LlamaConfig as JCfg
    from apex_tpu.transformer.testing import llama_model_provider as jllama
    inputs, ranks = port_runs
    tree, batch = inputs[2]["trees"][2], inputs[2]["batch"]
    cfg_kw = dict(LLAMA, num_kv_heads=2)
    model = jllama(JCfg(**cfg_kw))
    jtx = jfunctional.fused_adam(lr=LR)
    step = jtrain.make_train_step(
        lambda p, b: model.apply({"params": p}, b["tokens"], b["labels"]),
        jtx)

    def fn(p, tokens, labels):
        st = jtrain.init_train_state(jtx, p, loss_scale="dynamic")
        losses, masters = [], []
        for i in range(STEPS):
            st, loss = step(st, {"tokens": tokens[i], "labels": labels[i]})
            losses.append(loss)
            masters.append(st.opt.master)
        return jnp.stack(losses), jnp.stack(masters)

    losses, masters = _jax_tp(2, fn, _jax_shard_tree(tree, cfg_kw, 2),
                              replicated=(jnp.asarray(batch["tokens"]),
                                          jnp.asarray(batch["labels"])))
    for r in range(2):
        got = ranks[r][2]["train"]
        for i in range(STEPS):
            assert abs(got["losses"][i] - float(losses[r, i])) <= \
                TOL * float(losses[r, i])
            diff = np.abs(got["masters"][i] - masters[r, i])
            assert diff.max() <= 2 * LR * (i + 1), diff.max()
            assert np.mean(diff > 1e-5) <= 1e-3
    assert got["losses"][-1] < got["losses"][0]


def test_tp2_dp2_zero_matches_tp1_on_the_whole_batch(port_runs):
    """Four ranks, tp = 2 x dp = 2, the ZeRO step over the data group on
    each data rank's half of the rows, against JAX's tp = 1 dense step on
    the whole batch: the losses, and the tensor ranks' params put
    together along the shard dims after three steps."""
    import jax
    import jax.numpy as jnp
    from apex_tpu import train_step as jtrain
    from apex_tpu.optimizers import functional as jfunctional
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.testing import LlamaConfig as JCfg
    from apex_tpu.transformer.testing import llama_model_provider as jllama
    inputs, ranks = port_runs
    tree, batch = inputs[2]["trees"][2], inputs[2]["tpdp_batch"]
    cfg = LlamaConfig(**LLAMA, num_kv_heads=2)
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(1, devices=jax.devices()[:1])
    try:
        model = jllama(JCfg(**LLAMA, num_kv_heads=2))
        jtx = jfunctional.fused_adam(lr=LR)
        step = jax.jit(jtrain.make_train_step(
            lambda p, b: model.apply({"params": p}, b["tokens"],
                                     b["labels"]), jtx))
        st = jtrain.init_train_state(jtx, tree, loss_scale="dynamic")
        losses = []
        for i in range(STEPS):
            st, loss = step(st, {k: jnp.asarray(batch[k][i])
                                 for k in ("tokens", "labels")})
            losses.append(float(loss))
        want = jax.tree.map(np.asarray, st.params())
    finally:
        jps.destroy_model_parallel()
    runs = [r[2]["tpdp"] for r in ranks]
    assert sorted((r["data_rank"], r["tensor_rank"]) for r in runs) == [
        (0, 0), (0, 1), (1, 0), (1, 1)]
    for r in runs:
        for got, w in zip(r["losses"], losses):
            assert abs(got - w) <= TOL * w
    by_tensor = {r["tensor_rank"]: r["params"] for r in runs
                 if r["data_rank"] == 0}
    for r in runs:     # the data ranks of a tensor rank hold one model
        for name, p in r["params"].items():
            np.testing.assert_array_equal(p, by_tensor[r["tensor_rank"]][name])
    diffs = []
    for name in by_tensor[0]:
        dim = _gather_dim(cfg, name, 2)
        whole = by_tensor[0][name] if dim is None else np.concatenate(
            [by_tensor[t][name] for t in range(2)], axis=dim)
        diffs.append(np.abs(whole - _leaf(want, name)).reshape(-1))
    diff = np.concatenate(diffs)
    assert diff.max() <= 2 * LR * STEPS, diff.max()
    assert np.mean(diff > 1e-5) <= 1e-3


@pytest.mark.parametrize("n", [2, 4])
def test_broadcast_tracker_and_groups(port_runs, n):
    """``broadcast_data`` gives every rank tensor rank 0's arrays in the
    asked type; the model-parallel stream differs across tensor ranks and
    the default stream does not; ``checkpoint`` replays the forward's
    dropout mask in the recompute and leaves the stream where a run
    without recompute does; a ``ProcessGroup`` serves as ``axis_name``
    and an explicit size it contradicts raises."""
    _, ranks = port_runs
    runs = [ranks[r][n]["misc"] for r in range(n)]
    for r in runs:
        np.testing.assert_array_equal(r["bcast"]["a"], np.full((2, 3), 1))
        np.testing.assert_array_equal(r["bcast"]["b"], np.arange(4))
        assert r["bcast_dtype"] == torch.int64
        np.testing.assert_array_equal(r["default_draw"],
                                      runs[0]["default_draw"])
        assert r["replay_equal"] and r["grad_is_mask"] and r["after_equal"]
        assert r["group_shape"] == (3, 2 * n)
        assert "disagrees" in r["mismatch"]
    draws = [r["mp_draw"] for r in runs]
    assert all(np.abs(a - draws[0]).max() > 0 for a in draws[1:])
    # the streams' statistics: uniform on [0, 1) either way
    for d in draws + [runs[0]["default_draw"]]:
        assert 0.0 <= d.min() and d.max() < 1.0 and abs(d.mean() - 0.5) < 0.15


@pytest.mark.parametrize("n", [2, 4])
def test_gpt_and_bert_refuse_tp_above_1(port_runs, n):
    """GPT and BERT built under a tp > 1 topology raise
    NotImplementedError naming item 6 and queue 3's entry: the JAX
    reference's tied raw-einsum head leaves each rank a rank-partial
    dhidden, so there is no tp > 1 reference to hold them to."""
    _, ranks = port_runs
    for r in range(n):
        for name in ("gpt", "bert"):
            msg = ranks[r][n]["misc"][name]
            assert msg and "item 6" in msg and "tied heads at tp > 1" in msg


def test_memory_buffer_views_and_utils():
    """``MemoryBuffer`` hands out views of one flat tensor on its device
    and refuses a range past its end; the partition helpers are JAX's."""
    from apex_tpu.transformer import utils as jutils
    from apex_tpu_torch.transformer import utils as tutils
    buf = ttp.MemoryBuffer(12, torch.float32, device="cpu")
    a = buf.get((2, 3), 0)
    b = buf.get((6,), 6)
    a.fill_(1.0)
    b.fill_(2.0)
    assert a.data_ptr() == buf.data.data_ptr()
    np.testing.assert_array_equal(_np(buf.data), [1.0] * 6 + [2.0] * 6)
    buf.zero()
    assert not buf.data.any() and not a.any()
    with pytest.raises(RuntimeError, match="out of the buffer"):
        buf.get((4,), 10)
    for args in ((128, 4, 2), (96, 0, 3)):
        assert tutils.VocabUtility.vocab_range_from_global_vocab_size(
            *args) == jutils.VocabUtility.vocab_range_from_global_vocab_size(
            *args)
    x = np.arange(24, dtype=np.float32).reshape(2, 12)
    for got, want in zip(ttp.split_tensor_along_last_dim(_t(x), 3, True),
                         jutils.split_tensor_along_last_dim(x, 3)):
        np.testing.assert_array_equal(_np(got), np.asarray(want))
        assert got.is_contiguous()
    assert tutils.divide(12, 4) == 3
    with pytest.raises(AssertionError):
        tutils.divide(10, 4)


def test_shard_llama_params_layouts():
    """``shard_llama_params`` against JAX's tp > 1 init shapes: the column
    weights by rows, the row weights by columns, ``kv_proj`` by rows in
    whole kv heads (each kv head's k and v side by side), whole where tp
    exceeds the kv heads; numpy and tensor leaves alike."""
    import jax
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.testing import LlamaConfig as JCfg
    from apex_tpu.transformer.testing import llama_model_provider as jllama
    for kvh, tp in ((2, 2), (1, 2), (2, 4)):
        cfg = LlamaConfig(**LLAMA, num_kv_heads=kvh)
        tree = _llama_tree(kvh)
        jps.destroy_model_parallel()
        jps.initialize_model_parallel(tp, devices=jax.devices()[:tp])
        try:
            from jax.sharding import PartitionSpec as P
            model = jllama(JCfg(**LLAMA, num_kv_heads=kvh))
            tokens = np.zeros((1, SEQ), np.int32)
            shapes = jax.eval_shape(functools.partial(
                jax.shard_map, check_vma=False)(
                lambda t: model.init(jax.random.PRNGKey(0), t),
                mesh=jps.get_mesh(), in_specs=P(), out_specs=P()),
                tokens)["params"]
        finally:
            jps.destroy_model_parallel()
        for r in range(tp):
            shard = shard_llama_params(tree, cfg, tp, r)
            tshard = shard_llama_params(
                jax.tree.map(torch.from_numpy, tree), cfg, tp, r)
            for path, shape in llama_param_shapes(cfg).items():
                name = ".".join(path)
                got = _leaf(shard, name)
                np.testing.assert_array_equal(_np(_leaf(tshard, name)), got)
                jname = name
                if name.endswith("kv_proj.weight") and kvh % tp:
                    jname = name.replace("weight", "kernel")
                    assert got.shape == shape
                    continue
                assert got.shape == _leaf(shapes, jname).shape, name
            kv = _leaf(shard, "layer_0.attention.kv_proj.weight")
            whole = tree["layer_0"]["attention"]["kv_proj"]["weight"]
            if kvh % tp == 0:
                hd = LLAMA["hidden_size"] // LLAMA["num_attention_heads"]
                per = kvh // tp
                np.testing.assert_array_equal(
                    kv, whole[r * per * 2 * hd:(r + 1) * per * 2 * hd])


def test_param_attribute_helpers_match_jax():
    """The four attribute helpers on tensors, as the JAX package's on an
    attribute-bearing carrier: set (once), defaults, copy, and a
    tensor-parallel weight counted once."""
    import types
    from apex_tpu.transformer.tensor_parallel import layers as jlayers
    for mod, make in ((ttp, lambda: torch.nn.Parameter(torch.zeros(2))),
                      (jlayers, types.SimpleNamespace)):
        a, b, c = make(), make(), make()
        mod.set_tensor_model_parallel_attributes(a, True, 1, 2)
        with pytest.raises(AssertionError):
            mod.set_tensor_model_parallel_attributes(a, True, 1, 2)
        mod.set_defaults_if_not_set_tensor_model_parallel_attributes(b)
        mod.copy_tensor_model_parallel_attributes(c, a)
        assert (a.tensor_model_parallel, a.partition_dim,
                a.partition_stride) == (True, 1, 2)
        assert (b.tensor_model_parallel, b.partition_dim,
                b.partition_stride) == (False, -1, 1)
        assert (c.tensor_model_parallel, c.partition_dim,
                c.partition_stride) == (True, 1, 2)
        assert mod.param_is_not_tensor_parallel_duplicate(a)
