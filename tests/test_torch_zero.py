"""ZeRO on the port against the JAX package (CPU): the shard layouts,
the sharded-leaf helpers, the sharded rules, the ``zero=True`` train
step and the ``DistributedFused{Adam,LAMB}`` classes.

The port's counterparts of ``tests/L1/test_zero_train_step.py`` and
``tests/L0/run_contrib/test_distributed_optimizers.py``.  The JAX side
runs in this process on the 8 host devices that ``tests/conftest.py``
pins (``shard_map`` over a ``data`` mesh of the first dp of them); the
port's ranks run one process a rank, spawned over gloo with
``device="cpu"`` on a ``FileStore`` under the test's temporary directory
(:func:`apex_tpu_torch.transformer.testing.distributed_test_base.spawn_ranks`).
One spawn a width (dp = 2, dp = 4) runs every rank-side case of that
width (the ``port_runs`` fixture); the spawned ranks import this module,
torch and the port only: every JAX import sits inside a JAX-side helper.

Layouts are held exactly: a rank's shard is JAX's rank-r slice of
``init_zero_train_state``'s global view element for element, in the
block layout and the prefetch (per-span) layout.  The small LLaMA is 2
layers, hidden 64, 4 heads over 2 kv heads, vocab 128, fp32.  Steps
follow ``tests/test_torch_training.py``'s tolerances: losses within
1e-5 relative; masters within 2 * lr * steps everywhere and within 1e-5
on all but 0.1% of the elements (Adam's first steps move an element by
about lr * sign(g), so a grad at the two sides' noise level may move
the other way).  The sharded rules and the distributed optimizers on
fixed grads: 1e-5 relative and 1e-6 absolute; the sharded-leaf helpers
1e-6 relative.  An overflow step leaves master and slots bit-identical
on every rank.
"""
import functools

import numpy as np
import pytest
import torch

from apex_tpu_torch import train_step as ttrain
from apex_tpu_torch.contrib.optimizers import (DistributedFusedAdam,
                                               DistributedFusedLAMB)
from apex_tpu_torch.inference.weights import load_jax_params
from apex_tpu_torch.optimizers import FusedAdam, FusedLAMB
from apex_tpu_torch.optimizers import base as tbase
from apex_tpu_torch.optimizers import functional as tfunctional
from apex_tpu_torch.transformer.testing import (LlamaConfig,
                                                llama_model_provider)
from apex_tpu_torch.transformer.testing.distributed_test_base import \
    spawn_ranks

from _torch_isolation import restore_torch_from_amp  # noqa: F401

CFG = dict(vocab_size=128, hidden_size=64, num_layers=2,
           num_attention_heads=4, num_kv_heads=2, max_seq_length=32)
SEQ, BATCH, LR, STEPS = 16, 4, 1e-3, 3
#: the prefetch layouts held: the block and a 3-span layout
PREFETCH = (0, 3)
#: the sharded rules and their constructor arguments
RULES = {"adam": ("fused_adam", dict(lr=1e-2, weight_decay=0.01)),
         "lamb": ("fused_lamb", dict(lr=1e-2, weight_decay=0.01)),
         "sgd": ("fused_sgd", dict(lr=0.1, momentum=0.9)),
         "novograd": ("fused_novograd", dict(lr=1e-2, weight_decay=0.01)),
         "adagrad": ("fused_adagrad", dict(lr=1e-2))}
#: the distributed optimizers' parameters (JAX's ``_params`` shapes)
W_SHAPE, B_SHAPE = (37, 13), (13,)
NFLAT = 37 * 13 + 13


def _llama_tree():
    """A seeded numpy LLaMA tree with the model's key paths: linears
    N(0, 1/fan_in), norms 1 + N(0, 0.1^2), embeddings N(0, 1)."""
    from apex_tpu_torch.inference.weights import llama_param_shapes
    shapes = llama_param_shapes(LlamaConfig(**CFG))
    rng = np.random.RandomState(0)
    tree: dict = {}
    for path, shape in sorted(shapes.items()):
        t = rng.randn(*shape)
        if len(shape) == 1:
            t = 1 + 0.1 * t
        elif "embed" not in "/".join(path):
            t = t / np.sqrt(shape[1])
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.astype(np.float32)
    return tree


def _batches():
    """``STEPS`` global batches of ``BATCH`` rows; step 1 poisons the last
    quarter of the rows (the last rank's at dp = 4, half of rank 1's at
    dp = 2), so its grads alone carry an inf."""
    rng = np.random.RandomState(8)
    tokens = rng.randint(0, CFG["vocab_size"],
                         (STEPS, BATCH, SEQ + 1)).astype(np.int32)
    poison = np.zeros((STEPS, BATCH), np.float32)
    poison[1, -1] = 1e38
    return dict(tokens=tokens[..., :-1], labels=tokens[..., 1:],
                poison=poison)


def _opt_params(seed):
    rng = np.random.RandomState(seed)
    return {"b": rng.randn(*B_SHAPE).astype(np.float32),
            "w": rng.randn(*W_SHAPE).astype(np.float32)}


def _unflat(flat):
    """A flat grad vector as the ``{"b", "w"}`` tree (leaf order: b, w)."""
    return {"b": flat[:13], "w": flat[13:].reshape(W_SHAPE)}


def _rank_grads(dp, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(dp, NFLAT) * scale).astype(
        np.float32)


# -- the JAX side (JAX imported here only) -----------------------------------

def _mesh(dp):
    import jax
    from jax.sharding import Mesh
    return Mesh(np.array(jax.devices()[:dp]), ("data",))


def _shard_map(fn, dp, in_specs, out_specs):
    import jax
    return jax.jit(functools.partial(jax.shard_map, check_vma=False)(
        fn, mesh=_mesh(dp), in_specs=in_specs, out_specs=out_specs))


def _jax_llama():
    from apex_tpu.transformer import parallel_state
    from apex_tpu.transformer.testing import LlamaConfig as JLlamaConfig
    from apex_tpu.transformer.testing import llama_model_provider as jllama
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    return jllama(JLlamaConfig(**CFG))


def _jax_loss(jmodel):
    import jax.numpy as jnp

    def loss(p, b):
        return jmodel.apply({"params": p}, b["tokens"], b["labels"]) + \
            jnp.sum(p["final_norm"]["weight"]) * jnp.mean(b["poison"])
    return loss


def _jax_zero_run(dp, prefetch, tree, batches):
    """JAX's zero step, ``STEPS`` steps in ``shard_map``: the losses, each
    rank's master shard and slots after every step ``[dp, STEPS, L]``, and
    the final scale."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from apex_tpu import train_step as jtrain
    from apex_tpu.optimizers import functional as jfunctional
    tx = jfunctional.fused_adam(lr=LR)
    step = jtrain.make_train_step(_jax_loss(_jax_llama()), tx, zero=True)

    def body(bs):
        st = jtrain.init_train_state(tx, tree, loss_scale="dynamic",
                                     shard=("data", dp), prefetch=prefetch)
        losses, masters, ms, vs = [], [], [], []
        for i in range(STEPS):
            st, loss = step(st, jax.tree.map(lambda a: a[i], bs))
            losses.append(loss)
            masters.append(st.opt.master)
            ms.append(st.opt.slots["exp_avg"])
            vs.append(st.opt.slots["exp_avg_sq"])
        return (jnp.stack(losses), jnp.stack(masters)[None],
                jnp.stack(ms)[None], jnp.stack(vs)[None],
                st.scaler.loss_scale)

    spec = {k: P(None, "data") for k in batches}
    out = _shard_map(body, dp, (spec,), (P(), P("data"), P("data"),
                                         P("data"), P()))(
        {k: jnp.asarray(v) for k, v in batches.items()})
    return [np.asarray(x) for x in out]


def _jax_global_view(dp, prefetch, tree):
    """JAX's ``init_zero_train_state`` global master (padded, rank-major)
    and its shard length."""
    from apex_tpu import train_step as jtrain
    from apex_tpu.optimizers import functional as jfunctional
    state, _ = jtrain.init_zero_train_state(
        jfunctional.fused_adam(lr=LR), tree, "data", dp, prefetch=prefetch)
    return np.asarray(state.opt.master), state.opt.shard_len, state.opt.spans


def _jax_rule_run(dp, rule, prefetch, tree, gshards):
    """JAX's sharded ``rule`` update, two steps in ``shard_map`` on fixed
    per-rank grad shards: each rank's master and flat slots."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from apex_tpu.optimizers import functional as jfunctional
    name, kw = RULES[rule]
    tx = getattr(jfunctional, name)(**kw)

    def body(g):
        st = tx.init(tree, shard=("data", dp), prefetch=prefetch)
        for _ in range(2):
            st = tx.update(st, g[0])
        flat = {k: v[None] for k, v in st.slots.items()
                if v.shape == st.master.shape}
        return st.master[None], flat

    return _shard_map(body, dp, (P("data"),), (P("data"), P("data")))(
        jnp.asarray(gshards))


def _jax_dist_opt(cls_name, dp, params, grads, steps=2, noop=0.0):
    """JAX's ``DistributedFused*`` ``steps`` steps on fixed per-rank
    grads: the params tree after the last."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from apex_tpu.contrib import optimizers as jopt
    opt = getattr(jopt, cls_name)(dp, lr=1e-2, weight_decay=0.01)
    jparams = jax.tree.map(jnp.asarray, params)

    def body(grank):
        state = opt.init_state(jparams)
        g = _unflat(grank[0] if dp > 1 else grank.reshape(-1))
        for _ in range(steps):
            new, state = opt.step(state, g, noop_flag=noop)
        return new

    if dp == 1:
        out = jax.jit(body)(jnp.asarray(grads))
    else:
        out = _shard_map(body, dp, (P("data"),), P())(jnp.asarray(grads))
    return jax.tree.map(np.asarray, out)


# -- the port side (spawned ranks and in process) ----------------------------

def _port_model(tree):
    model = llama_model_provider(LlamaConfig(**CFG), device="cpu")
    load_jax_params(model, tree)
    return model


def _port_loss(model, b):
    return model(b["tokens"], b["labels"]) + \
        model.final_norm.weight.sum() * b["poison"].mean()


def _rank_batch(batches, i, rank, dp):
    rows = slice(rank * BATCH // dp, (rank + 1) * BATCH // dp)
    return {k: torch.from_numpy(np.ascontiguousarray(v[i, rows]))
            for k, v in batches.items()}


def _zero_steps(rank, dp, prefetch, tree, batches):
    """The port's zero step, ``STEPS`` steps on this rank's rows: losses,
    the shard of master and slots after each step, the final scale,
    whether each step's unscaled shard was finite."""
    tx = tfunctional.fused_adam(lr=LR)
    state = ttrain.init_train_state(tx, _port_model(tree),
                                    loss_scale="dynamic",
                                    shard=("data", dp), prefetch=prefetch)
    finite = []

    def record(g):
        finite.append(bool(torch.isfinite(g).all()))
        return g

    step = ttrain.make_train_step(_port_loss, tx, zero=True,
                                  grad_transform=record)
    out = dict(losses=[], masters=[], m=[], v=[], finite=finite,
               spans=state.opt.spans, shard_len=state.opt.shard_len)
    for i in range(STEPS):
        state, loss = step(state, _rank_batch(batches, i, rank, dp))
        out["losses"].append(float(loss))
        out["masters"].append(state.opt.master.clone())
        out["m"].append(state.opt.slots["exp_avg"].clone())
        out["v"].append(state.opt.slots["exp_avg_sq"].clone())
    out["scale"] = float(state.scaler.loss_scale)
    out["full"] = state.opt.full_master()
    return out


def _global_view(rank, dp, prefetch, tree):
    """``init_zero_train_state``: the rank's shard, the specs, the params
    reassembled by ``state.params()``."""
    state, specs = ttrain.init_zero_train_state(
        tfunctional.fused_adam(lr=LR), _port_model(tree), "data", dp,
        prefetch=prefetch)
    params = state.params()
    return dict(master=state.opt.master.clone(), specs=specs,
                params=params, spans=state.opt.spans)


def _aux_step(rank, dp, tree, batches):
    tx = tfunctional.fused_adam(lr=LR)
    state = ttrain.init_train_state(tx, _port_model(tree),
                                    shard=("data", dp))

    def loss_fn(model, b):
        loss = model(b["tokens"], b["labels"])
        return loss, {"x_mean": b["tokens"].float().mean(),
                      "n_local": torch.tensor(b["tokens"].shape[0],
                                              dtype=torch.int32)}

    step = ttrain.make_train_step(loss_fn, tx, has_aux=True, zero=True)
    _, (loss, aux) = step(state, _rank_batch(batches, 0, rank, dp))
    return dict(loss=float(loss), x_mean=float(aux["x_mean"]),
                n_local=int(aux["n_local"]),
                n_dtype=aux["n_local"].dtype)


def _rule_steps(rank, dp, rule, prefetch, tree, gshards):
    name, kw = RULES[rule]
    tx = getattr(tfunctional, name)(**kw)
    state = tx.init({k: torch.from_numpy(v) for k, v in tree.items()},
                    shard=("data", dp), prefetch=prefetch)
    g = torch.from_numpy(gshards[rank])
    for _ in range(2):
        state = tx.update(state, g.clone())
    return dict(master=state.master.clone(),
                slots={k: v.clone() for k, v in state.slots.items()
                       if v.shape == state.master.shape})


def _dist_opt_steps(rank, dp, cls_name, params, grads, steps=2, noop=0.0,
                    dtype=torch.float32):
    cls = {"DistributedFusedAdam": DistributedFusedAdam,
           "DistributedFusedLAMB": DistributedFusedLAMB}[cls_name]
    opt = cls(dp, lr=1e-2, weight_decay=0.01)
    tparams = {k: torch.from_numpy(v).to(dtype) for k, v in params.items()}
    state = opt.init_state(tparams)
    g = {k: v.to(dtype) for k, v in
         _unflat(torch.from_numpy(grads[rank if dp > 1 else 0])).items()}
    before = {k: v.clone() for k, v in state.items()}
    for _ in range(steps):
        new, state = opt.step(state, g, noop_flag=noop)
    return dict(params=new, before=before, state=state,
                ckpt=opt.state_dict(state))


def _resume(rank, dp, cls_name, ckpt, grads):
    """Restore a checkpoint at this dp and take one more step."""
    cls = {"DistributedFusedAdam": DistributedFusedAdam,
           "DistributedFusedLAMB": DistributedFusedLAMB}[cls_name]
    opt = cls(dp, lr=1e-2, weight_decay=0.01)
    state = opt.shard_state(opt.load_state_dict(ckpt))
    new, state = opt.step(state, _unflat(torch.from_numpy(grads[rank])))
    return dict(params=new, ckpt=opt.state_dict(state))


def _unscale(rank, dp, shards):
    from apex_tpu_torch.amp.scaler import (init_loss_scale,
                                           unscale_flat_grads)
    state = init_loss_scale("dynamic", device="cpu")
    out, state = unscale_flat_grads(torch.from_numpy(shards[rank]).clone(),
                                    state, axis_name="data")
    return dict(out=out, flag=float(state.found_inf))


def _rank_main(rank, dp, tree, batches, opt_in):
    """Every rank-side case of width ``dp``."""
    out = {"zero": {p: _zero_steps(rank, dp, p, tree, batches)
                    for p in PREFETCH},
           "view": {p: _global_view(rank, dp, p, tree) for p in PREFETCH},
           "aux": _aux_step(rank, dp, tree, batches),
           "rules": {(r, p): _rule_steps(rank, dp, r, p, opt_in["tree"],
                                         opt_in["gshards"][p])
                     for r in RULES for p in PREFETCH},
           "unscale": _unscale(rank, dp, opt_in["unscale"])}
    for cls_name in ("DistributedFusedAdam", "DistributedFusedLAMB"):
        out[cls_name] = _dist_opt_steps(rank, dp, cls_name,
                                        opt_in["params"], opt_in["grads"])
    out["noop"] = _dist_opt_steps(rank, dp, "DistributedFusedAdam",
                                  opt_in["params"], opt_in["grads"],
                                  steps=1, noop=1.0)
    out["bf16"] = _dist_opt_steps(rank, dp, "DistributedFusedAdam",
                                  opt_in["params"], opt_in["grads"],
                                  steps=1, dtype=torch.bfloat16)
    for name, ckpt in opt_in.get("resume", {}).items():
        out[f"resume {name}"] = _resume(rank, dp, name, ckpt,
                                        opt_in["grads"])
    return out


def _opt_inputs(dp):
    """The rank-independent inputs of the optimizer cases at ``dp``: the
    rule cases' per-rank grad shards (of the JAX layout) for each
    prefetch, the distributed optimizers' params and per-rank grads, and
    the unscale's shards (the last rank's holding an inf)."""
    small = _small_tree()
    gshards = {}
    for p in PREFETCH:
        st = tfunctional.fused_adam().init(
            {k: torch.from_numpy(v) for k, v in small.items()},
            shard=("data", dp, 0), prefetch=p)
        rng = np.random.RandomState(20 + p)
        g = rng.randn(dp, st.shard_len).astype(np.float32) * 0.05
        # zero the padding: JAX's grad shards come out of the
        # reduce-scatter with zeros there
        for r in range(dp):
            mask = np.zeros(st.shard_len, bool)
            for _, lo, hi in tbase.rank_spans(st.sizes, dp=dp,
                                              shard_len=st.shard_len,
                                              rank=r, spans=st.spans):
                mask[lo:hi] = True
            g[r, ~mask] = 0.0
        gshards[p] = g
    unscale = np.random.RandomState(30).randn(dp, 64).astype(np.float32)
    unscale[-1, 5] = np.inf
    return dict(tree=small, gshards=gshards, params=_opt_params(5),
                grads=_rank_grads(dp, 6, 0.05), unscale=unscale)


def _small_tree():
    """A small two-leaf tree for the rule cases (odd sizes, so the
    layouts pad)."""
    rng = np.random.RandomState(3)
    return {"a": rng.randn(7, 5).astype(np.float32),
            "b": rng.randn(11).astype(np.float32),
            "c": rng.randn(3, 9).astype(np.float32)}


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """``port_runs(dp)``: every rank-side case of width ``dp``, once per
    module, as ``[rank] -> {case: result}``.  dp = 2 also restores the
    distributed optimizers' dp = 4 checkpoints."""
    tree, batches, runs = _llama_tree(), _batches(), {}

    def get(dp):
        if dp not in runs:
            opt_in = _opt_inputs(dp)
            if dp == 2:
                four = get(4)
                opt_in["resume"] = {
                    name: four[0][name]["ckpt"] for name in
                    ("DistributedFusedAdam", "DistributedFusedLAMB")}
            runs[dp] = spawn_ranks(
                dp, _rank_main, dp, tree, batches, opt_in,
                tmp_dir=str(tmp_path_factory.mktemp(f"dp{dp}")))
        return runs[dp]
    return get


def _np(t):
    return t.detach().float().cpu().numpy()


def _master_close(got, want, steps):
    diff = np.abs(got - want)
    assert diff.max() <= 2 * LR * steps, diff.max()
    assert np.mean(diff > 1e-5) <= 1e-3, np.mean(diff > 1e-5)


# -- layouts, in process -----------------------------------------------------

def _layout_sizes():
    from apex_tpu_torch.utils import tree_leaves_with_path
    model = _port_model(_llama_tree())
    return [int(t.numel()) for _, t in tree_leaves_with_path(model)]


@pytest.mark.parametrize("dp", [2, 4])
def test_shard_and_prefetch_leaf_spans_match_jax(dp):
    from apex_tpu.optimizers import base as jbase
    from apex_tpu.optimizers import functional as jfunctional
    sizes = _layout_sizes()
    for k in (1, 2, 3, 5, 40):
        assert tfunctional.prefetch_span_layout(sizes, k) == \
            jfunctional.prefetch_span_layout(sizes, k)
        assert tfunctional._normalize_prefetch(k, sizes) == \
            jfunctional._normalize_prefetch(k, sizes)
    shard_len = -(-sum(sizes) // dp)
    assert tbase.shard_leaf_spans(sizes, dp, shard_len) == \
        jbase.shard_leaf_spans(sizes, dp, shard_len)
    for k in (2, 3, 5):
        spans = jfunctional.prefetch_span_layout(sizes, k)
        assert tbase.prefetch_leaf_spans(sizes, spans, dp) == \
            jbase.prefetch_leaf_spans(sizes, spans, dp)
    with pytest.raises(ValueError, match="summing"):
        tfunctional._normalize_prefetch((1, 2), sizes)


@pytest.mark.parametrize("prefetch", PREFETCH)
@pytest.mark.parametrize("dp", [2, 4])
def test_rank_shards_equal_jax_global_view_slices(dp, prefetch):
    """Each rank's shard (built with an explicit rank, no group) is JAX's
    rank-r slice of ``init_zero_train_state``'s global view element for
    element; so is the shard loader's from JAX's unpadded master; and
    the port's full layout is JAX's."""
    tree = _llama_tree()
    gview, shard_len, spans = _jax_global_view(dp, prefetch, tree)
    model = _port_model(tree)
    tx = tfunctional.fused_adam(lr=LR)
    from apex_tpu.utils import tree_ravel as jtree_ravel
    jmaster = np.asarray(jtree_ravel(tree)[0])
    for r in range(dp):
        st = tx.init(model, shard=("data", dp, r), prefetch=prefetch)
        assert st.spans == spans and st.shard_len == shard_len
        want = gview[r * shard_len:(r + 1) * shard_len]
        np.testing.assert_array_equal(_np(st.master), want)
        assert st.slots["exp_avg"].shape == (shard_len,)
        loaded = tfunctional.shard_from_global_master(
            tx, jmaster, model, shard=("data", dp, r), prefetch=prefetch)
        np.testing.assert_array_equal(_np(loaded.master), want)
    full = tfunctional._layout_master(torch.from_numpy(jmaster.copy()),
                                      sizes=st.sizes, spans=spans, dp=dp)
    np.testing.assert_array_equal(_np(full), gview)
    # the O(shard) slice equals the slice of the padded global layout
    for r in range(dp):
        assert torch.equal(
            tfunctional._rank_shard(torch.from_numpy(jmaster.copy()),
                                    sizes=st.sizes, spans=spans, dp=dp,
                                    rank=r),
            tfunctional._shard_of(full, shard_len, r))


@pytest.mark.parametrize("fallback", [False, True])
@pytest.mark.parametrize("prefetch", PREFETCH)
@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_leaf_helpers_match_jax(dp, prefetch, fallback,
                                        monkeypatch):
    """The port's square norms, nonfinite counts, generic reduce and
    broadcast of each rank's shard against JAX's ``lax.switch`` path and
    its large-dp global-buffer path (``_SWITCH_MAX_DP`` lowered)."""
    import jax.numpy as jnp
    from apex_tpu.optimizers import base as jbase
    if fallback:
        monkeypatch.setattr(jbase, "_SWITCH_MAX_DP", 1)
    sizes = _layout_sizes()[:7]
    spans = tfunctional._normalize_prefetch(prefetch, sizes)
    shard_len = (sum(-(-s // dp) for s in tfunctional._span_sizes(
        sizes, spans)) if spans else -(-sum(sizes) // dp))
    rng = np.random.RandomState(dp + prefetch)
    for r in range(dp):
        vecs = rng.randn(2, shard_len).astype(np.float32)
        vecs[1, ::97] = np.inf
        scalars = rng.rand(len(sizes)).astype(np.float32)
        kw = dict(dp=dp, shard_len=shard_len, rank=r, spans=spans or None)
        jkw = dict(kw, rank=jnp.int32(r))
        jv = tuple(jnp.asarray(v) for v in vecs)
        tv = tuple(torch.from_numpy(v) for v in vecs)
        np.testing.assert_allclose(
            _np(tbase.sharded_leaf_sq_norms(tv[:1], sizes, **kw)),
            np.asarray(jbase.sharded_leaf_sq_norms(jv[:1], sizes, **jkw)),
            rtol=1e-6)
        np.testing.assert_array_equal(
            _np(tbase.sharded_leaf_nonfinite_counts(tv, sizes, **kw)),
            np.asarray(jbase.sharded_leaf_nonfinite_counts(jv, sizes,
                                                           **jkw)))
        np.testing.assert_allclose(
            _np(tbase.sharded_leaf_reduce(tv[:1], sizes, **kw,
                                          elem_fn=torch.abs)),
            np.asarray(jbase.sharded_leaf_reduce(jv[:1], sizes, **jkw,
                                                 elem_fn=jnp.abs)),
            rtol=1e-6)
        np.testing.assert_array_equal(
            _np(tbase.sharded_leaf_broadcast(torch.from_numpy(scalars),
                                             sizes, **kw, pad_value=7.0)),
            np.asarray(jbase.sharded_leaf_broadcast(
                jnp.asarray(scalars), sizes, **jkw, pad_value=7.0)))


def test_zero_requires_sharded_state():
    """zero=True on a dense state raises JAX's ValueError in both
    packages; a name without the topology raises, naming
    initialize_model_parallel."""
    tree = _llama_tree()
    tx = tfunctional.fused_adam(lr=LR)
    state = ttrain.init_train_state(tx, _port_model(tree))
    step = ttrain.make_train_step(_port_loss, tx, zero=True)
    batch = _rank_batch(_batches(), 0, 0, 1)
    with pytest.raises(ValueError, match="dp-sharded"):
        step(state, batch)
    from apex_tpu import train_step as jtrain
    from apex_tpu.optimizers import functional as jfunctional
    jtx = jfunctional.fused_adam(lr=LR)
    jstep = jtrain.make_train_step(_jax_loss(_jax_llama()), jtx, zero=True)
    with pytest.raises(ValueError, match="dp-sharded"):
        jstep(jtrain.init_train_state(jtx, tree),
              {k: v[0] for k, v in _batches().items()})
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        ttrain.init_train_state(tx, _port_model(tree), shard=("data", 2))
    # the other way round: a rank's shard in the dense step raises before
    # the forward runs
    model = _port_model(tree)
    sharded = ttrain.init_train_state(tx, model, shard=("data", 2, 1))
    before = [p.detach().clone() for p in model.parameters()]
    with pytest.raises(ValueError, match="zero=True"):
        ttrain.make_train_step(_port_loss, tx)(sharded, batch)
    assert all(torch.equal(p, b) for p, b in zip(model.parameters(), before))


def test_dp1_distributed_optimizers_match_fused_in_process():
    """dp = 1 needs no group: DistributedFusedAdam and LAMB equal
    FusedAdam and FusedLAMB on the same grads, and JAX's dp = 1."""
    params = _opt_params(2)
    g = _rank_grads(1, 7, 0.05)
    for name, dense in (("DistributedFusedAdam", FusedAdam),
                        ("DistributedFusedLAMB", FusedLAMB)):
        got = _dist_opt_steps(0, 1, name, params, g)["params"]
        ref = dense({k: torch.from_numpy(v) for k, v in params.items()},
                    lr=1e-2, weight_decay=0.01)
        for _ in range(2):
            want = ref.step(_unflat(torch.from_numpy(g[0])))
        jax_out = _jax_dist_opt(name, 1, params, g)
        for k in params:
            np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                       rtol=1e-6, atol=1e-7)
            np.testing.assert_allclose(_np(got[k]), jax_out[k], rtol=1e-5,
                                       atol=1e-6)


# -- the ranks ---------------------------------------------------------------

@pytest.mark.parametrize("prefetch", PREFETCH)
@pytest.mark.parametrize("dp", [2, 4])
def test_zero_matches_jax_and_dense_including_rank_local_overflow(
        dp, prefetch, port_runs):
    """The port's zero step at dp ranks against JAX's zero step (losses,
    each rank's shard after every step) and against the port's dense
    step on the whole batch (the reassembled master); the overflow step,
    whose inf only the last rank's rows carry, skipped on EVERY rank
    with master and slots bit-identical; the scale backed off alike."""
    tree, batches = _llama_tree(), _batches()
    ranks = [r["zero"][prefetch] for r in port_runs(dp)]
    jlosses, jmasters, jm, jv, jscale = _jax_zero_run(dp, prefetch, tree,
                                                      batches)
    for r, run in enumerate(ranks):
        assert run["losses"] == ranks[0]["losses"]
        for i in range(STEPS):
            if i != 1:
                assert abs(run["losses"][i] - jlosses[i]) <= 1e-5 * max(
                    1.0, abs(float(jlosses[i])))
            _master_close(_np(run["masters"][i]), jmasters[r, i], i + 1)
        # the overflow step: bit-identical on every rank, finite shard or
        # not (the flag is all-reduced)
        for key in ("masters", "m", "v"):
            assert torch.equal(run[key][1], run[key][0]), key
        assert run["scale"] == float(jscale) == 2.0 ** 15
    assert not all(r["finite"][1] for r in ranks)
    assert any(r["finite"][1] for r in ranks)
    # the port's dense step on the whole batch (poisoned step included)
    tx = tfunctional.fused_adam(lr=LR)
    state = ttrain.init_train_state(tx, _port_model(tree),
                                    loss_scale="dynamic")
    step = ttrain.make_train_step(_port_loss, tx)
    for i in range(STEPS):
        state, loss = step(state, _rank_batch(batches, i, 0, 1))
        if i != 1:
            assert abs(float(loss) - ranks[0]["losses"][i]) <= 1e-5 * max(
                1.0, float(loss))
    _master_close(_np(ranks[0]["full"]), _np(state.opt.master), STEPS)
    for run in ranks[1:]:
        assert torch.equal(run["full"], ranks[0]["full"])


@pytest.mark.parametrize("prefetch", PREFETCH)
@pytest.mark.parametrize("dp", [2, 4])
def test_init_zero_train_state_global_view_roundtrip(dp, prefetch,
                                                     port_runs):
    """``init_zero_train_state`` on each rank: its shard is JAX's rank
    slice, the specs mark the master and the flat slots, and
    ``state.params()`` reassembles the construction tree."""
    tree = _llama_tree()
    gview, shard_len, spans = _jax_global_view(dp, prefetch, tree)
    for r, run in enumerate(port_runs(dp)):
        view = run["view"][prefetch]
        assert view["spans"] == spans
        np.testing.assert_array_equal(
            _np(view["master"]), gview[r * shard_len:(r + 1) * shard_len])
        assert view["specs"]["opt"] == {
            "master": "data", "count": None,
            "slots": {"exp_avg": "data", "exp_avg_sq": "data"}}
        got = view["params"]
        np.testing.assert_array_equal(
            _np(got["lm_head"]["weight"]), tree["lm_head"]["weight"])
        np.testing.assert_array_equal(
            _np(got["layer_1"]["mlp"]["down_proj"]["weight"]),
            tree["layer_1"]["mlp"]["down_proj"]["weight"])


@pytest.mark.parametrize("dp", [2, 4])
def test_zero_aux_floats_averaged_ints_rank_local(dp, port_runs):
    batches = _batches()
    ranks = [r["aux"] for r in port_runs(dp)]
    want = float(batches["tokens"][0].astype(np.float32).mean())
    for run in ranks:
        assert abs(run["x_mean"] - want) < 1e-6 * max(1.0, want)
        assert run["n_local"] == BATCH // dp
        assert run["n_dtype"] == torch.int32
        assert run["loss"] == ranks[0]["loss"]


@pytest.mark.parametrize("prefetch", PREFETCH)
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("dp", [2, 4])
def test_sharded_rules_match_jax(dp, rule, prefetch, port_runs):
    """Each rule's update of a rank's shard, two steps on fixed grad
    shards: Adam, SGD and Adagrad unchanged on the shard; LAMB's norms
    and trust ratios and NovoGrad's per-tensor moments from shard
    partials summed over the ranks."""
    opt_in = _opt_inputs(dp)
    jmaster, jslots = _jax_rule_run(dp, rule, prefetch, opt_in["tree"],
                                    opt_in["gshards"][prefetch])
    for r, run in enumerate(port_runs(dp)):
        got = run["rules"][rule, prefetch]
        np.testing.assert_allclose(_np(got["master"]),
                                   np.asarray(jmaster)[r], rtol=1e-5,
                                   atol=1e-6)
        for k, v in got["slots"].items():
            np.testing.assert_allclose(_np(v), np.asarray(jslots[k])[r],
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dp", [2, 4])
def test_unscale_flag_is_all_reduced_max(dp, port_runs):
    """``unscale_flat_grads(axis_name="data")``: each rank's shard
    unscaled as JAX's, the flag 1 on every rank though one shard holds
    the inf."""
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from apex_tpu.amp.scaler import init_loss_scale, unscale_flat_grads
    shards = _opt_inputs(dp)["unscale"]

    def body(g):
        out, st = unscale_flat_grads(g[0], init_loss_scale("dynamic"),
                                     axis_name="data")
        return out[None], st.found_inf

    jout, jflag = _shard_map(body, dp, (P("data"),), (P("data"), P()))(
        jnp.asarray(shards))
    for r, run in enumerate(port_runs(dp)):
        got = run["unscale"]
        np.testing.assert_array_equal(_np(got["out"]), np.asarray(jout)[r])
        assert got["flag"] == float(jflag) == 1.0


@pytest.mark.parametrize("cls_name", ["DistributedFusedAdam",
                                      "DistributedFusedLAMB"])
@pytest.mark.parametrize("dp", [2, 4])
def test_distributed_optimizers_match_jax_and_dense(dp, cls_name,
                                                    port_runs):
    """Two steps on per-rank grads: every rank's params equal, and equal
    to JAX's and to the dense FusedAdam / FusedLAMB on the mean grad."""
    opt_in = _opt_inputs(dp)
    params, grads = opt_in["params"], opt_in["grads"]
    ranks = [r[cls_name]["params"] for r in port_runs(dp)]
    jax_out = _jax_dist_opt(cls_name, dp, params, grads)
    dense = {"DistributedFusedAdam": FusedAdam,
             "DistributedFusedLAMB": FusedLAMB}[cls_name](
        {k: torch.from_numpy(v) for k, v in params.items()}, lr=1e-2,
        weight_decay=0.01)
    for _ in range(2):
        want = dense.step(_unflat(torch.from_numpy(grads.mean(axis=0))))
    for got in ranks:
        for k in params:
            assert torch.equal(got[k], ranks[0][k])
            np.testing.assert_allclose(_np(got[k]), jax_out[k], rtol=1e-5,
                                       atol=1e-6)
            np.testing.assert_allclose(_np(got[k]), _np(want[k]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dp", [2, 4])
def test_distributed_adam_overflow_skip_and_bf16(dp, port_runs):
    """noop_flag=1: params and moments untouched on every rank; bf16
    params come back bf16."""
    params = _opt_params(5)
    for run in port_runs(dp):
        noop = run["noop"]
        for k in params:
            np.testing.assert_array_equal(_np(noop["params"][k]), params[k])
        for k in ("master", "exp_avg", "exp_avg_sq"):
            assert torch.equal(noop["state"][k], noop["before"][k])
        assert all(v.dtype == torch.bfloat16
                   for v in run["bf16"]["params"].values())


@pytest.mark.parametrize("cls_name", ["DistributedFusedAdam",
                                      "DistributedFusedLAMB"])
def test_checkpoint_at_dp4_restores_at_dp2(cls_name, port_runs):
    """A dp = 4 checkpoint (the full unpadded master and moments,
    reassembled by an all-gather) restores on dp = 2 ranks: their
    re-sharded state reassembles to the same buffers, and one more step
    there matches the dense optimizer restored from the same buffers."""
    four = port_runs(4)[0][cls_name]["ckpt"]
    two = port_runs(2)
    for run in two:
        assert set(run[f"resume {cls_name}"]["ckpt"]) == set(four)
    got = two[0][f"resume {cls_name}"]
    assert got["ckpt"]["step"] == four["step"] + 1 == 3
    dense = {"DistributedFusedAdam": FusedAdam,
             "DistributedFusedLAMB": FusedLAMB}[cls_name](
        {k: torch.zeros(s) for k, s in (("b", B_SHAPE), ("w", W_SHAPE))},
        lr=1e-2, weight_decay=0.01)
    dense.load_state_dict({"step": four["step"], "groups": [{
        "master": torch.from_numpy(four["master"]),
        "state": {k: torch.from_numpy(four[k])
                  for k in ("exp_avg", "exp_avg_sq")}, "options": {}}]})
    want = dense.step(_unflat(torch.from_numpy(
        _rank_grads(2, 6, 0.05).mean(axis=0))))
    for k in ("b", "w"):
        np.testing.assert_allclose(_np(got["params"][k]), _np(want[k]),
                                   rtol=1e-5, atol=1e-6)
    for run in two[1:]:
        for k in ("b", "w"):
            assert torch.equal(run[f"resume {cls_name}"]["params"][k],
                               got["params"][k])
