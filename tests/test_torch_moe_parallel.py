"""The port's MoE expert and tensor parallelism against the JAX package
(CPU, four gloo ranks).

The counterparts of ``tests/L0/run_transformer/test_moe.py``'s sharded
tests.  The port's ranks run one process a rank over gloo with CPU
tensors, in one spawn of four ranks that rebuilds the topology for each
case (ep = 4; ep = 2 x dp = 2; tp = 2 x ep = 2 with and without
sequence parallelism; cp = 2 x dp = 2; pp = 2 x ep = 2); the JAX side
runs here, as its own tests run it, on the 8-device CPU mesh under
``jax.shard_map`` where it shards, and its dense ep = 1 layer where it
is the reference:

* ``MoELayer`` at ep = 4 and at ep = 2 (x dp = 2), both dispatch modes,
  each shard's output against the JAX layer's at ep = 4 on the same
  shard, on the weights JAX's ep = 4 ranks drew (gathered and resharded
  by expert);
* tp = 2 x ep = 2, with and without SP: the output, the router's grads
  (equal on the tensor ranks), the experts' ffn-shard grads and the
  input's against the JAX dense layer;
* ``reduce_moe_grads``: the expert leaves' 1/ep scale against a dense
  ep = 1 replay of the ranks' mean loss, the router replicas equal bit
  for bit after it, and the context axis joining both reductions;
* the GPT with the MoE FFN at ep = 2 (x dp = 2) through
  ``shard_moe_params``: the mean loss and the reduced grads against the
  JAX GPT at ep = 1 on the whole batch;
* 1F1B and the interleaved executor with an ep = 2 MoE stage (pp = 2 x
  ep = 2) against no pipelining, on the port's executors.

Tolerances: outputs within rtol and atol 2e-4 (JAX's tests' limit);
losses within rtol 2e-5; grads within 2e-5 of each leaf's largest
magnitude (fp32 in another order), the pipelined ones within JAX's
rtol 1e-4 / atol 1e-5 of no pipelining; replicas bit for bit; routing
exact, fair where each shard's top-k margin is at least
``test_torch_moe.MIN_MARGIN`` (asserted here on the router's inputs).
"""
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch.inference.weights import (load_jax_params,
                                              shard_moe_params)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.moe import MoELayer, reduce_moe_grads
from apex_tpu_torch.transformer.testing.distributed_test_base import \
    spawn_ranks
from apex_tpu_torch.transformer.testing.standalone_gpt import (GPTConfig,
                                                               GPTModel)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

E, H, F, K = 4, 8, 16, 2
TOL_OUT = 2e-4
RTOL = 2e-5
TOL_GRAD = 2e-5
MIN_MARGIN = 1e-5
T_LOCAL, CAP = 8, 8
#: JAX's ep = 4 mesh: dp = 2 x ep = 4, shard d * 4 + e
SHARDS = 8
GPT = dict(vocab_size=64, hidden_size=16, num_layers=2,
           num_attention_heads=2, max_seq_length=8, hidden_dropout=0.0,
           attention_dropout=0.0, num_moe_experts=4, moe_top_k=2,
           moe_capacity_factor=2.0)      # E / k: no token is dropped
GPT_BATCH = 4
PP_MICRO, PP_MB, PP_HID = 4, 4, 8


def _randn(seed, *shape):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _np(tree):
    import jax
    return jax.tree_util.tree_map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _margin(x, w, k=K):
    p = x.astype(np.float64) @ w.T.astype(np.float64)
    p = np.exp(p - p.max(-1, keepdims=True))
    s = -np.sort(-(p / p.sum(-1, keepdims=True)), axis=-1)
    return float((s[:, k - 1] - s[:, k]).min())


def _close(got, want, tol=TOL_GRAD):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    return np.abs(got - want).max() <= tol * max(np.abs(want).max(), 1e-30)


def _experts_slice(tree, lo, n, ffn=None):
    """The layer tree with experts ``lo .. lo + n`` (and, with ``ffn = (t,
    tp)``, the ffn shard t of tp, bias-free)."""
    ex = {k: v[lo:lo + n] for k, v in tree["experts"].items()}
    if ffn is not None:
        t, tp = ffn
        f = ex["w1"].shape[-1] // tp
        ex = {"w1": ex["w1"][:, :, t * f:(t + 1) * f],
              "w2": ex["w2"][:, t * f:(t + 1) * f, :]}
    return {"router": tree["router"], "experts": ex}


def _layer(tree, **kw):
    layer = MoELayer(E, H, F, top_k=K, device="cpu", **kw)
    load_jax_params(layer, tree)
    return layer


# -- the JAX side (JAX imported here only) -------------------------------

@functools.lru_cache(maxsize=None)
def _jax_ep4(mode):
    """JAX's ep = 4 layer on the 8-device mesh (dp = 2 x ep = 4): the
    tokens [8 * T_LOCAL, H], the outputs, and the global weights the
    expert ranks drew (gathered along the expert dim)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.moe import MoELayer as JMoE
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(expert_model_parallel_size_=4)
    try:
        tokens = _randn(2, SHARDS * T_LOCAL, H)
        layer = JMoE(num_experts=E, hidden_size=H, ffn_hidden_size=F,
                     top_k=K, capacity=CAP, expert_parallel_size=4,
                     dispatch_mode=mode)

        def body(x):
            params = layer.init(jax.random.key(3), x)
            y, _ = layer.apply(params, x)
            p = params["params"]
            return (y, p["router"]["weight"], p["experts"]["w1"],
                    p["experts"]["b1"], p["experts"]["w2"],
                    p["experts"]["b2"])

        y, wr, w1, b1, w2, b2 = jax.jit(functools.partial(
            jax.shard_map, check_vma=False)(
                body, mesh=jps.get_mesh(),
                in_specs=(P(("data", "expert")),),
                out_specs=(P(("data", "expert")), P(), P("expert"),
                           P("expert"), P("expert"), P("expert"))))(tokens)
        tree = _np({"router": {"weight": wr},
                    "experts": {"w1": w1, "b1": b1, "w2": w2, "b2": b2}})
        return tokens, np.asarray(y), tree
    finally:
        jps.destroy_model_parallel()


def _jax_dense(tree, xs, bias=True):
    """JAX's dense ep = 1 layer on each shard of ``xs``: the outputs, the
    grads of each shard's ``sum(y^2)`` in the params and the shard, and
    the grads of the shards' mean loss (the replay)."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.moe import MoELayer as JMoE
    layer = JMoE(num_experts=E, hidden_size=H, ffn_hidden_size=F, top_k=K,
                 capacity=CAP)
    ex = dict(tree["experts"])
    if not bias:
        ex.update(b1=np.zeros((E, 1, F), np.float32),
                  b2=np.zeros((E, 1, H), np.float32))
    params = {"params": {"router": tree["router"], "experts": ex}}

    def one(p, x):
        y, _ = layer.apply(p, x)
        return jnp.sum(y * y), y

    ys, grads, gxs = [], [], []
    for x in xs:
        (_, y), (gp, gx) = jax.value_and_grad(one, argnums=(0, 1),
                                              has_aux=True)(params, x)
        ys.append(np.asarray(y))
        grads.append(_flat(_np(gp)["params"]))
        gxs.append(np.asarray(gx))
    mean = {k: np.mean([g[k] for g in grads], axis=0) for k in grads[0]}
    return ys, grads, gxs, mean


@functools.lru_cache(maxsize=None)
def _jax_gpt():
    """The JAX GPT with the MoE FFN at ep = 1 on the whole batch: params,
    loss and grads."""
    import jax
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.testing.standalone_gpt import (
        GPTConfig as JCfg, gpt_model_provider)
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(1)
    try:
        model = gpt_model_provider(JCfg(**GPT))
        toks, labels = _gpt_batch()
        params = model.init(jax.random.key(0), toks, labels)
        loss, grads = jax.value_and_grad(
            lambda p: model.apply(p, toks, labels))(params)
        return _np(params), float(loss), _flat(_np(grads)["params"])
    finally:
        jps.destroy_model_parallel()


def _gpt_batch():
    rng = np.random.RandomState(51)
    toks = rng.randint(0, GPT["vocab_size"],
                       size=(GPT_BATCH, 8)).astype(np.int64)
    return toks, np.roll(toks, -1, axis=1)


# -- the port's ranks ----------------------------------------------------

def _shards_of(rank):
    """The two of the 8 shards a rank runs, in turn: rank r takes shards
    r and r + 4 (every expert group runs two passes alike)."""
    return (rank, rank + 4)


def _ep_case(inp, ep, rank):
    """MoELayer at ep on this rank's two shards, each mode."""
    e = ps.get_expert_model_parallel_rank()
    out = {}
    for mode in ("onehot", "gather"):
        tokens, _, tree = inp["ep4"][mode]
        layer = _layer(_experts_slice(tree, e * E // ep, E // ep),
                       capacity=CAP, expert_parallel_size=ep,
                       dispatch_mode=mode)
        out[mode] = {s: layer(torch.from_numpy(
            tokens[s * T_LOCAL:(s + 1) * T_LOCAL]))[0].detach()
            for s in _shards_of(rank)}
    return out


def _tp_ep_case(inp, sp):
    """tp = 2 x ep = 2 (dp = 1): ep rank e runs shard e, its tensor ranks
    the same tokens (with SP, sequence-sharded [s/tp, b, h]); the output,
    the router's and the input's grads of sum(y^2), the experts' ffn
    shard grads (ep rank e's experts, from both shards' losses)."""
    e = ps.get_expert_model_parallel_rank()
    t = ps.get_tensor_model_parallel_rank()
    x = inp["tp_x"][e]                                   # [s, b, h]
    layer = _layer(_experts_slice(inp["tp_tree"], e * 2, 2, (t, 2)),
                   capacity=CAP, expert_parallel_size=2,
                   tensor_parallel_size=2, sequence_parallel=sp)
    s_loc = x.shape[0] // 2
    xin = x[t * s_loc:(t + 1) * s_loc] if sp else x
    xt = torch.from_numpy(np.ascontiguousarray(xin)).requires_grad_()
    y, _ = layer(xt)
    (y * y).sum().backward()
    return dict(y=y.detach(), gx=xt.grad,
                grads={n: p.grad for n, p in layer.named_parameters()})


def _reduce_case(inp, cp):
    """reduce_moe_grads at ep = 4 (cp = 1) or cp = 2 x dp = 2 (ep = 1):
    each rank its shard, raw grads of its local sum(y^2), then reduced
    by the live topology's axes."""
    r = dist.get_rank()
    tree = inp["red_tree"]
    if cp == 1:
        layer = _layer(_experts_slice(tree, r, 1), capacity=CAP,
                       expert_parallel_size=4)
    else:
        layer = _layer(tree, capacity=CAP)
    y, _ = layer(torch.from_numpy(inp["red_x"][r]))
    (y * y).sum().backward()
    raw = {n: p.grad.clone() for n, p in layer.named_parameters()}
    grads = {n: p.grad for n, p in layer.named_parameters()}
    assert reduce_moe_grads(grads) is grads
    return dict(raw=raw, red=grads)


def _gpt_case(inp):
    """The GPT at ep = 2 x dp = 2: rank r its sequence, its ep rank's
    experts (``shard_moe_params``); the loss and reduced grads."""
    e = ps.get_expert_model_parallel_rank()
    r = dist.get_rank()
    model = GPTModel(GPTConfig(**GPT, expert_model_parallel=True),
                     device="cpu")
    load_jax_params(model, shard_moe_params(inp["gpt_params"], 2, e))
    toks, labels = (torch.from_numpy(a[r:r + 1]) for a in _gpt_batch())
    inter = {}
    loss = model(toks, labels, intermediates=inter)
    loss.backward()
    grads = reduce_moe_grads({n: p.grad for n, p in
                              model.named_parameters()})
    mean = loss.detach().clone()
    dist.all_reduce(mean)
    return dict(loss=mean.item() / dist.get_world_size(), grads=grads,
                aux=sorted(inter))


def _pp_stage(p, x, mb):
    return torch.func.functional_call(_PP_MOE[0], p, (x,))[0]


def _pp_loss(y, mb):
    return torch.mean((y - mb["target"]) ** 2)


_PP_MOE: list = []


def _pp_params(stage: int):
    """Virtual stage ``stage``'s MoE params on this expert rank: a layer
    drawn from a generator seeded by the stage (the expert rank folded
    in by the layer), the same on every pipe rank."""
    layer = MoELayer(E, PP_HID, 16, top_k=K, capacity=2 * PP_MB,
                     expert_parallel_size=2, device="cpu",
                     generator=torch.Generator().manual_seed(31 + stage))
    _PP_MOE[:] = [layer]
    return {n: p.detach().clone() for n, p in layer.named_parameters()}


def _pp_case(inp):
    from apex_tpu_torch.transformer import pipeline_parallel as tpp
    pp, r = 2, ps.get_pipeline_model_parallel_rank()
    batch = {k: torch.from_numpy(v) for k, v in inp["pp_batch"].items()}
    input_fn = lambda mb: mb["x"]                         # noqa: E731
    stages = [_pp_params(s) for s in range(2 * pp)]
    out = {}
    # 1F1B: stage r, against both stages run in turn
    l_pipe, g_pipe = tpp.forward_backward_pipelining_without_interleaving(
        _pp_stage, _pp_loss, stages[r], batch, num_microbatches=PP_MICRO,
        input_fn=input_fn)

    def full(p_all, x, mb):
        for s in range(pp):
            x = _pp_stage(p_all[f"s{s}"], x, mb)
        return x

    l_ref, g_ref = tpp.forward_backward_no_pipelining(
        full, _pp_loss, {"s0": stages[0], "s1": stages[1]}, batch,
        num_microbatches=PP_MICRO, input_fn=input_fn)
    out["1f1b"] = dict(loss=(float(l_pipe) if l_pipe is not None else None,
                             float(l_ref)),
                       grads=(g_pipe, g_ref[f"s{r}"]))
    # interleaved, v = 2: chunk c on rank r is virtual stage c * pp + r
    chunks = {n: torch.stack([stages[c * pp + r][n] for c in range(2)])
              for n in stages[0]}
    l_v, g_v = tpp.forward_backward_pipelining_with_interleaving(
        _pp_stage, _pp_loss, chunks, batch, num_microbatches=PP_MICRO,
        input_fn=input_fn, virtual_pipeline_model_parallel_size=2)

    def full4(p_all, x, mb):
        for s in range(2 * pp):
            x = _pp_stage(p_all[f"s{s}"], x, mb)
        return x

    l_ref4, g_ref4 = tpp.forward_backward_no_pipelining(
        full4, _pp_loss, {f"s{s}": p for s, p in enumerate(stages)}, batch,
        num_microbatches=PP_MICRO, input_fn=input_fn)
    out["interleaved"] = dict(
        loss=(float(l_v) if l_v is not None else None, float(l_ref4)),
        grads=(g_v, {n: torch.stack([g_ref4[f"s{c * pp + r}"][n]
                                     for c in range(2)])
                     for n in stages[0]}))
    return out


def _topology(**sizes):
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(**sizes)


def _rank_main(rank, inp):
    out = {"ep4": _ep_case(inp, 4, rank)}
    _topology(expert_model_parallel_size_=2)             # dp = 2
    out["ep2"] = _ep_case(inp, 2, rank)
    out["gpt"] = _gpt_case(inp)
    _topology(tensor_model_parallel_size_=2, expert_model_parallel_size_=2)
    out["tp_ep"] = {sp: _tp_ep_case(inp, sp) for sp in (False, True)}
    _topology(expert_model_parallel_size_=4)
    out["red_ep"] = _reduce_case(inp, 1)
    _topology(context_parallel_size_=2)                  # dp = 2
    out["red_cp"] = _reduce_case(inp, 2)
    _topology(pipeline_model_parallel_size_=2,
              expert_model_parallel_size_=2)
    out["pp"] = _pp_case(inp)
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    import jax
    from apex_tpu.transformer.moe import MoELayer as JMoE
    inp = {"ep4": {m: _jax_ep4(m) for m in ("onehot", "gather")}}
    # one dense layer's weights for the tp, reduction cases (ep = 1 init)
    x0 = _randn(9, 16, H)
    tree = _np(JMoE(num_experts=E, hidden_size=H, ffn_hidden_size=F,
                    top_k=K, capacity=CAP).init(jax.random.key(9), x0))
    inp["tp_tree"] = inp["red_tree"] = tree["params"]
    inp["tp_x"] = [_randn(10 + e, 8, 2, H) for e in range(2)]   # [s, b, h]
    inp["red_x"] = [_randn(20 + r, T_LOCAL, H) for r in range(4)]
    inp["gpt_params"] = _jax_gpt()[0]
    inp["pp_batch"] = {"x": _randn(30, PP_MICRO, PP_MB, PP_HID),
                       "target": np.full((PP_MICRO, PP_MB, PP_HID), 0.1,
                                         np.float32)}
    ranks = spawn_ranks(4, _rank_main, inp, expert_model_parallel_size=4,
                        tmp_dir=str(tmp_path_factory.mktemp("moe")))
    return inp, ranks


# -- the tests -----------------------------------------------------------

@pytest.mark.parametrize("ep", [4, 2])
@pytest.mark.parametrize("mode", ["onehot", "gather"])
def test_moe_ep_matches_jax_ep4_per_shard(port_runs, mode, ep):
    """The all-to-all round trip: each shard's output at ep (the experts
    resharded from JAX's ep = 4 draw) is JAX's ep = 4 output for that
    shard; the folded init gave JAX's ranks different experts."""
    inp, ranks = port_runs
    tokens, jy, tree = inp["ep4"][mode]
    assert not np.allclose(tree["experts"]["w1"][0], tree["experts"]["w1"][1])
    for rank, r in enumerate(ranks):
        for s, y in r[f"ep{ep}"][mode].items():
            x = tokens[s * T_LOCAL:(s + 1) * T_LOCAL]
            assert _margin(x, tree["router"]["weight"]) >= MIN_MARGIN
            np.testing.assert_allclose(
                y.numpy(), jy[s * T_LOCAL:(s + 1) * T_LOCAL], rtol=TOL_OUT,
                atol=TOL_OUT)


@pytest.mark.parametrize("sp", [False, True])
def test_moe_tp_ep_matches_jax_dense(port_runs, sp):
    """tp = 2 x ep = 2 (+/- SP): the ffn shards' partials summed before
    the combine give JAX's dense output; the router's and the input's
    grads equal on the two tensor ranks and JAX's; each expert rank's
    ffn-shard grads the slices of JAX's grads of both shards' losses."""
    inp, ranks = port_runs
    tree = inp["tp_tree"]
    xs = [x.reshape(-1, H) for x in inp["tp_x"]]
    for x in xs:
        assert _margin(x, tree["router"]["weight"]) >= MIN_MARGIN
    ys, grads, gxs, _ = _jax_dense(tree, xs, bias=False)
    for rank, r in enumerate(ranks):
        e, t = rank // 2, rank % 2                 # rank = e * tp + t
        got = r["tp_ep"][sp]
        s_loc = inp["tp_x"][e].shape[0] // 2
        want_y = ys[e].reshape(inp["tp_x"][e].shape)
        want_gx = gxs[e].reshape(inp["tp_x"][e].shape)
        if sp:
            want_y = want_y[t * s_loc:(t + 1) * s_loc]
            want_gx = want_gx[t * s_loc:(t + 1) * s_loc]
        np.testing.assert_allclose(got["y"].numpy(), want_y, rtol=TOL_OUT,
                                   atol=TOL_OUT)
        assert _close(got["gx"], want_gx)
        assert _close(got["grads"]["router.weight"],
                      grads[e]["router.weight"])
        f = F // 2
        for name, sl in (("w1", np.s_[2 * e:2 * e + 2, :, t * f:(t + 1) * f]),
                         ("w2", np.s_[2 * e:2 * e + 2, t * f:(t + 1) * f])):
            want = grads[0][f"experts.{name}"] + grads[1][f"experts.{name}"]
            assert _close(got["grads"][f"experts.{name}"], want[sl]), name
        assert "experts.b1" not in got["grads"]    # bias-free at tp > 1
    for e in range(2):
        a, b = ranks[2 * e]["tp_ep"][sp], ranks[2 * e + 1]["tp_ep"][sp]
        assert torch.allclose(a["grads"]["router.weight"],
                              b["grads"]["router.weight"], rtol=1e-5,
                              atol=1e-6)


def test_reduce_moe_grads_expert_scale_matches_dense_replay(port_runs):
    """At ep = 4 the loss is the mean of the ranks' shard losses: the
    reduced router grads are the replay's (and bit for bit on every
    rank), the reduced expert grads the replay's slice (the raw ones
    are ep = 4 times too large after a mean over one replica)."""
    inp, ranks = port_runs
    tree = inp["red_tree"]
    for x in inp["red_x"]:
        assert _margin(x, tree["router"]["weight"]) >= MIN_MARGIN
    _, _, _, mean = _jax_dense(tree, inp["red_x"])
    red = [r["red_ep"]["red"] for r in ranks]
    raw = [r["red_ep"]["raw"] for r in ranks]
    assert not torch.equal(raw[0]["router.weight"], raw[1]["router.weight"])
    for rank in range(4):
        assert torch.equal(red[rank]["router.weight"],
                           red[0]["router.weight"])
        assert _close(red[rank]["router.weight"], mean["router.weight"])
        for name in ("w1", "b1", "w2", "b2"):
            want = mean[f"experts.{name}"][rank:rank + 1]
            assert _close(red[rank][f"experts.{name}"], want), name
            assert _close(raw[rank][f"experts.{name}"], 4 * want), name


def test_reduce_moe_grads_spans_the_context_axis(port_runs):
    """At cp = 2 x dp = 2 each rank routes its own shard through
    replicated weights: router and expert grads both reduce over data
    and context (the defaults read the live topology), to the replay's
    mean, equal on every rank."""
    inp, ranks = port_runs
    _, _, _, mean = _jax_dense(inp["red_tree"], inp["red_x"])
    red = [r["red_cp"]["red"] for r in ranks]
    raw = [r["red_cp"]["raw"] for r in ranks]
    assert not torch.equal(raw[0]["router.weight"], raw[1]["router.weight"])
    for rank in range(4):
        for name, g in red[rank].items():
            assert torch.equal(g, red[0][name]), name
            assert _close(g, mean[name]), name


def test_gpt_moe_at_ep2_matches_the_jax_gpt(port_runs):
    """The GPT at ep = 2 x dp = 2 through ``shard_moe_params``: the mean
    of the ranks' losses is the JAX GPT's loss on the whole batch, and
    after ``reduce_moe_grads`` every dense and router grad is JAX's (the
    same on every rank), every expert grad the rank's slice of JAX's."""
    _, ranks = port_runs
    _, jloss, jgrads = _jax_gpt()
    for rank, r in enumerate(ranks):
        got = r["gpt"]
        np.testing.assert_allclose(got["loss"], jloss, rtol=RTOL)
        assert got["aux"] == sorted(f"layer_{i}.{k}" for i in range(2)
                                    for k in ("moe_lb_loss", "moe_z_loss"))
        e = rank % 2                         # rank = dp_rank * ep + e
        for name, g in got["grads"].items():
            want = jgrads[name]
            if ".experts." in name:
                want = want[2 * e:2 * e + 2]
            else:
                assert torch.equal(g, ranks[0]["gpt"]["grads"][name]), name
            assert _close(g, want), name


@pytest.mark.parametrize("schedule", ["1f1b", "interleaved"])
def test_pipelined_ep2_moe_stage_matches_no_pipelining(port_runs, schedule):
    """pp = 2 x ep = 2: the executors run a stage whose body exchanges
    tokens over the expert group, and give no pipelining's loss and
    grads (JAX's test_{1f1b,interleaved}_with_expert_parallel_moe_stage)."""
    _, ranks = port_runs
    for r in ranks:
        (l_pipe, l_ref), (g_pipe, g_ref) = (r["pp"][schedule]["loss"],
                                            r["pp"][schedule]["grads"])
        if l_pipe is not None:                  # the last stage's ranks
            np.testing.assert_allclose(l_pipe, l_ref, rtol=1e-5)
        assert sorted(g_pipe) == sorted(g_ref)
        for n in g_pipe:
            torch.testing.assert_close(g_pipe[n], g_ref[n], rtol=1e-4,
                                       atol=1e-5)
