"""The port's MoE modules against the JAX package's (CPU, one process).

``apex_tpu_torch.transformer.moe`` (router, dispatch forms, GroupedMLP,
MoELayer) and the GPT's MoE FFN held against
``apex_tpu/transformer/moe`` and the JAX GPT on the same numpy inputs and
the same weights (the JAX tree loaded into the port's modules): the
router's three routing types at top-1 and top-2 (and huge logits under
sinkhorn), the tie order of top-k, both dispatch forms (integers and 0/1
values, exactly), capacity drops, k-major priority and the capacity
formula's float arithmetic, MoELayer at ep = 1 in both dispatch modes
(output, aux losses, diagnostics, grads; bf16 too), the expert init's
per-expert statistics, the ``"auto"`` policy, and the GPT with the MoE
FFN in the loop and scan layouts, with and without ``remat``.  The
expert-parallel and tensor-parallel counterparts are in
``tests/test_torch_moe_parallel.py``.

Tolerances: fp32 losses and aux losses within rtol 2e-5; outputs within
rtol and atol 2e-4 (JAX's own tests' limit); grads within 2e-5 of each
leaf's largest magnitude (fp32 in another order); routing (expert ids,
slots, drops) exactly, which is fair only where no two router
probabilities of a token are closer than the two implementations' fp32
rounding: each test asserts its data's top-k margin (at least
``MIN_MARGIN``) before it demands exact routing.  bf16 outputs within
3e-2 of the output's largest magnitude (two bf16 computations whose
products accumulate in other orders).
"""
import functools
import math

import numpy as np
import pytest
import torch

from apex_tpu_torch.inference.weights import (gpt_param_shapes,
                                              load_jax_params,
                                              params_from_jax,
                                              shard_moe_params,
                                              to_loop_layout,
                                              to_scan_layout)
from apex_tpu_torch.transformer import moe as tmoe
from apex_tpu_torch.transformer.moe import layer as tlayer
from apex_tpu_torch.transformer.moe import router as trouter
from apex_tpu_torch.transformer.moe.experts import expert_init
from apex_tpu_torch.transformer.testing.standalone_gpt import (GPTConfig,
                                                               GPTModel)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

E, H, F, K = 4, 8, 16, 2
RTOL = 2e-5
TOL_OUT = 2e-4
TOL_GRAD = 2e-5
TOL_BF16 = 3e-2
#: the least gap between a token's k-th and (k+1)-th router probability
#: at which exact routing is demanded of two fp32 implementations
MIN_MARGIN = 1e-5


def _randn(seed, *shape, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


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


def _margin(probs: np.ndarray, k: int) -> float:
    """The least gap between a row's k-th and (k+1)-th largest value."""
    s = -np.sort(-probs.astype(np.float64), axis=-1)
    return float((s[:, k - 1] - s[:, k]).min()) if s.shape[1] > k else 1.0


def _softmax(logits):
    z = np.exp(logits - logits.max(-1, keepdims=True))
    return z / z.sum(-1, keepdims=True)


def _close_grads(got: dict, want: dict, tol=TOL_GRAD):
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = np.asarray(want[name], np.float32)
        g = g.detach().float().numpy() if isinstance(g, torch.Tensor) else g
        assert g.shape == w.shape, name
        assert np.abs(g - w).max() <= tol * max(np.abs(w).max(), 1e-30), name


# -- the router -----------------------------------------------------------

def _jax_router(x, lb, k, seed=24):
    import jax
    from apex_tpu.transformer.moe.router import TopKRouter as JRouter
    r = JRouter(num_experts=E, top_k=k, load_balancing_type=lb)
    params = r.init(jax.random.key(seed), x)
    gates, idx, aux = r.apply(params, x)
    return _np(params)["params"], np.asarray(gates), np.asarray(idx), \
        {n: float(v) for n, v in aux.items()}


def _port_router(w, x, lb, k):
    r = trouter.TopKRouter(E, x.shape[-1], top_k=k, load_balancing_type=lb,
                           device="cpu")
    load_jax_params(r, {"weight": w})
    return r(torch.from_numpy(x))


@pytest.mark.parametrize("lb,k", [("aux_loss", 1), ("aux_loss", 2),
                                  ("none", 2), ("sinkhorn", 1)])
def test_router_matches_jax(lb, k):
    x = _randn(20, 32, H)
    p, gates, idx, aux = _jax_router(x, lb, k)
    logits = x.astype(np.float64) @ p["weight"].T.astype(np.float64)
    sel = _softmax(logits)
    if lb == "sinkhorn":
        from apex_tpu.transformer.moe.router import sinkhorn as jsinkhorn
        sel = np.asarray(jsinkhorn(np.exp(logits - logits.max(-1,
                                                              keepdims=True))
                                   .astype(np.float32)))
    assert _margin(sel, k) >= MIN_MARGIN
    g, i, a = _port_router(p["weight"], x, lb, k)
    np.testing.assert_array_equal(i.numpy(), idx)
    np.testing.assert_allclose(g.detach().numpy(), gates, rtol=RTOL,
                               atol=1e-7)
    assert sorted(a) == sorted(aux)
    for name, v in aux.items():
        np.testing.assert_allclose(a[name].item(), v, rtol=RTOL, atol=1e-7)
    if lb != "aux_loss":
        assert float(a["load_balancing_loss"]) == 0.0


def test_router_weight_is_fp32_whatever_the_params_dtype():
    layer = tmoe.MoELayer(E, H, F, params_dtype=torch.bfloat16, device="cpu")
    assert layer.router.weight.dtype == torch.float32
    assert layer.experts.w1.dtype == torch.bfloat16
    y, _ = layer(torch.randn(16, H).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16


def test_top_k_takes_the_lower_index_on_ties():
    """``jax.lax.top_k`` takes the lower index among equal values; so
    does the port's selection, in the helper and through the router (a
    weight whose rows repeat gives tied probabilities)."""
    import jax
    import jax.numpy as jnp
    v = np.array([[0.3, 0.3, 0.4, 0.3], [0.25, 0.25, 0.25, 0.25],
                  [0.1, 0.5, 0.5, 0.5]], np.float32)
    for k in (1, 2, 3):
        jv, ji = jax.lax.top_k(jnp.asarray(v), k)
        tv, ti = trouter.top_k(torch.from_numpy(v), k)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    x = _randn(21, 16, H)
    w = np.repeat(_randn(22, 2, H), 2, axis=0)          # rows 0=1, 2=3
    from apex_tpu.transformer.moe.router import TopKRouter as JRouter
    for k in (1, 2):
        _, jidx, _ = JRouter(num_experts=E, top_k=k).apply(
            {"params": {"weight": w}}, x)
        _, idx, _ = _port_router(w, x, "aux_loss", k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        # the tie is real, and broken toward the lower index
        assert set(np.unique(idx.numpy()[:, 0])) <= {0, 2}


def test_sinkhorn_matches_jax():
    from apex_tpu.transformer.moe.router import sinkhorn as jsinkhorn
    cost = np.exp(_randn(23, 64, E))
    np.testing.assert_allclose(
        trouter.sinkhorn(torch.from_numpy(cost)).numpy(),
        np.asarray(jsinkhorn(cost)), rtol=1e-5, atol=1e-9)
    # skewed logits: the balanced assignment spreads tokens
    logits = _randn(24, 256, E) * 0.1
    logits[:, 0] += 5.0
    idx = tmoe.sinkhorn(torch.from_numpy(np.exp(logits))).argmax(-1)
    assert np.bincount(idx.numpy(), minlength=E).max() <= 2 * 256 // E


def test_sinkhorn_router_survives_huge_logits():
    """Raw exp(logits) overflows fp32 past ~88: the row max is shifted out
    first, and the assignment stays finite and JAX's."""
    x = _randn(25, 16, H) * 1500.0
    p, gates, idx, _ = _jax_router(x, "sinkhorn", 1)
    assert np.abs(x @ p["weight"].T).max() > 100.0
    g, i, _ = _port_router(p["weight"], x, "sinkhorn", 1)
    assert torch.isfinite(g).all()
    np.testing.assert_array_equal(i.numpy(), idx)


def test_routing_refusals_are_jax_value_errors():
    with pytest.raises(ValueError, match="top_k=1"):
        tmoe.MoELayer(E, H, F, top_k=2, load_balancing_type="sinkhorn",
                      device="cpu")
    with pytest.raises(ValueError, match="unknown load_balancing_type"):
        trouter.TopKRouter(E, H, load_balancing_type="bogus", device="cpu")
    with pytest.raises(ValueError, match="dispatch_mode"):
        tmoe.MoELayer(E, H, F, dispatch_mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        tmoe.MoELayer(E, H, F, expert_parallel_size=3, device="cpu")


def test_aux_losses_uniform_routing():
    probs = torch.full((32, E), 1.0 / E)
    chosen = torch.zeros(32, E)
    chosen[:, :K] = 1.0
    assert abs(float(tmoe.load_balancing_loss(probs, chosen)) - 1.0) < 1e-5
    assert float(trouter.router_z_loss(torch.zeros(32, E))) >= 0.0


# -- the dispatch forms --------------------------------------------------

def _routing(seed, s, k, e=E):
    rng = np.random.RandomState(seed)
    idx = np.stack([rng.permutation(e)[:k] for _ in range(s)]).astype(
        np.int32)
    gates = rng.rand(s, k).astype(np.float32)
    return gates, idx


@pytest.mark.parametrize("cap", [1, 3, 8, 40])
@pytest.mark.parametrize("k", [1, 2])
def test_dispatch_forms_match_jax_exactly(cap, k):
    from apex_tpu.transformer.moe.layer import (
        compute_dispatch_and_combine as jdc, compute_dispatch_indices as jdi)
    gates, idx = _routing(30 + cap, 40, k)
    tg, ti = torch.from_numpy(gates), torch.from_numpy(idx).long()
    d, c = tlayer.compute_dispatch_and_combine(tg, ti, E, cap)
    jd, jc = jdc(gates, idx, E, cap)
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    st, ts, tgate = tlayer.compute_dispatch_indices(tg, ti, E, cap)
    jst, jts, jtg = jdi(gates, idx, E, cap)
    np.testing.assert_array_equal(st.numpy(), np.asarray(jst))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(jts))
    np.testing.assert_array_equal(tgate.numpy(), np.asarray(jtg))
    # the two forms route alike: each kept choice's slot holds its token
    kept = ts.numpy() < E * cap
    assert int(kept.sum()) == int(d.sum())


def test_dispatch_combine_capacity_drop():
    gates = torch.ones(3, 1)
    idx = torch.zeros(3, 1, dtype=torch.long)
    dispatch, combine = tlayer.compute_dispatch_and_combine(gates, idx, E, 2)
    assert dispatch.shape == (3, E, 2)
    assert dispatch[0, 0].tolist() == [1, 0]
    assert dispatch[1, 0].tolist() == [0, 1]
    assert dispatch[2, 0].tolist() == [0, 0]          # dropped
    assert torch.equal(combine, dispatch)
    slot_token, token_slot, _ = tlayer.compute_dispatch_indices(
        gates, idx, E, 2)
    assert slot_token[0].tolist() == [0, 1]
    assert token_slot[:, 0].tolist() == [0, 1, E * 2]   # the sentinel


def test_dispatch_k_major_priority():
    """All top-1 choices win slots before any top-2 choice."""
    gates = torch.tensor([[0.6, 0.4], [0.9, 0.1]])
    idx = torch.tensor([[0, 1], [1, 2]])
    dispatch, _ = tlayer.compute_dispatch_and_combine(gates, idx, E, 1)
    assert dispatch[1, 1].tolist() == [1]     # token 1's first choice
    assert dispatch[0, 1].tolist() == [0]     # token 0's second, dropped


@pytest.mark.parametrize("cf,s,k,e", [(1.25, 16, 2, 4), (1.1, 30, 2, 3),
                                      (0.5, 7, 1, 4), (1.25, 2048, 2, 8),
                                      (1.25, 2048, 1, 128), (3.3, 10, 2, 6)])
def test_capacity_formula(cf, s, k, e):
    """``round_up(max(1, ceil(cf * S * k / E)), 8)`` in Python floats
    (1.1 * 30 * 2 / 3 is 22.000000000000004, so 23 before the round)."""
    from apex_tpu.utils import round_up
    layer = tmoe.MoELayer(e, H, F, top_k=k, capacity_factor=cf,
                          device="cpu")
    assert layer.capacity_for(s) == round_up(
        max(1, math.ceil(cf * s * k / e)), 8)
    assert tmoe.MoELayer(e, H, F, top_k=k, capacity=5,
                         device="cpu").capacity_for(s) == 5


# -- MoELayer at ep = 1 ---------------------------------------------------

def _jax_layer_run(x, mode, cap=None, cf=1.25, dtype=None, seed=5):
    """The JAX layer's params, output, aux and the grads of
    ``sum(y^2) + 0.01 lb + 0.001 z`` in the params and ``x``."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.moe import MoELayer as JMoE
    kw = dict(params_dtype=dtype) if dtype is not None else {}
    layer = JMoE(num_experts=E, hidden_size=H, ffn_hidden_size=F, top_k=K,
                 capacity=cap, capacity_factor=cf, dispatch_mode=mode, **kw)
    xj = jnp.asarray(x) if dtype is None else jnp.asarray(x).astype(dtype)
    params = layer.init(jax.random.key(seed), xj)

    def loss_fn(p, x):
        y, aux = layer.apply(p, x)
        return (jnp.sum(y.astype(jnp.float32) ** 2)
                + 0.01 * aux["load_balancing_loss"]
                + 0.001 * aux["z_loss"], (y, aux))

    (loss, (y, aux)), (gp, gx) = jax.value_and_grad(
        loss_fn, argnums=(0, 1), has_aux=True)(params, xj)
    return (_np(params), float(loss), np.asarray(y.astype(jnp.float32)),
            {n: np.asarray(v) for n, v in aux.items()},
            _flat(_np(gp)["params"]), np.asarray(gx.astype(jnp.float32)))


def _port_layer(params, mode, cap=None, cf=1.25, dtype=torch.float32):
    layer = tmoe.MoELayer(E, H, F, top_k=K, capacity=cap, capacity_factor=cf,
                          dispatch_mode=mode, params_dtype=dtype,
                          device="cpu")
    load_jax_params(layer, params)
    return layer


def _port_layer_run(layer, x):
    xt = torch.from_numpy(x).to(layer.experts.w1.dtype).requires_grad_()
    y, aux = layer(xt)
    loss = (y.float() ** 2).sum() + 0.01 * aux["load_balancing_loss"] \
        + 0.001 * aux["z_loss"]
    loss.backward()
    grads = {n: p.grad for n, p in layer.named_parameters()}
    return loss.item(), y.detach().float().numpy(), aux, grads, \
        xt.grad.float().numpy()


def _assert_margin(params, x):
    w = np.asarray(params["params"]["router"]["weight"], np.float64)
    assert _margin(_softmax(x.astype(np.float64) @ w.T), K) >= MIN_MARGIN


@pytest.mark.parametrize("cap,cf", [(16, 1.25), (None, 1.25), (None, 0.5),
                                    (2, 1.25)])
@pytest.mark.parametrize("mode", ["onehot", "gather"])
def test_moe_layer_ep1_matches_jax(mode, cap, cf):
    x = _randn(40, 24, H)
    params, jloss, jy, jaux, jgrads, jgx = _jax_layer_run(x, mode, cap, cf)
    _assert_margin(params, x)
    loss, y, aux, grads, gx = _port_layer_run(
        _port_layer(params, mode, cap, cf), x)
    np.testing.assert_allclose(loss, jloss, rtol=RTOL)
    np.testing.assert_allclose(y, jy, rtol=TOL_OUT, atol=TOL_OUT)
    for name in ("load_balancing_loss", "z_loss"):
        np.testing.assert_allclose(float(aux[name]), float(jaux[name]),
                                   rtol=RTOL)
    # the diagnostics: slot counts over the capacity, exactly
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  jaux["expert_load"])
    np.testing.assert_allclose(float(aux["dropped_fraction"]),
                               float(jaux["dropped_fraction"]), atol=1e-7)
    assert not aux["expert_load"].requires_grad
    _close_grads(grads, jgrads)
    assert np.abs(gx - jgx).max() <= TOL_GRAD * np.abs(jgx).max()


def test_moe_layer_modes_route_and_drop_alike():
    """The two dispatch modes on one set of weights: the same drops, the
    same output and grads (one-hot and gather move the same rows)."""
    x = _randn(41, 24, H)
    params = _jax_layer_run(x, "onehot", 2)[0]
    runs = [_port_layer_run(_port_layer(params, m, 2), x)
            for m in ("onehot", "gather")]
    (l0, y0, a0, g0, x0), (l1, y1, a1, g1, x1) = runs
    assert float(a0["dropped_fraction"]) > 0.0
    assert torch.equal(a0["expert_load"], a1["expert_load"])
    np.testing.assert_allclose(y1, y0, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(l1, l0, rtol=1e-6)
    for n in g0:
        np.testing.assert_allclose(g1[n].numpy(), g0[n].numpy(), rtol=1e-5,
                                   atol=1e-6)


@pytest.mark.parametrize("mode", ["onehot", "gather"])
def test_moe_layer_bf16_matches_jax(mode):
    """bf16 parameters and activations: the dispatch and combine (or the
    gate) cast to bf16 before their products, as JAX casts them; the
    router in fp32 from the bf16 tokens."""
    import jax.numpy as jnp
    x = _randn(42, 24, H)
    params, _, jy, jaux, _, _ = _jax_layer_run(x, mode, 8,
                                               dtype=jnp.bfloat16)
    xb = np.asarray(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32))
    _assert_margin(params, xb)
    layer = _port_layer(params, mode, 8, dtype=torch.bfloat16)
    y, aux = layer(torch.from_numpy(x).to(torch.bfloat16))
    assert y.dtype == torch.bfloat16
    err = np.abs(y.detach().float().numpy() - jy).max()
    assert err <= TOL_BF16 * np.abs(jy).max()
    np.testing.assert_array_equal(aux["expert_load"].numpy(),
                                  jaux["expert_load"])
    np.testing.assert_allclose(aux["z_loss"].item(), float(jaux["z_loss"]),
                               rtol=RTOL)


def test_routing_statistics():
    n_tok, cap = 16, 32
    x = torch.from_numpy(_randn(60, n_tok, H))
    ample = tmoe.MoELayer(E, H, F, top_k=K, capacity=cap, device="cpu")
    _, aux = ample(x)
    assert aux["expert_load"].shape == (E,)
    assert abs(float(aux["dropped_fraction"])) < 1e-6
    np.testing.assert_allclose(float(aux["expert_load"].sum()) * cap,
                               n_tok * K, rtol=1e-6)
    ample.capacity = 1
    _, aux = ample(x)
    np.testing.assert_allclose(float(aux["dropped_fraction"]),
                               1.0 - E / (n_tok * K), rtol=1e-6)
    assert float(aux["expert_load"].max()) <= 1.0


def test_expert_init_per_expert_variance():
    """Each expert a full 2-D xavier draw (truncated normal, the expert
    dim a batch dim): its std within 0.8-1.2 of sqrt(2 / (h + f)), as
    JAX's test holds JAX's, and both packages' draws agree in
    distribution; no element past two of the draw's std."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.moe.experts import expert_init as jinit
    e, h, f = 8, 64, 128
    want = np.sqrt(2.0 / (h + f))
    w = expert_init(torch.empty(e, h, f),
                    generator=torch.Generator().manual_seed(0)).numpy()
    got = w.reshape(e, -1).std(axis=-1)
    assert np.all(got > 0.8 * want) and np.all(got < 1.2 * want), got
    jw = np.asarray(jinit(jax.random.key(0), (e, h, f), jnp.float32))
    np.testing.assert_allclose(got.mean(), jw.reshape(e, -1).std(-1).mean(),
                               rtol=0.03)
    assert np.abs(w).max() <= 2.0 * want / 0.87962566103423978 + 1e-6
    assert not np.allclose(w[0], w[1])


def test_expert_streams_fold_the_default_generator():
    """An expert rank's init stream without ``generator=`` folds the
    device's default generator, read on the host: the same stream as
    folding that generator by hand, one stream a rank, and the default
    generator advanced by the fold."""
    from apex_tpu_torch.transformer.tensor_parallel.random import \
        fold_generator
    saved = torch.get_rng_state()
    try:
        draw = lambda gen: torch.rand(8, generator=gen)    # noqa: E731
        torch.manual_seed(3)
        a = draw(fold_generator(None, 1, 0, device="cpu"))
        after = torch.rand(4)
        torch.manual_seed(3)
        assert torch.equal(
            draw(fold_generator(torch.default_generator, 1, 0)), a)
        assert torch.equal(torch.rand(4), after)
        torch.manual_seed(3)
        assert not torch.equal(draw(fold_generator(None, 0, 0, device="cpu")),
                               a)
        torch.manual_seed(3)
        torch.rand(1)
        assert torch.equal(torch.rand(4), after)
    finally:
        torch.set_rng_state(saved)


def test_dispatch_mode_auto_policy():
    assert tlayer._AUTO_GATHER_MIN_E == 64
    r = tmoe.resolve_dispatch_mode
    assert r("auto", 8, 256, 64, 64) == "onehot"
    assert r("auto", 32, 8192, 640, 1024) == "onehot"
    assert r("auto", 63, 256, 64, 64) == "onehot"
    assert r("auto", 64, 8192, 320, 1024) == "gather"
    assert r("auto", 256, 256, 64, 64) == "gather"
    assert r("onehot", 512, 256, 64, 64) == "onehot"
    assert r("gather", 2, 256, 64, 64) == "gather"
    from apex_tpu.transformer.moe import resolve_dispatch_mode as jr
    for args in (("auto", 8, 256, 64, 64), ("auto", 64, 8192, 320, 1024),
                 ("auto", 128, 2048, 24, 2048)):
        assert r(*args) == jr(*args)


def test_dispatch_mode_auto_matches_explicit():
    x = torch.from_numpy(_randn(43, 32, 16))
    for e, expect in ((4, "onehot"), (tlayer._AUTO_GATHER_MIN_E, "gather")):
        kw = dict(num_experts=e, hidden_size=16, ffn_hidden_size=32,
                  top_k=2, device="cpu")
        auto = tmoe.MoELayer(dispatch_mode="auto", **kw)
        explicit = tmoe.MoELayer(dispatch_mode=expect, **kw)
        explicit.load_state_dict(auto.state_dict())
        assert torch.equal(auto(x)[0], explicit(x)[0])


def test_reduce_moe_grads_without_a_topology_raises():
    grads = {"router": {"weight": torch.ones(E, H)},
             "experts": {"w1": torch.ones(E, H, F)}}
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        tmoe.reduce_moe_grads(grads)
    # explicit empty axes reduce nothing
    assert tmoe.reduce_moe_grads(grads, dense_axes=(), expert_axes=()) \
        is grads
    assert float(grads["experts"]["w1"].max()) == 1.0


# -- the GPT with the MoE FFN ---------------------------------------------

GPT = dict(vocab_size=64, hidden_size=16, num_layers=2,
           num_attention_heads=2, max_seq_length=8, hidden_dropout=0.0,
           attention_dropout=0.0, num_moe_experts=4, moe_top_k=2)
LAYOUTS = [dict(), dict(scan_layers=True), dict(remat=True),
           dict(scan_layers=True, remat=True)]


def _gpt_batch():
    rng = np.random.RandomState(50)
    toks = rng.randint(0, GPT["vocab_size"], size=(2, 8)).astype(np.int64)
    return toks, np.roll(toks, -1, axis=1)


def _aux_sum(inter):
    return sum(v.sum() for v in inter)


@functools.lru_cache(maxsize=None)
def _jax_gpt(layout: tuple):
    """The JAX GPT with the MoE FFN: params, loss, the sown aux losses
    (flattened, one-element tuples unwrapped) and the grads of ``loss +
    0.01 sum(lb) + 0.001 sum(z)``."""
    import jax
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.testing.standalone_gpt import (
        GPTConfig as JCfg, gpt_model_provider)
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(1)
    try:
        model = gpt_model_provider(JCfg(**GPT, **dict(layout)))
        toks, labels = _gpt_batch()
        params = model.init(jax.random.key(0), toks, labels)

        def loss_fn(p):
            loss, inter = model.apply(p, toks, labels,
                                      mutable=["intermediates"])
            flat = {}

            def walk(node, path):
                if isinstance(node, dict):
                    for k, v in node.items():
                        walk(v, path + (k,))
                else:
                    flat[".".join(path)] = node[0]    # sow's tuple
            walk(inter["intermediates"], ())
            lb = sum(v.sum() for k, v in flat.items() if "lb" in k)
            z = sum(v.sum() for k, v in flat.items() if "z_loss" in k)
            return loss + 0.01 * lb + 0.001 * z, (loss, flat)

        (_, (loss, flat)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(params)
        return (_np(params), float(loss),
                {k: np.asarray(v) for k, v in flat.items()},
                _flat(_np(grads)["params"]))
    finally:
        jps.destroy_model_parallel()


def _router_margins(model):
    """Hooks recording each router's least top-k margin."""
    seen = []

    def hook(mod, args, kwargs, out):
        x = args[0].detach().double()
        p = torch.softmax(x @ mod.weight.detach().double().t(), -1)
        seen.append(_margin(p.numpy(), mod.top_k))

    for m in model.modules():
        if isinstance(m, trouter.TopKRouter):
            m.register_forward_hook(hook, with_kwargs=True)
    return seen


@pytest.mark.parametrize("layout", LAYOUTS,
                         ids=["loop", "scan", "remat", "scan_remat"])
def test_gpt_moe_matches_jax(layout):
    """The port's GPT with the MoE FFN on the JAX GPT's weights
    (``load_jax_params``): the loss, every layer's sown aux losses (JAX's
    paths) and the grads of the loss plus the scaled aux losses."""
    params, jloss, jinter, jgrads = _jax_gpt(tuple(sorted(layout.items())))
    model = GPTModel(GPTConfig(**GPT, **layout), device="cpu")
    load_jax_params(model, params)
    margins = _router_margins(model)
    toks, labels = (torch.from_numpy(a) for a in _gpt_batch())
    inter = {}
    loss = model(toks, labels, intermediates=inter)
    assert min(margins[:GPT["num_layers"]]) >= MIN_MARGIN
    assert sorted(inter) == sorted(jinter)
    for k, v in inter.items():
        np.testing.assert_allclose(v.detach().numpy(), jinter[k], rtol=RTOL)
    np.testing.assert_allclose(float(loss), jloss, rtol=RTOL)
    lb = _aux_sum(v for k, v in inter.items() if "lb" in k)
    z = _aux_sum(v for k, v in inter.items() if "z_loss" in k)
    (loss + 0.01 * lb + 0.001 * z).backward()
    _close_grads({n: p.grad for n, p in model.named_parameters()}, jgrads)


def test_gpt_moe_scan_layers_keeps_aux_losses():
    """``scan_layers`` hands back the aux losses stacked ``[num_layers]``
    (the regression JAX's nn.scan had), equal to the loop layout's on
    the same weights; the MoE leaves move between the layouts."""
    params, _, _, _ = _jax_gpt(())
    loop = GPTModel(GPTConfig(**GPT), device="cpu")
    load_jax_params(loop, params)
    scan = GPTModel(GPTConfig(**GPT, scan_layers=True), device="cpu")
    load_jax_params(scan, to_scan_layout(params, GPT["num_layers"]))
    toks, labels = (torch.from_numpy(a) for a in _gpt_batch())
    a, b = {}, {}
    assert torch.equal(loop(toks, labels, intermediates=a),
                       scan(toks, labels, intermediates=b))
    for key in ("moe_lb_loss", "moe_z_loss"):
        stacked = b[f"layers.layer.{key}"]
        assert stacked.shape == (GPT["num_layers"],)
        assert torch.equal(stacked, torch.stack(
            [a[f"layer_{i}.{key}"] for i in range(GPT["num_layers"])]))
    back = to_loop_layout(to_scan_layout(params, GPT["num_layers"]))
    assert _flat(back["params"]).keys() == _flat(params["params"]).keys()


def test_gpt_moe_remat_counts_each_aux_loss_once():
    """Under ``remat`` the recompute's aux losses are discarded: the
    dict holds one value a layer, and the grads equal the plain
    layout's."""
    params, _, _, _ = _jax_gpt(())
    runs = []
    for remat in (False, True):
        model = GPTModel(GPTConfig(**GPT, remat=remat), device="cpu")
        load_jax_params(model, params)
        toks, labels = (torch.from_numpy(a) for a in _gpt_batch())
        inter = {}
        loss = model(toks, labels, intermediates=inter)
        (loss + _aux_sum(inter.values())).backward()
        runs.append((inter, {n: p.grad for n, p in
                             model.named_parameters()}))
    assert sorted(runs[0][0]) == sorted(runs[1][0])
    assert len(runs[1][0]) == 2 * GPT["num_layers"]
    for n, g in runs[0][1].items():
        torch.testing.assert_close(runs[1][1][n], g, rtol=1e-6, atol=1e-7)


def test_gpt_moe_param_shapes_and_shards():
    """``gpt_param_shapes`` names the MoE leaves (JAX's tree paths);
    ``shard_moe_params`` gives each expert rank its experts and the
    router whole, in both layouts."""
    params, _, _, _ = _jax_gpt(())
    cfg = GPTConfig(**GPT)
    params_from_jax("gpt", cfg, params, device="cpu")      # shapes checked
    shapes = gpt_param_shapes(cfg)
    assert shapes[("layer_0", "mlp", "experts", "w1")] == (4, 16, 64)
    assert shapes[("layer_0", "mlp", "router", "weight")] == (4, 16)
    assert ("layer_0", "mlp", "dense_h_to_4h", "weight") not in shapes
    for tree, dim in ((params, 0),
                      (to_scan_layout(params, GPT["num_layers"]), 1)):
        full = _flat(tree["params"])
        for rank in range(2):
            got = _flat(shard_moe_params(tree, 2, rank)["params"])
            for name, v in got.items():
                if ".experts." in name:
                    want = np.take(full[name], range(2 * rank, 2 * rank + 2),
                                   axis=dim)
                    np.testing.assert_array_equal(v, want)
                else:
                    assert v is full[name] or np.array_equal(v, full[name])
    with pytest.raises(ValueError, match="does not divide"):
        shard_moe_params(params, 3, 0)
