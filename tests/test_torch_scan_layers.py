"""The GPT's ``scan_layers`` on the port against the JAX package (CPU).

The port's counterparts of ``tests/L0/run_transformer/
test_gpt_bert_minimal.py::test_scan_layers_matches_loop`` and
``test_scan_layers_dropout_trains``: a GPT (vocab 64, hidden 32, 3
layers, 4 heads, 16 tokens, batch 2) whose layers' parameters are
stacked ``[num_layers, ...]`` under ``layers.layer.<...>``, JAX's
``nn.scan`` tree:

* the JAX scan model's own tree (``params_from_jax`` checks its stacked
  shapes, ``load_jax_params`` loads it): the loss and every grad against
  the JAX scan model's, with and without ``remat``;
* the same weights moved to the loop layout (``to_loop_layout``) and
  back (``to_scan_layout``): scan and loop give the same loss and grads
  bit for bit, with and without ``remat``, in eval and in training mode
  (the layers draw their seeds and masks from the generator in layer
  order, as the loop does);
* dropout under scan against JAX's by its statistics (flax's
  ``split_rngs`` bits are not reproduced): reproducible by the
  generator, sensitive to it, each layer's hidden masks its own, keeping
  about 1 - rate, finite grads.

Tolerances: against JAX within 1e-5 of the loss and of each leaf's
largest grad magnitude (fp32, other orders); scan against loop exactly;
the keep share within 0.05 of 1 - rate.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from apex_tpu_torch.inference.weights import (load_jax_params,
                                              params_from_jax,
                                              to_loop_layout,
                                              to_scan_layout)
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.testing import standalone_gpt as sgpt
from apex_tpu_torch.transformer.testing.standalone_gpt import (GPTConfig,
                                                               GPTModel)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

TOL = 1e-5
TOL_KEEP = 0.05
CFG = dict(vocab_size=64, hidden_size=32, num_layers=3,
           num_attention_heads=4, max_seq_length=16, hidden_dropout=0.0,
           attention_dropout=0.0)
RATE = 0.2


def _data():
    rng = np.random.RandomState(3)
    toks = rng.randint(0, CFG["vocab_size"], (2, 16)).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1)


@functools.lru_cache(maxsize=None)
def _jax_scan(remat: bool):
    """The JAX scan model's tree (numpy leaves), loss and grads."""
    import jax
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.testing.standalone_gpt import (
        GPTConfig as JCfg, gpt_model_provider)
    toks, labels = _data()
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(1)
    try:
        init = gpt_model_provider(JCfg(**dict(CFG, scan_layers=True)))
        params = init.init(jax.random.PRNGKey(9), toks, labels)
        m = gpt_model_provider(JCfg(**dict(CFG, scan_layers=True,
                                           remat=remat)))
        loss, grads = jax.value_and_grad(
            lambda p: m.apply(p, toks, labels))(params)
    finally:
        jps.destroy_model_parallel()
    as_np = functools.partial(jax.tree_util.tree_map, np.asarray)
    return as_np(params), float(loss), as_np(grads)


def _port(tree, **kw):
    m = GPTModel(GPTConfig(**dict(CFG, **kw)), device="cpu")
    load_jax_params(m, tree)
    return m


def _run(model, **train):
    toks, labels = (torch.from_numpy(a).long() for a in _data())
    loss = model(toks, labels, **train)
    loss.backward()
    return loss.item(), {n: p.grad for n, p in model.named_parameters()}


def _leaf(tree, name):
    node = tree["params"]
    for key in name.split("."):
        node = node[key]
    return node


@pytest.fixture(autouse=True)
def _no_topology():
    ps.destroy_model_parallel()


@pytest.mark.parametrize("remat", [False, True])
def test_scan_layers_matches_the_jax_scan_model(remat):
    tree, jloss, jgrads = _jax_scan(remat)
    loss, grads = _run(_port(tree, scan_layers=True, remat=remat))
    np.testing.assert_allclose(loss, jloss, rtol=TOL)
    for name, g in grads.items():
        want = np.asarray(_leaf(jgrads, name))
        assert g.shape == want.shape, name
        assert np.abs(g.numpy() - want).max() <= TOL * np.abs(want).max(), \
            name


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("train", [False, True])
def test_scan_layers_matches_loop(remat, train):
    """JAX's test in the port: the loop model on the transplanted
    weights gives the scan model's loss, and here every grad too, bit for
    bit; in training mode with both dropouts from one generator."""
    tree = _jax_scan(False)[0]
    drop = dict(hidden_dropout=RATE, attention_dropout=RATE) if train else {}
    kw = dict(deterministic=False,
              generator=torch.Generator().manual_seed(5)) if train else {}
    scan = _run(_port(tree, scan_layers=True, remat=remat, **drop), **kw)
    kw = dict(deterministic=False,
              generator=torch.Generator().manual_seed(5)) if train else {}
    loop = _run(_port(to_loop_layout(tree), remat=remat, **drop), **kw)
    assert scan[0] == loop[0]
    for i in range(CFG["num_layers"]):
        for name, g in loop[1].items():
            prefix = f"layer_{i}."
            if name.startswith(prefix):
                stacked = scan[1]["layers.layer." + name[len(prefix):]]
                assert torch.equal(stacked[i], g), name
    for name in ("embedding.word_embeddings.weight",
                 "embedding.position_embeddings", "final_layernorm.weight"):
        assert torch.equal(scan[1][name], loop[1][name])


def test_scan_layout_round_trip_and_shapes():
    """params_from_jax checks a scanned tree's stacked shapes (and
    refuses the loop layout under ``scan_layers``); the layout helpers
    move a tree there and back leaf for leaf."""
    tree = _jax_scan(False)[0]
    scan_cfg = GPTConfig(**dict(CFG, scan_layers=True))
    got = params_from_jax("gpt", scan_cfg, tree, device="cpu")
    qkv = got["params"]["layers"]["layer"]["self_attention"][
        "query_key_value"]["weight"]
    assert tuple(qkv.shape) == (3, 96, 32)
    loop = to_loop_layout(tree)
    params_from_jax("gpt", GPTConfig(**CFG), loop, device="cpu")
    with pytest.raises(ValueError, match="layers/layer"):
        params_from_jax("gpt", scan_cfg, loop, device="cpu")
    back = to_scan_layout(loop, CFG["num_layers"])

    def leaves(node, path=()):
        if isinstance(node, dict):
            for k, v in node.items():
                yield from leaves(v, path + (k,))
        else:
            yield path, node

    a, b = dict(leaves(tree)), dict(leaves(back))
    assert sorted(a) == sorted(b)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    with pytest.raises(ValueError, match="layer_0 .. layer_3"):
        to_scan_layout(loop, 4)


def test_scan_layers_dropout_statistics():
    """Training mode under scan: the loss repeats with the generator and
    moves with it, each layer draws hidden masks of its own keeping
    about 1 - rate, and the grads are finite."""
    tree = _jax_scan(False)[0]
    model = _port(tree, scan_layers=True, hidden_dropout=RATE,
                  attention_dropout=RATE)
    toks, labels = (torch.from_numpy(a).long() for a in _data())

    def loss_with(seed):
        return model(toks, labels, deterministic=False,
                     generator=torch.Generator().manual_seed(seed))

    masks = []
    drop = sgpt.hidden_dropout

    def rec(x, rate, det, gen=None):
        y = drop(x, rate, det, gen)
        masks.append(y.ne(0))
        return y

    sgpt.hidden_dropout = rec
    try:
        a = loss_with(3)
    finally:
        sgpt.hidden_dropout = drop
    assert a.item() == loss_with(3).item() != loss_with(4).item()
    # the embedding's, then two a layer
    assert len(masks) == 1 + 2 * CFG["num_layers"]
    for i, m in enumerate(masks):
        assert abs(m.float().mean().item() - (1 - RATE)) <= TOL_KEEP
        assert all(not torch.equal(m, o) for o in masks[:i])
    a.backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def test_scan_layers_params_are_stacked_at_construction():
    """One seed builds the scan layout's layers as the loop's: the
    stacked parameters are the loop model's, layer by layer."""
    torch.manual_seed(0)
    loop = GPTModel(GPTConfig(**CFG), device="cpu")
    torch.manual_seed(0)
    scan = GPTModel(GPTConfig(**dict(CFG, scan_layers=True)), device="cpu")
    named = dict(scan.named_parameters())
    for name, p in loop.named_parameters():
        if name.startswith("layer_"):
            i, rest = name.split(".", 1)
            assert torch.equal(named["layers.layer." + rest][int(i[6:])], p)
        else:
            assert torch.equal(named[name], p)
    assert dataclasses.replace(scan.cfg, scan_layers=False) == loop.cfg


@pytest.mark.parametrize("remat", [False, True])
def test_scan_layers_slice_each_stack_once(remat):
    """Each stacked parameter reaches the graph through one
    ``unbind`` a forward, whose backward stacks the layers' grads once,
    not through a select a layer (each of whose backwards is a
    zero-filled grad of the whole stack)."""
    model = GPTModel(GPTConfig(**dict(CFG, scan_layers=True, remat=remat)),
                     device="cpu")
    toks, labels = (torch.from_numpy(a).long() for a in _data())
    stacked = {id(p): n for n, p in model.named_parameters()
               if n.startswith("layers.")}
    users: dict = {n: [] for n in stacked.values()}
    seen, todo = set(), [model(toks, labels).grad_fn]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        for nxt, _ in node.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in stacked:
                users[stacked[id(var)]].append(node.name())
            todo.append(nxt)
    assert len(users) == len(list(model.layers.layer.parameters()))
    assert all(u == ["UnbindBackward0"] for u in users.values()), users
