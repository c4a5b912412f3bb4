"""The GPT's context parallelism on the port against the JAX package (CPU).

The port's counterpart of ``tests/L0/run_transformer/
test_gpt_bert_minimal.py::test_context_parallel_matches_cp1``: a GPT
(vocab 64, hidden 32, 2 layers, 4 heads, a 64-token sequence, batch 2)
with ``context_parallel`` at cp = 4 (16 tokens a rank) and cp = 2, whose
loss averaged over the context group equals cp = 1's on the same weights
(rtol 2e-5, JAX's), and equals the JAX GPT's at cp = 4 under
``jax.shard_map`` on the host devices; the grads averaged over
``get_dense_param_grad_axes()``'s group (the data replicas run the same
batch at cp = 2 x dp = 2) against cp = 1's and JAX's cp = 4 grads; each
rank's positions starting at ``rank * s``; training mode with attention dropout (the ring at global
coordinates: the loss equals cp = 1's with the same generator) and with
hidden dropout (each rank's masks its own, the attention seeds the same
on every rank); a padding mask refused.  The port's ranks run one
process a rank over gloo with CPU tensors (one spawn of 4 ranks: cp =
4, then cp = 2 x dp = 2); the spawned ranks import this module, torch
and the port only.

Tolerances: losses within rtol 2e-5 (JAX's); grads within 2e-5 of each
leaf's largest magnitude (fp32 in other orders; the ring's merges);
the embedding's positions exactly; the hidden masks' keep share within
0.05 of 1 - rate.
"""
import functools

import numpy as np
import pytest
import torch
import torch.distributed as dist

from apex_tpu_torch.inference.weights import load_jax_params
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel.random import fold_generator
from apex_tpu_torch.transformer.testing import standalone_gpt as sgpt
from apex_tpu_torch.transformer.testing.distributed_test_base import \
    spawn_ranks
from apex_tpu_torch.transformer.testing.standalone_gpt import (GPTConfig,
                                                               GPTModel)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

RTOL = 2e-5
TOL_GRAD = 2e-5
TOL_KEEP = 0.05
VOCAB, HIDDEN, LAYERS, HEADS, SEQ, BATCH = 64, 32, 2, 4, 64, 2
CFG = dict(vocab_size=VOCAB, hidden_size=HIDDEN, num_layers=LAYERS,
           num_attention_heads=HEADS, max_seq_length=SEQ,
           hidden_dropout=0.0, attention_dropout=0.0)
CPS = (2, 4)
ATTN_RATE, HIDDEN_RATE = 0.1, 0.1


def _batch():
    rng = np.random.RandomState(0)
    toks = rng.randint(0, VOCAB, size=(BATCH, SEQ)).astype(np.int64)
    return toks, np.roll(toks, -1, axis=1)


@functools.lru_cache(maxsize=None)
def _jax_params():
    """The JAX GPT's weights at cp = 1 (numpy leaves)."""
    import jax
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.testing.standalone_gpt import (
        GPTConfig as JCfg, gpt_model_provider)
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(1)
    toks, labels = _batch()
    try:
        params = gpt_model_provider(JCfg(**CFG)).init(
            jax.random.PRNGKey(7), toks, labels)
    finally:
        jps.destroy_model_parallel()
    return jax.tree_util.tree_map(np.asarray, params)


def _model(tree, **kw):
    m = GPTModel(GPTConfig(**dict(CFG, **kw)), device="cpu")
    load_jax_params(m, tree)
    return m


def _flat_grads(model) -> dict:
    return {n: p.grad.clone() for n, p in model.named_parameters()}


def _cp1(tree, **train):
    """Loss and grads at cp = 1 (no topology's context group)."""
    toks, labels = (torch.from_numpy(a) for a in _batch())
    m = _model(tree, **train.pop("cfg", {}))
    loss = m(toks, labels, **train)
    loss.backward()
    return loss.item(), _flat_grads(m)


# -- the port's ranks --------------------------------------------------------

def _shard(a, cp, r):
    s = a.shape[1] // cp
    return torch.from_numpy(np.ascontiguousarray(a[:, r * s:(r + 1) * s]))


def _cp_run(tree, cp, cfg_kw=None, **train):
    """One forward and backward at context parallelism: the loss
    averaged over the context group, the grads all-reduced over the
    dense grad axes and divided by their ranks (cp context ranks x the
    data replicas, which run the same batch here)."""
    r = ps.get_context_parallel_rank()
    toks, labels = (_shard(a, cp, r) for a in _batch())
    m = _model(tree, context_parallel=True, **(cfg_kw or {}))
    loss = m(toks, labels, **train)
    loss.backward()
    group = ps.resolve_group(ps.get_dense_param_grad_axes())
    grads = _flat_grads(m)
    for g in grads.values():
        dist.all_reduce(g, group=group)
        g /= dist.get_world_size(group)     # cp ranks x identical replicas
    mean = loss.detach().clone()
    dist.all_reduce(mean, group=ps.get_context_parallel_group())
    return dict(loss=mean.item() / cp, grads=grads)


def _positions(tree, cp):
    """This rank's embedding output against cp = 1's slice at its
    positions."""
    r = ps.get_context_parallel_rank()
    toks = torch.from_numpy(_batch()[0])
    full = _model(tree).embedding(toks)
    mine = _model(tree, context_parallel=True).embedding(_shard(
        _batch()[0], cp, r))
    s = SEQ // cp
    return torch.equal(mine, full[r * s:(r + 1) * s])


def _dropout_streams(tree, cp):
    """Training mode with both dropouts at cp: the attention seeds each
    layer drew and the first hidden mask (the embedding's) on this
    rank."""
    seeds, masks = [], []
    seed_fn, drop_fn = sgpt.attention_seed, sgpt.hidden_dropout

    def seed_rec(gen, dev):
        t = seed_fn(gen, dev)
        seeds.append(int(t))
        return t

    def drop_rec(x, rate, det, gen=None):
        y = drop_fn(x, rate, det, gen)
        masks.append((y != 0).float().mean().item() if not masks else None)
        if len(masks) == 1:
            masks.append(y.ne(0))
        return y

    sgpt.attention_seed, sgpt.hidden_dropout = seed_rec, drop_rec
    try:
        r = ps.get_context_parallel_rank()
        toks, labels = (_shard(a, cp, r) for a in _batch())
        m = _model(tree, context_parallel=True, hidden_dropout=HIDDEN_RATE,
                   attention_dropout=ATTN_RATE)
        loss = m(toks, labels, deterministic=False,
                 generator=torch.Generator().manual_seed(11))
    finally:
        sgpt.attention_seed, sgpt.hidden_dropout = seed_fn, drop_fn
    return dict(seeds=seeds, keep=masks[0], mask=masks[1],
                finite=bool(torch.isfinite(loss)))


def _mask_refused(tree):
    m = _model(tree, context_parallel=True)
    toks = torch.zeros(BATCH, 4, dtype=torch.int64)
    try:
        m(toks, attention_mask=torch.zeros(BATCH, 1, 4, 4, dtype=torch.bool))
    except AssertionError as e:
        return str(e)
    return None


def _cases(tree, cp):
    gen = lambda: torch.Generator().manual_seed(3)     # noqa: E731
    return dict(
        eval=_cp_run(tree, cp),
        attn_drop=_cp_run(tree, cp, dict(attention_dropout=ATTN_RATE),
                          deterministic=False, generator=gen()),
        positions=_positions(tree, cp),
        streams=_dropout_streams(tree, cp),
        mask=_mask_refused(tree))


def _rank_main(rank, tree):
    out = {4: _cases(tree, 4)}
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(context_parallel_size_=2)
    out[2] = _cases(tree, 2)
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    tree = _jax_params()
    return tree, spawn_ranks(4, _rank_main, tree, context_parallel_size=4,
                             tmp_dir=str(tmp_path_factory.mktemp("cp")))


# -- the JAX side (JAX imported here only) -----------------------------------

@functools.lru_cache(maxsize=None)
def _jax_cp(cp):
    """The JAX GPT at cp: the loss pmean'd over the context axis and its
    grads (flattened by dotted name)."""
    import jax
    from jax.sharding import PartitionSpec as P
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.testing.standalone_gpt import (
        GPTConfig as JCfg, gpt_model_provider)
    toks, labels = _batch()
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(context_parallel_size_=cp,
                                  devices=jax.devices()[:cp])
    try:
        m = gpt_model_provider(JCfg(**dict(CFG, context_parallel=True)))

        def body(p, t, l):
            return jax.lax.pmean(m.apply(p, t, l), "context")

        loss_fn = jax.jit(functools.partial(jax.shard_map, check_vma=False)(
            body, mesh=jps.get_mesh(),
            in_specs=(P(), P(None, "context"), P(None, "context")),
            out_specs=P()))
        loss, grads = jax.value_and_grad(loss_fn)(_jax_params(), toks,
                                                  labels)
        flat = {}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, path + (k,))
            else:
                flat[".".join(path)] = np.asarray(node)

        walk(grads["params"], ())
        return float(loss), flat
    finally:
        jps.destroy_model_parallel()


def _close_grads(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for name, g in got.items():
        w = np.asarray(want[name], np.float32)
        g = g.numpy() if isinstance(g, torch.Tensor) else g
        assert np.abs(g - w).max() <= TOL_GRAD * max(np.abs(w).max(),
                                                     1e-30), name


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("cp", CPS)
def test_context_parallel_matches_cp1(port_runs, cp):
    """JAX's test in the port: the cp loss (the mean of the ranks' means)
    equals cp = 1's on the same weights."""
    tree, ranks = port_runs
    loss1, _ = _cp1(tree)
    for r in ranks:
        np.testing.assert_allclose(r[cp]["eval"]["loss"], loss1, rtol=RTOL,
                                   atol=2e-6)


def test_context_parallel_matches_the_jax_gpt(port_runs):
    tree, ranks = port_runs
    jloss, _ = _jax_cp(4)
    np.testing.assert_allclose(ranks[0][4]["eval"]["loss"], jloss, rtol=RTOL,
                               atol=2e-6)


@pytest.mark.parametrize("cp", CPS)
def test_context_parallel_grads_after_the_all_reduce(port_runs, cp):
    """The grads averaged over the dense grad axes (data and context)
    are cp = 1's, on every rank."""
    tree, ranks = port_runs
    _, want = _cp1(tree)
    for r in ranks:
        _close_grads(r[cp]["eval"]["grads"],
                     {n: g.numpy() for n, g in want.items()})


def test_context_parallel_grads_match_the_jax_gpt(port_runs):
    _, ranks = port_runs
    _close_grads(ranks[0][4]["eval"]["grads"], _jax_cp(4)[1])


@pytest.mark.parametrize("cp", CPS)
def test_context_parallel_positions_start_at_the_shard(port_runs, cp):
    _, ranks = port_runs
    assert all(r[cp]["positions"] for r in ranks)


@pytest.mark.parametrize("cp", CPS)
def test_context_parallel_attention_dropout_is_the_dense_runs(port_runs, cp):
    """Attention dropout 0.1 in training mode, the same generator on
    every rank: the ring drops at global coordinates with one seed a
    layer, so the cp loss equals cp = 1's with that generator."""
    tree, ranks = port_runs
    loss1, grads1 = _cp1(tree, cfg=dict(attention_dropout=ATTN_RATE),
                         deterministic=False,
                         generator=torch.Generator().manual_seed(3))
    for r in ranks:
        np.testing.assert_allclose(r[cp]["attn_drop"]["loss"], loss1,
                                   rtol=RTOL, atol=2e-6)
        _close_grads(r[cp]["attn_drop"]["grads"],
                     {n: g.numpy() for n, g in grads1.items()})


@pytest.mark.parametrize("cp", CPS)
def test_context_parallel_hidden_dropout_per_rank(port_runs, cp):
    """Both dropouts on: every context rank draws the same attention
    seeds, and hidden masks of its own (the context rank folded into
    the stream), each keeping about 1 - rate."""
    _, ranks = port_runs
    mine = [r[cp]["streams"] for r in ranks[:cp]]
    assert all(s["finite"] for s in mine)
    assert all(len(s["seeds"]) == LAYERS for s in mine)
    assert all(s["seeds"] == mine[0]["seeds"] for s in mine)
    for i in range(cp):
        assert abs(mine[i]["keep"] - (1 - HIDDEN_RATE)) <= TOL_KEEP
        for j in range(i):
            assert not torch.equal(mine[i]["mask"], mine[j]["mask"])


@pytest.mark.parametrize("cp", CPS)
def test_context_parallel_refuses_a_padding_mask(port_runs, cp):
    _, ranks = port_runs
    assert "causal masking only" in ranks[0][cp]["mask"]


def test_fold_generator_streams():
    """The fold: one stream a rank, the same for the same state and
    rank; the shared generator advances, so the next fold differs."""
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    draw = lambda gen: torch.rand(8, generator=gen)       # noqa: E731
    a0 = draw(fold_generator(g, 0))
    g.set_state(state)
    a1 = draw(fold_generator(g, 1))
    g.set_state(state)
    assert torch.equal(draw(fold_generator(g, 0)), a0)
    assert not torch.equal(a0, a1)
    assert not torch.equal(draw(fold_generator(g, 0)), a0)
