"""Sequence parallelism on the port against the JAX package (CPU).

The port's counterparts of ``tests/L0/run_transformer/test_layers.py::
test_sequence_parallel_column_row`` and ``test_gpt_bert_minimal.py``'s
sequence-parallel cases:

* the layers at tp = 2 and 4: ``ColumnParallelLinear`` (sequence in,
  all-gathered) -> GELU -> ``RowParallelLinear`` (reduce-scattered out)
  with ``sequence_parallel_enabled=True`` on ``[s / tp, b, h]`` shards,
  forward and the grads of the input, the weights and the biases, against
  the JAX layers under ``jax.shard_map`` on the host devices (the same
  numpy weights and cotangent on both sides), against the dense
  computation, and against the same pair without sequence parallelism on
  the gathered input;
* JAX's asserts: ``gather_output`` with sequence parallelism, a row layer
  whose input is not parallel;
* GPT and BERT with ``sequence_parallel`` at tp = 1 (the only tp they
  take: queue 3, "tied heads at tp > 1"), where the regions are the
  identity: the GPT's loss and grads against the JAX GPT with the flag at
  tp = 1, and both models against themselves without it.

The port's ranks run one process a rank over gloo with CPU tensors (one
spawn of 4 ranks: tp = 4, then tp = 2 x dp = 2); the spawned ranks import
this module, torch and the port only.

Tolerances (fp32): within 1e-5 of each output's largest magnitude (the
gathers and reduce-scatters' fp32 sums in other orders; JAX's test holds
its pair to the dense product at 1e-5); the model flag at tp = 1 exactly
(the same ops).
"""
import functools

import numpy as np
import pytest
import torch

from apex_tpu_torch.inference.weights import load_jax_params
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer.tensor_parallel import (ColumnParallelLinear,
                                                        RowParallelLinear)
from apex_tpu_torch.transformer.testing.distributed_test_base import \
    spawn_ranks
from apex_tpu_torch.transformer.testing.standalone_bert import (BertConfig,
                                                                BertModel)
from apex_tpu_torch.transformer.testing.standalone_gpt import (GPTConfig,
                                                               GPTModel,
                                                               gelu)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

TOL = 1e-5
SEQ, BATCH, IN, OUT = 8, 3, 8, 16
TPS = (2, 4)
GPT = dict(vocab_size=64, hidden_size=32, num_layers=2,
           num_attention_heads=4, max_seq_length=16, hidden_dropout=0.0,
           attention_dropout=0.0)


def _inputs():
    rng = np.random.RandomState(21)
    return dict(x=rng.randn(SEQ, BATCH, IN).astype(np.float32),
                dy=rng.randn(SEQ, BATCH, IN).astype(np.float32),
                wc=(rng.randn(OUT, IN) * 0.3).astype(np.float32),
                bc=rng.randn(OUT).astype(np.float32),
                wr=(rng.randn(IN, OUT) * 0.3).astype(np.float32),
                br=rng.randn(IN).astype(np.float32))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- the port's ranks --------------------------------------------------------

def _pair(inp, tp, r, sp):
    """Column -> GELU -> Row on this rank's weight shards; ``sp``: the
    input and output are the rank's sequence shards."""
    o = OUT // tp
    col = ColumnParallelLinear(IN, OUT, gather_output=False, device="cpu",
                               sequence_parallel_enabled=sp)
    row = RowParallelLinear(OUT, IN, input_is_parallel=True, device="cpu",
                            sequence_parallel_enabled=sp)
    with torch.no_grad():
        col.weight.copy_(_t(inp["wc"][r * o:(r + 1) * o]))
        col.bias.copy_(_t(inp["bc"][r * o:(r + 1) * o]))
        row.weight.copy_(_t(inp["wr"][:, r * o:(r + 1) * o]))
        row.bias.copy_(_t(inp["br"]))
    s = SEQ // tp
    x = _t(inp["x"][r * s:(r + 1) * s] if sp else inp["x"])
    dy = _t(inp["dy"][r * s:(r + 1) * s] if sp else inp["dy"])
    x.requires_grad_()
    h, _ = col(x)
    y, _ = row(gelu(h))
    y.backward(dy)
    return dict(y=y.detach(), dx=x.grad, dwc=col.weight.grad,
                dbc=col.bias.grad, dwr=row.weight.grad, dbr=row.bias.grad)


def _asserts():
    msgs = {}
    for label, build in (
            ("gather_output", lambda: ColumnParallelLinear(
                IN, OUT, gather_output=True, sequence_parallel_enabled=True,
                device="cpu")),
            ("input_is_parallel", lambda: RowParallelLinear(
                OUT, IN, input_is_parallel=False,
                sequence_parallel_enabled=True, device="cpu"))):
        layer = build()
        x = torch.zeros(SEQ // 2, BATCH, layer.input_size
                        // (1 if label == "gather_output" else layer.tp))
        try:
            layer(x)
            msgs[label] = None
        except AssertionError as e:
            msgs[label] = str(e)
    return msgs


def _cases(inp, tp):
    r = ps.get_tensor_model_parallel_rank()
    return dict(sp=_pair(inp, tp, r, True), dense=_pair(inp, tp, r, False),
                asserts=_asserts(), rank=r)


def _rank_main(rank, inp):
    out = {4: _cases(inp, 4)}
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(2)
    out[2] = _cases(inp, 2)
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    inp = _inputs()
    return inp, spawn_ranks(4, _rank_main, inp,
                            tensor_model_parallel_size=4,
                            tmp_dir=str(tmp_path_factory.mktemp("sp")))


# -- the JAX side (JAX imported here only) -----------------------------------

@functools.lru_cache(maxsize=None)
def _jax_pair(tp):
    """The JAX pair with sequence parallelism under shard_map at tp: each
    rank's y and its grads, stacked by rank."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer import tensor_parallel
    inp = _inputs()
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(tp, devices=jax.devices()[:tp])
    col = tensor_parallel.ColumnParallelLinear(
        IN, OUT, gather_output=False, sequence_parallel_enabled=True)
    row = tensor_parallel.RowParallelLinear(
        OUT, IN, input_is_parallel=True, sequence_parallel_enabled=True)

    def body(x, dy, wc, bc, wr, br):
        def f(x, wc, bc, wr, br):
            h, _ = col.apply({"params": {"weight": wc, "bias": bc}}, x)
            y, _ = row.apply({"params": {"weight": wr, "bias": br}},
                             jax.nn.gelu(h))
            return y

        y, vjp = jax.vjp(f, x, wc, bc, wr, br)
        grads = vjp(dy)
        return jax.tree.map(lambda t: t[None], (y, *grads))

    try:
        outs = jax.jit(functools.partial(jax.shard_map, check_vma=False)(
            body, mesh=jps.get_mesh(),
            in_specs=(P("tensor"), P("tensor"), P("tensor"), P("tensor"),
                      P(None, "tensor"), P()),
            out_specs=P("tensor")))(
            *(jnp.asarray(inp[k]) for k in ("x", "dy", "wc", "bc", "wr",
                                            "br")))
        return dict(zip(("y", "dx", "dwc", "dbc", "dwr", "dbr"),
                        (np.asarray(o) for o in outs)))
    finally:
        jps.destroy_model_parallel()


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _ranks_of(ranks, tp):
    """tp = 2: data rank 0's two tensor ranks (global ranks 0 and 1)."""
    mine = ranks[:tp]
    assert [r[tp]["rank"] for r in mine] == list(range(tp))
    return [r[tp] for r in mine]


# -- the tests ---------------------------------------------------------------

@pytest.mark.parametrize("tp", TPS)
def test_sequence_parallel_column_row_matches_jax(port_runs, tp):
    """Each rank's sequence-shard output and its input, weight and bias
    grads against the JAX pair's on the same weights and cotangent."""
    _, ranks = port_runs
    want = _jax_pair(tp)
    for r, got in enumerate(_ranks_of(ranks, tp)):
        for key in ("y", "dx", "dwc", "dbc", "dwr", "dbr"):
            _close(got["sp"][key], want[key][r])


@pytest.mark.parametrize("tp", TPS)
def test_sequence_parallel_column_row_matches_dense(port_runs, tp):
    """JAX's check: the shards put together are the dense product x
    Wc^T (+ bc) -> GELU -> Wr^T (+ br)."""
    inp, ranks = port_runs
    y = torch.cat([g["sp"]["y"] for g in _ranks_of(ranks, tp)])
    h = gelu(_t(inp["x"]) @ _t(inp["wc"]).T + _t(inp["bc"]))
    _close(y, (h @ _t(inp["wr"]).T + _t(inp["br"])).numpy())


@pytest.mark.parametrize("tp", TPS)
def test_sequence_parallel_matches_non_sp(port_runs, tp):
    """The same pair without sequence parallelism on the gathered input:
    the output and the input grad gathered along the sequence, the
    weight grads and the column bias's equal; the row bias's grad is a
    sequence shard's partial sum under sequence parallelism (summed over
    the ranks: the dense one)."""
    _, ranks = port_runs
    got = _ranks_of(ranks, tp)
    for key in ("y", "dx"):
        _close(torch.cat([g["sp"][key] for g in got]), got[0]["dense"][key])
    for g in got:
        for key in ("dwc", "dbc", "dwr"):
            _close(g["sp"][key], g["dense"][key])
    _close(sum(g["sp"]["dbr"] for g in got), got[0]["dense"]["dbr"])


@pytest.mark.parametrize("tp", TPS)
def test_sequence_parallel_asserts(port_runs, tp):
    _, ranks = port_runs
    msgs = ranks[0][tp]["asserts"]
    assert "gather_output incompatible with sequence_parallel" \
        in msgs["gather_output"]
    assert "requires input_is_parallel" in msgs["input_is_parallel"]


def test_sequence_parallel_asserts_at_tp_1():
    ps.destroy_model_parallel()
    msgs = _asserts()
    assert msgs["gather_output"] and msgs["input_is_parallel"]


def _gpt_tree():
    import jax
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.testing.standalone_gpt import (
        GPTConfig as JCfg, gpt_model_provider)
    rng = np.random.RandomState(4)
    toks = rng.randint(0, GPT["vocab_size"], (2, 16)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(1)
    try:
        m = gpt_model_provider(JCfg(**dict(GPT, sequence_parallel=True)))
        params = m.init(jax.random.PRNGKey(2), toks, labels)
        loss, grads = jax.value_and_grad(
            lambda p: m.apply(p, toks, labels))(params)
    finally:
        jps.destroy_model_parallel()
    np_tree = jax.tree_util.tree_map(np.asarray, params)
    return np_tree, toks, labels, float(loss), jax.tree_util.tree_map(
        np.asarray, grads)


def test_gpt_sequence_parallel_at_tp_1_matches_jax():
    """GPT with ``sequence_parallel`` at tp = 1 against the JAX GPT with
    the flag at tp = 1 (loss and grads), and against the port's GPT
    without it (the same bits)."""
    ps.destroy_model_parallel()
    tree, toks, labels, jloss, jgrads = _gpt_tree()
    losses = {}
    for sp in (True, False):
        m = GPTModel(GPTConfig(**dict(GPT, sequence_parallel=sp)),
                     device="cpu")
        load_jax_params(m, tree)
        loss = m(_t(toks).long(), _t(labels).long())
        loss.backward()
        losses[sp] = (loss.item(), {n: p.grad for n, p in
                                    m.named_parameters()})
    np.testing.assert_allclose(losses[True][0], jloss, rtol=TOL)
    assert losses[True][0] == losses[False][0]
    for name, g in losses[True][1].items():
        node = jgrads["params"]
        for key in name.split("."):
            node = node[key]
        _close(g, node)
        assert torch.equal(g, losses[False][1][name])


def test_bert_sequence_parallel_at_tp_1_is_the_plain_model():
    torch.manual_seed(0)
    cfg = dict(vocab_size=64, hidden_size=32, num_layers=2,
               num_attention_heads=4, max_seq_length=16)
    plain = BertModel(BertConfig(**cfg), device="cpu")
    sp = BertModel(BertConfig(**cfg, sequence_parallel=True), device="cpu")
    sp.load_state_dict(plain.state_dict())
    toks = torch.randint(0, 64, (2, 16))
    mask = torch.ones(2, 16, dtype=torch.int64)
    mask[1, 10:] = 0
    for a, b in zip(plain(toks, attention_mask=mask),
                    sp(toks, attention_mask=mask)):
        assert torch.equal(a, b)
