"""The pipeline schedules on the port against the JAX package (CPU).

The port's counterparts of ``tests/L0/run_transformer/
test_pipeline_parallel_fwd_bwd.py``, ``test_p2p_comm.py``,
``test_tied_embedding_pp.py`` and ``test_pipeline_trace_cost.py``'s GPT
stage, and the slice as a whole: the port's LLaMA (hidden 64, 4 heads
over 2 kv heads, 4 layers, vocab 96) at pp = 2 through 1F1B and the
interleaved executor against the JAX LLaMA's blocks under the JAX
executors on the same weights, and at pp 2 x tp 2 against pp 2 at tp 1.

The JAX side runs in this process under ``jax.shard_map`` on the host
devices that ``tests/conftest.py`` pins (a mesh of the first pp, or tp x
pp, of them), each result computed once for the module.  The port's
ranks run one process a rank, spawned over gloo with CPU tensors
(:func:`apex_tpu_torch.transformer.testing.distributed_test_base.spawn_ranks`):
one spawn of 4 ranks runs every rank-side case (the ``port_runs``
fixture), first at pp = 4, then with the topology rebuilt at pp = 2 x dp
= 2 (each data rank a pipeline of its own), then at tp = 2 x pp = 2.
The spawned ranks import this module, torch and the port only: every
JAX import sits inside a JAX-side helper.  On the CPU nothing launches a
kernel.

Tolerances (fp32): losses and grads within 1e-5 of the largest
magnitude of the JAX (or reference) side; the p2p payloads, the
embedding reduction and the overflow flags exactly; the dropout and
remat schedules against the port's sequential replay within 1e-6 (the
same CPU ops in another order of accumulation).
"""
import functools

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from apex_tpu_torch.inference.weights import (llama_param_shapes,
                                              shard_llama_params)
from apex_tpu_torch.normalization import fused_rms_norm
from apex_tpu_torch.transformer import parallel_state as ps
from apex_tpu_torch.transformer import pipeline_parallel as tpp
from apex_tpu_torch.transformer.amp import GradScaler
from apex_tpu_torch.transformer.pipeline_parallel import p2p_communication \
    as p2p
from apex_tpu_torch.transformer.pipeline_parallel import schedules
from apex_tpu_torch.transformer.tensor_parallel import (
    copy_to_tensor_model_parallel_region, vocab_parallel_cross_entropy)
from apex_tpu_torch.transformer.testing import LlamaConfig
from apex_tpu_torch.transformer.testing.distributed_test_base import \
    spawn_ranks
from apex_tpu_torch.utils import remat

from _torch_isolation import restore_torch_from_amp  # noqa: F401

TOL = 1e-5
TOL_REPLAY = 1e-6
#: the linear stages (JAX's test model): hidden 8, microbatches of 2
HID, MBS, N, N_I = 8, 2, 6, 8
#: the LLaMA slice
LLAMA = dict(vocab_size=96, hidden_size=64, num_layers=4,
             num_attention_heads=4, num_kv_heads=2, max_seq_length=16)
SEQ, LN_MICRO, LN_MBS = 16, 4, 2
#: the GPT stage of the trace-cost counterpart
GPT = dict(vocab_size=128, hidden_size=64, num_layers=4,
           num_attention_heads=4, max_seq_length=32, hidden_dropout=0.0,
           attention_dropout=0.0)
GPT_SEQ, GPT_BS, GPT_MICRO = 32, 2, 4
#: the interleaved chunk counts held against JAX
VS = (2, 4)
#: microbatch counts of the in-flight bound
BOUND_NS = (4, 8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(t):
    return np.array(t.detach().float().cpu())


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, err


def _close_tree(got, want, tol=TOL):
    if isinstance(want, dict):
        assert set(got) == set(want), (sorted(got), sorted(want))
        for k in want:
            _close_tree(got[k], want[k], tol)
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close_tree(g, w, tol)
    else:
        _close(got, want, tol)


def _tree_np(tree):
    return tpp.utils.tree_map(_np, tree)


def _tree_np_index(tree, r):
    return tpp.utils.tree_map(lambda a: np.asarray(a)[r], tree)


# -- inputs ----------------------------------------------------------------

def _lin_params(rng, stages):
    return {"w": (rng.randn(stages, HID, HID) / np.sqrt(HID)).astype(
                np.float32),
            "b": (0.1 * rng.randn(stages, HID)).astype(np.float32)}


def _lin_batch(rng, n):
    return {"x": rng.randn(n, MBS, HID).astype(np.float32),
            "target": np.full((n, MBS, HID), 0.1, np.float32),
            "cond": rng.randn(n, MBS, HID).astype(np.float32)}


def _llama_tree(seed=40):
    """A seeded numpy LLaMA tree: linears N(0, 1/fan_in), norms
    1 + N(0, 0.1^2), the embedding N(0, 1)."""
    rng = np.random.RandomState(seed)
    tree: dict = {}
    for path, shape in sorted(llama_param_shapes(
            LlamaConfig(**LLAMA)).items()):
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


def _inputs():
    rng = np.random.RandomState(0)
    lin = dict(params=_lin_params(rng, 4), batch=_lin_batch(rng, N))
    inter = {v: dict(params=_lin_params(rng, v * 4),
                     batch=_lin_batch(rng, N_I)) for v in VS}
    lin2 = dict(params=_lin_params(rng, 2), batch=_lin_batch(rng, N),
                inter=dict(params=_lin_params(rng, 4),
                           batch=_lin_batch(rng, N_I)))
    vocab, ehid = 16, HID
    tied = dict(embed=(0.5 * rng.randn(vocab, ehid)).astype(np.float32),
                w=(rng.randn(4, ehid, ehid) / np.sqrt(ehid)).astype(
                    np.float32),
                tokens=rng.randint(0, vocab, (4, MBS, 6)).astype(np.int64))
    tied["labels"] = np.roll(tied["tokens"], -1, axis=-1)
    t = rng.randint(0, LLAMA["vocab_size"], (LN_MICRO, LN_MBS, SEQ + 1))
    llama = dict(tree=_llama_tree(),
                 batch=dict(tokens=t[..., :-1].astype(np.int64),
                            labels=t[..., 1:].astype(np.int64)))
    gpt = dict(x=rng.randn(GPT_MICRO, GPT_SEQ, GPT_BS, GPT["hidden_size"])
               .astype(np.float32),
               t=rng.randn(GPT_MICRO, GPT_SEQ, GPT_BS, GPT["hidden_size"])
               .astype(np.float32))
    return dict(lin=lin, inter=inter, lin2=lin2, tied=tied, llama=llama,
                gpt=gpt, gpt_params=_jax_gpt_params())


# -- the stages (both sides compute the same functions) ---------------------

def _stage(p, x, mb):
    return F.gelu(x @ p["w"] + p["b"], approximate="tanh")


def _cond_stage(p, x, mb):
    return _stage(p, x, mb) + mb["cond"]


def _remat_stage(p, x, mb):
    return remat(_stage, p, x, mb)


def _mse(y, mb):
    return torch.mean((y - mb["target"]) ** 2)


def _input(mb):
    return mb["x"]


def _drop(y, seed, stage):
    g = torch.Generator().manual_seed(int(seed) * 1009 + int(stage))
    keep = torch.rand(y.shape, generator=g) < 0.8
    return torch.where(keep, y / 0.8, torch.zeros_like(y))


def _drop_stage(p, x, mb):
    """Dropout with the microbatch's seed and the pipe rank folded in."""
    return _drop(_stage(p, x, mb), mb["seed"],
                 ps.get_pipeline_model_parallel_rank())


def _tbatch(batch):
    return {k: _t(v) for k, v in batch.items()}


def _local(params, rank):
    return {k: _t(v[rank]) for k, v in params.items()}


def _chunks(params, rank, v, pp):
    """Rank ``rank``'s ``[v, ...]`` stack: chunk c is virtual stage
    ``c * pp + rank``."""
    return {k: _t(np.stack([a[c * pp + rank] for c in range(v)]))
            for k, a in params.items()}


def _stats():
    return schedules.last_run_stats()["max_in_flight"]


def _lin_cases(inp, pp, r):
    """The linear model through every executor at pp stages (rank r)."""
    out = {}
    local, batch = _local(inp["params"], r), _tbatch(inp["batch"])
    kw = dict(num_microbatches=N, input_fn=_input)
    f = tpp.forward_backward_pipelining_without_interleaving
    out["1f1b"] = f(_stage, _mse, local, batch, **kw)
    out["gpipe"] = f(_stage, _mse, local, batch, use_1f1b=False, **kw)
    out["forward_only"] = f(_stage, _mse, local, batch, forward_only=True,
                            **kw)
    out["cond"] = f(_cond_stage, _mse, local, batch, **kw)
    return out


def _inter_cases(inp, pp, r, v, extra=True):
    out = {}
    local, batch = _chunks(inp["params"], r, v, pp), _tbatch(inp["batch"])
    kw = dict(num_microbatches=N_I, input_fn=_input,
              virtual_pipeline_model_parallel_size=v)
    f = tpp.forward_backward_pipelining_with_interleaving
    out["run"] = f(_stage, _mse, local, batch, **kw)
    out["in_flight"] = _stats()
    if extra:
        out["cond"] = f(_cond_stage, _mse, local, batch, **kw)
        out["forward_only"] = f(_stage, _mse, local, batch,
                                forward_only=True, **kw)
        try:
            f(_stage, _mse, local, tpp.utils.tree_map(lambda a: a[:6], batch),
              **dict(kw, num_microbatches=6))
            out["indivisible"] = None
        except ValueError as e:
            out["indivisible"] = str(e)
    return out


def _p2p_cases(r, pp):
    """Every p2p function on rank-stamped payloads."""
    def stamp(base=0.0):
        return torch.full((4,), base + r)

    out = {name: getattr(p2p, name)(stamp()) for name in (
        "send_forward", "recv_forward", "send_backward", "recv_backward",
        "send_forward_recv_forward", "send_backward_recv_backward")}
    out["send_forward_recv_backward"] = p2p.send_forward_recv_backward(
        stamp(), stamp(100.0))
    out["send_backward_recv_forward"] = p2p.send_backward_recv_forward(
        stamp(100.0), stamp())
    out["pytree"] = p2p.send_forward_recv_forward(
        {"x": stamp()[:1], "y": (torch.ones(2) * r, torch.arange(3) + r)})
    out["roundtrip"] = p2p.send_backward(p2p.send_forward(stamp(0.5)))
    out["kwargs"] = p2p.send_forward_recv_forward(
        stamp(), tensor_shape=(4,), dtype_=torch.float32, timers=None,
        override_scatter_gather_tensors_in_pipeline=False)
    return out


def _dropout_case(inp, r):
    batch = _tbatch(inp["batch"])
    batch["seed"] = torch.arange(N)
    return tpp.forward_backward_pipelining_without_interleaving(
        _drop_stage, _mse, _local(inp["params"], r), batch,
        num_microbatches=N, input_fn=_input)


def _saved_bytes(fn):
    total = [0]

    def pack(t):
        total[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = fn()
    return out, total[0]


def _remat_case(inp, r):
    local, batch = _local(inp["params"], r), _tbatch(inp["batch"])
    kw = dict(num_microbatches=N, input_fn=_input)
    f = tpp.forward_backward_pipelining_without_interleaving
    raw, raw_bytes = _saved_bytes(lambda: f(_stage, _mse, local, batch,
                                            **kw))
    ck, ck_bytes = _saved_bytes(lambda: f(_remat_stage, _mse, local, batch,
                                          **kw))
    return dict(raw=raw, ck=ck, raw_bytes=raw_bytes, ck_bytes=ck_bytes)


def _bound_cases(inp, r):
    """Max in-flight graphs of 1F1B, GPipe and interleaved (v = 2) at
    each n of BOUND_NS (and 2 n for interleaved)."""
    rng = np.random.RandomState(5)
    params = _local(_lin_params(rng, 4), r)
    out = {}
    for n in BOUND_NS + (2 * BOUND_NS[-1],):
        batch = _tbatch(_lin_batch(rng, n))
        f = tpp.forward_backward_pipelining_without_interleaving
        for use_1f1b in (True, False):
            f(_stage, _mse, params, batch, num_microbatches=n,
              input_fn=_input, use_1f1b=use_1f1b)
            out[n, use_1f1b] = _stats()
        tpp.forward_backward_pipelining_with_interleaving(
            _stage, _mse, {k: torch.stack([t, t]) for k, t in params.items()},
            batch, num_microbatches=n, input_fn=_input,
            virtual_pipeline_model_parallel_size=2)
        out[n, "inter"] = _stats()
    return out


def _tied_stage(p, x, mb):
    if ps.get_pipeline_model_parallel_rank() == 0:
        x = p["embed"][mb["tokens"]]
    return x + F.gelu(x @ p["w"], approximate="tanh")


def _tied_loss(y, mb, p):
    logp = torch.log_softmax(y @ p["embed"].T, dim=-1)
    return -torch.mean(torch.gather(logp, -1, mb["labels"][..., None]))


def _tied_case(inp, r):
    t = inp["tied"]
    params = {"embed": _t(t["embed"]), "w": _t(t["w"][r])}
    batch = {"tokens": _t(t["tokens"]), "labels": _t(t["labels"])}
    loss, grads = tpp.forward_backward_pipelining_without_interleaving(
        _tied_stage, _tied_loss, params, batch, num_microbatches=4,
        input_fn=lambda mb: torch.zeros(MBS, 6, HID))
    grads["embed"] = tpp.embedding_grads_all_reduce(grads["embed"])
    masked = tpp.embedding_grads_all_reduce(torch.full((5,), float(r)))
    return dict(loss=loss, grads=grads, masked=masked)


_GPT_LAYER: list = []


def _gpt_stage(p, x, mb):
    return torch.func.functional_call(_GPT_LAYER[0], p, (x, None, True))


def _gpt_loss(y, mb):
    return torch.mean((y - mb["t"]) ** 2)


def _gpt_case(inp):
    from apex_tpu_torch.inference.weights import load_jax_params
    from apex_tpu_torch.transformer.testing.standalone_gpt import (
        GPTConfig, ParallelTransformerLayer)
    layer = ParallelTransformerLayer(GPTConfig(**GPT), causal=True,
                                     device="cpu")
    load_jax_params(layer, inp["gpt_params"])
    _GPT_LAYER[:] = [layer]
    params = {k: v.detach() for k, v in layer.named_parameters()}
    return tpp.forward_backward_pipelining_without_interleaving(
        _gpt_stage, _gpt_loss, params, _tbatch(inp["gpt"]),
        num_microbatches=GPT_MICRO, input_fn=lambda mb: mb["x"])


# -- the LLaMA slice (port side) ---------------------------------------------

_BLOCKS: dict = {}


def _block():
    from apex_tpu_torch.transformer.testing.standalone_llama import \
        LlamaBlock
    tp = ps.get_tensor_model_parallel_world_size()
    if tp not in _BLOCKS:
        _BLOCKS[tp] = LlamaBlock(LlamaConfig(**LLAMA), device="cpu")
    return _BLOCKS[tp]


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def _llama_stage(p, x, mb):
    for layer in p["layers"]:
        x = torch.func.functional_call(_block(), _flat(layer), (x,))
    return x


def _llama_chunk_stage(p, x, mb):
    return torch.func.functional_call(_block(), _flat(p["layer"]), (x,))


def _llama_head(y, mb, norm_w, head_w):
    h = fused_rms_norm(y, (LLAMA["hidden_size"],), norm_w, 1e-5)
    logits = F.linear(copy_to_tensor_model_parallel_region(h), head_w)
    return vocab_parallel_cross_entropy(logits.float(),
                                        mb["labels"].T).mean()


def _llama_loss(y, mb, p):
    return _llama_head(y, mb, p["final_norm"]["weight"],
                       p["lm_head"]["weight"])


def _llama_input(embed):
    return lambda mb: F.embedding(mb["tokens"], embed).transpose(0, 1)


def _llama_stage_tree(tree, r, pp=2):
    """Pipe rank r's stage: its layers, the final norm and the head (the
    JAX layout: every rank holds the same structure)."""
    per = LLAMA["num_layers"] // pp
    return {"layers": [tree[f"layer_{r * per + i}"] for i in range(per)],
            "final_norm": tree["final_norm"], "lm_head": tree["lm_head"]}


def _to_t(tree):
    return tpp.utils.tree_map(_t, tree)


def _llama_cases(inp, tp: int = 1):
    tree, batch = inp["llama"]["tree"], _tbatch(inp["llama"]["batch"])
    r = ps.get_pipeline_model_parallel_rank()
    cfg = LlamaConfig(**LLAMA)
    shard = tree if tp == 1 else shard_llama_params(
        tree, cfg, tp, ps.get_tensor_model_parallel_rank())
    embed = _t(tree["embed_tokens"]["weight"])
    out = {}
    out["1f1b"] = tpp.forward_backward_pipelining_without_interleaving(
        _llama_stage, _llama_loss, _to_t(_llama_stage_tree(shard, r)), batch,
        num_microbatches=LN_MICRO, input_fn=_llama_input(embed))
    if tp == 1:
        v, pp = 2, 2
        chunks = {"layer": tpp.utils.tree_map(
            lambda *a: _t(np.stack(a)),
            *[tree[f"layer_{c * pp + r}"] for c in range(v)])}
        norm_w = _t(tree["final_norm"]["weight"])
        head_w = _t(tree["lm_head"]["weight"])
        out["inter"] = tpp.forward_backward_pipelining_with_interleaving(
            _llama_chunk_stage,
            lambda y, mb: _llama_head(y, mb, norm_w, head_w), chunks, batch,
            num_microbatches=LN_MICRO, input_fn=_llama_input(embed),
            virtual_pipeline_model_parallel_size=v)
    return out


def _scaler_case(rank):
    """A rank-local inf on global rank 3 only (tp 2 x pp 2)."""
    scaler = GradScaler(init_scale=4.0, device="cpu")
    state = scaler.init()
    out = {}
    for poison in (False, True):
        g = {"w": torch.arange(6, dtype=torch.float32) + rank,
             "b": torch.ones(3)}
        if poison and rank == 3:
            g["w"][2] = float("inf")
        grads, st = scaler.unscale_(g, state)
        new = scaler.update(st)
        out[poison] = dict(grads=grads, found_inf=float(st.found_inf),
                           scale=float(new.loss_scale))
    return out


def _rank_main(rank, inp):
    out = {}
    # pp = 4
    r = ps.get_pipeline_model_parallel_rank()
    out[4] = dict(p2p=_p2p_cases(r, 4), lin=_lin_cases(inp["lin"], 4, r),
                  inter={v: _inter_cases(inp["inter"][v], 4, r, v,
                                         extra=v == 2) for v in VS},
                  dropout=_dropout_case(inp["lin"], r),
                  remat=_remat_case(inp["lin"], r),
                  tied=_tied_case(inp, r), gpt=_gpt_case(inp),
                  bound=_bound_cases(inp, r))
    # pp = 2 x dp = 2: ranks 0 and 2, 1 and 3 are two pipelines
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(1, 2)
    r = ps.get_pipeline_model_parallel_rank()
    lin2 = inp["lin2"]
    out[2] = dict(p2p=_p2p_cases(r, 2), lin=_lin_cases(lin2, 2, r),
                  inter=_inter_cases(lin2["inter"], 2, r, 2, extra=False),
                  bound=_bound_cases(inp, r), llama=_llama_cases(inp))
    # tp = 2 x pp = 2
    ps.destroy_model_parallel()
    ps.initialize_model_parallel(2, 2)
    out["tp2"] = dict(llama=_llama_cases(inp, tp=2),
                      scaler=_scaler_case(rank),
                      ranks=(ps.get_tensor_model_parallel_rank(),
                             ps.get_pipeline_model_parallel_rank()))
    return out


@pytest.fixture(scope="module")
def port_runs(tmp_path_factory):
    """Every rank-side case: ``[rank][4 | 2 | "tp2"] -> {case: result}``."""
    inputs = _inputs()
    return inputs, spawn_ranks(4, _rank_main, inputs,
                               pipeline_model_parallel_size=4,
                               tmp_dir=str(tmp_path_factory.mktemp("pp")))


# -- the JAX side (JAX imported here only) -----------------------------------

_JAX: dict = {}


def _jax_pipe(key, pp, fn, stacked=(), replicated=(), tp=1):
    """``fn(*local, *replicated)`` on each rank of a tp x pp mesh of the
    first host devices under ``shard_map``, computed once a key:
    ``stacked`` arrays lead with the pipe rank (tp ranks share them),
    the outputs stacked by rank (``[pp]``, or ``[pp, tp]``)."""
    if key in _JAX:
        return _JAX[key]
    import jax
    from jax.sharding import PartitionSpec as P
    from apex_tpu.transformer import parallel_state as jps
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(tp, pp, devices=jax.devices()[:tp * pp])
    mesh = jps.get_mesh()
    axes = ("pipe",) if tp == 1 else ("pipe", "tensor")

    def body(*args):
        local = [jax.tree.map(lambda x: x[0], a)
                 for a in args[:len(stacked)]] + list(args[len(stacked):])
        out = fn(*local)
        return jax.tree.map(lambda o: o[(None,) * len(axes)], out)

    try:
        out = jax.tree.map(np.asarray, jax.jit(functools.partial(
            jax.shard_map, check_vma=False)(
            body, mesh=mesh,
            in_specs=tuple([P("pipe")] * len(stacked)
                           + [P()] * len(replicated)),
            out_specs=P(*axes)))(*stacked, *replicated))
    finally:
        jps.destroy_model_parallel()
    _JAX[key] = out
    return out


def _j_stage(p, x, mb):
    import jax
    return jax.nn.gelu(x @ p["w"] + p["b"])


def _j_cond_stage(p, x, mb):
    return _j_stage(p, x, mb) + mb["cond"]


def _j_mse(y, mb):
    import jax.numpy as jnp
    return jnp.mean((y - mb["target"]) ** 2)


def _jax_lin(key, pp, inp):
    from apex_tpu.transformer.pipeline_parallel import (
        forward_backward_pipelining_without_interleaving as f)

    def fn(local, batch):
        kw = dict(num_microbatches=N, input_fn=lambda mb: mb["x"])
        return {"1f1b": f(_j_stage, _j_mse, local, batch, **kw),
                "gpipe": f(_j_stage, _j_mse, local, batch, use_1f1b=False,
                           **kw),
                "forward_only": f(_j_stage, _j_mse, local, batch,
                                  forward_only=True, **kw)[0],
                "cond": f(_j_cond_stage, _j_mse, local, batch, **kw)}
    return _jax_pipe(key, pp, fn, (inp["params"],), (inp["batch"],))


def _jax_inter(key, pp, v, inp, extra=True):
    import jax
    from apex_tpu.transformer.pipeline_parallel import (
        forward_backward_pipelining_with_interleaving as f)
    chunked = jax.tree.map(
        lambda p: p.reshape(v, pp, *p.shape[1:]).swapaxes(0, 1),
        inp["params"])

    def fn(local, batch):
        kw = dict(num_microbatches=N_I, input_fn=lambda mb: mb["x"],
                  virtual_pipeline_model_parallel_size=v)
        out = {"run": f(_j_stage, _j_mse, local, batch, **kw)}
        if extra:
            out["cond"] = f(_j_cond_stage, _j_mse, local, batch, **kw)
            out["forward_only"] = f(_j_stage, _j_mse, local, batch,
                                    forward_only=True, **kw)[0]
        return out
    return _jax_pipe(key, pp, fn, (chunked,), (inp["batch"],))


def _jax_ref(params, batch, stages, n, stage=_j_stage):
    """JAX's no-pipelining executor over all the stages in turn."""
    import jax
    from apex_tpu.transformer.pipeline_parallel import (
        forward_backward_no_pipelining)

    def full(p, x, mb):
        for s in range(stages):
            x = stage(jax.tree.map(lambda a, s=s: a[s], p), x, mb)
        return x
    return jax.tree.map(np.asarray, forward_backward_no_pipelining(
        full, _j_mse, jax.tree.map(jax.numpy.asarray, params),
        jax.tree.map(jax.numpy.asarray, batch), num_microbatches=n,
        input_fn=lambda mb: mb["x"]))


def _jax_gpt_params():
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer import parallel_state as jps
    from apex_tpu.transformer.testing import GPTConfig as JCfg
    from apex_tpu.transformer.testing.standalone_gpt import (
        ParallelTransformerLayer)
    jps.destroy_model_parallel()
    jps.initialize_model_parallel(1, 4, devices=jax.devices()[:4])
    try:
        layer = ParallelTransformerLayer(JCfg(**GPT), causal=True)
        params = layer.init(jax.random.PRNGKey(3), jnp.zeros(
            (GPT_SEQ, GPT_BS, GPT["hidden_size"])), None, True)
    finally:
        jps.destroy_model_parallel()
    return jax.tree.map(np.asarray, params)


def _jax_gpt(inp):
    import jax.numpy as jnp
    from apex_tpu.transformer.pipeline_parallel import (
        forward_backward_pipelining_without_interleaving as f)
    from apex_tpu.transformer.testing import GPTConfig as JCfg
    from apex_tpu.transformer.testing.standalone_gpt import (
        ParallelTransformerLayer)
    layer = ParallelTransformerLayer(JCfg(**GPT), causal=True)

    def fn(params, batch):
        loss, grads = f(
            lambda p, x, mb: layer.apply(p, x, None, True),
            lambda y, mb: jnp.mean((y - mb["t"]) ** 2), params, batch,
            num_microbatches=GPT_MICRO, input_fn=lambda mb: mb["x"])
        return loss, grads
    return _jax_pipe("gpt", 4, fn, (), (inp["gpt_params"], inp["gpt"]))


def _jax_tied(t):
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.pipeline_parallel import (
        embedding_grads_all_reduce,
        forward_backward_pipelining_without_interleaving as f)

    def stage_fn(params, x, mb):
        stage = jax.lax.axis_index("pipe")
        x = jnp.where(stage == 0, params["embed"][mb["tokens"]], x)
        return x + jax.nn.gelu(x @ params["w"])

    def loss_fn(y, mb, params):
        logp = jax.nn.log_softmax(y @ params["embed"].T, axis=-1)
        return -jnp.mean(jnp.take_along_axis(
            logp, mb["labels"][..., None], axis=-1))

    def fn(w, embed, batch, per_stage):
        params = {"embed": embed, "w": w}
        loss, grads = f(stage_fn, loss_fn, params, batch,
                        num_microbatches=4,
                        input_fn=lambda mb: jnp.zeros((MBS, 6, HID)))
        grads["embed"] = embedding_grads_all_reduce(grads["embed"])
        return loss, grads, embedding_grads_all_reduce(
            per_stage * jax.lax.axis_index("pipe").astype(jnp.float32))
    return _jax_pipe("tied", 4, fn, (t["w"],),
                     (t["embed"], {"tokens": t["tokens"],
                                   "labels": t["labels"]},
                      np.ones(5, np.float32)))


def _jax_llama(inp):
    """JAX's 1F1B (3-arg loss: the final norm and head train) and
    interleaved v = 2 (the norm and head a frozen closure) over the JAX
    LLaMA's blocks at pp = 2."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.normalization import fused_rms_norm as jnorm
    from apex_tpu.transformer.pipeline_parallel import (
        forward_backward_pipelining_with_interleaving as fi,
        forward_backward_pipelining_without_interleaving as f)
    from apex_tpu.transformer.tensor_parallel import (
        vocab_parallel_cross_entropy as jxent)
    from apex_tpu.transformer.testing import LlamaConfig as JCfg
    from apex_tpu.transformer.testing.standalone_llama import LlamaBlock
    tree, batch = inp["llama"]["tree"], inp["llama"]["batch"]
    block = LlamaBlock(JCfg(**LLAMA))
    embed = tree["embed_tokens"]["weight"]

    def stage(p, x, mb):
        for layer in p["layers"]:
            x = block.apply({"params": layer}, x)
        return x

    def head(y, mb, norm_w, head_w):
        h = jnorm(y, (LLAMA["hidden_size"],), norm_w, 1e-5)
        return jxent((h @ head_w.T).astype(jnp.float32),
                     mb["labels"].T).mean()

    def fn(stages, chunks, batch, norm_w, head_w):
        kw = dict(num_microbatches=LN_MICRO,
                  input_fn=lambda mb: jnp.asarray(embed)[mb["tokens"]]
                  .transpose(1, 0, 2))
        a = f(stage, lambda y, mb, p: head(y, mb, p["final_norm"]["weight"],
                                           p["lm_head"]["weight"]),
              stages, batch, **kw)
        b = fi(lambda p, x, mb: block.apply({"params": p["layer"]}, x),
               lambda y, mb: head(y, mb, norm_w, head_w), chunks, batch,
               virtual_pipeline_model_parallel_size=2, **kw)
        return {"1f1b": a, "inter": b}

    stages = jax.tree.map(lambda *a: np.stack(a),
                          *[_llama_stage_tree(tree, r) for r in range(2)])
    chunks = jax.tree.map(lambda *a: np.stack(a), *[
        {"layer": jax.tree.map(lambda *c: np.stack(c), *[
            tree[f"layer_{c * 2 + r}"] for c in range(2)])}
        for r in range(2)])
    return _jax_pipe("llama", 2, fn, (stages, chunks),
                     (batch, tree["final_norm"]["weight"],
                      tree["lm_head"]["weight"]))


def _jax_scaler():
    """JAX's GradScaler on the same grads over a tp 2 x pp 2 mesh, the inf
    on the rank at (pipe 1, tensor 1)."""
    import jax
    import jax.numpy as jnp
    from apex_tpu.transformer.amp import GradScaler as JScaler

    def fn(rank, poison):
        scaler = JScaler(init_scale=4.0)
        state = scaler.init()
        g = {"w": jnp.arange(6, dtype=jnp.float32) + rank,
             "b": jnp.ones(3)}
        g["w"] = g["w"].at[2].set(jnp.where(
            (rank == 3) & (poison > 0), jnp.inf, g["w"][2]))
        grads, st = scaler.unscale_(g, state)
        new = scaler.update(st)
        return grads, st.found_inf, new.loss_scale

    def body(poison):
        rank = (jax.lax.axis_index("pipe") * 2
                + jax.lax.axis_index("tensor")).astype(jnp.float32)
        return fn(rank, poison)
    return {p: _jax_pipe(("scaler", p), 2, body, (),
                         (np.float32(p),), tp=2) for p in (0, 1)}


# -- the tests ---------------------------------------------------------------

def _order(pp):
    """The global ranks of the first pipeline, by pipe rank: all four at
    pp = 4; at pp = 2 x dp = 2, data rank 0's (global ranks 0 and 2)."""
    return [0, 1, 2, 3] if pp == 4 else [0, 2]


def _hold_run(got_ranks, want, tol=TOL):
    """Each rank's (loss, grads) against JAX's, stacked by rank."""
    loss_w, grads_w = want
    for r, (loss, grads) in enumerate(got_ranks):
        _close(_np(loss), loss_w[r], tol)
        _close_tree(_tree_np(grads), _tree_np_index(grads_w, r), tol)


@pytest.mark.parametrize("case", ["1f1b", "gpipe", "cond"])
@pytest.mark.parametrize("pp", [4, 2])
def test_executors_match_jax(port_runs, pp, case):
    """1F1B, the GPipe oracle and per-microbatch conditioning (stage_fn
    sees the microbatch its activation belongs to): every rank's loss
    and grads against the JAX executor's on the same inputs."""
    inp, ranks = port_runs
    data = inp["lin"] if pp == 4 else inp["lin2"]
    want = _jax_lin(("lin", pp), pp, data)[case]
    _hold_run([ranks[g][pp]["lin"][case] for g in _order(pp)], want)


@pytest.mark.parametrize("pp", [4, 2])
def test_forward_only_matches_jax(port_runs, pp):
    inp, ranks = port_runs
    data = inp["lin"] if pp == 4 else inp["lin2"]
    want = _jax_lin(("lin", pp), pp, data)["forward_only"]
    for r, g in enumerate(_order(pp)):
        loss, grads = ranks[g][pp]["lin"]["forward_only"]
        assert grads is None
        _close(_np(loss), want[r])


def test_no_pipelining_and_pipelines_match_the_sequential_reference(
        port_runs):
    """The port's no-pipelining executor (one process) against JAX's, and
    the pipelined losses and grads against it."""
    inp, ranks = port_runs
    lin = inp["lin"]

    def full(p, x, mb):
        for s in range(4):
            x = _stage({k: t[s] for k, t in p.items()}, x, mb)
        return x
    loss, grads = tpp.forward_backward_no_pipelining(
        full, _mse, _to_t(lin["params"]), _tbatch(lin["batch"]),
        num_microbatches=N, input_fn=_input)
    want_loss, want_grads = _jax_ref(lin["params"], lin["batch"], 4, N)
    _close(_np(loss), want_loss)
    _close_tree(_tree_np(grads), want_grads)
    got = {k: np.stack([_np(ranks[g][4]["lin"]["1f1b"][1][k])
                        for g in range(4)]) for k in grads}
    _close_tree(got, _tree_np(grads))


@pytest.mark.parametrize("v", VS)
def test_interleaved_matches_jax(port_runs, v):
    """v chunks x 4 stages: each rank's loss and [v, ...] grads."""
    inp, ranks = port_runs
    want = _jax_inter(("inter", 4, v), 4, v, inp["inter"][v],
                      extra=v == 2)["run"]
    _hold_run([ranks[g][4]["inter"][v]["run"] for g in range(4)], want)


def test_interleaved_at_pp2_matches_jax(port_runs):
    inp, ranks = port_runs
    want = _jax_inter(("inter", 2, 2), 2, 2, inp["lin2"]["inter"],
                      extra=False)["run"]
    _hold_run([ranks[g][2]["inter"]["run"] for g in (0, 2)], want)


def test_interleaved_stage_fn_sees_the_right_microbatch(port_runs):
    inp, ranks = port_runs
    want = _jax_inter(("inter", 4, 2), 4, 2, inp["inter"][2])["cond"]
    _hold_run([ranks[g][4]["inter"][2]["cond"] for g in range(4)], want)


def test_interleaved_forward_only_and_indivisible_microbatches(port_runs):
    inp, ranks = port_runs
    want = _jax_inter(("inter", 4, 2), 4, 2, inp["inter"][2])["forward_only"]
    for g in range(4):
        case = ranks[g][4]["inter"][2]
        assert case["forward_only"][1] is None
        _close(_np(case["forward_only"][0]), want[g])
        assert case["indivisible"] is not None
        assert "multiple of the pipeline" in case["indivisible"]


def test_interleaved_phase_ticks_and_bubble_shrink_with_v():
    from apex_tpu.transformer.pipeline_parallel import (
        interleaved_phase_ticks as jticks)
    n, pp = 32, 4

    def bubble(v):
        warm, steady, cool = tpp.interleaved_phase_ticks(n, pp, v)
        return (warm + cool) / (2 * v) + steady / v - n

    for args in [(n, pp, v) for v in (1, 2, 3, 4)] + [(8, 2, 2), (6, 3, 1)]:
        assert tpp.interleaved_phase_ticks(*args) == jticks(*args)
    assert bubble(1) == pytest.approx(pp - 1)
    for v in (2, 4):
        assert bubble(v) == pytest.approx((pp - 1) / v)
    assert bubble(4) < bubble(2) < bubble(1)


@pytest.mark.parametrize("pp", [4, 2])
def test_in_flight_graphs_bounded_in_microbatches(port_runs, pp):
    """1F1B holds at most 2 (pp - 1) + 1 microbatch graphs on a rank,
    the same count at n = 4 and n = 8 once n reaches the bound; the GPipe
    oracle holds all n; interleaved stays within 2 v pp, the same at 8
    and 16 microbatches."""
    _, ranks = port_runs
    bound = 2 * (pp - 1) + 1
    for stage, g in enumerate(_order(pp)):
        b = ranks[g][pp]["bound"]
        want = [min(n, 2 * (pp - 1 - stage) + 1) for n in BOUND_NS]
        assert [b[n, True] for n in BOUND_NS] == want
        assert all(b[n, True] <= bound for n in BOUND_NS + (16,))
        assert [b[n, False] for n in BOUND_NS] == list(BOUND_NS)
        assert b[8, "inter"] == b[16, "inter"] <= 2 * 2 * pp
    if pp == 2:
        first = ranks[0][2]["bound"]
        assert first[4, True] == first[8, True] == bound


def test_per_microbatch_dropout_matches_the_sequential_replay(port_runs):
    """Each (stage, microbatch) draws its own mask from the microbatch's
    seed and the pipe rank; the 1F1B run matches a sequential replay of
    the same draws."""
    inp, ranks = port_runs
    lin = inp["lin"]
    params = _to_t(lin["params"])
    batch = _tbatch(lin["batch"])
    batch["seed"] = torch.arange(N)

    def full(p, x, mb):
        for s in range(4):
            x = _drop(_stage({k: t[s] for k, t in p.items()}, x, mb),
                      mb["seed"], s)
        return x
    loss, grads = tpp.forward_backward_no_pipelining(
        full, _mse, params, batch, num_microbatches=N, input_fn=_input)
    for g in range(4):
        got_loss, got_grads = ranks[g][4]["dropout"]
        _close(_np(got_loss), _np(loss), TOL_REPLAY)
        _close_tree(_tree_np(got_grads),
                    {k: _np(v[g]) for k, v in grads.items()}, TOL_REPLAY)


def test_remat_stage_matches_and_saves_fewer_bytes(port_runs):
    _, ranks = port_runs
    for g in range(4):
        case = ranks[g][4]["remat"]
        _close(_np(case["ck"][0]), _np(case["raw"][0]), TOL_REPLAY)
        _close_tree(_tree_np(case["ck"][1]), _tree_np(case["raw"][1]),
                    TOL_REPLAY)
        assert case["ck_bytes"] < case["raw_bytes"], (
            case["ck_bytes"], case["raw_bytes"])


@pytest.mark.parametrize("pp", [4, 2])
def test_p2p_functions_rotate_the_ring(port_runs, pp):
    """Each function moves a payload one stage forward (+1) or backward
    (-1), wrap-around included; pytrees; a round trip is the identity;
    the reference's kwargs are accepted; at pp = 2 the steady tick's two
    payloads arrive each in its own direction."""
    _, ranks = port_runs
    fwd = {"send_forward", "recv_forward", "send_forward_recv_forward",
           "kwargs"}
    for r, g in enumerate(_order(pp)):
        out = ranks[g][pp]["p2p"]
        prev, nxt = (r - 1) % pp, (r + 1) % pp
        for name, got in out.items():
            if name in fwd:
                assert got.tolist() == [float(prev)] * 4, name
            elif name in ("send_backward", "recv_backward",
                          "send_backward_recv_backward"):
                assert got.tolist() == [float(nxt)] * 4, name
        fa, bg = out["send_forward_recv_backward"]
        assert fa.tolist() == [float(prev)] * 4
        assert bg.tolist() == [100.0 + nxt] * 4
        bg, fa = out["send_backward_recv_forward"]
        assert bg.tolist() == [100.0 + nxt] * 4
        assert fa.tolist() == [float(prev)] * 4
        tree = out["pytree"]
        assert tree["x"].tolist() == [float(prev)]
        assert tree["y"][0].tolist() == [float(prev)] * 2
        assert tree["y"][1].tolist() == [prev, prev + 1, prev + 2]
        assert tree["y"][1].dtype == torch.int64
        assert out["roundtrip"].tolist() == [r + 0.5] * 4


def test_tied_embedding_grads_match_jax(port_runs):
    """A tied head through the 3-arg loss; ``embedding_grads_all_reduce``
    sums the first and last stages' embedding grads onto every stage
    (the middle stages contribute zeros)."""
    inp, ranks = port_runs
    loss_w, grads_w, masked_w = _jax_tied(inp["tied"])
    for g in range(4):
        case = ranks[g][4]["tied"]
        _close(_np(case["loss"]), loss_w[g])
        _close_tree(_tree_np(case["grads"]),
                    {k: v[g] for k, v in grads_w.items()})
        assert case["masked"].tolist() == masked_w[g].tolist() == [3.0] * 5


def test_gpt_layer_stage_matches_jax(port_runs):
    """The trace-cost test's stage: pp = 4 over GPT's
    ``ParallelTransformerLayer`` (the same weights on every stage)."""
    inp, ranks = port_runs
    loss_w, grads_w = _jax_gpt(inp)
    names = [n for n in _flat(inp["gpt_params"]["params"])]
    for g in range(4):
        loss, grads = ranks[g][4]["gpt"]
        _close(_np(loss), loss_w[g])
        want = _flat(grads_w["params"])
        for name in names:
            _close(_np(grads[name]), want[name][g])


@pytest.mark.parametrize("case", ["1f1b", "inter"])
def test_llama_pipeline_matches_jax(port_runs, case):
    """The slice: the port's LLaMA blocks at pp = 2 (1F1B with the head
    trained through the 3-arg loss; interleaved v = 2 with the head
    frozen) against the JAX LLaMA's blocks under the JAX executors."""
    inp, ranks = port_runs
    loss_w, grads_w = _jax_llama(inp)[case]
    for r, g in enumerate((0, 2)):
        loss, grads = ranks[g][2]["llama"][case]
        _close(_np(loss), loss_w[r])
        _close_tree(_tree_np(grads), _tree_np_index(grads_w, r))


def test_llama_pp2_tp2_matches_pp2_tp1(port_runs):
    """The tensor-parallel layers as stages: each rank's shard of the
    pp 2 x tp 2 grads against the same shard of pp 2 at tp 1."""
    inp, ranks = port_runs
    cfg = LlamaConfig(**LLAMA)
    for g in range(4):
        tr, pr = ranks[g]["tp2"]["ranks"]
        loss, grads = ranks[g]["tp2"]["llama"]["1f1b"]
        ref_loss, ref_grads = ranks[2 * pr][2]["llama"]["1f1b"]
        _close(_np(loss), _np(ref_loss))
        full = _tree_np(ref_grads)
        per = LLAMA["num_layers"] // 2
        flat_tree = {f"layer_{pr * per + i}": lay
                     for i, lay in enumerate(full["layers"])}
        flat_tree.update(final_norm=full["final_norm"],
                         lm_head=full["lm_head"])
        want = shard_llama_params(flat_tree, cfg, 2, tr)
        got = _tree_np(grads)
        for i in range(per):
            _close_tree(got["layers"][i], want[f"layer_{pr * per + i}"])
        _close_tree(got["final_norm"], want["final_norm"])
        _close_tree(got["lm_head"], want["lm_head"])


def test_grad_scaler_shares_a_rank_local_overflow(port_runs):
    """tp 2 x pp 2: an inf in one rank's grads sets found_inf on all four
    ranks, every rank halves its scale; clean grads unscale as JAX's."""
    _, ranks = port_runs
    want = _jax_scaler()
    for g in range(4):
        tr, pr = ranks[g]["tp2"]["ranks"]
        assert g == 2 * pr + tr
        for poison in (False, True):
            got = ranks[g]["tp2"]["scaler"][poison]
            grads_w, flag_w, scale_w = want[int(poison)]
            assert got["found_inf"] == float(flag_w[pr, tr]) == float(poison)
            assert got["scale"] == float(scale_w[pr, tr]) == \
                (2.0 if poison else 4.0)
            if not poison:
                _close_tree(_tree_np(got["grads"]),
                            {k: v[pr, tr] for k, v in grads_w.items()}, 0.0)


def test_pipelined_calls_without_topology_raise():
    """A pipe axis name without the topology raises, naming
    initialize_model_parallel: a pipeline never runs quietly as one
    rank."""
    ps.destroy_model_parallel()
    p = {"w": torch.eye(HID), "b": torch.zeros(HID)}
    batch = {"x": torch.zeros(2, MBS, HID), "target": torch.zeros(
        2, MBS, HID)}
    calls = [
        lambda: tpp.forward_backward_pipelining_without_interleaving(
            _stage, _mse, p, batch, num_microbatches=2, input_fn=_input),
        lambda: tpp.forward_backward_pipelining_with_interleaving(
            _stage, _mse, {k: t[None] for k, t in p.items()}, batch,
            num_microbatches=2, input_fn=_input,
            virtual_pipeline_model_parallel_size=2),
        lambda: p2p.send_forward(torch.zeros(2)),
        lambda: p2p.send_backward_recv_forward(torch.zeros(2),
                                               torch.zeros(2)),
        lambda: tpp.embedding_grads_all_reduce(torch.zeros(2))]
    for call in calls:
        with pytest.raises(RuntimeError, match="initialize_model_parallel"):
            call()
