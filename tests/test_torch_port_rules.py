"""The port's standing rules: it imports neither JAX nor the JAX
package, its entry points refuse to fall back to the CPU, CPU tensors
never touch a kernel, and the slice's out-of-scope configurations say
so instead of running something else.
"""
import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from apex_tpu_torch import multi_tensor_apply as mta
from apex_tpu_torch.inference import InferenceEngine
from apex_tpu_torch.inference.kv_cache import init_cache, init_paged_cache
from apex_tpu_torch.inference.weights import (bert_param_shapes,
                                              gpt_param_shapes,
                                              llama_param_shapes)
from apex_tpu_torch.ops import (_build, flash_attention, fused_adam_flat,
                                fused_scale, paged_decode_attention, rms_norm)
from apex_tpu_torch.ops import attention as tattn
from apex_tpu_torch.ops.attention import decode_attention
from apex_tpu_torch.ops.fused_update import (fused_adagrad_flat,
                                             fused_l2norm,
                                             fused_lamb_phase1_flat,
                                             fused_sgd_flat)
from apex_tpu_torch.ops.paged_attention import fused_block_decode
from apex_tpu_torch.ops.ring_attention import ring_attention
from apex_tpu_torch.ops.ulysses_attention import ulysses_attention
from apex_tpu_torch.transformer.testing import (BertConfig, GPTConfig,
                                                LlamaConfig)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "apex_tpu_torch"
LLAMA_KW = dict(vocab_size=64, hidden_size=32, num_layers=1,
                num_attention_heads=4, num_kv_heads=2, max_seq_length=64)
GPT_KW = dict(vocab_size=64, hidden_size=32, num_layers=1,
              num_attention_heads=4, max_seq_length=64)
CFG = LlamaConfig(**LLAMA_KW)
GPT_CFG = GPTConfig(**GPT_KW)
BERT_CFG = BertConfig(vocab_size=64, hidden_size=32, num_layers=1,
                      num_attention_heads=4, max_seq_length=64)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _params(cfg=CFG, shapes=llama_param_shapes):
    tree: dict = {}
    for path, shape in shapes(cfg).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = torch.zeros(shape)
    return tree


def test_fresh_process_imports_no_jax_and_no_apex_tpu():
    code = (
        "import importlib, pkgutil, sys\n"
        "import apex_tpu_torch\n"
        "for m in pkgutil.walk_packages(apex_tpu_torch.__path__,\n"
        "                                'apex_tpu_torch.'):\n"
        "    if m.name != 'apex_tpu_torch.parallel.multiproc':\n"
        "        importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'flax', 'apex_tpu'))\n"
        "print(len([m for m in sys.modules\n"
        "           if m.startswith('apex_tpu_torch')]), bad)\n"
        "sys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.split()[0]) >= 25      # every module was loaded


def test_ast_scan_no_jax_or_apex_tpu_imports():
    banned = {"jax", "jaxlib", "flax", "apex_tpu"}
    offenders = []
    for path in _sources():
        for node in ast.walk(ast.parse(path.read_text())):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            offenders += [f"{path.name}: {n}" for n in names
                          if n.split(".")[0] in banned]
    assert not offenders, offenders
    assert len(_sources()) >= 25
    # the last slices' modules are among those scanned
    scanned = {p.relative_to(ROOT).as_posix() for p in _sources()}
    tp = "apex_tpu_torch/transformer/tensor_parallel/"
    pp = "apex_tpu_torch/transformer/pipeline_parallel/"
    tr = "apex_tpu_torch/transformer/"
    assert {"apex_tpu_torch/multi_tensor_apply/__init__.py",
            "apex_tpu_torch/ops/attention.py",
            "apex_tpu_torch/ops/fused_update.py",
            "apex_tpu_torch/transformer/utils.py",
            tp + "mappings.py", tp + "random.py", tp + "data.py",
            tp + "memory.py", tp + "layers.py",
            tp + "cross_entropy.py", pp + "__init__.py", pp + "common.py",
            pp + "p2p_communication.py", pp + "schedules.py",
            pp + "utils.py", tr + "microbatches.py", tr + "amp/__init__.py",
            tr + "amp/grad_scaler.py", tr + "testing/batch_sampler.py",
            tr + "testing/commons.py", "apex_tpu_torch/ops/ring_attention.py",
            "apex_tpu_torch/ops/ulysses_attention.py",
            "apex_tpu_torch/parallel/_comm.py",
            tr + "testing/standalone_gpt.py", tr + "moe/__init__.py",
            tr + "moe/router.py", tr + "moe/experts.py",
            tr + "moe/layer.py"} <= scanned


def test_fp32_routes_without_an_instance_raise_naming_v10(monkeypatch):
    """The CUDA routes of fp32 outputs that still have no instance raise
    ``NotImplementedError`` naming ROADMAP V10 before any launch: a mask
    (the forward, the one-pass and the split backward) and the wide
    family's 16-bit operands.  Operands on the ``meta`` device take the
    CUDA routes without a card (only a CPU tensor takes the plain
    version) and cannot launch."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.ops import attention as tattn
    meta = dict(device="meta")
    bf = [torch.empty(4, 64, 128, dtype=torch.bfloat16, **meta)
          for _ in range(4)]
    h16 = [t.half() for t in bf]
    lse = torch.empty(4, 64, dtype=torch.float32, **meta)
    mask3 = torch.empty(1, 64, 64, dtype=torch.bool, **meta)
    f32 = dict(out_dtype=torch.float32)
    calls = [
        lambda: tattn._fwd(*bf[:3], True, 0.1, mask3=mask3, **f32),
        lambda: tattn._fwd(*h16[:3], True, 0.1, **f32),
        lambda: tattn._bwd(*bf[:3], bf[0], lse, bf[3], True, 0.1,
                           mask3=mask3, **f32),
        lambda: tattn._bwd(*h16[:3], h16[0], lse, h16[3], True, 0.1, **f32)]
    for call in calls:
        with pytest.raises(NotImplementedError, match="V10"):
            call()
    monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", 0)
    for call in calls[2:] + [lambda: tattn._dq_kernel(
            *bf[:3], lse, lse, bf[3], True, 0.1, mask3=mask3, f32=True),
            lambda: tattn._dkv_kernel(
                *bf[:3], lse, lse, bf[3], True, 0.1, mask3=mask3, f32=True)]:
        with pytest.raises(NotImplementedError, match="V10"):
            call()
    assert not any(_build.launch_counts().values())


def test_context_ops_call_no_plain_version():
    """Ring and Ulysses attention reach the kernels only through the
    routed entries (``_fwd``, ``_bwd``, ``flash_attention``), which on
    CUDA launch a kernel or raise: no function of theirs but the ring's
    oracle calls a plain version (a ``*_reference``), so a CUDA tensor
    never falls back to one."""
    called = {}
    for name in ("ring_attention", "ulysses_attention"):
        tree = ast.parse((PORT / "ops" / f"{name}.py").read_text())
        for top in tree.body:
            if not isinstance(top, (ast.FunctionDef, ast.ClassDef)) \
                    or top.name == "ring_attention_reference":
                continue
            for node in ast.walk(top):
                if isinstance(node, ast.Call):
                    f = node.func
                    fname = f.id if isinstance(f, ast.Name) else getattr(
                        f, "attr", "")
                    called.setdefault(name, set()).add(fname)
    assert {"_fwd", "_bwd"} <= called["ring_attention"]
    assert "flash_attention" in called["ulysses_attention"]
    assert not [f for fs in called.values() for f in fs
                if f.endswith("_reference")], called


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine("llama", CFG, _params(), slots=1, page_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_paged_cache(4, 1, 2, 16, 8, slots=1, max_pages_per_slot=4)
    with pytest.raises(RuntimeError):
        init_paged_cache(4, 1, 2, 16, 8, slots=1, max_pages_per_slot=4,
                         device="cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(1, 1, 2, 16, 8)
    eng = InferenceEngine("llama", CFG, _params(), slots=1, page_size=16,
                          device="cpu")
    assert eng.device.type == "cpu" and eng.init_cache().k.device.type == "cpu"


def _fused_args(hidden=32, h=4, kvh=2, d=8, ffn=48):
    """A tiny fused-layout layer on the CPU and its pool operands."""
    g = torch.Generator().manual_seed(0)
    blk = {n: torch.randn(shape, generator=g) for n, shape in (
        ("ln1_w", (1, hidden)), ("wq", (hidden, h * d)),
        ("wk", (hidden, kvh * d)), ("wv", (hidden, kvh * d)),
        ("wo", (h * d, hidden)), ("ln2_w", (1, hidden)),
        ("wg", (hidden, ffn)), ("wu", (hidden, ffn)), ("wd", (ffn, hidden)))}
    pool = torch.randn(3, kvh, 4, d, generator=g)
    return (torch.randn(1, hidden, generator=g), blk, pool, pool,
            torch.zeros(1, 2, dtype=torch.int32),
            torch.tensor([5], dtype=torch.int32))


def _fused_kw(**kw):
    return dict(dict(kind="llama", eps=1e-5, cos=torch.ones(1, 8),
                     sin=torch.zeros(1, 8)), **kw)


def _gpt_fused_args(hidden=32, h=4, d=8, ffn=48):
    """A tiny GPT layer in the fused layout, its pool operands as
    :func:`_fused_args`'."""
    x, _, pool, _, table, lengths = _fused_args(hidden, h, h, d, ffn)
    g = torch.Generator().manual_seed(1)
    blk = {n: torch.randn(shape, generator=g) for n, shape in (
        ("ln1_w", (1, hidden)), ("ln1_b", (1, hidden)),
        ("wq", (hidden, h * d)), ("bq", (1, h * d)),
        ("wk", (hidden, h * d)), ("bk", (1, h * d)),
        ("wv", (hidden, h * d)), ("bv", (1, h * d)),
        ("wo", (h * d, hidden)), ("bo", (1, hidden)),
        ("ln2_w", (1, hidden)), ("ln2_b", (1, hidden)),
        ("wu", (hidden, ffn)), ("bu", (1, ffn)), ("wd", (ffn, hidden)),
        ("bd", (1, hidden)))}
    return x, blk, pool, pool, table, lengths


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing(
        monkeypatch):
    _build.reset_launch_counts()
    x = torch.randn(4, 96, requires_grad=True)
    rms_norm(x, torch.ones(96)).sum().backward()
    q = torch.randn(1, 2, 8, 16, requires_grad=True)
    flash_attention(q, q, q, causal=True).sum().backward()
    # the split backward's route too: the gate below this [8, 16] dq
    monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", 8 * 16 * 4 - 1)
    flash_attention(q, q, q, causal=True).sum().backward()
    pool = torch.randn(3, 2, 4, 16)
    paged_decode_attention(torch.randn(1, 2, 16), pool, pool,
                           torch.zeros(1, 2, dtype=torch.int32),
                           torch.tensor([5], dtype=torch.int32))
    # the wide family's routes: a padded bf16 head dim, a group of 3
    qw = torch.randn(1, 2, 8, 80).to(torch.bfloat16).requires_grad_()
    flash_attention(qw, qw, qw, causal=True).float().sum().backward()
    paged_decode_attention(torch.randn(1, 6, 16), pool, pool,
                           torch.zeros(1, 2, dtype=torch.int32),
                           torch.tensor([5], dtype=torch.int32))
    flat = torch.randn(100)
    fused_scale(flat, 0.5)
    fused_adam_flat(flat, torch.randn(100), torch.zeros(100),
                    torch.zeros(100), lr=1e-3, beta1=0.9, beta2=0.999,
                    eps=1e-8, weight_decay=0.0, step=1.0)
    fused_l2norm(flat)
    fused_lamb_phase1_flat(flat, torch.randn(100), torch.zeros(100),
                           torch.zeros(100), beta1=0.9, beta2=0.999,
                           eps=1e-6, weight_decay=0.01, step=1.0)
    fused_sgd_flat(flat, torch.randn(100), torch.zeros(100), lr=0.1,
                   momentum=0.9, dampening=0.0, weight_decay=0.0,
                   first_run=True)
    fused_adagrad_flat(flat, torch.randn(100), torch.zeros(100), lr=0.1,
                       eps=1e-10, weight_decay=0.0)
    y, kt, vt = fused_block_decode(*_fused_args(), **_fused_kw())
    assert tuple(y.shape) == (1, 32) and tuple(kt.shape) == (1, 2, 8)
    y, kt, vt = fused_block_decode(*_gpt_fused_args(), kind="gpt", eps=1e-5)
    assert tuple(y.shape) == (1, 32) and tuple(kt.shape) == (1, 4, 8)
    # the masked flash forward and backward, dropout on both routes of
    # the backward, and decode_attention's kernel branch
    mask = torch.rand(1, 1, 8, 8) > 0.5
    flash_attention(q, q, q, mask=mask, dropout_rate=0.1,
                    dropout_seed=3).sum().backward()
    monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", 2 ** 21)
    flash_attention(q, q, q, mask=mask, dropout_rate=0.1,
                    dropout_seed=3).sum().backward()
    decode_attention(torch.randn(2, 4, 16), torch.randn(2, 2, 40, 16),
                     torch.randn(2, 2, 40, 16),
                     torch.tensor([0, 7], dtype=torch.int32), use_kernel=True)
    # ring attention's fp32-output routes on bf16 operands (one-pass and
    # split backward), and the context ops without a context group
    q16 = torch.randn(2, 8, 64).to(torch.bfloat16)
    seed3 = tattn._seed_operand(3)
    for gate in (2 ** 21, 0):
        monkeypatch.setattr(tattn, "_FUSED_BWD_MAX_BYTES", gate)
        for rate in (0.0, 0.1):
            o32, lse = tattn._fwd(q16, q16, q16, True, 0.125, rate=rate,
                                  seed3=seed3, out_dtype=torch.float32)
            tattn._bwd(q16, q16, q16, o32.to(torch.bfloat16), lse, q16,
                       True, 0.125, rate=rate, seed3=seed3,
                       out_dtype=torch.float32)
    ring_attention(q, q, q, causal=True, axis_name=None).sum().backward()
    ulysses_attention(q, q, q, causal=True).sum().backward()
    grads = [torch.randn(3, 5), torch.randn(7).to(torch.bfloat16)]
    for op, lists, args in (
            (mta.multi_tensor_scale, [grads], (0.5,)),
            (mta.multi_tensor_axpby, [grads, grads], (2.0, -1.0)),
            (mta.multi_tensor_l2norm, [grads], (True,)),
            (mta.multi_tensor_l2norm_scale, [grads], (0.5, True))):
        mta.multi_tensor_applier(op, 0.0, lists, *args)
    assert _build.launch_counts() == {
        "layer_norm": 0, "layer_norm_bwd": 0, "flash_attention": 0,
        "flash_attention_masked": 0,
        "flash_attention_bwd": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0, "flash_attention_drop": 0,
        "flash_attention_masked_drop": 0, "flash_attention_bwd_masked": 0,
        "flash_attention_bwd_drop": 0, "flash_attention_bwd_dq_md": 0,
        "flash_attention_bwd_dkv_md": 0, "paged_attention": 0,
        "fused_scale": 0, "fused_axpby": 0, "fused_adam": 0,
        "fused_block_decode": 0, "fused_block_decode_gpt": 0,
        "fused_block_decode_partial": 0,
        "fused_block_decode_gpt_partial": 0, "fused_l2norm": 0,
        "fused_l2norm_scale": 0, "fused_lamb1": 0, "fused_sgd": 0,
        "fused_adagrad": 0, "flash_attention_wide": 0,
        "flash_attention_wide_dq": 0, "flash_attention_wide_dkv": 0,
        "paged_attention_wide": 0, "flash_attention_f32out": 0,
        "flash_attention_drop_f32out": 0, "flash_attention_bwd_f32out": 0,
        "flash_attention_bwd_drop_f32out": 0,
        "flash_attention_bwd_dq_f32out": 0,
        "flash_attention_bwd_dq_drop_f32out": 0,
        "flash_attention_bwd_dkv_f32out": 0,
        "flash_attention_bwd_dkv_drop_f32out": 0}
    assert _build._LIB is None              # nothing was built or loaded


def _engine(**kwargs):
    kw = dict(kind="llama", slots=1, page_size=16, device="cpu")
    kw.update(kwargs)
    if kw["page_size"] is None:
        del kw["page_size"]
    kind = kw.pop("kind")
    cfg, shapes = {"llama": (CFG, llama_param_shapes),
                   "gpt": (GPT_CFG, gpt_param_shapes),
                   "bert": (BERT_CFG, bert_param_shapes)}[kind]
    return lambda: InferenceEngine(kind, cfg, _params(cfg, shapes), **kw)


def _fused(**kwargs):
    return lambda: fused_block_decode(*_fused_args(), **_fused_kw(**kwargs))


#: what a tp > 1 engine without an initialised torch.distributed says
NO_GROUP = "init_process_group"


@pytest.mark.parametrize("call,exc,match", [
    (_engine(kind="gpt", tp=2), RuntimeError, NO_GROUP),
    (_engine(kind="gpt", tp=2, spec_k=2), RuntimeError, NO_GROUP),
    (_engine(tp=2), RuntimeError, NO_GROUP),
    (_engine(tp=2, spec_k=2), RuntimeError, NO_GROUP),
    (_engine(decode_fusion="1", tp=2), RuntimeError, NO_GROUP),
    (_fused(partial_out=True, fuse_mlp=True), ValueError, "fuse_mlp=False"),
    (_fused(kind="gpt", partial_out=True, fuse_mlp=True), ValueError,
     "fuse_mlp=False"),
])
def test_out_of_slice_configurations_raise(call, exc, match):
    """A tp > 1 engine never serves one rank's shard without its process
    group; the rank-partial fused block runs without the MLP only."""
    with pytest.raises(exc, match=match):
        call()


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_host_tier_engines_build_and_book_jax_page_bytes(kind):
    """A paged engine with a host tier builds on the CPU and books JAX's
    ``page_host_bytes`` (the JAX engine built on the same configuration
    beside it)."""
    import jax.numpy as jnp
    from apex_tpu.inference import InferenceEngine as JaxEngine
    from apex_tpu.transformer import parallel_state
    from apex_tpu.transformer.testing import (GPTConfig as JGPTConfig,
                                              LlamaConfig as JLlamaConfig)
    eng = _engine(kind=kind, host_tier_bytes=1 << 20,
                  swap_batch_pages=3)()
    assert (eng.host_tier_bytes, eng.swap_batch_pages) == (1 << 20, 3)
    parallel_state.destroy_model_parallel()
    parallel_state.initialize_model_parallel(1)
    jcfg = (JLlamaConfig(**LLAMA_KW) if kind == "llama"
            else JGPTConfig(**GPT_KW))
    jeng = JaxEngine(kind, jcfg, None, slots=1, page_size=16,
                     cache_dtype=jnp.bfloat16, host_tier_bytes=1 << 20)
    assert eng.page_host_bytes() == jeng.page_host_bytes() > 0


@pytest.mark.parametrize("kind", ["llama", "gpt"])
def test_partial_out_returns_the_plain_partial(kind):
    """On the CPU ``partial_out=True`` is the plain version's rank
    partial, ``ctx @ wo``: the attention-only block's output less the
    residual (and, GPT, less ``bo``), and no kernel launches."""
    _build.reset_launch_counts()
    args = _gpt_fused_args() if kind == "gpt" else _fused_args()
    kw = _fused_kw(kind=kind, fuse_mlp=False)
    part, k_tok, v_tok = fused_block_decode(*args, partial_out=True, **kw)
    y, k_ref, v_ref = fused_block_decode(*args, **kw)
    want = y - args[0]
    if kind == "gpt":
        want = want - args[1]["bo"]
    torch.testing.assert_close(part, want, rtol=0, atol=1e-5)
    assert torch.equal(k_tok, k_ref) and torch.equal(v_tok, v_ref)
    assert not any(_build.launch_counts().values())


@pytest.mark.parametrize("call,match", [
    (_engine(kind="bert", page_size=None, decode_fusion="1"), "encode-only"),
    (_engine(page_size=None, tp=2), "does not shard"),
    (_engine(page_size=None, host_tier_bytes=1 << 20), "dense slot cache"),
])
def test_configurations_the_jax_engine_refuses_raise_its_value_error(
        call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_env_knobs_cannot_silently_select_an_unported_path(monkeypatch):
    """``APEX_TPU_SERVE_TP=2`` without a process group raises: the
    engine never serves one rank's shard as if it were the model.
    ``APEX_TPU_TP_OVERLAP_CHUNKS`` is read once, at a layer's
    construction: at tp = 1 it changes nothing (as in JAX, the ring runs
    only at tp > 1), and a tp = 2 layer without its group raises, the
    ring or not; ``ring_psum`` without a topology raises too."""
    monkeypatch.setenv("APEX_TPU_SPEC_K", "3")
    monkeypatch.setenv("APEX_TPU_SERVE_TP", "2")
    with pytest.raises(RuntimeError, match=NO_GROUP):
        InferenceEngine("llama", CFG, _params(), slots=1, page_size=16,
                        device="cpu")
    from apex_tpu_torch.transformer.tensor_parallel import (
        RowParallelLinear, mappings)
    monkeypatch.setenv("APEX_TPU_TP_OVERLAP_CHUNKS", "2")
    layer = RowParallelLinear(8, 4, bias=False, device="cpu")
    assert layer.overlap_chunks == 2 and layer.tp == 1
    x = torch.randn(4, 8)
    torch.testing.assert_close(layer(x)[0], x @ layer.weight.T, rtol=0,
                               atol=0)
    monkeypatch.delenv("APEX_TPU_TP_OVERLAP_CHUNKS")
    assert RowParallelLinear(8, 4, device="cpu").overlap_chunks == 1
    monkeypatch.setenv("APEX_TPU_TP_OVERLAP_CHUNKS", "2")
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        RowParallelLinear(8, 4, tensor_model_parallel_size=2, device="cpu")
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        mappings.ring_psum(x, chunks=2)


def test_every_kernel_source_exists_and_exports_its_entry():
    """Every source in ``_build.SOURCES`` exports each of its entries
    with a ctypes signature, names the TPU kernels it replaces, and
    every kernel has its own launch counter."""
    assert sorted(_build.KERNELS) == sorted(_build.launch_counts())
    # every TPU kernel, and further instances: the masked flash forward
    # (#3), the GPT fused block (#8), the flash kernels' mask and
    # dropout instances (#3 with dropout, masked or not; #4 with a mask or
    # dropout; #5 and #6 with either), the wide family (#3w, #5w, #6w,
    # #7w: fp32, fp16 and head dims the instances lack), the fused
    # blocks' tensor-parallel rank-partial instances (V6) and the fp32-
    # output instances of #3, #3d, #4, #4d, #5, #6 and #5md's and #6md's
    # with dropout (ring attention's)
    assert len(_build.KERNELS) == 38
    assert {"flash_attention_masked", "fused_block_decode_gpt",
            "flash_attention_f32out", "flash_attention_drop_f32out",
            "flash_attention_bwd_f32out", "flash_attention_bwd_drop_f32out",
            "flash_attention_bwd_dq_f32out",
            "flash_attention_bwd_dq_drop_f32out",
            "flash_attention_bwd_dkv_f32out",
            "flash_attention_bwd_dkv_drop_f32out",
            "fused_block_decode_partial", "fused_block_decode_gpt_partial",
            "flash_attention_drop", "flash_attention_masked_drop",
            "flash_attention_bwd_masked", "flash_attention_bwd_drop",
            "flash_attention_bwd_dq_md", "flash_attention_bwd_dkv_md",
            "flash_attention_wide", "flash_attention_wide_dq",
            "flash_attention_wide_dkv", "paged_attention_wide"} \
        <= set(_build.KERNELS)
    def flat(entries):    # a counter's entry, or its tuple of entries
        return [e for v in entries.values()
                for e in ((v,) if isinstance(v, str) else v)]

    for src, entries in _build.SOURCES.items():
        text = (PORT / "csrc" / src).read_text()
        assert "Replaces: apex_tpu/ops/" in text
        for entry in flat(entries) + list(_build.UNCOUNTED.get(src, ())):
            assert re.search(r'extern "C" int ' + entry + r"\(", text)
            assert entry in _build._SIGNATURES
    # every entry has a signature; the uncounted ones (the split
    # backward's mask pre-pass) have no launch counter
    counted = [e for es in _build.SOURCES.values() for e in flat(es)]
    uncounted = [e for es in _build.UNCOUNTED.values() for e in es]
    assert sorted(counted + uncounted) == sorted(_build._SIGNATURES)
    assert not set(counted) & set(uncounted)
    assert "apex_error_string" in (PORT / "csrc" / "layer_norm.cu").read_text()


def test_engine_geometry_and_cache_bytes():
    eng = InferenceEngine("llama", CFG, _params(), slots=2, max_seq=64,
                          page_size=16, num_pages=5, device="cpu")
    assert eng.max_pages_per_slot == 4
    assert eng.bucket_for(1) == 64 and eng.bucket_for(64) == 64
    # (5 + 1 trash) pages x 16 tokens x k+v x 1 layer x 2 kv x 8 x 2 B
    assert eng.cache_hbm_bytes() == 6 * 16 * 2 * 1 * 2 * 8 * 2
    cache = eng.init_cache()
    assert tuple(cache.k.shape) == (6, 1, 2, 16, 8)
    assert np.all(cache.page_table.numpy() == 5)


def _tiny_train(**cfg_kw):
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.transformer.testing import llama_model_provider
    cfg = LlamaConfig(**dict(dict(vocab_size=64, hidden_size=32,
                                  num_layers=1, num_attention_heads=4,
                                  num_kv_heads=2, max_seq_length=64),
                             **cfg_kw))
    model = llama_model_provider(cfg, device="cpu")
    tx = functional.fused_adam()
    return model, tx, train_step


def test_training_out_of_slice_options_raise(monkeypatch):
    from apex_tpu_torch.amp.scaler import init_loss_scale, unscale_flat_grads
    from apex_tpu_torch.transformer.tensor_parallel import (
        ColumnParallelLinear, RowParallelLinear, VocabParallelEmbedding,
        vocab_parallel_cross_entropy)
    model, tx, train_step = _tiny_train()
    loss = lambda m, b: m(b["tokens"], b["labels"])   # noqa: E731
    # ZeRO is ported (item 6a): zero=True on a dense state raises JAX's
    # ValueError, and a sharded state or a cross-rank flag without the
    # topology raises, naming initialize_model_parallel: no rank quietly
    # runs alone
    zero_step = train_step.make_train_step(loss, tx, zero=True)
    state = train_step.init_train_state(tx, model)
    tokens = torch.arange(8, dtype=torch.int32)[None]
    with pytest.raises(ValueError, match="dp-sharded"):
        zero_step(state, {"tokens": tokens, "labels": tokens})
    with pytest.raises(NotImplementedError, match="item 7"):
        train_step.make_train_step(loss, tx, numerics=True)
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        train_step.init_train_state(tx, model, shard=("data", 2))
    from apex_tpu_torch.optimizers import functional
    for rule in (functional.fused_lamb(), functional.fused_sgd(0.1),
                 functional.fused_adagrad(), functional.fused_novograd()):
        with pytest.raises(RuntimeError, match="initialize_model_parallel"):
            rule.init(model, shard=("data", 2))
        # one rank's shard by an explicit rank needs no group
        shard = rule.init(model, shard=("data", 2, 1), prefetch=2)
        assert shard.shard == ("data", 2) and len(shard.spans) == 2
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        unscale_flat_grads(torch.zeros(4), init_loss_scale(device="cpu"),
                           axis_name="data")
    # tp > 1 is ported (item 6b): without a topology to run on, a tp = 2
    # layer or loss raises, naming initialize_model_parallel (no rank
    # quietly computes alone); sequence parallelism is ported (item 6d):
    # at tp = 1 a layer with it is the plain layer, and JAX's asserts
    # hold (gather_output, a row input that is not parallel)
    for layer in (ColumnParallelLinear, RowParallelLinear):
        with pytest.raises(RuntimeError, match="initialize_model_parallel"):
            layer(8, 8, tensor_model_parallel_size=2, device="cpu")
        with pytest.raises(RuntimeError, match="initialize_model_parallel"):
            layer(8, 8, sequence_parallel_enabled=True,
                  tensor_model_parallel_size=2, device="cpu")
    x8 = torch.randn(4, 2, 8)
    col = ColumnParallelLinear(8, 8, gather_output=False, device="cpu",
                               sequence_parallel_enabled=True)
    row = RowParallelLinear(8, 8, input_is_parallel=True, device="cpu",
                            sequence_parallel_enabled=True)
    torch.testing.assert_close(
        row(col(x8)[0])[0], x8 @ col.weight.T @ row.weight.T
        + col.bias @ row.weight.T + row.bias, rtol=0, atol=1e-6)
    with pytest.raises(AssertionError, match="gather_output"):
        ColumnParallelLinear(8, 8, sequence_parallel_enabled=True,
                             device="cpu")(x8)
    with pytest.raises(AssertionError, match="input_is_parallel"):
        RowParallelLinear(8, 8, sequence_parallel_enabled=True,
                          device="cpu")(x8)
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        VocabParallelEmbedding(8, 8, tensor_model_parallel_size=2)
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        vocab_parallel_cross_entropy(torch.zeros(2, 8), torch.zeros(2),
                                     tensor_model_parallel_size=2)
    # the loss side is ported: the fused head (by fused_head_xent and by
    # APEX_TPU_XENT_CHUNK) and remat run and give the unfused loss; the
    # fused head at tp > 1 needs its process group
    from apex_tpu_torch.ops.fused_lm_xent import (
        fused_lm_head_vocab_parallel_cross_entropy)
    tokens = torch.arange(8, dtype=torch.int32)[None]
    with torch.no_grad():
        want = model(tokens, tokens)
        for kw in (dict(fused_head_xent=3), dict(remat=True)):
            other, _, _ = _tiny_train(**kw)
            other.load_state_dict(model.state_dict())
            torch.testing.assert_close(other(tokens, tokens), want,
                                       rtol=0, atol=1e-6)
        monkeypatch.setenv("APEX_TPU_XENT_CHUNK", "3")
        torch.testing.assert_close(model(tokens, tokens), want, rtol=0,
                                   atol=1e-6)
    with pytest.raises(RuntimeError, match="initialize_model_parallel"):
        fused_lm_head_vocab_parallel_cross_entropy(
            torch.zeros(2, 32), model.lm_head.weight, torch.zeros(2),
            token_chunk=1, tensor_model_parallel_size=2)
    # the pipeline schedules are ported (item 6c): a pipelined executor,
    # a p2p hop or the embedding reduction on the pipe axis without a
    # topology raises, naming initialize_model_parallel (no rank quietly
    # runs the pipeline alone); no pipelining runs anywhere
    from apex_tpu_torch.transformer import pipeline_parallel as tpp
    from apex_tpu_torch.transformer.pipeline_parallel import (
        p2p_communication as p2p)
    stage = lambda p, x, mb: x * p["w"]                  # noqa: E731
    mse = lambda y, mb: (y ** 2).mean()                  # noqa: E731
    params, batch = {"w": torch.ones(4)}, torch.ones(2, 4)
    for call in (
            lambda: tpp.forward_backward_pipelining_without_interleaving(
                stage, mse, params, batch, num_microbatches=2),
            lambda: tpp.forward_backward_pipelining_without_interleaving(
                stage, mse, params, batch, num_microbatches=2,
                use_1f1b=False),
            lambda: tpp.forward_backward_pipelining_with_interleaving(
                stage, mse, {"w": torch.ones(2, 4)}, batch,
                num_microbatches=2),
            lambda: p2p.send_forward_recv_backward(torch.ones(2),
                                                   torch.ones(2)),
            lambda: p2p.recv_backward(torch.ones(2)),
            lambda: tpp.embedding_grads_all_reduce(torch.ones(2))):
        with pytest.raises(RuntimeError, match="initialize_model_parallel"):
            call()
    loss, grads = tpp.forward_backward_no_pipelining(
        stage, mse, params, batch, num_microbatches=2)
    assert float(loss) == 1.0 and grads["w"].tolist() == [0.5] * 4


def test_training_entry_points_raise_without_cuda(monkeypatch):
    from apex_tpu_torch.amp.scaler import init_loss_scale
    from apex_tpu_torch.transformer.testing import llama_model_provider
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        llama_model_provider(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_loss_scale("dynamic")


def test_train_step_params_are_views_of_the_flat_buffers():
    """The flat-native property: every parameter and every grad is a
    view of one flat buffer (a step zeroes and casts whole buffers, no
    per-leaf concatenate), and bf16 linears keep fp32 norm weights."""
    model, tx, train_step = _tiny_train(params_dtype=torch.bfloat16)
    state = train_step.init_train_state(tx, model, loss_scale="dynamic")
    flat = state.flat
    base = flat.param_bytes.untyped_storage().data_ptr()
    gbase = flat.grad_bytes.untyped_storage().data_ptr()
    for name, p in model.named_parameters():
        assert p.untyped_storage().data_ptr() == base, name
        assert p.grad.untyped_storage().data_ptr() == gbase, name
        want = torch.float32 if "norm" in name else torch.bfloat16
        assert p.dtype == want, name
    # runs of same-dtype leaves: embedding, final_norm, then per layer
    # [attention projections], input_norm, [mlp projections], post norm,
    # and the head
    assert [r.dtype for r in flat.runs] == [
        torch.bfloat16, torch.float32, torch.bfloat16, torch.float32,
        torch.bfloat16, torch.float32, torch.bfloat16]
    step = train_step.make_train_step(
        lambda m, b: m(b["tokens"], b["labels"]), tx)
    tokens = torch.randint(0, 64, (2, 16))
    state, loss = step(state, {"tokens": tokens,
                               "labels": torch.roll(tokens, -1, 1)})
    assert torch.isfinite(loss) and float(state.opt.count) == 1.0


def test_no_raise_names_the_ported_loss_side():
    """The chunked fused LM head and remat are ported: no source of the
    port still refuses them by that queue item's title."""
    stale = [str(p) for p in _sources()
             if "chunked fused LM head and remat" in p.read_text()]
    assert not stale


def test_chip_smoke_runs_the_lean_phase_by_default():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    defaults = [kw.value.value for node in ast.walk(tree)
                if isinstance(node, ast.Call)
                for kw in node.keywords
                if kw.arg == "default" and node.args
                and isinstance(node.args[0], ast.Constant)
                and node.args[0].value == "--phases"]
    assert len(defaults) == 1
    phases = defaults[0].split(",")
    assert "lean_train" in phases
    assert phases.index("lean_train") == phases.index("train") + 1
    # tensor-parallel training runs by default, after the dp phase, and
    # pipelined training after it
    assert phases.index("tp_train") == phases.index("dp") + 1
    assert phases.index("pp_train") == phases.index("tp_train") + 1
    # then context-parallel and expert-parallel (MoE) training
    assert phases.index("cp_train") == phases.index("pp_train") + 1
    assert phases.index("moe_train") == phases.index("cp_train") + 1
