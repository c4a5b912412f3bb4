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
from apex_tpu_torch.transformer.testing import (BertConfig, GPTConfig,
                                                LlamaConfig)

from _torch_isolation import restore_torch_from_amp  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "apex_tpu_torch"
CFG = LlamaConfig(vocab_size=64, hidden_size=32, num_layers=1,
                  num_attention_heads=4, num_kv_heads=2, max_seq_length=64)
GPT_CFG = GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                    num_attention_heads=4, max_seq_length=64)
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
        "    importlib.import_module(m.name)\n"
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
    # the last slice's modules are among those scanned
    scanned = {p.relative_to(ROOT).as_posix() for p in _sources()}
    assert {"apex_tpu_torch/multi_tensor_apply/__init__.py",
            "apex_tpu_torch/ops/attention.py",
            "apex_tpu_torch/ops/fused_update.py"} <= scanned


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
    # the masked flash forward and decode_attention's kernel branch
    mask = torch.rand(1, 1, 8, 8) > 0.5
    flash_attention(q, q, q, mask=mask)
    decode_attention(torch.randn(2, 4, 16), torch.randn(2, 2, 40, 16),
                     torch.randn(2, 2, 40, 16),
                     torch.tensor([0, 7], dtype=torch.int32), use_kernel=True)
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
        "flash_attention_bwd_dkv": 0, "paged_attention": 0,
        "fused_scale": 0, "fused_axpby": 0, "fused_adam": 0,
        "fused_block_decode": 0, "fused_block_decode_gpt": 0,
        "fused_l2norm": 0,
        "fused_l2norm_scale": 0, "fused_lamb1": 0, "fused_sgd": 0,
        "fused_adagrad": 0}
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


@pytest.mark.parametrize("call,match", [
    (_engine(kind="gpt", tp=2), "tp and spec"),
    (_engine(kind="gpt", spec_k=2), "tp and spec"),
    (_engine(kind="gpt", host_tier_bytes=1 << 20), "host page tier"),
    (_engine(tp=2), "tp and spec"),
    (_engine(spec_k=2), "tp and spec"),
    (_engine(decode_fusion="1", tp=2), "tp and spec"),
    (_fused(partial_out=True, fuse_mlp=False), "tp and spec"),
    (_fused(kind="gpt", partial_out=True, fuse_mlp=False), "tp and spec"),
    (_engine(host_tier_bytes=1 << 20), "host page tier"),
])
def test_out_of_slice_configurations_raise(call, match):
    with pytest.raises(NotImplementedError, match=match):
        call()


@pytest.mark.parametrize("call,match", [
    (_engine(kind="bert", page_size=None, decode_fusion="1"), "encode-only"),
    (_engine(page_size=None, tp=2), "does not shard"),
])
def test_configurations_the_jax_engine_refuses_raise_its_value_error(
        call, match):
    with pytest.raises(ValueError, match=match):
        call()


def test_env_knobs_cannot_silently_select_an_unported_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_SPEC_K", "3")
    with pytest.raises(NotImplementedError, match="speculative"):
        InferenceEngine("llama", CFG, _params(), slots=1, page_size=16,
                        device="cpu")


def test_every_kernel_source_exists_and_exports_its_entry():
    """Every source in ``_build.SOURCES`` exports each of its entries
    with a ctypes signature, names the TPU kernels it replaces, and
    every kernel has its own launch counter."""
    assert sorted(_build.KERNELS) == sorted(_build.launch_counts())
    # every TPU kernel, and a second instance of two of them: the masked
    # flash forward (#3) and the GPT fused block (#8)
    assert len(_build.KERNELS) == 18
    assert {"flash_attention_masked", "fused_block_decode_gpt"} \
        <= set(_build.KERNELS)
    def flat(entries):    # a counter's entry, or its tuple of entries
        return [e for v in entries.values()
                for e in ((v,) if isinstance(v, str) else v)]

    for src, entries in _build.SOURCES.items():
        text = (PORT / "csrc" / src).read_text()
        assert "Replaces: apex_tpu/ops/" in text
        for entry in flat(entries):
            assert re.search(r'extern "C" int ' + entry + r"\(", text)
            assert entry in _build._SIGNATURES
    assert sorted(e for es in _build.SOURCES.values() for e in flat(es)) \
        == sorted(_build._SIGNATURES)
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
    with pytest.raises(NotImplementedError, match="item 6"):
        train_step.make_train_step(loss, tx, zero=True)
    with pytest.raises(NotImplementedError, match="item 7"):
        train_step.make_train_step(loss, tx, numerics=True)
    with pytest.raises(NotImplementedError, match="item 6"):
        train_step.init_train_state(tx, model, shard=("data", 2))
    from apex_tpu_torch.optimizers import functional
    for rule in (functional.fused_lamb(), functional.fused_sgd(0.1),
                 functional.fused_adagrad(), functional.fused_novograd()):
        with pytest.raises(NotImplementedError, match="item 6"):
            rule.init(model, shard=("data", 2))
        with pytest.raises(NotImplementedError, match="item 6"):
            rule.init(model, prefetch=2)
    with pytest.raises(NotImplementedError, match="item 6"):
        unscale_flat_grads(torch.zeros(4), init_loss_scale(device="cpu"),
                           axis_name="data")
    for layer in (ColumnParallelLinear, RowParallelLinear):
        with pytest.raises(NotImplementedError, match="item 6"):
            layer(8, 8, tensor_model_parallel_size=2, device="cpu")
        with pytest.raises(NotImplementedError, match="item 6"):
            layer(8, 8, sequence_parallel_enabled=True, device="cpu")
    with pytest.raises(NotImplementedError, match="item 6"):
        VocabParallelEmbedding(8, 8, tensor_model_parallel_size=2)
    with pytest.raises(NotImplementedError, match="item 6"):
        vocab_parallel_cross_entropy(torch.zeros(2, 8), torch.zeros(2),
                                     tensor_model_parallel_size=2)
    tokens = torch.zeros(1, 8, dtype=torch.int32)
    fused, _, _ = _tiny_train(fused_head_xent=16)
    with pytest.raises(NotImplementedError, match="fused LM head"):
        fused(tokens, tokens)
    monkeypatch.setenv("APEX_TPU_XENT_CHUNK", "16")
    with pytest.raises(NotImplementedError, match="fused LM head"):
        model(tokens, tokens)
    with pytest.raises(NotImplementedError, match="remat"):
        _tiny_train(remat=True)


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
