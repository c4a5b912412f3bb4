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

from apex_tpu_torch.inference import InferenceEngine
from apex_tpu_torch.inference.kv_cache import init_paged_cache
from apex_tpu_torch.inference.weights import llama_param_shapes
from apex_tpu_torch.ops import (_build, flash_attention,
                                paged_decode_attention, rms_norm)
from apex_tpu_torch.transformer.testing import LlamaConfig

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "apex_tpu_torch"
CFG = LlamaConfig(vocab_size=64, hidden_size=32, num_layers=1,
                  num_attention_heads=4, num_kv_heads=2, max_seq_length=64)


def _sources():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _params(cfg=CFG):
    tree: dict = {}
    for path, shape in llama_param_shapes(cfg).items():
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


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine("llama", CFG, _params(), slots=1, page_size=16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_paged_cache(4, 1, 2, 16, 8, slots=1, max_pages_per_slot=4)
    with pytest.raises(RuntimeError):
        init_paged_cache(4, 1, 2, 16, 8, slots=1, max_pages_per_slot=4,
                         device="cuda")
    eng = InferenceEngine("llama", CFG, _params(), slots=1, page_size=16,
                          device="cpu")
    assert eng.device.type == "cpu" and eng.init_cache().k.device.type == "cpu"


def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    _build.reset_launch_counts()
    x = torch.randn(4, 96)
    rms_norm(x, torch.ones(96))
    q = torch.randn(1, 2, 8, 16)
    flash_attention(q, q, q, causal=True)
    pool = torch.randn(3, 2, 4, 16)
    paged_decode_attention(torch.randn(1, 2, 16), pool, pool,
                           torch.zeros(1, 2, dtype=torch.int32),
                           torch.tensor([5], dtype=torch.int32))
    assert _build.launch_counts() == {
        "layer_norm": 0, "flash_attention": 0, "paged_attention": 0}
    assert _build._LIB is None              # nothing was built or loaded


@pytest.mark.parametrize("kwargs,match", [
    (dict(kind="gpt"), "GPT serving"),
    (dict(kind="bert"), "GPT serving"),
    (dict(page_size=None), "dense cache"),
    (dict(tp=2), "tp and spec"),
    (dict(spec_k=2), "tp and spec"),
    (dict(decode_fusion="1"), "decode fusion"),
    (dict(decode_fusion="auto"), "decode fusion"),
    (dict(host_tier_bytes=1 << 20), "host page tier"),
])
def test_out_of_slice_configurations_raise(kwargs, match):
    kw = dict(kind="llama", slots=1, page_size=16, device="cpu")
    kw.update(kwargs)
    if kw["page_size"] is None:
        del kw["page_size"]
    kind = kw.pop("kind")
    with pytest.raises(NotImplementedError, match=match):
        InferenceEngine(kind, CFG, _params(), **kw)


def test_env_knobs_cannot_silently_select_an_unported_path(monkeypatch):
    monkeypatch.setenv("APEX_TPU_SPEC_K", "3")
    with pytest.raises(NotImplementedError, match="speculative"):
        InferenceEngine("llama", CFG, _params(), slots=1, page_size=16,
                        device="cpu")


def test_every_kernel_source_exists_and_exports_its_entry():
    text = {name: (PORT / "csrc" / src).read_text()
            for name, src in _build.SOURCES.items()}
    entries = {"layer_norm": "apex_layer_norm_fwd",
               "flash_attention": "apex_flash_attention_fwd",
               "paged_attention": "apex_paged_decode_attention"}
    for name, entry in entries.items():
        assert re.search(r'extern "C" int ' + entry + r"\(", text[name])
        assert entry in _build._SIGNATURES
        assert "Replaces: apex_tpu/ops/" in text[name]
    assert "apex_error_string" in text["layer_norm"]


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
