"""Build, load and count the port's CUDA kernels.

At first use every source under ``apex_tpu_torch/csrc/`` is compiled by
``nvcc`` for ``sm_90a`` (one ``nvcc -c`` per source, all started
together) and linked into ONE shared library under
``build/apex_tpu_torch/``, named by a hash of the sources, the headers
they include and the flags, so an edited kernel never loads a stale
build.  The library exposes a
plain C interface and is loaded with ``ctypes``: every entry takes raw
device pointers and the CUDA stream as ``c_void_p``, launches on that
stream and returns ``cudaGetLastError()``, which :func:`check` turns
into an exception.

Each kernel wrapper adds one to its kernel's launch counter where it
launches that kernel and nowhere else (:func:`count`), so a run can
show that its main path went through the kernels:
:func:`reset_launch_counts` before the run, :func:`launch_counts`
after it.  Counters are per kernel, not per source: a source may hold
several kernels (``layer_norm.cu`` the forward and the backward,
``flash_attention_bwd.cu`` the one-pass backward and the split pair,
``fused_update.cu`` the unscale, axpby, Adam, the L2 norm, the fused
scale and norm, LAMB's phase 1, SGD and Adagrad), and two have a
second instance with a counter of its own: ``flash_attention.cu`` the
masked forward (``flash_attention_masked``, whose counter also counts
the dense cache's decode kernel, ``apex_flash_decode``: the masked
forward's q_len-1 case), ``fused_block_decode.cu`` the GPT layer
(``fused_block_decode_gpt``).  ``fused_block_decode.cu``
is one cooperative launch per decoder layer; its entries, called with
a null workspace, report the workspace size without launching.

Nothing here runs at import time: the CPU tests import every module of
the port on a machine with no ``nvcc`` and no card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

__all__ = ["SOURCES", "KERNELS", "BUILD_DIR", "build", "library", "check",
           "count", "launch_counts", "reset_launch_counts", "stream_ptr"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "apex_tpu_torch"
#: the kernel sources and, for each, its C entries by the launch-counter
#: name of the kernel each launches (a tuple where one counter counts
#: two entries: the masked flash forward and its q_len-1 case, the dense
#: cache's decode)
SOURCES = {
    "layer_norm.cu": {"layer_norm": "apex_layer_norm_fwd",
                      "layer_norm_bwd": "apex_layer_norm_bwd"},
    "flash_attention.cu": {
        "flash_attention": "apex_flash_attention_fwd",
        "flash_attention_masked": ("apex_flash_attention_fwd_masked",
                                   "apex_flash_decode")},
    "flash_attention_bwd.cu": {
        "flash_attention_bwd": "apex_flash_attention_bwd",
        "flash_attention_bwd_dq": "apex_flash_attention_bwd_dq",
        "flash_attention_bwd_dkv": "apex_flash_attention_bwd_dkv"},
    "paged_attention.cu": {
        "paged_attention": "apex_paged_decode_attention"},
    "fused_update.cu": {"fused_scale": "apex_fused_scale",
                        "fused_axpby": "apex_fused_axpby",
                        "fused_adam": "apex_fused_adam",
                        "fused_l2norm": "apex_fused_l2norm",
                        "fused_l2norm_scale": "apex_fused_l2norm_scale",
                        "fused_lamb1": "apex_fused_lamb1",
                        "fused_sgd": "apex_fused_sgd",
                        "fused_adagrad": "apex_fused_adagrad"},
    "fused_block_decode.cu": {
        "fused_block_decode": "apex_fused_block_decode",
        "fused_block_decode_gpt": "apex_fused_block_decode_gpt"},
}
#: the source of each kernel, by launch-counter name
KERNELS = {name: src for src, entries in SOURCES.items() for name in entries}
_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LAUNCHES: Dict[str, int] = {name: 0 for name in KERNELS}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_LP = ctypes.POINTER(ctypes.c_longlong)
#: C signature of every entry point: (argtypes); all return int
_SIGNATURES = {
    # x, w, b, y, rows, hidden, eps, rms, x_dtype, w_dtype, stream
    "apex_layer_norm_fwd": [_P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _P],
    # x, w, dy, dx, dw_part, db_part, dw, db, rows, hidden, nblocks, eps,
    # rms, x_dtype, w_dtype, stream
    "apex_layer_norm_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F,
                            _I, _I, _I, _P],
    # q, k, v, o, lse, bh, sq, sk, d, causal, off, valid_q, valid_k,
    # scale_log2, stream
    "apex_flash_attention_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                 _I, _I, _I, _F, _P],
    # q, k, v, mask, cls, bits, o, lse, bh, sq, sk, d, causal, off,
    # valid_q, valid_k, mask_hper, scale_log2, stream
    "apex_flash_attention_fwd_masked": [_P] * 8 + [_I] * 9 + [_F, _P],
    # q, k, v, lengths, out, part_acc, part_ml, counters, b, kvh, group,
    # d, s, head_stride, slot_stride, nsplit, tiles_per_split, scale_log2,
    # stream
    "apex_flash_decode": [_P] * 8 + [_I] * 5 + [_L, _L, _I, _I, _F, _P],
    # q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d,
    # causal, off, valid_q, valid_k, scale_log2, scale, stream
    "apex_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # q, k, v, dout, lse, delta, dq, bh, sq, sk, d, causal, off, valid_q,
    # valid_k, scale_log2, scale, stream
    "apex_flash_attention_bwd_dq": [_P] * 7 + [_I] * 8 + [_F, _F, _P],
    # q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, causal, off,
    # valid_q, valid_k, scale_log2, scale, stream
    "apex_flash_attention_bwd_dkv": [_P] * 8 + [_I] * 8 + [_F, _F, _P],
    # q, k_pages, v_pages, page_table, lengths, out, part_acc, part_ml,
    # counters, slots, h, kvh, ps, d, mpps, pages, page_stride, nsplit,
    # pages_per_split, scale_log2, stream
    "apex_paged_decode_attention": [_P] * 9 + [_I] * 6 + [_L, _L, _I, _I,
                                                           _F, _P],
    # x, out, scale, flag, n, x_dtype, out_dtype, stream
    "apex_fused_scale": [_P, _P, _P, _P, _L, _I, _I, _P],
    # x, y, out, ab, flag, n, x_dtype, y_dtype, out_dtype, stream
    "apex_fused_axpby": [_P, _P, _P, _P, _P, _L, _I, _I, _I, _P],
    # x, out, scale, partials, norm, flag, n, parts_cap, x_dtype,
    # out_dtype, stream
    "apex_fused_l2norm_scale": [_P] * 6 + [_L, _I, _I, _I, _P],
    # p, g, m, v, hp, n, g_dtype, adam_w, stream
    "apex_fused_adam": [_P, _P, _P, _P, _P, _L, _I, _I, _P],
    # x, partials, out, n, parts_cap, x_dtype, stream
    "apex_fused_l2norm": [_P, _P, _P, _L, _I, _I, _P],
    # p, g, m, v, u, hp, n, g_dtype, stream
    "apex_fused_lamb1": [_P, _P, _P, _P, _P, _P, _L, _I, _P],
    # p, g, buf, hp, n, g_dtype, nesterov, wd_after, stream
    "apex_fused_sgd": [_P, _P, _P, _P, _L, _I, _I, _I, _P],
    # p, g, h, hp, n, g_dtype, w_mode, stream
    "apex_fused_adagrad": [_P, _P, _P, _P, _L, _I, _I, _P],
    # x, cos, sin, ln1_w, wq, wk, wv, wo, ln2_w, wg, wu, wd, k_pages,
    # v_pages, page_table, lengths, y, kt, vt, ws, ws_bytes, clock, slots,
    # hidden, heads, kvh, d, ffn, ps, mpps, page_stride, fuse_mlp, ln_fp32,
    # eps, scale_log2, stream
    "apex_fused_block_decode": [_P] * 20 + [_LP, _P] + [_I] * 8
                               + [_L, _I, _I, _F, _F, _P],
    # x, ln1_w, ln1_b, wq, bq, wk, bk, wv, bv, wo, bo, ln2_w, ln2_b, wu,
    # bu, wd, bd, k_pages, v_pages, page_table, lengths, y, kt, vt, ws,
    # ws_bytes, clock, slots, hidden, heads, kvh, d, ffn, ps, mpps,
    # page_stride, fuse_mlp, eps, scale_log2, stream
    "apex_fused_block_decode_gpt": [_P] * 25 + [_LP, _P] + [_I] * 8
                                   + [_L, _I, _F, _F, _P],
}


def _nvcc() -> str:
    cands = [os.environ.get("CUDA_HOME"), "/usr/local/cuda"]
    for home in cands:
        if home and Path(home, "bin", "nvcc").exists():
            return str(Path(home, "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        return found
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin and "
        "PATH): the port's CUDA kernels are built from source at first use")


def _digest_files() -> list:
    """The files the library's name hashes: every source of
    :data:`SOURCES` and every header under ``CSRC`` (the sources include
    them, so an edited header must not load a stale build)."""
    headers = sorted(p.name for p in CSRC.iterdir()
                     if p.suffix in (".cuh", ".h"))
    return sorted(SOURCES) + headers


def _digest() -> str:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    for name in _digest_files():
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile the kernel sources into the shared library (once per
    source hash) and return its path.  Raises with the compiler's
    output if any source fails to build.  ``ptxas`` register and
    spill reports land in ``<build>/<source>.log``."""
    so = BUILD_DIR / f"libapex_tpu_torch_{_digest()}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    try:
        for src in SOURCES:
            obj = BUILD_DIR / (Path(src).stem + f".{os.getpid()}.o")
            cmd = [nvcc, *_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            with open(BUILD_DIR / f"{src}.log", "w") as log:
                procs.append((src, obj, subprocess.Popen(
                    cmd, stdout=log, stderr=subprocess.STDOUT)))
    finally:
        for _, _, proc in procs:        # every compile ends before we go on
            proc.wait()
    failed = [src for src, _, proc in procs if proc.returncode]
    if failed:
        msgs = "\n".join(f"--- {s}\n{(BUILD_DIR / f'{s}.log').read_text()}"
                         for s in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(tmp), *[str(o) for _, o, _ in procs]],
        capture_output=True, text=True)
    for _, obj, _ in procs:
        obj.unlink(missing_ok=True)
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stderr}")
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.apex_error_string.argtypes = [ctypes.c_int]
            lib.apex_error_string.restype = ctypes.c_char_p
            _LIB = lib
        return _LIB


def check(err: int, kernel: str) -> None:
    """Raise if a launch returned a CUDA error."""
    if err:
        msg = library().apex_error_string(err).decode()
        raise RuntimeError(f"{kernel} kernel launch failed: CUDA error "
                           f"{err} ({msg})")


def stream_ptr(device) -> ctypes.c_void_p:
    """The current PyTorch stream of ``device`` as a C pointer."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def count(kernel: str) -> None:
    """Record one launch of ``kernel`` (called by its wrapper only)."""
    _LAUNCHES[kernel] += 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0
