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
scale and norm, LAMB's phase 1, SGD and Adagrad), and some kernels have
further instances with counters of their own: ``flash_attention.cu`` the
masked forward (``flash_attention_masked``, whose counter also counts
the dense cache's decode kernel, ``apex_flash_decode``: the masked
forward's q_len-1 case), ``fused_block_decode.cu`` the GPT layer
(``fused_block_decode_gpt``), ``fused_block_partial.cu`` each layer's
tensor-parallel rank-partial instance (``fused_block_decode_partial``,
``fused_block_decode_gpt_partial``), and the flash kernels' mask and
dropout instances: ``flash_attention_md.cu`` the forward with dropout, without
and with a mask (``flash_attention_drop``,
``flash_attention_masked_drop``), and the split dq kernel with a mask
or dropout (``flash_attention_bwd_dq_md``); ``flash_attention_bwd_md.cu``
the one-pass backward with a mask, with or without dropout
(``flash_attention_bwd_masked``), with dropout alone
(``flash_attention_bwd_drop``), and the split dk/dv kernel with a mask
or dropout (``flash_attention_bwd_dkv_md``); the fp32-output instances
that ring attention runs on bf16 operands, ``flash_attention_f32out.cu``
the forward without and with dropout (``flash_attention_f32out``,
``flash_attention_drop_f32out``) and the split dq without and with
dropout (``flash_attention_bwd_dq_f32out``,
``flash_attention_bwd_dq_drop_f32out``), ``flash_attention_bwd_f32out.cu``
the one-pass backward (``flash_attention_bwd_f32out``,
``flash_attention_bwd_drop_f32out``) and the split dk/dv without and
with dropout (``flash_attention_bwd_dkv_f32out``,
``flash_attention_bwd_dkv_drop_f32out``).  The wide family, for the
operands and head dims those instances do not take: ``flash_wide.cu``
the forward (``flash_attention_wide``), dq (``flash_attention_wide_dq``)
and dk/dv (``flash_attention_wide_dkv``), ``paged_wide.cu`` paged decode
(``paged_attention_wide``); the forward's, dq's and dk/dv's tensor-core
instances and paged decode's TMA modes sit in sources of their own
(``flash_wide_tc_*.cu``, ``paged_wide_tc_*.cu``, no entries) so that
they compile in parallel.  ``fused_block_decode.cu`` and
``fused_block_partial.cu`` are one cooperative launch per decoder layer;
their entries, called with a null workspace, report the workspace size
without launching.  One
entry launches no counted kernel: the mask pre-pass of the split
backward (:data:`UNCOUNTED`), which the forward's masked entries run
inside them, uncounted too; nor do the wide family's split of fp32
operands into bf16 planes (run by the wrappers of the forward, dq and
dk/dv, whose launches count) and its route query.

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

__all__ = ["SOURCES", "KERNELS", "UNCOUNTED", "BUILD_DIR", "build",
           "library", "check", "count", "launch_counts",
           "reset_launch_counts", "stream_ptr"]

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
    "flash_attention_md.cu": {
        "flash_attention_drop": "apex_flash_attention_fwd_drop",
        "flash_attention_masked_drop": "apex_flash_attention_fwd_masked_drop",
        "flash_attention_bwd_dq_md": "apex_flash_attention_bwd_dq_md"},
    "flash_attention_bwd_md.cu": {
        "flash_attention_bwd_masked": "apex_flash_attention_bwd_masked",
        "flash_attention_bwd_drop": "apex_flash_attention_bwd_drop",
        "flash_attention_bwd_dkv_md": "apex_flash_attention_bwd_dkv_md"},
    # the fp32-output instances that ring attention runs on bf16
    # operands: the forward (#3, #3d) with the split dq (#5, #5md's
    # dropout) on the query-major templates, the one-pass backward (#4,
    # #4d) with the split dk/dv (#6, #6md's dropout) on the key-major
    # ones; their own sources so that they compile beside the rest
    "flash_attention_f32out.cu": {
        "flash_attention_f32out": "apex_flash_attention_fwd_f32out",
        "flash_attention_drop_f32out":
            "apex_flash_attention_fwd_drop_f32out",
        "flash_attention_bwd_dq_f32out":
            "apex_flash_attention_bwd_dq_f32out",
        "flash_attention_bwd_dq_drop_f32out":
            "apex_flash_attention_bwd_dq_drop_f32out"},
    "flash_attention_bwd_f32out.cu": {
        "flash_attention_bwd_f32out": "apex_flash_attention_bwd_f32out",
        "flash_attention_bwd_drop_f32out":
            "apex_flash_attention_bwd_drop_f32out",
        "flash_attention_bwd_dkv_f32out":
            "apex_flash_attention_bwd_dkv_f32out",
        "flash_attention_bwd_dkv_drop_f32out":
            "apex_flash_attention_bwd_dkv_drop_f32out"},
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
    "fused_block_partial.cu": {
        "fused_block_decode_partial": "apex_fused_block_decode_partial",
        "fused_block_decode_gpt_partial":
            "apex_fused_block_decode_gpt_partial"},
    "flash_wide.cu": {
        "flash_attention_wide": "apex_flash_wide_fwd",
        "flash_attention_wide_dq": "apex_flash_wide_dq",
        "flash_attention_wide_dkv": "apex_flash_wide_dkv"},
    "paged_wide.cu": {"paged_attention_wide": "apex_paged_wide"},
    # the wide forward's, dq's and dk/dv's tensor-core instances,
    # launched through flash_wide.cu's entries (their own sources: nvcc
    # builds them beside one another)
    "flash_wide_tc_f16_fwd.cu": {},
    "flash_wide_tc_f16_dq.cu": {},
    "flash_wide_tc_bf16.cu": {},
    "flash_wide_tc_f32_fwd.cu": {},
    "flash_wide_tc_f32_dq.cu": {},
    "flash_wide_tc_rows_fwd.cu": {},
    "flash_wide_tc_rows_dq.cu": {},
    "flash_wide_tc_dkv_f16.cu": {},
    "flash_wide_tc_dkv_bf16.cu": {},
    "flash_wide_tc_dkv_f32.cu": {},
    "flash_wide_tc_dkv_rows.cu": {},
    # the wide paged decode's TMA modes, launched through paged_wide.cu's
    # entry
    "paged_wide_tc_bf16.cu": {},
    "paged_wide_tc_f16.cu": {},
    "paged_wide_tc_f32.cu": {},
}
#: the source of each kernel, by launch-counter name
KERNELS = {name: src for src, entries in SOURCES.items() for name in entries}
#: entries with no launch counter, by source: the mask pre-pass that the
#: split backward runs once for its two kernels; the split of fp32
#: operands into bf16 planes that the wide forward's, dq's and dk/dv's
#: wrappers run before their launch (its time is theirs)
UNCOUNTED = {"flash_attention_md.cu": ("apex_flash_mask_tiles",),
             "flash_wide.cu": ("apex_flash_wide_split",)}
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
    # q, k, v, mask, cls, bits, seed3, o, lse, bh, sq, sk, d, causal, off,
    # valid_q, valid_k, mask_hper, mask_ld, threshold, inv_keep,
    # scale_log2, stream
    "apex_flash_attention_fwd_drop": [_P] * 9 + [_I] * 11 + [_F, _F, _P],
    "apex_flash_attention_fwd_masked_drop": [_P] * 9 + [_I] * 11
                                            + [_F, _F, _P],
    # q, k, v, dout, lse, delta, cls, bits, seed3, next_tile, dq, bh, sq,
    # sk, d, causal, off, valid_q, valid_k, mask_hper, threshold,
    # inv_keep, scale_log2, scale, stream
    "apex_flash_attention_bwd_dq_md": [_P] * 11 + [_I] * 10 + [_F] * 3
                                      + [_P],
    # q, k, v, dout, lse, delta, cls, bits, seed3, dk, dv, then as
    # apex_flash_attention_bwd_dq_md's from bh
    "apex_flash_attention_bwd_dkv_md": [_P] * 11 + [_I] * 10 + [_F] * 3
                                       + [_P],
    # mask, cls, bits, nmask, sq, sk, mask_ld, causal, off, valid_q,
    # valid_k, stream
    "apex_flash_mask_tiles": [_P] * 3 + [_I] * 8 + [_P],
    # q, k, v, dout, lse, delta, mask, cls, bits, seed3, dq_acc, dq, dk, dv,
    # bh, sq, sk, d, causal, off, valid_q, valid_k, mask_hper, mask_ld,
    # threshold, inv_keep, scale_log2, scale, stream
    "apex_flash_attention_bwd_masked": [_P] * 14 + [_I] * 11 + [_F] * 3
                                       + [_P],
    "apex_flash_attention_bwd_drop": [_P] * 14 + [_I] * 11 + [_F] * 3
                                     + [_P],
    # q, k, v, dout, lse, delta, dq_acc, dq, dk, dv, bh, sq, sk, d,
    # causal, off, valid_q, valid_k, scale_log2, scale, stream
    "apex_flash_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                 _I, _I, _I, _I, _I, _I, _I, _I, _F, _F, _P],
    # q, k, v, dout, lse, delta, dq, bh, sq, sk, d, causal, off, valid_q,
    # valid_k, scale_log2, scale, stream
    "apex_flash_attention_bwd_dq": [_P] * 7 + [_I] * 8 + [_F, _F, _P],
    # as apex_flash_attention_fwd's, o fp32
    "apex_flash_attention_fwd_f32out": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _F, _P],
    # q, k, v, seed3, o, lse, bh, sq, sk, d, causal, off, valid_q, valid_k,
    # threshold, inv_keep, scale_log2, stream
    "apex_flash_attention_fwd_drop_f32out": [_P] * 6 + [_I] * 9
                                            + [_F, _F, _P],
    # q, k, v, dout, lse, delta, dq, dk, dv (fp32), bh, sq, sk, d, causal,
    # off, valid_q, valid_k, scale_log2, scale, stream
    "apex_flash_attention_bwd_f32out": [_P] * 9 + [_I] * 8 + [_F, _F, _P],
    # q, k, v, dout, lse, delta, seed3, dq, dk, dv (fp32), bh, sq, sk, d,
    # causal, off, valid_q, valid_k, threshold, inv_keep, scale_log2,
    # scale, stream
    "apex_flash_attention_bwd_drop_f32out": [_P] * 10 + [_I] * 9
                                            + [_F] * 3 + [_P],
    # q, k, v, dout, lse, delta, dk, dv, bh, sq, sk, d, causal, off,
    # valid_q, valid_k, scale_log2, scale, stream
    "apex_flash_attention_bwd_dkv": [_P] * 8 + [_I] * 8 + [_F, _F, _P],
    # as apex_flash_attention_bwd_dq's and _dkv's, dq or dk, dv fp32
    "apex_flash_attention_bwd_dq_f32out": [_P] * 7 + [_I] * 8
                                          + [_F, _F, _P],
    "apex_flash_attention_bwd_dkv_f32out": [_P] * 8 + [_I] * 8
                                           + [_F, _F, _P],
    # q, k, v, dout, lse, delta, seed3, next_tile, dq (fp32), bh, sq, sk,
    # d, causal, off, valid_q, valid_k, threshold, inv_keep, scale_log2,
    # scale, stream
    "apex_flash_attention_bwd_dq_drop_f32out": [_P] * 9 + [_I] * 9
                                               + [_F] * 3 + [_P],
    # q, k, v, dout, lse, delta, seed3, dk, dv (fp32), bh, sq, sk, d,
    # causal, off, valid_q, valid_k, threshold, inv_keep, scale_log2,
    # scale, stream
    "apex_flash_attention_bwd_dkv_drop_f32out": [_P] * 9 + [_I] * 9
                                                + [_F] * 3 + [_P],
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
    # x, cos, sin, ln1_w, wq, wk, wv, wo, k_pages, v_pages, page_table,
    # lengths, y, kt, vt, ws, ws_bytes, clock, slots, hidden, heads, kvh,
    # d, ps, mpps, page_stride, ln_fp32, eps, scale_log2, stream
    "apex_fused_block_decode_partial": [_P] * 16 + [_LP, _P] + [_I] * 7
                                       + [_L, _I, _F, _F, _P],
    # x, ln1_w, ln1_b, wq, bq, wk, bk, wv, bv, wo, k_pages, v_pages,
    # page_table, lengths, y, kt, vt, ws, ws_bytes, clock, slots, hidden,
    # heads, kvh, d, ps, mpps, page_stride, eps, scale_log2, stream
    "apex_fused_block_decode_gpt_partial": [_P] * 18 + [_LP, _P] + [_I] * 7
                                           + [_L, _F, _F, _P],
    # q, k, v, mask, seed3, o, lse, bh, sq, sk, d, causal, off, valid_q,
    # valid_k, mask_hper, threshold, inv_keep, scale_log2, dtype, stream
    "apex_flash_wide_fwd": [_P] * 7 + [_I] * 10 + [_F, _F, _I, _P],
    # q, k, v, dout, lse, delta, mask, seed3, dq, bh, sq, sk, d, causal,
    # off, valid_q, valid_k, mask_hper, threshold, inv_keep, scale_log2,
    # scale, dtype, stream
    "apex_flash_wide_dq": [_P] * 9 + [_I] * 10 + [_F] * 3 + [_I, _P],
    # as apex_flash_wide_dq's with dk, dv in place of dq
    "apex_flash_wide_dkv": [_P] * 10 + [_I] * 10 + [_F] * 3 + [_I, _P],
    # x (fp32), planes (bf16), rows, d, stream
    "apex_flash_wide_split": [_P, _P, _L, _I, _P],
    # q, k_pages, v_pages, page_table, lengths, out, part_acc, part_ml,
    # counters, slots, h, kvh, ps, d, mpps, pages, page_stride, nsplit,
    # pages_per_split, scale_log2, dtype, tma, q_dtype, q_planes, rows,
    # stream
    "apex_paged_wide": [_P] * 9 + [_I] * 6 + [_L, _L, _I, _I, _F]
                       + [_I] * 5 + [_P],
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
