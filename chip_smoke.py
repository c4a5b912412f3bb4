#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

    python3 chip_smoke.py --phases kernels,train   # the training slice

1. **Build.**  Prints the card's name and power limit, compiles the
   port's CUDA kernels from ``apex_tpu_torch/csrc`` (``nvcc``, sm_90a)
   and prints the build time and each kernel's ``ptxas`` resource line.
2. **Kernels.**  Runs each kernel of the serving and training paths
   against its plain PyTorch version on the card at the shapes the
   main paths give it (RMSNorm forward ``[2048, 4096]`` and its backward
   with fp32 weights; causal flash attention forward and backward
   ``[1, 32, 2048, 128]`` with k/v broadcast from 8 kv heads; paged
   decode over 8 slots of page size 64 with lengths 0..4096 in a
   32-layer pool; the fused decode block, one random Llama-3-8B layer
   over the same pool; the amp unscale, Adam, the L2 norm, LAMB's phase
   1, SGD and Adagrad over the 1.923e9-element flat fp32 buffers of the
   4-layer training model, with the norm's run-to-run bit identity and
   the update kernels' noop bit identity).  Prints the max
   |diff| against its stated limit, the kernel's time, its bound (the
   larger of bytes over 3.35 TB/s and operations over the peak rate of
   their type — 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32
   — counted from this run's inputs), the plain version's time and,
   where one PyTorch call computes the same function, that call's
   time.  The fused block is timed over back-to-back eager calls
   between CUDA events (its cooperative launch is not captured into a
   graph); beside it, on a line of its own, the port's unfused layer on
   the same inputs.
3. **Serve.**  Llama-3-8B at full width and depth (random bf16 weights
   from a seeded ``torch.Generator``) served by ``InferenceEngine`` on
   the paged pool through ``engine.generate``: 8 seeded prompts of
   128..2048 tokens, 32 new tokens each, greedy.  The kernels' launch
   counters are zeroed just before and read just after; each must be
   above 0.  Prints TTFT, decode tokens/s and peak device memory.  Then
   the same prompts through a second engine on the same weights with
   ``decode_fusion="1"``: every decode layer must be one fused-block
   launch (32 per decode step) and paged attention must not launch.
4. **Check.**  For two of the requests, the decode logits of an
   engine prefill + decode run are held against the port's own
   full-forward prefill of prompt + generated tokens, for both engines
   (and, for one request, the fused engine with the fused block's plain
   version in place of its kernel); the fused decode logits are also
   printed against the unfused ones.
5. **Profile.**  Where the serve's time goes: one 2048-token prefill
   and one 8-slot decode step of each engine, each timed on the host
   clock and then under ``torch.profiler``: wall time, the device's
   busy share and the kernels that take the most device time.  With
   ``train``, the same for one training step.
6. **Train.**  After the serve's engine is freed: Llama-3-8B widths cut
   to 4 layers (1.923e9 parameters; the fp32 master and Adam moments of
   all 32 layers would not fit in 80 GB), bf16 parameters from a seeded
   ``torch.Generator`` at the JAX package's init scales, an fp32
   master, ``fused_adam(lr=1e-4)`` and ``loss_scale="dynamic"``, six
   ``make_train_step`` steps on one fixed batch of 2048 seeded tokens;
   the loss must fall and stay finite.  Then the same six steps under
   ``fused_lamb(lr=1e-4, weight_decay=0.01, max_grad_norm=1.0)``, which
   must launch its phase 1 once and the norm 1 + 2 per leaf times a
   step; then 1 layer, three steps each, under ``fused_sgd`` (momentum
   0.9, nesterov, no loss scale, ``contrib.clip_grad_norm_`` as the
   grad transform) and ``fused_adagrad(lr=1e-2)``.  In every run the
   segment from the end of the backward to the new state runs under
   ``torch.cuda.set_sync_debug_mode("error")``.  Prints each run's step
   time (median of steps 2 on), tokens/s, the model-flops share of the
   step, peak device memory and the launches per step; each run's
   kernels must have launched.
7. **Train-check.**  The same widths with 1 layer: one step's flat
   grads and loss through the kernels against the same step recomputed
   through the plain versions (a relative L2 limit on every parameter's
   slice of the flat grads, an absolute loss limit).  Then for LAMB,
   SGD and Adagrad: one update from two clones of a warm state, through
   the kernels and through their plain versions, every leaf of master
   and slots within a relative limit.

Then one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Any failed phase raises, so the
script exits non-zero and prints no result; so does a machine without
CUDA, or a directory without the ``apex_tpu_torch`` package.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import itertools
import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
BF16_FLOPS_PER_S = 989e12        # H100 SXM dense bf16 tensor cores
FP32_FLOPS_PER_S = 67e12         # H100 SXM fp32, outside the tensor cores
FULL_CFG = dict(vocab_size=128256, hidden_size=4096, num_layers=32,
                num_attention_heads=32, num_kv_heads=8,
                ffn_hidden_size=14336, max_seq_length=8192,
                rope_theta=500000.0, rms_eps=1e-5)
PROMPT_LENS = (128, 256, 384, 512, 1024, 1536, 1800, 2048)
NEW_TOKENS = 32
#: max |diff| limits, kernel vs plain version on the same bf16 inputs.
#: Both compute in fp32 and round to bf16; they differ by reduction
#: order and by one bf16 rounding of the output (2^-8 relative), so the
#: limits are a few output ulps at the outputs' magnitudes.
TOL_RMS_REL = 2.0 ** -6          # x max|ref| (rows scaled by rsqrt)
TOL_ATTN_OUT = 2e-2              # |out| <= ~3: weighted means of N(0,1)
TOL_ATTN_LSE = 1e-3              # base-2 lse, fp32 on both sides
TOL_PAGED_OUT = 2e-2
#: the fused decode block (y, k_tok, v_tok, bf16): a few ulps of each
#: output's magnitude, and a relative L2 (the kernel and its plain
#: version round the same values at the same points; sums run in
#: another order and p rounds against a split's running maximum)
TOL_FUSED_REL = 2.0 ** -6
TOL_FUSED_REL_L2 = 1e-2
#: training kernels: norm dx a few bf16 ulps, dw fp32 row sums in
#: another order; the unscale is one fp32 multiply on both sides
#: (exact); Adam may contract multiply-adds into FMAs (a few fp32 ulps
#: of |p| <= ~5)
TOL_NORM_DW_REL = 1e-3
TOL_ADAM = 2e-6
#: the optimizer family: the L2 norm's fp32 sum of squares over 1.9e9
#: elements in another order than the plain version's (1e-6 relative);
#: LAMB phase 1, SGD, Adagrad as Adam (a multiply-add contracted or
#: not), each output within 1e-6 of its largest magnitude
TOL_L2NORM_REL = 1e-6
TOL_UPDATE_REL = 1e-6
#: flash dq/dk/dv (fp32 accumulation, p and ds rounded to bf16 on both
#: sides, dq summed by atomics in any order) are held element by
#: element, |got - ref| <= RTOL |ref| + ATOL (two bf16 ulps of the
#: element, and an absolute floor far below a typical |dq| ~ 0.03), and
#: each output as a whole within a relative L2 difference
TOL_FLASH_BWD_RTOL = 2.0 ** -6
TOL_FLASH_BWD_ATOL = 2.0 ** -9
TOL_FLASH_BWD_REL_L2 = 1e-2
#: the kernels each main path must launch; a kernel's "launches" in the
#: JSON line is the count of the path it was ported for (the forward
#: norm and flash kernels: the serve)
SERVE_KERNELS = ("layer_norm", "flash_attention", "paged_attention",
                 "fused_block_decode")
#: the serve kernels only the fused engine launches, and those it must not
FUSED_ONLY = ("fused_block_decode",)
UNFUSED_ONLY = ("paged_attention",)
TRAIN_KERNELS = ("layer_norm", "layer_norm_bwd", "flash_attention",
                 "flash_attention_bwd", "fused_scale", "fused_adam")
#: the optimizer runs of the train phase: the kernels each must launch,
#: and the run whose launches each kernel reports (the rest: "adam")
RULE_KERNELS = {"lamb": ("fused_l2norm", "fused_lamb1"),
                "sgd": ("fused_l2norm", "fused_sgd"),
                "adagrad": ("fused_adagrad",)}
KERNEL_RUN = {"fused_l2norm": "lamb", "fused_lamb1": "lamb",
              "fused_sgd": "sgd", "fused_adagrad": "adagrad"}
#: the 4-layer training model (Llama-3-8B widths) and its batch
TRAIN_LAYERS = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 6
TRAIN_LR = 1e-4
#: the LAMB run (4 layers, six steps) and the 1-layer SGD (with the grad
#: clipper, no loss scale) and Adagrad runs, three steps each
LAMB_KW = dict(lr=TRAIN_LR, weight_decay=0.01, max_grad_norm=1.0)
SGD_KW = dict(lr=0.1, momentum=0.9, nesterov=True)
ADAGRAD_KW = dict(lr=1e-2)
SGD_CLIP = 1.0
RULE_LAYERS, RULE_STEPS = 1, 3
#: train-check of the update rules (1 layer): one update through the
#: kernels vs the same update through the plain versions, from clones of
#: one state, each leaf of master and slots within 1e-6 of its largest
#: magnitude (the norms are summed in another order: LAMB's clip factor
#: and trust ratios agree to a few fp32 ulps)
TOL_RULE_CHECK_REL = 1e-6
#: train-check (1 layer): flat grads through the kernels vs through the
#: plain versions, bf16 activations rounded at different points in the
#: two (and atomics in dq), so a relative L2 of a few 1e-3 in every
#: leaf (the worst leaf is held to the limit); the loss (~12 nats)
#: within 2e-2
TOL_TRAIN_GRAD_REL_L2 = 3e-2
TOL_TRAIN_LOSS = 2e-2
#: decode-vs-full-forward logit limit for the serve check: bf16
#: activations rounded at every op of 32 layers, along two different
#: kernel/matmul paths (paged decode vs causal flash prefill); the
#: fused engine is held to the same limit
TOL_LOGITS = 0.25


def _smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, iters: int) -> float:
    """Mean device time of one call of ``fn``: ``iters`` calls captured
    in one CUDA graph, the graph replayed between two CUDA events.  The
    graph keeps the host's per-call Python and dispatch cost out of the
    number, which for a call of tens of microseconds would otherwise be
    the time measured."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                                        # warm-up, off-graph
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()                                  # warm the replay
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    ms = start.elapsed_time(end) / iters
    del graph
    torch.cuda.empty_cache()
    return ms


def _eager_ms(fn, iters: int) -> float:
    """Mean wall time of one eager call, host dispatch included (CUDA
    events around ``iters`` back-to-back calls)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _bound(nbytes: float, flops: float, rate: float = BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    print(f"  {name}: max|diff| {err:.6g} (limit {tol:.6g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max|diff| {err} over limit {tol}")


def _elementwise(got, ref, rtol: float, atol: float):
    """The worst ratio of ``|got - ref|`` to ``rtol |ref| + atol`` over
    the elements (at most 1 passes), and the relative L2 difference."""
    g, r = got.float(), ref.float()
    ratio = ((g - r).abs() / (rtol * r.abs() + atol)).max().item()
    return ratio, ((g - r).norm() / r.norm()).item()


def _check_flash_bwd(label, got, ref) -> float:
    """Hold dq, dk, dv of ``got`` against ``ref`` element by element and
    as wholes; returns the largest max |diff|."""
    err, failed = 0.0, []
    for nm, g_, r_ in zip(("dq", "dk", "dv"), got, ref):
        ratio, rel = _elementwise(g_, r_, TOL_FLASH_BWD_RTOL,
                                  TOL_FLASH_BWD_ATOL)
        e = (g_.float() - r_.float()).abs().max().item()
        ok = ratio <= 1.0 and rel <= TOL_FLASH_BWD_REL_L2
        print(f"  {label} {nm}: max|diff| {e:.6g}, worst |diff| / "
              f"(2^-6 |ref| + 2^-9) {ratio:.4g} (limit 1), relative L2 "
              f"{rel:.4g} (limit {TOL_FLASH_BWD_REL_L2}) "
              f"{'ok' if ok else 'FAIL'}")
        failed += [] if ok else [nm]
        err = max(err, e)
    if failed:
        raise AssertionError(f"{label} {failed}: off the plain version")
    return err


def phase_build():
    from apex_tpu_torch.ops import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    for src in _build.SOURCES.values():
        log = (_build.BUILD_DIR / f"{src}.log")
        if log.exists():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"  {src}: {line.strip()}")


def phase_kernels(dev, gen):
    """Each kernel against its plain version at the main path's shapes;
    returns the kernels' records (launches filled in by the serve)."""
    # modules by name: the package re-exports functions of the same names
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    bf = torch.bfloat16
    recs = {}

    # -- RMSNorm [2048, 4096] (a 2048-token prefill's norm) --------------
    rows, hidden = 2048, 4096
    x = torch.randn(rows, hidden, generator=gen, device=dev).to(bf)
    w = (1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)).to(bf)
    got = ln.rms_norm(x, w, eps=1e-5)
    ref = ln.rms_norm_reference(x, w, eps=1e-5)
    err = (got.float() - ref.float()).abs().max().item()
    print("rms_norm [2048, 4096] bf16")
    _check("rms_norm", err, TOL_RMS_REL * ref.float().abs().max().item())
    # the kernel's other branches: LayerNorm with bias, fp32 weights, a
    # hidden size that is no multiple of 8 (element-wise loads), fp32 x
    bias = (0.1 * torch.randn(hidden, generator=gen, device=dev)).to(bf)
    ref_ln = ln.layer_norm_reference(x, w, bias)
    _check("layer_norm (bias)", (ln.layer_norm(x, w, bias).float()
                                 - ref_ln.float()).abs().max().item(),
           TOL_RMS_REL * ref_ln.float().abs().max().item())
    for xx, ww in ((x[:, :1001].contiguous(), w[:1001].float()),
                   (x.float(), w.float())):
        ref_o = ln.rms_norm_reference(xx, ww)
        _check(f"rms_norm {tuple(xx.shape)} {xx.dtype}/{ww.dtype}",
               (ln.rms_norm(xx, ww).float()
                - ref_o.float()).abs().max().item(),
               TOL_RMS_REL * ref_o.float().abs().max().item())
    nbytes = 2 * x.numel() * 2 + hidden * 2
    bound, by = _bound(nbytes, 4 * x.numel())
    # timed over 4 inputs in turn (64 MB, more than the 50 MB L2), so
    # each call reads its input from device memory as a prefill does
    xs = itertools.cycle([x] + [torch.randn(rows, hidden, generator=gen,
                                            device=dev).to(bf)
                                for _ in range(3)])
    recs["layer_norm"] = dict(
        name="rms_norm", route="cuda",
        source="apex_tpu_torch/csrc/layer_norm.cu",
        replaces="apex_tpu/ops/layer_norm.py:100", max_abs_err=err,
        ms=_time_ms(lambda: ln.rms_norm(next(xs), w, eps=1e-5), 48),
        plain_ms=_time_ms(
            lambda: ln.rms_norm_reference(next(xs), w, eps=1e-5), 20),
        bound_ms=bound, bound_by=by,
        library_ms=_time_ms(
            lambda: F.rms_norm(next(xs), (hidden,), w, 1e-5), 48),
        eager_ms=_eager_ms(lambda: ln.rms_norm(x, w, eps=1e-5), 50))
    del xs

    # -- causal flash attention [1, 32, 2048, 128], kv from 8 heads -----
    b, h, kvh, s, d = 1, 32, 8, 2048, 128
    q = torch.randn(b, h, s, d, generator=gen, device=dev).to(bf)
    kk = torch.randn(b, kvh, s, d, generator=gen, device=dev).to(bf)
    vv = torch.randn(b, kvh, s, d, generator=gen, device=dev).to(bf)
    k, v = (t[:, :, None].expand(b, kvh, h // kvh, s, d).reshape(b, h, s, d)
            for t in (kk, vv))
    scale = d ** -0.5
    q3, k3, v3 = (t.reshape(b * h, s, d).contiguous() for t in (q, k, v))
    out, lse = attn._fwd(q3, k3, v3, True, scale)
    ref_out, ref_lse = attn._fwd_reference(q3, k3, v3, True, scale)
    err = (out.float() - ref_out.float()).abs().max().item()
    err_lse = (lse - ref_lse).abs().max().item()
    got_pub = attn.flash_attention(q, k, v, causal=True)
    err_pub = (got_pub.float().reshape(b * h, s, d)
               - ref_out.float()).abs().max().item()
    print("flash_attention causal [1, 32, 2048, 128] bf16")
    _check("flash out", max(err, err_pub), TOL_ATTN_OUT)
    _check("flash lse (base 2)", err_lse, TOL_ATTN_LSE)
    del ref_out, ref_lse
    nbytes = 4 * q.numel() * 2 + b * h * s * 4          # q k v o + lse
    flops = 4 * s * s * d * h / 2                       # causal half
    bound, by = _bound(nbytes, flops)
    recs["flash_attention"] = dict(
        name="flash_attention", route="cuda",
        source="apex_tpu_torch/csrc/flash_attention.cu",
        replaces="apex_tpu/ops/attention.py:210", max_abs_err=max(err, err_pub),
        ms=_time_ms(lambda: attn._fwd(q3, k3, v3, True, scale), 10),
        eager_ms=_eager_ms(lambda: attn._fwd(q3, k3, v3, True, scale), 10),
        plain_ms=_time_ms(
            lambda: attn._fwd_reference(q3, k3, v3, True, scale), 3),
        bound_ms=bound, bound_by=by,
        library_ms=_time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 10))
    del q, k, v, q3, k3, v3, kk, vv, out, lse, got_pub

    # -- paged decode: 8 slots, page 64, one layer of a 32-layer pool ----
    slots, layers, ps, mpps = 8, 32, 64, 64
    lengths_l = [0, 1, 64, 65, 1500, 2048, 3000, 4096]
    n_pages = slots * mpps
    pool_shape = (n_pages + 1, layers, kvh, ps, d)
    pool_k = torch.randn(pool_shape, generator=gen, device=dev).to(bf)
    pool_v = torch.randn(pool_shape, generator=gen, device=dev).to(bf)
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    table = torch.full((slots, mpps), n_pages, dtype=torch.int32, device=dev)
    cursor = 0
    for i, ln_i in enumerate(lengths_l):
        need = -(-ln_i // ps)
        table[i, :need] = perm[cursor:cursor + need]
        cursor += need
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    qd = torch.randn(slots, h, d, generator=gen, device=dev).to(bf)
    layer = 5
    kp, vp = pool_k[:, layer], pool_v[:, layer]         # strided views
    got = pa.paged_decode_attention(qd, kp, vp, table, lengths)
    ref = pa.paged_decode_reference(qd, kp, vp, table, lengths, scale)
    err = (got.float() - ref.float()).abs().max().item()
    print("paged_decode_attention 8 slots, lengths "
          f"{lengths_l}, page 64, pool [513, 32, 8, 64, 128] bf16")
    _check("paged out", err, TOL_PAGED_OUT)
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("a length-0 slot must emit zeros")
    # a window of one split (8 pages): the kernel writes its output
    # without the merge pass
    short_len = torch.clamp(lengths, max=8 * ps)
    got = pa.paged_decode_attention(qd, kp, vp, table[:, :8].contiguous(),
                                    short_len)
    ref = pa.paged_decode_reference(qd, kp, vp, table[:, :8], short_len,
                                    scale)
    _check("paged out, one split",
           (got.float() - ref.float()).abs().max().item(), TOL_PAGED_OUT)
    live_tokens = sum(lengths_l)
    nbytes = live_tokens * kvh * d * 2 * 2 + 2 * qd.numel() * 2 \
        + table.numel() * 4 + slots * 4
    flops = 4 * live_tokens * h * d
    bound, by = _bound(nbytes, flops)
    # timed over 4 layers of the pool in turn (4 x 44 MB of live k/v), so
    # each call reads its pages from device memory as a decode step does
    views = itertools.cycle([(pool_k[:, i], pool_v[:, i])
                             for i in range(layer, layer + 4)])
    recs["paged_attention"] = dict(
        name="paged_decode_attention", route="cuda",
        source="apex_tpu_torch/csrc/paged_attention.cu",
        replaces="apex_tpu/ops/paged_attention.py:108", max_abs_err=err,
        ms=_time_ms(lambda: pa.paged_decode_attention(
            qd, *next(views), table, lengths), 48),
        plain_ms=_time_ms(lambda: pa.paged_decode_reference(
            qd, *next(views), table, lengths, scale), 4),
        bound_ms=bound, bound_by=by, library_ms=None,
        eager_ms=_eager_ms(lambda: pa.paged_decode_attention(
            qd, kp, vp, table, lengths), 50))
    del views
    # its own generator: the later kernels keep the inputs they had
    fgen = torch.Generator(device=dev)
    fgen.manual_seed(gen.initial_seed() + 1)
    _fused_kernel(dev, fgen, recs, pool_k, pool_v, table, lengths)
    del pool_k, pool_v, kp, vp
    torch.cuda.empty_cache()
    _train_kernels(dev, gen, recs)
    # its own generator again: the kernels above keep their inputs
    ogen = torch.Generator(device=dev)
    ogen.manual_seed(gen.initial_seed() + 2)
    _optimizer_kernels(dev, ogen, recs)
    for r in recs.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (eager call, host "
              f"included, {r.pop('eager_ms'):.4f} ms), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}")
    torch.cuda.empty_cache()
    return recs


def _fused_kernel(dev, gen, recs, pool_k, pool_v, table, lengths):
    """The fused decode block at Llama-3-8B width: one random layer
    (built in the model tree's layout and re-laid-out by
    ``fused_layer_params``, as the engine does) over one layer of the
    paged case's 32-layer pool, 8 slots, against its plain version; and
    the port's unfused layer on the same inputs, for comparison."""
    from apex_tpu_torch.inference import kv_cache, models
    from apex_tpu_torch.transformer.testing import LlamaConfig
    from apex_tpu_torch.transformer.testing.standalone_llama import (
        _rope_cos_sin)
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    cfg = LlamaConfig(**dict(FULL_CFG, num_layers=1))
    lp = _random_llama(cfg, dev, int(torch.randint(1 << 30, (1,),
                                                    generator=gen,
                                                    device=dev)),
                       only="layer_0")["layer_0"]
    blk = models.fused_layer_params("llama", cfg, {"layer_0": lp})[0]
    slots, hidden = table.shape[0], cfg.hidden_size
    d, kvh = pool_k.shape[4], pool_k.shape[2]
    h = cfg.num_attention_heads
    window = table.shape[1] * pool_k.shape[3]
    x = torch.randn(slots, hidden, generator=gen, device=dev).to(torch.bfloat16)
    cos_t, sin_t = _rope_cos_sin(window, d, cfg.rope_theta, device=dev)
    pos = torch.clamp(lengths.long(), max=window - 1)
    cos, sin = cos_t.reshape(window, d)[pos], sin_t.reshape(window, d)[pos]
    layer = 9
    kp, vp = pool_k[:, layer], pool_v[:, layer]
    kw = dict(kind="llama", eps=cfg.rms_eps, cos=cos, sin=sin)
    got = pa.fused_block_decode(x, blk, kp, vp, table, lengths, **kw)
    ref = pa.fused_block_reference(x, blk, kp, vp, table, lengths, **kw)
    print(f"fused_block_decode: one Llama-3-8B layer (hidden {hidden}, "
          f"{h} heads over {kvh}, ffn {cfg.ffn}), 8 slots, lengths "
          f"{lengths.tolist()}, layer {layer} of the pool")
    err = 0.0
    for name, g_, r_ in zip(("y", "k_tok", "v_tok"), got, ref):
        e = (g_.float() - r_.float()).abs().max().item()
        rel = ((g_.float() - r_.float()).norm() / r_.float().norm()).item()
        _check(f"fused {name}", e,
               TOL_FUSED_REL * r_.float().abs().max().item())
        print(f"    relative L2 {rel:.4g} (limit {TOL_FUSED_REL_L2})")
        if rel > TOL_FUSED_REL_L2:
            raise AssertionError(f"fused {name}: relative L2 {rel}")
        err = max(err, e)
    del got, ref
    weights = sum(t.numel() for t in blk.values())
    live = int(torch.clamp(lengths, max=window).sum())
    nbytes = 2 * weights + live * kvh * d * 2 * 2 + 2 * 2 * x.numel() \
        + 2 * 2 * slots * kvh * d + 2 * 4 * cos.numel() \
        + 4 * table.numel() + 4 * slots
    flops = 2 * slots * weights + 4 * (live + slots) * h * d
    bound, by = _bound(nbytes, flops)
    # four layers of the pool in turn, as a decode step reads them; the
    # 436 MB of weights never fit in the 50 MB L2
    views = itertools.cycle([(pool_k[:, i], pool_v[:, i])
                             for i in range(layer, layer + 4)])
    ms = _eager_ms(lambda: pa.fused_block_decode(
        x, blk, *next(views), table, lengths, **kw), 40)
    plain_ms = _eager_ms(lambda: pa.fused_block_reference(
        x, blk, *next(views), table, lengths, **kw), 3)
    print(f"  fused_block_decode: {weights} weights ({2 * weights / 1e6:.1f} "
          f"MB) + {live} live tokens' k/v; {ms:.4f} ms per call (CUDA "
          f"events around 40 eager calls), bound {bound:.4f} ms ({by}), "
          f"{nbytes / ms / 1e6:.1f} GB/s")
    _fused_phases(pa, x, blk, kp, vp, table, lengths, kw)
    # the port's unfused layer on the same inputs: the per-op path with
    # the pool append (which writes each slot's next row, so it runs
    # last) and paged attention over lengths + 1
    cache = kv_cache.PagedKVCache(
        k=pool_k, v=pool_v, page_table=table, lengths=lengths.clone(),
        capacity=torch.full_like(lengths, window))
    dims = models.tp_dims("llama", cfg, 1)
    targets = kv_cache.append_targets(cache)

    def unfused():
        return models._llama_decode_layer(
            lp, x, cache, layer, cos[:, None], sin[:, None], lengths + 1,
            targets, dims, cfg.rms_eps)

    un_eager = _eager_ms(unfused, 40)
    un_graph = _time_ms(unfused, 20)
    print(f"  unfused layer (the port's per-op decode layer, same inputs): "
          f"{un_eager:.4f} ms per eager call, {un_graph:.4f} ms per call "
          f"in CUDA-graph replay; fused / unfused eager "
          f"{ms / un_eager:.3f}")
    recs["fused_block_decode"] = dict(
        name="fused_block_decode", route="cuda",
        source="apex_tpu_torch/csrc/fused_block_decode.cu",
        replaces="apex_tpu/ops/paged_attention.py:445", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, eager_ms=ms)
    del blk, lp, cache, views
    torch.cuda.empty_cache()


FUSED_PHASES = ("q/k/v", "q/k/v sums + RoPE", "attention", "merge + fold",
                "o", "x2 + norm2", "gate/up", "down", "y")


def _fused_phases(pa, x, blk, kp, vp, table, lengths, kw):
    """Where the fused block's time goes: the kernel's phase clock (block
    0 reads the global timer as it leaves each grid barrier; the last
    block to finish sets the end), the median over 10 launches."""
    kvh, ps, d, h = pa._fused_geometry(x, blk, kp, vp, table, lengths,
                                       kw["kind"], kw["cos"], kw["sin"],
                                       False)
    clock = torch.zeros(len(FUSED_PHASES) + 1, dtype=torch.int64,
                        device=x.device)
    runs = []
    for _ in range(10):
        clock.zero_()
        pa._fused_kernel_call(x, blk, kp, vp, table, lengths, kw["cos"],
                              kw["sin"], kw["eps"], d ** -0.5, True, kvh, ps,
                              d, h, clock=clock)
        runs.append(np.diff(np.asarray(clock.tolist(), np.int64)) / 1e3)
    us = np.median(np.stack(runs), axis=0)
    print(f"  fused_block_decode phases (phase clock, median of 10 launches, "
          f"{us.sum():.1f} us in all): " + ", ".join(
              f"{n} {t:.1f} us" for n, t in zip(FUSED_PHASES, us)))
    return dict(zip(FUSED_PHASES, us.tolist()))


def _chunked(fn, n: int, chunk: int) -> None:
    """``fn(slice)`` over ``[0, n)`` in chunks, results dropped: a plain
    version over a buffer whose full-size temporaries would not fit."""
    for i in range(0, n, chunk):
        fn(slice(i, i + chunk))


def _train_numel() -> int:
    """Elements of the 4-layer training model's flat master."""
    from apex_tpu_torch.inference.weights import llama_param_shapes
    from apex_tpu_torch.transformer.testing import LlamaConfig
    shapes = llama_param_shapes(LlamaConfig(**dict(
        FULL_CFG, num_layers=TRAIN_LAYERS)))
    return sum(int(np.prod(shape)) for shape in shapes.values())


def _train_kernels(dev, gen, recs):
    """The training path's four kernels against their plain versions at
    the train phase's shapes."""
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    bf = torch.bfloat16

    # -- RMSNorm backward [2048, 4096] bf16, fp32 weight ------------------
    rows, hidden = TRAIN_SEQ, 4096
    x = torch.randn(rows, hidden, generator=gen, device=dev).to(bf)
    dy = torch.randn(rows, hidden, generator=gen, device=dev).to(bf)
    w = 1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)
    dx, dw, _ = ln._bwd_2d(x, w, dy, 1e-5, True)
    rdx, rdw, _ = ln._bwd_reference(x, w, dy, 1e-5, True)
    print("rms_norm backward [2048, 4096] bf16, fp32 weight")
    err = (dx.float() - rdx.float()).abs().max().item()
    _check("rms_norm bwd dx", err, TOL_RMS_REL * rdx.float().abs().max()
           .item())
    _check("rms_norm bwd dw", (dw - rdw).abs().max().item(),
           TOL_NORM_DW_REL * rdw.abs().max().item())
    b = 0.1 * torch.randn(hidden, generator=gen, device=dev)
    got, ref = ln._bwd_2d(x, w, dy, 1e-5, False), \
        ln._bwd_reference(x, w, dy, 1e-5, False)
    _check("layer_norm bwd dx", (got[0].float() - ref[0].float()).abs()
           .max().item(), TOL_RMS_REL * ref[0].float().abs().max().item())
    _check("layer_norm bwd db", (got[2] - ref[2]).abs().max().item(),
           TOL_NORM_DW_REL * ref[2].abs().max().item())
    del b, got, ref
    nbytes = 3 * x.numel() * 2 + 2 * hidden * 4
    bound, by = _bound(nbytes, 10 * x.numel(), FP32_FLOPS_PER_S)
    xr = x.clone().requires_grad_()
    wr = w.clone().requires_grad_()
    lib_fb = _time_ms(lambda: torch.autograd.grad(
        F.rms_norm(xr, (hidden,), wr, 1e-5), (xr, wr), dy), 48)
    lib_f = _time_ms(lambda: F.rms_norm(x, (hidden,), w, 1e-5), 48)
    recs["layer_norm_bwd"] = dict(
        name="rms_norm_bwd", route="cuda",
        source="apex_tpu_torch/csrc/layer_norm.cu",
        replaces="apex_tpu/ops/layer_norm.py:114", max_abs_err=err,
        ms=_time_ms(lambda: ln._bwd_2d(x, w, dy, 1e-5, True), 48),
        plain_ms=_time_ms(lambda: ln._bwd_reference(x, w, dy, 1e-5, True),
                          10),
        bound_ms=bound, bound_by=by, library_ms=lib_fb - lib_f,
        eager_ms=_eager_ms(lambda: ln._bwd_2d(x, w, dy, 1e-5, True), 50))
    del x, dy, w, dx, dw, rdx, rdw, xr, wr

    # -- flash backward, causal [1, 32, 2048, 128], kv from 8 heads -------
    b_, h, kvh, s, d = 1, 32, 8, TRAIN_SEQ, 128
    q = torch.randn(b_, h, s, d, generator=gen, device=dev).to(bf)
    kk = torch.randn(b_, kvh, s, d, generator=gen, device=dev).to(bf)
    vv = torch.randn(b_, kvh, s, d, generator=gen, device=dev).to(bf)
    do = torch.randn(b_, h, s, d, generator=gen, device=dev).to(bf)
    k, v = (t[:, :, None].expand(b_, kvh, h // kvh, s, d)
            .reshape(b_, h, s, d) for t in (kk, vv))
    scale = d ** -0.5
    q3, k3, v3, do3 = (t.reshape(b_ * h, s, d).contiguous()
                       for t in (q, k, v, do))
    out, lse = attn._fwd(q3, k3, v3, True, scale)
    got = attn._bwd(q3, k3, v3, out, lse, do3, True, scale)
    ref = attn._bwd_reference(q3, k3, v3, out, lse, do3, True, scale)
    print("flash_attention backward causal [1, 32, 2048, 128] bf16")
    err = _check_flash_bwd("flash bwd", got, ref)
    # what the rule reads for plainly wrong backwards (the plain version
    # with its causal boundary one 64-key tile late, and with the keys
    # of the second half dropped): each must fail it
    for label, wrong in (("causal boundary +64", dict(causal_off=64)),
                         ("keys >= 1024 dropped", dict(valid=(s, s // 2)))):
        bad = attn._bwd_reference(q3, k3, v3, out, lse, do3, True, scale,
                                  **wrong)
        readings = [_elementwise(b_, r_, TOL_FLASH_BWD_RTOL,
                                 TOL_FLASH_BWD_ATOL)
                    for b_, r_ in zip(bad, ref)]
        print(f"  wrong backward ({label}): (worst ratio, relative L2) of "
              f"dq, dk, dv {[(round(a, 4), round(r, 4)) for a, r in readings]}")
        if all(a <= 1.0 and r <= TOL_FLASH_BWD_REL_L2 for a, r in readings):
            raise AssertionError(f"the flash backward limits pass a wrong "
                                 f"backward ({label})")
        del bad
    del got, ref
    nbytes = 8 * q3.numel() * 2 + 2 * b_ * h * s * 4
    bound, by = _bound(nbytes, 5 * s * s * d * h)     # 5 products, causal
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_fb = _time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True),
        (qr, kr, vr), do), 10)
    lib_f = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 10)
    recs["flash_attention_bwd"] = dict(
        name="flash_attention_bwd", route="cuda",
        source="apex_tpu_torch/csrc/flash_attention_bwd.cu",
        replaces="apex_tpu/ops/attention.py:472", max_abs_err=err,
        ms=_time_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3, True,
                                      scale), 10),
        plain_ms=_time_ms(lambda: attn._bwd_reference(
            q3, k3, v3, out, lse, do3, True, scale), 3),
        bound_ms=bound, bound_by=by, library_ms=lib_fb - lib_f,
        eager_ms=_eager_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3,
                                             True, scale), 10))
    del q, k, v, kk, vv, do, q3, k3, v3, do3, out, lse, qr, kr, vr
    torch.cuda.empty_cache()

    # -- the amp unscale over the flat fp32 grads [1.923e9] ----------------
    n = _train_numel()
    print(f"fused_scale (unscale) over the flat fp32 grads [{n}]")
    g = torch.randn(n, generator=gen, device=dev).mul_(1000.0)
    inv = torch.full((), 2.0 ** -16, device=dev)
    outk, flag = fu.fused_scale(g, inv)
    chunk = 1 << 27
    err = 0.0
    for i in range(0, n, chunk):
        ref, _ = fu._scale_reference(g[i:i + chunk], inv, torch.float32)
        err = max(err, (outk[i:i + chunk] - ref).abs().max().item())
    _check("fused_scale out", err, 0.0)
    if flag.item() != 0.0:
        raise AssertionError("a finite buffer raised the overflow flag")
    g[n - 5] = float("inf")                      # past 2^32 bytes
    _, flag = fu.fused_scale(g, inv, out=outk)
    if flag.item() != 1.0:
        raise AssertionError("an inf past 2^32 bytes was not flagged")
    g[n - 5] = 0.0
    del outk
    found = torch.zeros((), device=dev)
    recs["fused_scale"] = dict(
        name="fused_scale", route="cuda",
        source="apex_tpu_torch/csrc/fused_update.cu",
        replaces="apex_tpu/ops/fused_update.py:132", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_scale(g, inv, out=g), 4),
        plain_ms=_time_ms(lambda: _chunked(lambda sl: fu._scale_reference(
            g[sl], inv, torch.float32), n, chunk), 1),
        library_ms=_time_ms(
            lambda: torch._amp_foreach_non_finite_check_and_unscale_(
                [g], found, inv), 4),
        eager_ms=_eager_ms(lambda: fu.fused_scale(g, inv, out=g), 4))
    recs["fused_scale"]["bound_ms"], recs["fused_scale"]["bound_by"] = \
        _bound(8 * n, n, FP32_FLOPS_PER_S)
    del g
    torch.cuda.empty_cache()

    # -- Adam over the flat fp32 master, grads, moments [1.923e9] ----------
    print(f"fused_adam_flat over flat fp32 p, g, m, v [{n}]")
    p = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    m = 0.1 * torch.randn(n, generator=gen, device=dev)
    v = torch.rand(n, generator=gen, device=dev).mul_(0.01)
    kw = dict(lr=TRAIN_LR, beta1=0.9, beta2=0.999, eps=1e-8,
              weight_decay=0.01, step=torch.full((), 3.0, device=dev))
    p0, m0, v0 = p.clone(), m.clone(), v.clone()
    fu.fused_adam_flat(p, g, m, v, **kw)
    hp = fu._adam_hparams(dev, noop_flag=0.0, bias_correction=True,
                          grad_scale=1.0, **{k_: kw[k_] for k_ in (
                              "lr", "beta1", "beta2", "eps",
                              "weight_decay", "step")})
    err = 0.0
    for i in range(0, n, chunk):
        sl = slice(i, i + chunk)
        rp, rm, rv = fu._adam_kernel_reference(p0[sl], g[sl], m0[sl],
                                               v0[sl], hp, True)
        err = max(err, (p[sl] - rp).abs().max().item(),
                  (m[sl] - rm).abs().max().item(),
                  (v[sl] - rv).abs().max().item())
    _check("fused_adam p/m/v", err, TOL_ADAM)
    snap = p.clone()
    fu.fused_adam_flat(p, g, m, v, noop_flag=torch.ones((), device=dev),
                       **kw)
    if not torch.equal(p, snap):
        raise AssertionError("the noop flag changed p")
    del p0, m0, v0, snap
    steps = torch.full((), 3.0, device=dev)
    recs["fused_adam"] = dict(
        name="fused_adam", route="cuda",
        source="apex_tpu_torch/csrc/fused_update.cu",
        replaces="apex_tpu/ops/fused_update.py:274", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_adam_flat(p, g, m, v, **kw), 4),
        plain_ms=_time_ms(lambda: _chunked(
            lambda sl: fu._adam_kernel_reference(p[sl], g[sl], m[sl], v[sl],
                                                 hp, True), n, chunk), 1),
        library_ms=_time_ms(lambda: torch._fused_adamw_(
            [p], [g], [m], [v], [], [steps], lr=TRAIN_LR, beta1=0.9,
            beta2=0.999, weight_decay=0.01, eps=1e-8, amsgrad=False,
            maximize=False), 4),
        eager_ms=_eager_ms(lambda: fu.fused_adam_flat(p, g, m, v, **kw), 4))
    recs["fused_adam"]["bound_ms"], recs["fused_adam"]["bound_by"] = \
        _bound(28 * n, 15 * n, FP32_FLOPS_PER_S)
    del p, g, m, v
    torch.cuda.empty_cache()


def _max_rel_err(pairs):
    """``(max |got - ref|, max |ref|)`` over ``(got, ref)`` pairs."""
    err = ref_max = 0.0
    for got, ref in pairs:
        err = max(err, (got - ref).abs().max().item())
        ref_max = max(ref_max, ref.abs().max().item())
    return err, ref_max


def _check_update(name, fu_ref, outs, ins, hp, flags, n, chunk):
    """Hold each output of an update kernel against its plain version,
    slice by slice (``fu_ref(*ins, hp, *flags)`` on the same slices);
    returns the largest max |diff|."""
    worst = 0.0
    for k, out in enumerate(outs):
        err, ref_max = _max_rel_err(
            (out[i:i + chunk],
             fu_ref(*(t[i:i + chunk] for t in ins), hp, *flags)[k])
            for i in range(0, n, chunk))
        _check(f"{name} output {k}", err, TOL_UPDATE_REL * ref_max)
        worst = max(worst, err)
    return worst


def _optimizer_kernels(dev, gen, recs):
    """The optimizer family's four kernels against their plain versions
    at the train phase's flat shape (1.923e9 fp32 elements), with the
    noop bit-identity of the three update kernels."""
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    n = _train_numel()
    chunk = 1 << 27
    one = torch.ones((), device=dev)
    src = "apex_tpu_torch/csrc/fused_update.cu"

    # -- the L2 norm (LAMB's global and per-leaf norms, the clipper) ------
    print(f"fused_l2norm over a flat fp32 buffer [{n}]")
    x = torch.randn(n, generator=gen, device=dev)
    got = fu.fused_l2norm(x)
    ref = torch.empty((), device=dev)
    fu._l2norm_plain(x, ref)
    err = abs(got.item() - ref.item())
    _check("fused_l2norm", err, TOL_L2NORM_REL * ref.item())
    if not all(torch.equal(fu.fused_l2norm(x), got) for _ in range(3)):
        raise AssertionError("fused_l2norm differs from run to run")
    print(f"  norm {got.item():.9g}, the same bits in 3 more runs")
    recs["fused_l2norm"] = dict(
        name="fused_l2norm", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:206", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_l2norm(x), 8),
        plain_ms=_time_ms(lambda: fu._l2norm_plain(x, ref), 1),
        library_ms=_time_ms(lambda: torch.linalg.vector_norm(x), 8),
        eager_ms=_eager_ms(lambda: fu.fused_l2norm(x), 8))
    recs["fused_l2norm"]["bound_ms"], recs["fused_l2norm"]["bound_by"] = \
        _bound(4 * n, 2 * n, FP32_FLOPS_PER_S)
    del x
    torch.cuda.empty_cache()

    # -- LAMB phase 1 over p, g, m, v -> m, v, u [1.923e9] -----------------
    print(f"fused_lamb_phase1_flat over flat fp32 p, g, m, v, u [{n}]")
    p = torch.randn(n, generator=gen, device=dev)
    g = torch.randn(n, generator=gen, device=dev)
    m = 0.1 * torch.randn(n, generator=gen, device=dev)
    v = torch.rand(n, generator=gen, device=dev).mul_(0.01).add_(0.01)
    u = torch.empty_like(p)
    kw = dict(beta1=0.9, beta2=0.999, eps=1e-6, weight_decay=0.01,
              step=torch.full((), 3.0, device=dev),
              grad_scale=torch.full((), 0.5, device=dev))
    hp = fu._lamb1_hparams(dev, noop_flag=0.0, bias_correction=True,
                           grad_averaging=True, **kw)
    m0, v0 = m.clone(), v.clone()
    fu.fused_lamb_phase1_flat(p, g, m, v, u=u, **kw)
    err = _check_update("fused_lamb1", fu._lamb1_kernel_reference,
                        (m, v, u), (p, g, m0, v0), hp, (), n, chunk)
    m0.copy_(m)
    v0.copy_(v)
    fu.fused_lamb_phase1_flat(p, g, m, v, u=u, noop_flag=one, **kw)
    if not (torch.equal(m, m0) and torch.equal(v, v0)
            and not bool(u.any())):
        raise AssertionError("the LAMB noop changed m or v, or left u")
    del m0, v0
    recs["fused_lamb1"] = dict(
        name="fused_lamb_phase1", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:495", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_lamb_phase1_flat(p, g, m, v, u=u, **kw),
                    4),
        plain_ms=_time_ms(lambda: _chunked(
            lambda sl: fu._lamb1_kernel_reference(p[sl], g[sl], m[sl], v[sl],
                                                  hp), n, chunk), 1),
        library_ms=None,
        eager_ms=_eager_ms(lambda: fu.fused_lamb_phase1_flat(
            p, g, m, v, u=u, **kw), 4))
    recs["fused_lamb1"]["bound_ms"], recs["fused_lamb1"]["bound_by"] = \
        _bound(28 * n, 16 * n, FP32_FLOPS_PER_S)
    del m, v, u
    torch.cuda.empty_cache()

    # -- SGD (momentum 0.9, nesterov) over p, g, buf [1.923e9] -------------
    print(f"fused_sgd_flat over flat fp32 p, g, buf [{n}]")
    buf = torch.randn(n, generator=gen, device=dev)
    kw = dict(lr=SGD_KW["lr"], momentum=SGD_KW["momentum"], dampening=0.0,
              weight_decay=0.0, first_run=torch.zeros((), device=dev),
              grad_scale=1.0)
    hp = fu._sgd_hparams(dev, noop_flag=0.0, **kw)
    p0, b0 = p.clone(), buf.clone()
    fu.fused_sgd_flat(p, g, buf, nesterov=True, **kw)
    err = _check_update("fused_sgd", fu._sgd_kernel_reference, (p, buf),
                        (p0, g, b0), hp, (True, False), n, chunk)
    p0.copy_(p)
    b0.copy_(buf)
    fu.fused_sgd_flat(p, g, buf, nesterov=True, noop_flag=one, **kw)
    if not (torch.equal(p, p0) and torch.equal(buf, b0)):
        raise AssertionError("the SGD noop changed p or buf")
    del p0, b0
    recs["fused_sgd"] = dict(
        name="fused_sgd", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:427", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_sgd_flat(p, g, buf, nesterov=True,
                                              **kw), 4),
        plain_ms=_time_ms(lambda: _chunked(
            lambda sl: fu._sgd_kernel_reference(p[sl], g[sl], buf[sl], hp,
                                                True, False), n, chunk), 1),
        library_ms=_time_ms(lambda: torch._fused_sgd_(
            [p], [g], [buf], weight_decay=0.0, momentum=SGD_KW["momentum"],
            lr=SGD_KW["lr"], dampening=0.0, nesterov=True, maximize=False,
            is_first_step=False), 4),
        eager_ms=_eager_ms(lambda: fu.fused_sgd_flat(p, g, buf,
                                                     nesterov=True, **kw), 4))
    recs["fused_sgd"]["bound_ms"], recs["fused_sgd"]["bound_by"] = \
        _bound(20 * n, 7 * n, FP32_FLOPS_PER_S)
    del buf
    torch.cuda.empty_cache()

    # -- Adagrad over p, g, h [1.923e9] ------------------------------------
    print(f"fused_adagrad_flat over flat fp32 p, g, h [{n}]")
    h = torch.rand(n, generator=gen, device=dev)
    kw = dict(lr=ADAGRAD_KW["lr"], eps=1e-10, weight_decay=0.0,
              grad_scale=1.0)
    hp = fu._adagrad_hparams(dev, noop_flag=0.0, **kw)
    p0, h0 = p.clone(), h.clone()
    fu.fused_adagrad_flat(p, g, h, **kw)
    err = _check_update("fused_adagrad", fu._adagrad_kernel_reference,
                        (p, h), (p0, g, h0), hp, (False,), n, chunk)
    p0.copy_(p)
    h0.copy_(h)
    fu.fused_adagrad_flat(p, g, h, noop_flag=one, **kw)
    if not (torch.equal(p, p0) and torch.equal(h, h0)):
        raise AssertionError("the Adagrad noop changed p or h")
    del p0, h0
    steps = torch.zeros((), device=dev)
    recs["fused_adagrad"] = dict(
        name="fused_adagrad", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:375", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_adagrad_flat(p, g, h, **kw), 4),
        plain_ms=_time_ms(lambda: _chunked(
            lambda sl: fu._adagrad_kernel_reference(p[sl], g[sl], h[sl], hp,
                                                    False), n, chunk), 1),
        library_ms=_time_ms(lambda: torch._fused_adagrad_(
            [p], [g], [h], [steps], lr=ADAGRAD_KW["lr"], lr_decay=0.0,
            weight_decay=0.0, eps=1e-10, maximize=False), 4),
        eager_ms=_eager_ms(lambda: fu.fused_adagrad_flat(p, g, h, **kw), 4))
    recs["fused_adagrad"]["bound_ms"], recs["fused_adagrad"]["bound_by"] = \
        _bound(20 * n, 7 * n, FP32_FLOPS_PER_S)
    del p, g, h
    torch.cuda.empty_cache()


def _random_llama(cfg, dev, seed: int, only=None):
    """Llama-3-8B-shaped tree of random bf16 weights from a seeded
    generator: linears N(0, 1/fan_in), norms 1 + N(0, 0.1^2), the
    embedding N(0, 1).  ``only``: the one top-level key to build."""
    from apex_tpu_torch.inference.weights import llama_param_shapes
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tree: dict = {}
    for path, shape in sorted(llama_param_shapes(cfg).items()):
        if only is not None and path[0] != only:
            continue
        if len(shape) == 1:
            t = 1 + 0.1 * torch.randn(shape, generator=gen, device=dev)
        elif path[0] == "embed_tokens":
            t = torch.randn(shape, generator=gen, device=dev)
        else:
            t = torch.randn(shape, generator=gen, device=dev) \
                * shape[1] ** -0.5
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.to(torch.bfloat16)
        del t
    return tree


def _serve(engine, prompts, label: str):
    """``engine.generate`` over the prompts with the launch counters and
    the telemetry registry zeroed just before; returns the outputs, the
    launch counts, the registry and the peak device memory."""
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.ops import _build
    reg = obs.reset_global_registry()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    outs = engine.generate(prompts, max_new_tokens=NEW_TOKENS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    ttft = reg.declared("serve_ttft_seconds")
    dec = reg.declared("serve_decode_token_seconds")
    gen_tokens = sum(len(o) for o in outs)
    decode_tokens = gen_tokens - len(outs)
    decode_s = dec.sum()
    print(f"{label}: {len(prompts)} requests, prompts {list(PROMPT_LENS)}, "
          f"{gen_tokens} tokens in {wall:.3f} s")
    print(f"  TTFT mean {ttft.sum() / ttft.count():.4f} s, p50<= "
          f"{ttft.quantile(0.5)} s, p99<= {ttft.quantile(0.99)} s")
    print(f"  decode: {dec.count()} steps, {decode_tokens} tokens in "
          f"{decode_s:.4f} s = {decode_tokens / decode_s:.1f} tokens/s")
    print(f"  peak device memory {peak / 2**30:.2f} GiB "
          f"(KV pool {engine.cache_hbm_bytes() / 2**30:.2f} GiB)")
    print(f"  kernel launches during the serve: {launches}")
    if any(len(o) != NEW_TOKENS for o in outs):
        raise AssertionError(f"expected {NEW_TOKENS} tokens per request, "
                             f"got {[len(o) for o in outs]}")
    if any(not 0 <= t < engine.cfg.vocab_size for o in outs for t in o):
        raise AssertionError("a generated token is outside the vocab")
    return dict(outs=outs, launches=launches, reg=reg, peak_bytes=peak,
                ttft_mean_s=ttft.sum() / ttft.count(),
                decode_tokens_per_s=decode_tokens / decode_s)


N_CHECK = 8


def _decode_logits(engine, prompt, forced=None):
    """Prefill one prompt into slot 0 and decode ``N_CHECK - 1`` steps:
    the ``[N_CHECK, vocab]`` logits, the engine's greedy token at each
    step, and the tokens fed (``forced`` when given, else its own)."""
    cache = engine.init_cache()
    alloc = engine.new_allocator()
    pages = alloc.acquire(alloc.pages_needed(len(prompt) + N_CHECK))
    cache, tok, last = engine.prefill(cache, prompt, 0, pages=pages)
    dec_logits, toks = [last], [int(tok)]
    fed = [forced[0] if forced else toks[0]]
    active = np.zeros((engine.slots,), bool)
    active[0] = True
    for i in range(1, N_CHECK):
        feed = np.zeros((engine.slots,), np.int32)
        feed[0] = fed[-1]
        cache, nxt, logits, _ = engine.decode(cache, feed, active)
        dec_logits.append(logits[0])
        toks.append(int(nxt[0]))
        fed.append(forced[i] if forced else toks[-1])
    return torch.stack(dec_logits), toks, fed


def _check_logits(label, engine, prompt, outs_row, limit, forced=None):
    """Hold one request's engine decode logits against the port's own
    full-forward prefill of the prompt and the tokens fed; returns the
    decode logits, the distance and the tokens fed."""
    from apex_tpu_torch.inference import models
    got, toks, fed = _decode_logits(engine, prompt, forced)
    seq = torch.tensor([prompt + fed[:-1]], dtype=torch.int32,
                       device=engine.device)
    with torch.no_grad():
        full, _, _ = models.prefill_forward("llama", engine.cfg,
                                            engine.params, seq)
    ref = full[len(prompt) - 1:, 0].float()              # [N_CHECK, v]
    del full
    if not torch.isfinite(got).all() or got.shape != ref.shape:
        raise AssertionError(f"{label}: decode logits not finite or "
                             f"misshaped")
    diff = (got - ref).abs().max().item()
    top2 = ref.topk(2, dim=-1).values
    decided = (top2[:, 0] - top2[:, 1]) > 2 * limit
    agree = ref.argmax(-1).cpu() == torch.tensor(toks)
    print(f"check {label} (prompt {len(prompt)}): max|decode - full| "
          f"{diff:.4f} (limit {limit}), tokens equal at "
          f"{int(agree.sum())}/{N_CHECK} positions, {int(decided.sum())} "
          f"with top-2 margin > {2 * limit}; engine.generate tokens equal: "
          f"{toks == outs_row[:N_CHECK]}")
    if diff > limit:
        raise AssertionError(f"{label}: decode logits off by {diff}")
    if not bool(agree[decided.cpu()].all()):
        raise AssertionError(f"{label}: a token with a clear top-2 margin "
                             f"differs")
    return got, diff, fed


@contextlib.contextmanager
def _plain_fused_block():
    """Route the fused decode layers to the fused block's plain version
    (looked up by the model module at call time)."""
    from apex_tpu_torch.inference import models
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    saved = models.fused_block_decode
    models.fused_block_decode = pa.fused_block_reference
    try:
        yield
    finally:
        models.fused_block_decode = saved


def phase_serve(dev, seed: int, profile: bool = False):
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig

    cfg = LlamaConfig(**FULL_CFG)
    t0 = time.perf_counter()
    params = _random_llama(cfg, dev, seed)
    torch.cuda.synchronize()
    print(f"serve: Llama-3-8B random bf16 weights in "
          f"{time.perf_counter() - t0:.1f} s")
    geometry = dict(slots=8, max_seq=4096, page_size=64, num_pages=512,
                    device=dev)
    engine = InferenceEngine("llama", cfg, params, **geometry)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    served = _serve(engine, prompts, "serve")
    launches = served["launches"]
    missing = [k for k in SERVE_KERNELS
               if k not in FUSED_ONLY and launches[k] <= 0]
    if missing:
        raise AssertionError(f"the serve launched no {missing} kernel")

    # -- the same prompts through a fused engine on the same weights ------
    t0 = time.perf_counter()
    fused = InferenceEngine("llama", cfg, engine.params, decode_fusion="1",
                            **geometry)
    torch.cuda.synchronize()
    layer_bytes = sum(t.numel() * t.element_size()
                      for t in fused._fused_layers[0].values())
    print(f"fused engine: fused layout built in "
          f"{time.perf_counter() - t0:.1f} s, {layer_bytes / 1e6:.1f} MB a "
          f"layer, {cfg.num_layers * layer_bytes / 1e9:.2f} GB in all")
    fserved = _serve(fused, prompts, "fused serve")
    flaunch = fserved["launches"]
    steps = int(fserved["reg"].declared(
        "infer_decode_fused_dispatch_total").total())
    print(f"  fused decode steps {steps}: fused_block_decode launched "
          f"{flaunch['fused_block_decode']} times (want "
          f"{cfg.num_layers} x {steps}), paged_attention "
          f"{flaunch['paged_attention']} times (want 0)")
    if steps <= 0 or flaunch["fused_block_decode"] != cfg.num_layers * steps:
        raise AssertionError("the fused serve did not run one fused block "
                             "per layer per decode step")
    if any(flaunch[k] for k in UNFUSED_ONLY):
        raise AssertionError(f"the fused serve launched the unfused path: "
                             f"{flaunch}")
    missing = [k for k in SERVE_KERNELS
               if k not in UNFUSED_ONLY and flaunch[k] <= 0]
    if missing:
        raise AssertionError(f"the fused serve launched no {missing} kernel")
    launches = dict(launches, **{k: flaunch[k] for k in FUSED_ONLY})

    # -- check: engine prefill + decode against the full forward --------
    # (the fused engine is fed the unfused engine's tokens, so the two
    # decode the same stream and their logits compare position by position)
    worst = worst_fused = 0.0
    for idx in (0, len(prompts) - 1):
        un, d_un, fed = _check_logits(f"request {idx}", engine, prompts[idx],
                                      served["outs"][idx], TOL_LOGITS)
        fu, d_fu, _ = _check_logits(f"request {idx}, fused", fused,
                                    prompts[idx], fserved["outs"][idx],
                                    TOL_LOGITS, forced=fed)
        print(f"  request {idx}: max|fused - unfused decode logits| "
              f"{(fu - un).abs().max().item():.4f} (same tokens fed)")
        worst, worst_fused = max(worst, d_un), max(worst_fused, d_fu)
        del un, fu
    # the same check with the fused block's plain version in place of its
    # kernel: the distance it reads is the algorithm's, not the kernel's
    with _plain_fused_block():
        _, d_plain, _ = _check_logits(
            f"request {len(prompts) - 1}, fused, plain version", fused,
            prompts[-1], fserved["outs"][-1], TOL_LOGITS, forced=fed)
    if profile:
        _profile(engine, prompts, "unfused")
        _profile(fused, prompts, "fused", prefill=False)
    del fused
    torch.cuda.empty_cache()
    return dict(launches=launches, ttft_mean_s=served["ttft_mean_s"],
                decode_tokens_per_s=served["decode_tokens_per_s"],
                peak_bytes=served["peak_bytes"], logit_err=worst,
                fused_logit_err=worst_fused, plain_fused_logit_err=d_plain,
                fused_decode_tokens_per_s=fserved["decode_tokens_per_s"])


def _train_setup(dev, seed: int, layers: int, tx=None,
                 loss_scale="dynamic"):
    """The training model at Llama-3-8B widths and ``layers`` deep, bf16
    parameters drawn from a seeded generator, its train state for ``tx``
    (default: Adam) and one fixed batch of seeded tokens."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.transformer.testing import (LlamaConfig,
                                                    llama_model_provider)
    cfg = LlamaConfig(**dict(FULL_CFG, num_layers=layers,
                             params_dtype=torch.bfloat16))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = llama_model_provider(cfg, device=dev)
    model.reset_parameters(generator=gen)
    tx = functional.fused_adam(lr=TRAIN_LR) if tx is None else tx
    state = train_step.init_train_state(tx, model, loss_scale=loss_scale)
    tokens = torch.randint(0, cfg.vocab_size, (1, TRAIN_SEQ + 1),
                           generator=gen, device=dev)
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "labels": tokens[:, 1:].contiguous()}
    return cfg, model, tx, state, batch, train_step


def _train_loss(model, batch):
    return model(batch["tokens"], batch["labels"])


def _train_run(dev, seed: int, label: str, tx, layers: int, steps: int,
               loss_scale, kernels, transform=None, profile: bool = False):
    """``steps`` steps of the ``layers``-deep model under ``tx`` with the
    launch counters zeroed just before; the segment from the flat grads
    (``transform``, then the unscale, the update and the scale update)
    runs under ``set_sync_debug_mode("error")``.  Returns the launch
    counts, step time, peak memory, losses and the leaf count."""
    from apex_tpu_torch.ops import _build
    t0 = time.perf_counter()
    cfg, model, tx, state, batch, train_step = _train_setup(
        dev, seed, layers, tx, loss_scale)
    torch.cuda.synchronize()
    n = state.opt.master.numel()
    leaves = len(state.opt.sizes)
    print(f"train {label}: Llama-3-8B widths, {layers} layers, {n} "
          f"parameters in {leaves} leaves (bf16 params, fp32 master), "
          f"{type(tx).__name__.strip('_')}, loss scale {loss_scale}, set up "
          f"in {time.perf_counter() - t0:.1f} s")

    def strict(flat_grads):
        # from here (the flat grads of the backward) to the new state:
        # the transform, unscale, update and scale update must not sync
        torch.cuda.set_sync_debug_mode("error")
        return flat_grads if transform is None else transform(flat_grads)

    step = train_step.make_train_step(_train_loss, tx, grad_transform=strict)
    losses, times = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    for _ in range(steps):
        t0 = time.perf_counter()
        try:
            state, loss = step(state, batch)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[1:]))
    tokens = TRAIN_SEQ
    heads = cfg.num_attention_heads
    hd = cfg.hidden_size // heads
    matmul_params = n - cfg.vocab_size * cfg.hidden_size \
        - (2 * layers + 1) * cfg.hidden_size
    # 6 N T for the weight GEMMs (the embedding table and norms do no
    # GEMM), and 3x the causal forward's two attention products
    model_flops = 6 * matmul_params * tokens + 3 * (
        4 * TRAIN_SEQ * TRAIN_SEQ * hd * heads / 2) * layers
    print(f"train {label} on {_smi()}: losses "
          f"{[round(x, 4) for x in losses]}")
    print(f"  step times {[round(t, 4) for t in times]} s; median of steps "
          f"2-{steps} {step_s:.4f} s = {tokens / step_s:.1f} tokens/s")
    print(f"  model flops {model_flops / 1e12:.3f} TFLOP per step = "
          f"{100 * model_flops / step_s / BF16_FLOPS_PER_S:.1f}% of 989 "
          f"TFLOP/s")
    print(f"  peak device memory {peak / 2**30:.2f} GiB")
    print(f"  kernel launches per step: "
          f"{ {k: v / steps for k, v in launches.items() if v} }")
    scale = "none" if state.scaler is None else state.scaler.loss_scale.item()
    print(f"  loss scale {scale}, count {state.opt.count.item()}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"{label}: the loss did not fall: {losses}")
    missing = [k for k in kernels if launches[k] <= 0]
    if missing:
        raise AssertionError(f"{label}: the train steps launched no "
                             f"{missing} kernel")
    if profile:
        def one():
            nonlocal state
            state, _ = train_step.make_train_step(_train_loss, tx)(state,
                                                                   batch)
        _device_breakdown(f"train step ({label}, {layers} layers, "
                          f"{TRAIN_SEQ} tokens)", one, 2, top=16)
    del model, state, step
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=step_s, peak_bytes=peak,
                losses=losses, leaves=leaves)


def phase_train(dev, seed: int, profile: bool = False):
    """The 4-layer model six steps under Adam and under LAMB, then the
    1-layer model three steps under SGD (nesterov, with the grad clipper
    as the grad transform, no loss scale) and under Adagrad; returns each
    run's record by rule."""
    from apex_tpu_torch.contrib import clip_grad_norm_
    from apex_tpu_torch.optimizers import functional
    runs = {"adam": _train_run(
        dev, seed, "adam", functional.fused_adam(lr=TRAIN_LR), TRAIN_LAYERS,
        TRAIN_STEPS, "dynamic", TRAIN_KERNELS, profile=profile)}
    runs["lamb"] = _train_run(
        dev, seed, "lamb", functional.fused_lamb(**LAMB_KW), TRAIN_LAYERS,
        TRAIN_STEPS, "dynamic", RULE_KERNELS["lamb"], profile=profile)
    lamb = runs["lamb"]["launches"]
    want = (1 + 2 * runs["lamb"]["leaves"]) * TRAIN_STEPS
    print(f"  lamb: fused_l2norm launched {lamb['fused_l2norm']} times (want "
          f"(1 + 2 x {runs['lamb']['leaves']} leaves) x {TRAIN_STEPS} = "
          f"{want}), fused_lamb1 {lamb['fused_lamb1']} (want {TRAIN_STEPS})")
    if lamb["fused_l2norm"] != want or lamb["fused_lamb1"] != TRAIN_STEPS:
        raise AssertionError("the LAMB steps did not run one phase-1 and "
                             "1 + 2 per leaf norm launches per step")
    runs["sgd"] = _train_run(
        dev, seed, "sgd", functional.fused_sgd(**SGD_KW), RULE_LAYERS,
        RULE_STEPS, None, RULE_KERNELS["sgd"],
        transform=lambda g: clip_grad_norm_(g, SGD_CLIP)[0])
    runs["adagrad"] = _train_run(
        dev, seed, "adagrad", functional.fused_adagrad(**ADAGRAD_KW),
        RULE_LAYERS, RULE_STEPS, "dynamic", RULE_KERNELS["adagrad"])
    print("train summary (step time, tokens/s, peak device memory):")
    for label, r in runs.items():
        print(f"  {label}: {r['step_s']:.4f} s, "
              f"{TRAIN_SEQ / r['step_s']:.1f} tokens/s, "
              f"{r['peak_bytes'] / 2**30:.2f} GiB")
    return runs


@contextlib.contextmanager
def _plain_kernels():
    """Route the model's kernel calls to their plain versions (for the
    train-check's reference step): the norm and flash dispatchers are
    module functions looked up at call time."""
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    saved = (ln._fwd_2d, ln._bwd_2d, attn._fwd, attn._bwd)

    def fwd_2d(x2, w, b, eps, rms):
        return (ln.rms_norm_reference(x2, w, eps) if rms
                else ln.layer_norm_reference(x2, w, b, eps))

    ln._fwd_2d, ln._bwd_2d = fwd_2d, ln._bwd_reference
    attn._fwd, attn._bwd = attn._fwd_reference, attn._bwd_reference
    try:
        yield
    finally:
        ln._fwd_2d, ln._bwd_2d, attn._fwd, attn._bwd = saved


def phase_train_check(dev, seed: int):
    """One step of the 1-layer model through the kernels against the
    same step through the plain versions: the flat grads leaf by leaf,
    and the loss."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.utils import tree_leaves_with_path
    grads, losses = [], []
    for plain in (False, True):
        _, model, tx, state, batch, train_step = _train_setup(dev, seed, 1)
        leaves = [(".".join(path), t.numel())
                  for path, t in tree_leaves_with_path(model)]
        keep = []
        step = train_step.make_train_step(
            _train_loss, tx, grad_transform=lambda g: keep.append(
                g.clone()) or g)
        _build.reset_launch_counts()
        if plain:
            with _plain_kernels():
                _, loss = step(state, batch)
        else:
            _, loss = step(state, batch)
        counts = _build.launch_counts()
        grads.append(keep[0])
        losses.append(loss.item())
        del model, state, step, keep
        torch.cuda.empty_cache()
        routed = [k for k in ("layer_norm", "layer_norm_bwd",
                              "flash_attention", "flash_attention_bwd")
                  if counts[k]]
        if plain and routed:
            raise AssertionError(f"the plain step launched {routed}: "
                                 f"{counts}")
    rels, off = {}, 0
    for name, size in leaves:
        got, ref = grads[0][off:off + size], grads[1][off:off + size]
        rels[name] = ((got - ref).norm() / ref.norm()).item()
        off += size
    worst = max(rels, key=rels.get)
    rel = ((grads[0] - grads[1]).norm() / grads[1].norm()).item()
    finite = bool(torch.isfinite(grads[0]).all())
    print(f"train-check (1 layer): loss kernels {losses[0]:.6f} plain "
          f"{losses[1]:.6f}; flat grads relative L2 {rel:.3e} in all, "
          f"by leaf:")
    for name, r in rels.items():
        print(f"    {r:.3e}  {name}")
    print(f"  worst leaf {worst} {rels[worst]:.3e} (limit "
          f"{TOL_TRAIN_GRAD_REL_L2}), finite {finite}")
    del grads
    torch.cuda.empty_cache()
    if not finite or not rels[worst] <= TOL_TRAIN_GRAD_REL_L2:
        raise AssertionError(f"flat grads off: relative L2 {rels[worst]} "
                             f"in {worst}")
    if abs(losses[0] - losses[1]) > TOL_TRAIN_LOSS:
        raise AssertionError(f"losses differ: {losses}")
    return dict(grad_rel_l2=rels, losses=losses)


@contextlib.contextmanager
def _plain_updates():
    """Route the optimizer kernels to their plain versions (the wrappers
    look up their kernel functions at call time)."""
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    names = ("_l2norm", "_lamb1", "_sgd", "_adagrad")
    saved = [getattr(fu, f"{nm}_kernel") for nm in names]
    for nm in names:
        setattr(fu, f"{nm}_kernel", getattr(fu, f"{nm}_plain"))
    try:
        yield
    finally:
        for nm, fn in zip(names, saved):
            setattr(fu, f"{nm}_kernel", fn)


def phase_rule_check(dev, seed: int):
    """For LAMB, SGD and Adagrad: one step of the 1-layer model (no loss
    scale) gives warm slots and its flat grads; then ``tx.update`` from
    two clones of that state with those grads, once through the kernels
    and once through their plain versions, master and slots held leaf by
    leaf."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.utils import tree_leaves_with_path
    rules = (("lamb", functional.fused_lamb(**LAMB_KW)),
             ("sgd", functional.fused_sgd(**SGD_KW)),
             ("adagrad", functional.fused_adagrad(**ADAGRAD_KW)))
    worst_all = {}
    for label, tx in rules:
        _, model, tx, state, batch, train_step = _train_setup(
            dev, seed, RULE_LAYERS, tx, None)
        leaves = [(".".join(path), t.numel())
                  for path, t in tree_leaves_with_path(model)]
        state, _ = train_step.make_train_step(_train_loss, tx)(state, batch)
        grads = state.flat.flat_grads.clone()
        opt = state.opt
        del model, state
        clones = [opt.replace(master=opt.master.clone(),
                              slots={k: t.clone()
                                     for k, t in opt.slots.items()})
                  for _ in range(2)]
        del opt
        torch.cuda.empty_cache()
        _build.reset_launch_counts()
        got = tx.update(clones[0], grads)
        counts = _build.launch_counts()
        with _plain_updates():
            ref = tx.update(clones[1], grads)
        if _build.launch_counts() != counts or not any(counts.values()):
            raise AssertionError(f"{label}: the kernel route launched "
                                 f"{counts}, the plain route "
                                 f"{_build.launch_counts()}")
        worst = {}
        for name, a, b in [("master", got.master, ref.master)] + [
                (k, got.slots[k], ref.slots[k]) for k in sorted(got.slots)
                if got.slots[k].dim() == 1]:
            off, rel = 0, {}
            for leaf, size in leaves:
                ga, rb = a[off:off + size], b[off:off + size]
                scale = max(rb.abs().max().item(), 1e-30)
                rel[leaf] = (ga - rb).abs().max().item() / scale
                off += size
            key = max(rel, key=rel.get)
            worst[name] = (key, rel[key])
        for k in got.slots:
            if got.slots[k].dim() == 0 and not torch.equal(got.slots[k],
                                                           ref.slots[k]):
                raise AssertionError(f"{label}: slot {k} differs")
        print(f"rule check {label} (1 layer, one update from a warm state, "
              f"kernels vs plain; launches "
              f"{ {k: v for k, v in counts.items() if v} }): worst leaf "
              f"max|diff| / "
              f"max|ref| by buffer: "
              + ", ".join(f"{nm} {v:.3e} ({leaf})"
                          for nm, (leaf, v) in worst.items())
              + f" (limit {TOL_RULE_CHECK_REL})")
        del got, ref, clones, grads
        torch.cuda.empty_cache()
        bad = {nm: v for nm, v in worst.items()
               if not v[1] <= TOL_RULE_CHECK_REL}
        if bad:
            raise AssertionError(f"{label}: update off its plain route: {bad}")
        worst_all[label] = worst
    return worst_all


def _device_breakdown(label, fn, reps: int, top: int = 10):
    """Run ``fn`` ``reps`` times unprofiled (host clock, synchronised),
    then once more ``reps`` times under ``torch.profiler``; print the
    wall time per call, the device's busy share of it (kernel time over
    wall time) and the kernels that take the most device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # device-side events only: the kernels and copies themselves, not
    # the host ops and the annotated ranges that launched them
    rows = [(e.key, e.self_device_time_total / 1e3 / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and e.self_device_time_total > 0
            and not getattr(e, "is_user_annotation", False)
            and not e.key.startswith("apex_tpu_torch.")]
    busy_ms = sum(r[1] for r in rows)
    print(f"profile {label}: {wall_ms:.3f} ms per call, device busy "
          f"{busy_ms:.3f} ms ({100 * busy_ms / wall_ms:.1f}%)")
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:top]:
        print(f"    {ms:9.4f} ms {n:6.0f}x  {name[:90]}")


def _profile(engine, prompts, label: str, prefill: bool = True):
    """Where the serve's time goes: one 2048-token cold prefill, and a
    decode step with all eight slots live."""
    cache = engine.init_cache()
    alloc = engine.new_allocator()
    last = np.zeros((engine.slots,), np.int32)
    for slot, p in enumerate(prompts[:engine.slots]):
        pages = alloc.acquire(alloc.pages_needed(len(p) + 16))
        cache, tok, _ = engine.prefill(cache, p, slot, pages=pages)
        last[slot] = int(tok)
    if prefill:
        longest = max(prompts, key=len)
        spare = alloc.acquire(alloc.pages_needed(len(longest) + 16))
        _device_breakdown(f"prefill ({len(longest)} tokens)",
                          lambda: engine.prefill(cache, longest, 0,
                                                 pages=spare), 3)
    state = {"cache": cache, "last": last}

    def step():
        c, nxt, _, _ = engine.decode(state["cache"], state["last"])
        state["cache"], state["last"] = c, nxt.numpy()

    step()
    _device_breakdown(f"decode step (8 slots, {label})", step, 5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases",
                    default="kernels,serve,profile,train,train-check",
                    help="comma list of kernels, serve, profile, train, "
                         "train-check (build always runs; profile "
                         "profiles the serve and the train phases that "
                         "run)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    from apex_tpu_torch import resolve_device
    dev = resolve_device(None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(_smi())                    # the card's name and power limit
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}")
    phases = set(args.phases.split(","))
    phase_build()
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    recs = phase_kernels(dev, gen) if "kernels" in phases else {}
    if "serve" in phases:
        served = phase_serve(dev, args.seed, "profile" in phases)
        for key, r in recs.items():
            if key in SERVE_KERNELS:
                r["launches"] = served["launches"][key]
        del served
        torch.cuda.empty_cache()
    if "train" in phases:
        runs = phase_train(dev, args.seed, "profile" in phases)
        for key, r in recs.items():
            if key not in SERVE_KERNELS:
                r["launches"] = runs[KERNEL_RUN.get(key, "adam")][
                    "launches"][key]
    if "train-check" in phases:
        phase_train_check(dev, args.seed)
        phase_rule_check(dev, args.seed)
    order = ("name", "route", "source", "replaces", "launches",
             "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")
    print(json.dumps({"kernels": [{k: r.get(k) for k in order}
                                  for r in recs.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
