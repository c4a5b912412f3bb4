#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

    python3 chip_smoke.py --phases kernels,train   # the training slice

1. **Build.**  Prints the card's name and power limit, compiles the
   port's CUDA kernels from ``apex_tpu_torch/csrc`` (``nvcc``, sm_90a)
   and prints the build time, each source's ``ptxas`` resource summary
   and, for the flash sources, each template instance's registers and
   spill bytes (and any note of ptxas serialising ``wgmma`` products).
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
   the update kernels' noop bit identity; the split flash backward's dq
   and dk/dv kernels at causal ``[1, 32, 8192, 128]``, held against
   their plain halves 4 heads at a time, bit for bit from run to run,
   and timed beside the one-pass kernel forced onto the same shape and
   SDPA's backward; the ``multi_tensor_apply`` shim's axpby and fused
   scale-and-norm kernels over the same flat length, fp32 and bf16,
   with the norm's bit identity and an inf raising each flag; the flash
   forward again at causal ``[1, 32, 8192, 128]`` and ``[1, 32, 128,
   128]``, held against its plain version a few heads at a time and
   timed beside SDPA; the flash forward's masked instance (with its
   tile pre-pass) at the dense decode shape ``[8, 32, 1, 8192]`` with a
   per-batch length mask over k/v broadcast to the query heads, at
   BERT-large's padding ``[8, 16, 512, 64]`` and with a per-head mask
   under causal ``[1, 32, 2048, 128]``, each timed beside SDPA with
   the boolean ``attn_mask``; ``decode_attention``'s kernel branch at
   the same decode shape over 8 kv heads, reading one layer of a
   strided dense cache in place, its peak memory rise over the call
   (under 64 MB: no broadcast), timed beside SDPA with ``enable_gqa``
   on the same cache and bounded by the cache's live bytes (the
   ``flash_attention_masked`` record); the fused block's GPT instance, one
   random GPT-3 1.3B layer over 8 slots of lengths 0..2048, page 64,
   with its phase clock).  Prints
   the max
   |diff| against its stated limit, the kernel's time, its bound (the
   larger of bytes over 3.35 TB/s and operations over the peak rate of
   their type — 989 TFLOP/s bf16 on the tensor cores, 67 TFLOP/s fp32
   — counted from this run's inputs), the plain version's time and,
   where one PyTorch call computes the same function, that call's
   time.  The fused block is timed over 40 calls queued behind a
   sleeping card between CUDA events (its cooperative launch is not
   captured into a graph, and its host cost can exceed its device
   time), with the eager time, host included, beside it; on a line of
   its own, the port's unfused layer on the same inputs.
3. **Serve.**  Llama-3-8B at full width and depth (random bf16 weights
   from a seeded ``torch.Generator``) served by ``InferenceEngine`` on
   the paged pool through ``engine.generate``: 8 seeded prompts of
   128..2048 tokens, 32 new tokens each, greedy.  The kernels' launch
   counters are zeroed just before and read just after; each must be
   above 0.  Prints TTFT, decode tokens/s and peak device memory.  Then
   the same prompts through a second engine on the same weights with
   ``decode_fusion="1"``: every decode layer must be one fused-block
   launch (32 per decode step) and paged attention must not launch.
   Then the same prompts on the dense slot cache at ``max_seq`` 8192
   (no paged kwarg): past ``decode_attention``'s 4096 crossover every
   decode layer must launch its decode kernel (counted as
   ``flash_attention_masked``) once (32 per step), and neither paged
   kernel.
4. **Check.**  For two of the requests, the decode logits of an
   engine prefill + decode run are held against the port's own
   full-forward prefill of prompt + generated tokens, for all three
   engines
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
   the loss must fall and stay finite.  Then three steps of the same
   model and rule on 8192 seeded tokens (Llama-3-8B's context), whose
   backward takes the split flash pair: each split kernel must launch
   once per layer and step, the one-pass kernel never (and every
   2048-token run the reverse).  Then the same six steps under
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
   and slots within a relative limit.  Then one 8192-token step of the
   1-layer model through the split backward against the same step with
   the gate raised so the one-pass kernel takes it (both on the card):
   the loss and every leaf's flat grads within a relative L2 limit.
8. **A/B** (``--phases ab --baseline DIR``, not in the default run).
   Another version's kernels (``DIR/apex_tpu_torch/csrc``) built into a
   library of their own beside this tree's and swapped in turn, A B B A
   in one process, with that version's paged-decode and norm-backward
   wrappers while its library is in: the flash rows (#3 at 128, 2048
   and 8192, #4 at 2048, #5 and #6 at 8192), paged decode #7 at the
   kernels phase's lengths and at the serve's, the norm backward #2 at
   ``[2048, 4096]`` and ``[8192, 4096]`` (RMSNorm and LayerNorm), the
   unfused 8-slot decode step and the 4-layer Adam steps at 2048 and
   8192 tokens, the masked forward #3m at its three shapes and
   ``decode_attention``'s whole kernel branch at ``[8, 32, 1, 8192]``
   (with each version's peak memory rise; the version's own masked and
   decode wrappers), the fused blocks #8 and #8g for one layer each
   with their phase clocks, and the fused GPT-3 1.3B and dense
   Llama-3-8B (8192 positions) decode steps
   (``--ab-rows`` picks among flash, paged, norm, steps, masked and
   fused).
9. **Shim.**  One backward of the 1-layer model, then
   ``multi_tensor_applier`` with each of its four ops over the model's
   real grad list (11 leaves, bf16 and fp32), one kernel launch a call,
   against the same calls through the plain versions; ``noop_flag`` 1
   and an inf in one grad must raise every flag.

10. **Optim** (after train).  Apex's optimizer classes
   (:mod:`apex_tpu_torch.optimizers`) at Llama-3-8B widths, every
   update kernel held to launch and no plain update version allowed to
   run: ``FusedAdam(model.parameters(), lr=1e-4)`` must be the
   ``FusedAdamTorch`` twin, six rounds of ``loss.backward();
   opt.step(); opt.zero_grad()`` on the 4-layer model and the 2048-token
   batch (the loss falls; one ``fused_adam`` launch a step; each step
   under ``set_sync_debug_mode("error")``), its step time and peak
   memory beside ``make_train_step``'s with no loss scale, and the
   time of the twin's grad-buffer copy pass; one twin step against one
   functional step from one warm state (1 layer: two optimizer states
   side by side), fed the same grads, every leaf's master and moments
   within 1e-6; the LAMB twin (decay and no-decay groups), SGD and
   Adagrad twins at 1 layer with their launches a step; ``FusedLAMB``
   over the 1-layer model's tree, three ``step(grads)`` calls against
   the functional update; and the handoff: the 4-layer model trained
   three ``make_train_step`` steps, served through
   ``InferenceEngine.from_train_state`` (8 prompts, 32 greedy tokens,
   page 64) with two requests' decode logits held against the full
   forward, and an engine from ``from_state_dict`` giving the same
   weights and tokens.  Its launches are added to the ``kernels``
   line's counts.

11. **GPT** (after serve).  GPT-3 1.3B at full width and depth (hidden
   2048, 24 layers, 16 heads, vocab 51200; random bf16 weights from a
   seed) served by ``InferenceEngine("gpt", ...)`` three ways: the
   paged pool (24 ``paged_attention`` launches a decode step), the
   paged pool with ``decode_fusion="1"`` (24 ``fused_block_decode_gpt``)
   and the dense cache (neither); 8 prompts of 128..1536 tokens, 32
   greedy tokens each: TTFT, decode tokens/s, peak memory, and two
   requests' decode logits against ``GPTModel``'s full forward.
12. **BERT** (after GPT).  BERT-large ``encode`` on ``[8, 512]`` (24
   flash launches) and ``BertModel`` with a padding mask over the same
   weights (24 masked launches), each held against the same forward
   through the plain versions.

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
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

HBM_BYTES_PER_S = 3.35e12        # H100 SXM HBM3 (NVIDIA data sheet)
#: the card's sleep before queued calls (``_queued_ms``): about 0.1 s at
#: the H100's clocks, longer than the host takes to queue 40 fused blocks
QUEUE_SLEEP_CYCLES = 200_000_000
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
#: paged decode and the masked flash forward: x each slot's (each query
#: row's) own max|ref| (a long slot's outputs average thousands of tokens
#: and read ~0.05, so a dropped page or tile of it moves them by more
#: than this and less than any one absolute limit)
TOL_PAGED_OUT = 2.0 ** -6
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
#: sides, dq summed in any order) are held against the exact float64
#: gradient at both lengths, causal [1, 32, 2048, 128] (the one-pass
#: kernel) and [1, 32, 8192, 128] (the split pair), and each output as a
#: whole within a relative L2 difference of the plain version.  The
#: element rule |got - ref| <= RTOL |ref| + ATOL (two bf16 ulps of the
#: element, and an absolute floor) is printed beside, not gated: its
#: floor (2^-9) is smaller than one bf16 rounding step of a p in [0.5, 1)
#: times |dO| ~ 1, and the kernels and the plain version, whose fp32
#: scores differ in their last bits, round a few such p to different
#: sides (at 8192 both the split and the one-pass kernel read 1.157 on
#: dv).  Each output's error against the exact gradient must stay within
#: 5% (relative L2) and 25% (max |err|) of the plain version's own
#: error; both round the same values, so the ratios sit near 1, and an
#: independent error of 7e-4 relative L2 moves the first past its limit.
TOL_FLASH_BWD_RTOL = 2.0 ** -6
TOL_FLASH_BWD_ATOL = 2.0 ** -9
TOL_FLASH_BWD_REL_L2 = 1e-2
TOL_FLASH_EXACT_L2 = 1.05
TOL_FLASH_EXACT_MAX = 1.25
#: the shim's two kernels against their plain versions: axpby rounds
#: each product before the sum, as the plain version's separate
#: multiplies do, and the fused scale writes one fp32 multiply, so both
#: outputs are exact; the fused norm is an fp32 sum in another order
#: (as TOL_L2NORM_REL)
TOL_AXPBY = 0.0
TOL_L2NORM_SCALE_OUT = 0.0
#: train-check of the split backward: one 8192-token step through the
#: split pair against the same step through the one-pass kernel.  The
#: forward is the same (the loss bit for bit), dk and dv are the same
#: products; dq differs by the order of its fp32 adds before its
#: bf16 rounding (an ulp of some elements), which the rest of the
#: backward carries into every leaf: each leaf within 1e-2 relative L2
TOL_SPLIT_GRAD_REL_L2 = 1e-2
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
#: the split flash backward, which the 8192-token run must launch once
#: each per layer and step in place of the one-pass kernel
SPLIT_KERNELS = ("flash_attention_bwd_dq", "flash_attention_bwd_dkv")
SPLIT_TRAIN_KERNELS = tuple(k for k in TRAIN_KERNELS
                            if k != "flash_attention_bwd") + SPLIT_KERNELS
#: the kernels only the multi_tensor_apply shim reaches
SHIM_KERNELS = ("fused_axpby", "fused_l2norm_scale")
#: the kernels only the serving paths of the dense cache and GPT reach:
#: the masked flash forward (the dense LLaMA serve) and the GPT block
SERVE_ONLY = ("flash_attention_masked", "fused_block_decode_gpt")
#: the optimizer runs of the train phase: the kernels each must launch,
#: and the run whose launches each kernel reports (the rest: "adam")
RULE_KERNELS = {"lamb": ("fused_l2norm", "fused_lamb1"),
                "sgd": ("fused_l2norm", "fused_sgd"),
                "adagrad": ("fused_adagrad",)}
KERNEL_RUN = {"fused_l2norm": "lamb", "fused_lamb1": "lamb",
              "fused_sgd": "sgd", "fused_adagrad": "adagrad",
              "flash_attention_bwd_dq": "adam8k",
              "flash_attention_bwd_dkv": "adam8k"}
#: the optim phase (Apex's optimizer classes): the 1-layer twins and
#: the tree-class LAMB take three steps each; the handoff trains three
#: steps before serving; a twin step and a tree step are held to the
#: functional update within 1e-6 of each leaf's magnitude (the same
#: kernel on the same values: bit for bit is expected)
OPTIM_RULE_STEPS = 3
OPTIM_TREE_STEPS = 3
HANDOFF_STEPS = 3
TOL_TWIN_REL = 1e-6
HANDOFF_SERVE_KERNELS = ("layer_norm", "flash_attention", "paged_attention")
#: the 4-layer training model (Llama-3-8B widths) and its batch
TRAIN_LAYERS = 4
TRAIN_SEQ = 2048
TRAIN_STEPS = 6
#: the 8192-token run (Llama-3-8B's published context): the same model
#: and Adam, three steps; sq * d * 4 = 4 MiB passes the one-pass gate
#: (2 MiB), so the split backward takes every layer
SPLIT_SEQ = 8192
SPLIT_STEPS = 3
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
#: two (and dq's adds in any order), so a relative L2 of a few 1e-3 in
#: every leaf (the worst leaf is held to the limit); the loss (~12 nats)
#: within 2e-2
TOL_TRAIN_GRAD_REL_L2 = 3e-2
TOL_TRAIN_LOSS = 2e-2
#: GPT-3 1.3B (the repo's GPT flagship: hidden 2048, 24 layers, 16 heads
#: of 128, ffn 8192, context 2048, vocab 51200), its eight prompts, and
#: the BERT-large encode batch; the dense LLaMA serve's window
GPT_CFG = dict(vocab_size=51200, hidden_size=2048, num_layers=24,
               num_attention_heads=16, max_seq_length=2048,
               hidden_dropout=0.0, attention_dropout=0.0)
GPT_PROMPT_LENS = (128, 256, 384, 512, 768, 1024, 1280, 1536)
BERT_BATCH, BERT_SEQ = 8, 512
DENSE_MAX_SEQ = 8192
#: decode-vs-full-forward logit limit for the serve check: bf16
#: activations rounded at every op of 32 layers, along two different
#: kernel/matmul paths (paged decode vs causal flash prefill); the
#: fused engine is held to the same limit
TOL_LOGITS = 0.25
#: BERT encode, kernels against plain versions on the same bf16 weights:
#: beside TOL_LOGITS, each sequence's logits within this relative L2 of
#: the plain route's.  The run prints the plain route's own distance
#: from an fp32 control (bf16 alone) and forwards with one wrong layer:
#: a wrong first layer must land past the limit; a wrong deeper one
#: moves the logits less than bf16 rounding (with random weights every
#: position carries nearly the same vector past the first layer, so
#: attention there averages equal rows whatever its mask)
TOL_BERT_REL_L2 = 3e-2


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


def _queued_ms(fn, iters: int) -> float:
    """Mean device time of one call of ``fn`` when the host is slower
    than the card: the card sleeps (``torch.cuda._sleep``, about 0.1 s)
    while the host queues ``iters`` calls behind it, so the calls run
    back to back between two CUDA events.  For the fused block, whose
    cooperative launch is not captured into a graph and whose host
    cost a call can exceed its device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
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


def _slot_rel(got, ref) -> float:
    """Paged decode against its plain version: the largest over slots of
    the slot's max |diff| over its own max |ref| (0 where both are 0, inf
    where only the reference is)."""
    diff = (got.float() - ref.float()).abs().flatten(1).amax(1)
    mag = ref.float().abs().flatten(1).amax(1)
    return torch.where(diff == 0, torch.zeros_like(diff),
                       diff / mag).max().item()


def _elementwise(got, ref, rtol: float, atol: float):
    """The worst ratio of ``|got - ref|`` to ``rtol |ref| + atol`` over
    the elements (at most 1 passes), and the relative L2 difference."""
    g, r = got.float(), ref.float()
    ratio = ((g - r).abs() / (rtol * r.abs() + atol)).max().item()
    return ratio, ((g - r).norm() / r.norm()).item()


def _exact_bwd(q3, k3, v3, do3, scale):
    """The causal backward in float64 from the bf16 operands, with p and
    ds unrounded: the exact gradient that the kernels and their plain
    versions both approximate."""
    q_, k_, v_, do_ = (t.double() for t in (q3, k3, v3, do3))
    s_ = torch.matmul(q_, k_.transpose(1, 2)) * scale
    sq, sk = s_.shape[1:]
    live = torch.ones(sq, sk, dtype=torch.bool, device=q3.device).tril(sk - sq)
    p = torch.softmax(s_.masked_fill_(~live, float("-inf")), dim=-1)
    del s_
    delta = (do_ * torch.matmul(p, v_)).sum(-1, keepdim=True)
    ds = p * (torch.matmul(do_, v_.transpose(1, 2)) - delta)
    return (scale * torch.matmul(ds, k_),
            scale * torch.matmul(ds.transpose(1, 2), q_),
            torch.matmul(p.transpose(1, 2), do_))


def _exact_errors(got, exact):
    """Per output: (relative L2, max |err|) of ``got`` against ``exact``."""
    out = []
    for g_, x_ in zip(got, exact):
        e = g_.double() - x_
        out.append(((e.norm() / x_.norm()).item(), e.abs().max().item()))
    return out


def _check_flash_bwd_exact(label, got, ref, exact) -> float:
    """The flash backward gate (2048 and 8192 tokens): each output's
    error against the exact float64 gradient within TOL_FLASH_EXACT_* of
    the plain version's own error, and within TOL_FLASH_BWD_REL_L2 of the
    plain version; the element rule's reading is printed beside.
    Returns the largest max |diff| against the plain version."""
    err, failed = 0.0, []
    for nm, g_, r_, (gl2, gmax), (rl2, rmax) in zip(
            ("dq", "dk", "dv"), got, ref, _exact_errors(got, exact),
            _exact_errors(ref, exact)):
        ratio, rel = _elementwise(g_, r_, TOL_FLASH_BWD_RTOL,
                                  TOL_FLASH_BWD_ATOL)
        e = (g_.float() - r_.float()).abs().max().item()
        ok = gl2 <= TOL_FLASH_EXACT_L2 * rl2 \
            and gmax <= TOL_FLASH_EXACT_MAX * rmax \
            and rel <= TOL_FLASH_BWD_REL_L2
        print(f"  {label} {nm}: against the exact gradient relative L2 "
              f"{gl2:.5g} (plain {rl2:.5g}, limit x{TOL_FLASH_EXACT_L2}), "
              f"max|err| {gmax:.5g} (plain {rmax:.5g}, limit "
              f"x{TOL_FLASH_EXACT_MAX}); against the plain version max|diff| "
              f"{e:.6g}, relative L2 {rel:.4g} (limit {TOL_FLASH_BWD_REL_L2}), "
              f"worst |diff| / (2^-6 |ref| + 2^-9) {ratio:.4g} "
              f"{'ok' if ok else 'FAIL'}")
        failed += [] if ok else [nm]
        err = max(err, e)
    if failed:
        raise AssertionError(f"{label} {failed}: less accurate than the plain "
                             f"version")
    return err


def _hold_wrong_backwards(plain, ref, exact, s: int) -> None:
    """What the flash backward gate reads for two plainly wrong
    backwards: ``plain(**kw)``, the plain version with its causal
    boundary one 64-key tile late and with the keys of the second half
    dropped.  Each must fail the gate."""
    plain_err = _exact_errors(ref, exact)
    for label, wrong in (("causal boundary +64", dict(causal_off=64)),
                         (f"keys >= {s // 2} dropped",
                          dict(valid=(s, s // 2)))):
        bad = plain(**wrong)
        readings = [_elementwise(g_, r_, TOL_FLASH_BWD_RTOL,
                                 TOL_FLASH_BWD_ATOL)
                    for g_, r_ in zip(bad, ref)]
        bad_err = _exact_errors(bad, exact)
        print(f"  wrong backward ({label}): relative L2 against the exact "
              f"gradient over the plain version's, of dq, dk, dv "
              f"{[round(b2[0] / p2[0], 4) for b2, p2 in zip(bad_err, plain_err)]}; "
              f"(worst element ratio, relative L2) against the plain version "
              f"{[(round(a, 4), round(r, 4)) for a, r in readings]}")
        if all(b2[0] <= TOL_FLASH_EXACT_L2 * p2[0]
               and b2[1] <= TOL_FLASH_EXACT_MAX * p2[1]
               and r <= TOL_FLASH_BWD_REL_L2
               for b2, p2, (_, r) in zip(bad_err, plain_err, readings)):
            raise AssertionError(f"the flash backward gate passes a wrong "
                                 f"backward ({label})")
        del bad


def phase_build():
    from apex_tpu_torch.ops import _build
    t0 = time.perf_counter()
    so = _build.build()
    _build.library()
    print(f"build: {so.name} in {time.perf_counter() - t0:.1f} s")
    # ptxas's resource lines, one summary a source (each template
    # instance is a function of its own)
    for src in _build.SOURCES:
        log = _build.BUILD_DIR / f"{src}.log"
        if log.exists():
            text = log.read_text()
            regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
            spills = sum(int(b) for b in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", text))
            if regs:
                print(f"  {src}: {len(regs)} functions, {min(regs)}-"
                      f"{max(regs)} registers, {spills} bytes of spills")
            if src.startswith("flash_attention"):
                for name, n_regs, n_spill in _ptxas_instances(text):
                    print(f"    {name}: {n_regs} registers, {n_spill} "
                          f"bytes of spills")
                # ptxas's note where it had to serialise wgmma products
                for line in sorted(set(re.findall(
                        r".*Performance Loss.*", text))):
                    print(f"    ptxas: {line.strip()[:200]}")


def _ptxas_instances(text: str):
    """``(instance, registers, spill bytes)`` for each kernel entry in an
    ``nvcc -Xptxas -v`` log, the instance named by its kernel and its
    template arguments read from the mangled name (``Li128E`` 128,
    ``Lb0E`` false)."""
    out = []
    for part in text.split("Compiling entry function '")[1:]:
        mangled = part.split("'", 1)[0]
        m = re.search(r"\d([a-z][a-z_]*_kernel)I((?:L[ib]\d+E)+)E", mangled)
        if m:
            args = [{"b0": "false", "b1": "true"}.get(a, a[1:])
                    for a in re.findall(r"L([ib]\d+)E", m.group(2))]
            name = f"{m.group(1)}<{', '.join(args)}>"
        else:
            plain = re.search(r"\d([a-z][a-z_]*_kernel)", mangled)
            name = plain.group(1) if plain else mangled
        regs = re.search(r"Used (\d+) registers", part)
        spill = sum(int(b) for b in re.findall(
            r"(\d+) bytes spill (?:stores|loads)", part))
        out.append((name, int(regs.group(1)) if regs else -1, spill))
    return out


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
    plan = pa._plan_splits(slots, kvh, h // kvh, d, ps, mpps,
                           pa._sm_count(qd.device))
    print("paged_decode_attention 8 slots, lengths "
          f"{lengths_l}, page 64, pool [513, 32, 8, 64, 128] bf16 (splits "
          f"of {plan.pages_per_split} pages, {plan.nsplit} a window)")
    _check("paged out (x each slot's max|ref|)", _slot_rel(got, ref),
           TOL_PAGED_OUT)
    if got[0].abs().max().item() != 0.0:
        raise AssertionError("a length-0 slot must emit zeros")
    if not torch.equal(got, pa.paged_decode_attention(qd, kp, vp, table,
                                                      lengths)):
        raise AssertionError("paged decode did not repeat bit for bit")
    # a window of one split (8 pages): the kernel writes its output
    # without the merge pass
    short_len = torch.clamp(lengths, max=8 * ps)
    got = pa.paged_decode_attention(qd, kp, vp, table[:, :8].contiguous(),
                                    short_len)
    ref = pa.paged_decode_reference(qd, kp, vp, table[:, :8], short_len,
                                    scale)
    _check("paged out, one split (x each slot's max|ref|)",
           _slot_rel(got, ref), TOL_PAGED_OUT)
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
    # and for each of the last slices' kernel pairs and rows
    for off, check in ((3, _split_kernels), (4, _shim_kernels),
                       (5, _flash_fwd_rows), (6, _masked_rows),
                       (7, _fused_gpt_kernel)):
        sgen = torch.Generator(device=dev)
        sgen.manual_seed(gen.initial_seed() + off)
        check(dev, sgen, recs)
    for r in recs.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (eager call, host "
              f"included, {r.pop('eager_ms'):.4f} ms), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}")
    torch.cuda.empty_cache()
    return recs


def _flash_fwd_rows(dev, gen, recs):
    """The flash forward (#3) at causal [1, 32, 8192, 128] (the 8192-token
    training run's shape) and [1, 32, 128, 128] (the shortest serving
    bucket), k/v from 8 kv heads: out and lse against the plain version
    (4 heads at a time at 8192, whose [h, s, s] fp32 scores are 256 MiB a
    head), then the kernel's time beside SDPA's and the bound.  The
    kernel's record stays the 2048-token prefill's."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    bf = torch.bfloat16
    b_, h, kvh, d = 1, 32, 8, 128
    scale = d ** -0.5
    for s in (SPLIT_SEQ, 128):
        q = torch.randn(b_, h, s, d, generator=gen, device=dev).to(bf)
        kk = torch.randn(b_, kvh, s, d, generator=gen, device=dev).to(bf)
        vv = torch.randn(b_, kvh, s, d, generator=gen, device=dev).to(bf)
        k, v = (t[:, :, None].expand(b_, kvh, h // kvh, s, d)
                .reshape(b_, h, s, d) for t in (kk, vv))
        q3, k3, v3 = (t.reshape(b_ * h, s, d).contiguous()
                      for t in (q, k, v))
        out, lse = attn._fwd(q3, k3, v3, True, scale)
        ref_out, ref_lse = _by_heads(lambda sl: attn._fwd_reference(
            q3[sl], k3[sl], v3[sl], True, scale), b_ * h, 4)
        print(f"flash_attention causal [{b_}, {h}, {s}, {d}] bf16")
        _check("flash out", (out.float() - ref_out.float()).abs().max()
               .item(), TOL_ATTN_OUT)
        _check("flash lse (base 2)", (lse - ref_lse).abs().max().item(),
               TOL_ATTN_LSE)
        del ref_out, ref_lse
        bound, by = _bound(4 * q.numel() * 2 + b_ * h * s * 4,
                           4 * s * s * d * h / 2)
        iters = 10 if s == SPLIT_SEQ else 48
        ms = _time_ms(lambda: attn._fwd(q3, k3, v3, True, scale), iters)
        lib = _time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), iters)
        print(f"  flash_attention causal [{b_}, {h}, {s}, {d}] on {_smi()}: "
              f"kernel {ms:.4f} ms, SDPA {lib:.4f} ms, bound {bound:.4f} "
              f"ms ({by}), {100 * bound / ms:.1f}% of the bound")
        del q, kk, vv, k, v, q3, k3, v3, out, lse
        torch.cuda.empty_cache()


def _masked_case(attn, label, q, k, v, mask, causal, iters):
    """One masked flash-forward shape: the public entry (one
    ``flash_attention_masked`` launch, no unmasked one) and ``_fwd`` on
    its mask3 against the plain version, fully masked rows 0; the
    kernel's time, the plain version's and SDPA's with the boolean
    ``attn_mask`` (True = keep, so the mask inverted, and the causal
    triangle folded in: timed only, its fully masked rows are NaN).
    Returns ``(max |err|, ms, plain_ms, library_ms)``."""
    from apex_tpu_torch.ops import _build
    b, h, sq, d = q.shape
    sk = k.shape[2]
    scale = d ** -0.5
    counts = _build.launch_counts()
    out = attn.flash_attention(q, k, v, causal=causal, mask=mask)
    after = _build.launch_counts()
    if after["flash_attention_masked"] != counts["flash_attention_masked"] \
            + 1 or after["flash_attention"] != counts["flash_attention"]:
        raise AssertionError(f"{label}: the masked entry did not take the "
                             f"masked kernel alone")
    mask3 = attn._mask3(mask, b, h, sq, sk)
    q3, k3, v3 = (t.reshape(b * h, -1, d).contiguous() for t in (q, k, v))
    got, lse = attn._fwd(q3, k3, v3, causal, scale, mask3=mask3)
    ref, ref_lse = attn._fwd_reference(q3, k3, v3, causal, scale,
                                       mask3=mask3)
    out = out.reshape(b * h, sq, d)
    err = max((got.float() - ref.float()).abs().max().item(),
              (out.float() - ref.float()).abs().max().item())
    rows = (lambda t: t.reshape(-1, d))
    row_rel = max(_slot_rel(rows(got), rows(ref)),
                  _slot_rel(rows(out), rows(ref)))
    dead = ref_lse <= -0.5e30
    print(f"flash_attention masked {label} [{b}, {h}, {sq}, {sk}] bf16, "
          f"mask {tuple(mask.shape)}, {int(dead.sum())} fully masked rows")
    _check("masked flash out", err, TOL_ATTN_OUT)
    _check("masked flash out (x each row's max|ref|)", row_rel,
           TOL_PAGED_OUT)
    _check("masked flash lse (base 2)", (lse - ref_lse).abs().max().item(),
           TOL_ATTN_LSE)
    if not bool((got[dead] == 0).all()):
        raise AssertionError(f"{label}: a fully masked row is not 0")
    del ref, ref_lse, out
    ms = _time_ms(lambda: attn._fwd(q3, k3, v3, causal, scale, mask3=mask3),
                  iters)
    plain_ms = _time_ms(lambda: attn._fwd_reference(
        q3, k3, v3, causal, scale, mask3=mask3), 3)
    keep = ~mask
    if causal:
        keep = keep & torch.ones(sq, sk, dtype=torch.bool,
                                 device=q.device).tril(sk - sq)
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=keep), iters)
    return err, ms, plain_ms, lib_ms


DECODE_LENGTHS = [0, 1, 100, 1000, 4097, 6000, 8000, 8192]


def _masked_shapes(dev, gen):
    """The masked flash forward's (#3m) three shapes, one at a time:
    ``(label, q, k, v, mask, causal, iters, bound_bytes, flops)``.
    Dense-cache decode as the JAX package's kernel branch gives it (sq =
    1 against 8192 cached positions, 8 slots, k/v broadcast from 8 kv
    heads to 32, a per-batch length mask with a length-0 slot),
    BERT-large's padding mask (``[8, 16, 512, 64]``, non causal,
    per-batch key padding) and a per-head mask under causal at ``[1, 32,
    2048, 128]``.  Bytes: q and out, the live keys' k/v, the mask, lse
    (the decode shape's mask is key-only: one byte a key)."""
    bf = torch.bfloat16
    b, h, kvh, s, d = 8, 32, 8, 8192, 128
    q = torch.randn(b, h, 1, d, generator=gen, device=dev).to(bf)
    kk = torch.randn(b, kvh, s, d, generator=gen, device=dev).to(bf)
    vv = torch.randn(b, kvh, s, d, generator=gen, device=dev).to(bf)
    k, v = (t[:, :, None].expand(b, kvh, h // kvh, s, d).reshape(b, h, s, d)
            for t in (kk, vv))
    del kk, vv
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    mask = (torch.arange(s, device=dev)[None, None, None, :]
            >= lengths[:, None, None, None])
    live = sum(DECODE_LENGTHS)
    yield ("decode", q, k, v, mask, False, 20,
           2 * live * h * d * 2 + 2 * q.numel() * 2 + b * s + b * h * 4,
           4 * live * h * d)
    del q, k, v, mask
    torch.cuda.empty_cache()
    b, h, s, d = 8, 16, 512, 64
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).to(bf)
               for _ in range(3))
    keep = torch.tensor([512, 500, 384, 256, 128, 64, 1, 0], device=dev)
    mask = (torch.arange(s, device=dev)[None, None, None, :]
            >= keep[:, None, None, None]).expand(b, 1, s, s)
    live = int(keep.sum())
    yield ("BERT padding", q, k, v, mask, False, 48,
           2 * q.numel() * 2 + 2 * live * h * d * 2 + b * s * s
           + b * h * s * 4, 4 * live * s * h * d)
    del q, k, v, mask
    b, h, s, d = 1, 32, 2048, 128
    q, k, v = (torch.randn(b, h, s, d, generator=gen, device=dev).to(bf)
               for _ in range(3))
    mask = torch.rand(b, h, s, s, generator=gen, device=dev) < 0.1
    mask[:, :, 5] = True                        # a fully masked row a head
    yield ("per-head causal", q, k, v, mask, True, 10,
           4 * q.numel() * 2 + mask.numel() + b * h * s * 4,
           4 * s * s * d * h / 2)
    del q, k, v, mask
    torch.cuda.empty_cache()


def _decode_case(dev, gen):
    """Llama-3-8B's dense decode at 8192 positions: q ``[8, 32, 1, 128]``
    against one layer's view of an 8-slot, 2-layer ``[slots, layers, 8,
    8192, 128]`` cache (strided, read in place), lengths
    :data:`DECODE_LENGTHS`.  Returns ``(q, k, v, lengths, bound_bytes,
    flops)``: the bytes the function needs are the live keys' k and v
    in the cache, q, out and the lengths."""
    bf = torch.bfloat16
    b, h, kvh, s, d = 8, 32, 8, 8192, 128
    q = torch.randn(b, h, 1, d, generator=gen, device=dev).to(bf)
    ck = torch.randn(b, 2, kvh, s, d, generator=gen, device=dev).to(bf)
    cv = torch.randn(b, 2, kvh, s, d, generator=gen, device=dev).to(bf)
    lengths = torch.tensor(DECODE_LENGTHS, dtype=torch.int32, device=dev)
    live = sum(DECODE_LENGTHS)
    return (q, ck[:, 1], cv[:, 1], lengths,
            2 * live * kvh * d * 2 + 2 * q.numel() * 2 + b * 4,
            4 * live * h * d)


def _masked_rows(dev, gen, recs):
    """The masked flash forward (#3 with its mask3 operand, after its
    tile pre-pass) at :func:`_masked_shapes`, and ``decode_attention``'s
    kernel branch at Llama-3-8B's dense decode (:func:`_decode_case`),
    the q_len-1 kernel that reads the cache in place with no broadcast:
    the kernel record (the dense LLaMA serve's path).  Its yardsticks:
    SDPA with ``enable_gqa=True`` on the same un-broadcast cache (the
    record's), SDPA with ``attn_mask`` on the broadcast operands (the
    JAX package's formulation), and the bound on the cache's own live
    bytes beside the bound on the broadcast operands' live keys."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    for (label, q, k, v, mask, causal, iters, nbytes,
         flops) in _masked_shapes(dev, gen):
        err, ms, plain_ms, lib_ms = _masked_case(attn, label, q, k, v, mask,
                                                 causal, iters)
        bound, by = _bound(nbytes, flops)
        print(f"  flash_attention masked {label} on {_smi()}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA {lib_ms:.4f} ms, "
              f"bound {bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of the "
              f"bound")
        if label == "decode":
            b, h, _, d = q.shape
            s = k.shape[2]
            broadcast_bound, sdpa_mask_ms = bound, lib_ms
            # a 128-key tile of the 8192-key slot left out: its outputs
            # move past the per-row limit
            mask3 = attn._mask3(mask, b, h, 1, s)
            q3, k3, v3 = (t.reshape(b * h, -1, d) for t in (q, k, v))
            ref = attn._fwd_reference(q3, k3, v3, False, d ** -0.5,
                                      mask3=mask3)[0]
            drop = mask3.clone()
            drop[b - 1, :, 4096:4224] = True
            off = attn._fwd_reference(q3, k3, v3, False, d ** -0.5,
                                      mask3=drop)[0]
            off_rel = _slot_rel(off, ref)
            print(f"  a dropped 128-key tile of the 8192-key slot: "
                  f"{off_rel:.4g} of each row's max|ref| (limit "
                  f"{TOL_PAGED_OUT}), max|diff| "
                  f"{(off.float() - ref.float()).abs().max().item():.4g}")
            if off_rel <= TOL_PAGED_OUT:
                raise AssertionError("masked decode: the per-row limit does "
                                     "not see a dropped tile")
            del mask3, drop, ref, off, q3, k3, v3
        del q, k, v, mask
    torch.cuda.empty_cache()
    # -- decode_attention's kernel branch: no broadcast ------------------
    q, k, v, lengths, nbytes, flops = _decode_case(dev, gen)
    b, h, _, d = q.shape
    kvh, s = k.shape[1], k.shape[2]
    scale = d ** -0.5
    qg = q.reshape(b, kvh, h // kvh, d)
    from apex_tpu_torch.ops import _build
    counts = _build.launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.memory_allocated()
    got = attn.decode_attention(q, k, v, lengths, use_kernel=True)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - start
    after = _build.launch_counts()
    if after["flash_attention_masked"] != \
            counts["flash_attention_masked"] + 1 \
            or after["flash_attention"] != counts["flash_attention"]:
        raise AssertionError("decode_attention's kernel branch did not "
                             "launch the decode kernel alone")
    ref = attn._decode_reference(qg, k, v, lengths, scale)
    got = got.reshape(ref.shape)
    err = (got.float() - ref.float()).abs().max().item()
    rows = (lambda t: t.reshape(-1, d))
    print(f"decode_attention kernel branch [{b}, {h}, 1, {s}] over {kvh} kv "
          f"heads, lengths {DECODE_LENGTHS}, one layer of a strided "
          f"[{b}, 2, {kvh}, {s}, {d}] cache; peak memory rise over the call "
          f"{rise / 2 ** 20:.2f} MiB (the broadcast k/v would be "
          f"{2 * b * h * s * d * 2 / 2 ** 30:.2f} GiB)")
    _check("decode kernel out", err, TOL_ATTN_OUT)
    _check("decode kernel out (x each row's max|ref|)",
           _slot_rel(rows(got), rows(ref)), TOL_PAGED_OUT)
    if rise >= 64 * 2 ** 20:
        raise AssertionError(f"the decode branch allocated {rise} bytes")
    # a 64-position tile of the 8192-position slot left out
    cut = slice(4096, 4160)
    keep_cols = torch.cat([torch.arange(0, cut.start, device=dev),
                           torch.arange(cut.stop, s, device=dev)])
    off = attn._decode_reference(
        qg, k[:, :, keep_cols], v[:, :, keep_cols],
        torch.where(lengths > cut.start,
                    lengths - (torch.clamp(lengths, max=cut.stop)
                               - cut.start), lengths), scale)
    off_rel = _slot_rel(rows(off[b - 1]), rows(ref[b - 1]))
    print(f"  a dropped 64-position tile of the 8192-position slot: "
          f"{off_rel:.4g} of each row's max|ref| (limit {TOL_PAGED_OUT})")
    if off_rel <= TOL_PAGED_OUT:
        raise AssertionError("decode kernel: the per-row limit does not see "
                             "a dropped tile")
    del off, ref, got
    bound, by = _bound(nbytes, flops)
    ms = _time_ms(lambda: attn.decode_attention(q, k, v, lengths,
                                                use_kernel=True), 20)
    plain_ms = _time_ms(lambda: attn._decode_reference(qg, k, v, lengths,
                                                       scale), 3)
    keep = (torch.arange(s, device=dev)[None, None, None, :]
            < lengths[:, None, None, None])
    lib_ms = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, attn_mask=keep, enable_gqa=True), 20)
    print(f"  decode_attention kernel branch on {_smi()}: {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, SDPA enable_gqa on the cache "
          f"{lib_ms:.4f} ms, SDPA attn_mask on the broadcast k/v "
          f"{sdpa_mask_ms:.4f} ms; bound {bound:.4f} ms ({by}: the cache's "
          f"live k/v {nbytes / 1e9:.4f} GB), {100 * bound / ms:.1f}% of it; "
          f"the broadcast operands' live-key bound {broadcast_bound:.4f} ms")
    recs["flash_attention_masked"] = dict(
        name="flash_attention_masked", route="cuda",
        source="apex_tpu_torch/csrc/flash_attention.cu",
        replaces="apex_tpu/ops/attention.py:210", max_abs_err=err, ms=ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=lib_ms,
        eager_ms=_eager_ms(lambda: attn.decode_attention(
            q, k, v, lengths, use_kernel=True), 10))
    del q, k, v, qg
    torch.cuda.empty_cache()


def _fused_gpt_kernel(dev, gen, recs):
    """The fused decode block's GPT instance at GPT-3 1.3B width (hidden
    2048, 16 heads of 128, ffn 8192): one random layer in the model
    tree's layout, re-laid-out by ``fused_layer_params``, 8 slots of
    lengths 0..2048 over one layer of a 4-layer pool of page 64, against
    its plain version; its time over the 4 layers in turn, its phase
    clock."""
    from apex_tpu_torch.inference import models
    from apex_tpu_torch.transformer.testing import GPTConfig
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    cfg = GPTConfig(**dict(GPT_CFG, num_layers=1))
    tree = _random_gpt(cfg, dev, int(torch.randint(
        1 << 30, (1,), generator=gen, device=dev)))
    blk = models.fused_layer_params("gpt", cfg, tree)[0]
    del tree
    slots, ps, mpps, layers = 8, 64, 32, 4
    hidden, h, d = cfg.hidden_size, cfg.num_attention_heads, 128
    lengths_l = [0, 1, 64, 65, 700, 1024, 1500, 2048]
    n_pages = slots * mpps
    bf = torch.bfloat16
    pool_k = torch.randn(n_pages + 1, layers, h, ps, d, generator=gen,
                         device=dev).to(bf)
    pool_v = torch.randn(n_pages + 1, layers, h, ps, d, generator=gen,
                         device=dev).to(bf)
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    table = torch.full((slots, mpps), n_pages, dtype=torch.int32, device=dev)
    cursor = 0
    for i, n in enumerate(lengths_l):
        need = -(-n // ps)
        table[i, :need] = perm[cursor:cursor + need]
        cursor += need
    lengths = torch.tensor(lengths_l, dtype=torch.int32, device=dev)
    x = torch.randn(slots, hidden, generator=gen, device=dev).to(bf)
    kw = dict(kind="gpt", eps=1e-5)
    kp, vp = pool_k[:, 0], pool_v[:, 0]
    got = pa.fused_block_decode(x, blk, kp, vp, table, lengths, **kw)
    ref = pa.fused_block_reference(x, blk, kp, vp, table, lengths, **kw)
    print(f"fused_block_decode (GPT): one GPT-3 1.3B layer (hidden {hidden}, "
          f"{h} heads of {d}, ffn {cfg.ffn}), 8 slots, lengths {lengths_l}, "
          f"page {ps}")
    err = 0.0
    for name, g_, r_ in zip(("y", "k_tok", "v_tok"), got, ref):
        e = (g_.float() - r_.float()).abs().max().item()
        rel = ((g_.float() - r_.float()).norm() / r_.float().norm()).item()
        _check(f"fused GPT {name}", e,
               TOL_FUSED_REL * r_.float().abs().max().item())
        print(f"    relative L2 {rel:.4g} (limit {TOL_FUSED_REL_L2})")
        if rel > TOL_FUSED_REL_L2:
            raise AssertionError(f"fused GPT {name}: relative L2 {rel}")
        err = max(err, e)
    del got, ref
    mats = sum(t.numel() for n, t in blk.items() if n.startswith("w"))
    vecs = sum(t.numel() for n, t in blk.items() if not n.startswith("w"))
    live = sum(lengths_l)
    nbytes = 2 * mats + 4 * vecs + live * h * d * 2 * 2 \
        + 2 * 2 * x.numel() + 2 * 2 * slots * h * d + 4 * table.numel() \
        + 4 * slots
    bound, by = _bound(nbytes, 2 * slots * mats + 4 * (live + slots) * h * d)
    views = itertools.cycle([(pool_k[:, i], pool_v[:, i])
                             for i in range(layers)])
    ms = _queued_ms(lambda: pa.fused_block_decode(
        x, blk, *next(views), table, lengths, **kw), 40)
    eager = _eager_ms(lambda: pa.fused_block_decode(
        x, blk, *next(views), table, lengths, **kw), 40)
    plain_ms = _eager_ms(lambda: pa.fused_block_reference(
        x, blk, *next(views), table, lengths, **kw), 3)
    print(f"  fused_block_decode (GPT) on {_smi()}: {mats} weights "
          f"({2 * mats / 1e6:.1f} MB) + {live} live tokens' k/v; {ms:.4f} ms "
          f"per call (40 calls queued behind a sleeping card; eager, host "
          f"included, {eager:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms ({by}), {100 * bound / ms:.1f}% of the bound")
    kvh, ps_, d_, h_ = pa._fused_geometry(x, blk, kp, vp, table, lengths,
                                          "gpt", None, None, False)
    clock = torch.zeros(len(FUSED_PHASES) + 1, dtype=torch.int64,
                        device=dev)
    runs = []
    for _ in range(10):
        clock.zero_()
        pa._fused_kernel_call(x, blk, kp, vp, table, lengths, None, None,
                              1e-5, d ** -0.5, True, kvh, ps_, d_, h_,
                              clock=clock, kind="gpt")
        runs.append(np.diff(np.asarray(clock.tolist(), np.int64)) / 1e3)
    us = np.median(np.stack(runs), axis=0)
    print(f"  fused_block_decode (GPT) phases (median of 10 launches, "
          f"{us.sum():.1f} us in all): " + ", ".join(
              f"{n} {t:.1f} us" for n, t in zip(GPT_FUSED_PHASES, us)))
    recs["fused_block_decode_gpt"] = dict(
        name="fused_block_decode_gpt", route="cuda",
        source="apex_tpu_torch/csrc/fused_block_decode.cu",
        replaces="apex_tpu/ops/paged_attention.py:445", max_abs_err=err,
        ms=ms, plain_ms=plain_ms, bound_ms=bound, bound_by=by,
        library_ms=None, eager_ms=eager)
    del blk, pool_k, pool_v, views
    torch.cuda.empty_cache()


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
    ms = _queued_ms(lambda: pa.fused_block_decode(
        x, blk, *next(views), table, lengths, **kw), 40)
    eager = _eager_ms(lambda: pa.fused_block_decode(
        x, blk, *next(views), table, lengths, **kw), 40)
    plain_ms = _eager_ms(lambda: pa.fused_block_reference(
        x, blk, *next(views), table, lengths, **kw), 3)
    print(f"  fused_block_decode: {weights} weights ({2 * weights / 1e6:.1f} "
          f"MB) + {live} live tokens' k/v; {ms:.4f} ms per call (40 calls "
          f"queued behind a sleeping card; eager, host included, "
          f"{eager:.4f} ms), bound {bound:.4f} ms ({by}), "
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
        library_ms=None, eager_ms=eager)
    del blk, lp, cache, views
    torch.cuda.empty_cache()


FUSED_PHASES = ("q/k/v", "q/k/v sums + RoPE", "attention",
                "merge + fold + o", "x2 + norm2", "gate/up", "down", "y")
GPT_FUSED_PHASES = ("q/k/v", "q/k/v sums + biases", "attention",
                    "merge + fold + o", "x2 + norm2", "up", "gelu + down",
                    "y")


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
    dx2, dw2, _ = ln._bwd_2d(x, w, dy, 1e-5, True)
    if not (torch.equal(dx, dx2) and torch.equal(dw, dw2)):
        raise AssertionError("the norm backward did not repeat bit for bit")
    del dx2, dw2
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
    # where the row's time goes: the row kernel and the partials' reduce
    _device_breakdown("rms_norm backward [2048, 4096] (_bwd_2d)",
                      lambda: ln._bwd_2d(x, w, dy, 1e-5, True), 20, top=3)
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
    exact = _by_heads(lambda sl: _exact_bwd(q3[sl], k3[sl], v3[sl], do3[sl],
                                            scale), b_ * h, 8)
    print("flash_attention backward causal [1, 32, 2048, 128] bf16")
    err = _check_flash_bwd_exact("flash bwd", got, ref, exact)
    _hold_wrong_backwards(lambda **kw: attn._bwd_reference(
        q3, k3, v3, out, lse, do3, True, scale, **kw), ref, exact, s)
    del got, ref, exact
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
    # where the row's time goes: delta, the fp32 dq scratch, the kernel
    # and the dq cast
    _device_breakdown("flash backward causal [1, 32, 2048, 128] (_bwd)",
                      lambda: attn._bwd(q3, k3, v3, out, lse, do3, True,
                                        scale), 10, top=6)
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


def _by_heads(fn, n: int, step: int):
    """``fn(slice)`` over ``[0, n)`` in slices of ``step`` heads, the
    results concatenated (a tuple of outputs each along dim 0)."""
    parts = [fn(slice(i, i + step)) for i in range(0, n, step)]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(parts)
    return tuple(torch.cat(p) for p in zip(*parts))


def _split_kernels(dev, gen, recs):
    """The split flash backward (#5 dq, #6 dk/dv) at causal [1, 32,
    8192, 128] bf16 with k/v from 8 kv heads, the 8192-token training
    run's shape: against their plain versions computed 4 heads at a time
    (the plain version's [h, 8192, 8192] fp32 temporaries are 1 GiB
    each at 4 heads) and the exact float64 gradient 2 heads at a time
    (``_check_flash_bwd_exact``), with the one-pass backward's two wrong
    backwards, which must fail that gate; two runs bit for bit; and the
    route's time beside the one-pass kernel forced onto the same shape
    and SDPA's backward."""
    from apex_tpu_torch.ops import _build
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    bf = torch.bfloat16
    b_, h, kvh, s, d = 1, 32, 8, SPLIT_SEQ, 128
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
    delta = attn._delta(out, do3)
    args = (q3, k3, v3, lse, delta, do3, True, scale)
    if not attn._split_bwd(s, d):
        raise AssertionError(f"sq {s}, d {d} must take the split route")
    before = _build.launch_counts()
    got = attn._bwd(q3, k3, v3, out, lse, do3, True, scale)
    counts = {k_: v_ - before[k_] for k_, v_ in _build.launch_counts().items()}
    if counts["flash_attention_bwd_dq"] != 1 \
            or counts["flash_attention_bwd_dkv"] != 1 \
            or counts["flash_attention_bwd"] != 0:
        raise AssertionError(f"the 8192 backward did not take the split "
                             f"route: {counts}")

    def plain(sl, **kw):
        part = tuple(t[sl] for t in args[:6]) + args[6:]
        return (attn._dq_reference(*part, **kw),
                *attn._dkv_reference(*part, **kw))

    step = 4
    ref = _by_heads(plain, b_ * h, step)
    exact = _by_heads(lambda sl: _exact_bwd(q3[sl], k3[sl], v3[sl], do3[sl],
                                            scale), b_ * h, 2)
    print(f"flash_attention backward, split route (dq kernel + dk/dv "
          f"kernel), causal [{b_}, {h}, {s}, {d}] bf16, kv from {kvh} heads")
    _check_flash_bwd_exact("flash bwd split", got, ref, exact)
    errs = [(g_.float() - r_.float()).abs().max().item()
            for g_, r_ in zip(got, ref)]
    _hold_wrong_backwards(lambda **kw: _by_heads(lambda sl: plain(sl, **kw),
                                                 b_ * h, step),
                          ref, exact, s)
    del ref, exact
    again = attn._bwd(q3, k3, v3, out, lse, do3, True, scale)
    same = [torch.equal(a_, b2) for a_, b2 in zip(got, again)]
    print(f"  a second run of the split route: dq, dk, dv bit-identical "
          f"{same}")
    if not all(same):
        raise AssertionError("the split backward differs from run to run")
    saved = attn._FUSED_BWD_MAX_BYTES
    attn._FUSED_BWD_MAX_BYTES = 1 << 62      # force the one-pass kernel
    try:
        one = attn._bwd(q3, k3, v3, out, lse, do3, True, scale)
        one_ms = _time_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3, True,
                                            scale), 4)
    finally:
        attn._FUSED_BWD_MAX_BYTES = saved
    same = [torch.equal(a_, b2) for a_, b2 in zip(got, one)]
    print("  split vs the one-pass kernel on the same inputs: "
          + ", ".join(f"{nm} bit-identical {eq}, relative "
                      f"L2 {((a_.float() - b2.float()).norm() / b2.float().norm()).item():.3e}"
                      for nm, eq, a_, b2 in zip(("dq", "dk", "dv"), same, got,
                                                one)))
    if not (same[1] and same[2]):
        raise AssertionError("split dk/dv differ from the one-pass kernel's")
    del again, one
    split_ms = _time_ms(lambda: attn._bwd(q3, k3, v3, out, lse, do3, True,
                                          scale), 4)
    qr, kr, vr = (t.detach().clone().requires_grad_() for t in (q, k, v))
    lib_fb = _time_ms(lambda: torch.autograd.grad(
        F.scaled_dot_product_attention(qr, kr, vr, is_causal=True),
        (qr, kr, vr), do), 4)
    lib_f = _time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True), 4)
    del qr, kr, vr
    dq_ms = _time_ms(lambda: attn._dq_kernel(*args), 4)
    dkv_ms = _time_ms(lambda: attn._dkv_kernel(*args), 4)
    print(f"  the route on {_smi()}: split (delta, dq kernel, dk/dv kernel) "
          f"{split_ms:.4f} ms = dq {dq_ms:.4f} + dk/dv {dkv_ms:.4f} ms; the "
          f"one-pass kernel forced onto this shape {one_ms:.4f} ms; SDPA "
          f"backward (fwd+bwd - fwd) {lib_fb - lib_f:.4f} ms")
    _device_breakdown(f"flash backward split route causal [1, 32, {s}, 128] "
                      f"(_bwd)", lambda: attn._bwd(q3, k3, v3, out, lse, do3,
                                                   True, scale), 4, top=6)
    # one causal product of the shape: 2 s^2 d h / 2 flops
    product = s * s * d * h
    elem = q3.numel() * 2
    stats = 2 * b_ * h * s * 4                          # lse, delta
    for name, fn, ref_fn, products, outs, ms, err in (
            ("flash_attention_bwd_dq", attn._dq_kernel, attn._dq_reference,
             3, 1, dq_ms, errs[0]),
            ("flash_attention_bwd_dkv", attn._dkv_kernel,
             attn._dkv_reference, 4, 2, dkv_ms, max(errs[1:]))):
        bound, by = _bound(4 * elem + stats + outs * elem, products * product)
        recs[name] = dict(
            name=name, route="cuda",
            source="apex_tpu_torch/csrc/flash_attention_bwd.cu",
            replaces=("apex_tpu/ops/attention.py:376" if outs == 1 else
                      "apex_tpu/ops/attention.py:408"),
            max_abs_err=err, ms=ms,
            plain_ms=_eager_ms(lambda: _by_heads(
                lambda sl: ref_fn(*(t[sl] for t in args[:6]), *args[6:]),
                b_ * h, step), 1),
            bound_ms=bound, bound_by=by, library_ms=lib_fb - lib_f,
            eager_ms=_eager_ms(lambda: fn(*args), 4))
    del q, k, v, kk, vv, do, q3, k3, v3, do3, out, lse, delta, got, args
    torch.cuda.empty_cache()


def _shim_kernels(dev, gen, recs):
    """The multi_tensor_apply shim's two kernels (#10 axpby, #12 the
    fused scale and norm) over the 4-layer training model's flat length
    (1.923e9 fp32 elements) against their plain versions slice by slice,
    a bf16-in, bf16-out case of each, the norm's run-to-run bit
    identity, and an inf past 2^32 bytes raising each flag."""
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    n = _train_numel()
    chunk = 1 << 27
    src = "apex_tpu_torch/csrc/fused_update.cu"
    f32, bf = torch.float32, torch.bfloat16

    # -- axpby: out = a x + b y ---------------------------------------------
    print(f"fused_axpby over flat fp32 x, y [{n}]")
    x = torch.randn(n, generator=gen, device=dev)
    y = torch.randn(n, generator=gen, device=dev)
    a_, b_ = torch.full((), 0.75, device=dev), torch.full((), -1.5, device=dev)
    ab = torch.stack([a_, b_])

    def held(label, out, flag, ref_of, limit):
        err = 0.0
        for i in range(0, n, chunk):
            r = ref_of(slice(i, i + chunk))
            err = max(err, (out[i:i + chunk].float() - r.float()).abs()
                      .max().item())
        _check(label, err, limit)
        if flag.item() != 0.0:
            raise AssertionError(f"{label}: a finite buffer raised the flag")
        return err

    out, flag = fu.fused_axpby(a_, x, b_, y)
    err = held("fused_axpby fp32", out, flag, lambda sl: fu._axpby_reference(
        x[sl], y[sl], ab, f32)[0], TOL_AXPBY)
    del out
    xb, yb = x.to(bf), y.to(bf)
    out, flag = fu.fused_axpby(a_, xb, b_, yb)
    err = max(err, held("fused_axpby bf16 -> bf16", out, flag,
                        lambda sl: fu._axpby_reference(xb[sl], yb[sl], ab,
                                                       bf)[0], TOL_AXPBY))
    del out, xb, yb
    y[n - 5] = float("inf")                      # past 2^32 bytes
    _, flag = fu.fused_axpby(a_, x, b_, y)
    if flag.item() != 1.0:
        raise AssertionError("fused_axpby: an inf past 2^32 bytes was not "
                             "flagged")
    y[n - 5] = 0.0
    add_ms = _time_ms(lambda: torch.add(x, y, alpha=-1.5), 4)
    recs["fused_axpby"] = dict(
        name="fused_axpby", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:167", max_abs_err=err,
        ms=_time_ms(lambda: fu.fused_axpby(a_, x, b_, y), 4),
        plain_ms=_time_ms(lambda: _chunked(lambda sl: fu._axpby_reference(
            x[sl], y[sl], ab, f32), n, chunk), 1),
        library_ms=None,
        eager_ms=_eager_ms(lambda: fu.fused_axpby(a_, x, b_, y), 4))
    recs["fused_axpby"]["bound_ms"], recs["fused_axpby"]["bound_by"] = \
        _bound(12 * n, 3 * n, FP32_FLOPS_PER_S)
    print(f"  for orientation only (no flag, a = 1): torch.add(x, y, "
          f"alpha=b) {add_ms:.4f} ms")
    del y
    torch.cuda.empty_cache()

    # -- the fused scale and norm: out = x * scale, ||x * scale|| -----------
    print(f"fused_l2norm_scale over a flat fp32 buffer [{n}]")
    x.mul_(1000.0)
    inv = torch.full((), 2.0 ** -16, device=dev)
    out, norm, flag = fu.fused_l2norm_scale(x, inv)
    err = held("fused_l2norm_scale out", out, flag,
               lambda sl: fu._l2norm_scale_reference(x[sl], inv, f32)[0],
               TOL_L2NORM_SCALE_OUT)
    rout = torch.empty_like(out)
    rnorm, rflag = torch.empty((), device=dev), torch.zeros((), device=dev)
    fu._l2norm_scale_plain(x, inv, rout, rnorm, rflag)
    del rout
    nerr = abs(norm.item() - rnorm.item())
    _check("fused_l2norm_scale norm", nerr, TOL_L2NORM_REL * rnorm.item())
    if not all(torch.equal(fu.fused_l2norm_scale(x, inv)[1], norm)
               for _ in range(2)):
        raise AssertionError("fused_l2norm_scale's norm differs from run to "
                             "run")
    print(f"  norm {norm.item():.9g}, the same bits in 2 more runs")
    del out
    xb = x.to(bf)
    outb, normb, flag = fu.fused_l2norm_scale(xb, inv)
    held("fused_l2norm_scale bf16 -> bf16 out", outb, flag,
         lambda sl: fu._l2norm_scale_reference(xb[sl], inv, bf)[0],
         TOL_L2NORM_SCALE_OUT)
    rout = torch.empty_like(outb)
    fu._l2norm_scale_plain(xb, inv, rout, rnorm, rflag)
    _check("fused_l2norm_scale bf16 norm", abs(normb.item() - rnorm.item()),
           TOL_L2NORM_REL * rnorm.item())
    del outb, rout, xb
    x[n - 5] = float("inf")
    _, _, flag = fu.fused_l2norm_scale(x, inv)
    if flag.item() != 1.0:
        raise AssertionError("fused_l2norm_scale: an inf past 2^32 bytes was "
                             "not flagged")
    x[n - 5] = 0.0
    recs["fused_l2norm_scale"] = dict(
        name="fused_l2norm_scale", route="cuda", source=src,
        replaces="apex_tpu/ops/fused_update.py:232", max_abs_err=max(err, nerr),
        ms=_time_ms(lambda: fu.fused_l2norm_scale(x, inv), 4),
        plain_ms=_time_ms(lambda: _chunked(
            lambda sl: fu._l2norm_scale_reference(x[sl], inv, f32), n, chunk),
            1),
        library_ms=None,
        eager_ms=_eager_ms(lambda: fu.fused_l2norm_scale(x, inv), 4))
    recs["fused_l2norm_scale"]["bound_ms"], \
        recs["fused_l2norm_scale"]["bound_by"] = \
        _bound(8 * n, 3 * n, FP32_FLOPS_PER_S)
    del x, rnorm, rflag
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


def _random_tree(shapes, dev, seed: int, embed_std: float = 1.0):
    """A tree of random bf16 weights for ``{path: shape}`` from a seeded
    generator: linear weights ``[out, in]`` N(0, 1/fan_in) (flax
    ``Dense`` kernels ``[in, out]`` likewise), norm weights 1 + N(0,
    0.1^2), biases (norm and linear) N(0, 0.02^2), embeddings and
    position tables N(0, embed_std^2)."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tree: dict = {}
    for path, shape in sorted(shapes.items()):
        t = torch.randn(shape, generator=gen, device=dev)
        if path[-1] == "bias":
            t = 0.02 * t
        elif len(shape) == 1:
            t = 1 + 0.1 * t
        elif "embed" in "/".join(path) or path[-1] == "embedding":
            t = embed_std * t
        elif path[-1] == "kernel":
            t = t * shape[0] ** -0.5
        else:
            t = t * shape[1] ** -0.5
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = t.to(torch.bfloat16)
        del t
    return tree


def _random_gpt(cfg, dev, seed: int):
    """A GPT tree of random bf16 weights (:func:`_random_tree`); the word
    embedding (the tied head) and the position table N(0, 0.02^2), the
    JAX initialisers' scale, so the logits are of order 1."""
    from apex_tpu_torch.inference.weights import gpt_param_shapes
    return _random_tree(gpt_param_shapes(cfg), dev, seed, embed_std=0.02)


def _random_bert(cfg, dev, seed: int):
    from apex_tpu_torch.inference.weights import bert_param_shapes
    return _random_tree(bert_param_shapes(cfg), dev, seed, embed_std=0.02)


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
    print(f"{label}: {len(prompts)} requests, prompts "
          f"{[len(p) for p in prompts]}, {gen_tokens} tokens in {wall:.3f} s")
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
    pages = None
    if engine.paged:
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


def _full_forward(engine, seq):
    """The full forward ``[s, 1, vocab]`` of a sequence over the engine's
    weights: LLaMA through the port's own full-forward prefill, GPT
    through ``GPTModel`` (built on the meta device, run over the
    engine's tree with ``functional_call``)."""
    from apex_tpu_torch.inference import models
    if engine.kind == "llama":
        return models.prefill_forward("llama", engine.cfg, engine.params,
                                      seq)[0]
    from apex_tpu_torch.transformer.testing import gpt_model_provider
    from apex_tpu_torch.utils import tree_leaves_with_path
    model = gpt_model_provider(engine.cfg, device="meta")
    state = {".".join(path): t for path, t in tree_leaves_with_path(
        models._params_subtree(engine.params))}
    return torch.func.functional_call(model, state, (seq,))


def _check_logits(label, engine, prompt, outs_row, limit, forced=None):
    """Hold one request's engine decode logits against the full forward
    (:func:`_full_forward`) of the prompt and the tokens fed; returns the
    decode logits, the distance and the tokens fed."""
    got, toks, fed = _decode_logits(engine, prompt, forced)
    seq = torch.tensor([prompt + fed[:-1]], dtype=torch.int32,
                       device=engine.device)
    with torch.no_grad():
        full = _full_forward(engine, seq)
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

    # -- the same prompts on the dense slot cache at max_seq 8192 ---------
    # (above decode_attention's 4096 crossover: every decode layer is one
    # launch of the decode kernel, counted as flash_attention_masked,
    # reading the cache in place)
    dense = InferenceEngine("llama", cfg, engine.params, slots=8,
                            max_seq=DENSE_MAX_SEQ, device=dev)
    dserved = _serve(dense, prompts, "dense serve")
    dl = dserved["launches"]
    steps = int(dserved["reg"].declared("infer_decode_dispatch_total")
                .total())
    print(f"  dense decode steps {steps}: flash_attention_masked launched "
          f"{dl['flash_attention_masked']} times (want {cfg.num_layers} x "
          f"{steps}), paged_attention {dl['paged_attention']} and "
          f"fused_block_decode {dl['fused_block_decode']} (want 0)")
    if steps <= 0 or dl["flash_attention_masked"] != cfg.num_layers * steps:
        raise AssertionError("the dense serve did not run one masked flash "
                             "forward per layer per decode step")
    if dl["paged_attention"] or dl["fused_block_decode"] \
            or not dl["layer_norm"] or not dl["flash_attention"]:
        raise AssertionError(f"the dense serve's launches are off: {dl}")
    worst_dense = 0.0
    for idx in (0, len(prompts) - 1):
        _, d_dense, _ = _check_logits(f"request {idx}, dense", dense,
                                      prompts[idx], dserved["outs"][idx],
                                      TOL_LOGITS)
        worst_dense = max(worst_dense, d_dense)
    launches["flash_attention_masked"] = dl["flash_attention_masked"]
    del dense
    torch.cuda.empty_cache()
    return dict(launches=launches, ttft_mean_s=served["ttft_mean_s"],
                decode_tokens_per_s=served["decode_tokens_per_s"],
                peak_bytes=served["peak_bytes"], logit_err=worst,
                fused_logit_err=worst_fused, plain_fused_logit_err=d_plain,
                fused_decode_tokens_per_s=fserved["decode_tokens_per_s"],
                dense_logit_err=worst_dense,
                dense_decode_tokens_per_s=dserved["decode_tokens_per_s"])


#: the three GPT serves: the paged pool unfused, the paged pool with
#: fused-block decode, the dense slot cache; per decode step each must
#: launch 24 (layers) of its path's kernel and none of the others'
GPT_SERVES = (("gpt paged", dict(page_size=64), "paged_attention"),
              ("gpt fused", dict(page_size=64, decode_fusion="1"),
               "fused_block_decode_gpt"),
              ("gpt dense", {}, None))
GPT_DECODE_KERNELS = ("paged_attention", "fused_block_decode_gpt",
                      "fused_block_decode", "flash_attention_masked")


def phase_gpt(dev, seed: int):
    """GPT-3 1.3B at full width and depth (random bf16 weights) served
    three ways by ``InferenceEngine("gpt", ...)`` (:data:`GPT_SERVES`),
    8 slots, max_seq 2048, page 64, 8 prompts of 128..1536 tokens, 32
    greedy tokens each: TTFT, decode tokens/s, peak memory and the
    kernels launched a decode step; then two requests' decode logits
    against ``GPTModel``'s full forward (the later engines fed the first
    one's tokens, so their logits also compare with each other)."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import GPTConfig
    cfg = GPTConfig(**GPT_CFG)
    t0 = time.perf_counter()
    params = _random_gpt(cfg, dev, seed + 10)
    torch.cuda.synchronize()
    from apex_tpu_torch.utils import tree_leaves_with_path
    n_params = sum(t.numel() for _, t in tree_leaves_with_path(params))
    print(f"gpt: GPT-3 1.3B ({n_params / 1e9:.3f}e9 parameters) random bf16 "
          f"weights in {time.perf_counter() - t0:.1f} s")
    rng = np.random.RandomState(seed + 10)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in GPT_PROMPT_LENS]
    out, fed, first = {}, {}, {}
    for label, kw, path_kernel in GPT_SERVES:
        engine = InferenceEngine("gpt", cfg, params, slots=8,
                                 max_seq=cfg.max_seq_length, device=dev,
                                 **kw)
        served = _serve(engine, prompts, label)
        launches = served["launches"]
        steps = int(served["reg"].declared("infer_decode_dispatch_total")
                    .total())
        want = {k: (cfg.num_layers * steps if k == path_kernel else 0)
                for k in GPT_DECODE_KERNELS}
        got = {k: launches[k] for k in GPT_DECODE_KERNELS}
        print(f"  {label}: {steps} decode steps, launches {got} (want "
              f"{want}); layer_norm {launches['layer_norm']}, "
              f"flash_attention {launches['flash_attention']}")
        if steps <= 0 or got != want or not launches["layer_norm"] \
                or not launches["flash_attention"]:
            raise AssertionError(f"{label}: launches off: {launches}")
        for idx in (0, len(prompts) - 1):
            logits, d_, fed_i = _check_logits(
                f"{label} request {idx}", engine, prompts[idx],
                served["outs"][idx], TOL_LOGITS, forced=fed.get(idx))
            if idx in first:
                print(f"  {label} request {idx}: max|decode logits - "
                      f"{GPT_SERVES[0][0]}'s| "
                      f"{(logits - first[idx]).abs().max().item():.4f} "
                      f"(same tokens fed)")
            else:
                first[idx], fed[idx] = logits, fed_i
            served[f"logit_err_{idx}"] = d_
        out[label] = {k: served[k] for k in (
            "launches", "ttft_mean_s", "decode_tokens_per_s", "peak_bytes",
            "logit_err_0", f"logit_err_{len(prompts) - 1}")}
        del engine, served
        torch.cuda.empty_cache()
    del params, first
    torch.cuda.empty_cache()
    return dict(runs=out, launches={
        "fused_block_decode_gpt":
            out["gpt fused"]["launches"]["fused_block_decode_gpt"]})


def phase_bert(dev, seed: int):
    """BERT-large (the ``BertConfig`` default, random bf16 weights):
    ``InferenceEngine("bert", ...).encode`` on ``[8, 512]`` tokens, its
    time and launches (one flash forward and LayerNorms a layer), its
    logits against the same forward with every kernel swapped for its
    plain version; then ``BertModel`` with a padding mask over the
    engine's weights (one masked flash forward a layer), held the same
    way."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.transformer.testing import BertConfig
    cfg = BertConfig()
    params = _random_bert(cfg, dev, seed + 20)
    engine = InferenceEngine("bert", cfg, params, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 20)
    tokens = torch.randint(0, cfg.vocab_size, (BERT_BATCH, BERT_SEQ),
                           generator=gen, device=dev, dtype=torch.int32)
    types = torch.randint(0, 2, tokens.shape, generator=gen, device=dev,
                          dtype=torch.int32)
    engine.encode(tokens, types)                        # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    logits, nsp = engine.encode(tokens, types)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    print(f"bert: BERT-large encode [{BERT_BATCH}, {BERT_SEQ}] in "
          f"{wall * 1e3:.2f} ms ({BERT_BATCH * BERT_SEQ / wall:.0f} tokens/s), "
          f"peak device memory {peak / 2**30:.2f} GiB; launches {launches}")
    if nsp is not None or tuple(logits.shape) != (BERT_SEQ, BERT_BATCH,
                                                  cfg.vocab_size) \
            or not torch.isfinite(logits).all():
        raise AssertionError("bert: encode's output is misshaped or not "
                             "finite")
    if launches["flash_attention"] != cfg.num_layers \
            or launches["layer_norm"] <= 0 \
            or launches["flash_attention_masked"]:
        raise AssertionError(f"bert: encode's launches are off: {launches}")
    # live lengths 512, 448, ..., 64 and, last, a single token
    keep = torch.tensor([BERT_SEQ - i * BERT_SEQ // BERT_BATCH
                         for i in range(BERT_BATCH - 1)] + [1], device=dev)
    pad = (torch.arange(BERT_SEQ, device=dev)[None, :]
           < keep[:, None]).to(torch.int32)

    def padded():
        return torch.func.functional_call(
            engine._bert, engine._bert_state, (tokens, types, pad))[0]

    def forwards(route, state=None):
        """Both forwards (``encode``'s and the padded one), each inside a
        context ``route()``: their logits as ``[b, s, vocab]``."""
        state = engine._bert_state if state is None else state
        outs = []
        for args in ((tokens, types), (tokens, types, pad)):
            with route(), torch.no_grad():
                outs.append(torch.func.functional_call(
                    engine._bert, state, args)[0].transpose(0, 1))
        return outs

    _build.reset_launch_counts()
    with torch.no_grad():
        masked = padded()
    plaunch = _build.launch_counts()
    if plaunch["flash_attention_masked"] != cfg.num_layers \
            or plaunch["flash_attention"]:
        raise AssertionError(f"bert: the padded forward's launches are "
                             f"off: {plaunch}")
    _build.reset_launch_counts()
    plain = forwards(_plain_kernels)
    if any(_build.launch_counts().values()):
        raise AssertionError("bert: the plain route launched a kernel")
    kern = forwards(contextlib.nullcontext)
    # the control: the plain route on the same weights in fp32
    fp32 = forwards(_plain_kernels, {
        n: t.float() for n, t in engine._bert_state.items()})
    # one wrong layer on the kernels' route, the first or the 13th: its
    # attention causal (encode), or without its padding mask (padded)
    wrong = {n: [forwards(lambda: _wrong_attention(n, causal=True))[0],
                 forwards(lambda: _wrong_attention(n, mask3=None))[1]]
             for n in (0, 12)}
    errs = []
    for i, label in enumerate(("encode", "padded")):
        g_, r_ = kern[i], plain[i]
        e = (g_.float() - r_.float()).abs().max().item()
        rel = _seq_rel_l2(g_, r_, BERT_BATCH)
        off = {n: _seq_rel_l2(w[i], r_, BERT_BATCH) for n, w in wrong.items()}
        print(f"  bert {label}: max|kernels - plain| {e:.4f} (limit "
              f"{TOL_LOGITS}), relative L2 {rel:.4e} (the worst sequence; "
              f"limit {TOL_BERT_REL_L2}); plain bf16 against plain fp32 "
              f"{_seq_rel_l2(fp32[i], r_, BERT_BATCH):.4e}; a wrong layer 0 "
              f"{off[0]:.4e}, a wrong layer 12 {off[12]:.4e}")
        _check(f"bert {label} logits", e, TOL_LOGITS)
        _check(f"bert {label} logits (relative L2)", rel, TOL_BERT_REL_L2)
        if off[0] <= TOL_BERT_REL_L2:
            raise AssertionError(f"bert {label}: the relative L2 limit does "
                                 f"not see a wrong first layer")
        errs.append(e)
    del engine, params, logits, masked, plain, kern, fp32, wrong
    torch.cuda.empty_cache()
    return dict(wall_s=wall, peak_bytes=peak, logit_err=max(errs),
                launches=launches)


def _train_model(dev, seed: int, layers: int, seq: int = TRAIN_SEQ):
    """The training model at Llama-3-8B widths and ``layers`` deep, bf16
    parameters drawn from a seeded generator, and one fixed batch of
    ``seq`` seeded tokens from the same generator."""
    from apex_tpu_torch.transformer.testing import (LlamaConfig,
                                                    llama_model_provider)
    cfg = LlamaConfig(**dict(FULL_CFG, num_layers=layers,
                             params_dtype=torch.bfloat16))
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    model = llama_model_provider(cfg, device=dev)
    model.reset_parameters(generator=gen)
    tokens = torch.randint(0, cfg.vocab_size, (1, seq + 1),
                           generator=gen, device=dev)
    batch = {"tokens": tokens[:, :-1].contiguous(),
             "labels": tokens[:, 1:].contiguous()}
    return cfg, model, batch


def _train_setup(dev, seed: int, layers: int, tx=None,
                 loss_scale="dynamic", seq: int = TRAIN_SEQ):
    """:func:`_train_model` and its train state for ``tx`` (default:
    Adam)."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.optimizers import functional
    cfg, model, batch = _train_model(dev, seed, layers, seq)
    tx = functional.fused_adam(lr=TRAIN_LR) if tx is None else tx
    state = train_step.init_train_state(tx, model, loss_scale=loss_scale)
    return cfg, model, tx, state, batch, train_step


def _train_loss(model, batch):
    return model(batch["tokens"], batch["labels"])


def _train_run(dev, seed: int, label: str, tx, layers: int, steps: int,
               loss_scale, kernels, transform=None, profile: bool = False,
               seq: int = TRAIN_SEQ):
    """``steps`` steps of the ``layers``-deep model under ``tx`` on one
    batch of ``seq`` tokens with the launch counters zeroed just before;
    the segment from the flat grads (``transform``, then the unscale,
    the update and the scale update) runs under
    ``set_sync_debug_mode("error")``.  Returns the launch counts, step
    time, peak memory, losses, the leaf count and the tokens a step."""
    from apex_tpu_torch.ops import _build
    t0 = time.perf_counter()
    cfg, model, tx, state, batch, train_step = _train_setup(
        dev, seed, layers, tx, loss_scale, seq)
    torch.cuda.synchronize()
    n = state.opt.master.numel()
    leaves = len(state.opt.sizes)
    print(f"train {label}: Llama-3-8B widths, {layers} layers, {seq} "
          f"tokens a step, {n} "
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
    tokens = seq
    heads = cfg.num_attention_heads
    hd = cfg.hidden_size // heads
    matmul_params = n - cfg.vocab_size * cfg.hidden_size \
        - (2 * layers + 1) * cfg.hidden_size
    # 6 N T for the weight GEMMs (the embedding table and norms do no
    # GEMM), and 3x the causal forward's two attention products
    model_flops = 6 * matmul_params * tokens + 3 * (
        4 * seq * seq * hd * heads / 2) * layers
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
                          f"{seq} tokens)", one, 2, top=16)
    del model, state, step
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=step_s, peak_bytes=peak,
                losses=losses, leaves=leaves, tokens=seq)


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
    # the 8192-token run: every layer's backward through the split pair
    runs["adam8k"] = _train_run(
        dev, seed, "adam 8192", functional.fused_adam(lr=TRAIN_LR),
        TRAIN_LAYERS, SPLIT_STEPS, "dynamic", SPLIT_TRAIN_KERNELS,
        profile=profile, seq=SPLIT_SEQ)
    split = runs["adam8k"]["launches"]
    want = TRAIN_LAYERS * SPLIT_STEPS
    print(f"  adam 8192: flash_attention_bwd_dq launched "
          f"{split['flash_attention_bwd_dq']} times, flash_attention_bwd_dkv "
          f"{split['flash_attention_bwd_dkv']} (want {TRAIN_LAYERS} layers x "
          f"{SPLIT_STEPS} steps = {want} each), flash_attention_bwd "
          f"{split['flash_attention_bwd']} (want 0)")
    if any(split[k] != want for k in SPLIT_KERNELS) \
            or split["flash_attention_bwd"]:
        raise AssertionError("the 8192-token steps did not run the split "
                             "backward once per layer and step")
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
    for label, r in runs.items():
        if label != "adam8k" and (any(r["launches"][k] for k in SPLIT_KERNELS)
                                  or not r["launches"]["flash_attention_bwd"]):
            raise AssertionError(f"{label}: a {TRAIN_SEQ}-token run must take "
                                 f"the one-pass backward: {r['launches']}")
    print("train summary (step time, tokens/s, peak device memory):")
    for label, r in runs.items():
        print(f"  {label}: {r['step_s']:.4f} s, "
              f"{r['tokens'] / r['step_s']:.1f} tokens/s, "
              f"{r['peak_bytes'] / 2**30:.2f} GiB")
    return runs


def _seq_rel_l2(got, ref, b: int) -> float:
    """The largest over the ``b`` sequences of the relative L2 difference
    of their parts of a tensor that leads with them (``[b, s, vocab]``
    logits, ``[b*h, s, d]`` flash outputs)."""
    got, ref = got.float().reshape(b, -1), ref.float().reshape(b, -1)
    return ((got - ref).norm(dim=1) / ref.norm(dim=1)).max().item()


@contextlib.contextmanager
def _wrong_attention(n: int, **override):
    """The ``n``-th flash forward (from 0) inside the context runs with
    ``override`` in its keyword arguments (``causal``, ``mask3``): one
    wrong layer, for showing that a check sees it."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    fwd, calls = attn._fwd, itertools.count()

    def wrong(q3, k3, v3, causal, scale, **kw):
        if next(calls) == n:
            kw = {**kw, "causal": causal, **override}
            causal = kw.pop("causal")
        return fwd(q3, k3, v3, causal, scale, **kw)

    attn._fwd = wrong
    try:
        yield
    finally:
        attn._fwd = fwd


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


def _step_grads(dev, seed: int, seq: int, route):
    """One step of the 1-layer model on ``seq`` tokens inside the
    context ``route``: its flat grads (cloned from the grad transform),
    loss, launch counts and ``(leaf name, size)`` list."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.utils import tree_leaves_with_path
    _, model, tx, state, batch, train_step = _train_setup(dev, seed, 1,
                                                          seq=seq)
    leaves = [(".".join(path), t.numel())
              for path, t in tree_leaves_with_path(model)]
    keep = []
    step = train_step.make_train_step(
        _train_loss, tx, grad_transform=lambda g: keep.append(
            g.clone()) or g)
    _build.reset_launch_counts()
    with route:
        _, loss = step(state, batch)
    counts = _build.launch_counts()
    grads, loss = keep[0], loss.item()
    del model, state, step, keep
    torch.cuda.empty_cache()
    return grads, loss, counts, leaves


def _hold_grads(label, got, ref, leaves, losses, limit):
    """Hold the flat grads ``got`` against ``ref``: the relative L2 on
    every leaf's slice (the worst within ``limit``), finite values, and
    the two losses within TOL_TRAIN_LOSS; returns the leaves' readings."""
    rels, off = {}, 0
    for name, size in leaves:
        g_, r_ = got[off:off + size], ref[off:off + size]
        rels[name] = ((g_ - r_).norm() / r_.norm()).item()
        off += size
    rel = ((got - ref).norm() / ref.norm()).item()
    worst = max(rels, key=rels.get)
    finite = bool(torch.isfinite(got).all())
    print(f"  losses {losses[0]:.6f} and {losses[1]:.6f}; flat grads "
          f"relative L2 {rel:.3e} in all, by leaf:")
    for name, r in rels.items():
        print(f"    {r:.3e}  {name}")
    print(f"  worst leaf {worst} {rels[worst]:.3e} (limit {limit}), finite "
          f"{finite}")
    if not finite or not rels[worst] <= limit:
        raise AssertionError(f"{label}: flat grads off: relative L2 "
                             f"{rels[worst]} in {worst}")
    if abs(losses[0] - losses[1]) > TOL_TRAIN_LOSS:
        raise AssertionError(f"{label}: losses differ: {losses}")
    return rels


def phase_train_check(dev, seed: int):
    """One step of the 1-layer model through the kernels against the
    same step through the plain versions: the flat grads leaf by leaf,
    and the loss."""
    got, loss_k, _, leaves = _step_grads(dev, seed, TRAIN_SEQ,
                                         contextlib.nullcontext())
    ref, loss_p, counts, _ = _step_grads(dev, seed, TRAIN_SEQ,
                                         _plain_kernels())
    routed = [k for k in ("layer_norm", "layer_norm_bwd", "flash_attention",
                          "flash_attention_bwd") + SPLIT_KERNELS
              if counts[k]]
    if routed:
        raise AssertionError(f"the plain step launched {routed}: {counts}")
    print("train-check (1 layer): kernels, then plain versions")
    rels = _hold_grads("train-check", got, ref, leaves, [loss_k, loss_p],
                       TOL_TRAIN_GRAD_REL_L2)
    del got, ref
    torch.cuda.empty_cache()
    return dict(grad_rel_l2=rels, losses=[loss_k, loss_p])


@contextlib.contextmanager
def _one_pass_backward():
    """Raise the flash backward's gate so the one-pass kernel takes every
    length (the module reads it at call time)."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    saved = attn._FUSED_BWD_MAX_BYTES
    attn._FUSED_BWD_MAX_BYTES = 1 << 62
    try:
        yield
    finally:
        attn._FUSED_BWD_MAX_BYTES = saved


def phase_split_check(dev, seed: int):
    """One 8192-token step of the 1-layer model through the split
    backward against the same step with the gate raised, so the one-pass
    kernel takes it: both on the card (the plain route would need tens
    of GiB of score temporaries), the flat grads leaf by leaf and the
    loss."""
    got, loss_s, cs, leaves = _step_grads(dev, seed, SPLIT_SEQ,
                                          contextlib.nullcontext())
    ref, loss_o, co, _ = _step_grads(dev, seed, SPLIT_SEQ,
                                     _one_pass_backward())
    print(f"split-check (1 layer, {SPLIT_SEQ} tokens): split route launched "
          f"{ {k: cs[k] for k in ('flash_attention_bwd',) + SPLIT_KERNELS} }, "
          f"one-pass route "
          f"{ {k: co[k] for k in ('flash_attention_bwd',) + SPLIT_KERNELS} }")
    if any(cs[k] != 1 for k in SPLIT_KERNELS) or cs["flash_attention_bwd"] \
            or co["flash_attention_bwd"] != 1 \
            or any(co[k] for k in SPLIT_KERNELS):
        raise AssertionError("the split check did not take its two routes")
    print("  split route, then one-pass route")
    rels = _hold_grads("split-check", got, ref, leaves, [loss_s, loss_o],
                       TOL_SPLIT_GRAD_REL_L2)
    del got, ref
    torch.cuda.empty_cache()
    return dict(grad_rel_l2=rels, losses=[loss_s, loss_o])


@contextlib.contextmanager
def _plain_shim():
    """Route the shim's kernels to their plain versions: the axpby, norm
    and fused scale-and-norm wrappers look up their kernel functions at
    call time, and the shim looks up ``fused_scale``."""
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    names = ("_axpby", "_l2norm", "_l2norm_scale")
    saved = [getattr(fu, f"{nm}_kernel") for nm in names] + [fu.fused_scale]
    for nm in names:
        setattr(fu, f"{nm}_kernel", getattr(fu, f"{nm}_plain"))
    fu.fused_scale = lambda flat, scale, out_dtype=None: fu._scale_reference(
        flat, fu._scalar(scale, flat.device), out_dtype or flat.dtype)
    try:
        yield
    finally:
        for nm, fn in zip(names, saved):
            setattr(fu, f"{nm}_kernel", fn)
        fu.fused_scale = saved[-1]


def phase_shim(dev, seed: int):
    """Apex's ``multi_tensor_applier`` over a real grad list: one
    backward of the 1-layer model (2048 tokens), then each of the four
    ops over its 11 grads (bf16 linears, fp32 norms) through the kernels,
    against the same calls through the plain versions on the card; an
    inf in one grad must raise every flag, and ``noop_flag`` must pass
    through.  Returns the launch counts of the kernel calls."""
    from apex_tpu_torch.multi_tensor_apply import (
        multi_tensor_applier, multi_tensor_axpby, multi_tensor_l2norm,
        multi_tensor_l2norm_scale, multi_tensor_scale)
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.utils import tree_leaves_with_path
    _, model, batch = _train_model(dev, seed, 1)
    _train_loss(model, batch).backward()
    named = tree_leaves_with_path(model)
    grads = [p.grad for _, p in named]
    params = [p.detach() for _, p in named]
    print(f"shim: multi_tensor_applier over the 1-layer model's "
          f"{len(grads)} grads ({sum(g.numel() for g in grads)} elements; "
          f"dtypes {sorted({str(g.dtype) for g in grads})})")
    calls = (("multi_tensor_scale", multi_tensor_scale, [grads], (0.5,)),
             ("multi_tensor_axpby", multi_tensor_axpby, [grads, params],
              (2.0, -0.5)),
             ("multi_tensor_l2norm", multi_tensor_l2norm, [grads], (True,)),
             ("multi_tensor_l2norm_scale", multi_tensor_l2norm_scale,
              [grads], (0.5, True)))

    def run_all(noop=0.0):
        return [multi_tensor_applier(op, noop, lists, *args)
                for _, op, lists, args in calls]

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    got = run_all()
    torch.cuda.synchronize()
    launches = _build.launch_counts()
    with _plain_shim():
        ref = run_all()
    if _build.launch_counts() != launches:
        raise AssertionError("the plain shim route launched a kernel")
    want = {"fused_scale": 1, "fused_axpby": 1, "fused_l2norm": 1,
            "fused_l2norm_scale": 1}
    print(f"  kernel launches of the four calls "
          f"{ {k: v for k, v in launches.items() if v} } (want {want})")
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError("the shim did not launch one kernel a call")

    def flat(x):
        if isinstance(x, torch.Tensor):
            return [x]
        if isinstance(x, (list, tuple)):
            return [t for item in x for t in flat(item)]
        return []

    worst = {}
    for (name, *_), g_, r_ in zip(calls, got, ref):
        gt, rt = flat(g_), flat(r_)
        if len(gt) != len(rt):
            raise AssertionError(f"{name}: outputs differ in structure")
        err = 0.0
        for a_, b_ in zip(gt, rt):
            if a_.shape != b_.shape or a_.dtype != b_.dtype:
                raise AssertionError(f"{name}: {a_.shape} {a_.dtype} against "
                                     f"{b_.shape} {b_.dtype}")
            rel = ((a_.float() - b_.float()).abs().max()
                   / b_.float().abs().max().clamp_min(1e-30)).item() \
                if a_.numel() else 0.0
            err = max(err, rel)
        worst[name] = err
        print(f"  {name}: worst max|diff| / max|ref| over its outputs "
              f"{err:.3e} (limit {TOL_L2NORM_REL})")
    if any(v > TOL_L2NORM_REL for v in worst.values()):
        raise AssertionError(f"the shim is off its plain route: {worst}")
    del got, ref
    noop = run_all(torch.ones((), device=dev))
    flags = [noop[0][1].item(), noop[1][1].item(), noop[3][3].item()]
    grads[3].view(-1)[0] = float("inf")
    poisoned = run_all()
    pflags = [poisoned[0][1].item(), poisoned[1][1].item(),
              poisoned[3][3].item()]
    print(f"  noop_flag 1 passed through: found_inf {flags}; an inf in "
          f"grad 3: found_inf of scale, axpby, l2norm_scale {pflags}, "
          f"global norm {poisoned[2][0].item()}")
    if flags != [1.0, 1.0, 1.0] or pflags != [1.0, 1.0, 1.0]:
        raise AssertionError("a shim flag did not rise")
    del model, grads, params, noop, poisoned
    torch.cuda.empty_cache()
    return dict(launches=launches, worst=worst)


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


@contextlib.contextmanager
def _plain_updates_refused():
    """Make every plain version of the update kernels raise: a class-API
    step on the card that reached one would fail the phase."""
    fu = importlib.import_module("apex_tpu_torch.ops.fused_update")
    saved = {n: getattr(fu, n) for n in dir(fu) if n.endswith("_plain")}

    def refuse(name):
        def plain(*args, **kwargs):
            raise AssertionError(f"{name} ran on the card")
        return plain

    for name in saved:
        setattr(fu, name, refuse(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(fu, name, fn)


def _strict_step(opt, **kw):
    """``opt.step()`` under ``set_sync_debug_mode("error")``: from the
    end of the backward to the new parameters, nothing reads back."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        opt.step(**kw)
    finally:
        torch.cuda.set_sync_debug_mode(0)


def _add_counts(total, counts):
    for k, v in counts.items():
        total[k] = total.get(k, 0) + v


def _twin_loop(dev, seed: int):
    """Apex's own loop on the 4-layer model: ``FusedAdam(model.
    parameters())``, then six rounds of ``loss.backward(); opt.step();
    opt.zero_grad()``.  Returns the launch counts, step time, peak memory
    and the time of the grad-buffer copy pass."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedAdam
    from apex_tpu_torch.optimizers._torch_mode import FusedAdamTorch
    t0 = time.perf_counter()
    cfg, model, batch = _train_model(dev, seed, TRAIN_LAYERS)
    opt = FusedAdam(model.parameters(), lr=TRAIN_LR)
    if type(opt) is not FusedAdamTorch:
        raise AssertionError(f"FusedAdam(model.parameters()) gave "
                             f"{type(opt).__name__}")
    n = sum(p.numel() for p in model.parameters())
    torch.cuda.synchronize()
    print(f"optim twin adam: FusedAdam(model.parameters()) is "
          f"{type(opt).__name__}; Llama-3-8B widths, {TRAIN_LAYERS} layers, "
          f"{n} parameters, {TRAIN_SEQ} tokens a step, set up in "
          f"{time.perf_counter() - t0:.1f} s")
    losses, times = [], []
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launch_counts()
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = _train_loss(model, batch)
        loss.backward()
        _strict_step(opt)
        opt.zero_grad()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        losses.append(loss.item())
    launches = _build.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = float(np.median(times[1:]))
    print(f"  losses {[round(x, 4) for x in losses]}")
    print(f"  step times {[round(t, 4) for t in times]} s; median of steps "
          f"2-{TRAIN_STEPS} {step_s:.4f} s = {TRAIN_SEQ / step_s:.1f} "
          f"tokens/s; peak device memory {peak / 2**30:.2f} GiB")
    print(f"  kernel launches per step: "
          f"{ {k: v / TRAIN_STEPS for k, v in launches.items() if v} }")
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"twin adam: the loss did not fall: {losses}")
    if launches["fused_adam"] != TRAIN_STEPS:
        raise AssertionError(f"twin adam: fused_adam launched "
                             f"{launches['fused_adam']} times in "
                             f"{TRAIN_STEPS} steps")
    # the pass the functional step does not have: each fresh grad copied
    # into its slot of the grad buffer (zero_grad set the grads to None)
    _train_loss(model, batch).backward()
    fg = opt._groups[0]
    pairs = [(gv, p.grad) for p, gv in zip(fg.params, fg.flat.grad_views)]
    grad_bytes = sum(g.numel() * g.element_size() for _, g in pairs)
    copy_ms = _time_ms(lambda: [gv.copy_(g) for gv, g in pairs], 5)
    cast_ms = _time_ms(fg.flat.cast_grads, 5)
    load_ms = _time_ms(lambda: fg.flat.load(fg.master), 5)
    print(f"  twin step passes: grad-buffer copy {copy_ms:.4f} ms ("
          f"{len(pairs)} copies, {grad_bytes / 1e9:.3f} GB each way, bound "
          f"{2 * grad_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms), grad cast "
          f"{cast_ms:.4f} ms, master cast into the parameters "
          f"{load_ms:.4f} ms")
    del pairs, opt, model, fg
    torch.cuda.empty_cache()
    return dict(launches=launches, step_s=step_s, peak_bytes=peak,
                losses=losses, copy_ms=copy_ms)


def _leaf_key(name: str) -> str:
    return "".join(f"[{k!r}]" for k in name.split("."))


def _twin_against_functional(dev, seed: int):
    """From one warm state (two functional Adam steps, no loss scale, on
    the 1-layer model), one ``make_train_step`` step and one step of a
    ``FusedAdam`` twin on a second copy of the model, fed the functional
    step's grads (the one-pass flash backward adds dq in any order, so
    two backwards differ in their last bits): master, ``exp_avg`` and
    ``exp_avg_sq`` of every leaf, and the update launches, must agree."""
    from apex_tpu_torch import train_step
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedAdam, functional
    tx = functional.fused_adam(lr=TRAIN_LR)
    _, model_f, batch = _train_model(dev, seed, RULE_LAYERS)
    state = train_step.init_train_state(tx, model_f)
    step = train_step.make_train_step(_train_loss, tx)
    for _ in range(2):
        state, _ = step(state, batch)
    _, model_t, _ = _train_model(dev, seed, RULE_LAYERS)
    opt = FusedAdam(model_t.parameters(), lr=TRAIN_LR)
    offsets = train_step.leaf_offsets(model_f)
    count = int(state.opt.count.item())
    ref = {"master": state.opt.master, **state.opt.slots}
    # each twin leaf's slice of the functional flat buffers
    leaves = [(name, p, *offsets[_leaf_key(name)])
              for name, p in model_t.named_parameters()]
    sd = opt.state_dict()
    for i, (_, p, off, size, shape) in enumerate(leaves):
        sd["state"][i] = {"step": count, **{
            k: buf[off:off + size].view(shape) for k, buf in ref.items()}}
    opt.load_state_dict(sd)
    with torch.no_grad():
        for _, p, off, size, shape in leaves:
            p.copy_(ref["master"][off:off + size].view(shape))
    _build.reset_launch_counts()
    state, _ = step(state, batch)
    torch.cuda.synchronize()
    f_counts = _build.launch_counts()
    # the functional step's grads, as autograd would hand them over
    views = dict(zip(offsets, state.flat.grad_views))
    for name, p, *_ in leaves:
        p.grad = views[_leaf_key(name)]
    _build.reset_launch_counts()
    _strict_step(opt)
    torch.cuda.synchronize()
    t_counts = _build.launch_counts()
    worst = {}
    for name, p, off, size, shape in leaves:
        st = opt.state[p]
        for k, buf in ref.items():
            a = st.get(k, p)                 # an fp32 leaf is its master
            b = buf[off:off + size].view(shape)
            rel = (a.float() - b).abs().max().item() / max(
                b.abs().max().item(), 1e-30)
            if rel >= worst.get(k, (-1.0,))[0]:
                worst[k] = (rel, name)
    upd = {k: (f_counts[k], t_counts[k]) for k in ("fused_adam",)}
    print(f"optim twin vs functional (1 layer, one Adam step from a warm "
          f"state at step {count}, the functional step's grads): worst "
          f"leaf max|diff| / max|ref|: "
          + ", ".join(f"{k} {v:.3e} ({leaf})" for k, (v, leaf)
                      in worst.items())
          + f" (limit {TOL_TWIN_REL}); update launches functional/twin "
          f"{upd}; the twin step launched "
          f"{ {k: v for k, v in t_counts.items() if v} }")
    bad = {k: v for k, v in worst.items() if not v[0] <= TOL_TWIN_REL}
    if bad:
        raise AssertionError(f"twin step off the functional step: {bad}")
    if not f_counts["fused_adam"] == t_counts["fused_adam"] == 1 or any(
            v for k, v in t_counts.items() if k != "fused_adam"):
        raise AssertionError(f"launches differ: functional {f_counts}, "
                             f"twin {t_counts}")
    del opt, model_t, model_f, state, step, views, ref, leaves
    torch.cuda.empty_cache()
    return worst


def _other_twins(dev, seed: int):
    """LAMB (two groups: decay and no-decay), SGD and Adagrad twins on the
    1-layer model, ``OPTIM_RULE_STEPS`` rounds each: each rule's kernel
    once per group and step; LAMB's norm 2 per leaf plus at most 2 per
    group a step."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedAdagrad, FusedLAMB, FusedSGD
    out = {}
    for label, cls, kw, kernel in (
            ("lamb", FusedLAMB, LAMB_KW, "fused_lamb1"),
            ("sgd", FusedSGD, SGD_KW, "fused_sgd"),
            ("adagrad", FusedAdagrad, ADAGRAD_KW, "fused_adagrad")):
        _, model, batch = _train_model(dev, seed, RULE_LAYERS)
        named = list(model.named_parameters())
        groups = [{"params": [p for n, p in named if "norm" not in n]},
                  {"params": [p for n, p in named if "norm" in n],
                   "weight_decay": 0.0}]
        opt = cls(groups if label == "lamb" else model.parameters(), **kw)
        n_groups = len(opt.param_groups)
        losses = []
        _build.reset_launch_counts()
        for _ in range(OPTIM_RULE_STEPS):
            loss = _train_loss(model, batch)
            loss.backward()
            _strict_step(opt)
            opt.zero_grad()
            losses.append(loss.item())
        launches = _build.launch_counts()
        per_step = {k: v / OPTIM_RULE_STEPS for k, v in launches.items()
                    if v}
        print(f"optim twin {label} ({type(opt).__name__}, 1 layer, "
              f"{len(named)} leaves in {n_groups} group(s)): losses "
              f"{[round(x, 4) for x in losses]}; launches per step "
              f"{per_step}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"twin {label}: non-finite loss {losses}")
        if launches[kernel] != n_groups * OPTIM_RULE_STEPS:
            raise AssertionError(f"twin {label}: {kernel} launched "
                                 f"{launches[kernel]} times")
        if label == "lamb":
            norms = launches["fused_l2norm"] / OPTIM_RULE_STEPS
            if not 2 * len(named) < norms <= 2 * len(named) + 2 * n_groups:
                raise AssertionError(f"twin lamb: {norms} norm launches a "
                                     f"step for {len(named)} leaves")
        out[label] = launches
        del opt, model, groups, named
        torch.cuda.empty_cache()
    return out


def _tree_lamb(dev, seed: int):
    """``FusedLAMB(tree).step(grads_tree)`` over the 1-layer model's
    parameter tree, three steps, against the functional LAMB update on
    the same flat grads from a clone of the same state."""
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import FusedLAMB, functional
    from apex_tpu_torch.utils import tree_leaves_with_path, tree_ravel
    _, model, batch = _train_model(dev, seed, RULE_LAYERS)

    def tree_of(tensors):
        tree: dict = {}
        for (path, _), t in zip(tree_leaves_with_path(model), tensors):
            node = tree
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = t
        return tree

    leaves = tree_leaves_with_path(model)
    params = tree_of([p.detach() for _, p in leaves])
    opt = FusedLAMB(params, **LAMB_KW)
    if type(opt) is not FusedLAMB:
        raise AssertionError(f"FusedLAMB(tree) gave {type(opt).__name__}")
    tx = functional.fused_lamb(**LAMB_KW)
    ref = tx.init(params)
    launches, worst = {}, {}
    for i in range(OPTIM_TREE_STEPS):
        model.zero_grad(set_to_none=True)
        _train_loss(model, batch).backward()
        grads = tree_of([p.grad for _, p in leaves])
        _build.reset_launch_counts()
        torch.cuda.set_sync_debug_mode("error")
        try:
            opt.step(grads)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        _add_counts(launches, _build.launch_counts())
        ref = tx.update(ref, tree_ravel(grads)[0])
        group = opt.param_groups[0]
        for k, a, b in [("master", group.master, ref.master)] + [
                (k, group.state[k], ref.slots[k]) for k in ref.slots]:
            off = 0
            for (path, t) in leaves:
                n = t.numel()
                rb = b[off:off + n]
                rel = (a[off:off + n] - rb).abs().max().item() / max(
                    rb.abs().max().item(), 1e-30)
                if rel >= worst.get(k, (-1.0,))[0]:
                    worst[k] = (rel, ".".join(path))
                off += n
        del grads
    per_step = {k: v / OPTIM_TREE_STEPS for k, v in launches.items() if v}
    print(f"optim tree lamb (FusedLAMB(tree).step(grads), 1 layer, "
          f"{len(leaves)} leaves, {OPTIM_TREE_STEPS} steps): launches per "
          f"step {per_step}; against the functional update, worst leaf "
          f"max|diff| / max|ref|: "
          + ", ".join(f"{k} {v:.3e} ({leaf})" for k, (v, leaf)
                      in worst.items()) + f" (limit {TOL_TWIN_REL})")
    bad = {k: v for k, v in worst.items() if not v[0] <= TOL_TWIN_REL}
    if bad:
        raise AssertionError(f"tree lamb off the functional update: {bad}")
    if launches["fused_lamb1"] != OPTIM_TREE_STEPS or launches[
            "fused_l2norm"] != (1 + 2 * len(leaves)) * OPTIM_TREE_STEPS:
        raise AssertionError(f"tree lamb launches: {launches}")
    del opt, ref, model, params
    torch.cuda.empty_cache()
    return launches


def _handoff(dev, seed: int):
    """Train the 4-layer model three ``make_train_step`` steps (Adam,
    dynamic loss scale), hand the state to ``InferenceEngine.
    from_train_state``, free the optimizer, serve the eight prompts; hold
    two requests' decode logits against the full forward; an engine
    from ``from_state_dict`` gives the same tokens."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.optimizers import functional
    from apex_tpu_torch.utils import tree_leaves_with_path
    cfg, model, tx, state, batch, train_step = _train_setup(
        dev, seed, TRAIN_LAYERS, functional.fused_adam(lr=TRAIN_LR),
        "dynamic")
    step = train_step.make_train_step(_train_loss, tx)
    _build.reset_launch_counts()
    losses = []
    for _ in range(HANDOFF_STEPS):
        state, loss = step(state, batch)
        losses.append(loss.item())
    train_launches = _build.launch_counts()
    print(f"optim handoff: trained {TRAIN_LAYERS} layers {HANDOFF_STEPS} "
          f"steps (fused_adam, dynamic loss scale): losses "
          f"{[round(x, 4) for x in losses]}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"handoff training: the loss did not fall "
                             f"{losses}")
    geometry = dict(slots=8, max_seq=4096, page_size=64, num_pages=512,
                    device=dev)
    t0 = time.perf_counter()
    engine = InferenceEngine.from_train_state("llama", cfg, state,
                                              **geometry)
    torch.cuda.synchronize()
    print(f"  InferenceEngine.from_train_state in "
          f"{time.perf_counter() - t0:.2f} s")
    # free the training state but the master (for from_state_dict) and
    # the model (its template)
    master = state.opt.master
    for p in model.parameters():
        p.grad = None
    del state, step
    torch.cuda.empty_cache()
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
    served = _serve(engine, prompts, "handoff serve")
    missing = [k for k in HANDOFF_SERVE_KERNELS if served["launches"][k] <= 0]
    if missing:
        raise AssertionError(f"the handoff serve launched no {missing}")
    worst = 0.0
    for idx in (0, len(prompts) - 1):
        _, d, _ = _check_logits(f"handoff request {idx}", engine,
                                prompts[idx], served["outs"][idx],
                                TOL_LOGITS)
        worst = max(worst, d)
    other = InferenceEngine.from_state_dict("llama", cfg, {"master": master},
                                            model, **geometry)
    same = all(torch.equal(a, b) for (_, a), (_, b) in zip(
        tree_leaves_with_path(engine.params),
        tree_leaves_with_path(other.params)))
    outs = other.generate(prompts, max_new_tokens=NEW_TOKENS)
    print(f"  from_state_dict engine: weights equal {same}, greedy tokens "
          f"equal {outs == served['outs']}")
    if not same or outs != served["outs"]:
        raise AssertionError("from_state_dict gave another engine than "
                             "from_train_state")
    del engine, other, master, model
    torch.cuda.empty_cache()
    launches = dict(train_launches)
    _add_counts(launches, served["launches"])
    return dict(launches=launches, ttft_mean_s=served["ttft_mean_s"],
                decode_tokens_per_s=served["decode_tokens_per_s"],
                peak_bytes=served["peak_bytes"], logit_err=worst)


def phase_optim(dev, seed: int):
    """Apex's optimizer classes on the card (see the module docstring,
    phase 10); returns the launch counts of the phase's paths by kernel
    and its records."""
    from apex_tpu_torch.optimizers import functional
    launches: dict = {}
    with _plain_updates_refused():
        twin = _twin_loop(dev, seed)
        _add_counts(launches, twin["launches"])
        func = _train_run(dev, seed, "adam, no loss scale (beside the twin)",
                          functional.fused_adam(lr=TRAIN_LR), TRAIN_LAYERS,
                          TRAIN_STEPS, None, ("fused_adam",))
        print(f"optim: twin Adam step {twin['step_s']:.4f} s, peak "
              f"{twin['peak_bytes'] / 2**30:.2f} GiB; functional step "
              f"{func['step_s']:.4f} s, peak "
              f"{func['peak_bytes'] / 2**30:.2f} GiB (no loss scale; "
              f"{TRAIN_LAYERS} layers, {TRAIN_SEQ} tokens; {_smi()})")
        _twin_against_functional(dev, seed)
        for counts in _other_twins(dev, seed).values():
            _add_counts(launches, counts)
        _add_counts(launches, _tree_lamb(dev, seed))
        handoff = _handoff(dev, seed)
        _add_counts(launches, handoff["launches"])
    return dict(launches=launches, twin=twin, functional=func,
                handoff=handoff)


def _library_of(csrc: Path, build_dir: Path, signatures=None):
    """The kernel library built from another copy of the kernel sources
    (``csrc``) into ``build_dir``, its entries typed by ``signatures``
    (that copy's ``_build._SIGNATURES``); the current library is left as
    it was."""
    from apex_tpu_torch.ops import _build
    saved = (_build.CSRC, _build.BUILD_DIR, _build._LIB, _build._SIGNATURES)
    _build.CSRC, _build.BUILD_DIR, _build._LIB = csrc, build_dir, None
    _build._SIGNATURES = signatures or saved[3]
    try:
        return _build.library()
    finally:
        (_build.CSRC, _build.BUILD_DIR, _build._LIB,
         _build._SIGNATURES) = saved


def _baseline_module(baseline: Path, name: str):
    """``apex_tpu_torch/ops/<name>.py`` of another checkout, loaded under
    a name of its own (it imports the rest from this tree's package)."""
    import importlib.util
    path = baseline / "apex_tpu_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"_ab_baseline_{name}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Version(NamedTuple):
    """One side of an A/B: its kernel library and the wrapper functions
    it swaps into this tree's modules (``(module, name, function)``:
    the wrappers whose C entries differ between the versions)."""
    lib: object
    patches: tuple = ()


@contextlib.contextmanager
def _as_version(version: _Version):
    from apex_tpu_torch.ops import _build
    saved = [(m, n, getattr(m, n)) for m, n, _ in version.patches]
    own = _build._LIB
    _build._LIB = version.lib
    for m, n, f in version.patches:
        setattr(m, n, f)
    try:
        yield
    finally:
        _build._LIB = own
        for m, n, f in saved:
            setattr(m, n, f)


def _ab(versions, fn, turns: str = "ABBA"):
    """``fn()`` (a time) under each version in turn, A B B A; the mean
    of each version's two turns."""
    got = {"A": [], "B": []}
    for turn in turns:
        with _as_version(versions[turn]):
            got[turn].append(fn())
    return {t: float(np.mean(v)) for t, v in got.items()}, got


def _turns(each):
    return [round(x, 5) for x in each["A"][:1] + each["B"] + each["A"][1:]]


AB_ROWS = ("flash", "paged", "norm", "steps", "masked", "fused")


def phase_ab(dev, seed: int, baseline: Path, rows=AB_ROWS):
    """A/B of the kernels against another version of the kernel sources
    (``baseline``, the root of a checkout holding ``apex_tpu_torch``), in
    one process on one card: each version built into a library of its
    own and swapped in turn, A (baseline) B (this tree) B A, with the
    baseline's paged-decode and norm-backward wrappers while its
    library is in (their C entries changed in this tree).  ``rows``:
    ``flash`` times #3 (the forward, ``_fwd``) at causal [1, 32, 128,
    128], [1, 32, 2048, 128] and [1, 32, 8192, 128], #4 (``_bwd``, the
    row's time: delta, dq scratch, kernel, cast) at 2048, #5 (the split
    dq kernel) and #6 (the split dk/dv kernel) at 8192; ``paged`` #7 at
    the kernels phase's lengths and at the serve's (8 slots, window
    4096, lengths 160..2080); ``norm`` #2 at [2048, 4096] and [8192,
    4096] bf16 with an fp32 weight, RMSNorm and LayerNorm; ``steps``
    the unfused 8-slot Llama-3-8B decode step (sixteen turns, median of
    8 a turn) and three 4-layer Adam steps a turn at 2048 and at 8192
    tokens (eight turns, median a turn); ``masked`` #3m at its three
    shapes and ``decode_attention``'s whole kernel branch at Llama-3-8B's
    dense decode (with each version's peak memory rise); ``fused`` #8
    and #8g for one layer each with their phase clocks, the fused GPT-3
    1.3B decode step and the dense Llama-3-8B decode step at 8192
    positions.  Each row's two versions are held against each other
    (and against the plain version) before they are timed.  The
    baseline's own wrappers stand in for this tree's where their C
    entries differ (paged decode, the norm backward, the masked forward
    and the decode branch)."""
    from apex_tpu_torch.ops import _build
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    t0 = time.perf_counter()
    base_pa = _baseline_module(baseline, "paged_attention")
    base_ln = _baseline_module(baseline, "layer_norm")
    base_attn = _baseline_module(baseline, "attention")
    models = importlib.import_module("apex_tpu_torch.inference.models")
    # the baseline's masked forward and decode branch, where it has them
    attn_patches = tuple(
        (mod, name, getattr(base_attn, name))
        for mod, name in ((attn, "_fwd"), (attn, "decode_attention"),
                          (models, "decode_attention"))
        if hasattr(base_attn, name))
    versions = {
        "A": _Version(
            _library_of(baseline / "apex_tpu_torch" / "csrc",
                        _build.BUILD_DIR.parent / "ab_baseline",
                        _baseline_module(baseline, "_build")._SIGNATURES),
            ((pa, "_kernel_call", base_pa._kernel_call),
             (ln, "_bwd_2d", base_ln._bwd_2d)) + attn_patches),
        "B": _Version(_build.library())}
    print(f"ab: baseline {baseline} built in "
          f"{time.perf_counter() - t0:.1f} s; A = baseline, B = this tree, "
          f"on {_smi()}")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)
    bf = torch.bfloat16
    flash_rows = ((128, "flash_attention"),
                  (TRAIN_SEQ, "flash_attention"),
                  (SPLIT_SEQ, "flash_attention"),
                  (TRAIN_SEQ, "flash_attention_bwd"),
                  (SPLIT_SEQ, "flash_attention_bwd_dq"),
                  (SPLIT_SEQ, "flash_attention_bwd_dkv"))
    for s, name in flash_rows if "flash" in rows else ():
        h, d = 32, 128
        q3, k3, v3, do3 = (torch.randn(h, s, d, generator=gen, device=dev)
                           .to(bf) for _ in range(4))
        scale = d ** -0.5
        out, lse = attn._fwd(q3, k3, v3, True, scale)
        delta = attn._delta(out, do3)
        call = {
            "flash_attention": lambda: attn._fwd(q3, k3, v3, True, scale),
            "flash_attention_bwd": lambda: attn._bwd(q3, k3, v3, out, lse,
                                                     do3, True, scale),
            "flash_attention_bwd_dq": lambda: (attn._dq_kernel(
                q3, k3, v3, lse, delta, do3, True, scale),),
            "flash_attention_bwd_dkv": lambda: attn._dkv_kernel(
                q3, k3, v3, lse, delta, do3, True, scale)}[name]
        # both versions against each other first: the forward's out and
        # lse within the kernel limits, the backward's outputs within the
        # flash backward's relative L2 (their fp32 sums run in another
        # order)
        got = {}
        for turn in "AB":
            with _as_version(versions[turn]):
                got[turn] = call()
        torch.cuda.synchronize()
        if name == "flash_attention":
            err = [(got["A"][0].float() - got["B"][0].float()).abs().max()
                   .item(), (got["A"][1] - got["B"][1]).abs().max().item()]
            print(f"  {name} causal [1, {h}, {s}, {d}]: B against A max|diff| "
                  f"out {err[0]:.3e}, lse {err[1]:.3e}")
            if err[0] > TOL_ATTN_OUT or err[1] > TOL_ATTN_LSE:
                raise AssertionError(f"ab: {name} differs between the "
                                     f"versions")
        else:
            rel = [((a_.float() - b2.float()).norm()
                    / a_.float().norm()).item()
                   for a_, b2 in zip(got["A"], got["B"])]
            print(f"  {name} causal [1, {h}, {s}, {d}]: B against A "
                  f"relative L2 {[f'{r:.3e}' for r in rel]}")
            if max(rel) > TOL_FLASH_BWD_REL_L2:
                raise AssertionError(f"ab: {name} differs between the "
                                     f"versions")
        del got
        iters = {128: 48, TRAIN_SEQ: 10}.get(s, 4)
        mean, each = _ab(versions, lambda: _time_ms(call, iters))
        print(f"  {name} causal [1, {h}, {s}, {d}]: A {mean['A']:.4f} ms, "
              f"B {mean['B']:.4f} ms (turns A B B A: {_turns(each)})")
        del q3, k3, v3, do3, out, lse, delta, call
        torch.cuda.empty_cache()
    if "paged" in rows:
        _ab_paged(dev, gen, versions)
    if "norm" in rows:
        _ab_norm(dev, gen, versions)
    if "masked" in rows:
        _ab_masked(dev, gen, versions)
    if "fused" in rows:
        _ab_fused(dev, seed, gen, versions)
    if "steps" not in rows:
        return
    _ab_decode_step(dev, seed, versions)
    for seq in (TRAIN_SEQ, SPLIT_SEQ):
        cfg, model, tx, state, batch, train_step = _train_setup(
            dev, seed, TRAIN_LAYERS, None, "dynamic", seq)
        step = train_step.make_train_step(_train_loss, tx)
        box = {"state": step(state, batch)[0]}
        del state

        def steps():
            times = []
            for _ in range(3):
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                box["state"], _ = step(box["state"], batch)
                torch.cuda.synchronize()
                times.append(time.perf_counter() - t1)
            return float(np.median(times))

        mean, each = _ab(versions, steps, "ABBAABBA")
        print(f"  adam step, {TRAIN_LAYERS} layers, {seq} tokens: A "
              f"{mean['A']:.4f} s, B {mean['B']:.4f} s (turns A B B A A B "
              f"B A, medians of 3 steps: A "
              f"{[round(x, 5) for x in each['A']]}, B "
              f"{[round(x, 5) for x in each['B']]})")
        del model, box, step, batch
        torch.cuda.empty_cache()


def _paged_table(dev, gen, lengths_l, ps: int, mpps: int):
    """A page table for the lengths over a pool of ``len(lengths) *
    mpps`` pages (and the trash page after them), pages shuffled."""
    slots = len(lengths_l)
    n_pages = slots * mpps
    perm = torch.randperm(n_pages, generator=gen, device=dev).to(torch.int32)
    table = torch.full((slots, mpps), n_pages, dtype=torch.int32, device=dev)
    cursor = 0
    for i, n in enumerate(lengths_l):
        need = min(-(-n // ps), mpps)
        table[i, :need] = perm[cursor:cursor + need]
        cursor += need
    return table, torch.tensor(lengths_l, dtype=torch.int32, device=dev)


def _ab_paged(dev, gen, versions):
    """#7 A/B: 8 slots of a 32-layer pool (page 64, window 4096), timed
    over 4 layers in turn as the kernels phase times it, at the kernels
    phase's lengths and at the serve's (each prompt plus its 32 new
    tokens)."""
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    bf = torch.bfloat16
    slots, layers, h, kvh, ps, mpps, d = 8, 32, 32, 8, 64, 64, 128
    scale = d ** -0.5
    shape = (slots * mpps + 1, layers, kvh, ps, d)
    pool_k = torch.randn(shape, generator=gen, device=dev).to(bf)
    pool_v = torch.randn(shape, generator=gen, device=dev).to(bf)
    qd = torch.randn(slots, h, d, generator=gen, device=dev).to(bf)
    views = [(pool_k[:, i], pool_v[:, i]) for i in range(4)]
    for label, lengths_l in (
            ("kernels-phase lengths", [0, 1, 64, 65, 1500, 2048, 3000,
                                       4096]),
            ("serve lengths", [n + NEW_TOKENS for n in PROMPT_LENS])):
        table, lengths = _paged_table(dev, gen, lengths_l, ps, mpps)

        def call(kp, vp):
            return pa.paged_decode_attention(qd, kp, vp, table, lengths)

        got = {}
        for turn in "AB":
            with _as_version(versions[turn]):
                got[turn] = call(*views[0])
        ref = pa.paged_decode_reference(qd, *views[0], table, lengths, scale)
        errs = [_slot_rel(got[t], ref) for t in "AB"]
        ab_err = (got["A"].float() - got["B"].float()).abs().max().item()
        print(f"  paged_decode_attention 8 slots, {label} {lengths_l}: "
              f"against the plain version max|diff| / the slot's max|ref| "
              f"A {errs[0]:.3e}, B {errs[1]:.3e}; B against A max|diff| "
              f"{ab_err:.3e}")
        if max(errs) > TOL_PAGED_OUT:
            raise AssertionError(f"ab: paged decode ({label}) is off its "
                                 f"plain version")
        live = sum(lengths_l)
        bound, by = _bound(live * kvh * d * 2 * 2 + 2 * qd.numel() * 2
                           + table.numel() * 4 + slots * 4,
                           4 * live * h * d)
        cyc = itertools.cycle(views)
        mean, each = _ab(versions, lambda: _time_ms(
            lambda: call(*next(cyc)), 48))
        print(f"  paged_decode_attention 8 slots, {label}: A "
              f"{mean['A']:.5f} ms, B {mean['B']:.5f} ms, bound "
              f"{bound:.5f} ms ({by}) (turns A B B A: {_turns(each)})")
        # the wrapper's host cost with it: eager calls, as a decode step
        # makes them
        mean, each = _ab(versions, lambda: _eager_ms(
            lambda: call(*next(cyc)), 50))
        print(f"  paged_decode_attention 8 slots, {label}, eager calls "
              f"(host included): A {mean['A']:.5f} ms, B {mean['B']:.5f} "
              f"ms (turns A B B A: {_turns(each)})")
    del pool_k, pool_v, views
    torch.cuda.empty_cache()


def _ab_norm(dev, gen, versions):
    """#2 A/B at [2048, 4096] and [8192, 4096] (the two training steps'
    rows) bf16 with an fp32 weight, RMSNorm and LayerNorm: one input
    timed again and again (as the kernels phase times it; at 2048 rows
    x and dy, 33.5 MB, stay in the 50 MB L2) and three inputs in turn
    (read from device memory as a training step does)."""
    ln = importlib.import_module("apex_tpu_torch.ops.layer_norm")
    hidden = 4096
    w = 1 + 0.1 * torch.randn(hidden, generator=gen, device=dev)
    for rows in (TRAIN_SEQ, SPLIT_SEQ):
        _ab_norm_rows(ln, dev, gen, versions, rows, w)


def _ab_norm_rows(ln, dev, gen, versions, rows, w):
    hidden = w.numel()
    shape = f"[{rows}, {hidden}]"
    ins = [(torch.randn(rows, hidden, generator=gen, device=dev)
            .to(torch.bfloat16),
            torch.randn(rows, hidden, generator=gen, device=dev)
            .to(torch.bfloat16)) for _ in range(3)]
    bound, by = _bound(3 * rows * hidden * 2 + 2 * hidden * 4,
                       10 * rows * hidden, FP32_FLOPS_PER_S)
    for rms in (True, False):
        label = "rms_norm" if rms else "layer_norm"
        x, dy = ins[0]
        got = {}
        for turn in "AB":
            with _as_version(versions[turn]):
                got[turn] = ln._bwd_2d(x, w, dy, 1e-5, rms)
        ref = ln._bwd_reference(x, w, dy, 1e-5, rms)
        for t in "AB":
            dx, dw, db = got[t]
            errs = [(dx.float() - ref[0].float()).abs().max().item()
                    / ref[0].float().abs().max().item(),
                    (dw - ref[1]).abs().max().item()
                    / ref[1].abs().max().item()]
            if not rms:
                errs.append((db - ref[2]).abs().max().item()
                            / ref[2].abs().max().item())
            print(f"  {label} bwd {shape} {t}: against the plain "
                  f"version max|diff| / max|ref| dx, dw(, db) "
                  f"{[f'{e:.3e}' for e in errs]}")
            if errs[0] > TOL_RMS_REL or max(errs[1:]) > TOL_NORM_DW_REL:
                raise AssertionError(f"ab: {label} bwd ({t}) is off its "
                                     f"plain version")
        del got, ref
        for how, fn in (
                ("one input", lambda: ln._bwd_2d(x, w, dy, 1e-5, rms)),
                ("3 inputs in turn", lambda: ln._bwd_2d(
                    *next(cyc_in), 1e-5, rms))):
            cyc_in = itertools.cycle([(a, w, b) for a, b in ins])
            mean, each = _ab(versions, lambda: _time_ms(fn, 48))
            print(f"  {label} bwd {shape} bf16, fp32 weight, {how}: A "
                  f"{mean['A']:.5f} ms, B {mean['B']:.5f} ms, bound "
                  f"{bound:.5f} ms ({by}) (turns A B B A: {_turns(each)})")
    del ins
    torch.cuda.empty_cache()


def _ab_decode_step(dev, seed: int, versions):
    """The unfused 8-slot Llama-3-8B decode step (32 layers, the serve's
    prompts prefilled once): each version's step must launch #7 once per
    layer."""
    from apex_tpu_torch.inference import InferenceEngine
    from apex_tpu_torch.transformer.testing import LlamaConfig
    cfg = LlamaConfig(**FULL_CFG)
    engine = InferenceEngine("llama", cfg, _random_llama(cfg, dev, seed),
                             slots=8, max_seq=4096, page_size=64,
                             num_pages=512, device=dev)
    _ab_steps("unfused decode step, 8 slots, Llama-3-8B", engine,
              PROMPT_LENS, seed, versions, "paged_attention")
    del engine
    torch.cuda.empty_cache()


def _ab_steps(label, engine, prompt_lens, seed: int, versions,
              kernel: str):
    """A decode step of ``engine`` (prompts of ``prompt_lens`` prefilled
    once), eight steps a turn, sixteen turns A B B A A B B A ...: the
    mean of a version's turn medians and the median of all its steps;
    each version's step must launch ``kernel`` once per layer."""
    from apex_tpu_torch.ops import _build
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, engine.cfg.vocab_size, size=n).tolist()
               for n in prompt_lens]
    cache = engine.init_cache()
    alloc = engine.new_allocator() if engine.paged else None
    last = np.zeros((engine.slots,), np.int32)
    for slot, p in enumerate(prompts):
        kw = {}
        if alloc is not None:
            kw["pages"] = alloc.acquire(alloc.pages_needed(len(p) + 256))
        cache, tok, _ = engine.prefill(cache, p, slot, **kw)
        last[slot] = int(tok)
    state = {"cache": cache, "last": last}
    layers = engine.cfg.num_layers

    def step():
        c, nxt, _, _ = engine.decode(state["cache"], state["last"])
        state["cache"], state["last"] = c, nxt.numpy()

    for turn in "AB":
        with _as_version(versions[turn]):
            _build.reset_launch_counts()
            step()
            n = _build.launch_counts()[kernel]
            for _ in range(4):              # warm-up off the clock
                step()
        if n != layers:
            raise AssertionError(f"ab: {label} ({turn}) launched {kernel} "
                                 f"{n} times")

    # the step is host-bound and its host time drifts: four rounds of
    # turns, each turn's median, and the median of every step
    every = {"A": [], "B": []}

    def steps():
        times = []
        for _ in range(8):
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t1) * 1e3)
        every["B" if _build._LIB is versions["B"].lib else "A"] += times
        return float(np.median(times))

    mean, each = _ab(versions, steps, "ABBA" * 4)
    print(f"  {label}: A {mean['A']:.3f} ms, B {mean['B']:.3f} ms (mean of "
          f"8 turn medians of 8 steps; median of all 64 steps A "
          f"{np.median(every['A']):.3f}, B {np.median(every['B']):.3f}; "
          f"{engine.slots / np.median(every['A']) * 1e3:.1f} / "
          f"{engine.slots / np.median(every['B']) * 1e3:.1f} decode "
          f"tokens/s; turns A {[round(x, 3) for x in each['A']]}, B "
          f"{[round(x, 3) for x in each['B']]})")
    del state, cache


def _ab_masked(dev, gen, versions):
    """#3m A/B at its three shapes (``_fwd`` on the mask3; the baseline's
    own ``_fwd`` while its library is in), then ``decode_attention``'s
    whole kernel branch at Llama-3-8B's dense decode: the baseline's
    broadcast, mask and kernel against this tree's decode kernel, with
    each version's peak memory rise over one call."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    for (label, q, k, v, mask, causal, iters, nbytes,
         flops) in _masked_shapes(dev, gen):
        b, h, sq, d = q.shape
        sk = k.shape[2]
        mask3 = attn._mask3(mask, b, h, sq, sk)
        q3, k3, v3 = (t.reshape(b * h, -1, d).contiguous()
                      for t in (q, k, v))
        scale = d ** -0.5

        def call():
            return attn._fwd(q3, k3, v3, causal, scale, mask3=mask3)

        got = {}
        for turn in "AB":
            with _as_version(versions[turn]):
                got[turn] = call()
        ref, _ = attn._fwd_reference(q3, k3, v3, causal, scale, mask3=mask3)
        rows = (lambda t: t.reshape(-1, d))
        errs = [_slot_rel(rows(got[t][0]), rows(ref)) for t in "AB"]
        lse_err = (got["A"][1] - got["B"][1]).abs().max().item()
        print(f"  flash_attention masked {label} [{b}, {h}, {sq}, {sk}]: "
              f"against the plain version, each row's max|diff| / max|ref| "
              f"A {errs[0]:.3e}, B {errs[1]:.3e}; B against A lse "
              f"{lse_err:.3e}")
        if max(errs) > TOL_PAGED_OUT or lse_err > TOL_ATTN_LSE:
            raise AssertionError(f"ab: masked flash ({label}) is off")
        del got, ref
        bound, by = _bound(nbytes, flops)
        mean, each = _ab(versions, lambda: _time_ms(call, iters))
        print(f"  flash_attention masked {label}: A {mean['A']:.4f} ms, B "
              f"{mean['B']:.4f} ms, bound {bound:.4f} ms ({by}) (turns A B "
              f"B A: {_turns(each)})")
        del q, k, v, mask, mask3, q3, k3, v3
    torch.cuda.empty_cache()
    q, k, v, lengths, nbytes, flops = _decode_case(dev, gen)
    b, h, _, d = q.shape
    kvh = k.shape[1]

    def branch():
        return attn.decode_attention(q, k, v, lengths, use_kernel=True)

    ref = attn._decode_reference(q.reshape(b, kvh, h // kvh, d), k, v,
                                 lengths, d ** -0.5)
    for turn in "AB":
        with _as_version(versions[turn]):
            branch()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            start = torch.cuda.memory_allocated()
            got = branch()
            torch.cuda.synchronize()
            rise = torch.cuda.max_memory_allocated() - start
        rel = _slot_rel(got.reshape(-1, d), ref.reshape(-1, d))
        print(f"  decode_attention kernel branch [{b}, {h}, 1, "
              f"{k.shape[2]}] ({turn}): each row's max|diff| / max|ref| "
              f"{rel:.3e}; peak memory rise over the call "
              f"{rise / 2 ** 20:.2f} MiB")
        if rel > TOL_PAGED_OUT:
            raise AssertionError(f"ab: the decode branch ({turn}) is off")
    bound, by = _bound(nbytes, flops)
    mean, each = _ab(versions, lambda: _time_ms(branch, 20))
    print(f"  decode_attention kernel branch: A {mean['A']:.4f} ms, B "
          f"{mean['B']:.4f} ms, bound {bound:.4f} ms ({by}: the cache's live "
          f"k/v) (turns A B B A: {_turns(each)})")
    del q, k, v, ref, got
    torch.cuda.empty_cache()


def _ab_fused(dev, seed: int, gen, versions):
    """#8 and #8g A/B: one Llama-3-8B layer over a 4-layer pool (8 slots,
    lengths 0..4096, page 64) and one GPT-3 1.3B layer (lengths 0..2048),
    each version against the plain version, its time over the 4 layers
    in turn (40 eager calls) and its phase clock; then the fused GPT-3
    1.3B decode step and the dense Llama-3-8B decode step at 8192
    positions (:func:`_ab_steps`)."""
    from apex_tpu_torch.inference import InferenceEngine, models
    from apex_tpu_torch.transformer.testing import GPTConfig, LlamaConfig
    from apex_tpu_torch.transformer.testing.standalone_llama import (
        _rope_cos_sin)
    pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")
    bf = torch.bfloat16
    slots, ps, layers = 8, 64, 4
    for kind in ("llama", "gpt"):
        if kind == "llama":
            cfg = LlamaConfig(**dict(FULL_CFG, num_layers=1))
            tree = {"layer_0": _random_llama(cfg, dev, seed, only="layer_0")[
                "layer_0"]}
            lengths_l, mpps = [0, 1, 64, 65, 1500, 2048, 3000, 4096], 64
            kvh, d = cfg.num_kv_heads, cfg.hidden_size // \
                cfg.num_attention_heads
            phases = FUSED_PHASES
        else:
            cfg = GPTConfig(**dict(GPT_CFG, num_layers=1))
            tree = _random_gpt(cfg, dev, seed + 10)
            lengths_l, mpps = [0, 1, 64, 65, 700, 1024, 1500, 2048], 32
            kvh, d = cfg.num_attention_heads, 128
            phases = GPT_FUSED_PHASES
        blk = models.fused_layer_params(kind, cfg, tree)[0]
        del tree
        table, lengths = _paged_table(dev, gen, lengths_l, ps, mpps)
        shape = (slots * mpps + 1, layers, kvh, ps, d)
        pool_k = torch.randn(shape, generator=gen, device=dev).to(bf)
        pool_v = torch.randn(shape, generator=gen, device=dev).to(bf)
        x = torch.randn(slots, cfg.hidden_size, generator=gen,
                        device=dev).to(bf)
        kw = dict(kind=kind, eps=1e-5)
        cos = sin = None
        if kind == "llama":
            window = mpps * ps
            cos_t, sin_t = _rope_cos_sin(window, d, cfg.rope_theta,
                                         device=dev)
            pos = torch.clamp(lengths.long(), max=window - 1)
            cos = cos_t.reshape(window, d)[pos]
            sin = sin_t.reshape(window, d)[pos]
            kw.update(cos=cos, sin=sin, eps=cfg.rms_eps)
        views = [(pool_k[:, i], pool_v[:, i]) for i in range(layers)]
        ref = pa.fused_block_reference(x, blk, *views[0], table, lengths,
                                       **kw)
        for turn in "AB":
            with _as_version(versions[turn]):
                got = pa.fused_block_decode(x, blk, *views[0], table,
                                            lengths, **kw)
            rel = max(((g.float() - r.float()).norm() / r.float().norm())
                      .item() for g, r in zip(got, ref))
            err = max((g.float() - r.float()).abs().max().item()
                      / r.float().abs().max().item()
                      for g, r in zip(got, ref))
            print(f"  fused_block_decode {kind} ({turn}) against the plain "
                  f"version: max|diff| / max|ref| {err:.3e}, relative L2 "
                  f"{rel:.3e}")
            if err > TOL_FUSED_REL or rel > TOL_FUSED_REL_L2:
                raise AssertionError(f"ab: fused {kind} ({turn}) is off")
        del ref, got
        cyc = itertools.cycle(views)
        for how, timer in (("queued", _queued_ms), ("eager", _eager_ms)):
            mean, each = _ab(versions, lambda: timer(
                lambda: pa.fused_block_decode(x, blk, *next(cyc), table,
                                              lengths, **kw), 40))
            print(f"  fused_block_decode {kind}, one layer, {how}: A "
                  f"{mean['A']:.4f} ms, B {mean['B']:.4f} ms (40 calls a "
                  f"turn over 4 layers; turns A B B A: {_turns(each)})")
        geo = pa._fused_geometry(x, blk, *views[0], table, lengths, kind,
                                 cos, sin, False)
        # room for either version's clock: a version writes its start,
        # its phases' ends and its end, and leaves the rest 0
        clock = torch.zeros(16, dtype=torch.int64, device=dev)
        for turn in "AB":
            with _as_version(versions[turn]):
                runs = []
                for _ in range(10):
                    clock.zero_()
                    pa._fused_kernel_call(x, blk, *views[0], table, lengths,
                                          cos, sin, kw["eps"], d ** -0.5,
                                          True, *geo, clock=clock,
                                          kind=kind)
                    t = np.asarray(clock.tolist(), np.int64)
                    runs.append(np.diff(t[:int(np.count_nonzero(t))]) / 1e3)
            us = np.median(np.stack(runs), axis=0)
            names = phases if len(us) == len(phases) else [
                f"phase {i + 1}" for i in range(len(us))]
            print(f"  fused_block_decode {kind} phases ({turn}, median of 10 "
                  f"launches, {us.sum():.1f} us in all): " + ", ".join(
                      f"{n} {t:.1f} us" for n, t in zip(names, us)))
        del blk, pool_k, pool_v, views, x
        torch.cuda.empty_cache()
    gcfg = GPTConfig(**GPT_CFG)
    engine = InferenceEngine("gpt", gcfg, _random_gpt(gcfg, dev, seed + 10),
                             slots=8, max_seq=gcfg.max_seq_length,
                             page_size=64, decode_fusion="1", device=dev)
    _ab_steps("fused decode step, 8 slots, GPT-3 1.3B", engine,
              GPT_PROMPT_LENS, seed + 10, versions, "fused_block_decode_gpt")
    del engine
    torch.cuda.empty_cache()
    lcfg = LlamaConfig(**FULL_CFG)
    engine = InferenceEngine("llama", lcfg, _random_llama(lcfg, dev, seed),
                             slots=8, max_seq=DENSE_MAX_SEQ, device=dev)
    _ab_steps("dense decode step, 8 slots at 8192 positions, Llama-3-8B",
              engine, PROMPT_LENS, seed, versions, "flash_attention_masked")
    del engine
    torch.cuda.empty_cache()


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
                    default="kernels,serve,gpt,bert,profile,train,optim,"
                            "train-check,shim",
                    help="comma list of kernels, serve, gpt, bert, profile, "
                         "train, optim, train-check, shim, ab (build always "
                         "runs; profile profiles the serve and the train "
                         "phases that run)")
    ap.add_argument("--baseline", type=Path, default=None,
                    help="root of a checkout of another version: with the "
                         "ab phase, time its kernels and this tree's, A/B "
                         "in this process")
    ap.add_argument("--ab-rows", default=",".join(AB_ROWS),
                    help=f"comma list of the ab phase's rows, of "
                         f"{', '.join(AB_ROWS)}")
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
            if key in SERVE_KERNELS + ("flash_attention_masked",):
                r["launches"] = served["launches"][key]
        del served
        torch.cuda.empty_cache()
    if "gpt" in phases:
        gpt = phase_gpt(dev, args.seed)
        if "fused_block_decode_gpt" in recs:
            recs["fused_block_decode_gpt"]["launches"] = gpt["launches"][
                "fused_block_decode_gpt"]
        del gpt
    if "bert" in phases:
        phase_bert(dev, args.seed)
    if "train" in phases:
        runs = phase_train(dev, args.seed, "profile" in phases)
        for key, r in recs.items():
            if key not in SERVE_KERNELS + SHIM_KERNELS + SERVE_ONLY:
                r["launches"] = runs[KERNEL_RUN.get(key, "adam")][
                    "launches"][key]
    if "optim" in phases:
        optim = phase_optim(dev, args.seed)
        for key, r in recs.items():
            r["launches"] = (r.get("launches") or 0) + optim["launches"].get(
                key, 0)
        del optim
        torch.cuda.empty_cache()
    if "train-check" in phases:
        phase_train_check(dev, args.seed)
        phase_split_check(dev, args.seed)
        phase_rule_check(dev, args.seed)
    if "ab" in phases:
        if args.baseline is None:
            raise SystemExit("the ab phase needs --baseline")
        phase_ab(dev, args.seed, args.baseline.resolve(),
                 tuple(args.ab_rows.split(",")))
    if "shim" in phases:
        shim = phase_shim(dev, args.seed)
        for key in SHIM_KERNELS:
            if key in recs:
                recs[key]["launches"] = shim["launches"][key]
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
