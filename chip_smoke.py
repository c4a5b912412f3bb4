#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (``apex_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

1. **Build.**  Prints the card's name and power limit, compiles the
   port's CUDA kernels from ``apex_tpu_torch/csrc`` (``nvcc``, sm_90a)
   and prints the build time and each kernel's ``ptxas`` resource line.
2. **Kernels.**  Runs each kernel of the serving path against its plain
   PyTorch version on the card, in bf16, at the shapes the main path
   gives it (RMSNorm ``[2048, 4096]``; causal flash attention
   ``[1, 32, 2048, 128]`` with k/v broadcast from 8 kv heads; paged
   decode over 8 slots of page size 64 with lengths 0..4096 in a
   32-layer pool).  Prints the max |diff| against its stated limit, the
   kernel's time, its bound (the larger of bytes over 3.35 TB/s and
   flops over 989 TFLOP/s, counted from this run's inputs), the plain
   version's time and, where one PyTorch call computes the same
   function, that call's time.
3. **Serve.**  Llama-3-8B at full width and depth (random bf16 weights
   from a seeded ``torch.Generator``) served by ``InferenceEngine`` on
   the paged pool through ``engine.generate``: 8 seeded prompts of
   128..2048 tokens, 32 new tokens each, greedy.  The kernels' launch
   counters are zeroed just before and read just after; each must be
   above 0.  Prints TTFT, decode tokens/s and peak device memory.
4. **Check.**  For two of the requests, the decode logits of an
   engine prefill + decode run are held against the port's own
   full-forward prefill of prompt + generated tokens.
5. **Profile.**  Where the serve's time goes: one 2048-token prefill
   and one 8-slot decode step, each timed on the host clock and then
   under ``torch.profiler``: wall time, the device's busy share and the
   kernels that take the most device time.

Then one ``{"kernels": [...]}`` line and, last, the
``{"ok": true, "device": {...}}`` line.  Any failed phase raises, so the
script exits non-zero and prints no result; so does a machine without
CUDA, or a directory without the ``apex_tpu_torch`` package.
"""
from __future__ import annotations

import argparse
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
#: decode-vs-full-forward logit limit for the serve check: bf16
#: activations rounded at every op of 32 layers, along two different
#: kernel/matmul paths (paged decode vs causal flash prefill)
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


def _bound(nbytes: float, flops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _check(name: str, err: float, tol: float) -> None:
    ok = err <= tol
    print(f"  {name}: max|diff| {err:.6g} (limit {tol:.6g}) "
          f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{name}: max|diff| {err} over limit {tol}")


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
    del pool_k, pool_v, kp, vp, views
    for r in recs.values():
        print(f"  {r['name']}: kernel {r['ms']:.4f} ms (eager call, host "
              f"included, {r.pop('eager_ms'):.4f} ms), bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), plain "
              f"{r['plain_ms']:.4f} ms, library {r['library_ms']}")
    torch.cuda.empty_cache()
    return recs


def _random_llama(cfg, dev, seed: int):
    """Llama-3-8B-shaped tree of random bf16 weights from a seeded
    generator: linears N(0, 1/fan_in), norms 1 + N(0, 0.1^2), the
    embedding N(0, 1)."""
    from apex_tpu_torch.inference.weights import llama_param_shapes
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    tree: dict = {}
    for path, shape in sorted(llama_param_shapes(cfg).items()):
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


def phase_serve(dev, seed: int, profile: bool = False):
    from apex_tpu_torch import observability as obs
    from apex_tpu_torch.inference import InferenceEngine, models
    from apex_tpu_torch.ops import _build
    from apex_tpu_torch.transformer.testing import LlamaConfig

    cfg = LlamaConfig(**FULL_CFG)
    t0 = time.perf_counter()
    params = _random_llama(cfg, dev, seed)
    torch.cuda.synchronize()
    print(f"serve: Llama-3-8B random bf16 weights in "
          f"{time.perf_counter() - t0:.1f} s")
    engine = InferenceEngine("llama", cfg, params, slots=8, max_seq=4096,
                             page_size=64, num_pages=512, device=dev)
    rng = np.random.RandomState(seed)
    prompts = [rng.randint(0, cfg.vocab_size, size=n).tolist()
               for n in PROMPT_LENS]
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
    print(f"serve: {len(prompts)} requests, prompts {list(PROMPT_LENS)}, "
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
    if any(not 0 <= t < cfg.vocab_size for o in outs for t in o):
        raise AssertionError("a generated token is outside the vocab")
    missing = [k for k, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f"the serve launched no {missing} kernel")

    # -- check: engine prefill + decode against the full forward --------
    n_check = 8
    worst = 0.0
    for idx in (0, len(prompts) - 1):
        prompt = prompts[idx]
        cache = engine.init_cache()
        alloc = engine.new_allocator()
        pages = alloc.acquire(alloc.pages_needed(len(prompt) + n_check))
        cache, tok, last = engine.prefill(cache, prompt, 0, pages=pages)
        dec_logits, toks = [last], [int(tok)]
        active = np.zeros((engine.slots,), bool)
        active[0] = True
        for _ in range(n_check - 1):
            feed = np.zeros((engine.slots,), np.int32)
            feed[0] = toks[-1]
            cache, nxt, logits, _ = engine.decode(cache, feed, active)
            dec_logits.append(logits[0])
            toks.append(int(nxt[0]))
        del cache
        seq = torch.tensor([prompt + toks[:-1]], dtype=torch.int32,
                           device=dev)
        with torch.no_grad():
            full, _, _ = models.prefill_forward("llama", cfg, engine.params,
                                                seq)
        ref = full[len(prompt) - 1:, 0].float()          # [n_check, v]
        got = torch.stack(dec_logits)
        if not torch.isfinite(got).all() or got.shape != ref.shape:
            raise AssertionError("decode logits not finite or misshaped")
        diff = (got - ref).abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        decided = margin > 2 * TOL_LOGITS
        agree = ref.argmax(-1).cpu() == torch.tensor(toks)
        print(f"check request {idx} (prompt {len(prompt)}): max|decode - "
              f"full| {diff:.4f} (limit {TOL_LOGITS}), tokens equal at "
              f"{int(agree.sum())}/{n_check} positions, {int(decided.sum())} "
              f"with top-2 margin > {2 * TOL_LOGITS}; engine.generate "
              f"tokens equal: {toks == outs[idx][:n_check]}")
        if diff > TOL_LOGITS:
            raise AssertionError(f"decode logits off by {diff}")
        if not bool(agree[decided.cpu()].all()):
            raise AssertionError("a token with a clear top-2 margin differs")
        worst = max(worst, diff)
        del full, ref, got
    if profile:
        _profile(engine, prompts)
    return dict(launches=launches, ttft_mean_s=ttft.sum() / ttft.count(),
                decode_tokens_per_s=decode_tokens / decode_s,
                peak_bytes=peak, logit_err=worst)


def _device_breakdown(label, fn, reps: int):
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
    for name, ms, n in sorted(rows, key=lambda r: -r[1])[:10]:
        print(f"    {ms:9.4f} ms {n:6.0f}x  {name[:90]}")


def _profile(engine, prompts):
    """Where the serve's time goes: one 2048-token cold prefill, and a
    decode step with all eight slots live."""
    cache = engine.init_cache()
    alloc = engine.new_allocator()
    last = np.zeros((engine.slots,), np.int32)
    for slot, p in enumerate(prompts[:engine.slots]):
        pages = alloc.acquire(alloc.pages_needed(len(p) + 16))
        cache, tok, _ = engine.prefill(cache, p, slot, pages=pages)
        last[slot] = int(tok)
    longest = max(prompts, key=len)
    spare = alloc.acquire(alloc.pages_needed(len(longest) + 16))
    _device_breakdown(f"prefill ({len(longest)} tokens)",
                      lambda: engine.prefill(cache, longest, 0, pages=spare),
                      3)
    state = {"cache": cache, "last": last}

    def step():
        c, nxt, _, _ = engine.decode(state["cache"], state["last"])
        state["cache"], state["last"] = c, nxt.numpy()

    step()
    _device_breakdown("decode step (8 slots)", step, 5)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--phases", default="kernels,serve,profile",
                    help="comma list of kernels,serve,profile (build "
                         "always runs; profile needs serve)")
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
            r["launches"] = served["launches"][key]
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
