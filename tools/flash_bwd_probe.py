"""Phase clock and ablations of the one-pass flash backward's mask and
dropout kernel (``apex_tpu_torch/csrc/flash_kmajor_ws.cuh``, #4d and
#4md) on the card.

Each probe is an edited copy of the kernel sources, built under
``build/probe_<name>/`` into a library of its own (the repo's sources
are never touched), and timed beside the unedited library at the
training paths' shapes (``chip_smoke._md_shapes``, dropout 0.1), each
call through ``_bwd`` as the training step makes it, twice in turn:

- ``clock``: SM clock cycles of each phase of a 64-query step, summed
  over the steps of block 0 (the first key block of the first
  batch-head) for the first thread of each product warpgroup, written
  over the first elements of that thread's first dk row;
- ``nohash``: every keep bit 1 (the hash's share; drops nothing, so its
  numbers are wrong);
- ``noexp``: p = s * scale_log2 - lse without the ex2 (the special
  function unit's share; wrong numbers);
- ``nodqwrite``: the dq partial not written to shared memory (its
  staging's share; wrong dq).

Each probe's dq, dk and dv are printed as relative L2 against the
unedited library's.  Run from the root of the repo on a machine with
the card (about two minutes, the four builds included)::

    python3 tools/flash_bwd_probe.py
"""
from __future__ import annotations

import importlib
import shutil
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from apex_tpu_torch.ops import _build  # noqa: E402

HEADER = "flash_kmajor_ws.cuh"
PHASES = ("loop", "wait full", "issue S dP", "shadow", "wait S", "softmax",
          "wait dP", "dS + stage", "issue dV dK", "dS barrier", "issue dQ",
          "wait all", "dq empty", "dq write")


def _rep(text: str, old: str, new: str) -> str:
    if text.count(old) != 1:
        raise ValueError(f"the probe's anchor is not unique in {HEADER}: "
                         f"{old[:60]!r}")
    return text.replace(old, new)


def clock(s: str) -> str:
    """Phase clocks: CLK(i) adds the cycles since the last mark to phase
    i."""
    s = _rep(s, "  for (int n = 0; n < nlive; ++n) {\n",
             "  unsigned acc_[16] = {0};\n"
             "  unsigned clk_prev = clock(), clk0 = clk_prev;\n"
             "#define CLK(i) { unsigned t_ = clock(); "
             "acc_[i] += t_ - clk_prev; clk_prev = t_; }\n"
             "  for (int n = 0; n < nlive; ++n) {\n")
    s = _rep(s, "    mbar_wait(bFull + 8 * st, (n / S) & 1);\n",
             "    CLK(0)\n    mbar_wait(bFull + 8 * st, (n / S) & 1);\n"
             "    CLK(1)\n")
    s = _rep(s, "    wgmma_commit();\n\n    // while they run",
             "    wgmma_commit();\n    CLK(2)\n\n    // while they run")
    s = _rep(s, "    wgmma_wait<1>();\n    keep(s);\n",
             "    CLK(3)\n    wgmma_wait<1>();\n    keep(s);\n    CLK(4)\n")
    s = _rep(s, "    wgmma_wait<0>();\n    keep(dp);\n",
             "    CLK(5)\n    wgmma_wait<0>();\n    keep(dp);\n    CLK(6)\n")
    s = _rep(s, "    fence_async_smem();     // dS^T, visible to wgmma\n",
             "    fence_async_smem();     // dS^T, visible to wgmma\n"
             "    CLK(7)\n")
    s = _rep(s, "    wgmma_commit();\n\n    // dQ = dS K",
             "    wgmma_commit();\n    CLK(8)\n\n    // dQ = dS K")
    for bar in ("bar_sync(1, kWsConsumers);", "bar_sync(3 + wg, 128);"):
        i = s.index(bar)
        j = s.index("\n", i) + 1
        s = s[:j] + "      CLK(9)\n" + s[j:]
    s = _rep(s, "    wgmma_commit();\n    wgmma_wait<0>();\n    keep(dqa);",
             "    wgmma_commit();\n    CLK(10)\n    wgmma_wait<0>();\n"
             "    CLK(11)\n    keep(dqa);")
    s = _rep(s, "    if (n >= 2) mbar_wait(bDqEmpty + 8 * b, "
                "((n >> 1) - 1) & 1);\n",
             "    if (n >= 2) mbar_wait(bDqEmpty + 8 * b, "
             "((n >> 1) - 1) & 1);\n    CLK(12)\n")
    s = _rep(s, "    mbar_arrive(bDqFull + 8 * (b * 2 + wg));\n  }\n",
             "    mbar_arrive(bDqFull + 8 * (b * 2 + wg));\n    CLK(13)\n"
             "    acc_[14]++;\n  }\n  acc_[15] = clock() - clk0;\n")
    tail = "            dva[j * 4 + hf * 2], dva[j * 4 + hf * 2 + 1]);\n" \
           "      }\n    }\n  }\n}\n"
    return _rep(s, tail, tail[:-2] +
                "  __syncwarp();\n"
                "  if (blockIdx.x == 0 && blockIdx.y == 0 && "
                "(tid == 0 || tid == 128)) {\n"
                "    unsigned* o_ = reinterpret_cast<unsigned*>(dk + "
                "(size_t)krow * D);\n"
                "    for (int x = 0; x < 16; ++x) o_[x] = acc_[x];\n"
                "  }\n}\n")


def nohash(s: str) -> str:
    a = s.index("    unsigned kbits = 0u;\n    if constexpr (DROP) {")
    b = s.index("    wgmma_wait<1>();\n    keep(s);\n")
    return s[:a] + "    unsigned kbits = 0xffffffffu;\n" + s[b:]


def noexp(s: str) -> str:
    a = s.index("    // P^T = exp2(S^T")
    b = s.index("    // the accumulator fragments of query columns")
    return s[:a] + s[a:b].replace("exp2_ftz(", "(") + s[b:]


def nodqwrite(s: str) -> str:
    a = s.index('        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\\n" '
                '::"r"(a),\n                     "f"(dqa[')
    b = s.index(");\n", a) + 3
    return s[:a] + s[b:]


PROBES = {"clock": clock, "nohash": nohash, "noexp": noexp,
          "nodqwrite": nodqwrite}


def _library(name: str, edit):
    out = _build.BUILD_DIR.parent / f"probe_{name}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out / "csrc")
    path = out / "csrc" / HEADER
    path.write_text(edit(path.read_text()))
    t0 = time.perf_counter()
    lib = cs._library_of(out / "csrc", out / "lib")
    log = (out / "lib" / "flash_attention_bwd_md.cu.log").read_text()
    spills = {n: b for n, _, b in cs._ptxas_instances(log) if "ws" in n}
    print(f"built {name} in {time.perf_counter() - t0:.1f} s; spill bytes "
          f"{spills}")
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("flash_bwd_probe: CUDA is not available", file=sys.stderr)
        return 2
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    dev = torch.device("cuda")
    print(cs._smi())
    libs = {"kernel": _build.library()}
    for name, edit in PROBES.items():
        libs[name] = _library(name, edit)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    seed3 = attn._seed_operand(-2 ** 31 + 12345, device=dev)
    for (tag, label, q3, k3, v3, do3, mask3, causal, _mb, _live,
         _h) in cs._md_shapes(dev, gen):
        scale = q3.shape[-1] ** -0.5
        md = dict(mask3=mask3, rate=cs.LM_DROPOUT, seed3=seed3)
        out, lse = attn._fwd(q3, k3, v3, causal, scale, **md)

        def call():
            return attn._bwd(q3, k3, v3, out, lse, do3, causal, scale, **md)

        _build._LIB = libs["kernel"]
        ref = call()
        times = {name: [] for name in libs}
        for _ in range(2):
            for name, lib in libs.items():
                _build._LIB = lib
                times[name].append(cs._time_ms(call, 10))
        for name, lib in libs.items():
            _build._LIB = lib
            got = call()
            torch.cuda.synchronize()
            rel = [cs._rel_l2(g_, r_) for g_, r_ in zip(got, ref)]
            print(f"{tag} ({label}) {name}: {np.mean(times[name]):.4f} ms "
                  f"(turns {[round(t, 4) for t in times[name]]}); dq, dk, "
                  f"dv against the kernel {[f'{r:.1e}' for r in rel]}")
            if name == "clock":
                for row in (0, 64):
                    a = got[1][0, row, :32].contiguous().view(
                        torch.int32).cpu().numpy().astype(np.int64)
                    n = max(int(a[14]), 1)
                    print(f"  warpgroup {row // 64}: {n} steps, "
                          f"{a[15] / n:.0f} cycles a step: " + ", ".join(
                              f"{p} {a[i] / n:.0f}"
                              for i, p in enumerate(PHASES)))
        _build._LIB = libs["kernel"]
        del q3, k3, v3, do3, out, lse, ref, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
