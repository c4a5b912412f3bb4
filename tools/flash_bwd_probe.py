"""Phase clock and ablations of the one-pass flash backward's mask and
dropout kernel (``apex_tpu_torch/csrc/flash_kmajor_ws.cuh``, #4d and
#4md) on the card; with ``--fwd``, of the forward's dropout kernel
(``apex_tpu_torch/csrc/flash_qmajor_ws.cuh``, #3d and #3md).

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
  writes kept under a condition that never holds; the staging's share;
  wrong dq).

Each probe's dq, dk and dv are printed as relative L2 against the
unedited library's.

``--fwd`` does the same for the forward at the same shapes, each call
through ``_fwd`` (the BERT shape's pre-pass included):

- ``clock``: SM clock cycles of each phase of a 128-key step (waiting
  for the stage, waiting for the turn, issuing S and P V, the hash,
  waiting for S, the softmax, waiting for P V, the rescale and P's
  pack) and of each tile (waiting for its Q, the last P V and the
  epilogue), summed over every tile of block 0 for the first thread of
  each product warpgroup, written over the lse of block 0's first tile
  behind a marker word;
- ``nohash``: every keep bit 1 (drops nothing: wrong numbers);
- ``noexp``: p = s * scale_log2 - m without the ex2 (wrong numbers);
- ``noepilogue``: O neither staged in shared memory nor stored (its
  writes kept under a condition that never holds: a product whose
  result nothing reads is deleted by ptxas; wrong O, lse kept);
- ``noanchor``: the keep bits kept in registers instead of passing
  through the thread's shared-memory slot before the S wait (ptxas then
  moves the hash past the wait; the same numbers);
- ``prepass``: the masked instance's C entry returns after the mask
  pre-pass, so its time is the pre-pass's alone (BERT's shape only);
- ``nosort``: the masked instance walks its tiles in the causal order
  (query blocks from the last) instead of sorting them by their live key
  tiles (BERT's shape only; the same numbers);

and reads the kernel's SASS (``cuobjdump -sass``): for each instance,
the keep hash's multiplies between the issue of S and the wait on it,
against all of them.  Out and lse are printed as their largest
difference from the unedited library's.  Both modes print each build's
HGMMA count beside the unedited one's: an ablation that leaves a
product's result unread loses the product too, and then times it.

Run from the root of the repo on a machine with the card (about two
minutes a mode, the builds included)::

    python3 tools/flash_bwd_probe.py
    python3 tools/flash_bwd_probe.py --fwd
"""
from __future__ import annotations

import argparse
import importlib
import re
import shutil
import subprocess
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
FWD_HEADER = "flash_qmajor_ws.cuh"
FWD_PHASES = ("wait stage", "wait turn", "issue S PV", "hash", "wait S",
              "softmax", "wait PV", "rescale + pack", "last P V + epilogue",
              "wait Q")
#: the marker before the clock words in the lse of block 0's first tile
MAGIC = 0x7E57C10C
PHASES = ("loop", "wait full", "issue S dP", "shadow", "wait S", "softmax",
          "wait dP", "dS + stage", "issue dV dK", "dS barrier", "issue dQ",
          "wait all", "dq empty", "dq write")


def _rep(text: str, old: str, new: str, count: int = 1) -> str:
    if text.count(old) != count:
        raise ValueError(f"the probe's anchor is not found {count} times: "
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
    """The dq partial's shared-memory writes under a condition that never
    holds (dQ's product must stay: ptxas deletes a product whose result
    nothing reads)."""
    a = s.index('        asm volatile("st.shared.v2.f32 [%0], {%1, %2};\\n" '
                '::"r"(a),\n                     "f"(dqa[')
    return s[:a] + "        if (sq < 0)\n" + s[a:]


PROBES = {"clock": clock, "nohash": nohash, "noexp": noexp,
          "nodqwrite": nodqwrite}


# -- the forward (flash_qmajor_ws.cuh) -------------------------------------

def fwd_clock(s: str) -> str:
    """Phase clocks of the forward: CLK(i) adds the cycles since the last
    mark to phase i; block 0's first thread of each product warpgroup
    writes them over the lse of its first tile."""
    s = _rep(s, "  int c = 0;                        // live steps so far: the "
                "ring's place\n  for (int n = 0;; ++n) {\n"
                "    mbar_wait(bQFull, n & 1);\n",
             "  unsigned acc_[16] = {0};\n  int bh0_ = -1, q00_ = 0;\n"
             "  unsigned clk_prev = clock(), clk0 = clk_prev;\n"
             "#define CLK(i) { unsigned t_ = clock(); "
             "acc_[i] += t_ - clk_prev; clk_prev = t_; }\n"
             "  int c = 0;\n  for (int n = 0;; ++n) {\n"
             "    mbar_wait(bQFull, n & 1);\n    CLK(9)\n")
    s = _rep(s, "    if (bh < 0) break;\n    const int q0 = qb * kQmBQ,",
             "    if (bh < 0) break;\n    if (bh0_ < 0) { bh0_ = bh; "
             "q00_ = qb * kQmBQ; }\n    acc_[14]++;\n"
             "    const int q0 = qb * kQmBQ,")
    s = _rep(s, "        if (i > 0) mbar_wait(bVFull + 8 * ((c - 1) % S), "
                "((c - 1) / S) & 1);\n",
             "        if (i > 0) mbar_wait(bVFull + 8 * ((c - 1) % S), "
             "((c - 1) / S) & 1);\n        CLK(0)\n")
    s = _rep(s, "        bar_sync(kFwTurn + wg, kFwConsumers);\n"
                "        wgmma_fence();\n#pragma unroll\n        for (int ks",
             "        bar_sync(kFwTurn + wg, kFwConsumers);\n        CLK(1)\n"
             "        wgmma_fence();\n#pragma unroll\n        for (int ks")
    s = _rep(s, "          bar_arrive(kFwTurn + 1 - wg, kFwConsumers);\n"
                "          hash();\n",
             "          CLK(2)\n          bar_arrive(kFwTurn + 1 - wg, "
             "kFwConsumers);\n          hash();\n          CLK(3)\n", 2)
    s = _rep(s, "        kb_load();\n        keep(s);\n",
             "        kb_load();\n        keep(s);\n        CLK(4)\n")
    s = _rep(s, "        wgmma_wait<0>();              // P_{t-1} V_{t-1} is "
                "done: O, P free\n        keep(acc);\n        keep(pa);\n",
             "        CLK(5)\n        wgmma_wait<0>();\n        keep(acc);\n"
             "        keep(pa);\n        CLK(6)\n")
    s = _rep(s, "        if (last) break;\n      }\n",
             "        CLK(7)\n        acc_[12]++;\n        if (last) break;\n"
             "      }\n")
    s = _rep(s, "      bulk_commit();\n    }\n  }\n",
             "      bulk_commit();\n    }\n    CLK(8)\n  }\n"
             "  acc_[13] = clock() - clk0;\n"
             "  if (blockIdx.x == 0 && (tid & 127) == 0 && bh0_ >= 0) {\n"
             "    unsigned* o_ = reinterpret_cast<unsigned*>(lse_out + "
             "(size_t)bh0_ * p.sq + q00_ + wg * 64);\n"
             f"    o_[0] = {MAGIC}u;\n"
             "    for (int x = 0; x < 15; ++x) o_[1 + x] = acc_[x];\n"
             "  }\n")
    return s


def fwd_nohash(s: str) -> str:
    a = s.index("        auto kb_load = [&]() {\n")
    b = s.index("        // this warpgroup's turn: S_t")
    return s[:a] + ("        auto kb_load = [&]() {};\n"
                    "        auto hash = [&]() { kb[0] = kb[1] = "
                    "0xffffffffu; };\n") + s[b:]


def fwd_noexp(s: str) -> str:
    a = s.index("        // the online softmax in base 2")
    b = s.index("        wgmma_wait<0>();              // P_{t-1} V_{t-1}")
    return s[:a] + s[a:b].replace("exp2_ftz(", "(") + s[b:]


def fwd_noepilogue(s: str) -> str:
    """O's shared-memory writes under a condition that never holds (O must
    stay live: ptxas deletes products whose results nothing reads), no
    barrier, fence or TMA store."""
    a = s.index("    if ((tid & 127) == 0) bulk_wait_read();")
    b = s.index("#pragma unroll\n    for (int j = 0; j < DP / 8; ++j)", a)
    c = s.index("    fence_async_smem();     // O, visible to the TMA store", b)
    d = s.index("      bulk_commit();\n    }\n", c) + len(
        "      bulk_commit();\n    }\n")
    return s[:a] + "    if (p.nbh < 0) {\n" + s[b:c] + "    }\n" + s[d:]


def fwd_noanchor(s: str) -> str:
    a = s.index('          asm volatile("st.shared.v2.u32 [%0], {%1, %2};')
    b = s.index(': "memory");\n', a) + len(': "memory");\n')
    return _rep(s[:a] + s[b:], "        kb_load();\n        keep(s);\n",
                "        keep(s);\n")


def fwd_prepass(s: str) -> str:
    return _rep(s, "  return launch_fwd_ws<D, MASK>(",
                "  if (MASK) return 0;\n  return launch_fwd_ws<D, MASK>(")


def fwd_nosort(s: str) -> str:
    return _rep(s, "    p.sorted = (long long)p.nmask * p.nqb <= "
                   "kFwOrderCap;\n", "    p.sorted = 0;\n")


#: the forward's probes: (edit, the file it edits, the shapes it runs)
FWD_PROBES = {"clock": (fwd_clock, FWD_HEADER, ("gpt", "bert")),
              "nohash": (fwd_nohash, FWD_HEADER, ("gpt", "bert")),
              "noexp": (fwd_noexp, FWD_HEADER, ("gpt", "bert")),
              "noepilogue": (fwd_noepilogue, FWD_HEADER, ("gpt", "bert")),
              "noanchor": (fwd_noanchor, FWD_HEADER, ("gpt", "bert")),
              "prepass": (fwd_prepass, "flash_attention_md.cu", ("bert",)),
              "nosort": (fwd_nosort, FWD_HEADER, ("bert",))}

_HASH = ("0x85ebca6b", "-0x7a143595", "0xc2b2ae35", "-0x3d4d51cb")


def sass_hash_windows(so: Path) -> None:
    """For each instance of flash_fwd_ws_kernel in the library ``so``: its
    keep-hash multiplies (IMADs by murmur3's constants) that sit between
    an HGMMA (the issue) and the next WARPGROUP.DEPBAR (the wait), against
    all of them, and how many HGMMAs are waited on one by one."""
    txt = subprocess.run(["cuobjdump", "-sass", str(so)],
                         capture_output=True, text=True).stdout
    for func in re.split(r"\n\s*Function : ", txt):
        m = re.search(r"flash_fwd_ws_kernelILi(\d+)ELb(\d)E",
                      func.split("\n", 1)[0])
        if not m:
            continue
        ops = [re.sub(r"^\s*/\*[0-9a-f]+\*/\s*", "", ln).split(";")[0]
               for ln in func.splitlines()
               if re.search(r"/\*[0-9a-f]{4,}\*/", ln)]
        is_hash = [any(h in o.lower() for h in _HASH) for o in ops]
        under, inside, serial = 0, False, 0
        for i, o in enumerate(ops):
            if "HGMMA" in o:
                inside = True
                serial += i + 1 < len(ops) and "DEPBAR" in ops[i + 1]
            elif "WARPGROUP.DEPBAR" in o:
                inside = False
            elif inside:
                under += is_hash[i]
        print(f"  SASS flash_fwd_ws_kernel<{m.group(1)}, "
              f"{['false', 'true'][int(m.group(2))]}>: {under} of "
              f"{sum(is_hash)} hash multiplies between an HGMMA and its "
              f"wait; {serial} HGMMAs waited on one by one")


def hgmma_counts(so: Path, kernel: str) -> dict:
    """HGMMA instructions of each instance of ``kernel`` in the library
    ``so``, by its template arguments' mangled names."""
    txt = subprocess.run(["cuobjdump", "-sass", str(so)],
                         capture_output=True, text=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", txt):
        m = re.search(kernel + r"I((?:L[ib]\d+E)+)E", func.split("\n", 1)[0])
        if m:
            args = ", ".join(a[1:] if a[0] == "i" else ["false", "true"][
                int(a[1:])] for a in re.findall(r"L([ib]\d+)E", m.group(1)))
            out[f"<{args}>"] = func.count("HGMMA")
    return out


def _library(name: str, edit, header: str = HEADER):
    out = _build.BUILD_DIR.parent / f"probe_{name}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out / "csrc")
    path = out / "csrc" / header
    path.write_text(edit(path.read_text()))
    t0 = time.perf_counter()
    lib = cs._library_of(out / "csrc", out / "lib")
    fwd = header != HEADER
    src = "flash_attention_md.cu" if fwd else "flash_attention_bwd_md.cu"
    log = (out / "lib" / f"{src}.log").read_text()
    spills = {n: b for n, _, b in cs._ptxas_instances(log) if "ws" in n}
    so = next((out / "lib").glob("libapex_tpu_torch_*.so"))
    kernel = "flash_fwd_ws_kernel" if fwd else "flash_bwd_ws_kernel"
    print(f"built {name} in {time.perf_counter() - t0:.1f} s; spill bytes "
          f"{spills}; HGMMA {hgmma_counts(so, kernel)}")
    return lib


def main_fwd() -> int:
    """The forward's probes at the training paths' shapes."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    dev = torch.device("cuda")
    print(cs._smi())
    libs = {"kernel": _build.library()}
    sass_hash_windows(_build.build())
    print(f"unedited: HGMMA "
          f"{hgmma_counts(_build.build(), 'flash_fwd_ws_kernel')}")
    for name, (edit, header, _) in FWD_PROBES.items():
        libs[name] = _library(name, edit, header)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    seed3 = attn._seed_operand(-2 ** 31 + 12345, device=dev)
    for (tag, label, q3, k3, v3, _do3, mask3, causal, _mb, _live,
         _h) in cs._md_shapes(dev, gen):
        scale = q3.shape[-1] ** -0.5
        md = dict(mask3=mask3, rate=cs.LM_DROPOUT, seed3=seed3)

        def call():
            return attn._fwd(q3, k3, v3, causal, scale, **md)

        runs = {n: lib for n, lib in libs.items()
                if n == "kernel" or tag in FWD_PROBES[n][2]}
        _build._LIB = libs["kernel"]
        ref = call()
        # 100 calls a turn: the forward takes a tenth of the backward's time
        times = {name: [] for name in runs}
        for _ in range(2):
            for name, lib in runs.items():
                _build._LIB = lib
                times[name].append(cs._time_ms(call, 100))
        for name, lib in runs.items():
            _build._LIB = lib
            got = call()
            torch.cuda.synchronize()
            diff = [(g_.float() - r_.float()).abs().max().item()
                    for g_, r_ in zip(got, ref)]
            print(f"{tag} ({label}) {name}: {np.mean(times[name]):.4f} ms "
                  f"(turns {[round(t, 4) for t in times[name]]}); out, lse "
                  f"max|diff| against the kernel {[f'{x:.1e}' for x in diff]}")
            if name == "clock":
                words = got[1].contiguous().view(torch.int32).cpu().numpy()
                for r in zip(*np.nonzero(words == MAGIC)):
                    a = words[r[0], r[1]:r[1] + 16].astype(np.int64) % 2 ** 32
                    n = max(int(a[13]), 1)
                    print(f"  warpgroup {r[1] % 128 // 64}: "
                          f"{int(a[15])} tiles, {n} steps, {a[14] / n:.0f} "
                          f"cycles a step in all: " + ", ".join(
                              f"{p} {a[1 + i] / n:.0f}"
                              for i, p in enumerate(FWD_PHASES)))
        _build._LIB = libs["kernel"]
        del q3, k3, v3, ref, got
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fwd", action="store_true",
                    help="probe the forward's dropout kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_probe: CUDA is not available", file=sys.stderr)
        return 2
    if args.fwd:
        return main_fwd()
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    dev = torch.device("cuda")
    print(cs._smi())
    libs = {"kernel": _build.library()}
    print(f"unedited: HGMMA "
          f"{hgmma_counts(_build.build(), 'flash_bwd_ws_kernel')}")
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
