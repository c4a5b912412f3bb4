"""Phase clock and ablations of the one-pass flash backward's mask and
dropout kernel (``apex_tpu_torch/csrc/flash_kmajor_ws.cuh``, #4d and
#4md) on the card; with ``--fwd``, of the forward's dropout kernel
(``apex_tpu_torch/csrc/flash_qmajor_ws.cuh``, #3d and #3md); with
``--split``, of the split backward's (#5md: that kernel's dq mode; #6md:
the key-major kernel's dk/dv mode).

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

``--split`` times each split kernel alone (the mask pre-pass run once
beforehand) at the kernels phase's causal ``[1, 32, 8192, 128]`` with a
per-head mask and at ``gpt_train_8k``'s causal ``[1, 16, 8192, 128]``,
dropout 0.1, beside builds of the sources its kernel needs:

- #5md: ``dq nohash``, ``dq noexp``, ``dq nowrite`` (dq's shared-memory
  writes under a never-true condition, no TMA store), and the
  alternatives measured against the design: ``dq noturn`` (no turns on
  the tensor cores), ``dq dsbuf`` (dS into registers of its own while
  dQ_{t-1} runs), ``dq hashlate`` (the hash under dP and dQ instead of
  S), ``dq nopack`` and ``dq serial nopack`` (the hash where dS takes
  it), ``dq serial`` (dQ_t waited in its own step, no turns),
  ``dq loadregs`` (40 registers for the copying warps), ``dq
  nopersist`` (as many blocks as tiles);
- #6md: ``dkv nohash``, ``dkv noexp``, ``dkv nowrite`` (dk and dv
  stores under a never-true condition), ``dkv noorder`` (each head's key
  blocks in order instead of the longest first).

Run from the root of the repo on a machine with the card (about two
minutes a mode, the builds included; ``--only`` picks probes)::

    python3 tools/flash_bwd_probe.py
    python3 tools/flash_bwd_probe.py --fwd
    python3 tools/flash_bwd_probe.py --split --only "dq nohash,dkv noorder"
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
    a = s.index("        auto kb_load = [&]() {\n", _fwd_start(s))
    b = s.index("        // this warpgroup's turn: S_t", a)
    return s[:a] + ("        auto kb_load = [&]() {};\n"
                    "        auto hash = [&]() { kb[0] = kb[1] = "
                    "0xffffffffu; };\n") + s[b:]


def fwd_noexp(s: str) -> str:
    a = s.index("        // the online softmax in base 2")
    b = s.index("        wgmma_wait<0>();              // P_{t-1} V_{t-1}")
    return s[:a] + s[a:b].replace("exp2_ftz(", "(") + s[b:]


def _fwd_start(s: str) -> int:
    """Where the forward's product warpgroups begin (past the dq mode's,
    whose source comes first and repeats some of the forward's lines)."""
    return s.index("  const uint32_t seed = (uint32_t)__ldg(p.seed3),")


def fwd_noepilogue(s: str) -> str:
    """O's shared-memory writes under a condition that never holds (O must
    stay live: ptxas deletes products whose results nothing reads), no
    barrier, fence or TMA store."""
    a = s.index("    if ((tid & 127) == 0) bulk_wait_read();", _fwd_start(s))
    b = s.index("#pragma unroll\n    for (int j = 0; j < DP / 8; ++j)", a)
    c = s.index("    fence_async_smem();     // O, visible to the TMA store", b)
    d = s.index("      bulk_commit();\n    }\n", c) + len(
        "      bulk_commit();\n    }\n")
    return s[:a] + "    if (p.nbh < 0) {\n" + s[b:c] + "    }\n" + s[d:]


def fwd_noanchor(s: str) -> str:
    a = s.index('          asm volatile("st.shared.v2.u32 [%0], {%1, %2};',
                _fwd_start(s))
    b = s.index(': "memory");\n', a) + len(': "memory");\n')
    return _rep(s[:a] + s[b:], "        kb_load();\n        keep(s);\n",
                "        keep(s);\n")


def fwd_prepass(s: str) -> str:
    return _rep(s, "  return launch_qm_ws<D, MASK, false, true>(",
                "  if (MASK) return 0;\n  return launch_qm_ws<D, MASK, false, "
                "true>(")


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
        m = re.search(r"flash_fwd_ws_kernelILi(\d+)ELb(\d)ELb(\d)ELb(\d)E",
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
        flags = ", ".join(["false", "true"][int(m.group(i))]
                          for i in (2, 3, 4))
        print(f"  SASS flash_fwd_ws_kernel<{m.group(1)}, {flags}>: {under} of "
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


# -- the split pair (#5md: flash_qmajor_ws.cuh's dq mode; #6md:
# flash_kmajor_ws.cuh's dk/dv mode) ---------------------------------------

def _dq_block(s: str):
    """The dq mode's product warpgroups: ``(start, end)`` in the source."""
    a = s.index("  if constexpr (DQ) {\n    // the dq mode")
    return a, s.index("    return;\n  }\n", a)


def dq_nohash(s: str) -> str:
    """#5md: every keep bit 1 (drops nothing: wrong numbers)."""
    a, b = _dq_block(s)
    blk = _rep(s[a:b], "          if constexpr (DROP) keep_bits();\n", "")
    i = blk.index("          if constexpr (DROP)\n            asm volatile("
                  "\"ld.shared.v2.u32")
    j = blk.index(': "memory");\n', i) + len(': "memory");\n')
    blk = blk[:i] + "          kb[0] = kb[1] = 0xffffffffu;\n" + blk[j:]
    return s[:a] + blk + s[b:]


def dq_noexp(s: str) -> str:
    """#5md: p = s * scale_log2 - lse without the ex2 (wrong numbers)."""
    a, b = _dq_block(s)
    i = s.index("          // P = exp2(S * scale_log2 - lse)", a)
    j = s.index("          wgmma_wait<1>();            // dP is done", i)
    return s[:i] + s[i:j].replace("exp2_ftz(", "(") + s[j:]


def dq_nowrite(s: str) -> str:
    """#5md: dq's shared-memory writes under a condition that never holds
    (dQ stays live), no barrier, fence or TMA store (wrong dq)."""
    a, b = _dq_block(s)
    i = s.index("      if ((tid & 127) == 0) bulk_wait_read();", a)
    j = s.index("#pragma unroll\n      for (int j = 0; j < DP / 8; ++j)", i)
    k = s.index("      fence_async_smem();     // dq, visible to the TMA store",
                j)
    e = s.index("        bulk_commit();\n      }\n", k) + len(
        "        bulk_commit();\n      }\n")
    assert e < b
    return s[:i] + "      if (p.nbh < 0) {\n" + s[j:k] + "      }\n" + s[e:]


def dkv_nowrite(s: str) -> str:
    """#6md (and the one-pass kernel): the dk and dv stores under a
    condition that never holds (wrong dk and dv)."""
    return _rep(s, "    const int kr = k0 + krow + hf * 8;\n    if (kr < sk) {",
                "    const int kr = k0 + krow + hf * 8;\n"
                "    if (kr < sk && sq < 0) {")


def dkv_noorder(s: str) -> str:
    """#6md: the key blocks in the plain order (each head's from the
    first) instead of the longest first within groups of heads."""
    return _rep(s, "    bh = g * group + r % gsize;\n    kb = r / gsize;\n",
                "    bh = blockIdx.x / nkt + 0 * (g + r + gsize);\n"
                "    kb = blockIdx.x % nkt;\n")


def dq_noturn(s: str) -> str:
    """#5md: the warpgroups issue their products without taking turns."""
    a, b = _dq_block(s)
    blk = s[a:b]
    for line in ("    if (wg == 1) bar_arrive(kFwTurn, kFwConsumers);\n",
                 "    if (wg == 0) bar_sync(kFwTurn, kFwConsumers);\n",
                 "          bar_sync(kFwTurn + wg, kFwConsumers);\n",
                 "          bar_arrive(kFwTurn + 1 - wg, kFwConsumers);\n",
                 "        bar_sync(kFwTurn + wg, kFwConsumers);\n",
                 "        bar_arrive(kFwTurn + 1 - wg, kFwConsumers);\n"):
        blk = _rep(blk, line, "")
    assert "kFwTurn" not in blk
    return s[:a] + blk + s[b:]


def dq_dsbuf(s: str) -> str:
    """#5md: dS_t computed into registers of its own while dQ_{t-1} still
    reads the last step's (then copied over): dQ off the critical path."""
    a, b = _dq_block(s)
    blk = s[a:b]
    wait = ("          wgmma_wait<0>();            // dQ_{t-1} is done: dQ "
            "and dS free\n          keep(acc);\n          keep(pa);\n"
            "          if (i > 0) mbar_arrive(bKEmpty + 8 * ((c - 1) % S));\n")
    blk = _rep(blk, wait, "")
    blk = _rep(blk, "          to_a_frags(pa, dp);\n",
               "          unsigned pb[kPS][4];\n          to_a_frags(pb, dp);\n"
               + wait +
               "#pragma unroll\n          for (int u = 0; u < kPS; ++u)\n"
               "#pragma unroll\n            for (int v = 0; v < 4; ++v) "
               "pa[u][v] = pb[u][v];\n")
    return s[:a] + blk + s[b:]


def dq_hashlate(s: str) -> str:
    """#5md: the hash after P's exp, under the dP and dQ products (its
    words through the slot before the dP wait)."""
    a, b = _dq_block(s)
    blk = _rep(s[a:b], "          if constexpr (DROP) keep_bits();\n", "")
    i = blk.index("          if constexpr (DROP)\n            asm volatile("
                  "\"ld.shared.v2.u32")
    j = blk.index(': "memory");\n', i) + len(': "memory");\n')
    load, blk = blk[i:j], blk[:i] + blk[j:]
    w = "          wgmma_wait<1>();            // dP is done"
    blk = _rep(blk, w, "          if constexpr (DROP) keep_bits();\n" + w)
    k = blk.index("          keep(dp);\n", blk.index(w)) + len(
        "          keep(dp);\n")
    return s[:a] + blk[:k] + load + blk[k:] + s[b:]


def dq_nopack(s: str) -> str:
    """#5md: no keep words: each element's keep bit hashed where dS takes
    it, after the dP wait (the last version's place, folded)."""
    a, b = _dq_block(s)
    blk = _rep(s[a:b], "          if constexpr (DROP) keep_bits();\n", "")
    i = blk.index("          if constexpr (DROP)\n            asm volatile("
                  "\"ld.shared.v2.u32")
    j = blk.index(': "memory");\n', i) + len(': "memory");\n')
    blk = blk[:i] + blk[j:]
    old = blk[blk.index("#pragma unroll\n          for (int hf = 0; hf < 2; "
                        "++hf)\n#pragma unroll\n            for (int j = 0; j "
                        "< BK / 8; ++j)\n#pragma unroll\n              for "
                        "(int e = 0; e < 2; ++e) {\n                const int "
                        "x = j * 4 + hf * 2 + e;\n                float g"):
              blk.index("          to_a_frags(pa, dp);\n")]
    new = ("#pragma unroll\n          for (int j = 0; j < BK / 8; ++j)\n"
           "#pragma unroll\n            for (int e = 0; e < 2; ++e) {\n"
           "              const uint32_t cf = fold16(drop_col(hcol0 + "
           "(uint32_t)(k0 + j * 8 + tig * 2 + e)));\n"
           "#pragma unroll\n              for (int hf = 0; hf < 2; ++hf) {\n"
           "                const int x = j * 4 + hf * 2 + e;\n"
           "                float g = dp[x];\n"
           "                if constexpr (DROP)\n"
           "                  g = (kall && drop_mix(hrow[hf] ^ cf) >= thr8)"
           " ? g * p.inv_keep : 0.f;\n"
           "                dp[x] = s[x] * (g - drow[hf]);\n"
           "              }\n            }\n")
    return s[:a] + blk.replace(old, new) + s[b:]


def dq_serial(s: str) -> str:
    """#5md: the last version's step in the persistent kernel: dQ_t issued
    after dS_t and waited in its step (no product left in flight), no
    turns; the hash under S as the kernel has it."""
    s = dq_noturn(s)
    a, b = _dq_block(s)
    blk = s[a:b]
    blk = _rep(blk, "#pragma unroll\n          for (int t = 0; t < kPS; ++t) "
                    "wgmma_rs(acc, pa[t], n_desc(pK, t), 1);\n"
                    "          wgmma_commit();\n", "")
    blk = _rep(blk, "          wgmma_wait<2>();            // S is done",
               "          wgmma_wait<1>();            // S is done")
    blk = _rep(blk, "          wgmma_wait<1>();            // dP is done",
               "          wgmma_wait<0>();            // dP is done")
    blk = _rep(blk, "          wgmma_wait<0>();            // dQ_{t-1} is done: "
                    "dQ and dS free\n          keep(acc);\n          keep(pa);"
                    "\n          if (i > 0) mbar_arrive(bKEmpty + 8 * ((c - 1) "
                    "% S));\n", "")
    blk = _rep(blk, "          to_a_frags(pa, dp);\n",
               "          to_a_frags(pa, dp);\n          keep(acc);\n"
               "          keep(pa);\n          wgmma_fence();\n"
               "#pragma unroll\n          for (int t = 0; t < kPS; ++t)\n"
               "            wgmma_rs(acc, pa[t], n_desc(sK + st * T::kKV, t), "
               "1);\n          wgmma_commit();\n          wgmma_wait<0>();\n"
               "          keep(acc);\n          keep(pa);\n"
               "          mbar_arrive(bKEmpty + 8 * st);\n")
    i = blk.index("        // the last step's dQ += dS K, in turn\n")
    j = blk.index("        ++c;\n", i)
    blk = blk[:i] + blk[j:]
    return s[:a] + blk + s[b:]


def dq_loadregs(s: str) -> str:
    """#5md: 40 registers for the scheduling and loading warps, 232 for
    the product threads (the dq mode only)."""
    s = _rep(s, "    reg_dealloc<kQmCopyRegs>();\n    if (tid == kFwConsumers + 32)",
             "    reg_dealloc<DQ ? 40 : kQmCopyRegs>();\n"
             "    if (tid == kFwConsumers + 32)")
    return _rep(s, "  reg_alloc<kQmRegs>();\n\n  const int wg = tid >> 7",
                "  reg_alloc<DQ ? 232 : kQmRegs>();\n\n"
                "  const int wg = tid >> 7")


def dq_nopersist(s: str) -> str:
    """#5md: as many blocks as tiles instead of one an SM (against the
    static snake, each block then took one tile in the schedule's order;
    against the tile counter, the blocks past the SMs' wait to start)."""
    return _rep(s, "  const int grid = (int)(tiles < sms ? tiles : sms);\n",
                "  const int grid = DQ ? (int)tiles\n"
                "                      : (int)(tiles < sms ? tiles : sms);\n")


#: the split pair's probes: (edit, the file it edits, the kernel it times)
SPLIT_PROBES = {"dq nohash": (dq_nohash, FWD_HEADER, "dq"),
                "dq noexp": (dq_noexp, FWD_HEADER, "dq"),
                "dq nowrite": (dq_nowrite, FWD_HEADER, "dq"),
                "dq noturn": (dq_noturn, FWD_HEADER, "dq"),
                "dq dsbuf": (dq_dsbuf, FWD_HEADER, "dq"),
                "dq hashlate": (dq_hashlate, FWD_HEADER, "dq"),
                "dq nopack": (dq_nopack, FWD_HEADER, "dq"),
                "dq serial": (dq_serial, FWD_HEADER, "dq"),
                "dq loadregs": (dq_loadregs, FWD_HEADER, "dq"),
                "dq nopersist": (dq_nopersist, FWD_HEADER, "dq"),
                "dq serial nopack": (lambda s: dq_nopack(dq_serial(s)),
                                     FWD_HEADER, "dq"),
                "dkv nohash": (nohash, HEADER, "dkv"),
                "dkv noexp": (noexp, HEADER, "dkv"),
                "dkv nowrite": (dkv_nowrite, HEADER, "dkv"),
                "dkv noorder": (dkv_noorder, HEADER, "dkv")}
#: the sources each kernel's probe library is built from (the error
#: string's and the pre-pass's with them)
_SPLIT_SOURCES = {"dq": ("flash_attention_md.cu", "layer_norm.cu"),
                  "dkv": ("flash_attention_md.cu",
                          "flash_attention_bwd_md.cu", "layer_norm.cu")}


def _split_library(name: str, edit, header: str, kernel: str):
    """A library of the sources the kernel needs, one header edited."""
    out = _build.BUILD_DIR.parent / f"probe_{name.replace(' ', '_')}"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(_build.CSRC, out / "csrc")
    path = out / "csrc" / header
    path.write_text(edit(path.read_text()))
    sources = {src: _build.SOURCES[src] for src in _SPLIT_SOURCES[kernel]}
    entries = {e for es in sources.values() for v in es.values()
               for e in ((v,) if isinstance(v, str) else v)}
    entries |= set(_build.UNCOUNTED["flash_attention_md.cu"])
    sigs = {e: a for e, a in _build._SIGNATURES.items() if e in entries}
    t0 = time.perf_counter()
    lib = cs._library_of(out / "csrc", out / "lib", sigs, sources)
    src = "flash_attention_md.cu" if kernel == "dq" \
        else "flash_attention_bwd_md.cu"
    log = (out / "lib" / f"{src}.log").read_text()
    spills = {n: b for n, _, b in cs._ptxas_instances(log) if "ws" in n}
    so = next((out / "lib").glob("libapex_tpu_torch_*.so"))
    kname = "flash_fwd_ws_kernel" if kernel == "dq" else "flash_bwd_ws_kernel"
    print(f"built {name} in {time.perf_counter() - t0:.1f} s; spill bytes "
          f"{spills}; HGMMA {hgmma_counts(so, kname)}")
    return lib


def main_split(only=None) -> int:
    """The split pair's probes at the kernels phase's shape (causal [1, 32,
    8192, 128], a per-head mask, dropout 0.1) and gpt_train_8k's (causal
    [1, 16, 8192, 128], dropout 0.1): each kernel alone, the mask
    pre-pass run once beforehand."""
    attn = importlib.import_module("apex_tpu_torch.ops.attention")
    dev = torch.device("cuda")
    print(cs._smi())
    libs = {"kernel": _build.library()}
    so = _build.build()
    print(f"unedited: HGMMA {hgmma_counts(so, 'flash_fwd_ws_kernel')} "
          f"{hgmma_counts(so, 'flash_bwd_ws_kernel')}")
    sass_hash_windows(so)
    for name, (edit, header, kernel) in SPLIT_PROBES.items():
        if only is None or name in only:
            libs[name] = _split_library(name, edit, header, kernel)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    seed3 = attn._seed_operand(-2 ** 31 + 12345, device=dev)
    bf = torch.bfloat16
    for tag, bh, masked in (("masked", 32, True), ("gpt8k", 16, False)):
        s_, d = cs.SPLIT_SEQ, 128
        q3, k3, v3, do3 = (torch.randn(bh, s_, d, generator=gen, device=dev)
                           .to(bf) for _ in range(4))
        mask3 = None
        if masked:
            mask3 = torch.rand(bh, s_, s_, generator=gen, device=dev) < 0.1
            mask3[:, 5] = True
        scale = d ** -0.5
        md = dict(mask3=mask3, rate=cs.LM_DROPOUT, seed3=seed3)
        _build._LIB = libs["kernel"]
        out, lse = attn._fwd(q3, k3, v3, True, scale, **md)
        delta = attn._delta(out, do3)
        args = (q3, k3, v3, lse, delta, do3, True, scale)
        label = (f"causal [1, {bh}, {s_}, {d}]"
                 + (", a per-head mask" if masked else "") + ", dropout 0.1")
        for kernel, fn in (("dq", attn._dq_kernel), ("dkv", attn._dkv_kernel)):
            runs = {n: lib for n, lib in libs.items()
                    if n == "kernel" or SPLIT_PROBES[n][2] == kernel}
            _build._LIB = libs["kernel"]
            scratch = None if mask3 is None else attn._mask_tiles(
                q3, s_, mask3, True)

            def timed():
                return fn(*args, **md, **({} if scratch is None
                                          else {"scratch": scratch}))

            ref = timed()
            ref = ref if isinstance(ref, tuple) else (ref,)
            times = {n: [] for n in runs}
            for _ in range(2):
                for n, lib in runs.items():
                    _build._LIB = lib
                    times[n].append(cs._time_ms(timed, 4))
            for n, lib in runs.items():
                _build._LIB = lib
                got = timed()
                got = got if isinstance(got, tuple) else (got,)
                torch.cuda.synchronize()
                rel = [cs._rel_l2(g_, r_) for g_, r_ in zip(got, ref)]
                print(f"{tag} ({label}) #{'5md' if kernel == 'dq' else '6md'} "
                      f"{n}: {np.mean(times[n]):.4f} ms (turns "
                      f"{[round(t, 4) for t in times[n]]}); against the "
                      f"kernel {[f'{r:.1e}' for r in rel]}")
            del ref, got
        _build._LIB = libs["kernel"]
        del q3, k3, v3, do3, out, lse, delta, args, mask3
        torch.cuda.empty_cache()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fwd", action="store_true",
                    help="probe the forward's dropout kernel")
    ap.add_argument("--split", action="store_true",
                    help="probe the split backward's mask/dropout kernels")
    ap.add_argument("--only", default=None,
                    help="with --split: a comma list of the probes to run "
                         "(e.g. 'dq nohash,dkv noorder'); default all")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("flash_bwd_probe: CUDA is not available", file=sys.stderr)
        return 2
    if args.fwd:
        return main_fwd()
    if args.split:
        return main_split(None if args.only is None
                          else set(args.only.split(",")))
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
