"""Variants of the fused block's rank-partial kernel (8p, 8gp;
``apex_tpu_torch/csrc/fused_block_partial.cu``) side by side on the card.

Each variant is a list of source edits (``[old, new]`` pairs, every
occurrence replaced) to a copy of the kernel sources under
``build/partial_variants/<name>/``; the variants build at once (the
kernel's source and ``layer_norm.cu``, which holds the error strings,
into a library of their own), are held against the plain version at
each shard, and are timed in turns (forward, then backward; 40 calls a
turn queued behind a sleeping card, ``chip_smoke._queued_ms``) at the
four shards of ``chip_smoke.py``'s ``partial`` A/B row: Llama-3-8B and
GPT-3 1.3B at tp = 2 and tp = 4 (rank 0, 8 slots, page 64), each beside
its phase clock and the mean time its items spend working and waiting on
counters (``chip_smoke._partial_clock``).  The variant ``base`` (no
edit) is always run.  Needs one card; run from the root of the repo::

    python3 tools/fused_partial_probe.py                  # the kernel alone
    python3 tools/fused_partial_probe.py variants.json    # {"name": [[old, new], ...]}
"""
import ctypes
import itertools
import json
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

SRC = "fused_block_partial.cu"
ENTRIES = ("apex_fused_block_decode_partial",
           "apex_fused_block_decode_gpt_partial")


def build(variants: dict) -> dict:
    """Each variant's library, built at once (one nvcc per source)."""
    root = ROOT / "build" / "partial_variants"
    shutil.rmtree(root, ignore_errors=True)
    nvcc = _build._nvcc()
    procs = []
    for name, edits in variants.items():
        d = root / name
        shutil.copytree(_build.CSRC, d / "csrc")
        text = (d / "csrc" / SRC).read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: no {old!r} in {SRC}")
            text = text.replace(old, new)
        (d / "csrc" / SRC).write_text(text)
        for src in (SRC, "layer_norm.cu"):
            log = open(d / f"{src}.log", "w")
            procs.append((d, src, subprocess.Popen(
                [nvcc, *_build._FLAGS, "-c", str(d / "csrc" / src), "-o",
                 str(d / f"{src}.o")], stdout=log, stderr=subprocess.STDOUT)))
    for d, src, proc in procs:
        if proc.wait():
            print((d / f"{src}.log").read_text()[-3000:])
            raise SystemExit(f"{d.name}: {src} failed to build")
    libs = {}
    for name in variants:
        d = root / name
        subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                        "-shared", "-o", str(d / "lib.so"),
                        str(d / f"{SRC}.o"), str(d / "layer_norm.cu.o")],
                       check=True)
        lib = ctypes.CDLL(str(d / "lib.so"))
        for entry in ENTRIES:
            getattr(lib, entry).argtypes = _build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        lib.apex_error_string.argtypes = [ctypes.c_int]
        lib.apex_error_string.restype = ctypes.c_char_p
        log = (d / f"{SRC}.log").read_text()
        regs = sorted(set(re.findall(r"Used (\d+) registers", log)), key=int)
        spills = sorted(set(re.findall(r"(\d+) bytes spill stores", log)),
                        key=int)
        print(f"{name}: registers {regs}, spill stores {spills}")
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("fused_partial_probe: CUDA is not available", file=sys.stderr)
        return 2
    variants = {"base": []}
    if len(sys.argv) > 1:
        variants.update(json.loads(Path(sys.argv[1]).read_text()))
    t0 = time.perf_counter()
    libs = build(variants)
    print(f"built {len(libs)} variants in {time.perf_counter() - t0:.1f} s "
          f"on {cs._smi()}")
    from apex_tpu_torch.inference import models
    from apex_tpu_torch.transformer.testing import GPTConfig, LlamaConfig
    from apex_tpu_torch.transformer.testing.standalone_llama import (
        _rope_cos_sin)
    pa = cs.importlib.import_module("apex_tpu_torch.ops.paged_attention")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    bf = torch.bfloat16
    slots, ps, layers, d = 8, 64, 4, 128
    for kind in ("llama", "gpt"):
        if kind == "llama":
            cfg = LlamaConfig(**dict(cs.FULL_CFG, num_layers=1))
            tree = {"layer_0": cs._random_llama(cfg, dev, 0,
                                                only="layer_0")["layer_0"]}
            lengths_l, mpps = [0, 1, 64, 65, 1500, 2048, 3000, 4096], 64
            kvh = cfg.num_kv_heads
        else:
            cfg = GPTConfig(**dict(cs.GPT_CFG, num_layers=1))
            tree = cs._random_gpt(cfg, dev, 10)
            lengths_l, mpps = [0, 1, 64, 65, 700, 1024, 1500, 2048], 32
            kvh = cfg.num_attention_heads
        blk = models.fused_layer_params(kind, cfg, tree)[0]
        del tree
        table, lengths = cs._paged_table(dev, gen, lengths_l, ps, mpps)
        x = torch.randn(slots, cfg.hidden_size, generator=gen,
                        device=dev).to(bf)
        kw = dict(kind=kind, eps=1e-5)
        if kind == "llama":
            window = mpps * ps
            cos_t, sin_t = _rope_cos_sin(window, d, cfg.rope_theta,
                                         device=dev)
            pos = torch.clamp(lengths.long(), max=window - 1)
            kw.update(cos=cos_t.reshape(window, d)[pos],
                      sin=sin_t.reshape(window, d)[pos])
        for tp in (2, 4):
            shard = models.shard_tree(
                blk, models.fused_partition_specs([blk], tp)[0], tp, 0)
            shape = (slots * mpps + 1, layers, kvh // tp, ps, d)
            pool_k = torch.randn(shape, generator=gen, device=dev).to(bf)
            pool_v = torch.randn(shape, generator=gen, device=dev).to(bf)
            views = [(pool_k[:, i], pool_v[:, i]) for i in range(layers)]
            args = (x, shard, *views[0], table, lengths)
            ref = pa.fused_block_reference(*args, fuse_mlp=False,
                                           partial_out=True, **kw)
            for name, lib in libs.items():
                with cs._as_version(cs._Version(lib)):
                    got = pa.fused_block_decode(*args, fuse_mlp=False,
                                                partial_out=True, **kw)
                err = max((g.float() - r.float()).abs().max().item()
                          / r.float().abs().max().item()
                          for g, r in zip(got, ref))
                if err > cs.TOL_FUSED_REL:
                    raise AssertionError(f"{name} {kind} tp = {tp}: "
                                         f"max|diff| / max|ref| {err}")
            cyc = itertools.cycle(views)
            times = {n: [] for n in libs}
            for name in list(libs) + list(libs)[::-1]:
                with cs._as_version(cs._Version(libs[name])):
                    times[name].append(cs._queued_ms(
                        lambda: pa.fused_block_decode(
                            x, shard, *next(cyc), table, lengths,
                            fuse_mlp=False, partial_out=True, **kw), 40))
            print(f"{kind} tp = {tp}: " + "; ".join(
                f"{n} {np.mean(t):.4f} ms ({', '.join(f'{v:.4f}' for v in t)})"
                for n, t in times.items()))
            for name, lib in libs.items():
                with cs._as_version(cs._Version(lib)):
                    cs._print_partial_clock(
                        f"{kind} tp = {tp} {name}",
                        cs._partial_clock(x, shard, *views[0], table,
                                          lengths, kw))
            del shard, pool_k, pool_v, views, cyc
            torch.cuda.empty_cache()
        del blk
    return 0


if __name__ == "__main__":
    sys.exit(main())
