"""Where the wide paged decode's (#7w) time goes on the card: each
``chip_smoke._wide_paged_cases`` row timed on the mode the host
predicate picks (the TMA modes of ``csrc/kv_decode.cuh``), on the
CUDA-core kernel (``csrc/paged_wide.cu``, the predicate forced off), and
on the TMA modes under other split plans (``_BLOCKS_PER_SM`` 1 and 2,
``_MIN_SPLIT_TOKENS`` 256, 512 and 1024; the plan sets how many blocks
share a window, so how full the card is and how long the heaviest block
runs); the fp16 rows also beside #7's bf16 instance and #7w's bf16
mode on the same pool cast to bf16.  CUDA-graph replays between CUDA
events over four layers of the pool in turn (``chip_smoke._time_ms``).
Needs one card; run from the root of the repo::

    python3 tools/paged_wide_probe.py
"""
import importlib
import itertools
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

pa = importlib.import_module("apex_tpu_torch.ops.paged_attention")


def _time(q, views, table, lengths) -> float:
    cyc = itertools.cycle(views)
    return cs._time_ms(lambda: pa.paged_decode_attention(
        q, *next(cyc), table, lengths), 48)


def _with_plan(blocks_per_sm: int, min_tokens: int, fn):
    saved = pa._BLOCKS_PER_SM, pa._MIN_SPLIT_TOKENS
    pa._BLOCKS_PER_SM, pa._MIN_SPLIT_TOKENS = blocks_per_sm, min_tokens
    pa._plan_splits.cache_clear()
    try:
        return fn()
    finally:
        pa._BLOCKS_PER_SM, pa._MIN_SPLIT_TOKENS = saved
        pa._plan_splits.cache_clear()


def main() -> int:
    if not torch.cuda.is_available():
        print("paged_wide_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    print(cs._smi())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    sms = pa._sm_count(dev)
    for tag, dt, kvh, group, d, ps, lengths_l in cs._wide_paged_cases():
        q, views, table, lengths = cs._wide_paged_inputs(
            dev, gen, dt, kvh, group, d, ps, lengths_l)
        args = (q, views, table, lengths)
        mode = cs._wide_paged_mode(pa, *views[0])
        plan = pa._plan_splits(q.shape[0], kvh, group, d, ps,
                               table.shape[1], sms)
        row = [f"{tag} ({mode}; plan {plan.nsplit} splits of "
               f"{plan.pages_per_split} pages): {_time(*args):.4f} ms"]
        saved = pa._wide_paged_tma
        pa._wide_paged_tma = lambda *a: False
        try:
            row.append(f"CUDA-core kernel {_time(*args):.4f}")
        finally:
            pa._wide_paged_tma = saved
        for bps, tokens in itertools.product((1, 2), (256, 512, 1024)):
            ms = _with_plan(bps, tokens, lambda: _time(*args))
            row.append(f"plan {bps}/SM, {tokens} tokens {ms:.4f}")
        if dt == torch.float16:
            # the same pool in bf16: #7's instance, and #7w's bf16 mode
            # on it (the wrapper called directly)
            qb = q.to(torch.bfloat16)
            bviews = [(k_.to(torch.bfloat16), v_.to(torch.bfloat16))
                      for k_, v_ in views]
            ms = _time(qb, bviews, table, lengths)
            row.append(f"#7 on it in bf16 {ms:.4f}")
            cyc = itertools.cycle(bviews)
            ms = cs._time_ms(lambda: pa._wide_call(
                qb, *next(cyc), table, lengths, d ** -0.5), 48)
            row.append(f"#7w's bf16 mode on it {ms:.4f}")
            del bviews
        print("; ".join(row), flush=True)
        del q, views
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
