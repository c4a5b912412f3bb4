"""What each operand costs the wide dk/dv kernel (#6w,
``apex_tpu_torch/csrc/flash_kmajor_ws.cuh``'s wide modes) on the card:
``attention._dkv_wide`` timed at BERT-large's ``[16, 16, 512, 64]``
with and without its padding mask and dropout 0.1 (fp32 and fp16), and
at GPT-3 1.3B's causal ``[1, 16, 2048, 128]`` (fp32 with and without
dropout; fp16 causal, non-causal and at head dim 64; fp32 at head dim
64).  Each call is timed as the wrapper runs it (fp32: the split of q,
k, v and dO into bf16 planes included) and with the planes made
beforehand (``tc=``, as ``_bwd_wide`` hands them over), CUDA-graph
replays between CUDA events (``chip_smoke._time_ms``).  Needs one card;
run from the root of the repo::

    python3 tools/wide_dkv_probe.py
"""
import importlib
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

attn = importlib.import_module("apex_tpu_torch.ops.attention")


def _run(dev, gen, seed3, label, dt, b, h, s, d, causal, masked, rate):
    q3, k3, v3, do3, _, _, _, md, _ = cs._wide_inputs(
        dev, gen, seed3, dt, b, h, s, d, masked, rate)
    out, lse = attn._fwd_wide(q3, k3, v3, causal, d ** -0.5, **md)
    args = (q3, k3, v3, lse, attn._delta(out, do3), do3, causal,
            d ** -0.5)
    ms = cs._time_ms(lambda: attn._dkv_wide(*args, **md), 10)
    tc = attn._wide_tc_operands(attn._WIDE_DTYPES[dt], (q3, k3, v3, do3))
    ms_planes = cs._time_ms(lambda: attn._dkv_wide(*args, **md, tc=tc), 10)
    print(f"{label}: {ms:.4f} ms, without the split {ms_planes:.4f} ms")


def main() -> int:
    if not torch.cuda.is_available():
        print("wide_dkv_probe: CUDA is not available", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs._smi())
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    seed3 = attn._seed_operand(-2 ** 31 + 777, device=dev)
    f32, f16 = torch.float32, torch.float16
    for row in (("bert fp32 mask+drop", f32, 16, 16, 512, 64, False, True,
                 0.1),
                ("bert fp32 mask", f32, 16, 16, 512, 64, False, True, 0.0),
                ("bert fp32 drop", f32, 16, 16, 512, 64, False, False, 0.1),
                ("bert fp32 plain", f32, 16, 16, 512, 64, False, False,
                 0.0),
                ("bert fp16 plain", f16, 16, 16, 512, 64, False, False,
                 0.0),
                ("bert fp16 mask", f16, 16, 16, 512, 64, False, True, 0.0),
                ("gpt fp32 d64 causal", f32, 1, 16, 2048, 64, True, False,
                 0.0),
                ("gpt fp32 drop", f32, 1, 16, 2048, 128, True, False, 0.1),
                ("gpt fp32 plain", f32, 1, 16, 2048, 128, True, False, 0.0),
                ("gpt fp16 plain", f16, 1, 16, 2048, 128, True, False, 0.0),
                ("gpt fp16 noncausal", f16, 1, 16, 2048, 128, False, False,
                 0.0),
                ("gpt fp16 d64", f16, 1, 16, 2048, 64, True, False, 0.0)):
        _run(dev, gen, seed3, *row)
    return 0


if __name__ == "__main__":
    sys.exit(main())
