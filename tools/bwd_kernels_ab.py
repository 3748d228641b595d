"""Time the backward kernels of attention and of the SSD (kernels 5b and
6b) at the LM training path's shapes on one CUDA card, for the PyTorch port
under a given source tree.

    python3 tools/bwd_kernels_ab.py [--src DIR] [--reps 5]

DIR defaults to this checkout's ``src/``; point it at another checkout's
``src/`` (its kernels are built into that checkout) to compare two trees on
the same card, in turns (parent, change, change, parent).  The shapes are
chip_smoke.py's ATTN_BWD_PATH (gemma3-4b at train_4k_b1: q (1, 4096, 8,
256), k and v (1, 4096, 4, 256), bf16, causal; global and window 1024) and
SSD_BWD_PATH (mamba2-370m at train_4k_b8: x (8, 4096, 32, 64), B and C
(8, 4096, 128), f32, A and dt as mamba2-370m's init draws them), inputs
drawn on the card from seed 0.  Prints the card's name and power limit,
then one JSON object: each case's milliseconds a call (CUDA events over
`reps` back-to-back calls after a warm-up) and device milliseconds a call
of each CUDA kernel (torch.profiler).  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
ATTN = ((1, 4096, 8, 4, 256, None), (1, 4096, 8, 4, 256, 1024))
SSD = (8, 4096, 32, 64, 128)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("bwd_kernels_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def name(key: str) -> str:
        """A profiler's kernel key without its return type, namespace and
        parameter list."""
        return key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]

    def timed(fn) -> dict:
        fn()
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        device = {name(ev.key): ev.self_device_time_total / args.reps / 1e3
                  for ev in prof.key_averages()
                  if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}
        return {"ms": start.elapsed_time(end) / args.reps, "device_ms": device}

    out = {"src": str(args.src)}
    for B, S, H, KVH, hd, window in ATTN:
        q, do = (torch.randn(B, S, H, hd, device="cuda", generator=gen).bfloat16()
                 for _ in range(2))
        k, v = (torch.randn(B, S, KVH, hd, device="cuda", generator=gen).bfloat16()
                for _ in range(2))
        out["attn_global" if window is None else f"attn_window{window}"] = timed(
            lambda: fa._kernel_bwd(q, k, v, do, True, window))
        del q, k, v, do
    B, S, H, hd, N = SSD
    x = torch.randn(B, S, H, hd, device="cuda", generator=gen)
    A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
    dt = torch.nn.functional.softplus(torch.randn(B, S, H, device="cuda", generator=gen))
    Bm, Cm = (torch.randn(B, S, N, device="cuda", generator=gen) for _ in range(2))
    dy = torch.randn(B, S, H, hd, device="cuda", generator=gen)
    _, _, fws = ss._kernel(x, dt, A, Bm, Cm)
    out["ssd"] = timed(lambda: ss._kernel_bwd(x, dt, A, Bm, Cm, dy, None, fws))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
