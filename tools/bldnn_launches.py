"""Count the CUDA launches of fig-dnn/BLDNN rounds on one CUDA card, and
time the rounds, for the PyTorch port under a given source tree.

    python3 tools/bldnn_launches.py [--src DIR] [--rounds 4] [--repeats 3]

DIR defaults to this checkout's ``src/``; point it at another checkout's
``src/`` (its kernels are built into that checkout) to compare two trees
on the same card.  Prints the card's name and power limit, then one JSON
object: the CUDA launches a round (kernels, copies and sets, from
torch.profiler over `rounds` rounds after a profiled warm-up) and the
seconds a round of the whole 40-round cell, `repeats` times.  Exits 1
without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--repeats", type=int, default=3)
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("bldnn_launches: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.exp import problems

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    cell = problems.FIG_DNN["BLDNN"]
    prob = problems.load_dnn_problem(device="cuda")
    problems.run_dnn_cell(cell, prob, steps=2)                  # builds and warms up
    for _ in range(2):                                          # the first warms the profiler
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            problems.run_dnn_cell(cell, prob, steps=args.rounds)
            torch.cuda.synchronize()
    launched = sum(ev.count for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0)
    s_per_round = []
    for _ in range(args.repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        problems.run_dnn_cell(cell, prob)
        torch.cuda.synchronize()
        s_per_round.append((time.perf_counter() - t0) / cell.steps)
    print(json.dumps({"src": args.src, "rounds": args.rounds, "cuda_launches": launched,
                      "cuda_launches_per_round": launched / args.rounds,
                      "s_per_round": s_per_round}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
