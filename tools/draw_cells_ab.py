"""Time the cells whose rounds draw on the card (partial participation, the
stochastic compressors, FedNL-BAG's reporters) on one CUDA card, for the
PyTorch port under a given source tree.

    python3 tools/draw_cells_ab.py [--src DIR] [--reps 3] [--xl]

DIR defaults to this checkout's ``src/``; point it at another checkout's
``src/`` (its kernels are built into that checkout) to compare two trees on
the same card, in turns (parent, change, change, parent).  Each cell runs
through `repro_torch.exp.problems.run_cell` on the card, as chip_smoke.py's
cell phases run it: a 1-round warm-up, then ``reps`` full runs (seconds a
round: the median), then a profiled 2-round run (CUDA launches a round, the
device's busy milliseconds a round).  The cells: fig-dnn/RTopK (the carried
BL-DNN problem), fig3/RTopK, fig6/BL2_p0.33, fig1r3/RRankR, fig1r2/DIANA,
fig1r2/ADIANA, fig1-bag/BAG_q0.5 and fig4/BL2_tau_half, and with ``--xl``
bl2-xl's BL2 (n = 512, d = 1200).  Prints the card's name and power limit,
then one JSON object by cell.  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--xl", action="store_true")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("draw_cells_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.exp import problems
    from repro_torch.kernels import SOURCES, _build

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    _build.build_all(SOURCES)
    cells = [problems.FIG_DNN["RTopK"], problems.FIG3["RTopK"], problems.FIG6["BL2_p0.33"],
             problems.FIG1R3["RRankR"], problems.FIG1R2["DIANA"], problems.FIG1R2["ADIANA"],
             problems.FIG1_BAG["BAG_q0.5"], problems.FIG4["BL2_tau_half"]]
    if args.xl:
        cells.append(problems.BL2_XL)
    out = {}
    for cell in cells:
        spec = problems.DNN_FIG if cell.method == "bldnn" else cell.problem
        prob = problems.build_problem(spec, device="cuda")

        def run(steps=None, cell=cell, prob=prob):
            problems.run_cell(cell, prob, steps=steps)
            torch.cuda.synchronize()

        run(1)
        secs = []
        for _ in range(args.reps):
            t0 = time.perf_counter()
            run()
            secs.append((time.perf_counter() - t0) / cell.steps)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run(2)
        evs = [ev for ev in prof.key_averages()
               if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0]
        out[f"{cell.experiment}/{cell.name}"] = {
            "steps": cell.steps, "s_per_round": secs, "s_per_round_median": statistics.median(secs),
            "cuda_launches_per_round": sum(ev.count for ev in evs) / 2,
            "device_busy_ms_per_round": sum(ev.self_device_time_total for ev in evs) / 2 / 1e3}
        del prob
        problems.build_problem.cache_clear()
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
