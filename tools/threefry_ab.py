"""Time kernel 7's normal path (the keyed ``jax.random.normal`` draw) at
gemma3-4b's embedding leaf on one CUDA card, for the PyTorch port under a
given source tree.

    python3 tools/threefry_ab.py [--src DIR] [--reps 5] [--ptxas] [--leaves]

DIR defaults to this checkout's ``src/``; point it at another checkout's
``src/`` (its kernels are built into that checkout) to compare two trees on
the same card, in turns (parent, change, change, parent).  The leaf is
262,144 × 2560 draws of ``normal(split(PRNGKey(0), 6)[0])`` scaled by 0.02
into bfloat16, the original threefry layout, as chip_smoke.py's phase prng
times it; each tree's draw is held bitwise to the first tree's of the run
(written to ``build/threefry_ab_ref.pt`` under this checkout, or read from
there).  ``--leaves`` also times one launch at every draw size of the ten
configs' full-width inits and BL-DNN (chip_smoke.py's `normal_draw_shapes`,
one row each) and at llama4-maverick's 5.4 G-draw expert leaf past 2³² − 1.
``--ptxas`` prints ``nvcc -Xptxas -v`` for the tree's
``threefry_normal.cu`` (registers, shared memory, spills).  Prints the
card's name and power limit, then one JSON object: milliseconds a launch
(CUDA events over `reps` launches after a warm-up) and the kernel's device
milliseconds (torch.profiler).  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
V, D = 262144, 2560


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--leaves", action="store_true")
    args = ap.parse_args()
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("threefry_ab: no CUDA device is available", file=sys.stderr)
        return 1
    src = pathlib.Path(args.src).resolve()
    sys.path.insert(0, str(src))
    from repro_torch.core import prng
    from repro_torch.kernels import _build
    from repro_torch.kernels import threefry_normal as tn

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    res = {"src": str(src)}
    if args.ptxas:
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
               str(ROOT / "build" / "threefry_ab_ptxas.so"), str(_build.CSRC / "threefry_normal.cu")]
        (ROOT / "build").mkdir(exist_ok=True)
        proc = subprocess.run(cmd, capture_output=True, text=True)
        res["ptxas"] = [line for line in (proc.stdout + proc.stderr).splitlines()
                        if "registers" in line or "Compiling" in line or "spill" in line]
    _build.build_all(["threefry_normal"])
    n = V * D
    key = prng.split(prng.PRNGKey(0), 6)[0][None]
    s = float(torch.tensor(0.02, dtype=torch.float32))
    out = torch.empty((1, n), dtype=torch.bfloat16, device="cuda")

    def kernel():
        return tn.threefry_normal(out, key, n, scale=s)

    kernel()
    torch.cuda.synchronize()
    ref = ROOT / "build" / "threefry_ab_ref.pt"
    digest = torch.tensor([int(v) for v in out.view(torch.int16)[0, :: 997].cpu().tolist()])
    if ref.exists():
        res["bitwise_first_tree"] = bool(torch.equal(torch.load(ref), digest))
    else:
        torch.save(digest, ref)
        res["bitwise_first_tree"] = True
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(args.reps):
        kernel()
    end.record()
    end.synchronize()
    res["ms"] = start.elapsed_time(end) / args.reps
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kernel()
        torch.cuda.synchronize()
    res["device_ms"] = {ev.key.split("(")[0][-60:]: ev.self_device_time_total / 3 / 1e3
                        for ev in prof.key_averages()
                        if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}
    if args.leaves:
        sys.path.insert(0, str(ROOT))
        import math

        import chip_smoke

        del out
        torch.cuda.empty_cache()
        res["leaves_ms"] = {}
        for shape in [*chip_smoke.normal_draw_shapes(), chip_smoke.BLOCKED_DRAW_SHAPE]:
            size = math.prod(shape)
            leaf = torch.empty((1, size), dtype=torch.bfloat16, device="cuda")

            def draw():
                return tn.threefry_normal(leaf, key, size, scale=s)

            draw()
            reps = 3 if size > 1 << 26 else 20
            start.record()
            for _ in range(reps):
                draw()
            end.record()
            end.synchronize()
            res["leaves_ms"][size] = start.elapsed_time(end) / reps
            del leaf
            torch.cuda.empty_cache()
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
