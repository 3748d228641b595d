#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py              # what a checkout's check runs
    python3 chip_smoke.py --profile    # + a torch.profiler pass over fig1-xl

Phases, each printing one JSON line; any failure raises, so the exit code
is non-zero and no result line is printed:

  1. device  — the card's name, and its name and power limit from nvidia-smi;
  2. build   — compile every CUDA source of the port (one nvcc each, in
               parallel) from this checkout;
  3. kernels — each kernel against its plain PyTorch version on the card,
               bitwise, on the main path's shapes and on edge-case rows, and
               timed beside its plain version, its library call and its bound;
  4. fig1r1  — BL1 through `repro_torch.core.bl.bl1` against the committed
               artifact results/exp/fig1r1/BL1.seed0.json;
  5. fig1-xl — the same at full width (n=512, d=1200) against
               results/exp/fig1-xl/BL1.seed0.json, with seconds per round,
               the Newton reference time and peak device memory.

Gaps must agree to |Δ| ≤ 1e-8·|ref| + 1e-12 and every bit stream exactly.
Each path resets the kernels' launch counts just before it runs and fails
if a kernel of the path was not launched.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a CUDA device or outside a checkout of the repo.
"""
from __future__ import annotations

import json
import pathlib
from statistics import median
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
#: NVIDIA H100 SXM data sheet: HBM3 rate, and the 32-bit rate outside the
#: tensor cores (the kernel's operations are 32-bit integer compares/adds)
HBM_BYTES_PER_S = 3.35e12
OPS32_PER_S = 67e12
#: fig1-xl timing repeats (each a 1-round and a full run)
XL_REPEATS = 5


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def threshold_bound_ms(rows: int, T: int) -> tuple:
    """Least time for the threshold of a (rows, T) f32 input: one read of
    the input and one write of the (rows, 1) output, or 31 passes of a
    compare and an add per element, whichever is larger."""
    bytes_ms = (rows * T * 4 + rows * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * 31 * rows * T / OPS32_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def check_history(name: str, hist, ref: dict) -> dict:
    import numpy as np

    g, gr = np.asarray(hist.gaps), np.asarray(ref["gaps"])
    if g.shape != gr.shape or not np.all(np.isfinite(g)):
        raise AssertionError(f"{name}: gaps {g} against reference {gr}")
    err = np.abs(g - gr)
    bad = err > GAP_RTOL * np.abs(gr) + GAP_ATOL
    if bad.any():
        raise AssertionError(f"{name}: gaps leave |Δ| ≤ 1e-8·|ref| + 1e-12 at rounds "
                             f"{np.nonzero(bad)[0].tolist()}: {g} vs {gr}")
    streams = {"up_bits": hist.up_bits, "down_bits": hist.down_bits,
               **{f"legs.{k}": hist.legs[k] for k in ref["legs"]}}
    want = {"up_bits": ref["up_bits"], "down_bits": ref["down_bits"],
            **{f"legs.{k}": v for k, v in ref["legs"].items()}}
    for k, v in streams.items():
        if list(v) != list(want[k]):
            raise AssertionError(f"{name}: bit stream {k} {v} != reference {want[k]}")
    return {"max_gap_abs_err": float(err.max()), "gaps": list(map(float, g)),
            "bit_streams_equal": sorted(streams)}


def kernel_phase(torch, tk) -> dict:
    """The threshold kernel against its plain version and torch.topk,
    bitwise, then keep-masks from both thresholds; then its timings."""
    import numpy as np

    rng = np.random.default_rng(0)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device="cuda")

    cases = [(f"random{r}x{T}", dev(np.abs(rng.standard_normal((r, T)))), k)
             for r, T, ks in ((10, 576, (1, 24, 576)), (512, 1024, (32, 1024)))
             for k in ks]
    ties = rng.integers(0, 4, (64, 576)).astype(np.float32)
    zeros = np.zeros((8, 576), np.float32)
    infs = np.abs(rng.standard_normal((8, 576))).astype(np.float32)
    infs[:, rng.integers(0, 576, 40)] = np.inf
    tiny = np.finfo(np.float32).smallest_subnormal
    subn = (rng.integers(0, 50, (8, 576)) * tiny).astype(np.float32)
    negz = np.where(rng.random((8, 576)) < 0.5, -0.0,
                    rng.standard_normal((8, 576))).astype(np.float32)
    for name, arr in (("ties", ties), ("zeros", zeros), ("inf", infs),
                      ("subnormal", subn), ("neg_zero", negz)):
        for k in (1, 24, 300, 576):
            cases.append((name, torch.abs(dev(arr)).contiguous(), k))

    max_err = 0.0
    for name, a, k in cases:
        kk = max(1, min(k, a.shape[1]))
        t_kernel = tk.topk_row_threshold(a, k)
        t_plain = tk.topk_row_threshold_plain(a, k)
        t_lib = torch.topk(a, kk, dim=1).values[:, -1:].contiguous()
        torch.cuda.synchronize()
        for other, label in ((t_plain, "plain"), (t_lib, "torch.topk")):
            if not torch.equal(t_kernel.view(torch.int32), other.view(torch.int32)):
                raise AssertionError(f"threshold kernel != {label} on {name} k={k}")
        m_kernel = tk.keep_mask(a, t_kernel, kk)
        if not torch.equal(m_kernel, tk.keep_mask(a, t_plain, kk)):
            raise AssertionError(f"keep_mask differs on {name} k={k}")
        if not bool((m_kernel.sum(dim=1) == kk).all()):
            raise AssertionError(f"keep_mask keeps != {kk} per row on {name}")
        same = t_kernel == t_plain
        diff = torch.where(same, 0.0, (t_kernel.double() - t_plain.double()).abs())
        max_err = max(max_err, float(diff.max()))

    timings = {}
    for rows, T, k, path in ((10, 576, 24, "fig1r1"), (512, 1024, 1024, "fig1-xl")):
        a = dev(np.abs(rng.standard_normal((rows, T))))
        bound, by = threshold_bound_ms(rows, T)
        timings[path] = {
            "shape": [rows, T], "k": k,
            "kernel_ms": cuda_ms(torch, lambda: tk.topk_row_threshold(a, k), 500),
            "plain_ms": cuda_ms(torch, lambda: tk.topk_row_threshold_plain(a, k), 50),
            "library_ms": cuda_ms(
                torch, lambda: torch.topk(a, k, dim=1).values[:, -1:], 500),
            "bound_ms": bound, "bound_by": by}
    return {"cases": len(cases), "max_abs_err": max_err, "timings": timings}


def run_path(torch, tk, problems, cell, prob, steps=None):
    """Drive one BL1 path with the launch count reset just before it and
    read just after; returns (history, seconds, launches)."""
    torch.cuda.synchronize()
    tk.launches = 0
    t0 = time.perf_counter()
    hist = problems.run_cell(cell, prob, steps=steps)
    torch.cuda.synchronize()
    return hist, time.perf_counter() - t0, tk.launches


def profile_xl(torch, problems, cell, prob, steps: int = 2) -> dict:
    """Device time by CUDA kernel over a `steps`-round fig1-xl run
    (torch.profiler; a first profiled run warms the profiler up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            problems.run_cell(cell, prob, steps=steps)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "top": [{"name": k[:100], "device_ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:15]]}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repo (no src/repro_torch)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as _device
    from repro_torch.exp import problems
    from repro_torch.kernels import SOURCES, _build
    from repro_torch.kernels import topk_threshold as tk

    _device.resolve("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    emit({"phase": "build", "sources": list(SOURCES),
          "seconds": time.perf_counter() - t0})

    kern = kernel_phase(torch, tk)
    emit({"phase": "kernels", "kernel": "topk_row_threshold", **kern})

    launches = {}
    # ---- fig1r1: the paper's cell -----------------------------------------
    cell = problems.FIG1R1
    t0 = time.perf_counter()
    prob = problems.build_problem(cell.problem, device="cuda")
    prob.bases(cell.basis)
    setup_s = time.perf_counter() - t0
    hist, secs, launches["fig1r1"] = run_path(torch, tk, problems, cell, prob)
    res = check_history("fig1r1", hist, json.loads(cell.artifact.read_text())["history"])
    if launches["fig1r1"] < cell.steps:
        raise AssertionError(f"fig1r1: threshold kernel launched {launches['fig1r1']} "
                             f"times in {cell.steps} rounds")
    emit({"phase": "fig1r1", "setup_s": setup_s, "run_s": secs,
          "launches": {"topk_row_threshold": launches["fig1r1"]}, **res})

    # ---- fig1-xl: full width on one card ------------------------------------
    cell = problems.FIG1_XL
    t0 = time.perf_counter()
    prob = problems.build_problem(cell.problem, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    from repro_torch.core import client_batch

    client_batch.newton_solve_fused(client_batch.from_clients(prob.clients), prob.x0,
                                    cell.problem.newton_iters)
    torch.cuda.synchronize()
    newton_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob.bases(cell.basis)
    torch.cuda.synchronize()
    bases_s = time.perf_counter() - t0
    problems.run_cell(cell, prob, steps=1)                    # warm-up round
    # seconds per round by differencing a 1-round and a full run, repeated;
    # the last full run is the main path's checked run
    per_round, t_ones, t_alls = [], [], []
    for rep in range(XL_REPEATS):
        _, t_one, _ = run_path(torch, tk, problems, cell, prob, steps=1)
        if rep == XL_REPEATS - 1:
            torch.cuda.reset_peak_memory_stats()
        hist, t_all, launches["fig1-xl"] = run_path(torch, tk, problems, cell, prob)
        t_ones.append(t_one)
        t_alls.append(t_all)
        per_round.append((t_all - t_one) / (cell.steps - 1))
    peak = torch.cuda.max_memory_allocated()
    res = check_history("fig1-xl", hist, json.loads(cell.artifact.read_text())["history"])
    if launches["fig1-xl"] < cell.steps:
        raise AssertionError(f"fig1-xl: threshold kernel launched {launches['fig1-xl']} "
                             f"times in {cell.steps} rounds")
    emit({"phase": "fig1-xl", "problem_build_s": build_s, "newton_s": newton_s,
          "bases_s": bases_s, "run_1_round_s": t_ones, "run_s": t_alls,
          "s_per_round": sorted(per_round), "s_per_round_median": median(per_round),
          "max_memory_allocated": peak,
          "launches": {"topk_row_threshold": launches["fig1-xl"]}, **res})

    if "--profile" in argv:
        emit({"phase": "profile_fig1-xl", **profile_xl(torch, problems, cell, prob)})

    xl = kern["timings"]["fig1-xl"]
    emit({"kernels": [{
        "name": "topk_row_threshold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_threshold.cu",
        "replaces": "src/repro/kernels/topk_threshold.py:73",
        "launches": launches["fig1-xl"], "max_abs_err": kern["max_abs_err"],
        "ms": xl["kernel_ms"], "plain_ms": xl["plain_ms"], "bound_ms": xl["bound_ms"],
        "bound_by": xl["bound_by"], "library_ms": xl["library_ms"],
        "shape": xl["shape"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
