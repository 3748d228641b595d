"""CLI for the port's experiment subsystem.

    PYTHONPATH=src python -m repro_torch.exp list
    PYTHONPATH=src python -m repro_torch.exp run --fig fig1r1
    PYTHONPATH=src python -m repro_torch.exp run --fig fig1r1 --device cpu \\
        --out /tmp/x --artifacts /tmp/x/exp

``run`` executes registered experiments (see `repro_torch.exp.registry`),
writes per-cell JSON artifacts under ``--artifacts`` and regenerates the
figure CSVs under ``--out`` (defaults: the committed ``results/`` layout).
Re-running resumes: cells with an up-to-date artifact — the committed ones
included, whose digests the port reproduces — are skipped unless
``--force``, which overwrites them: never pass ``--force`` with the default
``--out``/``--artifacts``.  ``--max-steps`` clamps every cell's round budget
(smoke tests) and is refused into the committed ``results/`` tree.
``--device`` picks the card (``cuda``, the default) or ``cpu``.
``--progress-every`` streams (round, gap, Mbits) for BL cells.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from .engine import build_problem, run_experiment
from .registry import available_experiments, get_experiment


def _cmd_list(args) -> int:
    for name in available_experiments():
        exp = get_experiment(name)
        cells = ", ".join(c.name for c in exp.cells)
        print(f"{name:10s} [{exp.figure}] {exp.title}")
        print(f"{'':10s}   {exp.paper_ref}; cells: {cells}")
    return 0


def _cmd_run(args) -> int:
    if args.all:
        names = available_experiments()
    elif args.fig:
        names = list(dict.fromkeys(args.fig))     # keep order, dedupe
    else:
        print("error: pass --fig <name> (repeatable) or --all",
              file=sys.stderr)
        return 2
    try:
        exps = [get_experiment(n) for n in names]
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    if args.max_steps is not None:
        committed = os.path.realpath("results")
        targets = (os.path.realpath(args.out), os.path.realpath(args.artifacts))
        if any(t == committed or t.startswith(committed + os.sep)
               for t in targets):
            print("error: --max-steps truncates histories; the committed "
                  "results/ tree only holds full-length runs — pass "
                  "--out/--artifacts pointing at a scratch directory "
                  "(e.g. --out /tmp/exp-smoke --artifacts /tmp/exp-smoke/exp)",
                  file=sys.stderr)
            return 2
    failures = 0
    for name, exp in zip(names, exps):
        print(f"== {name}: {exp.title}")
        t0 = time.perf_counter()
        try:
            run_experiment(
                exp, args.out, args.artifacts, force=args.force,
                max_steps=args.max_steps, cells=args.cell or None,
                seeds=args.seed or None, progress_every=args.progress_every,
                device=args.device)
        except Exception as e:  # keep the sweep robust across experiments
            if len(names) == 1:
                raise
            print(f"  {name} FAILED: {type(e).__name__}: {e}",
                  file=sys.stderr)
            failures += 1
            continue
        finally:
            if {"xl", "stream"} & set(exp.tags):
                # XL and streaming problems pin GBs in build_problem's memo
                # (fig1-xxl's store on the host); evict so the
                # remaining (small, shared) figure problems rebuild cheaply
                build_problem.cache_clear()
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
        print(f"== {name} done in {time.perf_counter() - t0:.1f}s")
    return 1 if failures else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.exp",
                                 description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list registered experiments")
    rp = sub.add_parser("run", help="run experiments, write artifacts + CSVs")
    rp.add_argument("--fig", action="append", default=[],
                    help="experiment name (repeatable)")
    rp.add_argument("--all", action="store_true",
                    help="run every registered experiment (incl. fig1-xl)")
    rp.add_argument("--cell", action="append", default=[],
                    help="restrict to named cells (repeatable)")
    rp.add_argument("--seed", action="append", type=int, default=[],
                    help="override sweep seeds (repeatable)")
    rp.add_argument("--out", default="results",
                    help="figure CSV directory (default: results)")
    rp.add_argument("--artifacts", default="results/exp",
                    help="per-cell JSON directory (default: results/exp)")
    rp.add_argument("--force", action="store_true",
                    help="re-run cells even when a fresh artifact exists")
    rp.add_argument("--max-steps", type=int, default=None,
                    help="clamp every cell's round budget (smoke runs)")
    rp.add_argument("--progress-every", type=int, default=None,
                    help="stream (round, gap, Mbits) every N rounds (BL methods)")
    rp.add_argument("--device", default="cuda",
                    help="torch device the cells run on: cuda (default) or cpu")
    args = ap.parse_args(argv)
    return _cmd_list(args) if args.cmd == "list" else _cmd_run(args)


if __name__ == "__main__":
    sys.exit(main())
