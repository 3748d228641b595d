"""The JAX package's reference for the PyTorch port's basis grid and its
Table 2 run (`repro_torch.exp.problems.BASIS_GRID`, `TABLE2_A1A`):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/basis_grid_reference.py [--out PATH]

The grid is ``benchmarks/run.py::basis_matrix``: BL1 on fig1r1's problem
(n=10, m=60, d=120, r=24, seed 0, the "loop" Newton optimum) for 16
rounds with an Identity model stream, in each of the bases ``standard``,
``symmetric``, ``data_outer``, ``eigen`` and ``dct``, under Top-K with
K = r² = 576 and under Rank-2.  The Table 2 run is BL1 on the ``a1a``
regime (n=16, m=100, d=123, r=64) in the data basis with Top-64 for 12
rounds.  Every run is the reference's ``backend="fast"``; none draws, so
the threefry setting does not matter (the file records False, the
port's default).  The file holds each run's whole history (gaps, the
uplink and downlink bits and every ledger leg) under ``runs``, keyed by
the port's cell name.  Writes
``src/repro_torch/exp/data/basis_grid_seed0.json`` by default.
"""
from __future__ import annotations

import argparse
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "exp" / "data" / "basis_grid_seed0.json"
BASES = ("standard", "symmetric", "data_outer", "eigen", "dct")
GRID_STEPS, R = 16, 24
A1A_STEPS, A1A_K = 12, 64


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    import jax

    from repro.core import bl, compressors
    from repro.exp import engine, registry

    def history(h):
        return {"gaps": h.gaps, "up_bits": h.up_bits, "down_bits": h.down_bits,
                "legs": h.legs}

    runs = {}
    with jax.threefry_partitionable(False):
        prob = engine.build_problem(registry.get_experiment("fig1r1").problem)
        comps = {"topk": compressors.TopK(k=R * R), "rankr": compressors.RankR(r=2)}
        for name in BASES:
            for kind, comp in comps.items():
                h = bl.bl1(prob.clients, prob.bases(name), [comp] * prob.n,
                           compressors.Identity(), prob.x0, prob.x_star, GRID_STEPS,
                           backend="fast")
                runs[f"{name}_{kind}"] = history(h)
        a1a = engine.build_problem(registry.ProblemSpec(kind="table2", name="a1a"))
        h = bl.bl1(a1a.clients, a1a.bases("data_outer"),
                   [compressors.TopK(k=A1A_K)] * a1a.n, compressors.Identity(),
                   a1a.x0, a1a.x_star, A1A_STEPS, backend="fast")
        runs["a1a_BL1"] = history(h)

    out = {"config": {"grid": {"problem": "fig1r1", "steps": GRID_STEPS, "bases": list(BASES),
                               "topk_k": R * R, "rankr_r": 2, "model_comp": "identity"},
                      "a1a": {"problem": "table2/a1a", "steps": A1A_STEPS, "basis": "data_outer",
                              "topk_k": A1A_K, "model_comp": "identity"},
                      "backend": "fast", "seed": 0},
           "threefry_partitionable": False, "runs": runs}
    pathlib.Path(args.out).write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {args.out}: {sorted(runs)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
