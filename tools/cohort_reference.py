"""The JAX package's reference for the cohort-streaming experiments, for
the PyTorch port's ``fig1-xxl`` and ``cohort-smoke`` runs
(`repro_torch.exp.problems.FIG1_XXL`, `COHORT_SMOKE`):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/cohort_reference.py [--out PATH]

Runs the registered cells through the reference's own engine
(`repro.exp.engine.run_cell`, the ``cohort`` backend) under
``jax_threefry_partitionable=False`` (the port's default, and the setting
of every committed artifact), seed 0: fig1-xxl's BL2 and FedNL-BAG (n =
131,072 clients, m = 8, d = 24, cohorts of 512, 4 rounds a cohort, 16
rounds) and cohort-smoke's BL2 (n = 96, 16 a cohort, 2 rounds a cohort, 12
rounds).  For each experiment it records:

  * ``store_sha256``: sha256 of the store's ``A`` and ``b`` bytes (numpy's
    ``default_rng`` stream: a port on another numpy must fail here, not
    drift into a gap failure);
  * ``f_star`` and ``x_star``: the host Newton solve's optimum and loss;
  * ``cohorts``: each epoch's sorted cohort (`CohortEngine.cohort_indices`);
  * per cell, ``participants`` (BL2: each round's participating global
    indices, from the reference's `rounds._cohort_participation` on the
    keys its BL2 splits) or ``senders`` (FedNL-BAG: the global indices
    whose Bernoulli(q) report draw fired), and the history: ``gaps``,
    ``up_bits``, ``down_bits`` and ``legs``.

Floats are written by `json` as their shortest round-trip ``repr``.
Writes ``src/repro_torch/exp/data/fig1_xxl_seed0.json`` by default; takes
~40 s and ~2 GB of host memory (fig1-xxl's store and BL2's (n, 24, 24)
state).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "exp" / "data" / "fig1_xxl_seed0.json"
EXPERIMENTS = ("fig1-xxl", "cohort-smoke")


def store_sha256(store) -> dict:
    """sha256 of the store's data arrays, each as C-ordered float64 bytes."""
    import numpy as np

    return {name: hashlib.sha256(np.ascontiguousarray(getattr(store, name), np.float64)
                                 .tobytes()).hexdigest() for name in ("A", "b")}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.core import cohort, rounds
    from repro.exp import engine, registry

    out = {"jax": jax.__version__, "numpy": np.__version__,
           "jax_threefry_partitionable": False, "seed": 0, "experiments": {}}
    with jax.threefry_partitionable(False):
        for name in EXPERIMENTS:
            exp = registry.get_experiment(name)
            prob = engine.build_problem(exp.problem)
            store = prob.store
            entry = {"n": store.n, "store_sha256": store_sha256(store),
                     "x_star": [float(v) for v in prob.x_star],
                     "f_star": cohort.store_loss(store, prob.x_star), "runs": {}}
            for cell in exp.cells:
                params = cell.params_dict()
                csize, rpc = params["cohort"], params["rounds_per_cohort"]
                root = jax.random.PRNGKey(0)
                sampler = cohort.CohortEngine.__new__(cohort.CohortEngine)
                sampler.root_key, sampler.n, sampler.cohort, sampler.full = (
                    root, store.n, csize, False)
                sampler._seed64 = sampler._sampler_seed()
                epochs = [sampler.cohort_indices(e) for e in range(-(-cell.steps // rpc))]
                cohorts = [ep.tolist() for ep in epochs]
                if entry.setdefault("cohorts", cohorts) != cohorts:
                    raise AssertionError(f"{name}: the cells' cohorts differ")
                drawn = []
                for t in range(cell.steps):
                    idx = epochs[t // rpc]
                    key_t = jax.random.fold_in(root, t)
                    if cell.method == "bl2":
                        CR = rounds.CohortReducer(
                            rounds.VmapReducer(n=csize), idx=jnp.asarray(idx, jnp.int32),
                            real=jnp.ones(csize, bool), frozen={}, n_global=store.n)
                        part, _ = rounds._cohort_participation(
                            CR, jax.random.split(key_t, 4)[0], params["tau"], None)
                    else:
                        k_b = jax.random.split(key_t, 2)[1]
                        part = jax.random.bernoulli(k_b, params["q"], (csize,))
                    drawn.append(idx[np.asarray(part)].tolist())
                h = engine.run_cell(exp, cell, prob)
                entry["runs"][cell.name] = {
                    "participants" if cell.method == "bl2" else "senders": drawn,
                    "gaps": h.gaps, "up_bits": h.up_bits, "down_bits": h.down_bits,
                    "legs": h.legs}
                print(f"{name}/{cell.name}: gaps {h.gaps[0]:.4e} → {h.gaps[-1]:.4e}, "
                      f"up_bits {h.up_bits[-1]!r}", file=sys.stderr)
            out["experiments"][name] = entry
            engine.build_problem.cache_clear()
    pathlib.Path(args.out).write_text(json.dumps(out) + "\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
