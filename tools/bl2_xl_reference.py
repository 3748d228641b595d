"""The JAX package's reference for BL2 at fig1-xl's widths, for the
PyTorch port's ``bl2-xl`` run (`repro_torch.exp.problems.BL2_XL`):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/bl2_xl_reference.py [--out PATH]

The run: n=512 clients, m=32, d=1200, r=32, the data basis with Top-K
k = r² = 1024 in (n, r, r) blocks, τ = 256 expected participants, p = 1,
an Identity model stream, seed 0, 8 rounds, draws under
``jax_threefry_partitionable=False``.  At full width the reference carries
a (512, 1200, 1200) float64 stream (5.9 GB) and makes several more a
round, more than a CPU host shared with other work should hold, so this
tool computes what does not need that stream:

  * ``masks``: each round's participation mask (512 bits as a string of
    0/1), drawn by the reference's own `rounds.participation` from the
    keys its BL2 splits each round;
  * ``history``: the reference's `bl.bl2` on the same fleet narrowed to
    d = 40 (every other width and the seed unchanged): gaps and every bit
    stream, the port's narrow twin cell (`problems.BL2_XL_NARROW`);
  * ``xl``: the bit streams at d = 1200.  The Hessian leg bills Top-K of
    the r × r block, so it does not depend on d; the gradient, model and
    basis legs bill d floats a participant (d·r a client for the basis),
    so they grow as d.  The tool checks both on a second narrow run
    (d = 80) and scales d = 40's streams by 1200/40; every value is an
    integer number of bits, so the scaling is exact.

The gaps at full width are not in the file: the port's run is held to its
own float64 rerun, bitwise, and the masks and bit streams to this file.
Writes ``src/repro_torch/exp/data/bl2_xl_seed0.json`` by default.
"""
from __future__ import annotations

import argparse
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "exp" / "data" / "bl2_xl_seed0.json"
N, M, D, R, K, TAU, STEPS, SEED = 512, 32, 1200, 32, 1024, 256, 8, 0
NARROW = (40, 80)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    import jax
    import numpy as np

    from repro.core import bl, compressors, rounds
    from repro.exp import engine, registry

    runs = {}
    with jax.threefry_partitionable(False):
        keys = jax.random.split(jax.random.PRNGKey(SEED), STEPS)
        masks = []
        for t in range(STEPS):
            k_part = jax.random.split(keys[t], 4)[0]
            mask, _ = rounds.participation(rounds.VmapReducer(n=N), k_part, TAU)
            masks.append("".join("1" if b else "0" for b in np.asarray(mask)))
        for d in NARROW:
            spec = registry.ProblemSpec(seed=SEED, n_clients=N, m=M, d=d, r=R, lam=1e-3,
                                        newton_iters=12, solver="fused")
            prob = engine.build_problem(spec)
            h = bl.bl2(prob.clients, prob.bases("data_outer"), [compressors.TopK(k=K)] * N,
                       [compressors.Identity()] * N, prob.x0, prob.x_star, STEPS,
                       tau=TAU, seed=SEED, backend="fast")
            runs[d] = {"gaps": h.gaps, "up_bits": h.up_bits, "down_bits": h.down_bits,
                       "legs": h.legs}

    lo, hi = (runs[d]["legs"] for d in NARROW)
    scale = NARROW[1] // NARROW[0]
    if hi["hess_up"] != lo["hess_up"]:
        raise AssertionError("the Hessian leg depends on d")
    for leg in ("grad_up", "model_down", "basis_ship"):
        if hi[leg] != [scale * v for v in lo[leg]]:
            raise AssertionError(f"the {leg} leg does not grow as d")
    f = D // NARROW[0]
    legs = {"hess_up": lo["hess_up"],
            **{leg: [f * v for v in lo[leg]] for leg in ("grad_up", "model_down", "basis_ship")}}
    xl = {"up_bits": [h + g + b for h, g, b in zip(legs["hess_up"], legs["grad_up"],
                                                    legs["basis_ship"])],
          "down_bits": legs["model_down"], "legs": legs}
    out = {
        "schema": "repro_torch/bl2-xl-reference@1",
        "generator": "tools/bl2_xl_reference.py",
        "jax": jax.__version__, "threefry_partitionable": False,
        "config": {"method": "bl2", "n_clients": N, "m": M, "d": D, "r": R, "lam": 1e-3,
                   "basis": "data_outer", "hess_comp": {"kind": "topk", "k": K},
                   "model_comp": {"kind": "identity"}, "tau": TAU, "p": 1.0,
                   "seed": SEED, "steps": STEPS, "narrow_d": NARROW[0]},
        "masks": masks,
        "participants": [m.count("1") for m in masks],
        "xl": xl,
        "history": runs[NARROW[0]],
    }
    path = pathlib.Path(args.out)
    path.write_text(json.dumps(out, indent=1) + "\n")
    print(f"wrote {path} ({path.stat().st_size} bytes); participants a round: "
          f"{out['participants']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
