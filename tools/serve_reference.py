"""The JAX package's service-loop records, for the PyTorch port's serve
phase and tests (`repro_torch.launch.fed_serve`):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/serve_reference.py [--out PATH]

Runs `python -m repro.launch.fed_serve`'s ``main`` in-process on the CPU
under ``jax_threefry_partitionable=False`` (the port's default, and the
setting of every committed artifact) with ``--no-progcache``, each case in
a fresh temporary checkpoint directory, for the cases in `CASES`:

  * fig4/``BL2_tau_half``: the reference CI's serve-smoke command (seed 3,
    30 rounds in chunks of 6, i.i.d. dropout 0.2, fault seed 11);
  * fig4/``BL3_tau_half``: clients 0 and 1 down over rounds 4–11 and a
    straggler model (mean 0.1 s, a fifth of the fleet persistently slow);
  * fig1-bag/``BAG_q0.5``: clients 0–8 down over rounds 2–5, 8 rounds in
    chunks of 4, then the same command raised to 24 rounds, which extends
    the finished run from its round-8 checkpoint.

Each case stores its command-line arguments (``args``, without
``--ckpt-dir``/``--result``/``--device``) and the serve record without its
``meta`` (config, digest, gaps, bits, events).  Floats are written by
`json` as their shortest round-trip ``repr``.  Writes
``src/repro_torch/exp/data/fed_serve_ref.json`` by default; takes ~1 min.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import sys
import tempfile

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "src" / "repro_torch" / "exp" / "data" / "fed_serve_ref.json"

_BAG_OUTAGES = [a for c in range(9) for a in ("--outage", f"{c}:2:6")]
#: (case name, arguments, checkpoint directory shared with an earlier case)
CASES = (
    ("fig4/BL2_tau_half", ["--exp", "fig4", "--cell", "BL2_tau_half", "--seed", "3",
                           "--max-rounds", "30", "--chunk", "6", "--dropout-p", "0.2",
                           "--fault-seed", "11"], None),
    ("fig4/BL3_tau_half", ["--exp", "fig4", "--cell", "BL3_tau_half", "--seed", "0",
                           "--max-rounds", "24", "--chunk", "6", "--outage", "0:4:12",
                           "--outage", "1:4:12", "--straggler-mean", "0.1",
                           "--slow-frac", "0.2"], None),
    ("fig1-bag/BAG_q0.5@8", ["--exp", "fig1-bag", "--cell", "BAG_q0.5", "--seed", "1",
                             "--max-rounds", "8", "--chunk", "4", *_BAG_OUTAGES], None),
    ("fig1-bag/BAG_q0.5@24", ["--exp", "fig1-bag", "--cell", "BAG_q0.5", "--seed", "1",
                              "--max-rounds", "24", "--chunk", "4", *_BAG_OUTAGES],
     "fig1-bag/BAG_q0.5@8"),
)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(OUT))
    args = ap.parse_args()
    import jax
    import numpy as np

    from repro.launch import fed_serve

    out = {"jax": jax.__version__, "numpy": np.__version__,
           "jax_threefry_partitionable": False, "cases": {}}
    with tempfile.TemporaryDirectory() as tmp, jax.threefry_partitionable(False):
        for name, argv, shared in CASES:
            ckpt = pathlib.Path(tmp) / (shared or name).replace("/", "_")
            result = pathlib.Path(tmp) / (name.replace("/", "_") + ".json")
            with contextlib.redirect_stdout(sys.stderr):
                fed_serve.main([*argv, "--ckpt-dir", str(ckpt), "--result", str(result),
                                "--no-progcache"])
            rec = json.loads(result.read_text())
            meta = rec.pop("meta")
            if shared is not None and meta["resumed_from"] is None:
                raise AssertionError(f"{name}: did not extend {shared}'s run")
            out["cases"][name] = {"args": argv, "resumed_from": meta["resumed_from"],
                                  "record": rec}
            print(f"{name}: digest {rec['config_digest']}, gaps {rec['history']['gaps'][0]:.4e}"
                  f" → {rec['history']['gaps'][-1]:.4e}, {rec['degraded_rounds']} degraded",
                  file=sys.stderr)
    pathlib.Path(args.out).write_text(json.dumps(out) + "\n")
    print(f"wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
