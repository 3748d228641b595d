"""Resumable, schema-versioned artifacts for experiment sweeps — port of the
per-cell part of `repro.exp.artifacts` (the service-loop checkpoints come
with ROADMAP.md §1 item 14).

Two artifact kinds per experiment, byte-for-byte the reference's layout:

  * **Per-cell JSON** — ``<artifacts>/<experiment>/<cell>.seed<k>.json``:
    the full declarative config, a digest of it (resume key), the complete
    `History` streams *including the CommLedger per-leg bit streams*
    (hess_up / grad_up / model_down / basis_ship), and the headline
    bits-to-tolerance record with its reached/not-reached flag.
  * **Figure CSV** — ``<out>/<experiment>_<cell>.csv``: the plottable curve
    (``iter,gap,up_bits_per_node,down_bits_per_node`` then one column per
    ledger leg; legs are empty for methods without a ledger).

Resume contract: a sweep re-run skips any (cell, seed) whose JSON exists
with a matching ``config_digest`` — the same digest the reference computes
from the same config, so the reference's committed artifacts resume as the
port's own.  ``runtime_s`` is the only field whose value differs by nature.
"""
from __future__ import annotations

import csv
import dataclasses
import hashlib
import json
import os
from typing import Optional

import numpy as np

from .metrics import bits_to_tol

SCHEMA_VERSION = 1
SCHEMA = f"repro.exp/cell@{SCHEMA_VERSION}"

#: figure-CSV column schema: historical 4-column prefix + ledger legs
CSV_COLUMNS = (
    "iter", "gap", "up_bits_per_node", "down_bits_per_node",
    "hess_up_bits", "grad_up_bits", "model_down_bits", "basis_ship_bits",
)
LEG_NAMES = ("hess_up", "grad_up", "model_down", "basis_ship")


def cell_config(exp, cell, seed: int, steps: int) -> dict:
    """The exact declarative inputs of one run, as plain JSON data."""
    return {
        "schema": SCHEMA,
        "experiment": exp.name,
        "problem": dataclasses.asdict(exp.problem),
        "cell": dataclasses.asdict(cell),
        "seed": seed,
        "steps": steps,          # effective steps (CLI --max-steps clamps)
        "tol": exp.tol,
    }


def config_digest(config: dict) -> str:
    """Stable digest of a cell config — the resume/invalidate key."""
    blob = json.dumps(config, sort_keys=True, default=str).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


def cell_record(exp, cell, seed: int, steps: int, hist,
                runtime_s: Optional[float] = None) -> dict:
    """Build the full per-cell artifact record from a finished `History`."""
    config = cell_config(exp, cell, seed, steps)
    b2t = bits_to_tol(hist, exp.tol)
    legs = None
    if hist.legs is not None:
        legs = {name: [float(v) for v in hist.legs[name]]
                for name in LEG_NAMES}
    history = {
        "gaps": [float(g) for g in hist.gaps],
        "up_bits": [float(b) for b in hist.up_bits],
        "down_bits": [float(b) for b in hist.down_bits],
        "legs": legs,
    }
    if getattr(hist, "metrics", None):
        # extra named eval streams (e.g. the BL-DNN loss curve) — the key
        # is present only when the method emits them, so artifacts of
        # stream-less methods keep their exact history shape
        history["metrics"] = {k: [float(v) for v in vs]
                              for k, vs in hist.metrics.items()}
    return {
        "schema": SCHEMA,
        "experiment": exp.name,
        "cell": cell.name,
        "seed": seed,
        "config_digest": config_digest(config),
        "config": config,
        "history": history,
        "bits_to_tol": {
            "tol": exp.tol,
            "mbits_per_node": (None if not b2t.reached else b2t.mbits),
            "reached": b2t.reached,
        },
        "runtime_s": runtime_s,
    }


def artifact_path(artifacts_dir: str, exp_name: str, cell_name: str,
                  seed: int) -> str:
    return os.path.join(artifacts_dir, exp_name,
                        f"{cell_name}.seed{seed}.json")


def write_json(path: str, record: dict) -> str:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
        f.write("\n")
    return path


def load_json(path: str) -> Optional[dict]:
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError):
        return None       # truncated/corrupt partial artifact → re-run


def csv_path(out_dir: str, exp_name: str, cell_name: str) -> str:
    return os.path.join(out_dir, f"{exp_name}_{cell_name}.csv")


def write_fig_csv(out_dir: str, record: dict) -> str:
    """Write one figure curve CSV from a per-cell artifact record."""
    os.makedirs(out_dir, exist_ok=True)
    path = csv_path(out_dir, record["experiment"], record["cell"])
    h = record["history"]
    gaps, up, down = h["gaps"], h["up_bits"], h["down_bits"]
    legs = h.get("legs")
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(CSV_COLUMNS)
        for i in range(len(gaps)):
            row = [i, np.float64(gaps[i]), np.float64(up[i]),
                   np.float64(down[i])]
            if legs is not None:
                row += [np.float64(legs[name][i]) for name in LEG_NAMES]
            else:
                row += ["", "", "", ""]
            w.writerow(row)
    return path
