"""Resumable, schema-versioned artifacts for experiment sweeps and the
service loop's checkpoints — port of `repro.exp.artifacts`, with the
program cache's entry schema tag (`PROGCACHE_SCHEMA`) beside the
checkpoint schemas.

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

Service-loop checkpoints (``repro.exp/ckpt@2``, `save_checkpoint` /
`load_checkpoint`) have the reference's file layout and manifest, so
either package loads a checkpoint the other wrote.  Whether the serve loop
resumes it is the loop's decision: a carry held in a computed basis must
name that basis (`repro_torch.launch.fed_serve.basis_fingerprint`).
"""
from __future__ import annotations

import csv
import dataclasses
import hashlib
import json
import os
import zipfile
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


# ==========================================================================
# Service-loop checkpoints (repro_torch.launch.fed_serve)
# ==========================================================================
# A checkpoint is a pair of files in the checkpoint directory:
#
#   ckpt-<t>.npz    — the flattened carry (``carry/<i>`` per leaf, in
#                     `rounds.carry_leaves` order, the reference's
#                     `init_serve_carry` flattening), the accumulated history
#                     streams (``stream/<name>``), the host state
#                     (``host/<name>``) and the run's root PRNG key data
#                     (``root_key``, uint32 (2,)).
#   ckpt-<t>.json   — the manifest: schema tag, the serve config digest
#                     (resume key — a changed config invalidates the
#                     checkpoint), round counter, per-leaf shapes/dtypes,
#                     the stream and host-state names, and the sha256 of the
#                     npz payload.
#
# Writes are atomic (tmp file + os.replace, npz before manifest) so a crash
# mid-write never leaves a manifest pointing at a torn payload; the loader
# walks checkpoints newest-first and falls back past any whose payload is
# missing, torn, or fails the digest — so the latest *valid* checkpoint
# wins even after a worst-case crash.  @2 carries the optional host_state
# plane (the cohort-streaming engine's host-resident client store, fleet
# totals and frozen epoch statistics, `CohortEngine.checkpoint_payload`);
# stacked serves write an empty host_state list, and @1 checkpoints are
# walked past (an old run restarts from round 0).
CKPT_SCHEMA_VERSION = 2
CKPT_SCHEMA = f"repro.exp/ckpt@{CKPT_SCHEMA_VERSION}"

SERVE_SCHEMA_VERSION = 1
SERVE_SCHEMA = f"repro.exp/serve@{SERVE_SCHEMA_VERSION}"

# the program cache's entry schema lives with its validation in
# `repro_torch.core.progcache`; re-exported here so every schema tag the
# port writes is enumerable from one module
from ..core.progcache import PROGCACHE_SCHEMA  # noqa: E402,F401


def _ckpt_base(ckpt_dir: str, t: int) -> str:
    return os.path.join(ckpt_dir, f"ckpt-{t:08d}")


def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _atomic_replace(tmp: str, dst: str) -> None:
    os.replace(tmp, dst)
    # best-effort directory fsync so the rename itself survives power loss
    try:
        dfd = os.open(os.path.dirname(dst) or ".", os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
    except OSError:
        pass


def save_checkpoint(ckpt_dir: str, *, t: int, carry_leaves, streams: dict,
                    root_key, config_digest: str, keep: int = 3,
                    host_state: Optional[dict] = None) -> str:
    """Atomically write the service loop's full server state at round ``t``.

    ``carry_leaves`` is the flattened carry (numpy arrays, in
    `rounds.carry_leaves` order); ``streams`` maps stream name → accumulated
    (t, ...) array (eval iterates, per-leg ledger bit streams, events);
    ``root_key`` is the raw PRNG key data, uint32 (2,).  ``config_digest``
    keys the checkpoint to one serve configuration.  ``host_state``
    (ckpt@2) is an optional dict of named host arrays — the cohort engine's
    `CohortEngine.checkpoint_payload`; stacked serves omit it.  Keeps the
    newest ``keep`` checkpoints and prunes the rest.  Returns the manifest
    path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    base = _ckpt_base(ckpt_dir, t)
    host_state = host_state or {}
    payload = {f"carry/{i}": np.asarray(leaf)
               for i, leaf in enumerate(carry_leaves)}
    for name, arr in streams.items():
        payload[f"stream/{name}"] = np.asarray(arr)
    for name, arr in host_state.items():
        payload[f"host/{name}"] = np.asarray(arr)
    payload["root_key"] = np.asarray(root_key)
    tmp = base + ".npz.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **payload)
        f.flush()
        os.fsync(f.fileno())
    _atomic_replace(tmp, base + ".npz")
    manifest = {
        "schema": CKPT_SCHEMA,
        "config_digest": config_digest,
        "t": int(t),
        "n_carry_leaves": len(carry_leaves),
        "carry_leaves": [{"shape": list(np.asarray(x).shape),
                          "dtype": str(np.asarray(x).dtype)}
                         for x in carry_leaves],
        "streams": sorted(streams),
        "host_state": sorted(host_state),
        "payload_sha256": _sha256_file(base + ".npz"),
    }
    tmp = base + ".json.tmp"
    with open(tmp, "w") as f:
        json.dump(manifest, f, indent=1)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    _atomic_replace(tmp, base + ".json")
    prune_checkpoints(ckpt_dir, keep=keep)
    return base + ".json"


def list_checkpoints(ckpt_dir: str):
    """(round, manifest path) pairs, oldest first."""
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for f in sorted(os.listdir(ckpt_dir)):
        if f.startswith("ckpt-") and f.endswith(".json"):
            try:
                t = int(f[len("ckpt-"):-len(".json")])
            except ValueError:
                continue
            out.append((t, os.path.join(ckpt_dir, f)))
    return out


def prune_checkpoints(ckpt_dir: str, keep: int) -> None:
    for t, manifest in list_checkpoints(ckpt_dir)[:-keep if keep else None]:
        for ext in (".json", ".npz"):
            try:
                os.remove(_ckpt_base(ckpt_dir, t) + ext)
            except OSError:
                pass


def load_checkpoint(ckpt_dir: str, *, config_digest: Optional[str] = None):
    """The newest valid checkpoint as a dict
    ``{t, carry_leaves, streams, root_key, host_state, manifest}`` — or
    None.

    Walks newest-first, skipping checkpoints whose manifest or payload is
    torn/corrupt (digest mismatch), that belong to a different serve
    config, or that carry an older schema tag (a ckpt@1 directory restarts
    from round 0 instead of crashing) — a crash during `save_checkpoint`
    therefore falls back to the previous intact checkpoint instead of
    resuming garbage."""
    for t, manifest_path in reversed(list_checkpoints(ckpt_dir)):
        manifest = load_json(manifest_path)
        if manifest is None or manifest.get("schema") != CKPT_SCHEMA:
            continue
        if (config_digest is not None
                and manifest.get("config_digest") != config_digest):
            continue
        npz_path = _ckpt_base(ckpt_dir, t) + ".npz"
        if not os.path.exists(npz_path):
            continue
        if _sha256_file(npz_path) != manifest.get("payload_sha256"):
            continue
        try:
            with np.load(npz_path) as z:
                n = manifest["n_carry_leaves"]
                carry = [z[f"carry/{i}"] for i in range(n)]
                streams = {name: z[f"stream/{name}"]
                           for name in manifest["streams"]}
                host_state = {name: z[f"host/{name}"]
                              for name in manifest.get("host_state", [])}
                root_key = z["root_key"]
        except (OSError, KeyError, ValueError, zipfile.BadZipFile):
            continue
        return {"t": manifest["t"], "carry_leaves": carry,
                "streams": streams, "root_key": root_key,
                "host_state": host_state, "manifest": manifest}
    return None


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
