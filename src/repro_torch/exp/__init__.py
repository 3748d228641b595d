"""Port of `repro.exp`: every paper figure as a registered, resumable,
schema-versioned sweep on the port's round engine.

    from repro_torch.exp import get_experiment, run_experiment

    run_experiment(get_experiment("fig1r1"), "/tmp/x", "/tmp/x/exp")

or from the shell: ``python -m repro_torch.exp run --fig fig1r1``.  See
`registry` for the catalogue, `artifacts` for the artifact schema, and
`problems` for the cells the tests and ``chip_smoke.py`` hold.
"""
from .artifacts import CSV_COLUMNS, SCHEMA, SCHEMA_VERSION
from .engine import Problem, build_compressor, build_problem, run_cell, run_experiment
from .metrics import BitsToTol, best_gap_stream, bits_to_tol
from .registry import (
    CompressorCfg,
    Experiment,
    MethodCell,
    ProblemSpec,
    available_experiments,
    get_experiment,
    register_experiment,
)

__all__ = [
    "BitsToTol",
    "CSV_COLUMNS",
    "CompressorCfg",
    "Experiment",
    "MethodCell",
    "Problem",
    "ProblemSpec",
    "SCHEMA",
    "SCHEMA_VERSION",
    "available_experiments",
    "best_gap_stream",
    "bits_to_tol",
    "build_compressor",
    "build_problem",
    "get_experiment",
    "register_experiment",
    "run_cell",
    "run_experiment",
]
