"""The problems and cells of BL1's main path — port of the synthetic part
of `repro.exp.registry.ProblemSpec` and `repro.exp.engine.build_problem`.

Two registered cells, each with its committed reference artifact:

  * `FIG1R1`  — the paper's headline cell (``src/repro/exp/registry.py``
    lines 194-218): n=10, m=60, d=120, r=24, Top-K k=24, 12 rounds, the
    "loop" Newton reference;
  * `FIG1_XL` — the full-width cell (registry lines 359-378): n=512, m=32,
    d=1200, r=32, Top-K k=r²=1024, 8 rounds, the "fused" Newton reference.
    Its block-mode Hessian reconstruction is a (512, 1200, 1200) float64
    stream, about 5.9 GB a round.  The reference registers it on the
    sharded backend, which is bitwise equal to the single-device one; the
    port runs it on one card with the "fast" backend.

Both run BL1 with the ``data_outer`` basis and an Identity model stream.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, List

import torch

from .. import device as _device
from ..core import basis as _basis
from ..core import bl, client_batch, glm
from ..core.compressors import Identity, TopK

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """A synthetic federated GLM regime (`glm.make_synthetic`) plus the
    reference-optimum solver: "loop" is `glm.newton_solve`, "fused" is
    `client_batch.newton_solve_fused` (no (n, d, d) intermediate)."""

    kind: str = "synthetic"
    seed: int = 0
    n_clients: int = 10
    m: int = 60
    d: int = 120
    r: int = 24
    lam: float = 1e-3
    newton_iters: int = 20
    solver: str = "loop"


@dataclasses.dataclass(frozen=True)
class BL1Cell:
    """One BL1 curve: data basis, Top-K(k) Hessian compressor, Identity
    model stream, `steps` rounds at seed 0, and its committed artifact."""

    experiment: str
    problem: ProblemSpec
    steps: int
    k: int
    basis: str = "data_outer"

    @property
    def artifact(self) -> pathlib.Path:
        return REPO_ROOT / "results" / "exp" / self.experiment / "BL1.seed0.json"


FIG1R1 = BL1Cell("fig1r1", ProblemSpec(), steps=12, k=24)
FIG1_XL = BL1Cell("fig1-xl", ProblemSpec(seed=0, n_clients=512, m=32, d=1200,
                                         r=32, lam=1e-3, newton_iters=12,
                                         solver="fused"),
                  steps=8, k=32 * 32)


@dataclasses.dataclass
class Problem:
    """A built regime: data, initial iterate, reference optimum, and the
    per-client basis fleets (built once per name)."""

    spec: ProblemSpec
    clients: List[glm.ClientData]
    x0: torch.Tensor
    x_star: torch.Tensor
    _bases: Dict[str, list] = dataclasses.field(default_factory=dict)

    @property
    def n(self) -> int:
        return len(self.clients)

    def bases(self, name: str) -> list:
        if name not in self._bases:
            self._bases[name] = _basis.make_bases(name, self.clients, x0=self.x0)
        return self._bases[name]


def build_problem(spec: ProblemSpec, *, device=None) -> Problem:
    """Materialize a synthetic `ProblemSpec` on `device`."""
    if spec.kind != "synthetic":
        raise NotImplementedError(
            f"problem kind {spec.kind!r} is not ported yet: ROADMAP.md §1 "
            "items 10 (table2) and 15 (synthetic_stream) bring it")
    dev = _device.resolve(device)
    clients = glm.make_synthetic(seed=spec.seed, n_clients=spec.n_clients,
                                 m=spec.m, d=spec.d, r=spec.r, lam=spec.lam,
                                 device=dev)
    x0 = torch.zeros(spec.d, dtype=torch.float64, device=dev)
    if spec.solver == "fused":
        batch = client_batch.from_clients(clients)
        x_star = client_batch.newton_solve_fused(batch, x0, spec.newton_iters)
    elif spec.solver == "loop":
        x_star = glm.newton_solve(clients, x0, spec.newton_iters)
    else:
        raise ValueError(f"unknown solver {spec.solver!r}")
    return Problem(spec=spec, clients=clients, x0=x0, x_star=x_star)


def run_cell(cell: BL1Cell, prob: Problem, *, steps=None,
             backend: str = "fast") -> bl.History:
    """Run a BL1 cell through the public `bl.bl1` entry point, on the
    problem's device."""
    return bl.bl1(prob.clients, prob.bases(cell.basis), [TopK(k=cell.k)] * prob.n,
                  Identity(), prob.x0, prob.x_star,
                  cell.steps if steps is None else steps, backend=backend,
                  device=prob.x0.device)
