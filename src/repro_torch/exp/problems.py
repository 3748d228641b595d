"""The problems and cells of the port's main paths — port of the synthetic
part of `repro.exp.registry` (`ProblemSpec`, `DNNProblemSpec` and their
cells) and of `repro.exp.engine.build_problem` / ``run_cell``.

GLM cells (`GLMCell`), each with its committed reference artifact and
run through a public entry point by `run_cell`:

  * `FIG1R1`  — the paper's headline cell (``src/repro/exp/registry.py``
    lines 203-218): BL1, data basis, n=10, m=60, d=120, r=24, Top-K k=24,
    12 rounds, the "loop" Newton reference;
  * `FIG1R1_CELLS` — that cell and fig1r1's ``Newton`` (no basis, 12
    rounds) and ``FedNL`` (BL1 in the standard basis with a Rank-1
    Hessian compressor, 12 rounds); NL1 waits for the PRNG port;
  * `FIG2` — ``newton_std`` and ``newton_basis`` (registry lines 258-268):
    Newton without a basis and in the data basis, 10 rounds, on the same
    problem;
  * `FIG1_XL` — the full-width cell (registry lines 359-378): n=512, m=32,
    d=1200, r=32, Top-K k=r²=1024, 8 rounds, the "fused" Newton reference.
    Its block-mode Hessian reconstruction is a (512, 1200, 1200) float64
    stream, about 5.9 GB a round.  The reference registers it on the
    sharded backend, which is bitwise equal to the single-device one; the
    port runs it on one card with the "fast" backend.

Every BL1 cell runs an Identity model stream with α = η = p = 1, as the
reference's ``engine.run_cell`` does when a cell sets no params.

The BL-DNN cells of ``fig-dnn`` (registry lines 437-468: BLDNN, TopK,
RTopK, FedAvg) and ``fig-dnn-ship`` (lines 478-509) on `DNN_FIG`, the
widest BL-DNN model the reference registers: n=8 clients, m=64, d=96,
width 32, 4 classes.  The reference draws that problem from
``jax.random``; the port loads it, carried across, from `DNN_FIXTURE`
(`load_dnn_problem`): the data, the student's parameters and the
per-layer SVD factors, written by the reference with
``jax_threefry_partitionable=False``, the setting its committed artifacts
were written under (``tests/test_torch_bldnn.py`` regenerates it).
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..core import basis as _basis
from ..core import baselines, bl, client_batch, glm
from ..core.compressors import Identity, RankR, TopK
from ..core.convert import dnn_problem_from_numpy
from ..core.pytree import tree_leaves
from ..fed import bldnn

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
#: the carried fig-dnn problem (seed 0)
DNN_FIXTURE = pathlib.Path(__file__).resolve().parent / "data" / "fig_dnn_seed0.npz"


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
class GLMCell:
    """One GLM curve at seed 0: ``method`` "bl1" (with an Identity model
    stream) or "newton", the basis registry name (None: Newton without a
    basis), the Hessian compressor as ``(kind, size)`` — ``("topk", k)``
    or ``("rankr", r)``, BL1 only — `steps` rounds, and its committed
    artifact."""

    experiment: str
    name: str
    problem: ProblemSpec
    steps: int
    method: str = "bl1"
    basis: Optional[str] = None
    hess_comp: Optional[Tuple[str, int]] = None

    @property
    def artifact(self) -> pathlib.Path:
        return REPO_ROOT / "results" / "exp" / self.experiment / f"{self.name}.seed0.json"


FIG1R1 = GLMCell("fig1r1", "BL1", ProblemSpec(), 12, basis="data_outer",
                 hess_comp=("topk", 24))
FIG1R1_CELLS: Dict[str, GLMCell] = {c.name: c for c in (
    FIG1R1,
    GLMCell("fig1r1", "FedNL", ProblemSpec(), 12, basis="standard",
            hess_comp=("rankr", 1)),
    GLMCell("fig1r1", "Newton", ProblemSpec(), 12, method="newton"),
)}
FIG2: Dict[str, GLMCell] = {c.name: c for c in (
    GLMCell("fig2", "newton_std", ProblemSpec(), 10, method="newton"),
    GLMCell("fig2", "newton_basis", ProblemSpec(), 10, method="newton",
            basis="data_outer"),
)}
FIG1_XL = GLMCell("fig1-xl", "BL1", ProblemSpec(seed=0, n_clients=512, m=32, d=1200,
                                                r=32, lam=1e-3, newton_iters=12,
                                                solver="fused"),
                  8, basis="data_outer", hess_comp=("topk", 32 * 32))


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


_HESS_COMPS = {"topk": lambda k: TopK(k=k), "rankr": lambda r: RankR(r=r)}


def run_cell(cell: GLMCell, prob: Problem, *, steps=None, backend: str = "fast",
             basis_project: str = "einsum") -> bl.History:
    """Run a GLM cell through its public entry point (`bl.bl1` or
    `baselines.newton`) on the problem's device; ``basis_project`` routes
    the data basis's Γ = VᵀAV (see `bl.bl1`)."""
    steps = cell.steps if steps is None else steps
    bases = prob.bases(cell.basis) if cell.basis else None
    if cell.method == "newton":
        return baselines.newton(prob.clients, prob.x0, prob.x_star, steps, bases=bases,
                                backend=backend, device=prob.x0.device,
                                basis_project=basis_project)
    kind, size = cell.hess_comp
    return bl.bl1(prob.clients, bases, [_HESS_COMPS[kind](size)] * prob.n, Identity(),
                  prob.x0, prob.x_star, steps, backend=backend, device=prob.x0.device,
                  basis_project=basis_project)


# ==========================================================================
# BL-DNN: fig-dnn and fig-dnn-ship
# ==========================================================================
@dataclasses.dataclass(frozen=True)
class DNNProblemSpec:
    """The BL-DNN regime (`repro.exp.registry.DNNProblemSpec`): a
    teacher-labelled classification fleet with inputs in a shared
    r-dimensional subspace and a near-teacher student."""

    kind: str = "dnn_synthetic"
    seed: int = 0
    n_clients: int = 8
    m: int = 64                      # samples per client
    d: int = 96                      # input features
    classes: int = 4
    width: int = 32                  # MLP hidden width
    r: int = 8                       # intrinsic data rank
    heterogeneity: float = 0.5
    label_noise: float = 0.05


DNN_FIG = DNNProblemSpec()


@dataclasses.dataclass(frozen=True)
class DNNCell:
    """One BL-DNN curve: `compressor` kind for both legs, the pytree
    `basis` (None: no basis), `BLDNNConfig` overrides in `params`, and its
    committed artifact."""

    experiment: str
    name: str
    steps: int
    compressor: str
    basis: Optional[str] = None
    params: Tuple[Tuple[str, object], ...] = ()

    @property
    def artifact(self) -> pathlib.Path:
        return REPO_ROOT / "results" / "exp" / self.experiment / f"{self.name}.seed0.json"


_TOPK_PARAMS = (("top_k_frac", 0.1), ("lr", 0.05))
FIG_DNN: Dict[str, DNNCell] = {c.name: c for c in (
    DNNCell("fig-dnn", "BLDNN", 40, "topk", "per_layer_svd", _TOPK_PARAMS),
    DNNCell("fig-dnn", "TopK", 40, "topk", None, _TOPK_PARAMS),
    DNNCell("fig-dnn", "RTopK", 40, "rtopk", "per_layer_svd", _TOPK_PARAMS),
    DNNCell("fig-dnn", "FedAvg", 60, "identity", None,
            (("lr", 0.5), ("precondition", False))),
)}
FIG_DNN_SHIP: Dict[str, DNNCell] = {c.name: c for c in (
    DNNCell("fig-dnn-ship", "TopK", 40, "topk", None, _TOPK_PARAMS),
    DNNCell("fig-dnn-ship", "BLDNN_f32", 40, "topk", "per_layer_svd", _TOPK_PARAMS),
    DNNCell("fig-dnn-ship", "BLDNN_bf16", 40, "topk", "per_layer_svd",
            _TOPK_PARAMS + (("ship_float_bits", 16),)),
    DNNCell("fig-dnn-ship", "BLDNN_int8", 40, "topk", "per_layer_svd",
            _TOPK_PARAMS + (("ship_float_bits", 8),)),
    DNNCell("fig-dnn-ship", "BLDNN_dct", 40, "topk", "dct_tree", _TOPK_PARAMS),
    DNNCell("fig-dnn-ship", "BLDNN_hadamard", 40, "topk", "hadamard_tree", _TOPK_PARAMS),
)}


@dataclasses.dataclass
class DNNProblem:
    """A BL-DNN problem on a device: client-stacked data, the student's
    parameters, the carried per-layer SVD basis, and the loss/eval
    closures."""

    spec: DNNProblemSpec
    batch: client_batch.TreeBatch
    params0: dict
    basis: _basis.PerLayerSVDBasis
    loss_fn: object
    eval_fn: object


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def load_dnn_problem(path: pathlib.Path = DNN_FIXTURE, spec: DNNProblemSpec = DNN_FIG,
                     *, device=None) -> DNNProblem:
    """The carried BL-DNN problem from an ``.npz`` written by the reference:
    ``x``, ``y``, ``param:<leaf path>`` and ``U:``/``V:<leaf path>`` for
    every rotated leaf (leaf paths like ``mlp/wi``)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    params = _nest({k[len("param:"):]: v for k, v in arrays.items()
                    if k.startswith("param:")})
    paths = tree_leaves(_nest({k[len("param:"):]: k[len("param:"):]
                               for k in arrays if k.startswith("param:")}))
    UV = [(arrays[f"U:{p}"], arrays[f"V:{p}"]) if f"U:{p}" in arrays else None
          for p in paths]
    conv = dnn_problem_from_numpy(arrays["x"], arrays["y"], params, UV, device=device)
    if tuple(conv.batch.data["x"].shape) != (spec.n_clients, spec.m, spec.d):
        raise ValueError(f"{path} holds x of shape {tuple(conv.batch.data['x'].shape)}, "
                         f"not the ({spec.n_clients}, {spec.m}, {spec.d}) of {spec}")
    return DNNProblem(spec=spec, batch=conv.batch, params0=conv.params0,
                      basis=conv.basis, loss_fn=bldnn.make_loss_fn(spec.classes),
                      eval_fn=bldnn.make_eval_fn())


def run_dnn_cell(cell: DNNCell, prob: DNNProblem, *, steps=None) -> bl.History:
    """Run a BL-DNN cell through the public `run_bldnn` entry point on the
    problem's device; a ``per_layer_svd`` cell rotates with the carried
    factors."""
    cfg = bldnn.BLDNNConfig(compressor=cell.compressor,
                            use_basis=cell.basis is not None,
                            basis_kind=cell.basis or "per_layer_svd",
                            **dict(cell.params))
    basis = prob.basis if cell.basis == "per_layer_svd" else None
    device = tree_leaves(prob.params0)[0].device
    return bldnn.run_bldnn(prob.loss_fn, prob.eval_fn, prob.params0, prob.batch,
                           cell.steps if steps is None else steps, cfg,
                           basis=basis, device=device)
