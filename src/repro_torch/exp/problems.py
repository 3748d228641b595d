"""The problems and cells of the port's main paths — port of the synthetic
part of `repro.exp.registry` (`ProblemSpec`, `DNNProblemSpec` and their
cells) and of `repro.exp.engine.build_problem` / ``run_cell``.

GLM cells (`GLMCell`), each with its committed reference artifact and
run through a public entry point by `run_cell`:

  * `FIG1R1`  — the paper's headline cell (``src/repro/exp/registry.py``
    lines 203-218): BL1, data basis, n=10, m=60, d=120, r=24, Top-K k=24,
    12 rounds, the "loop" Newton reference;
  * `FIG1R1_CELLS` — that cell and fig1r1's ``Newton`` (no basis, 12
    rounds), ``FedNL`` (BL1 in the standard basis with a Rank-1 Hessian
    compressor, 12 rounds) and ``NL1`` (line 215: NewtonLearn-1 with
    Rand-1, 12 rounds);
  * `FIG2` — ``newton_std`` and ``newton_basis`` (registry lines 258-268):
    Newton without a basis and in the data basis, 10 rounds, on the same
    problem;
  * `FIG1_XL` — the full-width cell (registry lines 359-378): n=512, m=32,
    d=1200, r=32, Top-K k=r²=1024, 8 rounds, the "fused" Newton reference.
    Its block-mode Hessian reconstruction is a (512, 1200, 1200) float64
    stream, about 5.9 GB a round.  The reference registers it on the
    sharded backend, which is bitwise equal to the single-device one; the
    port runs it on one card with the "fast" backend.

  * the stochastic paper cells, each drawing from `repro_torch.core.prng`
    (all written under ``jax_threefry_partitionable=False``): `FIG1R3`
    (lines 239-257: BL2 in the standard basis with Rank-1, RRank-1 and
    NRank-1, a Top-12 model stream, p = 0.1), `FIG3` (lines 270-288: BL2
    in the data basis with Top-24, RTop-24 and NTop-24, a Top-12 model
    stream, p = 0.1), `FIG4` (lines 289-307: BL2 in the data basis with
    Top-24 and BL3 with Top-120 at τ ∈ {10, 5, 2}, 24 rounds), `FIG5`
    (lines 322-330: BL1-BC at p = 0.5 and seed 3, BL2-BC, BL3-BC) and
    `FIG6` (lines 338-356: BL2 in the standard basis and BL3, Top-K both
    ways with k = ⌊p·d⌋, τ = 5, p ∈ {1, 1/3});
  * the rest of the paper's figures: `FIG1R2` (registry lines 220-237:
    BL1 against GD, DIANA and ADIANA with s = 10 dithering, and Local-GD
    with 5 local steps; 60 rounds, Local-GD 15), `FIG5_REST` (lines
    309-336: FedNL-BC, BL1 in the standard basis with Top-7200 on the
    Hessian's upper triangle and Top-60 on the model stream, 12 rounds;
    DORE with Top-60 both ways, 60 rounds) and `FIG1_BAG` (lines
    514-531: FedNL, and FedNL-BAG at q = 0.5 and at q = 1 with η = 1,
    Rank-1 in the standard basis, 24 rounds);
    `BASELINE_CELLS` holds these ten;
  * `BASIS_GRID` — BL1 on fig1r1's problem for 16 rounds in each of the
    ``standard``, ``symmetric``, ``data_outer``, ``eigen`` and ``dct``
    bases under Top-576 (K = r²) and Rank-2, the configurations of
    ``benchmarks/run.py::basis_matrix``, and `TABLE2_A1A`, BL1 on Table 2's
    ``a1a`` regime (n=16, m=100, d=123, r=64) in the data basis with
    Top-64 for 12 rounds.  No artifact exists for them: their reference,
    `BASIS_GRID_REFERENCE`, holds the JAX package's histories
    (``tools/basis_grid_reference.py``);
  * `BL2_XL` — BL2 at fig1-xl's widths (n=512, d=1200, Top-K k=r²=1024,
    block mode) with τ = 256, 8 rounds: no registered cell.  Its reference,
    `BL2_XL_REFERENCE`, written by the JAX package
    (``tools/bl2_xl_reference.py``), holds the participation masks and
    bit streams at full width and the whole history of `BL2_XL_NARROW`,
    the same run on the fleet narrowed to d = 40.

A cell's compressors are ``(kind, size)`` pairs (`make_compressor`) and
its ``params`` the keyword arguments the reference's ``engine.run_cell``
passes its entry point; a cell that sets none runs α = η = p = 1, full
participation and seed 0.

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
import json
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..core import basis as _basis
from ..core import baselines, bl, client_batch, glm
from ..core.compressors import (Compressor, Identity, RandomDithering, RankR, TopK, nrankr,
                                ntopk, rrankr, rtopk)
from ..core.convert import dnn_problem_from_numpy
from ..core.pytree import tree_leaves
from ..fed import bldnn

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DATA = pathlib.Path(__file__).resolve().parent / "data"
#: the carried fig-dnn problem (seed 0)
DNN_FIXTURE = DATA / "fig_dnn_seed0.npz"
#: the JAX package's BL2 trajectory at fig1-xl's widths (`BL2_XL`)
BL2_XL_REFERENCE = DATA / "bl2_xl_seed0.json"
#: the JAX package's histories of `BASIS_GRID` and `TABLE2_A1A`
BASIS_GRID_REFERENCE = DATA / "basis_grid_seed0.json"


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """A federated GLM regime plus the reference-optimum solver: kind
    "synthetic" draws `glm.make_synthetic` at these sizes, "table2" the
    named `glm.TABLE2` regime (its own sizes); solver "loop" is
    `glm.newton_solve`, "fused" `client_batch.newton_solve_fused` (no
    (n, d, d) intermediate)."""

    kind: str = "synthetic"
    name: Optional[str] = None
    seed: int = 0
    n_clients: int = 10
    m: int = 60
    d: int = 120
    r: int = 24
    lam: float = 1e-3
    newton_iters: int = 20
    solver: str = "loop"


#: compressor kinds of a cell: (kind, size) → compressor for a d-wide problem
_COMPRESSORS = {
    "identity": lambda size, d: Identity(),
    "topk": lambda k, d: TopK(k=k),
    "topk_sym": lambda k, d: TopK(k=k, symmetrize=True),
    "dither": lambda s, d: RandomDithering(s=s),
    "rankr": lambda r, d: RankR(r=r),
    "rtopk": lambda k, d: rtopk(k),
    "ntopk": lambda k, d: ntopk(k),
    "rrankr": lambda r, d: rrankr(r, d),
    "nrankr": lambda r, d: nrankr(r),
}


def make_compressor(kind_size: Tuple[str, int], d: int) -> Compressor:
    """The compressor of a cell's ``(kind, size)`` pair on a d-wide problem
    (the reference's ``engine.build_compressor``)."""
    kind, size = kind_size
    if kind not in _COMPRESSORS:
        raise ValueError(f"unknown compressor kind {kind!r} (expected one of "
                         f"{sorted(_COMPRESSORS)})")
    return _COMPRESSORS[kind](size, d)


@dataclasses.dataclass(frozen=True)
class GLMCell:
    """One GLM curve: ``method`` "bl1", "bl2", "bl3", "newton", "nl1",
    "fednl_bag", "gd", "diana", "adiana", "local_gd" or "dore", the basis
    registry name (None: no basis), the Hessian and model-stream
    compressors as ``(kind, size)`` pairs (the first-order methods'
    gradient compressor is ``hess_comp``, DORE's downlink ``model_comp``),
    `steps` rounds, the entry point's keyword ``params`` (``p``, ``tau``,
    ``q``, ``eta``, ``seed``), and its reference trajectory: the committed
    artifact under ``results/exp``, or ``reference`` where given."""

    experiment: str
    name: str
    problem: ProblemSpec
    steps: int
    method: str = "bl1"
    basis: Optional[str] = None
    hess_comp: Optional[Tuple[str, int]] = None
    model_comp: Tuple[str, int] = ("identity", 0)
    params: Tuple[Tuple[str, object], ...] = ()
    reference: Optional[pathlib.Path] = None

    @property
    def artifact(self) -> pathlib.Path:
        if self.reference is not None:
            return self.reference
        return REPO_ROOT / "results" / "exp" / self.experiment / f"{self.name}.seed0.json"

    def reference_history(self) -> dict:
        """The reference's history of this cell: the artifact's
        ``history``, or this cell's entry of a reference file that holds
        several runs."""
        ref = json.loads(self.artifact.read_text())
        return ref["runs"][self.name] if "runs" in ref else ref["history"]


_P = ProblemSpec()
_R, _D, _N = _P.r, _P.d, _P.n_clients
FIG1R1 = GLMCell("fig1r1", "BL1", _P, 12, basis="data_outer", hess_comp=("topk", _R))
FIG1R1_CELLS: Dict[str, GLMCell] = {c.name: c for c in (
    FIG1R1,
    GLMCell("fig1r1", "FedNL", _P, 12, basis="standard", hess_comp=("rankr", 1)),
    GLMCell("fig1r1", "NL1", _P, 12, method="nl1"),
    GLMCell("fig1r1", "Newton", _P, 12, method="newton"),
)}
FIG1R3: Dict[str, GLMCell] = {c.name: c for c in (
    GLMCell("fig1r3", name, _P, 12, method="bl2", basis="standard", hess_comp=(kind, 1),
            model_comp=("topk", _D // 10), params=(("p", 0.1),))
    for name, kind in (("RankR", "rankr"), ("RRankR", "rrankr"), ("NRankR", "nrankr")))}
FIG3: Dict[str, GLMCell] = {c.name: c for c in (
    GLMCell("fig3", name, _P, 12, method="bl2", basis="data_outer", hess_comp=(kind, _R),
            model_comp=("topk", _R // 2), params=(("p", _R / (2 * _D)),))
    for name, kind in (("TopK", "topk"), ("RTopK", "rtopk"), ("NTopK", "ntopk")))}
_TAUS = (("full", _N), ("half", _N // 2), ("quarter", _N // 4))
FIG4: Dict[str, GLMCell] = {c.name: c for c in (
    *(GLMCell("fig4", f"BL2_tau_{tag}", _P, 24, method="bl2", basis="data_outer",
              hess_comp=("topk", _R), params=(("tau", tau),)) for tag, tau in _TAUS),
    *(GLMCell("fig4", f"BL3_tau_{tag}", _P, 24, method="bl3", hess_comp=("topk", _D),
              params=(("tau", tau),)) for tag, tau in _TAUS))}
FIG5: Dict[str, GLMCell] = {c.name: c for c in (
    GLMCell("fig5", "BL1-BC", _P, 24, basis="data_outer", hess_comp=("topk", _R),
            model_comp=("topk", _R), params=(("p", 0.5), ("seed", 3))),
    GLMCell("fig5", "BL2-BC", _P, 24, method="bl2", basis="data_outer",
            hess_comp=("topk", _R), model_comp=("topk", _R), params=(("p", 0.5),)),
    GLMCell("fig5", "BL3-BC", _P, 12, method="bl3", hess_comp=("topk", _D // 2),
            model_comp=("topk", _D // 2), params=(("p", 0.5),)),
)}
FIG6: Dict[str, GLMCell] = {c.name: c for c in (
    GLMCell("fig6", f"{meth.upper()}_p{p:.2f}", _P, 24, method=meth,
            basis="standard" if meth == "bl2" else None,
            hess_comp=("topk", max(1, int(p * _D))), model_comp=("topk", max(1, int(p * _D))),
            params=(("tau", _N // 2), ("p", p)))
    for p in (1.0, 1 / 3) for meth in ("bl2", "bl3"))}
#: artifact rounds whose NaN the reference's CPU SVD put there, not the
#: method: LAPACK's gesdd fails to converge on one client's round-10
#: Hessian difference (numpy's and scipy's gesdd fail on the same matrix;
#: gesvd and MKL's gesdd converge), jax fills that client's factors with
#: NaN, and the next round's gap is NaN.  The port's SVD converges, so at
#: these rounds its gap is finite (ROADMAP.md §3).
REFERENCE_SVD_NAN: Dict[str, int] = {"fig1r3/RRankR": 11, "fig1r3/NRankR": 11}
#: the stochastic GLM cells held to their artifacts
STOCHASTIC_CELLS: Tuple[GLMCell, ...] = (
    *FIG4.values(), *FIG6.values(), *FIG3.values(), *FIG5.values(),
    FIG1R1_CELLS["NL1"], *FIG1R3.values())
_DITHER = ("dither", 10)        # s = 10 ≈ √d dithering levels
FIG1R2: Dict[str, GLMCell] = {c.name: c for c in (
    dataclasses.replace(FIG1R1, experiment="fig1r2"),
    GLMCell("fig1r2", "GD", _P, 60, method="gd"),
    GLMCell("fig1r2", "DIANA", _P, 60, method="diana", hess_comp=_DITHER),
    GLMCell("fig1r2", "ADIANA", _P, 60, method="adiana", hess_comp=_DITHER),
    GLMCell("fig1r2", "LocalGD", _P, 15, method="local_gd"),
)}
FIG5_REST: Dict[str, GLMCell] = {c.name: c for c in (
    GLMCell("fig5", "FedNL-BC", _P, 12, basis="standard", hess_comp=("topk_sym", _D * _D // 2),
            model_comp=("topk", _D // 2)),
    GLMCell("fig5", "DORE", _P, 60, method="dore", hess_comp=("topk", _D // 2),
            model_comp=("topk", _D // 2)),
)}
FIG1_BAG: Dict[str, GLMCell] = {c.name: c for c in (
    GLMCell("fig1-bag", "FedNL", _P, 24, basis="standard", hess_comp=("rankr", 1)),
    GLMCell("fig1-bag", "BAG_q0.5", _P, 24, method="fednl_bag", basis="standard",
            hess_comp=("rankr", 1), params=(("q", 0.5),)),
    GLMCell("fig1-bag", "BAG_q1.0", _P, 24, method="fednl_bag", basis="standard",
            hess_comp=("rankr", 1), params=(("q", 1.0), ("eta", 1.0))),
)}
#: the ten artifact cells of the first-order baselines, FedNL-BC, DORE and
#: FedNL-BAG (with the two BL1 / FedNL cells they are drawn beside)
BASELINE_CELLS: Tuple[GLMCell, ...] = (
    *FIG1R2.values(), *FIG5_REST.values(), *FIG1_BAG.values())
#: BL1 in every registered d×d basis but ``psd`` (BL3's) under Top-K with
#: K = r² and Rank-2, as ``benchmarks/run.py::basis_matrix`` runs it
GRID_BASES = ("standard", "symmetric", "data_outer", "eigen", "dct")
BASIS_GRID: Dict[str, GLMCell] = {c.name: c for c in (
    GLMCell("basis-grid", f"{b}_{kind}", _P, 16, basis=b, hess_comp=(kind, size),
            reference=BASIS_GRID_REFERENCE)
    for b in GRID_BASES for kind, size in (("topk", _R * _R), ("rankr", 2)))}
TABLE2_A1A = GLMCell("table2", "a1a_BL1", ProblemSpec(kind="table2", name="a1a"), 12,
                     basis="data_outer", hess_comp=("topk", 64),
                     reference=BASIS_GRID_REFERENCE)
FIG2: Dict[str, GLMCell] = {c.name: c for c in (
    GLMCell("fig2", "newton_std", ProblemSpec(), 10, method="newton"),
    GLMCell("fig2", "newton_basis", ProblemSpec(), 10, method="newton",
            basis="data_outer"),
)}
FIG1_XL = GLMCell("fig1-xl", "BL1", ProblemSpec(seed=0, n_clients=512, m=32, d=1200,
                                                r=32, lam=1e-3, newton_iters=12,
                                                solver="fused"),
                  8, basis="data_outer", hess_comp=("topk", 32 * 32))
BL2_XL = GLMCell("bl2-xl", "BL2", FIG1_XL.problem, 8, method="bl2", basis="data_outer",
                 hess_comp=("topk", 32 * 32), params=(("tau", 256),),
                 reference=BL2_XL_REFERENCE)
#: `BL2_XL` on its fleet narrowed to d = 40, which the reference ran in full
#: (its history is `BL2_XL_REFERENCE`'s ``history``)
BL2_XL_NARROW = dataclasses.replace(
    BL2_XL, name="BL2_d40", problem=dataclasses.replace(FIG1_XL.problem, d=40))


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

    @property
    def d(self) -> int:
        return int(self.x0.shape[0])

    def bases(self, name: str) -> list:
        if name not in self._bases:
            self._bases[name] = _basis.make_bases(name, self.clients, x0=self.x0)
        return self._bases[name]


def build_problem(spec: ProblemSpec, *, device=None) -> Problem:
    """Materialize a "synthetic" or "table2" `ProblemSpec` on `device`."""
    dev = _device.resolve(device)
    if spec.kind == "table2":
        clients = glm.make_table2(spec.name, seed=spec.seed, lam=spec.lam, device=dev)
    elif spec.kind == "synthetic":
        clients = glm.make_synthetic(seed=spec.seed, n_clients=spec.n_clients,
                                     m=spec.m, d=spec.d, r=spec.r, lam=spec.lam,
                                     device=dev)
    elif spec.kind == "synthetic_stream":
        raise NotImplementedError(
            "problem kind 'synthetic_stream' is not ported yet: ROADMAP.md §1 "
            "item 15 (the cohort engine) brings it")
    else:
        raise ValueError(f"unknown problem kind {spec.kind!r}")
    x0 = torch.zeros(int(clients[0].A.shape[1]), dtype=torch.float64, device=dev)
    if spec.solver == "fused":
        batch = client_batch.from_clients(clients)
        x_star = client_batch.newton_solve_fused(batch, x0, spec.newton_iters)
    elif spec.solver == "loop":
        x_star = glm.newton_solve(clients, x0, spec.newton_iters)
    else:
        raise ValueError(f"unknown solver {spec.solver!r}")
    return Problem(spec=spec, clients=clients, x0=x0, x_star=x_star)


def run_cell(cell: GLMCell, prob: Problem, *, steps=None, backend: str = "fast",
             basis_project: str = "einsum") -> bl.History:
    """Run a GLM cell through its public entry point (`bl.bl1`, `bl.bl2`,
    `bl.bl3`, or `baselines.newton`, `nl1`, `fednl_bag`, `gd`, `diana`,
    `adiana`, `local_gd`, `dore_like`) on the problem's device, with the
    cell's params, as the reference's ``engine.run_cell`` dispatches;
    ``basis_project`` routes the data basis's Γ = VᵀAV of BL1 and Newton
    (see `bl.bl1`)."""
    steps = cell.steps if steps is None else steps
    bases = prob.bases(cell.basis) if cell.basis else None
    dev = prob.x0.device
    params = dict(cell.params)
    args = (prob.x0, prob.x_star, steps)
    d = prob.d
    if cell.method == "newton":
        return baselines.newton(prob.clients, *args, bases=bases, backend=backend,
                                device=dev, basis_project=basis_project, **params)
    if cell.method == "nl1":
        return baselines.nl1(prob.clients, *args, device=dev, **params)
    if cell.method == "gd":
        return baselines.gd(prob.clients, *args, backend=backend, device=dev, **params)
    if cell.method == "local_gd":
        return baselines.local_gd(prob.clients, *args, device=dev, **params)
    if cell.method in ("diana", "adiana"):
        comp = make_compressor(cell.hess_comp, d)
        if cell.method == "diana":
            return baselines.diana(prob.clients, *args, comp, comp.omega_for(d),
                                   backend=backend, device=dev, **params)
        return baselines.adiana(prob.clients, *args, comp, comp.omega_for(d), device=dev,
                                **params)
    if cell.method == "dore":
        return baselines.dore_like(prob.clients, *args, make_compressor(cell.hess_comp, d),
                                   make_compressor(cell.model_comp, d), device=dev, **params)
    hc = [make_compressor(cell.hess_comp, d)] * prob.n
    if cell.method == "fednl_bag":
        return baselines.fednl_bag(prob.clients, bases, hc, *args, backend=backend,
                                   device=dev, **params)
    mc = make_compressor(cell.model_comp, d)
    if cell.method == "bl1":
        return bl.bl1(prob.clients, bases, hc, mc, *args, backend=backend, device=dev,
                      basis_project=basis_project, **params)
    if cell.method == "bl2":
        return bl.bl2(prob.clients, bases, hc, [mc] * prob.n, *args, backend=backend,
                      device=dev, **params)
    if cell.method == "bl3":
        return bl.bl3(prob.clients, hc, [mc] * prob.n, *args, backend=backend, device=dev,
                      **params)
    raise ValueError(f"unknown method {cell.method!r} in cell {cell.name!r}")


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
