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
import pathlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .. import device as _device
from ..core import basis as _basis
from ..core import baselines, bl, client_batch, glm
from ..core.compressors import Compressor, Identity, RankR, TopK, nrankr, ntopk, rrankr, rtopk
from ..core.convert import dnn_problem_from_numpy
from ..core.pytree import tree_leaves
from ..fed import bldnn

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
DATA = pathlib.Path(__file__).resolve().parent / "data"
#: the carried fig-dnn problem (seed 0)
DNN_FIXTURE = DATA / "fig_dnn_seed0.npz"
#: the JAX package's BL2 trajectory at fig1-xl's widths (`BL2_XL`)
BL2_XL_REFERENCE = DATA / "bl2_xl_seed0.json"


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


#: compressor kinds of a cell: (kind, size) → compressor for a d-wide problem
_COMPRESSORS = {
    "identity": lambda size, d: Identity(),
    "topk": lambda k, d: TopK(k=k),
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
    """One GLM curve: ``method`` "bl1", "bl2", "bl3", "newton" or "nl1",
    the basis registry name (None: no basis), the Hessian and model-stream
    compressors as ``(kind, size)`` pairs, `steps` rounds, the entry
    point's keyword ``params`` (``p``, ``tau``, ``seed``), and its
    reference trajectory: the committed artifact under ``results/exp``, or
    ``reference`` where given."""

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


def run_cell(cell: GLMCell, prob: Problem, *, steps=None, backend: str = "fast",
             basis_project: str = "einsum") -> bl.History:
    """Run a GLM cell through its public entry point (`bl.bl1`, `bl.bl2`,
    `bl.bl3`, `baselines.newton` or `baselines.nl1`) on the problem's
    device, with the cell's params, as the reference's ``engine.run_cell``
    dispatches; ``basis_project`` routes the data basis's Γ = VᵀAV of BL1
    and Newton (see `bl.bl1`)."""
    steps = cell.steps if steps is None else steps
    bases = prob.bases(cell.basis) if cell.basis else None
    dev = prob.x0.device
    params = dict(cell.params)
    args = (prob.x0, prob.x_star, steps)
    if cell.method == "newton":
        return baselines.newton(prob.clients, *args, bases=bases, backend=backend,
                                device=dev, basis_project=basis_project, **params)
    if cell.method == "nl1":
        return baselines.nl1(prob.clients, *args, device=dev, **params)
    d = prob.spec.d
    hc = [make_compressor(cell.hess_comp, d)] * prob.n
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
