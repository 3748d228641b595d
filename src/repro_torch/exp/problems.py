"""The cells the port's tests and ``chip_smoke.py`` hold against a
reference — a view of `registry`, run through `engine.run_cell`.

Registered cells, each held to its committed artifact under
``results/exp/<experiment>/<cell>.seed0.json``:

  * `FIG1R1` (the paper's headline cell: BL1, data basis, Top-24) and
    `FIG1R1_CELLS` (with FedNL, NL1 and Newton); `FIG2` (Newton without a
    basis and in the data basis); `FIG1_XL` (BL1 at n=512, d=1200, 8
    rounds, registered ``"fast+sharded"``: one rank runs it on the
    single-device path, see `engine.resolve_backend`);
  * the stochastic paper cells, all drawing from `repro_torch.core.prng`:
    `FIG1R3`, `FIG3`, `FIG4`, `FIG6`, fig5's BL1/2/3-BC (`FIG5`) and
    fig1r1's NL1, gathered in `STOCHASTIC_CELLS`;
  * the rest of the paper's figures: `FIG1R2`, fig5's FedNL-BC and DORE
    (`FIG5_REST`) and `FIG1_BAG`, gathered in `BASELINE_CELLS`;
  * the BL-DNN cells `FIG_DNN` and `FIG_DNN_SHIP` on `DNN_FIG`, the
    problem carried in `DNN_FIXTURE` (`engine.load_dnn_problem`).

Registered cells without an artifact, held to a file the JAX package
writes: the cohort-streaming experiments `FIG1_XXL` (BL2 and FedNL-BAG on
131,072 clients, 512 a cohort) and `COHORT_SMOKE` (BL2 on 96 clients, 16 a
cohort), held to `COHORT_REFERENCE` (``tools/cohort_reference.py``).

Cells the registry lacks, in experiments built here and not registered,
each held to a file the JAX package writes:

  * `BASIS_GRID` — BL1 on fig1r1's problem for 16 rounds in each of
    `GRID_BASES` under Top-576 (K = r²) and Rank-2, the configurations of
    ``benchmarks/run.py::basis_matrix``, and `TABLE2_A1A`, BL1 on Table
    2's ``a1a`` regime in the data basis with Top-64 for 12 rounds; their
    reference is `BASIS_GRID_REFERENCE` (``tools/basis_grid_reference.py``);
  * `BL2_XL` — BL2 at fig1-xl's widths with τ = 256, 8 rounds; its
    reference `BL2_XL_REFERENCE` (``tools/bl2_xl_reference.py``) holds the
    participation masks and bit streams at full width and the whole
    history of `BL2_XL_NARROW`, the same run on the fleet narrowed to
    d = 40.
"""
from __future__ import annotations

import dataclasses
import json
import pathlib
from typing import Dict, Optional, Tuple

from ..core.pytree import tree_leaves
from . import engine
from .engine import DATA, Problem, StreamProblem
# the handles the tests, tools and chip_smoke.py reach through this module
from .engine import DNN_FIXTURE, DNNProblem, build_problem, load_dnn_problem  # noqa: F401
from .registry import CompressorCfg, Experiment, MethodCell, ProblemSpec, get_experiment

REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
#: the JAX package's BL2 trajectory at fig1-xl's widths (`BL2_XL`)
BL2_XL_REFERENCE = DATA / "bl2_xl_seed0.json"
#: the JAX package's histories of `BASIS_GRID` and `TABLE2_A1A`
BASIS_GRID_REFERENCE = DATA / "basis_grid_seed0.json"
#: the JAX package's runs of fig1-xxl and cohort-smoke (`FIG1_XXL`,
#: `COHORT_SMOKE`): store checksums, f*, cohorts, participants, histories
COHORT_REFERENCE = DATA / "fig1_xxl_seed0.json"
#: the JAX package's service-loop records (`tools/serve_reference.py`): each
#: case's `repro_torch.launch.fed_serve` arguments and its record, meta aside
SERVE_REFERENCE = DATA / "fed_serve_ref.json"
#: the BL-DNN regime of fig-dnn and fig-dnn-ship, the one the fixture holds
DNN_FIG = engine.DNN_FIXTURE_SPEC


@dataclasses.dataclass(frozen=True)
class Cell:
    """One curve: an experiment and one of its cells, and its reference
    trajectory — the committed artifact under ``results/exp``, or the file
    ``reference`` where given."""

    exp: Experiment
    cell: MethodCell
    reference: Optional[pathlib.Path] = None

    @property
    def experiment(self) -> str:
        return self.exp.name

    @property
    def problem(self):
        return self.exp.problem

    @property
    def name(self) -> str:
        return self.cell.name

    @property
    def method(self) -> str:
        return self.cell.method

    @property
    def steps(self) -> int:
        return self.cell.steps

    @property
    def basis(self) -> Optional[str]:
        return self.cell.basis

    @property
    def hess_comp(self) -> Optional[CompressorCfg]:
        return self.cell.hess_comp

    @property
    def model_comp(self) -> Optional[CompressorCfg]:
        return self.cell.model_comp

    @property
    def params(self) -> Tuple[Tuple[str, object], ...]:
        return self.cell.params

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
        if "experiments" in ref:
            ref = ref["experiments"][self.experiment]
        return ref["runs"][self.name] if "runs" in ref else ref["history"]


def cells(experiment, names=None, reference: Optional[pathlib.Path] = None) -> Dict[str, Cell]:
    """The cells of an experiment (a registered name or an `Experiment`),
    all or the named ones, by name, held to their artifacts or to the file
    ``reference``."""
    exp = get_experiment(experiment) if isinstance(experiment, str) else experiment
    return {c.name: Cell(exp, c, reference) for c in exp.cells
            if names is None or c.name in names}


def run_cell(cell: Cell, prob, *, steps=None, basis_project: str = "einsum",
             backend: Optional[str] = None):
    """Run a cell through `engine.run_cell` on the problem's device;
    ``basis_project`` routes the data basis's Γ = VᵀAV of BL1 and Newton,
    ``backend`` overrides the cell's (see `engine.run_cell`)."""
    x = prob.x0 if isinstance(prob, (Problem, StreamProblem)) else tree_leaves(prob.params0)[0]
    return engine.run_cell(cell.exp, cell.cell, prob, steps=steps, device=x.device,
                           basis_project=basis_project, backend=backend)


#: the BL-DNN cells' handle on `run_cell`
run_dnn_cell = run_cell


FIG1R1_CELLS = cells("fig1r1")
FIG1R1 = FIG1R1_CELLS["BL1"]
FIG2 = cells("fig2")
FIG1_XL = cells("fig1-xl")["BL1"]
FIG1R3 = cells("fig1r3")
FIG3 = cells("fig3")
FIG4 = cells("fig4")
FIG5 = cells("fig5", ("BL1-BC", "BL2-BC", "BL3-BC"))
FIG6 = cells("fig6")
#: artifact rounds whose NaN the reference's CPU SVD put there, not the
#: method: LAPACK's gesdd fails to converge on one client's round-10
#: Hessian difference (numpy's and scipy's gesdd fail on the same matrix;
#: gesvd and MKL's gesdd converge), jax fills that client's factors with
#: NaN, and the next round's gap is NaN.  The port's SVD converges, so at
#: these rounds its gap is finite (ROADMAP.md §3).
REFERENCE_SVD_NAN: Dict[str, int] = {"fig1r3/RRankR": 11, "fig1r3/NRankR": 11}
#: the stochastic GLM cells held to their artifacts
STOCHASTIC_CELLS: Tuple[Cell, ...] = (
    *FIG4.values(), *FIG6.values(), *FIG3.values(), *FIG5.values(),
    FIG1R1_CELLS["NL1"], *FIG1R3.values())
FIG1R2 = cells("fig1r2")
FIG5_REST = cells("fig5", ("FedNL-BC", "DORE"))
FIG1_BAG = cells("fig1-bag")
#: the ten artifact cells of the first-order baselines, FedNL-BC, DORE and
#: FedNL-BAG (with the two BL1 / FedNL cells they are drawn beside)
BASELINE_CELLS: Tuple[Cell, ...] = (
    *FIG1R2.values(), *FIG5_REST.values(), *FIG1_BAG.values())
FIG_DNN = cells("fig-dnn")
FIG_DNN_SHIP = cells("fig-dnn-ship")
FIG1_XXL = cells("fig1-xxl", reference=COHORT_REFERENCE)
COHORT_SMOKE = cells("cohort-smoke", reference=COHORT_REFERENCE)["BL2"]

_P = ProblemSpec()
_IDENT = CompressorCfg(kind="identity")


def _unregistered(exp_name: str, source: str, problem, cell: MethodCell,
                  reference: pathlib.Path) -> Cell:
    """A cell of an experiment the registry lacks, held to a reference file."""
    exp = Experiment(name=exp_name, figure="extra", title=f"{exp_name}/{cell.name}",
                     paper_ref=source, problem=problem, cells=(cell,))
    return Cell(exp, cell, reference)


#: BL1 in every registered d×d basis but ``psd`` (BL3's) under Top-K with
#: K = r² and Rank-2, as ``benchmarks/run.py::basis_matrix`` runs it
GRID_BASES = ("standard", "symmetric", "data_outer", "eigen", "dct")
BASIS_GRID: Dict[str, Cell] = {c.name: c for c in (
    _unregistered("basis-grid", "benchmarks/run.py::basis_matrix", _P,
                  MethodCell(f"{b}_{kind}", "bl1", 16, basis=b, model_comp=_IDENT,
                             hess_comp=CompressorCfg(kind=kind, **{key: size})),
                  BASIS_GRID_REFERENCE)
    for b in GRID_BASES for kind, key, size in (("topk", "k", _P.r * _P.r), ("rankr", "r", 2)))}
TABLE2_A1A = _unregistered(
    "table2", "glm.TABLE2", ProblemSpec(kind="table2", name="a1a"),
    MethodCell("a1a_BL1", "bl1", 12, basis="data_outer", model_comp=_IDENT,
               hess_comp=CompressorCfg(kind="topk", k=64)), BASIS_GRID_REFERENCE)
BL2_XL = _unregistered(
    "bl2-xl", "tools/bl2_xl_reference.py", FIG1_XL.problem,
    MethodCell("BL2", "bl2", 8, basis="data_outer", model_comp=_IDENT,
               hess_comp=CompressorCfg(kind="topk", k=32 * 32), params=(("tau", 256),)),
    BL2_XL_REFERENCE)
#: `BL2_XL` on its fleet narrowed to d = 40, which the reference ran in full
#: (its history is `BL2_XL_REFERENCE`'s ``history``)
BL2_XL_NARROW = _unregistered(
    "bl2-xl", "tools/bl2_xl_reference.py", dataclasses.replace(FIG1_XL.problem, d=40),
    dataclasses.replace(BL2_XL.cell, name="BL2_d40"), BL2_XL_REFERENCE)
