"""Declarative experiment registry: every paper figure as frozen data —
port of `repro.exp.registry`, registrations verbatim.

An `Experiment` is a frozen dataclass naming a problem regime
(`ProblemSpec` — a `glm.make_synthetic` / `glm.TABLE2` configuration plus
the reference-optimum solver), a tuple of `MethodCell`s (method × basis ×
compressor grid × hyperparameters × backend), seeds and a gap tolerance.
The sweep engine (`repro_torch.exp.engine`) executes cells through the
public method entry points and the artifact layer
(`repro_torch.exp.artifacts`) writes one schema-versioned JSON per (cell,
seed) plus the figure CSVs.

Every field, default and literal is the reference's: an artifact's
``config_digest`` is the sha256 of ``dataclasses.asdict`` of these objects
(`artifacts.config_digest`), so a cell registered here reproduces the
committed digest only while its fields, their Python types (``False`` is
not ``0``, ``5`` is not ``5.0``) and float spellings stay the reference's.
That holds for the backends too: fig1-xl stays ``"fast+sharded"`` and
fig1-xxl / cohort-smoke ``"cohort"`` (the engine decides what runs them).

Registered experiments (``available_experiments()``):

  * ``fig1r1`` … ``fig6`` — the paper's figures (§6 + Appendix A);
  * ``fig1-xl``  — 512 clients at d=1200, registered on the sharded backend;
  * ``fig1-xxl`` and ``cohort-smoke`` — the cohort-streaming regimes
    (``synthetic_stream`` problems);
  * ``fig1-bag`` — FedNL + Bernoulli-lazy gradient aggregation vs FedNL;
  * ``fig-dnn`` and ``fig-dnn-ship`` — the BL-DNN workload.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

# ==========================================================================
# Declarative pieces
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class ProblemSpec:
    """A problem regime: which federated GLM instance a figure runs on.

    kind="synthetic" draws `glm.make_synthetic(seed, n_clients, m, d, r,
    lam)`; kind="table2" uses the named `glm.TABLE2` regime (scaled-down
    LibSVM shapes).  ``solver`` picks the reference-optimum computation:
    "loop" is the paper-faithful `glm.newton_solve` (stacks per-client
    d×d Hessians — fine at paper scale), "fused" is
    `client_batch.newton_solve_fused` (one Gram contraction, no (n, d, d)
    intermediate — required at fig1-xl scale)."""

    kind: str = "synthetic"          # "synthetic" | "table2" |
    #                                  "synthetic_stream" (host-resident
    #                                  ClientStore fleet for the cohort-
    #                                  streaming engine; solver is the
    #                                  slab-wise host Newton)
    name: Optional[str] = None       # TABLE2 regime name for kind="table2"
    seed: int = 0
    n_clients: int = 10
    m: int = 60
    d: int = 120
    r: int = 24
    lam: float = 1e-3
    newton_iters: int = 20
    solver: str = "loop"             # "loop" | "fused"


@dataclasses.dataclass(frozen=True)
class DNNProblemSpec:
    """Problem regime for the BL-DNN deep-network workload (`fig-dnn`).

    A teacher-labelled synthetic classification fleet whose inputs live in
    a shared r-dimensional subspace (the §2.3 low-rank regime carried to a
    DNN) plus a near-teacher student initialization — drawn by the
    reference's `make_synthetic_classification`; the port's engine loads
    the seed-0 draw carried in ``exp/data/fig_dnn_seed0.npz``.  A separate
    dataclass from `ProblemSpec` on purpose: GLM fields (lam,
    newton_iters, solver) don't apply, and existing artifact config
    digests stay untouched."""

    kind: str = "dnn_synthetic"
    seed: int = 0
    n_clients: int = 8
    m: int = 64                      # samples per client
    d: int = 96                      # input features
    classes: int = 4
    width: int = 32                  # MLP hidden width
    r: int = 8                       # intrinsic data rank (§2.3 analogue)
    heterogeneity: float = 0.5
    label_noise: float = 0.05


@dataclasses.dataclass(frozen=True)
class CompressorCfg:
    """Declarative compressor config; built per-problem by
    `repro_torch.exp.engine.build_compressor` (some kinds derive parameters from
    the problem dimension d, e.g. rrankr's dithering levels)."""

    kind: str                        # identity|topk|randk|rankr|dither|
    #                                  natural|rtopk|ntopk|rrankr|nrankr|
    #                                  bernoulli
    k: int = 0                       # topk/randk/rtopk/ntopk
    r: int = 0                       # rankr/rrankr/nrankr
    s: int = 0                       # dither levels
    p: float = 0.0                   # bernoulli send probability
    symmetrize: bool = False         # topk on the triangular half (§A.2)


@dataclasses.dataclass(frozen=True)
class MethodCell:
    """One curve of a figure: a method, its compressors/basis and params.

    ``name`` is the curve label and the CSV suffix
    (``results/<experiment>_<name>.csv``).  ``params`` is a frozen tuple of
    (key, value) pairs forwarded to the method entry point (alpha, eta, p,
    tau, q, seed, lr, local_steps, k, option, ...).  ``basis`` is a
    `repro_torch.core.basis` registry name (None for basis-free methods).
    """

    name: str
    method: str                      # bl1|bl2|bl3|newton|nl1|gd|diana|
    #                                  adiana|local_gd|dore|fednl_bag
    steps: int
    basis: Optional[str] = None
    hess_comp: Optional[CompressorCfg] = None
    model_comp: Optional[CompressorCfg] = None
    params: Tuple[Tuple[str, Any], ...] = ()
    backend: str = "auto"

    def params_dict(self) -> Dict[str, Any]:
        return dict(self.params)


@dataclasses.dataclass(frozen=True)
class Experiment:
    """A registered, reproducible figure: problem + cells + seeds + tol."""

    name: str
    figure: str                      # "fig1".."fig6" | "extra"
    title: str
    paper_ref: str                   # e.g. "§6 Fig. 1 row 1"
    problem: ProblemSpec
    cells: Tuple[MethodCell, ...]
    seeds: Tuple[int, ...] = (0,)
    tol: float = 1e-6
    tags: Tuple[str, ...] = ()       # e.g. ("xl",) for scaled scenarios

    def cell(self, name: str) -> MethodCell:
        for c in self.cells:
            if c.name == name:
                return c
        raise KeyError(f"{self.name} has no cell {name!r}; "
                       f"cells: {[c.name for c in self.cells]}")


# ==========================================================================
# Registry
# ==========================================================================
EXPERIMENT_REGISTRY: Dict[str, Experiment] = {}


def register_experiment(exp: Experiment) -> Experiment:
    if exp.name in EXPERIMENT_REGISTRY:
        raise ValueError(f"duplicate experiment {exp.name!r}")
    EXPERIMENT_REGISTRY[exp.name] = exp
    return exp


def available_experiments() -> List[str]:
    return sorted(EXPERIMENT_REGISTRY)


def get_experiment(name: str) -> Experiment:
    if name not in EXPERIMENT_REGISTRY:
        raise KeyError(f"unknown experiment {name!r}; "
                       f"registered: {available_experiments()}")
    return EXPERIMENT_REGISTRY[name]


# ==========================================================================
# The paper's figures (§6 + Appendix A)
# ==========================================================================
# All paper figures share one synthetic Table-2-style instance (n=10, m=60,
# d=120, intrinsic rank r=24 — scaled down from the LibSVM regimes so a CPU
# run finishes in minutes; docs/REPRODUCING.md records the scaling).  The
# data basis of this instance has rank exactly r=24, so the Top-K budgets
# below (k=24 = r, k=12 = r/2) are written as literals.
_PROBLEM = ProblemSpec()
_D, _R, _N = _PROBLEM.d, _PROBLEM.r, _PROBLEM.n_clients

_IDENT = CompressorCfg(kind="identity")
_TOPK_R = CompressorCfg(kind="topk", k=_R)
_S = 12       # figure step budget (matches the committed results/ curves)
_SL = 60      # first-order methods need more, cheaper rounds


register_experiment(Experiment(
    name="fig1r1",
    figure="fig1",
    title="Second-order comparison: BL1 (data basis) vs FedNL vs NL1 vs Newton",
    paper_ref="§6 Fig. 1 row 1",
    problem=_PROBLEM,
    cells=(
        MethodCell("BL1", "bl1", _S, basis="data_outer",
                   hess_comp=_TOPK_R, model_comp=_IDENT),
        MethodCell("FedNL", "bl1", _S, basis="standard",
                   hess_comp=CompressorCfg(kind="rankr", r=1),
                   model_comp=_IDENT),
        MethodCell("NL1", "nl1", _S),
        MethodCell("Newton", "newton", _S),
    ),
))

register_experiment(Experiment(
    name="fig1r2",
    figure="fig1",
    title="BL1 vs first-order methods (GD / DIANA / ADIANA / Local-GD)",
    paper_ref="§6 Fig. 1 row 2",
    problem=_PROBLEM,
    cells=(
        MethodCell("BL1", "bl1", _S, basis="data_outer",
                   hess_comp=_TOPK_R, model_comp=_IDENT),
        MethodCell("GD", "gd", _SL),
        # the first-order baselines quantize with s = ⌊√d⌋ dithering levels
        MethodCell("DIANA", "diana", _SL,
                   hess_comp=CompressorCfg(kind="dither", s=10)),
        MethodCell("ADIANA", "adiana", _SL,
                   hess_comp=CompressorCfg(kind="dither", s=10)),
        MethodCell("LocalGD", "local_gd", _SL // 4),
    ),
))

register_experiment(Experiment(
    name="fig1r3",
    figure="fig1",
    title="Composed Rank-R compressors in BL2 (standard basis ⇒ FedNL-PP)",
    paper_ref="§6 Fig. 1 row 3",
    problem=_PROBLEM,
    cells=tuple(
        MethodCell(nm, "bl2", _S, basis="standard",
                   hess_comp=cfg,
                   model_comp=CompressorCfg(kind="topk", k=_D // 10),
                   params=(("p", 0.1),))
        for nm, cfg in (
            ("RankR", CompressorCfg(kind="rankr", r=1)),
            ("RRankR", CompressorCfg(kind="rrankr", r=1)),
            ("NRankR", CompressorCfg(kind="nrankr", r=1)),
        )
    ),
))

register_experiment(Experiment(
    name="fig2",
    figure="fig2",
    title="Newton in the standard vs the data-induced basis (bits per iter)",
    paper_ref="§A.4 Fig. 2",
    problem=_PROBLEM,
    cells=(
        MethodCell("newton_std", "newton", 10),
        MethodCell("newton_basis", "newton", 10, basis="data_outer"),
    ),
))

register_experiment(Experiment(
    name="fig3",
    figure="fig3",
    title="Composed Top-K compressors in BL2 (data basis)",
    paper_ref="§A.5 Fig. 3",
    problem=_PROBLEM,
    cells=tuple(
        MethodCell(nm, "bl2", _S, basis="data_outer",
                   hess_comp=cfg,
                   model_comp=CompressorCfg(kind="topk", k=_R // 2),
                   params=(("p", _R / (2 * _D)),))
        for nm, cfg in (
            ("TopK", _TOPK_R),
            ("RTopK", CompressorCfg(kind="rtopk", k=_R)),
            ("NTopK", CompressorCfg(kind="ntopk", k=_R)),
        )
    ),
))

register_experiment(Experiment(
    name="fig4",
    figure="fig4",
    title="Partial participation: BL2 (data basis) and BL3 at τ ∈ {n, n/2, n/4}",
    paper_ref="§A.6 Fig. 4",
    problem=_PROBLEM,
    cells=tuple(
        MethodCell(f"BL2_tau_{tag}", "bl2", 2 * _S, basis="data_outer",
                   hess_comp=_TOPK_R, model_comp=_IDENT,
                   params=(("tau", tau),))
        for tag, tau in (("full", _N), ("half", _N // 2), ("quarter", _N // 4))
    ) + tuple(
        MethodCell(f"BL3_tau_{tag}", "bl3", 2 * _S,
                   hess_comp=CompressorCfg(kind="topk", k=_D),
                   model_comp=_IDENT,
                   params=(("tau", tau),))
        for tag, tau in (("full", _N), ("half", _N // 2), ("quarter", _N // 4))
    ),
))

register_experiment(Experiment(
    name="fig5",
    figure="fig5",
    title="Bidirectional compression: BL1/BL2/BL3-BC vs FedNL-BC vs DORE",
    paper_ref="§A.7 Fig. 5",
    problem=_PROBLEM,
    cells=(
        MethodCell("FedNL-BC", "bl1", _S, basis="standard",
                   hess_comp=CompressorCfg(kind="topk", k=_D * _D // 2,
                                           symmetrize=True),
                   model_comp=CompressorCfg(kind="topk", k=_D // 2)),
        # K=r (not the paper's K=r/2) and p=1/2: the paper's most aggressive
        # A.7 setting diverges on this harder synthetic instance
        MethodCell("BL1-BC", "bl1", 2 * _S, basis="data_outer",
                   hess_comp=_TOPK_R, model_comp=_TOPK_R,
                   params=(("p", 0.5), ("seed", 3))),
        MethodCell("BL2-BC", "bl2", 2 * _S, basis="data_outer",
                   hess_comp=_TOPK_R, model_comp=_TOPK_R,
                   params=(("p", 0.5),)),
        MethodCell("BL3-BC", "bl3", _S,
                   hess_comp=CompressorCfg(kind="topk", k=_D // 2),
                   model_comp=CompressorCfg(kind="topk", k=_D // 2),
                   params=(("p", 0.5),)),
        MethodCell("DORE", "dore", _SL,
                   hess_comp=CompressorCfg(kind="topk", k=_D // 2),
                   model_comp=CompressorCfg(kind="topk", k=_D // 2)),
    ),
))

register_experiment(Experiment(
    name="fig6",
    figure="fig6",
    title="BL2 vs BL3 under partial participation + bidirectional compression",
    paper_ref="§A.8 Fig. 6",
    problem=_PROBLEM,
    cells=tuple(
        MethodCell(f"{meth.upper()}_p{p:.2f}", meth, 2 * _S,
                   basis=("standard" if meth == "bl2" else None),
                   hess_comp=CompressorCfg(kind="topk", k=max(1, int(p * _D))),
                   model_comp=CompressorCfg(kind="topk", k=max(1, int(p * _D))),
                   params=(("tau", _N // 2), ("p", p)))
        for p in (1.0, 1 / 3)
        for meth in ("bl2", "bl3")
    ),
))


# ==========================================================================
# Beyond the paper
# ==========================================================================
# fig1-xl: the fig1r1 comparison at a scale the original op-by-op code
# cannot run — 512 clients at d=1200 (≈ 737 MB of stacked client data, a
# 5.9 GB/round reconstruction stream) through the client-sharded shard_map
# backend with §2.3 block-mode (n, r, r) coefficient state and the fused
# low-memory Newton reference solver.
_XL = ProblemSpec(seed=0, n_clients=512, m=32, d=1200, r=32, lam=1e-3,
                  newton_iters=12, solver="fused")

register_experiment(Experiment(
    name="fig1-xl",
    figure="extra",
    title="BL1 at scale: 512 clients, d=1200, sharded engine (beyond paper)",
    paper_ref="engine demonstration (no paper counterpart)",
    problem=_XL,
    cells=(
        MethodCell("BL1", "bl1", 8, basis="data_outer",
                   hess_comp=CompressorCfg(kind="topk", k=_XL.r * _XL.r),
                   model_comp=_IDENT, backend="fast+sharded"),
    ),
    tags=("xl",),
))

# fig1-xxl: the cohort-streaming regime — a fleet two-plus orders of
# magnitude past fig1-xl (131072 clients) whose data/shift state lives in a
# host-resident ClientStore; each round touches only a 512-client cohort
# (`repro.core.cohort.CohortEngine`), so per-round wall time is flat in the
# total fleet size (benchmarks/run.py cohort_stream pins ≤1.15× from n=1k
# to n=100k).  Small per-client shapes on purpose: the scale axis here is
# n, not d — fig1-xl already owns the big-d regime.
_XXL = ProblemSpec(kind="synthetic_stream", seed=0, n_clients=131072, m=8,
                   d=24, r=24, lam=1e-3, newton_iters=12, solver="fused")

register_experiment(Experiment(
    name="fig1-xxl",
    figure="extra",
    title="FedNL-PP at fleet scale: 131072 clients, 512-client cohorts, "
          "streaming engine (beyond paper)",
    paper_ref="engine demonstration (no paper counterpart)",
    problem=_XXL,
    cells=(
        MethodCell("BL2", "bl2", 16, basis="standard",
                   hess_comp=CompressorCfg(kind="topk", k=2 * _XXL.d),
                   model_comp=_IDENT, backend="cohort",
                   params=(("tau", 256), ("cohort", 512),
                           ("rounds_per_cohort", 4))),
        MethodCell("FedNL-BAG", "fednl_bag", 16, basis="standard",
                   hess_comp=CompressorCfg(kind="topk", k=2 * _XXL.d),
                   backend="cohort",
                   params=(("q", 0.5), ("cohort", 512),
                           ("rounds_per_cohort", 4))),
    ),
    tags=("xl", "stream"),
))

# cohort-smoke: a minutes-scale streaming scenario for the fault-tolerance
# and resume tests (tests/test_cohort.py kill-9s a serve of this through
# ckpt@2) and for CI — same engine path as fig1-xxl at a fleet small
# enough to also run stacked for parity.
_COHORT_SMOKE = ProblemSpec(kind="synthetic_stream", seed=3, n_clients=96,
                            m=8, d=8, r=8, lam=1e-3, newton_iters=12,
                            solver="fused")

register_experiment(Experiment(
    name="cohort-smoke",
    figure="extra",
    title="Cohort-streaming smoke: 96 clients, 16-client cohorts",
    paper_ref="engine test scenario (no paper counterpart)",
    problem=_COHORT_SMOKE,
    cells=(
        MethodCell("BL2", "bl2", 12, basis="standard",
                   hess_comp=CompressorCfg(kind="topk", k=2 * 8),
                   model_comp=_IDENT, backend="cohort",
                   params=(("tau", 24), ("cohort", 16),
                           ("rounds_per_cohort", 2))),
    ),
    tags=("stream",),
))

# fig-dnn: the BL-DNN deep-network workload on the pytree round engine —
# bits-to-accuracy for the paper's communication mechanism (per-layer SVD
# basis + compressed-shift recursions + Fisher preconditioning) against an
# uncompressed FedAvg baseline and the no-basis Top-K ablation, plus the
# stochastic RTop-K codec (the gap stream is the training ERROR RATE, so
# tol=0.1 makes bits-to-tolerance = bits to 90% train accuracy).
_DNN = DNNProblemSpec()
_DNN_TOPK = CompressorCfg(kind="topk")   # per-leaf k from top_k_frac param

register_experiment(Experiment(
    name="fig-dnn",
    figure="extra",
    title="BL-DNN bits-to-accuracy: SVD basis vs FedAvg vs no-basis Top-K "
          "(beyond paper)",
    paper_ref="§2.3 mechanism on a DNN (no paper counterpart)",
    problem=_DNN,
    tol=0.1,                             # error rate < 0.1 ⇔ 90% accuracy
    cells=(
        MethodCell("BLDNN", "bldnn", 40, basis="per_layer_svd",
                   hess_comp=_DNN_TOPK,
                   params=(("top_k_frac", 0.1), ("lr", 0.05))),
        MethodCell("TopK", "bldnn", 40,
                   hess_comp=_DNN_TOPK,
                   params=(("top_k_frac", 0.1), ("lr", 0.05))),
        MethodCell("RTopK", "bldnn", 40, basis="per_layer_svd",
                   hess_comp=CompressorCfg(kind="rtopk"),
                   params=(("top_k_frac", 0.1), ("lr", 0.05))),
        MethodCell("FedAvg", "bldnn", 60,
                   hess_comp=CompressorCfg(kind="identity"),
                   params=(("lr", 0.5), ("precondition", False))),
    ),
))

# fig-dnn-ship: make the basis pay for itself.  fig-dnn shows the per-layer
# SVD basis winning ROUNDS-to-90% (10 vs 13) but losing the BITS headline
# to no-basis TopK because its dense-f32 shipment costs 0.69 Mbit.  This
# grid attacks the shipment leg itself: the same basis shipped bf16 / int8
# (quantized factors are what the engine rotates with — fidelity loss
# included), plus the FREE structured pytree bases (per-leaf DCT /
# Walsh–Hadamard rotations, zero floats shipped).  Same problem, compressor
# and tolerance as fig-dnn, so bits-to-tol columns compare directly.
register_experiment(Experiment(
    name="fig-dnn-ship",
    figure="extra",
    title="BL-DNN basis shipment: compressed / free bases vs no-basis Top-K "
          "(beyond paper)",
    paper_ref="Table 1 basis_ship leg carried to the DNN workload "
              "(no paper counterpart)",
    problem=_DNN,
    tol=0.1,                             # error rate < 0.1 ⇔ 90% accuracy
    cells=(
        MethodCell("TopK", "bldnn", 40,
                   hess_comp=_DNN_TOPK,
                   params=(("top_k_frac", 0.1), ("lr", 0.05))),
        MethodCell("BLDNN_f32", "bldnn", 40, basis="per_layer_svd",
                   hess_comp=_DNN_TOPK,
                   params=(("top_k_frac", 0.1), ("lr", 0.05))),
        MethodCell("BLDNN_bf16", "bldnn", 40, basis="per_layer_svd",
                   hess_comp=_DNN_TOPK,
                   params=(("top_k_frac", 0.1), ("lr", 0.05),
                           ("ship_float_bits", 16))),
        MethodCell("BLDNN_int8", "bldnn", 40, basis="per_layer_svd",
                   hess_comp=_DNN_TOPK,
                   params=(("top_k_frac", 0.1), ("lr", 0.05),
                           ("ship_float_bits", 8))),
        MethodCell("BLDNN_dct", "bldnn", 40, basis="dct_tree",
                   hess_comp=_DNN_TOPK,
                   params=(("top_k_frac", 0.1), ("lr", 0.05))),
        MethodCell("BLDNN_hadamard", "bldnn", 40, basis="hadamard_tree",
                   hess_comp=_DNN_TOPK,
                   params=(("top_k_frac", 0.1), ("lr", 0.05))),
    ),
))

# fig1-bag: FedNL-BAG (Bernoulli-lazy gradient aggregation, arXiv
# 2206.03588) vs FedNL — the follow-up method's first reproducible
# experiment path in this repo.
register_experiment(Experiment(
    name="fig1-bag",
    figure="extra",
    title="FedNL-BAG (Bernoulli gradient aggregation) vs FedNL (beyond paper)",
    paper_ref="Islamov et al. 2022 (arXiv 2206.03588) §BAG",
    problem=_PROBLEM,
    cells=(
        MethodCell("FedNL", "bl1", 2 * _S, basis="standard",
                   hess_comp=CompressorCfg(kind="rankr", r=1),
                   model_comp=_IDENT),
        MethodCell("BAG_q0.5", "fednl_bag", 2 * _S, basis="standard",
                   hess_comp=CompressorCfg(kind="rankr", r=1),
                   params=(("q", 0.5),)),
        MethodCell("BAG_q1.0", "fednl_bag", 2 * _S, basis="standard",
                   hess_comp=CompressorCfg(kind="rankr", r=1),
                   params=(("q", 1.0), ("eta", 1.0))),
    ),
))
