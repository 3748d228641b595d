"""The sweep engine: execute registered experiments, cell by cell — port of
`repro.exp.engine`.

`build_problem` materializes a `ProblemSpec` once per device (clients, x0,
reference optimum x*, memoized basis fleets); `run_cell` dispatches one
`MethodCell` to the public method entry points (`repro_torch.core.bl`,
`repro_torch.core.baselines`, `repro_torch.fed.bldnn`), as the reference
does; `run_experiment` sweeps (cell × seed), skips cells whose artifact
already exists with a matching config digest (resume — the reference's
committed artifacts included) and regenerates the figure CSVs from the
artifacts.

Where the port differs, and why:

  * every entry point takes ``device`` (``None`` means ``"cuda"``, raising
    without a card); the problem memo is keyed on (spec, device);
  * BL-DNN problems are not drawn: the reference draws them with
    ``jax.random.normal``, which the port does not yet reproduce bit for
    bit (ROADMAP.md §1 item 9's remainder).  `build_problem` loads the
    fig-dnn problem carried in ``data/fig_dnn_seed0.npz`` — data, student
    and the reference's per-layer SVD factors, which are not unique and
    which ``per_layer_svd`` cells rotate with — and refuses any other
    `DNNProblemSpec`;
  * backends (`resolve_backend`): ``"fast+sharded"`` (fig1-xl's) runs the
    sharded reducer (`repro_torch.core.rounds.ShardedReducer`) over the
    ranks of this process's `torch.distributed` world — ``torchrun
    --nproc-per-node W -m repro_torch.exp run …`` — and on one rank (the
    reference's one-device mesh) is bitwise ``"fast"``; ``"cohort"`` runs
    ``synthetic_stream`` problems (fig1-xxl, cohort-smoke) through the
    cohort-streaming engine (`repro_torch.core.cohort`), and
    ``"cohort+sharded"`` shards its cohorts the same way.  Under a world
    of several ranks only rank 0 writes artifacts and figure CSVs.

Long cells can stream progress: ``progress_every=N`` attaches a
`repro_torch.core.rounds.StreamHook` that reports (round, gap,
Mbits/node) every N rounds for the BL methods.
"""
from __future__ import annotations

import dataclasses
import functools
import pathlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .. import device as _device
from ..core import baselines, batched, bl, client_batch, cohort, compressors, glm, prng, specs
from ..core.basis import PerLayerSVDBasis, is_pytree_basis, make_bases
from ..core.convert import dnn_problem_from_numpy
from ..core.pytree import tree_leaves
from ..core.rounds import StreamHook
from ..fed import bldnn
from ..launch import mesh
from . import artifacts
from .registry import (
    CompressorCfg,
    DNNProblemSpec,
    Experiment,
    MethodCell,
    ProblemSpec,
)

DATA = pathlib.Path(__file__).resolve().parent / "data"
#: the carried fig-dnn problem (seed 0), written by the reference under
#: ``jax_threefry_partitionable=False`` (tests/test_torch_bldnn.py)
DNN_FIXTURE = DATA / "fig_dnn_seed0.npz"
#: the one `DNNProblemSpec` the fixture holds: fig-dnn's and fig-dnn-ship's
DNN_FIXTURE_SPEC = DNNProblemSpec()


def build_compressor(cfg: CompressorCfg, d: int) -> compressors.Compressor:
    """Materialize a declarative `CompressorCfg` for a d-dimensional problem
    (the composed Rank-R codecs derive their dithering levels from d)."""
    k = cfg.kind
    if k == "identity":
        return compressors.Identity()
    if k == "topk":
        return compressors.TopK(k=cfg.k, symmetrize=cfg.symmetrize)
    if k == "randk":
        return compressors.RandK(k=cfg.k)
    if k == "rankr":
        return compressors.RankR(r=cfg.r)
    if k == "dither":
        return compressors.RandomDithering(s=cfg.s)
    if k == "natural":
        return compressors.NaturalCompression()
    if k == "rtopk":
        return compressors.rtopk(cfg.k)
    if k == "ntopk":
        return compressors.ntopk(cfg.k)
    if k == "rrankr":
        return compressors.rrankr(cfg.r, d)
    if k == "nrankr":
        return compressors.nrankr(cfg.r)
    if k == "bernoulli":
        return compressors.BernoulliLazy(p=cfg.p)
    raise ValueError(f"unknown compressor kind {cfg.kind!r}")


@dataclasses.dataclass
class Problem:
    """A built problem regime: data, initial iterate, reference optimum."""

    spec: ProblemSpec
    clients: List[glm.ClientData]
    x0: torch.Tensor
    x_star: torch.Tensor
    _bases: Dict[str, list] = dataclasses.field(default_factory=dict)

    @property
    def d(self) -> int:
        return int(self.x0.shape[0])

    @property
    def n(self) -> int:
        return len(self.clients)

    def bases(self, name: str) -> list:
        """Per-client basis fleet for a `repro_torch.core.basis` registry
        name, built once per problem and memoized across cells."""
        if name not in self._bases:
            self._bases[name] = make_bases(name, self.clients, x0=self.x0)
        return self._bases[name]


@dataclasses.dataclass
class StreamProblem:
    """A built ``synthetic_stream`` regime: the fleet lives on the host in a
    `client_batch.ClientStore` (never stacked on the device) and the
    reference optimum comes from the slab-wise host Newton solver; the
    problem form the cohort-streaming engine consumes."""

    spec: ProblemSpec
    store: client_batch.ClientStore
    x0: torch.Tensor
    x_star: np.ndarray

    @property
    def d(self) -> int:
        return int(self.x0.shape[0])

    @property
    def n(self) -> int:
        return self.store.n


@dataclasses.dataclass
class DNNProblem:
    """A built `DNNProblemSpec`: client-stacked data, the student's
    parameters, the carried per-layer SVD basis, and the (stable,
    memoized) loss/eval closures."""

    spec: DNNProblemSpec
    batch: client_batch.TreeBatch
    params0: dict
    basis: PerLayerSVDBasis
    loss_fn: object
    eval_fn: object

    @property
    def n(self) -> int:
        return self.batch.n


def _nest(flat: Dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for path, value in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[leaf] = value
    return tree


def load_dnn_problem(path: pathlib.Path = DNN_FIXTURE,
                     spec: DNNProblemSpec = DNN_FIXTURE_SPEC, *,
                     device=None) -> DNNProblem:
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


@functools.lru_cache(maxsize=None)
def _build_problem(spec, dev: torch.device):
    if isinstance(spec, DNNProblemSpec):
        if spec != DNN_FIXTURE_SPEC:
            raise NotImplementedError(
                f"{spec} is not the carried fig-dnn problem: drawing a BL-DNN "
                "fleet needs jax.random.normal bit for bit, ROADMAP.md §1 "
                "item 9's remainder (normal / erf_inv) brings it")
        return load_dnn_problem(DNN_FIXTURE, spec, device=dev)
    if spec.kind == "synthetic_stream":
        store = client_batch.synthetic_store(spec.seed, spec.n_clients, spec.m, spec.d,
                                             lam=spec.lam)
        x_star = cohort.store_newton_solve(store, np.zeros(spec.d), iters=spec.newton_iters)
        return StreamProblem(spec=spec, store=store,
                             x0=torch.zeros(spec.d, dtype=torch.float64, device=dev),
                             x_star=x_star)
    if spec.kind == "table2":
        clients = glm.make_table2(spec.name, seed=spec.seed, lam=spec.lam, device=dev)
    elif spec.kind == "synthetic":
        clients = glm.make_synthetic(seed=spec.seed, n_clients=spec.n_clients,
                                     m=spec.m, d=spec.d, r=spec.r, lam=spec.lam,
                                     device=dev)
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


def build_problem(spec, device=None):
    """Materialize a `ProblemSpec` or `DNNProblemSpec` on `device`
    (``None``: the card), memoized on (spec, device) — figures share
    regimes.  ``build_problem.cache_clear()`` drops the memo (the CLI does
    after an ``"xl"`` or ``"stream"`` experiment)."""
    return _build_problem(spec, _device.resolve(device))


build_problem.cache_clear = _build_problem.cache_clear


#: the engine backends a cell may name
BACKENDS = ("auto", "fast", "fast+sharded", "reference", "cohort", "cohort+sharded")


def resolve_backend(backend: str) -> str:
    """The backend a cell declared, as this process runs it: every backend
    runs as named — ``"fast+sharded"`` and ``"cohort+sharded"`` over the
    ranks of this process's world (one process: a one-rank world) — and
    an unknown name raises ``ValueError``."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    return backend


#: methods that accept a PRNG seed (the sweep seed is injected only here;
#: newton/gd/local_gd are deterministic and take none)
_SEEDED_METHODS = frozenset(
    {"bl1", "bl2", "bl3", "fednl_bag", "nl1", "diana", "adiana", "dore",
     "bldnn"})


def _comp(cfg: Optional[CompressorCfg], d: int, what: str):
    if cfg is None:
        raise ValueError(f"cell needs a {what} compressor config")
    return build_compressor(cfg, d)


def build_stream_spec(cell: MethodCell, d: int, n: int, lam: float, params: dict):
    """`MethodSpec` and basis kind of a store-backed streaming cell, built
    from the cell's config (the stacked setups of `repro_torch.core.batched`
    start from client lists, which a streaming fleet never holds), with the
    fields and bit accounting of `bl2_setup`, `bl3_setup` and
    `fednl_bag_setup`.  Pops the engine's params (cohort, rounds_per_cohort,
    seed) from ``params`` and returns ``(spec, basis, cohort,
    rounds_per_cohort, seed)``."""
    m = cell.method
    cohort_size = int(params.pop("cohort", n))
    rpc = int(params.pop("rounds_per_cohort", 1))
    seed = int(params.pop("seed", 0))
    hc = _comp(cell.hess_comp, d, "hessian")
    if m == "bl2":
        mc = _comp(cell.model_comp, d, "model")
        bb = cohort.standard_basisb(d, n)
        init_exact = bool(params.pop("init_exact_hessian", True))
        spec = specs.BL2Spec(
            hess_comp=hc, model_comp=mc,
            alpha=params.pop("alpha", 1.0), eta=params.pop("eta", 1.0),
            p=params.pop("p", 1.0), tau=int(params.pop("tau", n)),
            init_exact=init_exact, init_hess_bits=bb.init_coeff_bits_mean(init_exact),
            basis_bits=bb.transmission_bits_mean(), block=False)
        basis = "standard"
    elif m == "bl3":
        mc = _comp(cell.model_comp, d, "model")
        spec = specs.BL3Spec(
            hess_comp=hc, model_comp=mc,
            alpha=params.pop("alpha", 1.0), eta=params.pop("eta", 1.0),
            p=params.pop("p", 1.0), tau=int(params.pop("tau", n)),
            c=params.pop("c", 1e-8), option=int(params.pop("option", 2)))
        basis = None
    elif m == "fednl_bag":
        bb = cohort.standard_basisb(d, n)
        init_exact = bool(params.pop("init_exact_hessian", True))
        q = params.pop("q", 0.5)
        eta = params.pop("eta", None)
        mu = params.pop("mu", None)
        spec = specs.FedNLBAGSpec(
            hess_comp=hc, alpha=params.pop("alpha", 1.0), q=q,
            eta=q if eta is None else eta, mu=lam if mu is None else mu,
            init_exact=init_exact, init_hess_bits=bb.init_coeff_bits_mean(init_exact),
            basis_bits=bb.transmission_bits_mean(), block=False)
        basis = "standard"
    else:
        raise ValueError(f"method {m!r} has no cohort-streaming path (bl2, bl3 and "
                         "fednl_bag stream: see MethodSpec.supports_cohort)")
    if params:
        raise ValueError(f"unused streaming cell params {sorted(params)} for {m!r}")
    return spec, basis, cohort_size, rpc, seed


def _run_stream_cell(cell: MethodCell, prob: StreamProblem, steps: int, params: dict,
                     dev: torch.device, sharded: bool = False,
                     exact: bool = True) -> bl.History:
    spec, basis, csize, rpc, seed = build_stream_spec(cell, prob.d, prob.n, prob.store.lam,
                                                      params)
    eng = cohort.CohortEngine(spec, prob.store, prob.x0.to(dev), cohort=csize,
                              rounds_per_cohort=rpc, root_key=prng.PRNGKey(seed), basis=basis,
                              sharded=sharded, exact=exact)
    try:
        eval_x, leds, _events = eng.run_chunk(0, steps)
        uploads = None if eng.uploads is None else [u.tolist() for u in eng.uploads]
    finally:
        eng.close()
    # the fleet's gaps are evaluated slab by slab on the host: the device
    # never holds more than a cohort
    xs = eval_x.cpu().numpy()
    f_star = cohort.store_loss(prob.store, prob.x_star)
    gaps = torch.tensor([cohort.store_loss(prob.store, xs[t]) - f_star
                         for t in range(xs.shape[0])], dtype=torch.float64)
    hist = batched._history({"gap": gaps}, leds)
    hist.uploads = uploads
    return hist


def run_cell(exp: Experiment, cell: MethodCell, prob, *,
             steps: Optional[int] = None, seed: Optional[int] = None,
             backend: Optional[str] = None,
             stream: Optional[StreamHook] = None, device=None,
             basis_project: str = "einsum", exact: bool = True) -> bl.History:
    """Run one cell and return its `History`.

    Args:
      exp, cell: the registered experiment and one of its cells.
      prob: the built problem (`build_problem(exp.problem, device)`).
      steps: override the cell's round budget — shorter OR longer.
      seed: sweep seed; a ``seed`` in ``cell.params`` takes precedence
        (cells that pin a seed reproduce one specific committed curve).
      backend: override the cell's engine backend (`resolve_backend`).
      stream: optional mid-sweep progress hook (`rounds.StreamHook`).
      device: the run's device, ``None`` meaning ``"cuda"``; the problem's
        tensors are moved there.
      basis_project: the route of the data basis's Γ = VᵀAV for ``bl1``
        and ``newton``: "einsum" (float64, the reference's default) or
        "kernel" (float32 through the tiled-matmul kernel, the reference's
        ``REPRO_BL_PALLAS=1`` route).
      exact: the ``+sharded`` backends' collectives (the bitwise gather, or
        the spec's `repro_torch.core.rounds.ReducePlan`) for the methods on
        the round engine that take it (bl1, bl2, bl3, fednl_bag, bldnn and
        the streaming cells).
    """
    m = cell.method
    steps = cell.steps if steps is None else steps
    backend = resolve_backend(cell.backend if backend is None else backend)
    params = cell.params_dict()
    if seed is not None and m in _SEEDED_METHODS:
        params.setdefault("seed", seed)

    if isinstance(prob, StreamProblem):
        if backend == "auto":
            backend = "cohort"
        if backend not in ("cohort", "cohort+sharded"):
            raise ValueError(f"cell {cell.name!r}: a synthetic_stream problem runs on the "
                             f"cohort backends, got backend={backend!r}")
        return _run_stream_cell(cell, prob, steps, params, _device.resolve(device),
                                sharded=backend == "cohort+sharded", exact=exact)
    if basis_project != "einsum" and m not in ("bl1", "newton"):
        raise ValueError(f"basis_project={basis_project!r} routes Γ of bl1 and "
                         f"newton only, not of {m!r}")

    if m == "bldnn":
        if not isinstance(prob, DNNProblem):
            raise ValueError(
                f"cell {cell.name!r} needs a DNNProblemSpec problem")
        if cell.hess_comp is None:
            raise ValueError("bldnn cells configure the (gradient+Fisher) "
                             "compressor via hess_comp")
        run_seed = params.pop("seed", 0)
        if cell.basis is not None and not is_pytree_basis(cell.basis):
            raise ValueError(
                f"cell {cell.name!r}: bldnn needs a pytree basis "
                f"(per_layer_svd / dct_tree / hadamard_tree), got "
                f"{cell.basis!r}")
        cfg = bldnn.BLDNNConfig(compressor=cell.hess_comp.kind,
                                use_basis=cell.basis is not None,
                                basis_kind=cell.basis or "per_layer_svd",
                                **params)
        # "auto" on a DNN cell means the engine's single-device fast path
        eng_backend = "fast" if backend == "auto" else backend
        basis = prob.basis if cell.basis == "per_layer_svd" else None
        return bldnn.run_bldnn(prob.loss_fn, prob.eval_fn, prob.params0,
                               prob.batch, steps, cfg, seed=run_seed,
                               backend=eng_backend, exact=exact, basis=basis, stream=stream,
                               device=device)

    n, d = prob.n, prob.d
    clients, x0, xs = prob.clients, prob.x0, prob.x_star

    if m in ("bl1", "bl2", "bl3", "fednl_bag"):
        hc = [_comp(cell.hess_comp, d, "hessian")] * n
        if m == "bl1":
            mc = _comp(cell.model_comp, d, "model")
            return bl.bl1(clients, prob.bases(cell.basis), hc, mc, x0, xs,
                          steps, backend=backend, stream=stream, exact=exact,
                          basis_project=basis_project, device=device, **params)
        if m == "bl2":
            mc = [_comp(cell.model_comp, d, "model")] * n
            return bl.bl2(clients, prob.bases(cell.basis), hc, mc, x0, xs,
                          steps, backend=backend, stream=stream, exact=exact, device=device,
                          **params)
        if m == "bl3":
            mc = [_comp(cell.model_comp, d, "model")] * n
            return bl.bl3(clients, hc, mc, x0, xs, steps, backend=backend,
                          stream=stream, exact=exact, device=device, **params)
        return baselines.fednl_bag(clients, prob.bases(cell.basis), hc, x0,
                                   xs, steps, backend=backend, exact=exact, device=device,
                                   **params)
    if m == "newton":
        bases = prob.bases(cell.basis) if cell.basis else None
        return baselines.newton(clients, x0, xs, steps, bases=bases,
                                backend=backend, basis_project=basis_project,
                                device=device, **params)
    if m == "nl1":
        return baselines.nl1(clients, x0, xs, steps, device=device, **params)
    if m == "gd":
        return baselines.gd(clients, x0, xs, steps, backend=backend, device=device,
                            **params)
    if m == "diana":
        comp = _comp(cell.hess_comp, d, "gradient")
        return baselines.diana(clients, x0, xs, steps, comp,
                               comp.omega_for(d), backend=backend, device=device,
                               **params)
    if m == "adiana":
        comp = _comp(cell.hess_comp, d, "gradient")
        return baselines.adiana(clients, x0, xs, steps, comp,
                                comp.omega_for(d), device=device, **params)
    if m == "local_gd":
        return baselines.local_gd(clients, x0, xs, steps, device=device, **params)
    if m == "dore":
        up = _comp(cell.hess_comp, d, "uplink")
        down = _comp(cell.model_comp, d, "downlink")
        return baselines.dore_like(clients, x0, xs, steps, up, down, device=device,
                                   **params)
    raise ValueError(f"unknown method {m!r} in cell {cell.name!r}")


def _progress_hook(exp: Experiment, cell: MethodCell, prob: Problem,
                   every: int, log) -> StreamHook:
    # the gap is evaluated in numpy on host copies of the fleet, as the
    # reference's hook does (its body runs inside a host callback)
    A = np.stack([c.A.cpu().numpy() for c in prob.clients])   # (n, m, d)
    b = np.stack([c.b.cpu().numpy() for c in prob.clients])   # (n, m)
    lam = prob.clients[0].lam
    x_star = prob.x_star.cpu().numpy()

    def loss(x):
        z = (A @ x) * b
        return float(np.mean(np.logaddexp(0.0, -z))
                     + 0.5 * lam * np.dot(x, x))

    f_star = loss(x_star)

    def report(t, eval_x, ledger):
        gap = loss(eval_x.detach().cpu().numpy()) - f_star
        mb = float(ledger.uplink) / 1e6
        log(f"    [{exp.name}/{cell.name}] round {t}: gap={gap:.3e} "
            f"up={mb:.3f} Mbits/node")

    return StreamHook(every=every, callback=report)


def _layout_n(cell: MethodCell, prob) -> int:
    """The client count a sharded cell spreads over the ranks: the fleet,
    or a streaming cell's cohort capacity."""
    if isinstance(prob, StreamProblem):
        return cohort.capacity(int(cell.params_dict().get("cohort", prob.n)), prob.n)
    return prob.n


def run_experiment(exp: Experiment, out_dir: str, artifacts_dir: str, *,
                   force: bool = False, max_steps: Optional[int] = None,
                   cells: Optional[Sequence[str]] = None,
                   seeds: Optional[Sequence[int]] = None,
                   progress_every: Optional[int] = None,
                   log=print, device=None) -> List[dict]:
    """Sweep an experiment: run (cell × seed), write artifacts + CSVs.

    Cells whose artifact JSON already exists with a matching config digest
    are *skipped* (status "cached") unless ``force`` — re-running a partial
    sweep is idempotent and completes only the missing cells.  Figure CSVs
    are regenerated from the artifacts every time.  ``device`` (``None``:
    the card) is resolved only when a cell runs.  Under a world of several
    ranks (``torchrun``) every rank runs the cells and rank 0 alone logs
    and writes.  Returns one summary dict per (cell, seed).
    """
    summaries = []
    # under a world of several ranks every rank runs the cells, rank 0 writes
    mesh.init_from_env(device)
    writer = mesh.world()[0] == 0
    log = mesh.rank0(log)
    sweep_seeds = tuple(seeds) if seeds is not None else exp.seeds
    run_cells = (exp.cells if cells is None
                 else tuple(exp.cell(c) for c in cells))
    prob = dev = None
    for cell in run_cells:
        eff_steps = (cell.steps if max_steps is None
                     else min(cell.steps, max_steps))
        for seed in sweep_seeds:
            config = artifacts.cell_config(exp, cell, seed, eff_steps)
            digest = artifacts.config_digest(config)
            path = artifacts.artifact_path(artifacts_dir, exp.name,
                                           cell.name, seed)
            record = None if force else artifacts.load_json(path)
            if record is not None and record.get("config_digest") == digest:
                status = "cached"
            else:
                if prob is None:
                    dev = _device.resolve(device)
                    prob = build_problem(exp.problem, dev)
                backend = resolve_backend(cell.backend)
                if backend.endswith("+sharded"):
                    lay = mesh.client_group(_layout_n(cell, prob), dev).describe()
                    log(f"  {exp.name}/{cell.name}: backend {backend} on "
                        f"{lay['world_size']} rank(s), {lay['ndev']} holding clients "
                        f"({lay['n_local']} each), process group {lay['backend']}")
                stream = None
                if progress_every and cell.method in ("bl1", "bl2", "bl3"):
                    stream = _progress_hook(exp, cell, prob,
                                            progress_every, log)
                t0 = time.perf_counter()
                hist = run_cell(exp, cell, prob, steps=eff_steps, seed=seed,
                                stream=stream, device=dev)
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                runtime = time.perf_counter() - t0
                record = artifacts.cell_record(exp, cell, seed, eff_steps,
                                               hist, runtime_s=runtime)
                if writer:
                    artifacts.write_json(path, record)
                status = "ran"
            csv_file = None
            if seed == sweep_seeds[0] and writer:
                csv_file = artifacts.write_fig_csv(out_dir, record)
            b2t = record["bits_to_tol"]
            summaries.append({
                "experiment": exp.name, "cell": cell.name, "seed": seed,
                "status": status, "steps": eff_steps,
                "mbits_to_tol": b2t["mbits_per_node"],
                "reached": b2t["reached"],
                "final_gap": record["history"]["gaps"][-1],
                "runtime_s": record.get("runtime_s"),
                "artifact": path, "csv": csv_file,
            })
            reach = (f"{b2t['mbits_per_node']:.3f} Mbits to {exp.tol:g}"
                     if b2t["reached"] else
                     f"tol not reached (gap {record['history']['gaps'][-1]:.2e})")
            log(f"  {exp.name}/{cell.name} seed={seed} [{status}] "
                f"{eff_steps} rounds — {reach}")
    return summaries
