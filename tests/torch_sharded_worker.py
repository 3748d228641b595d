"""One rank of `tests/test_torch_sharded.py`'s world of W ranks (gloo on the
CPU).

    RANK=r WORLD_SIZE=W MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_sharded_worker.py DATA_DIR OUT_DIR

The test starts W of these with the environment ``torchrun`` sets, so the
port's own `repro_torch.launch.mesh.init_from_env` builds the world.  Each
rank runs every case below through the port's public entry points on the
``fast+sharded`` / ``cohort+sharded`` backends (exact and ``exact=False``)
and pickles what it saw to ``OUT_DIR/rank{r}.pkl``; the test compares the
ranks with each other, with the one-process port and with the JAX package.
``DATA_DIR`` holds the GLM problems as numpy arrays (``glm_*.npz``) and the
serve checkpoint directories.  Imports the port only.
"""
from __future__ import annotations

import hashlib
import os
import pathlib
import pickle
import sys

import numpy as np
import torch

from repro_torch.core import baselines, bl, cohort, compressors, prng, rounds, specs
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.core.convert import problem_from_numpy
from repro_torch.exp import engine, registry
from repro_torch.fed import bldnn
from repro_torch.launch import fed_serve, mesh

GLM_STEPS = 8
DNN_STEPS = 4


def glm_problem(data: pathlib.Path, name: str):
    z = np.load(data / f"glm_{name}.npz")
    return problem_from_numpy(z["A"], z["b"], float(z["lam"]), z["V"], z["rs"], z["x0"],
                              z["x_star"], device="cpu")


def run_glm(case: str, p, **kw):
    """One GLM case on the port's entry points (``kw``: backend, exact)."""
    n, d = len(p.clients), p.x0.shape[0]
    r = max(b.r for b in p.bases)
    C = compressors
    if case == "bl1":
        return bl.bl1(p.clients, p.bases, [C.TopK(k=r)] * n, C.Identity(), p.x0, p.x_star,
                      GLM_STEPS, device="cpu", **kw)
    if case == "bl2":
        return bl.bl2(p.clients, p.bases, [C.TopK(k=2 * r)] * n, [C.Identity()] * n, p.x0,
                      p.x_star, GLM_STEPS, tau=3, p=0.5, seed=2, device="cpu", **kw)
    if case == "bl3":
        return bl.bl3(p.clients, [C.TopK(k=d)] * n, [C.Identity()] * n, p.x0, p.x_star,
                      GLM_STEPS, tau=4, p=0.5, seed=1, device="cpu", **kw)
    if case == "bag":
        return baselines.fednl_bag(p.clients, p.bases, [C.TopK(k=r)] * n, p.x0, p.x_star,
                                   GLM_STEPS, q=0.5, seed=1, device="cpu", **kw)
    raise ValueError(case)


#: the GLM cases and their problems: n = 10 at W = 4 holds clients on 2 ranks
GLM_CASES = {"bl1": "n10", "bl2": "n8", "bl3": "n8", "bag": "n8"}


def run_dnn(**kw):
    exp = registry.get_experiment("fig-dnn")
    prob = engine.build_problem(exp.problem, "cpu")
    cell = exp.cell("BLDNN")
    params = cell.params_dict()
    params.pop("seed", None)
    cfg = bldnn.BLDNNConfig(compressor=cell.hess_comp.kind, use_basis=True,
                            basis_kind=cell.basis, **params)
    return bldnn.run_bldnn(prob.loss_fn, prob.eval_fn, prob.params0, prob.batch, DNN_STEPS,
                           cfg, basis=prob.basis, device="cpu", **kw)


def _stack(seed: int, n: int):
    """A client-stacked pytree of mixed dtypes, the same on every rank."""
    g = torch.Generator().manual_seed(seed)
    return {"a": torch.randn(n, 3, 4, generator=g, dtype=torch.float64),
            "b": {"c": torch.randn(n, 5, generator=g, dtype=torch.float32),
                  "d": torch.randn(n, generator=g, dtype=torch.float64)},
            "e": torch.randint(0, 7, (n, 2), generator=g, dtype=torch.int32),
            # a leaf laid out transposed, as an einsum can return one
            "f": torch.randn(n, 4, 6, generator=g, dtype=torch.float64).mT}


def reducer_checks(R: rounds.ShardedReducer) -> dict:
    """reduce_tree's packing against per-leaf calls and the one-rank
    reduction of the whole stack, `once` against the plain call, the
    fleet-wide draws against the one-rank draws cut to the rank's rows."""
    full = _stack(0, R.n)
    local = tree_map(R.shard, full)
    V = rounds.VmapReducer(n=R.n)
    ops = {"a": "mean", "b": "sum", "e": "max", "f": "mean"}
    packed = R.reduce_tree(local, ops)
    leafwise = {"a": R.mean(local["a"]), "b": {k: R.sum(v) for k, v in local["b"].items()},
                "e": R.max(local["e"]), "f": R.mean(local["f"])}
    one = V.reduce_tree(full, ops)
    out = {"packed_vs_leafwise": [torch.equal(x, y) for x, y in
                                  zip(tree_leaves(packed), tree_leaves(leafwise))],
           "packed_vs_one_rank": [torch.equal(x, y) for x, y in
                                  zip(tree_leaves(packed), tree_leaves(one))]}
    H = torch.tensor([[2.0, 0.5], [0.5, 1.0]], dtype=torch.float64)
    f = lambda H, g: (-0.0 * g, torch.linalg.solve(H, g))  # noqa: E731
    g = torch.tensor([1.0, -2.0], dtype=torch.float64)
    got, ref = R.once(f, H, g), f(H, g)
    out["once"] = [torch.equal(a, b) and torch.equal(torch.signbit(a), torch.signbit(b))
                   for a, b in zip(got, ref)]
    key = prng.PRNGKey(11)
    avail = torch.arange(R.n) % 3 != 1
    for tau in (1, 3, R.n):
        for av in (None, avail):
            m_sh, e_sh = rounds.participation(R, key, tau, av)
            m_one, e_one = rounds.participation(V, key, tau, av)
            out.setdefault("participation", []).append(
                torch.equal(m_sh, R.shard(m_one)) and torch.equal(e_sh, e_one))
    out["xi_mask"] = torch.equal(rounds.xi_mask(R, key, 0.5),
                                 R.shard(rounds.xi_mask(V, key, 0.5)))
    out["client_keys"] = torch.equal(R.client_keys(key), R.shard(V.client_keys(key)))
    return out


def bag_send_flags(p) -> list:
    """FedNL-BAG's per-round send flags as the sharded step cut them (read
    where the step records its uploads)."""
    seen = []
    orig = specs.note_uploads
    specs.note_uploads = lambda R, mask: seen.append(mask.clone())
    try:
        run_glm("bag", p, backend="fast+sharded")
    finally:
        specs.note_uploads = orig
    return [m.tolist() for m in seen]


def presummed_checks(R: rounds.ShardedReducer) -> dict:
    """``exact=False``'s Fisher leg reads the local sums: a wrong sum moves
    the mean, the right one gives the fleet mean."""
    Ra = rounds.ShardedReducer(n=R.n, group=R.group, exact=False,
                               plan=specs.BLDNNSpec.reduce_plan)
    full = _stack(1, R.n)["b"]["c"]
    local = R.shard(full)
    right = Ra.tree_mean_presummed({"w": local}, {"w": local.sum(dim=0)})["w"]
    wrong = Ra.tree_mean_presummed({"w": local}, {"w": 2.0 * local.sum(dim=0)})["w"]
    return {"right_err": float((right - full.mean(dim=0)).abs().max()),
            "wrong_moves": not torch.allclose(right, wrong)}


def dnn_with_wrong_sums() -> object:
    """BL-DNN under ``exact=False`` with the compress-sum codec's local sums
    doubled: if the run reads them, its loss stream moves."""
    orig = compressors.TopK.compress_sum

    def doubled(self, keys, x):
        dense, counts, s = orig(self, keys, x)
        return dense, counts, 2.0 * s
    compressors.TopK.compress_sum = doubled
    try:
        return run_dnn(backend="fast+sharded", exact=False)
    finally:
        compressors.TopK.compress_sum = orig


def _sha(store) -> str:
    h = hashlib.sha256()
    for k in sorted(store.state):
        h.update(np.ascontiguousarray(store.state[k]).tobytes())
    return h.hexdigest()


def cohort_runs(cohort_size=None, sharded=True) -> dict:
    """cohort-smoke's BL2 on the cohort engine (sharded, or on one rank),
    epoch by epoch: its streams, participants and the store's checksum
    after each epoch."""
    exp = registry.get_experiment("cohort-smoke")
    cell = exp.cell("BL2")
    prob = engine.build_problem(exp.problem, "cpu")
    params = cell.params_dict()
    if cohort_size is not None:
        params["cohort"] = cohort_size
    spec, basis, csize, rpc, seed = engine.build_stream_spec(cell, prob.d, prob.n,
                                                             prob.store.lam, params)
    eng = cohort.CohortEngine(spec, prob.store, prob.x0, cohort=csize, rounds_per_cohort=rpc,
                              root_key=prng.PRNGKey(seed), basis=basis, sharded=sharded)
    xs, shas, ups = [], [], []
    for t in range(0, cell.steps, rpc):
        x, led, _ = eng.run_chunk(t, rpc)
        xs.append((x, led))
        ups += [u.tolist() for u in eng.uploads]
        shas.append(_sha(prob.store))
    eng.close()
    return {"eval_x": torch.cat([x for x, _ in xs]).tolist(),
            "hess_up": torch.cat([led.hess_up for _, led in xs]).tolist(),
            "uploads": ups, "store_sha": shas, "cap": eng.cap}


def main(data: pathlib.Path, out: pathlib.Path) -> None:
    torch.set_num_threads(1)
    mesh.init_from_env("cpu")
    rank, size = mesh.world()
    res = {"world": (rank, size)}
    probs = {name: glm_problem(data, name) for name in ("n10", "n8")}
    for case, pname in GLM_CASES.items():
        for exact in (True, False):
            res[("glm", case, exact)] = run_glm(case, probs[pname], backend="fast+sharded",
                                                exact=exact)
    res["layout_n10"] = mesh.client_group(10, "cpu").describe()
    res["bag_send"] = bag_send_flags(probs["n8"])
    for exact in (True, False):
        res[("dnn", exact)] = run_dnn(backend="fast+sharded", exact=exact)
    res["dnn_wrong_sums"] = dnn_with_wrong_sums()
    R = rounds.make_reducer(None, 8, "cpu", sharded=True)
    res["reducer"] = reducer_checks(R)
    res["presummed"] = presummed_checks(R)
    smoke = registry.get_experiment("cohort-smoke")
    res["smoke_cell"] = engine.run_cell(smoke, smoke.cell("BL2"),
                                        engine.build_problem(smoke.problem, "cpu"),
                                        backend="cohort+sharded", device="cpu")
    res["smoke_epochs"] = cohort_runs()
    res["smoke_padded"] = cohort_runs(cohort_size=6)
    quiet = dict(log=lambda *a: None, device="cpu", backend="fast+sharded")
    serve = ["--exp", "fig4", "--cell", "BL2_tau_half", "--seed", "3", "--chunk", "6",
             "--dropout-p", "0.2", "--fault-seed", "11"]
    plan_n = 10
    plan = fed_serve._build_plan(fed_serve._parser().parse_args(serve), plan_n)
    # W ranks write the first 12 rounds; the test resumes them on one rank
    res["serve_w_to_1"] = fed_serve.serve(exp_name="fig4", cell_name="BL2_tau_half", seed=3,
                                          chunk=6, max_rounds=12, ckpt_dir=str(data / "s_w"),
                                          plan=plan, **quiet)
    # W ranks resume what one rank wrote
    res["serve_1_to_w"] = fed_serve.serve(exp_name="fig4", cell_name="BL2_tau_half", seed=3,
                                          chunk=6, max_rounds=30, ckpt_dir=str(data / "s_1"),
                                          plan=plan, result_path=str(data / "s_1.json"),
                                          **quiet)
    res["serve_cohort"] = fed_serve.serve(exp_name="cohort-smoke", cell_name="BL2", chunk=3,
                                          max_rounds=6, ckpt_dir=str(data / "s_cohort"),
                                          log=lambda *a: None, device="cpu",
                                          backend="cohort+sharded")
    with open(out / f"rank{rank}.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(pathlib.Path(sys.argv[1]), pathlib.Path(sys.argv[2]))
    os._exit(0)
