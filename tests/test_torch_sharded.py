"""The sharded reducer (`repro_torch.core.rounds.ShardedReducer`) on a world
of 4 gloo ranks on the CPU, against the one-process port and the JAX
package.

One module-scoped launch starts 4 processes of `torch_sharded_worker.py`
with the environment ``torchrun`` sets; each runs every case through the
port's entry points on ``fast+sharded`` and ``cohort+sharded`` and pickles
what it saw.  The tests then hold:

  * exact mode bitwise to the one-process port (BL1 at n = 10, where 2 of
    the 4 ranks hold clients; BL2, BL3 and FedNL-BAG at n = 8; BL-DNN;
    cohort-smoke), every rank alike;
  * the same GLM cases to the JAX package's ``fast`` backend in the GLM
    gate (|Δgap| ≤ 1e-8·|ref| + 1e-12, every bit stream exact);
  * ``exact=False`` in the reference's own envelope of the exact run
    (tests/test_sharding_multidev.py: gaps rtol 1e-6, atol 1e-12; bits
    rtol 1e-9), and BL-DNN's in its rounds-0–3 gate, reading kernel 2's
    local sums (doubled sums move the run);
  * `reduce_tree`'s packing bitwise per leaf, `once` equal to the plain
    call, participation, ξ, client keys and FedNL-BAG's send flags cut
    from the fleet-wide draw;
  * cohort-smoke's stores equal on every rank after every epoch and to the
    one-rank engine's, its history held to the JAX package's file, and a
    padded cohort (6 clients in 8 slots);
  * serve checkpoints written at 4 ranks resumed at 1 and the reverse, bit
    for bit, and a rank killed mid-serve ending the run with non-zero exits.
"""
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import bl as jbl
from repro.core import client_batch as jcb
from repro.core import compressors as jcomp
from repro.core import glm as jglm
from repro.core.basis import make_bases as jmake_bases
from repro_torch.core import specs
from repro_torch.exp import engine, problems, registry
from repro_torch.launch import fed_serve

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = pathlib.Path(__file__).resolve().parent / "torch_sharded_worker.py"
sys.path.insert(0, str(WORKER.parent))
import torch_sharded_worker as worker  # noqa: E402

W = 4
GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
ENV_RTOL, ENV_ATOL, BITS_RTOL = 1e-6, 1e-12, 1e-9
SERVE_ARGS = ["--exp", "fig4", "--cell", "BL2_tau_half", "--seed", "3", "--chunk", "6",
              "--dropout-p", "0.2", "--fault-seed", "11"]
QUIET = dict(log=lambda *a: None, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_env(rank: int, world: int, port: int) -> dict:
    env = dict(os.environ)
    env.update(PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
               LOCAL_RANK=str(rank), WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
               REPRO_DIST_TIMEOUT_S="60")
    return env


def _plan():
    return fed_serve._build_plan(fed_serve._parser().parse_args(SERVE_ARGS), 10)


def _serve(ckpt, max_rounds, **kw):
    return fed_serve.serve(exp_name="fig4", cell_name="BL2_tau_half", seed=3, chunk=6,
                           max_rounds=max_rounds, ckpt_dir=str(ckpt), plan=_plan(),
                           backend="fast+sharded", **QUIET, **kw)


def _strip(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "meta"}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The GLM problems drawn by the JAX package (as numpy), a checkpoint
    one rank wrote, then the 4 ranks' results: ``(data dir, {rank:
    results})``."""
    tmp = tmp_path_factory.mktemp("sharded")
    data, out = tmp / "data", tmp / "out"
    data.mkdir()
    out.mkdir()
    for name, (seed, n) in {"n10": (0, 10), "n8": (1, 8)}.items():
        clients = jglm.make_synthetic(seed=seed, n_clients=n, m=30, d=20, r=6, lam=1e-3)
        x0 = jnp.zeros(20, jnp.float64)
        xs = jglm.newton_solve(clients, x0, 20)
        jbb = jcb.stack_bases(jmake_bases("data_outer", clients))
        np.savez(data / f"glm_{name}.npz", A=np.stack([np.asarray(c.A) for c in clients]),
                 b=np.stack([np.asarray(c.b) for c in clients]), lam=1e-3,
                 V=np.asarray(jbb.V), rs=np.asarray(jbb.rs), x0=np.asarray(x0),
                 x_star=np.asarray(xs))
    _serve(data / "s_1", 12)           # one rank writes 12 rounds; 4 resume
    port = _free_port()
    procs = [subprocess.Popen([sys.executable, str(WORKER), str(data), str(out)],
                              env=_rank_env(r, W, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(W)]
    logs = [p.communicate(timeout=600)[0] for p in procs]
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{log[-4000:]}"
    return data, {r: pickle.loads((out / f"rank{r}.pkl").read_bytes()) for r in range(W)}


def _hist_equal(a, b) -> bool:
    return (a.gaps == b.gaps and a.up_bits == b.up_bits and a.down_bits == b.down_bits
            and a.legs == b.legs and a.metrics == b.metrics)


@pytest.fixture(scope="module")
def probs(world):
    data, _ = world
    return {name: worker.glm_problem(data, name) for name in ("n10", "n8")}


# --------------------------------------------------------------------------
# the world
# --------------------------------------------------------------------------
def test_every_rank_returns_the_same_results(world):
    _, res = world
    assert [res[r]["world"] for r in range(W)] == [(r, W) for r in range(W)]
    for r in range(1, W):
        for key, h in res[0].items():
            if isinstance(key, tuple):
                assert _hist_equal(res[r][key], h), (r, key)
        for key in ("smoke_cell",):
            assert _hist_equal(res[r][key], res[0][key])
            assert res[r][key].uploads == res[0][key].uploads
        for key in ("smoke_epochs", "smoke_padded"):
            assert res[r][key] == res[0][key], (r, key)
        for key in ("serve_w_to_1", "serve_1_to_w", "serve_cohort"):
            assert _strip(res[r][key]) == _strip(res[0][key]), (r, key)


def test_layout_follows_the_references_rule(world):
    _, res = world
    # n = 10 over 4 ranks: the largest divisor of 10 that is at most 4
    assert res[0]["layout_n10"] == {"world_size": 4, "ndev": 2, "n_local": 5,
                                    "backend": "gloo"}
    assert res[0]["serve_w_to_1"]["meta"]["layout"]["ndev"] == 2
    assert res[0]["smoke_epochs"]["cap"] == 16 and res[0]["smoke_padded"]["cap"] == 8


# --------------------------------------------------------------------------
# GLM: exact bitwise, the JAX package's gate, exact=False's envelope
# --------------------------------------------------------------------------
@pytest.mark.parametrize("case", sorted(worker.GLM_CASES))
def test_exact_is_bitwise_the_one_process_port(world, probs, case):
    _, res = world
    one = worker.run_glm(case, probs[worker.GLM_CASES[case]], backend="fast")
    assert _hist_equal(res[0][("glm", case, True)], one)


def _jax_run(case, data):
    z = np.load(data / f"glm_{worker.GLM_CASES[case]}.npz")
    n = z["A"].shape[0]
    clients = [jglm.ClientData(A=jnp.asarray(z["A"][i]), b=jnp.asarray(z["b"][i]),
                               lam=float(z["lam"])) for i in range(n)]
    from repro.core.basis import DataOuterBasis
    bases = [DataOuterBasis(V=jnp.asarray(z["V"][i, :, :r])) for i, r in enumerate(z["rs"])]
    x0, xs = jnp.asarray(z["x0"]), jnp.asarray(z["x_star"])
    r, d, S = int(max(z["rs"])), x0.shape[0], worker.GLM_STEPS
    with jax.threefry_partitionable(False):
        if case == "bl1":
            return jbl.bl1(clients, bases, [jcomp.TopK(k=r)] * n, jcomp.Identity(), x0, xs, S,
                           backend="fast")
        if case == "bl2":
            return jbl.bl2(clients, bases, [jcomp.TopK(k=2 * r)] * n, [jcomp.Identity()] * n,
                           x0, xs, S, tau=3, p=0.5, seed=2, backend="fast")
        if case == "bl3":
            return jbl.bl3(clients, [jcomp.TopK(k=d)] * n, [jcomp.Identity()] * n, x0, xs, S,
                           tau=4, p=0.5, seed=1, backend="fast")
        return jbase.fednl_bag(clients, bases, [jcomp.TopK(k=r)] * n, x0, xs, S, q=0.5,
                               seed=1, backend="fast")


def _assert_gate(gaps, ref):
    g, gr = np.asarray(gaps), np.asarray(ref)
    assert g.shape == gr.shape and np.all(np.isfinite(g))
    bad = ~(np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL)
    assert not bad.any(), (g, gr)


@pytest.mark.parametrize("case", sorted(worker.GLM_CASES))
def test_exact_is_in_the_glm_gate_of_the_jax_package(world, case):
    data, res = world
    h, ref = res[0][("glm", case, True)], _jax_run(case, data)
    _assert_gate(h.gaps, ref.gaps)
    assert list(h.up_bits) == list(map(float, ref.up_bits))
    assert list(h.down_bits) == list(map(float, ref.down_bits))
    for leg, stream in (ref.legs or {}).items():
        assert list(h.legs[leg]) == list(map(float, stream)), leg


@pytest.mark.parametrize("case", sorted(worker.GLM_CASES))
def test_inexact_is_in_the_references_envelope(world, case):
    _, res = world
    ex, ap = res[0][("glm", case, True)], res[0][("glm", case, False)]
    np.testing.assert_allclose(ap.gaps, ex.gaps, rtol=ENV_RTOL, atol=ENV_ATOL)
    np.testing.assert_allclose(ap.up_bits, ex.up_bits, rtol=BITS_RTOL)
    np.testing.assert_allclose(ap.down_bits, ex.down_bits, rtol=BITS_RTOL)


# --------------------------------------------------------------------------
# BL-DNN
# --------------------------------------------------------------------------
def test_bldnn_exact_is_bitwise_the_one_process_port(world):
    _, res = world
    assert _hist_equal(res[0][("dnn", True)], worker.run_dnn(backend="fast"))


def test_bldnn_inexact_reads_kernel_2s_local_sums(world):
    _, res = world
    ex, ap, wrong = res[0][("dnn", True)], res[0][("dnn", False)], res[0]["dnn_wrong_sums"]
    # the rounds-0–3 gate of the fig-dnn cells, bits exact
    np.testing.assert_allclose(ap.metrics["loss"], ex.metrics["loss"], rtol=1e-4)
    assert ap.gaps == ex.gaps and ap.up_bits == ex.up_bits and ap.legs == ex.legs
    # doubled local sums move the preconditioner, so the run reads them
    assert not np.allclose(wrong.metrics["loss"][1:], ap.metrics["loss"][1:], rtol=1e-7)
    assert res[0]["presummed"]["wrong_moves"]
    assert res[0]["presummed"]["right_err"] < 1e-6


# --------------------------------------------------------------------------
# the reducer and the fleet-wide draws
# --------------------------------------------------------------------------
def test_reduce_tree_packing_is_bitwise_per_leaf_and_once_is_the_plain_call(world):
    _, res = world
    for r in range(W):
        chk = res[r]["reducer"]
        assert all(chk["packed_vs_leafwise"]) and all(chk["packed_vs_one_rank"]), r
        assert all(chk["once"]), r


def test_draws_are_cut_from_the_fleet_wide_draw(world, probs, monkeypatch):
    _, res = world
    for r in range(W):
        chk = res[r]["reducer"]
        assert all(chk["participation"]) and chk["xi_mask"] and chk["client_keys"], r
    seen = []
    monkeypatch.setattr(specs, "note_uploads", lambda R, mask: seen.append(mask.clone()))
    worker.run_glm("bag", probs["n8"], backend="fast")
    full = [m.tolist() for m in seen]
    for r in range(W):   # n = 8 over 4 ranks: 2 clients a rank
        assert res[r]["bag_send"] == [f[2 * r:2 * r + 2] for f in full], r


# --------------------------------------------------------------------------
# cohort+sharded
# --------------------------------------------------------------------------
def test_cohort_smoke_sharded_is_the_one_rank_run_and_the_files(world):
    _, res = world
    exp = registry.get_experiment("cohort-smoke")
    prob = engine.build_problem(exp.problem, "cpu")
    one = engine.run_cell(exp, exp.cell("BL2"), prob, device="cpu")
    h = res[0]["smoke_cell"]
    assert _hist_equal(h, one) and h.uploads == one.uploads
    run = json.loads(problems.COHORT_REFERENCE.read_text())["experiments"]["cohort-smoke"]
    _assert_gate(h.gaps, run["runs"]["BL2"]["gaps"])
    assert (h.up_bits, h.down_bits, h.legs) == (
        run["runs"]["BL2"]["up_bits"], run["runs"]["BL2"]["down_bits"],
        run["runs"]["BL2"]["legs"])
    assert h.uploads == run["runs"]["BL2"]["participants"]


def test_cohort_stores_stay_equal_on_every_rank_epoch_by_epoch(world):
    _, res = world
    one = worker.cohort_runs(sharded=False)
    got = res[0]["smoke_epochs"]
    assert got["store_sha"] == one["store_sha"]
    assert (got["eval_x"], got["hess_up"], got["uploads"]) == (
        one["eval_x"], one["hess_up"], one["uploads"])


def test_padded_cohort_matches_the_one_rank_run(world):
    """6 clients in 8 slots: the padded slots never reduce; the sums run
    over 8 rows where one rank sums 6, so the iterates are held to 1e-12."""
    _, res = world
    one = worker.cohort_runs(cohort_size=6, sharded=False)
    got = res[0]["smoke_padded"]
    assert got["uploads"] == one["uploads"] and got["hess_up"] == one["hess_up"]
    np.testing.assert_allclose(got["eval_x"], one["eval_x"], rtol=1e-12, atol=1e-14)


# --------------------------------------------------------------------------
# serve checkpoints across world sizes, and a killed rank
# --------------------------------------------------------------------------
def test_serve_checkpoints_resume_across_world_sizes(world, tmp_path):
    data, res = world
    whole = _serve(tmp_path / "whole", 30)
    # written at 4 ranks (12 rounds), resumed at 1
    resumed = _serve(data / "s_w", 30)
    assert resumed["meta"]["resumed_from"] == 12
    assert _strip(resumed) == _strip(whole)
    # written at 1 rank (12 rounds), resumed at 4
    assert res[0]["serve_1_to_w"]["meta"]["resumed_from"] == 12
    assert _strip(res[0]["serve_1_to_w"]) == _strip(whole)
    assert _strip(json.loads((data / "s_1.json").read_text())) == \
        _strip(json.loads(json.dumps(whole)))
    # and the history is the JAX package's serve of this cell
    ref = json.loads((REPO / "src/repro_torch/exp/data/fed_serve_ref.json").read_text())
    ref = ref["cases"]["fig4/BL2_tau_half"]["record"]["history"]
    _assert_gate(whole["history"]["gaps"], ref["gaps"])
    for key in ("up_bits", "down_bits", "legs", "events"):
        assert whole["history"][key] == ref[key], key


def test_cohort_serve_checkpoint_resumes_on_one_rank(world, tmp_path):
    data, _ = world
    kw = dict(exp_name="cohort-smoke", cell_name="BL2", chunk=3, backend="cohort+sharded",
              **QUIET)
    whole = fed_serve.serve(max_rounds=12, ckpt_dir=str(tmp_path / "whole"), **kw)
    resumed = fed_serve.serve(max_rounds=12, ckpt_dir=str(data / "s_cohort"), **kw)
    assert resumed["meta"]["resumed_from"] == 6
    assert _strip(resumed) == _strip(whole)


def test_a_killed_rank_ends_the_serve_with_nonzero_exits(tmp_path):
    """Rank 1 of 2 SIGKILLs itself after round 6; rank 0 must leave its next
    collective with an error, not hang, and neither exit 0."""
    port = _free_port()
    args = [sys.executable, "-m", "repro_torch.launch.fed_serve", *SERVE_ARGS,
            "--max-rounds", "30", "--backend", "fast+sharded", "--device", "cpu",
            "--ckpt-dir", str(tmp_path / "ck")]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(args + (["--crash-after-round", "6"] if r == 1 else []),
                              env=_rank_env(r, 2, port), stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=120)[0] for p in procs]
    assert procs[1].returncode == -9, logs[1][-2000:]
    assert procs[0].returncode not in (0, None), logs[0][-2000:]
    assert time.perf_counter() - t0 < 110
