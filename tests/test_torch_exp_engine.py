"""The port's sweep engine on the CPU: `run_experiment` for fig1r1 (4 cells,
12 rounds) and fig-dnn's BLDNN cell (40 rounds) against the committed
artifacts, resume, the stream hook, ``"fast+sharded"`` on one rank and
across 4 gloo ranks, and what is not ported yet."""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import rounds
from repro_torch.exp import __main__ as tmain
from repro_torch.exp import artifacts, engine, registry

REPO = pathlib.Path(__file__).resolve().parents[1]
GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
#: BL-DNN: rounds whose loss and error rate are held (training is chaotic
#: at the ulp level), and the loss tolerance there
DNN_HELD_ROUNDS, DNN_LOSS_RTOL = 4, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _quiet(*_):
    pass


def _committed(record: dict) -> dict:
    return json.loads((REPO / "results" / "exp" / record["experiment"]
                       / f"{record['cell']}.seed{record['seed']}.json").read_text())


def _assert_bits(h: dict, ref: dict):
    assert h["up_bits"] == ref["up_bits"] and h["down_bits"] == ref["down_bits"]
    assert h["legs"] == ref["legs"]


def _schema_diff(out: pathlib.Path):
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "schema_diff.py"), str(out),
                           str(REPO / "results")], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_fig1r1_run_experiment_matches_committed_artifacts(tmp_path):
    out = engine.run_experiment(registry.get_experiment("fig1r1"), str(tmp_path),
                                str(tmp_path / "exp"), log=_quiet, device="cpu")
    assert [s["cell"] for s in out] == ["BL1", "FedNL", "NL1", "Newton"]
    assert {s["status"] for s in out} == {"ran"}
    for s in out:
        rec = json.loads(pathlib.Path(s["artifact"]).read_text())
        ref = _committed(rec)
        assert rec["config_digest"] == ref["config_digest"] and rec["config"] == ref["config"]
        g, gr = np.asarray(rec["history"]["gaps"]), np.asarray(ref["history"]["gaps"])
        assert np.all(np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL), (s["cell"], g, gr)
        _assert_bits(rec["history"], ref["history"])
        assert rec["bits_to_tol"] == ref["bits_to_tol"]
        assert sorted(rec) == sorted(ref) and rec["runtime_s"] > 0
        lines = pathlib.Path(s["csv"]).read_text().splitlines()
        assert lines[0] == ",".join(artifacts.CSV_COLUMNS) and len(lines) == 13
    _schema_diff(tmp_path)


def test_fig_dnn_bldnn_run_experiment_matches_committed_artifact(tmp_path):
    out = engine.run_experiment(registry.get_experiment("fig-dnn"), str(tmp_path),
                                str(tmp_path / "exp"), cells=["BLDNN"], log=_quiet,
                                device="cpu")
    assert [(s["cell"], s["status"], s["steps"]) for s in out] == [("BLDNN", "ran", 40)]
    rec = json.loads(pathlib.Path(out[0]["artifact"]).read_text())
    ref = _committed(rec)
    assert rec["config_digest"] == ref["config_digest"]
    _assert_bits(rec["history"], ref["history"])
    h = DNN_HELD_ROUNDS
    loss, lr = (np.asarray(x["history"]["metrics"]["loss"]) for x in (rec, ref))
    assert np.all(np.isfinite(loss)) and loss.shape == lr.shape
    assert np.all(np.abs(loss[:h] - lr[:h]) <= DNN_LOSS_RTOL * np.abs(lr[:h]))
    assert rec["history"]["gaps"][:h] == ref["history"]["gaps"][:h]
    assert rec["bits_to_tol"] == ref["bits_to_tol"]       # reached at round 10, bits exact
    _schema_diff(tmp_path)


def test_resume_is_idempotent(tmp_path):
    exp = registry.get_experiment("fig1r1")
    out, adir = str(tmp_path / "results"), str(tmp_path / "artifacts")
    kw = dict(max_steps=3, log=_quiet, device="cpu")

    first = engine.run_experiment(exp, out, adir, **kw)
    assert all(s["status"] == "ran" for s in first)
    blobs = {s["cell"]: open(s["csv"], "rb").read() for s in first}

    # full re-run: everything cached, CSVs byte-identical
    second = engine.run_experiment(exp, out, adir, **kw)
    assert all(s["status"] == "cached" for s in second)
    for s in second:
        assert open(s["csv"], "rb").read() == blobs[s["cell"]]

    # deleting one cell's JSON re-runs exactly that cell, bitwise
    victim = first[0]
    before = json.loads(pathlib.Path(victim["artifact"]).read_text())
    os.remove(victim["artifact"])
    third = engine.run_experiment(exp, out, adir, **kw)
    statuses = {s["cell"]: s["status"] for s in third}
    assert statuses.pop(victim["cell"]) == "ran"
    assert set(statuses.values()) == {"cached"}
    assert open(victim["csv"], "rb").read() == blobs[victim["cell"]]
    after = json.loads(pathlib.Path(victim["artifact"]).read_text())
    assert {**after, "runtime_s": None} == {**before, "runtime_s": None}

    # a config change (different clamp) invalidates the digest and re-runs
    fourth = engine.run_experiment(exp, out, adir, max_steps=2, log=_quiet, device="cpu")
    assert all(s["status"] == "ran" for s in fourth)


def test_cli_run_on_cpu_then_cached(tmp_path, capsys):
    argv = ["run", "--fig", "fig1r1", "--cell", "BL1", "--cell", "Newton", "--max-steps",
            "2", "--progress-every", "1", "--device", "cpu", "--out", str(tmp_path),
            "--artifacts", str(tmp_path / "exp")]
    assert tmain.main(argv) == 0
    text = capsys.readouterr().out
    assert text.count("[ran]") == 2 and "[fig1r1/BL1] round 1: gap=" in text
    assert "[fig1r1/Newton] round" not in text          # the hook serves BL methods
    assert sorted(p.name for p in (tmp_path / "exp" / "fig1r1").iterdir()) == [
        "BL1.seed0.json", "Newton.seed0.json"]
    assert tmain.main(argv) == 0
    assert capsys.readouterr().out.count("[cached]") == 2


def test_stream_hook_fires_and_preserves_trajectory():
    exp = registry.get_experiment("fig1r1")
    prob = engine.build_problem(exp.problem, "cpu")
    seen = []
    hook = rounds.StreamHook(every=2, callback=lambda t, x, led: seen.append((t, x, led)))
    h1 = engine.run_cell(exp, exp.cell("BL1"), prob, steps=5, stream=hook, device="cpu")
    h0 = engine.run_cell(exp, exp.cell("BL1"), prob, steps=5, device="cpu")
    assert [t for t, *_ in seen] == [0, 2, 4]
    assert h1 == h0
    for t, x, led in seen:
        assert tuple(x.shape) == (prob.d,) and x.dtype == torch.float64
        assert float(led.uplink) == h0.up_bits[t]
        assert float(led.downlink) == h0.down_bits[t]
        assert {leg: float(getattr(led, leg)) for leg in artifacts.LEG_NAMES} == \
            {leg: h0.legs[leg][t] for leg in artifacts.LEG_NAMES}


def _narrow_xl():
    """fig1-xl's experiment on a narrowed fleet (its backend kept)."""
    exp = registry.get_experiment("fig1-xl")
    cell = dataclasses.replace(exp.cells[0], steps=3,
                               hess_comp=registry.CompressorCfg(kind="topk", k=64))
    problem = dataclasses.replace(exp.problem, n_clients=6, m=8, d=24, r=8)
    return dataclasses.replace(exp, problem=problem, cells=(cell,)), cell


def test_fast_sharded_cell_runs_single_device_path_on_one_rank(tmp_path):
    """fig1-xl's backend runs the sharded reducer; one process is a
    one-rank world, the reference's one-device mesh: bitwise "fast"."""
    exp, cell = _narrow_xl()
    assert cell.backend == "fast+sharded" and engine.resolve_backend(cell.backend) == cell.backend
    prob = engine.build_problem(exp.problem, "cpu")
    h = engine.run_cell(exp, cell, prob, device="cpu")
    assert h == engine.run_cell(exp, cell, prob, backend="fast", device="cpu")
    assert np.isfinite(h.gaps).all() and h.up_bits[-1] > 0
    lines = []
    engine.run_experiment(exp, str(tmp_path), str(tmp_path / "exp"), log=lines.append,
                          device="cpu")
    assert ("fig1-xl/BL1: backend fast+sharded on 1 rank(s), 1 holding clients (6 each), "
            "process group none") in lines[0]


_ACROSS_RANKS = """
import dataclasses, json, sys
import torch
from repro_torch.exp import engine, registry
torch.set_num_threads(1)
exp = registry.get_experiment("fig1-xl")
cell = dataclasses.replace(exp.cells[0], steps=3,
                           hess_comp=registry.CompressorCfg(kind="topk", k=64))
exp = dataclasses.replace(exp, problem=dataclasses.replace(exp.problem, n_clients=6, m=8,
                                                           d=24, r=8), cells=(cell,))
h = engine.run_cell(exp, cell, engine.build_problem(exp.problem, "cpu"), device="cpu")
print(json.dumps([h.gaps, h.up_bits, h.down_bits, h.legs]))
"""


def test_fast_sharded_across_ranks_raises_item_13():
    """fig1-xl's "fast+sharded" across 4 ranks (ROADMAP.md §1 item 13 is
    ported): 3 of them hold the 6 clients, one sits out, and every rank
    returns the one-process history bit for bit."""
    import os
    import socket
    import subprocess
    import sys

    exp, cell = _narrow_xl()
    prob = engine.build_problem(exp.problem, "cpu")
    one = engine.run_cell(exp, cell, prob, backend="fast", device="cpu")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = []
    for r in range(4):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
                   MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(r),
                   WORLD_SIZE="4", LOCAL_RANK=str(r), LOCAL_WORLD_SIZE="4")
        procs.append(subprocess.Popen([sys.executable, "-c", _ACROSS_RANKS], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                      text=True))
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err[-3000:]
        assert json.loads(out.splitlines()[-1]) == [one.gaps, one.up_bits, one.down_bits,
                                                     one.legs]


def test_unported_problems_and_backends_raise_naming_their_item():
    smoke = engine.build_problem(registry.get_experiment("cohort-smoke").problem, "cpu")
    assert isinstance(smoke, engine.StreamProblem) and smoke.n == 96
    assert engine.resolve_backend("cohort") == "cohort"
    # the sharded cohort backend (ROADMAP.md §1 item 13) runs as named
    assert engine.resolve_backend("cohort+sharded") == "cohort+sharded"
    # a BL-DNN spec other than the carried fixture's is drawn (it raised
    # ROADMAP.md §1 item 9's remainder until the port drew normals)
    drawn = engine.build_problem(registry.DNNProblemSpec(seed=1), "cpu")
    assert isinstance(drawn, engine.DNNProblem) and drawn.n == 8
    assert tuple(drawn.batch.data["x"].shape) == (8, 64, 96)
    exp = registry.get_experiment("fig1r1")
    with pytest.raises(ValueError, match="routes Γ of bl1 and newton only"):
        engine.run_cell(exp, exp.cell("NL1"), engine.build_problem(exp.problem, "cpu"),
                        steps=1, device="cpu", basis_project="kernel")


def test_build_problem_is_memoized_per_device():
    spec = registry.get_experiment("fig1r1").problem
    assert engine.build_problem(spec, "cpu") is engine.build_problem(spec, torch.device("cpu"))
    dnn = engine.build_problem(registry.get_experiment("fig-dnn").problem, "cpu")
    assert isinstance(dnn, engine.DNNProblem) and dnn.n == 8


def test_entry_points_without_device_raise_when_cuda_is_unavailable(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    exp = registry.get_experiment("fig1r1")
    with pytest.raises(RuntimeError, match="CUDA device"):
        engine.build_problem(exp.problem)
    with pytest.raises(RuntimeError, match="CUDA device"):
        engine.run_experiment(exp, str(tmp_path), str(tmp_path / "exp"), max_steps=1,
                              log=_quiet)
    with pytest.raises(RuntimeError, match="CUDA device"):
        tmain.main(["run", "--fig", "fig1r1", "--max-steps", "1", "--out", str(tmp_path),
                    "--artifacts", str(tmp_path / "exp")])
