"""The port's experiment layer against the JAX package's, with no engine
run: the registry experiment by experiment, the 46 committed config
digests, the metrics, the artifact writers byte for byte, the compressor
builder, `BernoulliLazy`'s draws, the CLI's ``list`` text and its
refusals, and resuming from copies of the committed artifacts."""
import dataclasses
import filecmp
import json
import pathlib
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import compressors as jcomp
from repro.core.bl import History as JHistory
from repro.exp import __main__ as jmain
from repro.exp import artifacts as jart
from repro.exp import engine as jengine
from repro.exp import metrics as jmetrics
from repro.exp import registry as jreg
from repro_torch.core import compressors as tcomp
from repro_torch.core import prng
from repro_torch.core.bl import History
from repro_torch.exp import __main__ as tmain
from repro_torch.exp import artifacts, engine, metrics, registry

REPO = pathlib.Path(__file__).resolve().parents[1]
COMMITTED = sorted((REPO / "results" / "exp").glob("*/*.seed*.json"))
#: the registered experiments with committed artifacts (the two
#: ``synthetic_stream`` ones have none)
WITH_ARTIFACTS = sorted({p.parent.name for p in COMMITTED})


def _json(obj) -> str:
    """Type-strict spelling: ``False`` and ``0``, ``5`` and ``5.0`` differ."""
    return json.dumps(obj, sort_keys=True, default=str)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------
def test_registry_lists_the_references_experiments():
    assert registry.available_experiments() == jreg.available_experiments()
    assert len(registry.available_experiments()) == 14
    assert registry.get_experiment("fig1-xl").cells[0].backend == "fast+sharded"
    assert {c.backend for n in ("fig1-xxl", "cohort-smoke")
            for c in registry.get_experiment(n).cells} == {"cohort"}


@pytest.mark.parametrize("name", jreg.available_experiments())
def test_experiment_equals_reference(name):
    mine, ref = registry.get_experiment(name), jreg.get_experiment(name)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert _json(dataclasses.asdict(mine)) == _json(dataclasses.asdict(ref))
    assert [f.name for f in dataclasses.fields(mine.problem)] == \
        [f.name for f in dataclasses.fields(ref.problem)]


def test_all_46_artifacts_are_registered():
    assert len(COMMITTED) == 46 and len(WITH_ARTIFACTS) == 12


@pytest.mark.parametrize("path", COMMITTED, ids=lambda p: f"{p.parent.name}/{p.stem}")
def test_committed_config_digest_is_reproduced(path):
    art = json.loads(path.read_text())
    exp = registry.get_experiment(art["experiment"])
    config = artifacts.cell_config(exp, exp.cell(art["cell"]), art["seed"],
                                   art["config"]["steps"])
    assert artifacts.config_digest(config) == art["config_digest"]
    assert json.loads(json.dumps(config)) == art["config"]


def test_lookup_errors():
    with pytest.raises(KeyError, match="unknown experiment 'nope'"):
        registry.get_experiment("nope")
    with pytest.raises(KeyError, match="fig1r1 has no cell 'nope'"):
        registry.get_experiment("fig1r1").cell("nope")
    with pytest.raises(ValueError, match="duplicate experiment 'fig1r1'"):
        registry.register_experiment(registry.get_experiment("fig1r1"))
    with pytest.raises(ValueError, match="unknown compressor kind 'zip'"):
        engine.build_compressor(registry.CompressorCfg(kind="zip"), 10)


# --------------------------------------------------------------------------
# metrics and artifacts
# --------------------------------------------------------------------------
@pytest.mark.parametrize("gaps,tol", [
    ([1.0, 1e-3, 1e-9], 1e-6), ([1.0, 1e-3, 1e-9], 1e-12), ([1e-9, 1.0, 1e-9], 1e-6),
    ([float("nan"), 1e-7, 1e-8], 1e-6), ([0.5, 0.05, 0.2], 0.1)])
def test_bits_to_tol_and_best_gap_match_reference(gaps, tol):
    h = History(gaps=gaps, up_bits=[0.0, 1e6, 2e6], down_bits=[0.0] * 3)
    assert metrics.bits_to_tol(h, tol) == jmetrics.bits_to_tol(h, tol)
    np.testing.assert_array_equal(metrics.best_gap_stream(gaps),
                                  jmetrics.best_gap_stream(gaps))


def test_bits_to_tol_reached_flag():
    h = History(gaps=[1.0, 1e-3, 1e-9], up_bits=[0.0, 1e6, 2e6], down_bits=[0.0] * 3)
    hit = metrics.bits_to_tol(h, 1e-6)
    assert hit.reached and hit.mbits == 2.0
    miss = metrics.bits_to_tol(h, 1e-12)
    assert not miss.reached and miss.mbits == float("inf")


def _synthetic(cls, legs: bool, extra: bool):
    rng = np.random.default_rng(7)
    gaps = list(np.abs(rng.standard_normal(6)) * 10.0 ** -np.arange(6))
    up = list(np.cumsum(rng.integers(1, 10**6, 6)).astype(float) / 3)
    down = list(np.cumsum(rng.integers(1, 10**5, 6)).astype(float))
    kw = {}
    if legs:
        kw["legs"] = {leg: list(rng.random(6) * 1e5) for leg in artifacts.LEG_NAMES}
    if extra:
        kw["metrics"] = {"loss": list(rng.random(6))}
    return cls(gaps=gaps, up_bits=up, down_bits=down, **kw)


@pytest.mark.parametrize("legs,extra", [(True, True), (True, False), (False, False)])
def test_records_and_csvs_are_byte_equal_to_reference(tmp_path, legs, extra):
    exp = registry.get_experiment("fig-dnn" if extra else "fig1r1")
    jexp = jreg.get_experiment(exp.name)
    cell, jcell = exp.cells[0], jexp.cells[0]
    rec = artifacts.cell_record(exp, cell, 0, 6, _synthetic(History, legs, extra),
                                runtime_s=1.5)
    jrec = jart.cell_record(jexp, jcell, 0, 6, _synthetic(JHistory, legs, extra),
                            runtime_s=1.5)
    assert rec == jrec and ("metrics" in rec["history"]) == extra
    for writer, record, sub in ((artifacts, rec, "port"), (jart, jrec, "ref")):
        writer.write_json(writer.artifact_path(str(tmp_path / sub), exp.name, cell.name, 0),
                          record)
        writer.write_fig_csv(str(tmp_path / sub), record)
    for rel in (f"{exp.name}/{cell.name}.seed0.json", f"{exp.name}_{cell.name}.csv"):
        assert (tmp_path / "port" / rel).read_bytes() == (tmp_path / "ref" / rel).read_bytes()
    assert artifacts.load_json(str(tmp_path / "port" / "missing.json")) is None
    (tmp_path / "torn.json").write_text('{"schema": ')
    assert artifacts.load_json(str(tmp_path / "torn.json")) is None
    assert (artifacts.SCHEMA, artifacts.CSV_COLUMNS) == (jart.SCHEMA, jart.CSV_COLUMNS)


@pytest.mark.parametrize("name", WITH_ARTIFACTS)
def test_committed_artifacts_resume_as_the_ports_own(tmp_path, name):
    """Every committed artifact is "cached" for the port, and the CSVs
    regenerated from it are the committed ones byte for byte."""
    shutil.copytree(REPO / "results" / "exp" / name, tmp_path / "exp" / name)
    out = engine.run_experiment(registry.get_experiment(name), str(tmp_path),
                                str(tmp_path / "exp"), log=lambda *_: None)
    assert {s["status"] for s in out} == {"cached"}
    assert len(out) == len(registry.get_experiment(name).cells)
    for s in out:
        assert filecmp.cmp(s["csv"], REPO / "results" / pathlib.Path(s["csv"]).name,
                           shallow=False)


# --------------------------------------------------------------------------
# compressors
# --------------------------------------------------------------------------
CFGS = [registry.CompressorCfg(kind="identity"), registry.CompressorCfg(kind="topk", k=24),
        registry.CompressorCfg(kind="topk", k=7200, symmetrize=True),
        registry.CompressorCfg(kind="randk", k=5), registry.CompressorCfg(kind="rankr", r=2),
        registry.CompressorCfg(kind="dither", s=10), registry.CompressorCfg(kind="natural"),
        registry.CompressorCfg(kind="rtopk", k=24), registry.CompressorCfg(kind="ntopk", k=24),
        registry.CompressorCfg(kind="rrankr", r=1), registry.CompressorCfg(kind="nrankr", r=1),
        registry.CompressorCfg(kind="bernoulli", p=0.25)]


@pytest.mark.parametrize("cfg", CFGS, ids=lambda c: f"{c.kind}{'_sym' if c.symmetrize else ''}")
def test_build_compressor_matches_reference(cfg):
    mine = engine.build_compressor(cfg, 120)
    ref = jengine.build_compressor(jreg.CompressorCfg(**dataclasses.asdict(cfg)), 120)
    assert repr(mine) == repr(ref)
    for attr in ("is_unbiased", "omega", "delta", "deterministic"):
        assert getattr(mine, attr) == getattr(ref, attr), attr


@pytest.mark.parametrize("seed,p", [(0, 0.25), (1, 0.5), (5, 0.9)])
def test_bernoulli_lazy_draws_equal_jax(seed, p):
    x = np.random.default_rng(seed).standard_normal((32, 3, 5))
    with jax.threefry_partitionable(False):
        jkeys = jax.random.split(jax.random.PRNGKey(seed), 32)
        ref, rc = jcomp.BernoulliLazy(p=p).compress(jkeys, jnp.asarray(x))
    out, counts = tcomp.BernoulliLazy(p=p).compress(prng.split(prng.PRNGKey(seed), 32),
                                                    torch.tensor(x))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    np.testing.assert_array_equal(counts.floats.numpy(), np.asarray(rc.floats))
    sent = counts.floats.numpy() > 0
    assert sent.any() and not sent.all() and set(counts.floats.tolist()) <= {0.0, 15.0}
    with pytest.raises(ValueError, match="stochastic"):
        tcomp.BernoulliLazy(p=p).compress(None, torch.tensor(x))


# --------------------------------------------------------------------------
# CLI
# --------------------------------------------------------------------------
def test_list_prints_the_references_text(capsys):
    assert jmain.main(["list"]) == 0
    ref = capsys.readouterr().out
    assert tmain.main(["list"]) == 0
    assert capsys.readouterr().out == ref and "fig1-xxl" in ref


def test_cli_refusals(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(REPO)
    for argv in (["run", "--fig", "fig1r1", "--max-steps", "2"],
                 ["run", "--fig", "fig1r1", "--max-steps", "2", "--out", str(tmp_path)],
                 ["run", "--fig", "fig1r1", "--max-steps", "2", "--artifacts",
                  "results/exp/scratch", "--out", str(tmp_path)]):
        assert tmain.main(argv + ["--device", "cpu"]) == 2
        assert "--max-steps truncates histories" in capsys.readouterr().err
    assert tmain.main(["run", "--device", "cpu"]) == 2
    assert "pass --fig" in capsys.readouterr().err
    assert tmain.main(["run", "--fig", "nope", "--device", "cpu"]) == 2
    assert "unknown experiment 'nope'" in capsys.readouterr().err
    assert not (REPO / "results" / "exp" / "scratch").exists()
