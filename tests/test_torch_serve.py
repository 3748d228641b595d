"""The service loop (`repro_torch.launch.fed_serve`) and its checkpoints
(`repro_torch.exp.artifacts`, ``repro.exp/ckpt@2``) on the CPU, against the
JAX package in-process and the reference file
`src/repro_torch/exp/data/fed_serve_ref.json` (`tools/serve_reference.py`),
mirroring `tests/test_serve.py` and `tests/test_cohort.py`'s serve tests.

  * checkpoints: round trip; torn, corrupt, foreign-digest and ckpt@1
    checkpoints walked past; pruning; the reference's manifest and payload
    layout (each package loads the other's); `tools/schema_diff.py --ckpt`
    accepts a directory the port's serve wrote;
  * `rounds.carry_leaves`: the reference's leaf order, shapes and dtypes for
    every serve method's carry;
  * the file's serves (fig4's BL2 and BL3 under faults, fig1-bag's BAG
    under outages, extended from 8 to 24 rounds) run in-process equal the
    reference's records without ``meta``: config digests equal, events and
    bits exact, gaps within 1e-8·|ref| + 1e-12; fig1r1/BL1 served in
    chunks equals its committed artifact;
  * a checkpoint the JAX loop writes at round 12 resumes in the port and
    ends equal to the reference's uninterrupted record; one held in a data
    basis must name that basis (`fed_serve.basis_fingerprint`): without it
    the port refuses it, with it the port maps the coefficients into its
    own basis; a port checkpoint from a sign-flipped basis resumes bit for
    bit, one from another basis is refused;
  * every serve method's carry stays contiguous from round to round;
  * kill -9 through ``python -m repro_torch.launch.fed_serve --device cpu``
    (fig4 and cohort-smoke) and a restart end equal to an uninterrupted
    serve, ``meta`` aside;
  * `MetricsSink` overwrites a torn tail and a resume emits no round twice;
  * the refusals: faults on bl1 ("synchronous"), a fault plan or a stacked
    backend on a cohort cell, the reference backend; ``--progcache-dir``
    serving with its cache where it says (item 16, ported); and
    ``cohort+sharded`` served on a one-rank world.
"""
import contextlib
import io
import json
import os
import pathlib
import signal
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

from repro.core import batched as jbatched
from repro.core import client_batch as jcb
from repro.core import compressors as jcomp
from repro.core import glm as jglm
from repro.core import rounds as jrounds
from repro.core.basis import make_bases as jmake_bases
from repro.exp import artifacts as jartifacts
from repro.launch import fed_serve as jfed_serve
from repro_torch.core import batched, compressors, faults, rounds
from repro_torch.core.convert import problem_from_numpy
from repro_torch.exp import artifacts, problems
from repro_torch.launch import fed_serve

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_FILE = REPO / "src" / "repro_torch" / "exp" / "data" / "fed_serve_ref.json"
GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
QUIET = dict(log=lambda *a: None)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def ref_file() -> dict:
    return json.loads(REF_FILE.read_text())


def _strip(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "meta"}


def assert_record_matches(rec: dict, ref: dict):
    """Records without ``meta``: gaps within the GLM gate, everything else
    (config, digest, bits, events, counts) exactly equal."""
    rec, ref = _strip(rec), _strip(ref)
    g, gr = np.asarray(rec["history"]["gaps"]), np.asarray(ref["history"]["gaps"])
    assert g.shape == gr.shape and np.all(np.isfinite(g))
    bad = ~(np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL)
    assert not bad.any(), (np.nonzero(bad)[0], g, gr)
    for key in ("up_bits", "down_bits", "legs", "events"):
        assert rec["history"][key] == ref["history"][key], key
    assert {k: v for k, v in rec.items() if k != "history"} == \
        {k: v for k, v in ref.items() if k != "history"}


def _main(argv, ckpt, result):
    with contextlib.redirect_stdout(io.StringIO()):
        fed_serve.main([*argv, "--ckpt-dir", str(ckpt), "--result", str(result),
                        "--device", "cpu"])
    return json.loads(pathlib.Path(result).read_text())


@pytest.fixture(scope="module")
def served(ref_file, tmp_path_factory):
    """The file's cases served in-process by the port, each in the same
    checkpoint directory arrangement the reference used."""
    tmp = tmp_path_factory.mktemp("served")
    out = {}
    for name, case in ref_file["cases"].items():
        ckpt = tmp / ("bag" if name.startswith("fig1-bag") else name.replace("/", "_"))
        out[name] = _main(case["args"], ckpt, tmp / (name.replace("/", "_") + ".json"))
    return out


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
def _save(mod, d, t, digest="d1", keep=10, **kw):
    return mod.save_checkpoint(
        str(d), t=t, carry_leaves=[np.arange(3.0) + t, np.array(t % 2 == 0)],
        streams={"eval_x": np.zeros((t, 2)), "events": np.arange(t, dtype=np.int32)},
        root_key=np.array([0, 7], np.uint32), config_digest=digest, keep=keep, **kw)


def test_checkpoint_roundtrip(tmp_path):
    host = {"store/z": np.ones((4, 2)), "frozen/H": np.eye(2)}
    _save(artifacts, tmp_path, 6, host_state=host)
    ck = artifacts.load_checkpoint(str(tmp_path), config_digest="d1")
    assert ck["t"] == 6 and ck["manifest"]["schema"] == artifacts.CKPT_SCHEMA == \
        jartifacts.CKPT_SCHEMA
    np.testing.assert_array_equal(ck["carry_leaves"][0], np.arange(3.0) + 6)
    assert ck["carry_leaves"][1].dtype == bool and ck["carry_leaves"][1].shape == ()
    np.testing.assert_array_equal(ck["streams"]["events"], np.arange(6, dtype=np.int32))
    np.testing.assert_array_equal(ck["root_key"], np.array([0, 7], np.uint32))
    assert sorted(ck["host_state"]) == ["frozen/H", "store/z"]
    np.testing.assert_array_equal(ck["host_state"]["store/z"], np.ones((4, 2)))


def test_load_checkpoint_skips_corrupt_foreign_and_old_schema(tmp_path):
    for t in (5, 10, 15, 20):
        _save(artifacts, tmp_path, t)
    base = tmp_path / "ckpt-00000020"
    with open(f"{base}.npz", "r+b") as f:              # torn payload
        f.truncate(os.path.getsize(f"{base}.npz") // 2)
    man = json.loads((tmp_path / "ckpt-00000015.json").read_text())
    man["schema"] = "repro.exp/ckpt@1"                 # an older run's checkpoint
    (tmp_path / "ckpt-00000015.json").write_text(json.dumps(man))
    (tmp_path / "ckpt-00000010.json").write_text('{"schema": "repro.exp/ck')   # torn manifest
    ck = artifacts.load_checkpoint(str(tmp_path), config_digest="d1")
    assert ck is not None and ck["t"] == 5
    np.testing.assert_array_equal(ck["carry_leaves"][0], np.arange(3.0) + 5)
    (tmp_path / "ckpt-00000005.npz").write_bytes(b"garbage")          # sha256 mismatch
    assert artifacts.load_checkpoint(str(tmp_path), config_digest="d1") is None
    _save(artifacts, tmp_path, 30)
    assert artifacts.load_checkpoint(str(tmp_path), config_digest="other") is None
    assert artifacts.load_checkpoint(str(tmp_path / "void")) is None


def test_checkpoint_pruning(tmp_path):
    for t in (1, 2, 3, 4):
        _save(artifacts, tmp_path, t, digest="d", keep=2)
    assert [t for t, _ in artifacts.list_checkpoints(str(tmp_path))] == [3, 4]
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "ckpt-00000003.json", "ckpt-00000003.npz", "ckpt-00000004.json", "ckpt-00000004.npz"]


def test_checkpoint_layout_is_the_references(tmp_path):
    """Same inputs, same manifest (the payload's sha256 aside: the zip
    entries carry their write time) and the same npz entries; each
    package loads the other's checkpoint."""
    host = {"totals/H": np.arange(4.0)}
    _save(artifacts, tmp_path / "port", 3, host_state=host)
    _save(jartifacts, tmp_path / "jax", 3, host_state=host)
    mans = [json.loads((tmp_path / w / "ckpt-00000003.json").read_text())
            for w in ("port", "jax")]
    for m in mans:
        m.pop("payload_sha256")
    assert mans[0] == mans[1]
    with np.load(tmp_path / "port" / "ckpt-00000003.npz") as a, \
            np.load(tmp_path / "jax" / "ckpt-00000003.npz") as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    for mod, other in ((artifacts, "jax"), (jartifacts, "port")):
        ck = mod.load_checkpoint(str(tmp_path / other), config_digest="d1")
        assert ck is not None and ck["t"] == 3 and sorted(ck["host_state"]) == ["totals/H"]


def test_schema_diff_accepts_a_port_serve_directory(tmp_path):
    fed_serve.serve(exp_name="fig1r1", cell_name="BL1", chunk=2, max_rounds=4,
                    ckpt_dir=str(tmp_path), device="cpu", **QUIET)
    r = subprocess.run([sys.executable, str(REPO / "tools" / "schema_diff.py"), "--ckpt",
                        str(tmp_path)], capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "ckpt schema ok: 2 checkpoint(s)" in r.stdout


# --------------------------------------------------------------------------
# the carry's leaf order
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    clients = jglm.make_synthetic(seed=0, n_clients=6, m=24, d=18, r=6, lam=1e-3)
    x0 = np.zeros(18)
    x_star = np.asarray(jglm.newton_solve(clients, jax.numpy.asarray(x0), 20))
    jbases = jmake_bases("data_outer", clients)
    jbb = jcb.stack_bases(jbases)
    port = problem_from_numpy(
        np.stack([np.asarray(c.A) for c in clients]),
        np.stack([np.asarray(c.b) for c in clients]), 1e-3, np.asarray(jbb.V), jbb.rs,
        x0, x_star, device="cpu")
    return clients, jbases, port


def _setups(small, method):
    """(JAX setup, port setup) of one serve method on the small problem."""
    clients, jbases, port = small
    n = len(clients)
    jtk, ttk = jcomp.TopK(k=6), compressors.TopK(k=6)
    if method == "bl1":
        js = jbatched.bl1_setup(clients, jbases, [jtk] * n, jcomp.Identity())
        ts = batched.bl1_setup(port.clients, port.bases, [ttk] * n, compressors.Identity())
    elif method == "bl2":
        js = jbatched.bl2_setup(clients, jbases, [jtk] * n, [jcomp.Identity()] * n, tau=3)
        ts = batched.bl2_setup(port.clients, port.bases, [ttk] * n,
                               [compressors.Identity()] * n, tau=3)
    elif method == "bl3":
        js = jbatched.bl3_setup(clients, [jcomp.TopK(k=18)] * n, [jcomp.Identity()] * n, tau=3)
        ts = batched.bl3_setup(port.clients, [compressors.TopK(k=18)] * n,
                               [compressors.Identity()] * n, tau=3)
    else:
        js = jbatched.fednl_bag_setup(clients, jbases, [jtk] * n)
        ts = batched.fednl_bag_setup(port.clients, port.bases, [ttk] * n)
    return js, ts


@pytest.mark.parametrize("method", ["bl1", "bl2", "bl3", "fednl_bag"])
def test_carry_leaves_are_the_references_flattening(small, method):
    _, _, port = small
    js, ts = _setups(small, method)
    jleaves = jax.tree_util.tree_leaves(
        jrounds.init_serve_carry(*js, jax.numpy.zeros(18, jax.numpy.float64)))
    carry = rounds.init_serve_carry(*ts, port.x0)
    leaves = rounds.carry_leaves(carry)
    assert [(tuple(x.shape), fed_serve._numpy_dtype(x)) for x in leaves] == \
        [(tuple(np.shape(x)), np.asarray(x).dtype) for x in jleaves]
    for a, b in zip(leaves, jleaves):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-12, atol=1e-12)
    back = rounds.carry_from_leaves(carry, [x.clone() for x in leaves])
    assert all(torch.equal(a, b) for a, b in zip(rounds.carry_leaves(back), leaves))


@pytest.mark.parametrize("method", ["bl1", "bl2", "bl3", "fednl_bag"])
def test_carry_leaves_stay_contiguous_round_to_round(small, method):
    """A restored carry is contiguous; the live one must be too after every
    round, or a reduction over a leaf may sum in another order once the
    run has been resumed.  The coefficient element `fed_serve` rebases is
    the spec's ``L``."""
    _, _, port = small
    spec, batch, basisb = _setups(small, method)[1]
    if method in fed_serve._COEFF_ELEM and spec.carry_names:
        assert spec.carry_names.index("L") == fed_serve._COEFF_ELEM[method]
    carry = rounds.init_serve_carry(spec, batch, basisb, port.x0)
    key = torch.tensor([0, 5], dtype=torch.int64)
    avail = np.ones((1, batch.n), bool)
    avail[0, 1] = False
    for t in range(4):
        carry, _ = rounds.run_chunk(spec, batch, basisb, port.x0, carry, t, 1, key,
                                    avail=avail if spec.supports_faults else None)
        bad = [i for i, x in enumerate(rounds.carry_leaves(carry)) if not x.is_contiguous()]
        assert not bad, (t, bad)


def test_restore_carry_refuses_a_mismatched_checkpoint(small):
    _, _, port = small
    spec, batch, basisb = batched.bl2_setup(port.clients, port.bases,
                                            [compressors.TopK(k=6)] * 6,
                                            [compressors.Identity()] * 6, tau=3)
    template = rounds.init_serve_carry(spec, batch, basisb, port.x0)
    leaves = [x.numpy() for x in rounds.carry_leaves(template)]
    with pytest.raises(SystemExit, match="carry has 3 leaves"):
        fed_serve._restore_carry({"carry_leaves": leaves[:3]}, template)
    bad = list(leaves)
    bad[2] = bad[2].astype(np.float32)
    with pytest.raises(SystemExit, match="leaf 2 is float32"):
        fed_serve._restore_carry({"carry_leaves": bad}, template)


# --------------------------------------------------------------------------
# serves against the reference's records
# --------------------------------------------------------------------------
def _main_kwargs(mod, argv, monkeypatch, n):
    """What ``mod.main(argv)`` hands `serve` (its parsed flags and fault
    plan), with `serve` and the problem build stubbed out."""
    got = {}
    monkeypatch.setattr(mod, "serve", lambda **kw: got.update(kw))
    monkeypatch.setattr(mod, "build_problem", lambda spec, **kw: types.SimpleNamespace(n=n))
    mod.main(argv)
    return got


def test_serve_config_digests_equal_the_references(ref_file, monkeypatch):
    for name, case in ref_file["cases"].items():
        want = case["record"]["config"]
        cfgs = []
        for mod, extra in ((fed_serve, ["--device", "cpu"]), (jfed_serve, [])):
            kw = _main_kwargs(mod, [*case["args"], *extra], monkeypatch, want["faults"]["n"])
            exp = mod.get_experiment(kw["exp_name"])
            cfgs.append(json.loads(json.dumps(mod.serve_config(
                exp, exp.cell(kw["cell_name"]), kw["seed"], want["backend"], kw["plan"]))))
        assert cfgs[0] == cfgs[1] == want, name
        assert artifacts.config_digest(cfgs[0]) == case["record"]["config_digest"]


@pytest.mark.parametrize("name", ["fig4/BL2_tau_half", "fig4/BL3_tau_half",
                                  "fig1-bag/BAG_q0.5@8", "fig1-bag/BAG_q0.5@24"])
def test_inprocess_serve_matches_the_reference_file(served, ref_file, name):
    rec = served[name]
    assert_record_matches(rec, ref_file["cases"][name]["record"])
    assert rec["meta"]["resumed_from"] == ref_file["cases"][name]["resumed_from"]
    # the default program cache, beside the checkpoints: a fresh serve
    # misses its init and chunk programs, a resumed one hits them
    pc = rec["meta"]["progcache"]
    assert os.path.basename(pc["dir"]) == "progcache"
    resumed = ref_file["cases"][name]["resumed_from"] is not None
    assert pc["stats"] == ({"hit": 2} if resumed else {"miss": 2, "absent": 2})


def test_bag_outages_degrade_the_window_only(served):
    ev = served["fig1-bag/BAG_q0.5@8"]["history"]["events"]
    assert ev[:2] == [0, 0] and ev[6:] == [0, 0]
    assert all(e & rounds.EVENT_DEGRADED for e in ev[2:6])


def test_fig1r1_bl1_served_in_chunks_equals_its_artifact(tmp_path):
    cell = problems.FIG1R1
    art = json.loads(cell.artifact.read_text())
    rec = fed_serve.serve(exp_name="fig1r1", cell_name="BL1", chunk=5,
                          max_rounds=cell.steps, ckpt_dir=str(tmp_path), device="cpu", **QUIET)
    g, gr = np.asarray(rec["history"]["gaps"]), np.asarray(art["history"]["gaps"])
    assert np.all(np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL)
    for key in ("up_bits", "down_bits", "legs"):
        assert rec["history"][key] == art["history"][key], key
    assert rec["history"]["events"] == [0] * cell.steps


def _jax_serve(argv, ckpt):
    with jax.threefry_partitionable(False), contextlib.redirect_stdout(io.StringIO()):
        jfed_serve.main([*argv, "--ckpt-dir", str(ckpt), "--no-progcache"])


@pytest.mark.parametrize("name,stop", [("fig4/BL3_tau_half", "12"),
                                       ("fig1-bag/BAG_q0.5@24", "8")])
def test_jax_checkpoint_resumes_in_the_port(ref_file, tmp_path, name, stop):
    """The JAX loop serves a cell part way and stops; the port resumes its
    ckpt@2 directory and ends equal to the reference's uninterrupted
    record.  These carries hold nothing in a computed basis (BL3's PSD
    coefficients, BAG's standard basis)."""
    case = ref_file["cases"][name]
    argv = list(case["args"])
    total = argv[argv.index("--max-rounds") + 1]
    argv[argv.index("--max-rounds") + 1] = stop
    _jax_serve(argv, tmp_path)
    assert max(t for t, _ in artifacts.list_checkpoints(str(tmp_path))) == int(stop)
    rec = _main(case["args"], tmp_path, tmp_path / "res.json")
    assert rec["meta"]["resumed_from"] == int(stop) and rec["rounds"] == int(total)
    assert_record_matches(rec, case["record"])


def test_jax_data_basis_checkpoint_resumes_once_it_names_its_basis(ref_file, tmp_path):
    """fig4/BL2_tau_half keeps its Hessian coefficients L in each client's
    data basis, which each package computes by its own SVD: the port's and
    jaxlib's LAPACK disagree in the signs of some singular vectors.  The
    JAX checkpoint at round 12 names no basis, so the port refuses it;
    given the fingerprint of the basis JAX computed, the port maps L into
    its own basis and ends equal to the reference's uninterrupted record."""
    from repro.exp import engine as jengine

    case = ref_file["cases"]["fig4/BL2_tau_half"]
    argv = [a if a != "30" else "12" for a in case["args"]]
    _jax_serve(argv, tmp_path)
    digest = case["record"]["config_digest"]
    ck = artifacts.load_checkpoint(str(tmp_path), config_digest=digest)
    assert ck is not None and ck["t"] == 12 and ck["host_state"] == {}
    with pytest.raises(SystemExit, match="does not say which"):
        _main(case["args"], tmp_path, tmp_path / "res.json")
    exp = problems.FIG4["BL2_tau_half"].exp
    port_bases = fed_serve.build_problem(exp.problem, device="cpu").bases("data_outer")
    jax_bases = jengine.build_problem(exp.problem).bases("data_outer")
    signs = np.stack([np.sign(np.diag(pb.V.numpy().T @ np.asarray(jb.V)))
                      for pb, jb in zip(port_bases, jax_bases)])          # (n, r)
    assert np.all(np.abs(signs) == 1) and np.any(signs < 0)                # the map is needed
    jV = types.SimpleNamespace(V=np.asarray(jcb.stack_bases(jax_bases).V))
    artifacts.save_checkpoint(str(tmp_path), t=12, carry_leaves=ck["carry_leaves"],
                              streams=ck["streams"], root_key=ck["root_key"],
                              config_digest=digest, host_state=fed_serve.basis_fingerprint(jV))
    rec = _main(case["args"], tmp_path, tmp_path / "res.json")
    assert rec["meta"]["resumed_from"] == 12
    assert_record_matches(rec, case["record"])


def _flip_basis(tmp_path, digest, signs, scale=1.0):
    """Rewrite the newest checkpoint as if its writer's basis had columns
    ``signs`` times this run's (its L and its fingerprint flipped
    together), the fingerprint's pivots scaled by ``scale``."""
    ck = artifacts.load_checkpoint(str(tmp_path), config_digest=digest)
    hs = dict(ck["host_state"])
    assert sorted(hs) == ["basis/pivot_row", "basis/pivot_val"]
    leaves = list(ck["carry_leaves"])
    r = signs.shape[1]
    L = leaves[2].copy()
    L[:, :r, :r] = signs[:, :, None] * L[:, :r, :r] * signs[:, None, :]
    leaves[2] = L
    hs["basis/pivot_val"] = hs["basis/pivot_val"] * signs * scale
    artifacts.save_checkpoint(str(tmp_path), t=int(ck["t"]), carry_leaves=leaves,
                              streams=ck["streams"], root_key=ck["root_key"],
                              config_digest=digest, host_state=hs)
    return ck


def test_a_checkpoint_from_a_sign_flipped_basis_resumes_bit_for_bit(served, ref_file,
                                                                     tmp_path):
    """A port checkpoint whose SVD came out with other column signs (the
    CPU's against the card's): the resume maps its coefficients back
    exactly and ends equal to the uninterrupted serve, bit for bit."""
    case = ref_file["cases"]["fig4/BL2_tau_half"]
    _main([a if a != "30" else "12" for a in case["args"]], tmp_path, tmp_path / "12.json")
    digest = case["record"]["config_digest"]
    hs = artifacts.load_checkpoint(str(tmp_path), config_digest=digest)["host_state"]
    signs = np.where(np.random.default_rng(0).random(hs["basis/pivot_val"].shape) < 0.5,
                     -1.0, 1.0)
    assert (signs < 0).any() and (signs > 0).any()
    _flip_basis(tmp_path, digest, signs)
    rec = _main(case["args"], tmp_path, tmp_path / "res.json")
    assert rec["meta"]["resumed_from"] == 12
    assert _strip(rec) == _strip(served["fig4/BL2_tau_half"])


def test_a_checkpoint_from_another_basis_is_refused(ref_file, tmp_path):
    case = ref_file["cases"]["fig4/BL2_tau_half"]
    _main([a if a != "30" else "6" for a in case["args"]], tmp_path, tmp_path / "6.json")
    digest = case["record"]["config_digest"]
    hs = artifacts.load_checkpoint(str(tmp_path), config_digest=digest)["host_state"]
    _flip_basis(tmp_path, digest, np.ones(hs["basis/pivot_val"].shape), scale=0.9)
    with pytest.raises(SystemExit, match="more than column signs"):
        _main(case["args"], tmp_path, tmp_path / "res.json")


# --------------------------------------------------------------------------
# kill -9 through the CLI
# --------------------------------------------------------------------------
_ENV = {"PYTHONPATH": str(REPO / "src"), "PATH": os.environ.get("PATH", "/usr/bin:/bin"),
        "HOME": os.environ.get("HOME", "/tmp"), "OMP_NUM_THREADS": "1"}


def _cli(argv, ckpt, *extra):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.fed_serve", *argv, "--ckpt-dir", str(ckpt),
         "--device", "cpu", *extra],
        env=_ENV, capture_output=True, text=True, timeout=600, cwd=REPO)


@pytest.mark.parametrize("case", ["fig4", "cohort-smoke"])
def test_kill9_and_restart_equal_an_uninterrupted_serve(case, served, ref_file, tmp_path):
    if case == "fig4":
        argv, crash_after, total = ref_file["cases"]["fig4/BL2_tau_half"]["args"], 14, 30
        want = served["fig4/BL2_tau_half"]
    else:
        argv = ["--exp", "cohort-smoke", "--cell", "BL2", "--seed", "2", "--max-rounds", "12",
                "--chunk", "3"]
        crash_after, total = 5, 12
        want = _main(argv, tmp_path / "ref", tmp_path / "ref.json")
    r = _cli(argv, tmp_path / "crash", "--crash-after-round", str(crash_after))
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-1000:])
    ts = [t for t, _ in artifacts.list_checkpoints(str(tmp_path / "crash"))]
    assert ts and max(ts) < total          # the kill cost progress
    res = tmp_path / "res.json"
    r = _cli(argv, tmp_path / "crash", "--result", str(res))
    assert r.returncode == 0, r.stdout + r.stderr[-2000:]
    assert "resumed from checkpoint" in r.stdout
    got = json.loads(res.read_text())
    assert got["meta"]["resumed_from"] == max(ts)
    assert _strip(got) == _strip(want)     # bit-exact: gaps, events, every ledger leg


# --------------------------------------------------------------------------
# metrics sink
# --------------------------------------------------------------------------
def test_metrics_sink_overwrites_a_torn_tail_and_never_repeats_a_round(tmp_path):
    path = tmp_path / "m.jsonl"
    kw = dict(exp_name="fig4", cell_name="BL2_tau_half", seed=3, chunk=4,
              ckpt_dir=str(tmp_path / "ck"), metrics_out=str(path), device="cpu", **QUIET)
    fed_serve.serve(max_rounds=8, **kw)
    with open(path, "a") as f:
        f.write('{"round": 8, "gap": 0.1')            # a killed writer's torn line
    rec = fed_serve.serve(max_rounds=12, **kw)
    lines = path.read_text().splitlines()
    rows = [json.loads(line) for line in lines]       # the torn line is gone
    assert [r["round"] for r in rows] == list(range(12))
    assert [r["events"] for r in rows] == rec["history"]["events"]
    for r in rows:
        assert r["gap"] == pytest.approx(rec["history"]["gaps"][r["round"]], rel=1e-12,
                                         abs=1e-15)
        assert r["legs"] == {leg: rec["history"]["legs"][leg][r["round"]]
                             for leg in artifacts.LEG_NAMES}
    sink = fed_serve.MetricsSink(str(path))
    assert sink.last_round == 11
    sink.emit_chunk([10, 11], [0.0, 0.0], [0, 0], {"hess_up": [0.0, 0.0]})
    assert path.read_text().splitlines() == lines


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------
def test_refusals(tmp_path):
    d = str(tmp_path)
    with pytest.raises(SystemExit, match="synchronous"):
        fed_serve.serve(exp_name="fig1r1", cell_name="BL1", ckpt_dir=d, max_rounds=2,
                        plan=faults.FaultPlan(n=10, dropout_p=0.5), device="cpu", **QUIET)
    with pytest.raises(SystemExit, match="fault"):
        fed_serve.serve(exp_name="cohort-smoke", cell_name="BL2", ckpt_dir=d, max_rounds=2,
                        plan=faults.FaultPlan(n=96, dropout_p=0.5), device="cpu", **QUIET)
    with pytest.raises(SystemExit, match="cohort"):
        fed_serve.serve(exp_name="cohort-smoke", cell_name="BL2", ckpt_dir=d, max_rounds=2,
                        backend="fast", device="cpu", **QUIET)
    with pytest.raises(SystemExit, match="the reference backend has no checkpointable"):
        fed_serve.serve(exp_name="fig4", cell_name="BL2_tau_half", ckpt_dir=d, max_rounds=2,
                        backend="reference", device="cpu", **QUIET)
    assert artifacts.list_checkpoints(d) == []
    # the program cache (ROADMAP.md §1 item 16) is ported: --progcache-dir
    # serves, its entries where it says, the record that of --no-progcache
    pc = tmp_path / "pc"
    cached = fed_serve.serve(exp_name="fig4", cell_name="BL2_tau_half",
                             ckpt_dir=str(tmp_path / "c1"), max_rounds=2, progcache_dir=str(pc),
                             device="cpu", **QUIET)
    plain = fed_serve.serve(exp_name="fig4", cell_name="BL2_tau_half",
                            ckpt_dir=str(tmp_path / "c2"), max_rounds=2, no_progcache=True,
                            device="cpu", **QUIET)
    assert cached["meta"]["progcache"]["dir"] == str(pc) and plain["meta"]["progcache"] is None
    assert {k: v for k, v in cached.items() if k != "meta"} == \
        {k: v for k, v in plain.items() if k != "meta"}
    assert sorted(f.name.split("-")[0] for f in pc.glob("*.json")) == ["serve_chunk",
                                                                      "serve_init"]
    assert not (tmp_path / "c1" / "progcache").exists()
    # cohort+sharded (ROADMAP.md §1 item 13) serves, here on a one-rank world
    rec = fed_serve.serve(exp_name="cohort-smoke", cell_name="BL2", ckpt_dir=str(tmp_path / "s"),
                          max_rounds=2, backend="cohort+sharded", device="cpu", **QUIET)
    assert rec["rounds"] == 2 and rec["meta"]["layout"]["ndev"] == 1
    assert len(artifacts.list_checkpoints(str(tmp_path / "s"))) == 1
