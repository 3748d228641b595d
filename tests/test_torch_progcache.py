"""The program cache (`repro_torch.core.progcache`), its kernel-library
tier in `repro_torch.kernels._build`, and the retrace audit of
`repro_torch.core.rounds` — the reference's `tests/test_progcache.py` and
`tests/test_retrace_audit.py`, translated — on the CPU.

  * Serve programs dispatched through the cache give bits equal to the
    uncached dispatch on a miss and on a hit, for the `VmapReducer` and a
    one-rank `ShardedReducer` (8 rounds in chunks of 4).
  * Every anomaly — a corrupt payload, a torn manifest, another
    environment, another schema, a payload that fails to load — is a miss
    of its own class that rebuilds, never an error: through the serve
    programs and through `ProgramCache.load_or_build` with a stand-in
    build and load (no ``nvcc``).  A kernel library resolves through tier
    1 so: a warm load from a copy of the entries, with tier 2 empty and
    no ``nvcc``, runs nothing and loads the verified copy.
  * `fingerprint` is the same in two processes and tells specs apart;
    `env_fingerprint` holds no hostname; `validate_entry`; `from_env`
    with ``REPRO_PROGCACHE=0``; concurrent writers leave a sound entry.
  * The audit: one trace per spec and none across chunks (both reducers)
    or cohort epochs; a warm-cache dispatch traces nothing and loads the
    libraries its entry names.
  * ``fed_serve`` with its default cache equals ``--no-progcache`` (meta
    aside) and the JAX package's serve record; ``dryrun --progcache-dir``
    prints the records it prints without it.

Every test leaves no cache active and the program memo empty.
"""
import contextlib
import io
import json
import multiprocessing
import os
import pathlib
import platform
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import batched, cohort, comm, compressors, glm, progcache, rounds, specs
from repro_torch.core import client_batch
from repro_torch.core.basis import orth_basis_from_data
from repro_torch.kernels import _build
from repro_torch.launch import dryrun, fed_serve

REPO = pathlib.Path(__file__).resolve().parents[1]
REF_FILE = REPO / "src" / "repro_torch" / "exp" / "data" / "fed_serve_ref.json"
GAP_RTOL, GAP_ATOL = 1e-8, 1e-12


@pytest.fixture(autouse=True)
def _no_cache_after():
    """No test leaves a cache active or a program resolved."""
    progcache.deactivate()
    rounds.clear_aot_memo()
    yield
    progcache.deactivate()
    rounds.clear_aot_memo()


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _bl2_problem(seed=0, n=6, m=24, d=18, r=6, tau=3):
    clients = glm.make_synthetic(seed=seed, n_clients=n, m=m, d=d, r=r, lam=1e-3,
                                 device="cpu")
    bases = [orth_basis_from_data(c.A) for c in clients]
    spec, batch, basisb = batched.bl2_setup(clients, bases, [compressors.TopK(k=r)] * n,
                                            [compressors.Identity()] * n, tau=tau)
    return spec, batch, basisb, torch.zeros(d, dtype=torch.float64)


@pytest.fixture(scope="module")
def problem():
    return _bl2_problem()


def _serve_rounds(problem, *, sharded=False, t1=8, chunk=4):
    """Rounds [0, t1) in chunks from a fresh carry: (trajectory, per-leg
    bits, events) as numpy arrays."""
    spec, batch, basisb, x0 = problem
    root = torch.tensor([0, 7], dtype=torch.int64)
    carry = rounds.init_serve_carry(spec, batch, basisb, x0, sharded=sharded)
    parts, t = [], 0
    while t < t1:
        steps = min(chunk, t1 - t)
        carry, ys = rounds.run_chunk(spec, batch, basisb, x0, carry, t, steps, root,
                                     sharded=sharded)
        parts.append(ys)
        t += steps
    xs, leds, evs = rounds.concat_streams(parts)
    return (xs.numpy(), {leg: getattr(leds, leg).numpy() for leg in comm.CommLedger.LEGS},
            evs.numpy())


def _assert_streams_equal(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    for leg in comm.CommLedger.LEGS:
        np.testing.assert_array_equal(a[1][leg], b[1][leg])
    np.testing.assert_array_equal(a[2], b[2])


def _entries(root, kind, ext):
    return sorted(p for p in pathlib.Path(root).iterdir()
                  if p.name.startswith(kind + "-") and p.name.endswith(ext))


# ==========================================================================
# Hit == miss == uncached, both reducers
# ==========================================================================
@pytest.mark.parametrize("sharded", [False, True], ids=["vmap", "sharded"])
def test_miss_then_hit_bitwise_equal_uncached(problem, tmp_path, sharded):
    ref = _serve_rounds(problem, sharded=sharded)
    cache = progcache.activate(str(tmp_path / "pc"), "cpu")
    rounds.clear_aot_memo()
    missed = _serve_rounds(problem, sharded=sharded)
    assert cache.stats["miss"] == cache.stats["absent"] == 2 and cache.stats["hit"] == 0
    assert _entries(cache.root, "serve_chunk", ".bin") and _entries(cache.root, "serve_init",
                                                                    ".bin")
    # the payload: the kernel libraries the first call launched (none here)
    assert json.loads(_entries(cache.root, "serve_chunk", ".bin")[0].read_text()) == []
    rounds.clear_aot_memo()            # the next dispatch reads the entries on disk
    hit = _serve_rounds(problem, sharded=sharded)
    assert cache.stats["hit"] == 2 and cache.stats["miss"] == 2
    _assert_streams_equal(missed, ref)
    _assert_streams_equal(hit, ref)


# ==========================================================================
# Every anomaly is a miss of its own class, with equal bits
# ==========================================================================
def _corrupt_payload(root):
    for p in _entries(root, "serve_chunk", ".bin"):
        blob = bytearray(p.read_bytes())
        blob[len(blob) // 2] ^= 0xFF
        p.write_bytes(bytes(blob))


def _tear_manifest(root):
    for p in _entries(root, "serve_chunk", ".json"):
        raw = p.read_bytes()
        p.write_bytes(raw[: len(raw) // 2])


def _edit_manifest(field, value):
    def edit(root):
        for p in _entries(root, "serve_chunk", ".json"):
            manifest = json.loads(p.read_text())
            if field == "env":
                manifest["env"]["torch"] = value
            else:
                manifest[field] = value
            p.write_text(json.dumps(manifest))
    return edit


ANOMALIES = {"corrupt_payload": (_corrupt_payload, "corrupt"),
             "torn_manifest": (_tear_manifest, "corrupt"),
             "environment_skew": (_edit_manifest("env", "0.0.0-somebody-upgraded"), "skew"),
             "schema_bump": (_edit_manifest("schema", "repro_torch.progcache/entry@0"), "skew"),
             "jax_entry": (_edit_manifest("schema", "repro.progcache/entry@2"), "skew")}


@pytest.mark.parametrize("anomaly", sorted(ANOMALIES))
def test_serve_program_anomaly_is_a_miss_with_equal_bits(problem, tmp_path, anomaly):
    damage, why = ANOMALIES[anomaly]
    cache = progcache.activate(str(tmp_path / "pc"), "cpu")
    ref = _serve_rounds(problem)
    rounds.clear_aot_memo()
    damage(cache.root)
    cache.stats.clear()
    again = _serve_rounds(problem)
    assert cache.stats == {"hit": 1, "miss": 1, why: 1}        # init hits, chunk misses
    _assert_streams_equal(again, ref)
    # the entry built afresh replaced the damaged one
    (manifest,) = _entries(cache.root, "serve_chunk", ".json")
    assert progcache.validate_entry(str(manifest)) == []


def _stand_in(cache, calls, payload=b"library bytes v1"):
    """load_or_build with a stand-in build (counts its calls) and load."""
    def build():
        calls.append("build")
        return payload

    return cache.load_or_build(name="kernel-standin", key_parts=("kernel", "standin"),
                               build=build, load=lambda p: pathlib.Path(p).read_bytes())


def _damage_entry(root, anomaly):
    (bpath,) = _entries(root, "kernel-standin", ".bin")
    mpath = bpath.with_suffix(".json")
    if anomaly == "corrupt_payload":
        bpath.write_bytes(b"library bytes v2")
    elif anomaly == "torn_manifest":
        mpath.write_bytes(mpath.read_bytes()[:20])
    else:
        manifest = json.loads(mpath.read_text())
        if anomaly == "environment_skew":
            manifest["env"]["device_kind"] = "another card"
        else:
            manifest["schema"] = {"schema_bump": "repro_torch.progcache/entry@0",
                                  "jax_entry": "repro.progcache/entry@2"}[anomaly]
        mpath.write_text(json.dumps(manifest))


@pytest.mark.parametrize("anomaly", sorted(ANOMALIES))
def test_load_or_build_anomaly_is_a_miss_that_rebuilds(tmp_path, anomaly):
    cache = progcache.ProgramCache(str(tmp_path / "pc"))
    calls = []
    assert _stand_in(cache, calls) == (b"library bytes v1", "absent")
    assert _stand_in(cache, calls) == (b"library bytes v1", "hit") and calls == ["build"]
    _damage_entry(cache.root, anomaly)
    obj, why = _stand_in(cache, calls)
    assert (obj, why) == (b"library bytes v1", ANOMALIES[anomaly][1])
    assert calls == ["build", "build"]
    assert cache.stats["miss"] == 2 and cache.stats[why] == 1 and cache.stats["hit"] == 1
    assert _stand_in(cache, calls) == (b"library bytes v1", "hit")   # rebuilt entry is sound


def test_load_error_is_a_miss_and_a_failing_build_raises(tmp_path):
    cache = progcache.ProgramCache(str(tmp_path / "pc"))
    _stand_in(cache, [])
    loads = []

    def flaky(path):
        loads.append(path)
        if len(loads) == 1:
            raise OSError("cannot load the cached copy")
        return "loaded"

    obj, why = cache.load_or_build(name="kernel-standin", key_parts=("kernel", "standin"),
                                   build=lambda: b"library bytes v1", load=flaky)
    assert (obj, why) == ("loaded", "load_error") and len(loads) == 2
    with pytest.raises(RuntimeError, match="nvcc failed"):
        cache.load_or_build(name="kernel-other", key_parts=("kernel", "other"),
                            build=lambda: (_ for _ in ()).throw(RuntimeError("nvcc failed")),
                            load=flaky)


def test_store_error_is_counted_and_the_fallback_serves(tmp_path, monkeypatch):
    cache = progcache.ProgramCache(str(tmp_path / "pc"))

    def full_disk(path, data):
        raise OSError(28, "No space left on device")

    monkeypatch.setattr(progcache, "_atomic_write", full_disk)
    obj, why = cache.load_or_build(name="kernel-standin", key_parts=("kernel", "s"),
                                   build=lambda: b"x", load=lambda p: "cached",
                                   fallback=lambda: "fallback")
    assert (obj, why) == ("fallback", "absent") and cache.stats["store_error"] == 1
    with pytest.raises(OSError, match="cannot store"):
        cache.load_or_build(name="kernel-standin", key_parts=("kernel", "s"),
                            build=lambda: b"x", load=lambda p: "cached")


# ==========================================================================
# The kernel-library tier (kernels._build) without nvcc
# ==========================================================================
@pytest.fixture
def fake_toolkit(tmp_path, monkeypatch):
    """`_build` over a stand-in toolkit: ``nvcc`` writes the source's bytes
    as the library, a dlopen reads them back; tier 2 is ``tmp/build``."""
    state = {"nvcc": True}
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "_LOADED", {})
    monkeypatch.setattr(_build, "_IN_TIER1", set())
    monkeypatch.setattr(_build, "nvcc_runs", _build.collections.Counter())
    monkeypatch.setattr(_build, "dlopens", _build.collections.Counter())
    monkeypatch.setattr(_build, "_nvcc_release", lambda: "stand-in 1.0")

    def start(name):
        out = _build.library_path(name)
        if out.exists():
            return None, None, out
        if not state["nvcc"]:
            raise RuntimeError("nvcc not found")
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        out.write_bytes(b"so:" + (_build.CSRC / f"{name}.cu").read_bytes()[:64])
        _build.nvcc_runs[name] += 1
        return None, None, out

    def dlopen(name, path):
        _build.dlopens[name] += 1
        return ("lib", name, pathlib.Path(path).read_bytes())

    monkeypatch.setattr(_build, "_start", start)
    monkeypatch.setattr(_build, "_open", dlopen)
    monkeypatch.setattr(progcache, "env_fingerprint",
                        lambda backend="cpu": {"backend": backend, "card": "stand-in"})
    return state


def test_library_resolves_through_tier1_and_warm_loads_without_nvcc(tmp_path, fake_toolkit):
    cache = progcache.activate(str(tmp_path / "pc"), "cpu")
    lib = _build.load("topk_threshold")
    assert lib[1] == "topk_threshold" and dict(_build.nvcc_runs) == {"topk_threshold": 1}
    (entry,) = _entries(cache.root, "kernel-topk_threshold", ".json")
    assert progcache.validate_entry(str(entry)) == []
    assert json.loads(entry.read_text())["aux"] == {"library": "topk_threshold",
                                                    "nvcc": "stand-in 1.0"}
    assert _build.load("topk_threshold") is lib          # one load a process, by name
    # a fresh process on a fresh checkout: tier 2 empty, no nvcc
    for p in _build.BUILD_DIR.iterdir():
        p.unlink()
    fake_toolkit["nvcc"] = False
    _build._LOADED.clear()
    _build.nvcc_runs.clear()
    progcache.deactivate()
    warm = progcache.activate(str(tmp_path / "pc"), "cpu")
    assert _build.load("topk_threshold") == lib
    assert warm.stats == {"hit": 1} and not _build.nvcc_runs
    assert not any(_build.BUILD_DIR.iterdir())            # tier 2 untouched
    # a damaged library is a miss that rebuilds — and with no toolkit it raises
    _build._LOADED.clear()
    progcache.deactivate()
    entry.with_suffix(".bin").write_bytes(b"truncated")
    progcache.activate(str(tmp_path / "pc"), "cpu")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.load("topk_threshold")


def test_no_cache_loads_from_tier2_as_before(fake_toolkit):
    assert progcache.active() is None
    lib = _build.load("tiled_matmul")
    assert lib[2].startswith(b"so:") and _build.library_path("tiled_matmul").exists()
    assert dict(_build.dlopens) == {"tiled_matmul": 1}


def test_library_key_holds_content_not_location(tmp_path, monkeypatch):
    key = _build._key_parts("topk_threshold")
    moved = tmp_path / "elsewhere" / "csrc"
    moved.mkdir(parents=True)
    for p in _build.CSRC.iterdir():
        (moved / p.name).write_bytes(p.read_bytes())
    monkeypatch.setattr(_build, "CSRC", moved)
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS[:-1] + (str(moved),))
    assert _build._key_parts("topk_threshold") == key
    assert str(moved) not in json.dumps(progcache.env_fingerprint.__wrapped__("cpu"))
    (moved / "topk_threshold.cu").write_bytes(b"// edited\n")
    assert _build._key_parts("topk_threshold") != key


# ==========================================================================
# Keys
# ==========================================================================
_FP_SCRIPT = """
import sys, torch
sys.path.insert(0, {src!r})
from repro_torch.core import batched, compressors, glm, progcache
from repro_torch.core.basis import orth_basis_from_data
clients = glm.make_synthetic(seed=0, n_clients=6, m=24, d=18, r=6, lam=1e-3, device="cpu")
bases = [orth_basis_from_data(c.A) for c in clients]
spec, batch, basisb = batched.bl2_setup(clients, bases, [compressors.TopK(k=6)] * 6,
                                        [compressors.Identity()] * 6, tau=3)
print(progcache.fingerprint((spec, basisb)))
"""


def test_fingerprint_deterministic_across_processes_and_discriminating(problem):
    spec, _, basisb, _ = problem
    here = progcache.fingerprint((spec, basisb))
    assert here == progcache.fingerprint((spec, basisb))
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"), "PYTHONHASHSEED": "random"}
    outs = [subprocess.run([sys.executable, "-c", _FP_SCRIPT.format(src=str(REPO / "src"))],
                           capture_output=True, text=True, env=env, timeout=300, check=True
                           ).stdout.strip() for _ in range(2)]
    assert outs == [here, here]
    assert progcache.fingerprint(_bl2_problem(tau=2)[0]) != progcache.fingerprint(spec)
    assert progcache.fingerprint(_bl2_problem(seed=1)[2]) != progcache.fingerprint(basisb)
    assert progcache.fingerprint(0.1) != progcache.fingerprint(float(np.nextafter(0.1, 1.0)))
    assert progcache.fingerprint({"b": 1, "a": 2}) == progcache.fingerprint({"a": 2, "b": 1})


def test_env_fingerprint_is_hostname_free():
    fp = progcache.env_fingerprint("cpu")
    blob = json.dumps(fp)
    for ident in (socket.gethostname(), platform.node()):
        if ident:
            assert ident not in blob
    assert {"torch", "cuda", "backend", "device_count", "device_kind", "capability",
            "nvcc_flags", "python", "machine"} == set(fp)
    assert "<csrc>" in fp["nvcc_flags"] and str(_build.CSRC) not in blob
    assert progcache.entry_key(("a",)) != progcache.entry_key(("b",))


# ==========================================================================
# Entry validation, activation, concurrent writers
# ==========================================================================
def test_validate_entry_accepts_real_and_rejects_corrupt(problem, tmp_path):
    cache = progcache.activate(str(tmp_path / "pc"), "cpu")
    _serve_rounds(problem)
    manifests = _entries(cache.root, "serve_init", ".json") + _entries(cache.root,
                                                                      "serve_chunk", ".json")
    assert len(manifests) == 2
    for m in manifests:
        assert progcache.validate_entry(str(m)) == []
    with open(manifests[0].with_suffix(".bin"), "ab") as f:
        f.write(b"junk")
    problems = progcache.validate_entry(str(manifests[0]))
    assert problems and "sha256 mismatch" in problems[0]


def test_from_env_respects_disable(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_PROGCACHE_DIR", str(tmp_path / "envpc"))
    monkeypatch.setenv("REPRO_PROGCACHE", "0")
    assert progcache.from_env() is None
    monkeypatch.setenv("REPRO_PROGCACHE", "1")
    cache = progcache.from_env()
    assert cache is not None and cache.root == str(tmp_path / "envpc")
    assert progcache.active() is cache


def test_scope_restores_the_cache_active_before(tmp_path):
    outer = progcache.activate(str(tmp_path / "a"), "cpu")
    with progcache.scope(str(tmp_path / "b"), "cpu") as inner:
        assert progcache.active() is inner and inner.root == str(tmp_path / "b")
        with progcache.scope(None) as off:
            assert off is None and progcache.active() is None
        assert progcache.active() is inner
    assert progcache.active() is outer


def _write_entry(root: str, writes: int) -> None:
    cache = progcache.ProgramCache(root)
    for _ in range(writes):
        assert cache.store("kernel-race", "k", b"\x7fELF" + bytes(range(256)) * 64) is not None


def test_concurrent_writers_leave_a_sound_entry(tmp_path):
    """Processes writing one entry at once (the ranks of a sharded serve,
    a killed child and its restart) — the same bytes, as they build them —
    leave a sound entry and no temporary file."""
    root = str(tmp_path / "pc")
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_write_entry, args=(root, 40)) for _ in range(6)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=240)
    assert all(not p.is_alive() and p.exitcode == 0 for p in procs)
    assert sorted(os.listdir(root)) == ["kernel-race-k.bin", "kernel-race-k.json"]
    assert progcache.validate_entry(os.path.join(root, "kernel-race-k.json")) == []


# ==========================================================================
# The retrace audit
# ==========================================================================
def _delta(before, after, kind):
    return after.get(kind, 0) - before.get(kind, 0)


@pytest.mark.parametrize("sharded", [False, True], ids=["fast", "fast+sharded"])
def test_one_trace_per_spec_zero_retraces_across_chunks(sharded):
    # dims of its own, so the first chunk is a fresh (spec, shapes)
    spec, batch, basisb, x0 = _bl2_problem(seed=2, n=5, m=20, d=14, r=5, tau=2)
    root = torch.tensor([0, 0], dtype=torch.int64)
    before = rounds.trace_counts()
    carry = rounds.init_serve_carry(spec, batch, basisb, x0, sharded=sharded)
    carry, _ = rounds.run_chunk(spec, batch, basisb, x0, carry, 0, 4, root, sharded=sharded)
    first = rounds.trace_counts()
    assert _delta(before, first, "chunk") == 1 and _delta(before, first, "init") == 1
    for t in (4, 8, 12):
        carry, _ = rounds.run_chunk(spec, batch, basisb, x0, carry, t, 4, root,
                                    sharded=sharded)
    after = rounds.trace_counts()
    assert _delta(first, after, "chunk") == 0, f"retraced across chunks: {first} -> {after}"
    assert _delta(first, after, "init/shape_eval") == 0
    rounds.carry_client_flags(spec, batch, basisb, x0)
    assert _delta(after, rounds.trace_counts(), "init/shape_eval") == 2
    assert _delta(after, rounds.trace_counts(), "init") == 0


def _cohort_engine(cohort_size=16, d=12, m=8, n=32):
    bb = cohort.standard_basisb(d, n)
    spec = specs.BL2Spec(hess_comp=compressors.TopK(k=2 * d), model_comp=compressors.Identity(),
                         alpha=1.0, eta=1.0, p=1.0, tau=8, init_exact=True,
                         init_hess_bits=bb.init_coeff_bits_mean(True),
                         basis_bits=bb.transmission_bits_mean(), block=False)
    store = client_batch.synthetic_store(0, n, m, d, lam=1e-3)
    # an epoch is 2 rounds: every chunk of 4 crosses epoch boundaries
    return cohort.CohortEngine(spec, store, x0=torch.zeros(d, dtype=torch.float64),
                               cohort=cohort_size, rounds_per_cohort=2,
                               root_key=torch.tensor([0, 0]), basis="standard", prefetch=False)


def test_zero_retraces_across_cohort_epochs():
    eng = _cohort_engine()
    try:
        before = rounds.trace_counts()
        eng.run_chunk(0, 4)
        first = rounds.trace_counts()
        assert _delta(before, first, "cohort_chunk") == 1
        for t in (4, 8):
            eng.run_chunk(t, 4)
        after = rounds.trace_counts()
        assert _delta(first, after, "cohort_chunk") == 0, f"{first} -> {after}"
    finally:
        eng.close()


@pytest.mark.parametrize("cohort_size", [16, 32], ids=["streamed", "full"])
def test_cohort_warm_programs_share_the_dispatch_signature(tmp_path, cohort_size):
    """`CohortEngine.warm_programs` resolves the very program its first
    chunk dispatches: after it, the rounds look nothing up and trace
    nothing, and the bits are those of an engine run without a cache."""
    plain = _cohort_engine(cohort_size)
    try:
        want = plain.run_chunk(0, 4)
    finally:
        plain.close()
    cache = progcache.activate(str(tmp_path / "pc"), "cpu")
    eng = _cohort_engine(cohort_size)
    try:
        assert eng.warm_programs(4)
        stats, traces = dict(cache.stats), rounds.trace_counts()
        got = eng.run_chunk(0, 4)
        assert dict(cache.stats) == stats and rounds.trace_counts() == traces
    finally:
        eng.close()
    for a, b in zip(rounds.carry_leaves(got[:1]) + [got[2]], rounds.carry_leaves(want[:1])
                    + [want[2]]):
        assert torch.equal(a, b)
    assert all(torch.equal(getattr(got[1], leg), getattr(want[1], leg))
               for leg in comm.CommLedger.LEGS)
    kind = "serve_chunk" if cohort_size == 32 else "cohort_chunk"
    assert _entries(cache.root, kind, ".bin")


def test_warm_cache_dispatch_traces_nothing(problem, tmp_path):
    spec, batch, basisb, x0 = problem
    root = torch.tensor([0, 1], dtype=torch.int64)
    progcache.activate(str(tmp_path / "pc"), "cpu")
    carry = rounds.init_serve_carry(spec, batch, basisb, x0)
    carry, ys_miss = rounds.run_chunk(spec, batch, basisb, x0, carry, 0, 4, root)
    rounds.clear_aot_memo()
    before = rounds.trace_counts()
    carry = rounds.init_serve_carry(spec, batch, basisb, x0)
    carry, ys_hit = rounds.run_chunk(spec, batch, basisb, x0, carry, 0, 4, root)
    after = rounds.trace_counts()
    assert _delta(before, after, "chunk") == 0 and _delta(before, after, "init") == 0
    assert progcache.active().stats["hit"] == 2
    assert torch.equal(ys_miss[0], ys_hit[0])


def test_warm_programs_resolve_without_running(problem, tmp_path, monkeypatch):
    """`warm_chunk_program` on a miss runs no round and leaves the carry as
    it was; the next dispatch stores the entry naming the libraries the
    call launched, and a warm resolution in a fresh memo loads them before
    any round."""
    spec, batch, basisb, x0 = problem
    assert not rounds.warm_chunk_program(spec, batch, basisb, x0, None, 4)   # no cache
    cache = progcache.activate(str(tmp_path / "pc"), "cpu")
    carry = rounds.init_serve_carry(spec, batch, basisb, x0)
    before = [t.clone() for t in rounds.carry_leaves(carry)]
    assert rounds.warm_chunk_program(spec, batch, basisb, x0, carry, 4)
    assert all(torch.equal(a, b) for a, b in zip(before, rounds.carry_leaves(carry)))
    assert not _entries(cache.root, "serve_chunk", ".bin")          # stored by the first call
    step = spec.step

    def launching(*args, **kw):              # a round that launches kernel 1's library
        _build.note("topk_threshold")
        return step(*args, **kw)

    monkeypatch.setattr(type(spec), "step", lambda self, *a, **k: launching(*a, **k))
    monkeypatch.setattr(_build, "entry_name", lambda lib: f"kernel-{lib}-k")
    rounds.run_chunk(spec, batch, basisb, x0, carry, 0, 4, torch.tensor([0, 1]))
    (payload,) = _entries(cache.root, "serve_chunk", ".bin")
    assert json.loads(payload.read_text()) == [{"library": "topk_threshold",
                                                "entry": "kernel-topk_threshold-k"}]
    loaded = []
    monkeypatch.setattr(_build, "load", loaded.append)
    rounds.clear_aot_memo()
    before = rounds.trace_counts()
    assert rounds.warm_chunk_program(spec, batch, basisb, x0, carry, 4)
    assert loaded == ["topk_threshold"] and rounds.trace_counts() == before


# ==========================================================================
# The serve loop and the dry run
# ==========================================================================
def test_fed_serve_default_cache_equals_no_progcache_and_the_reference(tmp_path):
    case = json.loads(REF_FILE.read_text())["cases"]["fig4/BL2_tau_half"]
    outs = {}
    for tag, extra in (("cached", []), ("plain", ["--no-progcache"])):
        res = tmp_path / f"{tag}.json"
        with contextlib.redirect_stdout(io.StringIO()):
            fed_serve.main([*case["args"], "--ckpt-dir", str(tmp_path / tag), "--result",
                            str(res), "--device", "cpu", *extra])
        outs[tag] = json.loads(res.read_text())
    cached, plain = outs["cached"], outs["plain"]
    assert cached["meta"]["progcache"]["dir"] == str(tmp_path / "cached" / "progcache")
    assert cached["meta"]["progcache"]["stats"] == {"miss": 2, "absent": 2}
    assert plain["meta"]["progcache"] is None and progcache.active() is None
    strip = lambda r: {k: v for k, v in r.items() if k != "meta"}  # noqa: E731
    assert strip(cached) == strip(plain)
    ref = strip(case["record"])
    g, gr = np.asarray(cached["history"]["gaps"]), np.asarray(ref["history"]["gaps"])
    assert not (np.abs(g - gr) > GAP_RTOL * np.abs(gr) + GAP_ATOL).any(), (g, gr)
    for key in ("up_bits", "down_bits", "legs", "events"):
        assert cached["history"][key] == ref["history"][key], key
    assert {k: v for k, v in strip(cached).items() if k != "history"} == \
        {k: v for k, v in ref.items() if k != "history"}


def test_dryrun_progcache_dir_gives_the_same_output(tmp_path):
    argv = ["--arch", "gemma3_4b", "--shape", "decode_32k", "--no-compile"]
    outs = []
    for extra in ([], ["--progcache-dir", str(tmp_path / "pc")]):
        out, err = io.StringIO(), io.StringIO()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            assert dryrun.main(argv + extra) == 0
        outs.append(([{k: v for k, v in json.loads(line).items() if k != "lower_s"}
                      for line in out.getvalue().splitlines()], err.getvalue()))
    assert outs[0][0] == outs[1][0] and outs[0][0][0]["status"] == "lowered"
    assert "# progcache" not in outs[0][1]
    summary = json.loads(outs[1][1].split("# progcache ", 1)[1])
    assert summary["stats"] == {} and summary["nvcc_runs"] == {} == summary["dlopens"]
