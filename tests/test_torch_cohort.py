"""The cohort-streaming engine (`repro_torch.core.cohort`): the port
against the JAX package in-process on the CPU, and the port's own
contracts, mirroring `tests/test_cohort.py`.

Against the reference (``jax.threefry_partitionable(flag)`` beside
``prng.threefry_partitionable(flag)``; the committed reference file was
written under False):

  * `synthetic_store`'s arrays and the epochs' cohorts (both sampler
    branches) are equal; `store_loss` and `store_newton_solve` agree to
    1e-14;
  * the vector `prng.fold_in` and the cohort participation draw are
    bitwise jax's, in both threefry settings;
  * cohort-smoke's BL2 through `exp.engine.run_cell` against the
    reference's engine and `problems.COHORT_REFERENCE`; BL2, BL3 and
    FedNL-BAG streaming on 96 clients in init slabs of 32 (the multi-slab
    init and `cohort_server_init`): gaps within 1e-8·|ref| + 1e-12, every
    bit stream exact, cohorts and each round's uploading clients (the
    run's own `CohortEngine.uploads`) equal.

The port's contracts: full mode is the stacked `rounds.run_chunk` bit for
bit; where the rounds are cut into calls, whether the next epoch is
prefetched and an in-memory checkpoint/restore change no bit; the bytes an
epoch moves to the device do not grow with the fleet; bad input raises.
"""
import hashlib
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.core import client_batch as jcb
from repro.core import cohort as jcohort
from repro.core import compressors as jcomp
from repro.core import rounds as jrounds
from repro.core import specs as jspecs
from repro.exp import engine as jengine
from repro.exp import registry as jregistry
from repro_torch.core import client_batch, cohort, comm, compressors, prng, rounds, specs
from repro_torch.exp import engine, problems, registry

GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
D, M = 6, 8
SETTINGS = (False, True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=SETTINGS, ids=["original", "partitionable"])
def setting(request):
    with jax.threefry_partitionable(request.param), \
            prng.threefry_partitionable(request.param):
        yield request.param


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _streams(ys) -> list:
    """(eval_x, ledger, events) as numpy arrays, the ledger leg by leg."""
    x, led, ev = ys
    return [_np(x), *(_np(getattr(led, leg)) for leg in comm.CommLedger.LEGS), _np(ev)]


def _assert_streams_equal(a, b, msg=""):
    for x, y in zip(_streams(a), _streams(b)):
        np.testing.assert_array_equal(x, y, err_msg=msg)


def _assert_gaps(g, gr):
    g, gr = np.asarray(g), np.asarray(gr)
    assert g.shape == gr.shape and np.all(np.isfinite(g))
    bad = ~(np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL)
    assert not bad.any(), (np.nonzero(bad)[0], g, gr)


# --------------------------------------------------------------------------
# the port's specs and engines at test size
# --------------------------------------------------------------------------
def _bl2(n, tau, mod=specs, comp=compressors):
    bb = cohort.standard_basisb(D, n)
    return mod.BL2Spec(hess_comp=comp.TopK(k=2 * D), model_comp=comp.Identity(), alpha=1.0,
                       eta=1.0, p=1.0, tau=tau, init_exact=True,
                       init_hess_bits=bb.init_coeff_bits_mean(True),
                       basis_bits=bb.transmission_bits_mean(), block=False)


def _bl3(n, tau, mod=specs, comp=compressors):
    return mod.BL3Spec(hess_comp=comp.TopK(k=2 * D), model_comp=comp.Identity(), alpha=1.0,
                       eta=1.0, p=0.5, tau=tau, c=1e-8, option=2)


def _bag(n, tau, mod=specs, comp=compressors):
    bb = cohort.standard_basisb(D, n)
    return mod.FedNLBAGSpec(hess_comp=comp.TopK(k=2 * D), alpha=1.0, q=0.5, eta=0.5,
                            mu=1e-3, init_exact=True,
                            init_hess_bits=bb.init_coeff_bits_mean(True),
                            basis_bits=bb.transmission_bits_mean(), block=False)


SPECS = {"bl2": (_bl2, "standard"), "bl3": (_bl3, None), "fednl_bag": (_bag, "standard")}


def _engine(n, tau, cohort_size, seed=11, **kw):
    kw.setdefault("prefetch", False)
    return cohort.CohortEngine(_bl2(n, tau), client_batch.synthetic_store(seed, n, M, D),
                               torch.zeros(D, dtype=torch.float64), cohort=cohort_size,
                               rounds_per_cohort=2, root_key=prng.PRNGKey(7),
                               basis="standard", **kw)


# --------------------------------------------------------------------------
# against the JAX package
# --------------------------------------------------------------------------
@pytest.mark.parametrize("seed,n,m,d", [(0, 5, 8, 24), (3, 96, 8, 8), (11, 64, 3, 6)])
def test_synthetic_store_equals_reference(seed, n, m, d):
    ours = client_batch.synthetic_store(seed, n, m, d)
    ref = jcb.synthetic_store(seed, n, m, d)
    np.testing.assert_array_equal(ours.A, ref.A)
    np.testing.assert_array_equal(ours.b, ref.b)
    assert ours.lam == ref.lam and ours.A.dtype == np.float64


@pytest.mark.parametrize("n,c", [(64, 8), (64, 16)], ids=["rejection", "permutation"])
def test_cohort_indices_equal_reference(n, c):
    ours = _engine(n, c, c)
    ref = jcohort.CohortEngine(_bl2(n, c, jspecs, jcomp), jcb.synthetic_store(11, n, M, D),
                               jnp.zeros(D), cohort=c, rounds_per_cohort=2,
                               root_key=jax.random.PRNGKey(7), prefetch=False)
    for e in range(6):
        got = ours.cohort_indices(e)
        np.testing.assert_array_equal(got, ref.cohort_indices(e))
        assert np.unique(got).size == c and got.min() >= 0 and got.max() < n
    assert not np.array_equal(ours.cohort_indices(0), ours.cohort_indices(1))
    ours.close()
    ref.close()


def test_fig1_xxl_epoch_cohort_equals_reference_file():
    ref = json.loads(problems.COHORT_REFERENCE.read_text())["experiments"]["fig1-xxl"]
    cell = problems.FIG1_XXL["BL2"]
    p = cell.cell.params_dict()
    got = cohort.cohort_indices(cohort.sampler_seed(prng.PRNGKey(0)), cell.problem.n_clients,
                                p["cohort"], 0)
    assert got.tolist() == ref["cohorts"][0]


def test_vector_fold_in_bitwise(setting):
    key = jax.random.fold_in(jax.random.PRNGKey(5), 9)
    idx = np.array([0, 1, 17, 95, 131071, 2**32 - 1], np.int64)
    want = jax.vmap(lambda i: jax.random.fold_in(key, i))(jnp.asarray(idx, jnp.uint32))
    got = prng.fold_in(prng.fold_in(prng.PRNGKey(5), 9), torch.tensor(idx))
    np.testing.assert_array_equal(np.asarray(want).astype(np.int64), got.numpy())
    for p in (1 / 512, 24 / 96, 0.5):
        np.testing.assert_array_equal(
            np.asarray(jax.vmap(lambda k: jax.random.bernoulli(k, p, ()))(want)),
            prng.bernoulli(got, p, ()).numpy())


@pytest.mark.parametrize("tau", [1, 24, 96, 200])
def test_cohort_participation_bitwise(setting, tau):
    """Each round's mask and event over a 13-client cohort of 96 against
    the reference's; τ = 1 makes empty draws (the forced fallback) likely,
    τ ≥ n draws everyone.  The reducer records each mask."""
    cidx = np.sort(np.random.default_rng(tau).choice(96, 13, replace=False)).astype(np.int32)
    jR = jrounds.CohortReducer(jrounds.VmapReducer(n=13), idx=jnp.asarray(cidx),
                               real=jnp.ones(13, bool), frozen={}, n_global=96)
    tR = rounds.CohortReducer(rounds.VmapReducer(n=13), idx=torch.tensor(cidx), frozen={},
                              n_global=96)
    forced = 0
    for t in range(12):
        jk = jax.random.fold_in(jax.random.PRNGKey(3), t)
        tk = prng.fold_in(prng.PRNGKey(3), t)
        jm, je = jrounds.participation(jR, jk, tau)
        tm, te = rounds.participation(tR, tk, tau)
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
        assert int(je) == int(te) and tR.uploads[t] is tm
        forced += int(te) == rounds.EVENT_FORCED
    if tau == 1:
        assert forced > 0
    with pytest.raises(ValueError, match="fault injection"):
        rounds.participation(tR, prng.PRNGKey(0), tau, avail=torch.ones(96, dtype=torch.bool))


def test_store_loss_and_newton_solve_match_reference():
    ours, ref = client_batch.synthetic_store(3, 96, 8, 8), jcb.synthetic_store(3, 96, 8, 8)
    x_o = cohort.store_newton_solve(ours, np.zeros(8), iters=12, slab=40)
    x_r = jcohort.store_newton_solve(ref, np.zeros(8), iters=12, slab=40)
    np.testing.assert_allclose(x_o, x_r, rtol=1e-14, atol=0)
    for x in (x_o, np.full(8, 0.3)):
        f_o, f_r = cohort.store_loss(ours, x, slab=40), jcohort.store_loss(ref, x, slab=40)
        assert abs(f_o - f_r) <= 1e-14 * abs(f_r)


def _check_against_file(exp_name, hist_by_cell, prob):
    ref = json.loads(problems.COHORT_REFERENCE.read_text())["experiments"][exp_name]
    sha = {k: hashlib.sha256(getattr(prob.store, k).tobytes()).hexdigest() for k in ("A", "b")}
    assert sha == ref["store_sha256"]
    f_star = cohort.store_loss(prob.store, prob.x_star)
    assert abs(f_star - ref["f_star"]) <= 1e-14 * abs(ref["f_star"])
    for name, h in hist_by_cell.items():
        run = ref["runs"][name]
        _assert_gaps(h.gaps, run["gaps"])
        assert h.up_bits == run["up_bits"] and h.down_bits == run["down_bits"]
        assert h.legs == run["legs"]


def test_cohort_smoke_run_cell_matches_reference():
    """cohort-smoke's BL2 through the port's `exp.engine.run_cell` against
    the reference's engine in-process and against the reference file
    (store checksums, f*, cohorts, participants, history)."""
    exp = registry.get_experiment("cohort-smoke")
    cell = exp.cell("BL2")
    prob = engine.build_problem(exp.problem, "cpu")
    assert isinstance(prob, engine.StreamProblem) and prob.n == 96
    h = engine.run_cell(exp, cell, prob, device="cpu")
    with jax.threefry_partitionable(False):
        jexp = jregistry.get_experiment("cohort-smoke")
        hr = jengine.run_cell(jexp, jexp.cell("BL2"), jengine.build_problem(jexp.problem))
    _assert_gaps(h.gaps, hr.gaps)
    assert (h.up_bits, h.down_bits, h.legs) == (hr.up_bits, hr.down_bits, hr.legs)
    _check_against_file("cohort-smoke", {"BL2": h}, prob)
    # the epochs' cohorts, and each round's participants as the run drew them
    p = cell.params_dict()
    seed64 = cohort.sampler_seed(prng.PRNGKey(0))
    cohorts = [cohort.cohort_indices(seed64, 96, p["cohort"], e)
               for e in range(cell.steps // p["rounds_per_cohort"])]
    file = json.loads(problems.COHORT_REFERENCE.read_text())["experiments"]["cohort-smoke"]
    assert [c.tolist() for c in cohorts] == file["cohorts"]
    assert h.uploads == file["runs"]["BL2"]["participants"]
    assert all(set(u) <= set(cohorts[t // p["rounds_per_cohort"]].tolist())
               for t, u in enumerate(h.uploads))
    with pytest.raises(ValueError, match="cohort backends"):
        engine.run_cell(exp, cell, prob, steps=2, backend="fast", device="cpu")


@pytest.mark.parametrize("method", sorted(SPECS))
def test_multi_slab_stream_matches_reference(method):
    """96 clients in init slabs of 32, cohorts of 16 for 2 rounds, 8 rounds:
    the multi-slab init (BAG's `cohort_server_init`), the frozen means
    (and BL3's frozen max) against the reference's engine."""
    make, basis = SPECS[method]
    n, tau, steps = 96, 24, 8
    store = client_batch.synthetic_store(5, n, M, D)
    eng = cohort.CohortEngine(make(n, tau), store, torch.zeros(D, dtype=torch.float64),
                              cohort=16, rounds_per_cohort=2, root_key=prng.PRNGKey(4),
                              basis=basis, slab=32, prefetch=False)
    x, led, _ = eng.run_chunk(0, steps)
    eng.close()
    with jax.threefry_partitionable(False):
        jstore = jcb.synthetic_store(5, n, M, D)
        jspec = make(n, tau, jspecs, jcomp)
        jeng = jcohort.CohortEngine(jspec, jstore, jnp.zeros(D), cohort=16, rounds_per_cohort=2,
                                    root_key=jax.random.PRNGKey(4), basis=basis, slab=32,
                                    prefetch=False)
        jx, jled, _ = jeng.run_chunk(0, steps)
        jeng.close()
        # each round's uploading clients, drawn as the reference's step draws them
        for t in range(steps):
            idx = jeng.cohort_indices(t // 2)
            key_t = jax.random.fold_in(jax.random.PRNGKey(4), t)
            if method == "fednl_bag":
                mask = jax.random.bernoulli(jax.random.split(key_t, 2)[1], jspec.q, (16,))
            else:
                CR = jrounds.CohortReducer(jrounds.VmapReducer(n=16), idx=jnp.asarray(idx),
                                           real=jnp.ones(16, bool), frozen={}, n_global=n)
                mask, _ = jrounds._cohort_participation(CR, jax.random.split(key_t, 4)[0], tau,
                                                        None)
            assert eng.uploads[t].tolist() == idx[np.asarray(mask)].tolist(), (method, t)
    x_star = cohort.store_newton_solve(store, np.zeros(D), iters=12)
    f_star = cohort.store_loss(store, x_star)
    gaps = [cohort.store_loss(store, xi) - f_star for xi in x.numpy()]
    _assert_gaps(gaps, [jcohort.store_loss(jstore, xi) - f_star for xi in np.asarray(jx)])
    for leg in comm.CommLedger.LEGS:
        np.testing.assert_array_equal(getattr(led, leg).numpy(), np.asarray(getattr(jled, leg)))
    for name, rows in jstore.state.items():
        np.testing.assert_allclose(store.state[name], rows, rtol=1e-8, atol=1e-12, err_msg=name)


# --------------------------------------------------------------------------
# the port's own contracts
# --------------------------------------------------------------------------
def test_full_mode_bitwise_equals_stacked_run_chunk():
    n = 32
    spec = _bl2(n, n)
    batch = client_batch.synthetic_store(11, n, M, D).gather_batch(np.arange(n))
    bb = cohort.standard_basisb(D, n)
    x0 = torch.zeros(D, dtype=torch.float64)
    c0 = rounds.init_serve_carry(spec, batch, bb, x0)
    c1, ys1 = rounds.run_chunk(spec, batch, bb, x0, c0, 0, 6, prng.PRNGKey(7))
    eng = _engine(n, n, n)
    assert eng.full
    ys2 = rounds.concat_streams([eng.run_chunk(0, 3), eng.run_chunk(3, 3)])
    _assert_streams_equal(ys1, ys2, "full mode != the stacked run_chunk")
    for x, y in zip(rounds.carry_leaves(c1), rounds.carry_leaves(eng._cur["carry"])):
        assert torch.equal(x, y)
    eng.close()


@pytest.mark.parametrize("make", [_bl2, _bag], ids=["bl2", "fednl_bag"])
def test_stacked_run_chunk_does_not_depend_on_cuts(make):
    """The stacked chunk driver keys round t by ``fold_in(root_key, t)``:
    rounds [3, 7) in one call equal [3, 5) then [5, 7) from the carry."""
    n = 16
    spec = make(n, 4)
    batch = client_batch.synthetic_store(2, n, M, D).gather_batch(np.arange(n))
    bb = cohort.standard_basisb(D, n)
    x0 = torch.zeros(D, dtype=torch.float64)
    c0 = rounds.init_serve_carry(spec, batch, bb, x0)
    c1, ys = rounds.run_chunk(spec, batch, bb, x0, c0, 3, 4, prng.PRNGKey(1))
    ca, ya = rounds.run_chunk(spec, batch, bb, x0, c0, 3, 2, prng.PRNGKey(1))
    cb, yb = rounds.run_chunk(spec, batch, bb, x0, ca, 5, 2, prng.PRNGKey(1))
    _assert_streams_equal(ys, rounds.concat_streams([ya, yb]), "cuts changed the run")
    for x, y in zip(rounds.carry_leaves(c1), rounds.carry_leaves(cb)):
        assert torch.equal(x, y)


def test_carry_client_flags_on_shapes_only():
    n = 8
    batch = client_batch.synthetic_store(1, n, M, D).gather_batch(np.arange(n))
    x0 = torch.zeros(D, dtype=torch.float64)
    bb = cohort.standard_basisb(D, n)
    assert [all(f) for f in rounds.carry_client_flags(_bl2(n, n), batch, bb, x0)] == [
        True, True, True, True, True, True, False]
    assert [any(f) for f in rounds.carry_client_flags(_bag(n, n), batch, bb, x0)] == [
        False, True, False, True, False]


def _run_segmented(segs, seed=11, **kw):
    eng = _engine(64, 16, 16, seed=seed, **kw)
    outs, t = [], 0
    for s in segs:
        outs.append(eng.run_chunk(t, s))
        t += s
    eng.close()
    return rounds.concat_streams(outs)


def test_chunk_boundary_invariance():
    ref = _run_segmented([12])
    # cuts mid-epoch, at epoch edges, and one-round calls
    _assert_streams_equal(ref, _run_segmented([1, 4, 3, 2, 2]), "cuts changed the run")
    _assert_streams_equal(ref, _run_segmented([6, 6]), "cuts changed the run")


@settings(max_examples=6, deadline=None)
@given(cuts=st.lists(st.integers(1, 11), min_size=0, max_size=3), seed=st.integers(0, 3))
def test_chunk_boundary_invariance_property(cuts, seed):
    bounds = sorted(set(cuts)) + [12]
    segs, prev = [], 0
    for b in bounds:
        if b > prev:
            segs.append(b - prev)
            prev = b
    _assert_streams_equal(_run_segmented([12], seed=seed), _run_segmented(segs, seed=seed),
                          f"cuts {segs} changed the run")


def test_prefetch_changes_no_bit():
    eng = _engine(64, 16, 16, prefetch=True)
    on = rounds.concat_streams([eng.run_chunk(0, 5), eng.run_chunk(5, 7)])
    assert eng.metrics["epochs_prefetched"] == 5 and eng.metrics["epochs_loaded"] == 6
    assert 0.0 <= eng.prefetch_overlap <= 1.0
    eng.close()
    _assert_streams_equal(_run_segmented([12]), on, "prefetch changed the run")


def _epoch_bytes(eng, c) -> tuple:
    """Bytes an epoch moves to the device and back, from the shapes: the
    cohort's A and b, its carry rows, its int32 indices and the float64
    frozen statistics in; the carry rows out."""
    rows = c * sum(v[0].nbytes for v in eng.store.state.values())
    frozen = sum(eng.store.state[leaf][0].astype(np.float64).nbytes
                 for leaf, _ in eng.spec.cohort_aggregates().values())
    return c * (M * D + M) * 8 + rows + c * 4 + frozen, rows


@pytest.mark.parametrize("prefetch", [False, True], ids=["sync", "prefetch"])
def test_epoch_bytes_do_not_grow_with_the_fleet(prefetch):
    """Every copy the engine makes is counted where it is made: an epoch
    moves the same bytes at 64 and at 512 clients (same cohort of 16)."""
    per_epoch = {}
    for n in (64, 512):
        eng = _engine(n, 16, 16, prefetch=prefetch)
        eng.run_chunk(0, 12)
        eng.close()
        m = eng.metrics
        h2d, d2h = _epoch_bytes(eng, 16)
        assert m["epochs_loaded"] == 6
        assert m["h2d_bytes"] == 6 * h2d and m["d2h_bytes"] == 5 * d2h  # the 6th stays
        per_epoch[n] = m["h2d_bytes"] / m["epochs_loaded"]
    assert per_epoch[64] == per_epoch[512]


@pytest.mark.parametrize("tck", [5, 6], ids=["mid_epoch", "epoch_boundary"])
def test_checkpoint_restore_bitwise(tck):
    e1 = _engine(64, 16, 16)
    e1.run_chunk(0, tck)
    leaves, host = e1.checkpoint_payload()
    assert any(k.startswith("store/") for k in host)
    assert any(k.startswith("frozen/") for k in host)
    tail_ref = e1.run_chunk(tck, 12 - tck)
    e1.close()
    e2 = _engine(64, 16, 16)
    e2.restore(tck, e2.unflatten_carry(leaves), host)
    tail = e2.run_chunk(tck, 12 - tck)
    e2.close()
    _assert_streams_equal(tail_ref, tail, f"restore at {tck} diverged")


def test_constructor_and_restore_refuse_bad_input():
    store = client_batch.synthetic_store(1, 8, M, D)
    x0 = torch.zeros(D, dtype=torch.float64)
    key = prng.PRNGKey(0)
    with pytest.raises(ValueError, match="rounds_per_cohort must be >= 1"):
        cohort.CohortEngine(_bl2(8, 8), store, x0, cohort=4, rounds_per_cohort=0, root_key=key)
    with pytest.raises(ValueError, match="cohort must be >= 1"):
        cohort.CohortEngine(_bl2(8, 8), store, x0, cohort=0, rounds_per_cohort=1, root_key=key)
    with pytest.raises(ValueError, match="not cohort-capable"):
        cohort.CohortEngine(specs.GDSpec(lr=0.1), store, x0, cohort=4, rounds_per_cohort=1,
                            root_key=key)
    with pytest.raises(ValueError, match="convention basis"):
        cohort.CohortEngine(_bl2(8, 8), store, x0, cohort=8, rounds_per_cohort=1,
                            root_key=key, basis="data_outer")
    # sharded=True (ROADMAP.md §1 item 13) on a one-rank world: the cohort
    # engine unsharded, bit for bit
    runs = []
    for sharded in (False, True):
        fleet = client_batch.synthetic_store(1, 8, M, D)
        e = cohort.CohortEngine(_bl2(8, 8), fleet, torch.zeros(D, dtype=torch.float64), cohort=4,
                                rounds_per_cohort=1, root_key=key, sharded=sharded)
        runs.append((e.run_chunk(0, 3), e.uploads, fleet.state))
        e.close()
    (xa, la, _), ua, sa = runs[0]
    (xb, lb, _), ub, sb = runs[1]
    assert torch.equal(xa, xb) and torch.equal(la.hess_up, lb.hess_up)
    assert [u.tolist() for u in ua] == [u.tolist() for u in ub]
    assert all(np.array_equal(sa[k], sb[k]) for k in sa)
    eng = _engine(64, 16, 16)
    with pytest.raises(ValueError, match="lacks.*frozen"):
        eng.restore(4, eng.carry_template(), {})
    with pytest.raises(RuntimeError, match="nothing to checkpoint"):
        eng.checkpoint_payload()
    eng.close()


def test_bare_cohort_reducer_mean_and_max_raise():
    R = rounds.CohortReducer(rounds.VmapReducer(n=4), idx=torch.arange(4, dtype=torch.int32),
                             frozen={}, n_global=10)
    x = torch.ones(4, 3, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="unnamed fleet mean"):
        R.mean(x)
    with pytest.raises(NotImplementedError, match="unnamed fleet max"):
        R.max(x)
    with pytest.raises(ValueError, match="needs a frozen fleet statistic"):
        R.reduce_tree({"b": x}, "max")
    out = R.reduce_tree({"a": x, "s": x}, {"a": "mean", "s": "sum"})
    assert torch.equal(out["a"], torch.full((3,), 0.4, dtype=torch.float64))
    assert torch.equal(out["s"], torch.full((3,), 4.0, dtype=torch.float64))


def test_stream_backends():
    assert engine.resolve_backend("cohort") == "cohort"
    # the sharded cohort backend (ROADMAP.md §1 item 13) runs as named
    assert engine.resolve_backend("cohort+sharded") == "cohort+sharded"
    exp = registry.get_experiment("fig1-xxl")
    assert exp.problem.kind == "synthetic_stream" and exp.problem.n_clients == 131072
    assert {c.backend for c in exp.cells} == {"cohort"}
    assert set(problems.FIG1_XXL) == {"BL2", "FedNL-BAG"}
