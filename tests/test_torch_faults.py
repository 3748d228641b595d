"""The fault layer (`repro_torch.core.faults`) and the chunked driver's
availability schedule (`rounds.run_chunk(avail=...)`): the port against the
JAX package in-process on the CPU.

  * `FaultPlan.schedule`, the straggler model's outcomes and waits, the
    slow-client draw and `describe` are bitwise `repro.core.faults`' for
    several seeds and chunkings; the validation errors carry the same
    messages;
  * `run_chunk` under a dropout-and-outage schedule on `tests/test_serve.py`'s
    problem (n=6, m=24, d=18, r=6, BL2 τ=3) equals the JAX `run_chunk`:
    events and every bit stream exact, gaps within 1e-8·|ref| + 1e-12, in
    both threefry settings; within the port it is bitwise the same cut into
    chunks of 1, 4 and 12 rounds, and ``avail=None`` is bitwise an all-ones
    schedule;
  * `FedNLBAGSpec` under a schedule with outages and an all-down round
    equals the reference (its ``EVENT_DEGRADED`` / ``EVENT_ALL_DOWN`` bits
    and its trajectory: unavailable clients stay silent).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import batched as jbatched
from repro.core import client_batch as jcb
from repro.core import compressors as jcomp
from repro.core import faults as jfaults
from repro.core import glm as jglm
from repro.core import rounds as jrounds
from repro.core.basis import make_bases as jmake_bases
from repro_torch.core import batched, comm, compressors, faults, prng, rounds
from repro_torch.core.convert import problem_from_numpy

GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
N, M, D, R = 6, 24, 18, 6
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


# --------------------------------------------------------------------------
# the fault layer against repro.core.faults
# --------------------------------------------------------------------------
def _plans(mod, n, seed):
    """(name, plan) pairs built the same way in either package."""
    strag = dict(mean_s=0.1, slow_frac=0.3, slow_factor=5.0, timeout_s=0.2, retries=2,
                 backoff=1.5)
    return {
        "dropout": mod.FaultPlan(n=n, dropout_p=0.3, seed=seed),
        "outages": mod.FaultPlan(n=n, outages=(mod.Outage(1, 2, 7), mod.Outage(4, 0, 3)),
                                 seed=seed),
        "straggler": mod.FaultPlan(n=n, straggler=mod.StragglerModel(**strag), seed=seed),
        "composed": mod.FaultPlan(n=n, dropout_p=0.15, outages=(mod.Outage(0, 5, 9),),
                                  straggler=mod.StragglerModel(**strag), seed=seed),
    }


@pytest.mark.parametrize("kind", ["dropout", "outages", "straggler", "composed"])
@pytest.mark.parametrize("seed", [0, 7, 123])
def test_schedule_bitwise_equal_to_reference(kind, seed):
    """The whole [0, 13) schedule and its waits equal the reference's, cut
    into chunks of 1, 4 or 13 rounds (a fresh generator a round and
    stream, so chunking cannot matter)."""
    n, T = 11, 13
    plan, ref = _plans(faults, n, seed)[kind], _plans(jfaults, n, seed)[kind]
    want, want_wait = ref.schedule(0, T)
    for chunk in (1, 4, T):
        rows, waited = [], 0.0
        for t0 in range(0, T, chunk):
            a, w = plan.schedule(t0, min(chunk, T - t0))
            rows.append(a)
            waited += w
        got = np.concatenate(rows)
        assert got.dtype == want.dtype and got.shape == (T, n)
        np.testing.assert_array_equal(got, want)
        assert waited == pytest.approx(want_wait, rel=1e-15, abs=0.0)
    assert plan.describe() == ref.describe()
    assert plan.trivial == ref.trivial


@pytest.mark.parametrize("seed", [0, 3, 99])
def test_straggler_outcomes_and_waits_bitwise(seed):
    n = 17
    model = faults.StragglerModel(mean_s=0.08, slow_frac=0.25, timeout_s=0.2, retries=3)
    ref = jfaults.StragglerModel(mean_s=0.08, slow_frac=0.25, timeout_s=0.2, retries=3)
    np.testing.assert_array_equal(model.slow_mask(seed, n), ref.slow_mask(seed, n))
    for t in range(6):
        ok, waited = model.round_outcome(seed, t, n)
        ok_r, waited_r = ref.round_outcome(seed, t, n)
        np.testing.assert_array_equal(ok, ok_r)
        assert waited == waited_r


def test_surviving_cohort_monotone_in_retries():
    """A client misses a round only when every attempt times out, so the
    survivors can only grow with the retry budget."""
    n = 64
    for t in range(8):
        prev = np.zeros(n, bool)
        for retries in range(4):
            ok, _ = faults.StragglerModel(mean_s=0.3, timeout_s=0.2,
                                          retries=retries).round_outcome(5, t, n)
            assert np.all(ok >= prev)
            prev = ok


_BAD = [
    ("Outage", dict(client=0, start=3, stop=3)),
    ("Outage", dict(client=-1, start=0, stop=2)),
    ("StragglerModel", dict(timeout_s=0.0)),
    ("StragglerModel", dict(mean_s=-1.0)),
    ("StragglerModel", dict(retries=-1)),
    ("StragglerModel", dict(backoff=0.5)),
    ("StragglerModel", dict(slow_frac=1.5)),
    ("FaultPlan", dict(n=4, dropout_p=1.0)),
    ("FaultPlan", dict(n=4, dropout_p=-0.1)),
    ("FaultPlan", dict(n=4, outages=("OUTAGE",))),
]


@pytest.mark.parametrize("cls,kw", _BAD, ids=lambda v: v if isinstance(v, str) else
                         ",".join(f"{k}={w}" for k, w in v.items()))
def test_validation_errors_match_reference(cls, kw):
    def build(mod):
        args = dict(kw)
        if args.get("outages") == ("OUTAGE",):
            args["outages"] = (mod.Outage(client=4, start=0, stop=1),)
        return getattr(mod, cls)(**args)

    with pytest.raises(ValueError) as got:
        build(faults)
    with pytest.raises(ValueError) as want:
        build(jfaults)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("spec", ["3:1:4", "0:0:1", "3:1", "a:b:c", "2:5:5"])
def test_outage_parse_matches_reference(spec):
    try:
        want = jfaults.Outage.parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            faults.Outage.parse(spec)
        assert str(got.value) == str(e)
    else:
        assert faults.Outage.parse(spec) == faults.Outage(want.client, want.start, want.stop)


def test_crash_injector_fires_only_past_its_round():
    """The kill itself is exercised through the CLI (test_torch_serve.py);
    here: at or before its round the injector does nothing."""
    inj = faults.CrashInjector(after_round=5)
    for t in range(6):
        inj.maybe_crash(t)


# --------------------------------------------------------------------------
# run_chunk under an availability schedule, against the JAX run_chunk
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def problem():
    """tests/test_serve.py's problem in both packages (identical data,
    basis and optimum)."""
    clients = jglm.make_synthetic(seed=0, n_clients=N, m=M, d=D, r=R, lam=1e-3)
    x0 = jnp.zeros(D, jnp.float64)
    x_star = jglm.newton_solve(clients, x0, 20)
    jbases = jmake_bases("data_outer", clients)
    jbb = jcb.stack_bases(jbases)
    port = problem_from_numpy(
        np.stack([np.asarray(c.A) for c in clients]),
        np.stack([np.asarray(c.b) for c in clients]), 1e-3,
        np.asarray(jbb.V), jbb.rs, np.asarray(x0), np.asarray(x_star), device="cpu")
    return clients, jbases, x0, x_star, port


def _setups(problem, method):
    clients, jbases, _, _, port = problem
    if method == "bl2":
        return (jbatched.bl2_setup(clients, jbases, [jcomp.TopK(k=6)] * N,
                                   [jcomp.Identity()] * N, tau=3),
                batched.bl2_setup(port.clients, port.bases, [compressors.TopK(k=6)] * N,
                                  [compressors.Identity()] * N, tau=3))
    return (jbatched.fednl_bag_setup(clients, jbases, [jcomp.TopK(k=6)] * N, q=0.5),
            batched.fednl_bag_setup(port.clients, port.bases, [compressors.TopK(k=6)] * N,
                                    q=0.5))


def _port_chunks(setup, x0, plan, T, chunk, root, *, ones=False):
    spec, batch, basisb = setup
    carry = rounds.init_serve_carry(spec, batch, basisb, x0)
    parts = []
    for t0 in range(0, T, chunk):
        steps = min(chunk, T - t0)
        avail = (np.ones((steps, N), bool) if ones else
                 None if plan is None else plan.schedule(t0, steps)[0])
        carry, ys = rounds.run_chunk(spec, batch, basisb, x0, carry, t0, steps, root,
                                     avail=avail)
        parts.append(ys)
    return rounds.concat_streams(parts)


def _jax_run(setup, x0, plan, T, root):
    spec, batch, basisb = setup
    carry = jrounds.init_serve_carry(spec, batch, basisb, x0)
    avail = None if plan is None else plan.schedule(0, T)[0]
    _, ys = jrounds.run_chunk(spec, batch, basisb, x0, carry, 0, T, root, avail=avail)
    return ys


def _host_streams(ys) -> list:
    x, led, ev = ys
    return [np.asarray(x), *(np.asarray(getattr(led, leg)) for leg in comm.CommLedger.LEGS),
            np.asarray(ev)]


def _assert_matches_reference(port_ys, jax_ys, setups, problem):
    (jspec, jbatch, _), (spec, batch, _) = setups
    _, _, _, jx_star, port = problem
    got, want = _host_streams(port_ys), _host_streams(jax_ys)
    for leg, a, b in zip(comm.CommLedger.LEGS, got[1:5], want[1:5]):
        np.testing.assert_array_equal(a, b, err_msg=leg)
    np.testing.assert_array_equal(got[5], want[5], err_msg="events")
    gaps = rounds.default_gap_stream(batch, port_ys[0], batched._f_star(batch, port.x_star))
    jg = jrounds.default_gap_stream(jbatch, jax_ys[0], jbatched._f_star(jbatch, jx_star))
    g, gr = gaps.numpy(), np.asarray(jg)
    assert np.all(np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL), (g, gr)


def test_run_chunk_dropout_schedule_matches_reference(problem, setting):
    """BL2 τ=3 under dropout and an outage window: events and bits exact,
    gaps in the gate, the port's chunks of 5 against one JAX chunk."""
    plan = faults.FaultPlan(n=N, dropout_p=0.3, outages=(faults.Outage(2, 3, 9),), seed=3)
    setups = _setups(problem, "bl2")
    x0 = problem[4].x0
    port_ys = _port_chunks(setups[1], x0, plan, 14, 5, prng.PRNGKey(5))
    jax_ys = _jax_run(setups[0], problem[2], plan, 14, jax.random.PRNGKey(5))
    _assert_matches_reference(port_ys, jax_ys, setups, problem)
    assert np.any(np.asarray(jax_ys[2]) & rounds.EVENT_DEGRADED)


def test_run_chunk_is_chunk_invariant_and_none_is_all_ones(problem):
    plan = faults.FaultPlan(n=N, dropout_p=0.3, outages=(faults.Outage(2, 3, 9),), seed=3)
    setup = _setups(problem, "bl2")[1]
    x0 = problem[4].x0
    runs = [_host_streams(_port_chunks(setup, x0, plan, 12, c, prng.PRNGKey(1)))
            for c in (1, 4, 12)]
    for other in runs[1:]:
        for a, b in zip(runs[0], other):
            np.testing.assert_array_equal(a, b)
    none = _host_streams(_port_chunks(setup, x0, None, 12, 4, prng.PRNGKey(1)))
    ones = _host_streams(_port_chunks(setup, x0, None, 12, 4, prng.PRNGKey(1), ones=True))
    for a, b in zip(none, ones):
        np.testing.assert_array_equal(a, b)


def test_run_chunk_rejects_a_schedule_of_the_wrong_shape(problem):
    spec, batch, basisb = _setups(problem, "bl2")[1]
    x0 = problem[4].x0
    carry = rounds.init_serve_carry(spec, batch, basisb, x0)
    with pytest.raises(ValueError, match=r"avail schedule must be \(steps, n\) = \(3, 6\), "
                                         r"got \(3, 5\)"):
        rounds.run_chunk(spec, batch, basisb, x0, carry, 0, 3, prng.PRNGKey(0),
                         avail=np.ones((3, 5), bool))


def test_fednl_bag_under_faults_matches_reference(problem, setting):
    """FedNL-BAG reads `RoundCtx.avail`: unavailable clients stay silent,
    a round with a client down is ``EVENT_DEGRADED`` and one with every
    client down adds ``EVENT_ALL_DOWN`` — trajectory, bits and events as
    the reference's."""
    outages = tuple(faults.Outage(c, 2, 5) for c in range(4)) + tuple(
        faults.Outage(c, 6, 7) for c in range(N))
    plan = faults.FaultPlan(n=N, outages=outages, seed=0)
    setups = _setups(problem, "fednl_bag")
    x0 = problem[4].x0
    port_ys = _port_chunks(setups[1], x0, plan, 10, 4, prng.PRNGKey(2))
    jax_ys = _jax_run(setups[0], problem[2], plan, 10, jax.random.PRNGKey(2))
    _assert_matches_reference(port_ys, jax_ys, setups, problem)
    ev = np.asarray(port_ys[2]).tolist()
    assert ev == [0, 0, 1, 1, 1, 0, 5, 0, 0, 0]
