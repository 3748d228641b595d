"""The op-by-op reference backend (`repro_torch.core.bl_reference`, the
``backend="reference"`` branches of `bl1` / `bl2` / `bl3` and of
`baselines.newton` / `gd` / `diana`) against the JAX package's loops, on the
CPU, on the reference's `tests/test_batched_parity.py` problem (6 clients,
m = 30, d = 40, r = 12).

  * Each loop equals the JAX package's loop, ``backend="reference"`` in
    both, in the GLM gate of PERF.md §2: gaps within 1e-8·|ref| + 1e-12,
    integer bit streams exact.  Both packages draw the same keys, client
    after client (the loops' ``key, sk = split(key)`` chain), so the
    stochastic cases (p < 1, partial participation, dithering) are held to
    the same gate, in both ``jax_threefry_partitionable`` settings; a
    dithering count goes through ``exp2`` / ``log2``, where XLA and torch
    differ by an ulp, so its bits are held at 1e-14 relative.
  * The port's fast path equals its own loops in the reference's
    `_assert_parity` envelope (gaps rtol 1e-9, atol 1e-8; bits rtol
    1e-12) on the deterministic full-participation cases.
  * "auto" on a fleet the fast path cannot stack (Top-K on half the
    clients, Rank-R on the rest) is an explicit "reference" run bit for
    bit, and "fast" raises `batched.FastPathUnavailable`;
    ``fednl_bag(backend="reference")`` raises ``ValueError``, as in the
    reference.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbaselines
from repro.core import bl as jbl
from repro.core import client_batch as jcb
from repro.core import compressors as jcomp
from repro.core import glm as jglm
from repro.core.basis import StandardBasis as JStd
from repro.core.basis import orth_basis_from_data
from repro_torch.core import baselines, batched, prng
from repro_torch.core import bl as tbl
from repro_torch.core import compressors as tcomp
from repro_torch.core.basis import DataOuterBasis
from repro_torch.core.basis import StandardBasis as TStd
from repro_torch.core.convert import problem_from_numpy

GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
DITHER_BITS_RTOL = 1e-14


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def problem():
    """The reference's parity problem in both packages, on one data basis
    and one optimum."""
    clients = jglm.make_synthetic(seed=0, n_clients=6, m=30, d=40, r=12, lam=1e-3)
    x0 = jnp.zeros(40, jnp.float64)
    xs = jglm.newton_solve(clients, x0, 20)
    jbases = [orth_basis_from_data(c.A) for c in clients]
    jbb = jcb.stack_bases(jbases)
    port = problem_from_numpy(
        np.stack([np.asarray(c.A) for c in clients]),
        np.stack([np.asarray(c.b) for c in clients]), 1e-3,
        np.asarray(jbb.V), jbb.rs, np.asarray(x0), np.asarray(xs), device="cpu")
    return clients, jbases, x0, xs, port


@contextlib.contextmanager
def threefry(flag: bool):
    """One ``jax_threefry_partitionable`` setting for both packages."""
    with jax.threefry_partitionable(flag), prng.threefry_partitionable(flag):
        yield


def assert_glm_gate(h, ref, bits_rtol: float = 0.0):
    g, gr = np.asarray(h.gaps), np.asarray(ref.gaps)
    assert g.shape == gr.shape and np.all(np.isfinite(g))
    bad = np.abs(g - gr) > GAP_RTOL * np.abs(gr) + GAP_ATOL
    assert not bad.any(), f"gaps {g} vs reference {gr}"
    for name in ("up_bits", "down_bits"):
        got, want = np.asarray(getattr(h, name)), np.asarray(getattr(ref, name))
        if bits_rtol:
            np.testing.assert_allclose(got, want, rtol=bits_rtol, atol=0)
        else:
            assert list(got) == list(want), name
    assert h.legs is None and ref.legs is None


def assert_parity(h_ref, h_fast):
    """The reference's `_assert_parity` envelope between its two backends."""
    np.testing.assert_allclose(h_fast.gaps, h_ref.gaps, rtol=1e-9, atol=1e-8)
    np.testing.assert_allclose(h_fast.up_bits, h_ref.up_bits, rtol=1e-12)
    np.testing.assert_allclose(h_fast.down_bits, h_ref.down_bits, rtol=1e-12)


def _r(jbases) -> int:
    return jbases[0].r


# --------------------------------------------------------------------------
# BL1
# --------------------------------------------------------------------------
#: (id, basis, hessian compressor maker (r → (jax, port)), model compressor
#: (jax, port), steps, keyword arguments)
BL1_CASES = [
    ("topk_r", "data", lambda r: (jcomp.TopK(k=r), tcomp.TopK(k=r)), None, 14, {}),
    ("topk_2r_no_exact_init", "data",
     lambda r: (jcomp.TopK(k=2 * r), tcomp.TopK(k=2 * r)), None, 12,
     {"init_exact_hessian": False}),
    ("rankr_standard", "standard", lambda r: (jcomp.RankR(r=1), tcomp.RankR(r=1)), None, 14,
     {}),
    ("rankr_standard_p0.5", "standard", lambda r: (jcomp.RankR(r=2), tcomp.RankR(r=2)),
     None, 12, {"p": 0.5, "seed": 1}),
    ("rankr_data_no_exact_init_p0.5", "data",
     lambda r: (jcomp.RankR(r=3), tcomp.RankR(r=3)), None, 12,
     {"init_exact_hessian": False, "p": 0.5, "seed": 1}),
    ("topk_bidirectional_p0.5", "data", lambda r: (jcomp.TopK(k=r), tcomp.TopK(k=r)),
     (jcomp.TopK(k=20), tcomp.TopK(k=20)), 20, {"p": 0.5, "seed": 3}),
    ("rtopk_stochastic", "data", lambda r: (jcomp.rtopk(2 * r), tcomp.rtopk(2 * r)), None,
     12, {"alpha": 0.5, "seed": 5}),
]


def _bl1_runs(problem, case):
    clients, jbases, x0, xs, port = problem
    _, basis, hess, model, steps, kw = case
    r = _r(jbases)
    jh, th = hess(r)
    jm, tm = model if model is not None else (jcomp.Identity(), tcomp.Identity())
    n = len(clients)
    if basis == "standard":
        jb, tb = [JStd(40)] * n, [TStd(40)] * n
    else:
        jb, tb = jbases, port.bases

    def jax_run(backend):
        return jbl.bl1(clients, jb, [jh] * n, jm, x0, xs, steps, backend=backend, **kw)

    def port_run(backend):
        return tbl.bl1(port.clients, tb, [th] * n, tm, port.x0, port.x_star, steps,
                       backend=backend, device="cpu", **kw)

    return jax_run, port_run


def _settings(cases):
    """(case, threefry setting): every case in the artifacts' setting
    (False), a case that draws (it passes a seed) in both."""
    out = [pytest.param(c, False, id=f"{c[0]}-threefry0") for c in cases]
    return out + [pytest.param(c, True, id=f"{c[0]}-threefry1") for c in cases
                  if "seed" in c[-1]]


@pytest.mark.parametrize("case,flag", _settings(BL1_CASES))
def test_bl1_reference_matches_the_jax_loop(problem, case, flag):
    jax_run, port_run = _bl1_runs(problem, case)
    with threefry(flag):
        h = port_run("reference")
        ref = jax_run("reference")
    assert_glm_gate(h, ref, DITHER_BITS_RTOL if case[0] == "rtopk_stochastic" else 0.0)


@pytest.mark.parametrize("case", [c for c in BL1_CASES if not c[5]],
                         ids=[c[0] for c in BL1_CASES if not c[5]])
def test_bl1_fast_path_matches_the_port_loop(problem, case):
    _, port_run = _bl1_runs(problem, case)
    assert_parity(port_run("reference"), port_run("fast"))


# --------------------------------------------------------------------------
# BL2 and BL3
# --------------------------------------------------------------------------
BL2_CASES = [("full_participation", 4, 14, {}),
             ("partial_tau3", 2, 14, {"tau": 3, "seed": 2}),
             ("partial_tau3_p0.5_no_exact_init", 2, 12,
              {"tau": 3, "p": 0.5, "seed": 4, "init_exact_hessian": False})]


@pytest.mark.parametrize("case,flag", _settings(BL2_CASES))
def test_bl2_reference_matches_the_jax_loop(problem, case, flag):
    clients, jbases, x0, xs, port = problem
    name, kr, steps, kw = case
    k = kr * _r(jbases)
    n = len(clients)
    run = lambda backend: tbl.bl2(port.clients, port.bases, [tcomp.TopK(k=k)] * n,  # noqa: E731
                                  [tcomp.Identity()] * n, port.x0, port.x_star, steps,
                                  backend=backend, device="cpu", **kw)
    with threefry(flag):
        ref = jbl.bl2(clients, jbases, [jcomp.TopK(k=k)] * n, [jcomp.Identity()] * n, x0, xs,
                      steps, backend="reference", **kw)
        h = run("reference")
    assert_glm_gate(h, ref)
    if not kw:
        assert_parity(h, run("fast"))


BL3_CASES = [("option1", {"option": 1}), ("option2", {"option": 2}),
             ("option2_partial_tau3_p0.5", {"option": 2, "tau": 3, "p": 0.5, "seed": 6})]


@pytest.mark.parametrize("case,flag", _settings(BL3_CASES))
def test_bl3_reference_matches_the_jax_loop(problem, case, flag):
    """Identity Hessian compressors: the reference's tie-free BL3 parity
    configuration, in both β options."""
    clients, _, x0, xs, port = problem
    name, kw = case
    n = len(clients)
    run = lambda backend: tbl.bl3(port.clients, [tcomp.Identity()] * n,  # noqa: E731
                                  [tcomp.Identity()] * n, port.x0, port.x_star, 12,
                                  backend=backend, device="cpu", **kw)
    with threefry(flag):
        ref = jbl.bl3(clients, [jcomp.Identity()] * n, [jcomp.Identity()] * n, x0, xs, 12,
                      backend="reference", **kw)
        h = run("reference")
    assert_glm_gate(h, ref)
    if "tau" not in kw:
        assert_parity(h, run("fast"))


# --------------------------------------------------------------------------
# Newton, GD, DIANA
# --------------------------------------------------------------------------
@pytest.mark.parametrize("with_bases", [False, True], ids=["naive", "data_basis"])
def test_newton_reference_matches_the_jax_loop(problem, with_bases):
    clients, jbases, x0, xs, port = problem
    ref = jbaselines.newton(clients, x0, xs, 6, bases=jbases if with_bases else None,
                            backend="reference")
    run = lambda backend: baselines.newton(  # noqa: E731
        port.clients, port.x0, port.x_star, 6, bases=port.bases if with_bases else None,
        backend=backend, device="cpu")
    h = run("reference")
    assert_glm_gate(h, ref)
    assert_parity(h, run("fast"))


def test_gd_reference_matches_the_jax_loop(problem):
    clients, _, x0, xs, port = problem
    ref = jbaselines.gd(clients, x0, xs, 30, backend="reference")
    h = baselines.gd(port.clients, port.x0, port.x_star, 30, backend="reference",
                     device="cpu")
    assert_glm_gate(h, ref)
    assert_parity(h, baselines.gd(port.clients, port.x0, port.x_star, 30, backend="fast",
                                  device="cpu"))


@pytest.mark.parametrize("flag", [False, True], ids=["threefry0", "threefry1"])
@pytest.mark.parametrize("s", [4, 16])
def test_diana_reference_matches_the_jax_loop(problem, s, flag):
    """DIANA with random dithering: the same client-after-client key chain
    in both packages, so the same draws."""
    clients, _, x0, xs, port = problem
    jc, tc = jcomp.RandomDithering(s=s), tcomp.RandomDithering(s=s)
    with threefry(flag):
        ref = jbaselines.diana(clients, x0, xs, 25, jc, jc.omega_for(40), seed=7,
                               backend="reference")
        h = baselines.diana(port.clients, port.x0, port.x_star, 25, tc, tc.omega_for(40),
                            seed=7, backend="reference", device="cpu")
    assert_glm_gate(h, ref, DITHER_BITS_RTOL)


# --------------------------------------------------------------------------
# dispatch: "auto" falls back, "fast" raises, fednl_bag has no loop
# --------------------------------------------------------------------------
def test_auto_falls_back_to_the_loops_on_a_heterogeneous_fleet(problem):
    """Top-K on half the clients, Rank-R on the rest: "fast" cannot stack
    it, "auto" runs the loops (bit for bit an explicit "reference" run) and
    equals the JAX package's "auto" in the GLM gate."""
    clients, jbases, x0, xs, port = problem
    r = _r(jbases)
    th = [tcomp.TopK(k=r)] * 3 + [tcomp.RankR(r=2)] * 3
    jh = [jcomp.TopK(k=r)] * 3 + [jcomp.RankR(r=2)] * 3
    args = (port.clients, port.bases, th, tcomp.Identity(), port.x0, port.x_star, 10)
    with pytest.raises(batched.FastPathUnavailable):
        tbl.bl1(*args, backend="fast", device="cpu")
    auto = tbl.bl1(*args, backend="auto", device="cpu")
    ref = tbl.bl1(*args, backend="reference", device="cpu")
    assert (auto.gaps, auto.up_bits, auto.down_bits) == (ref.gaps, ref.up_bits, ref.down_bits)
    assert_glm_gate(auto, jbl.bl1(clients, jbases, jh, jcomp.Identity(), x0, xs, 10,
                                  backend="auto"))


def test_newton_auto_falls_back_on_a_fleet_of_unequal_clients(problem):
    """Clients of unequal sample counts do not stack: "auto" runs Newton's
    loop, equal to the JAX package's "auto"."""
    clients, jbases, x0, xs, port = problem
    cut = [jglm.ClientData(A=c.A[:20 + 2 * i], b=c.b[:20 + 2 * i], lam=c.lam)
           for i, c in enumerate(clients)]
    tcut = [type(c)(A=torch.tensor(np.asarray(j.A)), b=torch.tensor(np.asarray(j.b)),
                    lam=j.lam) for c, j in zip(port.clients, cut)]
    tb = [DataOuterBasis(V=b.V) for b in port.bases]
    with pytest.raises(batched.FastPathUnavailable):
        baselines.newton(tcut, port.x0, port.x_star, 4, bases=tb, backend="fast",
                         device="cpu")
    h = baselines.newton(tcut, port.x0, port.x_star, 4, bases=tb, backend="auto",
                         device="cpu")
    assert_glm_gate(h, jbaselines.newton(cut, x0, xs, 4, bases=jbases, backend="auto"))


def test_fednl_bag_has_no_reference_backend(problem):
    _, _, _, _, port = problem
    with pytest.raises(ValueError, match="spec-only"):
        baselines.fednl_bag(port.clients, [TStd(40)] * 6, [tcomp.Identity()] * 6, port.x0,
                            port.x_star, 2, backend="reference", device="cpu")
