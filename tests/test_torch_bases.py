"""The GLM bases ``symmetric``, ``psd``, ``eigen`` and ``dct`` and Table 2's
regimes: the port (`repro_torch.core.basis`, `client_batch.BatchedBasis`,
`glm.make_table2`) against the JAX package in-process, and the basis grid
(`problems.BASIS_GRID`, `problems.TABLE2_A1A`) against the JAX package's
histories in `problems.BASIS_GRID_REFERENCE`, on the CPU.

Transforms are held to 1e-12 of the largest magnitude (the rotations and
the PSD basis's diagonal are float64 sums taken in different orders), the
symmetric basis's triangles and the bit accounting exactly.  Runs are
held to the GLM gate: gaps within |Δ| ≤ 1e-8·|ref| + 1e-12, every bit
stream exact.  ``psd`` is BL3's basis; no run on the card uses it, so
only these tests hold it.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import basis as jbasis
from repro.core import bl as jbl
from repro.core import client_batch as jcb
from repro.core import compressors as jcomp
from repro.core import glm as jglm
from repro_torch.core import basis as tbasis
from repro_torch.core import bl as tbl
from repro_torch.core import client_batch as tcb
from repro_torch.core import compressors as tcomp
from repro_torch.core import glm as tglm
from repro_torch.exp import problems

N, M, D, R = 5, 20, 16, 5
GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
NEW_KINDS = ("symmetric", "psd", "eigen", "dct")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fleet():
    """The same small fleet in both packages, its optimum, and a symmetric
    (n, d, d) stack of Hessians."""
    jc = jglm.make_synthetic(seed=4, n_clients=N, m=M, d=D, r=R, lam=1e-3)
    tc = tglm.make_synthetic(seed=4, n_clients=N, m=M, d=D, r=R, lam=1e-3, device="cpu")
    x0 = jnp.zeros(D, jnp.float64)
    x_star = jglm.newton_solve(jc, x0, 20)
    x = np.random.default_rng(2).standard_normal(D) / np.sqrt(D)
    H = np.stack([np.asarray(jglm.hess(c, jnp.asarray(x))) for c in jc])
    return jc, tc, x0, x_star, H


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=1e-12):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * max(float(np.abs(b).max()), 1e-300))


def _pair(fleet, kind):
    """Both packages' bases of `kind`; the port's eigenbasis carries the
    reference's Q (eigenvectors are not unique; `test_eigen_basis_*`
    holds the port's own)."""
    jc, tc, x0, _, _ = fleet
    jb = jbasis.make_bases(kind, jc, x0=x0)
    if kind == "eigen":
        shared = tbasis.EigenBasis(Q=torch.tensor(np.asarray(jb[0].Q)))
        return jb, [shared] * N
    return jb, tbasis.make_bases(kind, tc, x0=torch.zeros(D, dtype=torch.float64))


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_single_basis_matches_reference(fleet, kind):
    jb, tb = _pair(fleet, kind)
    H = fleet[-1]
    exact = kind == "symmetric"
    for j, t, A in zip(jb, tb, H):
        hj, ht = j.h(jnp.asarray(A)), t.h(torch.tensor(A))
        if exact:
            np.testing.assert_array_equal(_np(ht), np.asarray(hj))
        else:
            _close(ht, hj)
        _close(t.reconstruct(ht), j.reconstruct(hj))
        _close(t.reconstruct(ht), A)                       # exact inverse on S^d
        assert t.n_coeff == j.n_coeff and t.d == j.d
        assert tbasis.basis_transmission_bits(t) == jbasis.basis_transmission_bits(j)


@pytest.mark.parametrize("kind", NEW_KINDS)
def test_batched_basis_matches_reference(fleet, kind):
    """Batched h / reconstruct / server_reconstruct and every bit count."""
    jb, tb = _pair(fleet, kind)
    jbb, tbb = jcb.stack_bases(jb), tcb.stack_bases(tb)
    assert tbb.kind == jbb.kind == kind and tbb.rs == jbb.rs
    H = fleet[-1]
    hj, ht = jbb.h(jnp.asarray(H)), tbb.h(torch.tensor(H))
    if kind == "symmetric":
        np.testing.assert_array_equal(_np(ht), np.asarray(hj))
        np.testing.assert_array_equal(_np(tbb.reconstruct(ht)), np.asarray(jbb.reconstruct(hj)))
    else:
        _close(ht, hj)
        _close(tbb.reconstruct(ht), jbb.reconstruct(hj))
    _close(tbb.server_reconstruct(ht, 1e-3), jbb.server_reconstruct(hj, 1e-3))
    for name in ("grad_uplink_bits_mean", "transmission_bits_mean", "coeff_count_mean"):
        assert getattr(tbb, name)() == getattr(jbb, name)(), name
    for exact in (True, False):
        assert tbb.init_coeff_bits_mean(exact) == jbb.init_coeff_bits_mean(exact)


def test_dct_matrix_is_the_references_dct_basis():
    """`_dct_matrix` in float64 is `DCTBasis`'s C bit for bit (the BL-DNN
    tree bases use it in float32)."""
    for d in (1, 4, 7, 120):
        want = np.asarray(jbasis.DCTBasis(d).Q)
        np.testing.assert_array_equal(_np(tbasis._dct_matrix(d, dtype=torch.float64)), want)
        np.testing.assert_array_equal(_np(tbasis.DCTBasis(d).Q), want)
        np.testing.assert_array_equal(_np(tbasis._dct_matrix(d)), want.astype(np.float32))


def test_eigen_basis_from_clients_matches_reference(fleet):
    """The port's own eigenbasis: the same eigenvectors up to each
    column's sign (the spectrum of this fleet is simple), one shared
    object, shipped as d² floats."""
    jc, tc, _, _, _ = fleet
    jQ = np.asarray(jbasis.eigen_basis_from_clients(jc)[0].Q)
    tb = tbasis.eigen_basis_from_clients(tc)
    assert all(b is tb[0] for b in tb)
    tQ = _np(tb[0].Q)
    np.testing.assert_allclose(np.abs(tQ.T @ jQ), np.eye(D), rtol=0, atol=1e-10)
    assert tbasis.basis_transmission_bits(tb[0]) == D * D * 64.0


def test_stack_bases_refuses_mixed_kinds_and_rotations(fleet):
    jc, tc, _, _, _ = fleet
    sym, dct = tbasis.make_bases("symmetric", tc), tbasis.make_bases("dct", tc)
    assert tcb.stack_bases(sym[:2] + dct[2:]) is None
    q = tbasis.make_bases("eigen", tc)[0].Q
    rotated = [tbasis.EigenBasis(Q=q), tbasis.EigenBasis(Q=q.flip(1))]
    assert tcb.stack_bases(rotated) is None
    same = [tbasis.EigenBasis(Q=q), tbasis.EigenBasis(Q=q.clone())]
    assert tcb.stack_bases(same).kind == "eigen"
    with pytest.raises(TypeError):
        tbasis.make_bases("dct", tc, rcond=1.0)


BL1_CASES = [(kind, comp) for kind in NEW_KINDS for comp in (("TopK", 40), ("RankR", 2))]


@pytest.mark.parametrize("kind,comp", BL1_CASES, ids=[f"{k}-{c[0]}" for k, c in BL1_CASES])
def test_bl1_in_each_basis_matches_reference(fleet, kind, comp):
    """BL1 in the new bases (the full (n, d, d) layout) against the
    reference, bits exact (the eigenbasis's shipment included)."""
    jc, tc, x0, x_star, _ = fleet
    jb, tb = _pair(fleet, kind)
    name, size = comp
    ref = jbl.bl1(jc, jb, [getattr(jcomp, name)(size)] * N, jcomp.Identity(), x0, x_star, 6,
                  backend="fast")
    h = tbl.bl1(tc, tb, [getattr(tcomp, name)(size)] * N, tcomp.Identity(),
                torch.tensor(np.asarray(x0)), torch.tensor(np.asarray(x_star)), 6, device="cpu")
    g, gr = np.asarray(h.gaps), np.asarray(ref.gaps)
    assert np.all(np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL), (g, gr)
    assert h.up_bits == ref.up_bits and h.down_bits == ref.down_bits and h.legs == ref.legs


# --------------------------------------------------------------------------
# Table 2's regimes
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jglm.TABLE2))
def test_make_table2_matches_reference(name):
    assert tglm.TABLE2[name] == jglm.TABLE2[name]
    jc = jglm.make_table2(name, seed=1)
    tc = tglm.make_table2(name, seed=1, device="cpu")
    assert len(tc) == len(jc)
    for j, t in zip(jc, tc):
        np.testing.assert_array_equal(_np(t.A), np.asarray(j.A))
        np.testing.assert_array_equal(_np(t.b), np.asarray(j.b))
        assert t.lam == j.lam


def test_table2_problem_kind():
    spec = problems.TABLE2_A1A.problem
    prob = problems.build_problem(spec, device="cpu")
    shape = jglm.TABLE2["a1a"]
    assert (prob.n, prob.d) == (shape["n_clients"], shape["d"])
    stream = problems.build_problem(
        problems.ProblemSpec(kind="synthetic_stream", n_clients=12, m=8, d=6), device="cpu")
    assert (stream.n, stream.d, stream.store.A.shape) == (12, 6, (12, 8, 6))
    # the sharded cohort backend runs as named (ROADMAP.md §1 item 13)
    assert problems.engine.resolve_backend("cohort+sharded") == "cohort+sharded"
    with pytest.raises(ValueError, match="unknown problem kind"):
        problems.build_problem(problems.ProblemSpec(kind="libsvm"), device="cpu")


# --------------------------------------------------------------------------
# the basis grid and a1a against the JAX package's histories
# --------------------------------------------------------------------------
GRID = (*problems.BASIS_GRID.values(), problems.TABLE2_A1A)


@pytest.fixture(scope="module")
def paper():
    return problems.build_problem(problems.ProblemSpec(), device="cpu")


def test_basis_grid_reference_describes_the_cells():
    ref = json.loads(problems.BASIS_GRID_REFERENCE.read_text())
    cfg = ref["config"]
    assert sorted(ref["runs"]) == sorted(c.name for c in GRID)
    assert tuple(cfg["grid"]["bases"]) == problems.GRID_BASES
    for cell in problems.BASIS_GRID.values():
        assert cell.steps == cfg["grid"]["steps"] and cell.problem == problems.ProblemSpec()
        hc = cell.hess_comp
        want = {"topk": cfg["grid"]["topk_k"], "rankr": cfg["grid"]["rankr_r"]}
        assert (hc.k if hc.kind == "topk" else hc.r) == want[hc.kind]
        assert cell.model_comp.kind == cfg["grid"]["model_comp"]
    a1a = problems.TABLE2_A1A
    assert (a1a.steps, a1a.basis, a1a.hess_comp) == (
        cfg["a1a"]["steps"], cfg["a1a"]["basis"],
        problems.CompressorCfg(kind="topk", k=cfg["a1a"]["topk_k"]))
    assert ref["threefry_partitionable"] is False


@pytest.mark.parametrize("cell", GRID, ids=[c.name for c in GRID])
def test_basis_grid_matches_reference(paper, cell):
    prob = paper if cell.problem.kind == "synthetic" else \
        problems.build_problem(cell.problem, device="cpu")
    h = problems.run_cell(cell, prob)
    ref = cell.reference_history()
    g, gr = np.asarray(h.gaps), np.asarray(ref["gaps"])
    assert np.all(np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL), (g, gr)
    assert h.up_bits == ref["up_bits"] and h.down_bits == ref["down_bits"]
    assert h.legs == ref["legs"]
