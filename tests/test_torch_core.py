"""The port's core modules (`repro_torch.core`) against the reference
package, on the CPU at small sizes.

Inputs are made from a seed with numpy and handed to both packages.
Tolerances: GLM quantities to 1e-12 relative (the two frameworks sum in
different orders, in float64); data generation, bit accounting and the
deterministic compressors bitwise.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import basis as jbasis
from repro.core import bl as jbl
from repro.core import client_batch as jcb
from repro.core import comm as jcomm
from repro.core import compressors as jcomp
from repro.core import glm as jglm
from repro_torch.core import basis as tbasis
from repro_torch.core import bl as tbl
from repro_torch.core import client_batch as tcb
from repro_torch.core import comm as tcomm
from repro_torch.core import compressors as tcomp
from repro_torch.core import convert, glm as tglm

RTOL = 1e-12
N, M, D, R = 4, 20, 24, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def fleet():
    """The same small problem in both packages, plus a shared iterate."""
    jclients = jglm.make_synthetic(seed=3, n_clients=N, m=M, d=D, r=R, lam=1e-3)
    tclients = tglm.make_synthetic(seed=3, n_clients=N, m=M, d=D, r=R, lam=1e-3,
                                   device="cpu")
    x = np.random.default_rng(7).standard_normal(D) / np.sqrt(D)
    return jclients, tclients, x


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, rtol=RTOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    scale = max(float(np.max(np.abs(b))), 1e-300)
    np.testing.assert_allclose(a, b, rtol=0, atol=rtol * scale)


# --------------------------------------------------------------------------
# glm
# --------------------------------------------------------------------------
def test_make_synthetic_is_bitwise_the_reference(fleet):
    jclients, tclients, _ = fleet
    assert len(jclients) == len(tclients)
    for jc, tc in zip(jclients, tclients):
        assert tc.A.dtype == torch.float64 and tc.b.dtype == torch.float64
        np.testing.assert_array_equal(_np(tc.A), np.asarray(jc.A))
        np.testing.assert_array_equal(_np(tc.b), np.asarray(jc.b))
        assert tc.lam == jc.lam


@pytest.mark.parametrize("fn", ["loss", "grad", "hess", "hess_data_part",
                                "hess_diag_weights"])
def test_glm_per_client_matches_reference(fleet, fn):
    jclients, tclients, x = fleet
    for jc, tc in zip(jclients, tclients):
        _close(getattr(tglm, fn)(tc, torch.from_numpy(x)),
               getattr(jglm, fn)(jc, jnp.asarray(x)))


@pytest.mark.parametrize("fn", ["global_loss", "global_grad", "global_hess"])
def test_glm_global_matches_reference(fleet, fn):
    jclients, tclients, x = fleet
    _close(getattr(tglm, fn)(tclients, torch.from_numpy(x)),
           getattr(jglm, fn)(jclients, jnp.asarray(x)))


def test_sigmoid_keeps_the_tanh_form():
    t = np.linspace(-40, 40, 101)
    _close(tglm.sigmoid(torch.from_numpy(t)), jglm.sigmoid(jnp.asarray(t)))


def test_newton_solve_matches_reference(fleet):
    jclients, tclients, _ = fleet
    x0 = np.zeros(D)
    _close(tglm.newton_solve(tclients, torch.from_numpy(x0), 20),
           jglm.newton_solve(jclients, jnp.asarray(x0), 20))


# --------------------------------------------------------------------------
# client_batch
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def batches(fleet):
    jclients, tclients, x = fleet
    return jcb.from_clients(jclients), tcb.from_clients(tclients), x


@pytest.mark.parametrize("fn", ["losses", "global_loss", "grads", "global_grad",
                                "hess_weights", "hess_data_part", "hess",
                                "global_hess_fused"])
def test_batched_glm_matches_reference(batches, fn):
    jb, tb, x = batches
    _close(getattr(tcb, fn)(tb, torch.from_numpy(x)), getattr(jcb, fn)(jb, jnp.asarray(x)))


def test_bmv_is_multiply_plus_reduce(batches):
    jb, tb, x = batches
    xb = np.tile(x, (N, 1))
    _close(tcb.bmv(tb.A, torch.from_numpy(xb)), jcb.bmv(jb.A, jnp.asarray(xb)))


def test_newton_solve_fused_matches_reference(batches):
    jb, tb, _ = batches
    x0 = np.zeros(D)
    _close(tcb.newton_solve_fused(tb, torch.from_numpy(x0), 12),
           jcb.newton_solve_fused(jb, jnp.asarray(x0), 12))


def test_client_batch_validates_shapes():
    with pytest.raises(ValueError, match="client-stacked"):
        tcb.ClientBatch(A=torch.zeros(3, 4), b=torch.zeros(3), lam=1e-3)
    with pytest.raises(ValueError, match="b must have shape"):
        tcb.ClientBatch(A=torch.zeros(2, 3, 4), b=torch.zeros(2, 4), lam=1e-3)


def test_from_clients_refuses_heterogeneous_fleets(fleet):
    _, tclients, _ = fleet
    odd = tglm.ClientData(A=tclients[0].A[:-1], b=tclients[0].b[:-1], lam=1e-3)
    assert tcb.from_clients(list(tclients[1:]) + [odd]) is None
    other_lam = tglm.ClientData(A=tclients[0].A, b=tclients[0].b, lam=2e-3)
    assert tcb.from_clients(list(tclients[1:]) + [other_lam]) is None


# --------------------------------------------------------------------------
# basis + batched basis, from the reference's own V
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def bases(fleet):
    jclients, tclients, _ = fleet
    jb = jbasis.make_bases("data_outer", jclients)
    jbb = jcb.stack_bases(jb)
    tbb = tcb.BatchedBasis(kind="data_outer", d=D, rs=tuple(jbb.rs),
                           V=torch.tensor(np.asarray(jbb.V)))
    return jb, jbb, tbb


def test_orth_basis_spans_the_reference_subspace(fleet, bases):
    """Same rank, and the same projector V Vᵀ (singular-vector signs may
    differ between LAPACK builds; the projector does not see them)."""
    _, tclients, _ = fleet
    jb, _, _ = bases
    tb = tbasis.make_bases("data_outer", tclients)
    for j, t in zip(jb, tb):
        assert (t.r, t.d) == (j.r, j.d) and t.n_coeff == j.n_coeff
        Vj, Vt = np.asarray(j.V), _np(t.V)
        _close(Vt @ Vt.T, Vj @ Vj.T)
        np.testing.assert_allclose(Vt.T @ Vt, np.eye(t.r), atol=1e-12)
        assert tbasis.basis_transmission_bits(t) == jbasis.basis_transmission_bits(j)


def test_basis_h_and_reconstruct_round_trip(fleet, bases):
    jclients, tclients, x = fleet
    jb, _, _ = bases
    for jc, tc, j in zip(jclients, tclients, jb):
        t = tbasis.DataOuterBasis(V=torch.tensor(np.asarray(j.V)))
        Hj = jglm.hess_data_part(jc, jnp.asarray(x))
        Ht = tglm.hess_data_part(tc, torch.from_numpy(x))
        _close(t.h(Ht), j.h(Hj))
        _close(t.reconstruct(t.h(Ht)), j.reconstruct(j.h(Hj)))
    s = tbasis.StandardBasis(D)
    A = torch.from_numpy(np.random.default_rng(0).standard_normal((D, D)))
    assert s.h(A) is A and s.reconstruct(A) is A and s.n_coeff == D * D
    assert tbasis.basis_transmission_bits(s) == 0.0


def test_make_bases_errors(fleet):
    """An unknown name raises KeyError; ``eigen`` (ported) builds one
    shared eigenbasis for the fleet."""
    _, tclients, _ = fleet
    eig = tbasis.make_bases("eigen", tclients)
    assert len(eig) == N and all(b is eig[0] for b in eig)
    assert isinstance(eig[0], tbasis.EigenBasis)
    with pytest.raises(KeyError):
        tbasis.make_bases("no_such_basis", tclients)
    assert all(isinstance(b, tbasis.StandardBasis)
               for b in tbasis.make_bases("standard", tclients))


def test_batched_basis_bit_accounting_is_exact(fleet, bases):
    _, tclients, _ = fleet
    _, jbb, tbb = bases
    for fn in ("grad_uplink_bits_mean", "transmission_bits_mean", "coeff_count_mean"):
        assert getattr(tbb, fn)() == getattr(jbb, fn)()
    for exact in (True, False):
        assert tbb.init_coeff_bits_mean(exact) == jbb.init_coeff_bits_mean(exact)
    std = tcb.stack_bases(tbasis.make_bases("standard", tclients))
    jstd = jcb.stack_bases([jbasis.StandardBasis(D)] * N)
    assert std.kind == "standard"
    assert std.grad_uplink_bits_mean() == jstd.grad_uplink_bits_mean()
    assert std.transmission_bits_mean() == jstd.transmission_bits_mean()


def test_stack_bases_pads_and_refuses_mixed_kinds(fleet):
    _, tclients, _ = fleet
    tb = tbasis.make_bases("data_outer", tclients)
    short = tbasis.DataOuterBasis(V=tb[0].V[:, :-2])
    bb = tcb.stack_bases([short] + tb[1:])
    assert bb.rs[0] == tb[0].r - 2 and bb.V.shape == (N, D, bb.r_max)
    assert torch.equal(bb.V[0, :, -2:], torch.zeros(D, 2, dtype=torch.float64))
    assert tcb.stack_bases([tbasis.StandardBasis(D)] + tb[1:]) is None


@pytest.mark.parametrize("fn", ["hess_coeff_target", "hess_coeff_block"])
def test_coefficient_targets_match_reference(batches, bases, fn):
    jb, tb, x = batches
    _, jbb, tbb = bases
    args_j, args_t = (jbb, jb, jnp.asarray(x)), (tbb, tb, torch.from_numpy(x))
    if fn == "hess_coeff_block":
        args_j += (jcb.basis_AV(jbb, jb),)
        args_t += (tcb.basis_AV(tbb, tb),)
        _close(args_t[-1], args_j[-1])
    _close(getattr(tcb, fn)(*args_t), getattr(jcb, fn)(*args_j))


def test_reconstruct_block_matches_reference(bases):
    _, jbb, tbb = bases
    G = np.random.default_rng(2).standard_normal((N, jbb.r_max, jbb.r_max))
    _close(tcb.reconstruct_block(tbb, torch.from_numpy(G)),
           jcb.reconstruct_block(jbb, jnp.asarray(G)))
    H = np.random.default_rng(3).standard_normal((N, D, D))
    _close(tbb.reconstruct(torch.from_numpy(H)), jbb.reconstruct(jnp.asarray(H)))
    _close(tbb.h(torch.from_numpy(H)), jbb.h(jnp.asarray(H)))


def test_proj_mu_matches_reference():
    A = np.random.default_rng(4).standard_normal((D, D))
    for mu in (1e-3, 0.5):
        _close(tbl.proj_mu(torch.from_numpy(A), mu), jbl.proj_mu(jnp.asarray(A), mu))


# --------------------------------------------------------------------------
# comm
# --------------------------------------------------------------------------
@pytest.mark.parametrize("wire_kw", [{}, {"float_bits": 32}, {"entry_bits": 3.5},
                                     {"float_bits": 16, "index_bits": 8}])
def test_price_is_exact(wire_kw):
    rng = np.random.default_rng(len(wire_kw))
    f, i, e = (rng.integers(0, 10**6, 5).astype(np.float64) for _ in range(3))
    tw, jw = tcomm.WireFormat(**wire_kw), jcomm.WireFormat(**wire_kw)
    t = tcomm.price(tw, tcomm.Counts(torch.from_numpy(f), torch.from_numpy(i),
                                     torch.from_numpy(e)))
    j = jcomm.price(jw, jcomm.Counts(jnp.asarray(f), jnp.asarray(i), jnp.asarray(e)))
    assert t.dtype == torch.float64
    np.testing.assert_array_equal(_np(t), np.asarray(j))
    # scalar counts broadcast, composed wires price leg by leg
    assert float(tcomm.price(tw, tcomm.Counts(floats=3.0))) == float(
        jcomm.price(jw, jcomm.Counts(floats=3.0)))
    pair = tcomm.price((tw, tw), (tcomm.Counts(floats=2.0), tcomm.Counts(indices=1.0)))
    assert float(pair) == 2.0 * tw.float_bits + tw.index_bits
    assert tcomm.with_float_bits(tw, 8) == tcomm.WireFormat(
        **{**wire_kw, "float_bits": 8})


def test_price_rejects_mismatched_composed_wire():
    w = tcomm.WireFormat()
    with pytest.raises(ValueError, match="every wire leg"):
        tcomm.price((w, w), (tcomm.Counts(floats=1.0),))


def test_ledger_accumulates_exactly():
    t = tcomm.CommLedger.create(hess_up=36864.0, basis_ship=184320.0)
    j = jcomm.CommLedger.create(hess_up=36864.0, basis_ship=184320.0)
    snaps = []
    for r in range(5):
        t = t.add(hess_up=torch.tensor(1536.0 * r, dtype=torch.float64),
                  grad_up=1536.0, model_down=7680.0)
        j = j.add(hess_up=jnp.asarray(1536.0 * r), grad_up=1536.0, model_down=7680.0)
        snaps.append(t)
        for leg in tcomm.CommLedger.LEGS:
            assert float(getattr(t, leg)) == float(getattr(j, leg))
        assert float(t.uplink) == float(j.uplink)
        assert float(t.downlink) == float(j.downlink)
    st = tcomm.CommLedger.stack(snaps)
    assert st.hess_up.shape == (5,) and float(st.grad_up[-1]) == 5 * 1536.0


# --------------------------------------------------------------------------
# compressors
# --------------------------------------------------------------------------
@pytest.mark.parametrize("shape,k", [((4, 6, 6), 6), ((4, 6, 6), 36), ((4, 6, 6), 50),
                                     ((3, 24), 5), ((2, 9, 9), 1)])
def test_topk_compress_matches_reference_bitwise(shape, k):
    x = np.random.default_rng(k).standard_normal(shape)
    x[0].flat[:3] = 0.25                   # a tie group inside the first row
    dense_t, c_t = tcomp.TopK(k=k).compress(None, torch.from_numpy(x))
    dense_j, c_j = jcomp.TopK(k=k).compress(None, jnp.asarray(x))
    assert dense_t.dtype == torch.float64
    np.testing.assert_array_equal(_np(dense_t), np.asarray(dense_j))
    for leg in ("floats", "indices", "entries"):
        np.testing.assert_array_equal(_np(torch.as_tensor(getattr(c_t, leg))),
                                      np.asarray(getattr(c_j, leg)))
    np.testing.assert_array_equal(_np(tcomm.price(tcomp.TopK(k=k).wire, c_t)),
                                  np.asarray(jcomm.price(jcomp.TopK(k=k).wire, c_j)))


def test_identity_compress_and_single_client_adapter_match_reference():
    x = np.random.default_rng(0).standard_normal((3, 5, 5))
    dense_t, c_t = tcomp.Identity().compress(None, torch.from_numpy(x))
    dense_j, c_j = jcomp.Identity().compress(None, jnp.asarray(x))
    np.testing.assert_array_equal(_np(dense_t), np.asarray(dense_j))
    np.testing.assert_array_equal(_np(c_t.floats), np.asarray(c_j.floats))
    v = x[0, 0]
    for comp_t, comp_j in ((tcomp.Identity(), jcomp.Identity()),
                           (tcomp.TopK(k=2), jcomp.TopK(k=2))):
        d_t, bits_t = comp_t(None, torch.from_numpy(v))
        d_j, bits_j = comp_j(None, jnp.asarray(v))
        np.testing.assert_array_equal(_np(d_t), np.asarray(d_j))
        assert float(bits_t) == float(bits_j)


def test_compressor_constants_match_reference():
    for t, j in ((tcomp.TopK(k=5), jcomp.TopK(k=5)), (tcomp.Identity(), jcomp.Identity())):
        assert (t.is_unbiased, t.omega, t.delta, t.deterministic) == (
            j.is_unbiased, j.omega, j.delta, j.deterministic)
        assert t.wire == tcomm.WireFormat() and j.wire == jcomm.WireFormat()
    assert tcomp.TopK(k=3) == tcomp.TopK(k=3) and hash(tcomp.TopK(k=3))
    assert tcomp.TopK(k=3) != tcomp.TopK(k=4)


def test_topk_symmetrize_is_not_ported():
    """The triangular-half codec is ported: on symmetric stacks with ties
    spanning the k-th key it keeps the reference's entries bitwise (the
    tie-break runs over the triangle's row-major order), mirrors them, and
    bills min(k, d(d+1)/2) floats and indices."""
    rng = np.random.default_rng(5)
    a = rng.integers(-3, 4, (3, 7, 7)).astype(np.float64)
    x = a + a.transpose(0, 2, 1)
    for k in (1, 5, 13, 28, 40):
        t_out, t_counts = tcomp.TopK(k=k, symmetrize=True).compress(None, torch.tensor(x))
        j_out, j_counts = jcomp.TopK(k=k, symmetrize=True).compress(None, jnp.asarray(x))
        np.testing.assert_array_equal(_np(t_out), np.asarray(j_out))
        np.testing.assert_array_equal(_np(tcomm.price(tcomm.WireFormat(), t_counts)),
                                      np.asarray(jcomm.price(jcomm.WireFormat(), j_counts)))


# --------------------------------------------------------------------------
# convert
# --------------------------------------------------------------------------
def test_problem_from_numpy_carries_the_reference_state(fleet, bases):
    jclients, _, x = fleet
    _, jbb, _ = bases
    A = np.stack([np.asarray(c.A) for c in jclients])
    b = np.stack([np.asarray(c.b) for c in jclients])
    p = convert.problem_from_numpy(A, b, 1e-3, np.asarray(jbb.V), jbb.rs,
                                   np.zeros(D), x, device="cpu")
    np.testing.assert_array_equal(_np(p.batch.A), A)
    np.testing.assert_array_equal(_np(p.basisb.V), np.asarray(jbb.V))
    assert p.basisb.rs == tuple(jbb.rs) and len(p.clients) == len(p.bases) == N
    for i, r in enumerate(jbb.rs):
        np.testing.assert_array_equal(_np(p.bases[i].V), np.asarray(jbb.V)[i, :, :r])
    np.testing.assert_array_equal(_np(p.x_star), x)
    with pytest.raises(ValueError, match="inconsistent shapes"):
        convert.problem_from_numpy(A, b, 1e-3, np.asarray(jbb.V)[:, :-1], jbb.rs,
                                   np.zeros(D), x, device="cpu")
