"""BL2, BL3, NL1 and the stochastic compressors: the port against the JAX
package in-process on a small fleet, and every stochastic GLM cell of the
paper's figures against its committed artifact, on the CPU.

Draws are jax's bit for bit (`repro_torch.core.prng`), so gaps must agree
to |Δ| ≤ 1e-8·|ref| + 1e-12 and every bit stream exactly, the bar of
`tests/test_torch_bl1.py`.  The reference runs under
``jax.threefry_partitionable(flag)`` and the port under
``prng.threefry_partitionable(flag)``: the committed artifacts were all
written under False.

A NaN in an artifact agrees only with a NaN in the same round, with one
exception named in `problems.REFERENCE_SVD_NAN`: fig1r3's RRankR and NRankR
end in a NaN that the reference's CPU SVD put there (LAPACK's gesdd does
not converge on one client's round-10 Hessian difference, and jax reports
the failure as NaN); the port's SVD converges, so at that round the port
must be finite and the artifact NaN, and every other round is held as
usual.
"""
import json

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
from repro.core import rounds as jrounds
from repro.core.basis import make_bases as jmake_bases
from repro_torch.core import baselines as tbase
from repro_torch.core import bl as tbl
from repro_torch.core import compressors as tcomp
from repro_torch.core import prng, rounds
from repro_torch.core.basis import make_bases as tmake_bases
from repro_torch.core.convert import problem_from_numpy
from repro_torch.exp import problems

GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
N, M, D, R = 6, 20, 24, 6


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_same_history(h, ref, nan_round=None):
    """Gaps within the GLM gate (NaN against NaN agrees; at ``nan_round``
    the artifact is NaN and the port finite), every bit stream exact."""
    g, gr = np.asarray(h.gaps), np.asarray(ref["gaps"])
    assert g.shape == gr.shape
    both = np.isnan(g) & np.isnan(gr)
    if nan_round is not None:
        assert np.isnan(gr[nan_round]) and np.isfinite(g[nan_round])
        both[nan_round] = True
    ok = both | (np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL)
    assert ok.all(), f"gaps leave the gate at rounds {np.nonzero(~ok)[0].tolist()}: {g} vs {gr}"
    assert list(h.up_bits) == list(ref["up_bits"])
    assert list(h.down_bits) == list(ref["down_bits"])
    if ref["legs"] is None:
        assert h.legs is None
    else:
        assert sorted(h.legs) == sorted(ref["legs"])
        for leg, stream in ref["legs"].items():
            assert list(h.legs[leg]) == list(stream), leg


def _ref(hist) -> dict:
    return {"gaps": hist.gaps, "up_bits": hist.up_bits, "down_bits": hist.down_bits,
            "legs": hist.legs}


@pytest.fixture(scope="module")
def small():
    """n=6, m=20, d=24, r=6 in the reference and the same problem in the
    port (identical data, basis and optimum)."""
    clients = jglm.make_synthetic(seed=2, n_clients=N, m=M, d=D, r=R, lam=1e-3)
    x0 = jnp.zeros(D, jnp.float64)
    x_star = jglm.newton_solve(clients, x0, 20)
    jbases = jmake_bases("data_outer", clients)
    jbb = jcb.stack_bases(jbases)
    port = problem_from_numpy(
        np.stack([np.asarray(c.A) for c in clients]),
        np.stack([np.asarray(c.b) for c in clients]), 1e-3,
        np.asarray(jbb.V), jbb.rs, np.asarray(x0), np.asarray(x_star), device="cpu")
    return clients, jbases, x0, x_star, port


def _bases(small, kind):
    clients, jbases, _, _, port = small
    if kind == "data_outer":
        return jbases, port.bases
    return jmake_bases(kind, clients), tmake_bases(kind, port.clients)


#: (name, basis, Hessian compressor, model compressor, kwargs): block-mode
#: Top-K, composed Top-K in block mode, the composed Rank-R codecs in the
#: standard basis (FedNL-PP), stochastic downlinks (Rand-K, dithering) and
#: a composed Top-K past r² (full layout)
BL2_CASES = [
    ("topk_block", "data_outer", ("TopK", 6), ("Identity",), dict(tau=3, p=1.0)),
    ("rtopk_block", "data_outer", ("rtopk", 6), ("TopK", 4), dict(tau=3, p=0.5)),
    ("rrankr_std", "standard", ("rrankr", 1, D), ("TopK", 4), dict(p=0.3)),
    ("nrankr_randk", "standard", ("nrankr", 1), ("RandK", 5), dict(tau=2)),
    ("ntopk_full_dither", "data_outer", ("ntopk", 40), ("RandomDithering", 3),
     dict(tau=4, p=0.5, alpha=0.8, eta=0.9)),
]


def _comp(mod, spec):
    name, *args = spec
    return getattr(mod, name)(*args)


def _run_bl2(small, basis, hc, mc, kw, steps=6, seed=1, flag=False):
    clients, _, x0, x_star, port = small
    jb, tb = _bases(small, basis)
    with jax.threefry_partitionable(flag):
        ref = jbl.bl2(clients, jb, [_comp(jcomp, hc)] * N, [_comp(jcomp, mc)] * N, x0,
                      x_star, steps, seed=seed, backend="fast", **kw)
    with prng.threefry_partitionable(flag):
        h = tbl.bl2(port.clients, tb, [_comp(tcomp, hc)] * N, [_comp(tcomp, mc)] * N,
                    port.x0, port.x_star, steps, seed=seed, backend="fast", device="cpu",
                    **kw)
    return h, ref


@pytest.mark.parametrize("name,basis,hc,mc,kw", BL2_CASES, ids=[c[0] for c in BL2_CASES])
def test_bl2_matches_reference(small, name, basis, hc, mc, kw):
    h, ref = _run_bl2(small, basis, hc, mc, kw)
    assert_same_history(h, _ref(ref))
    assert h.events is None and h.metrics is None


def test_bl2_partitionable_setting_matches_reference(small):
    """Under jax's own default (True) the draws, and so the run, change;
    the port follows."""
    name, basis, hc, mc, kw = BL2_CASES[1]
    h, ref = _run_bl2(small, basis, hc, mc, kw, flag=True)
    assert_same_history(h, _ref(ref))
    h_orig, _ = _run_bl2(small, basis, hc, mc, kw, steps=6)
    assert h_orig.up_bits != h.up_bits or h_orig.gaps != h.gaps


BL3_CASES = [
    ("topk_opt2", ("TopK", 24), ("Identity",), dict(tau=3, p=0.5)),
    ("topk_natural_opt1", ("TopK", 12), ("NaturalCompression",), dict(tau=2, option=1)),
]


@pytest.mark.parametrize("name,hc,mc,kw", BL3_CASES, ids=[c[0] for c in BL3_CASES])
def test_bl3_matches_reference(small, name, hc, mc, kw):
    clients, _, x0, x_star, port = small
    with jax.threefry_partitionable(False):
        ref = jbl.bl3(clients, [_comp(jcomp, hc)] * N, [_comp(jcomp, mc)] * N, x0, x_star,
                      6, seed=4, backend="fast", **kw)
    h = tbl.bl3(port.clients, [_comp(tcomp, hc)] * N, [_comp(tcomp, mc)] * N, port.x0,
                port.x_star, 6, seed=4, backend="auto", device="cpu", **kw)
    assert_same_history(h, _ref(ref))


def test_bl1_stochastic_model_stream_matches_reference(small):
    """BL1 with p < 1 and a dithered model stream (the single-client
    adapter's key)."""
    clients, jbases, x0, x_star, port = small
    with jax.threefry_partitionable(False):
        ref = jbl.bl1(clients, jbases, [jcomp.rtopk(6)] * N, jcomp.RandomDithering(s=4),
                      x0, x_star, 6, p=0.4, seed=5, backend="fast")
    h = tbl.bl1(port.clients, port.bases, [tcomp.rtopk(6)] * N, tcomp.RandomDithering(s=4),
                port.x0, port.x_star, 6, p=0.4, seed=5, device="cpu")
    assert_same_history(h, _ref(ref))


def test_nl1_matches_reference(small):
    clients, _, x0, x_star, port = small
    with jax.threefry_partitionable(False):
        ref = jbase.nl1(clients, x0, x_star, 5, k=2, seed=3)
    h = tbase.nl1(port.clients, port.x0, port.x_star, 5, k=2, seed=3, device="cpu")
    assert_same_history(h, _ref(ref))


# --------------------------------------------------------------------------
# the round engine's draws
# --------------------------------------------------------------------------
AVAIL = {"none": None, "all": [1] * 8, "some_down": [1, 0, 1, 1, 0, 1, 0, 1],
         "one_up": [0, 0, 0, 0, 0, 1, 0, 0], "all_down": [0] * 8}


@pytest.mark.parametrize("tau", [1, 3, 8, 20])
@pytest.mark.parametrize("avail", sorted(AVAIL))
def test_participation_matches_reference(avail, tau):
    jR, tR = jrounds.VmapReducer(n=8), rounds.VmapReducer(n=8)
    a = AVAIL[avail]
    for seed in range(6):
        with jax.threefry_partitionable(False):
            jm, je = jrounds.participation(jR, jax.random.PRNGKey(seed), tau,
                                           avail=None if a is None else jnp.asarray(a, bool))
        tm, te = rounds.participation(tR, prng.PRNGKey(seed), tau,
                                      avail=None if a is None else torch.tensor(a, dtype=torch.bool))
        assert np.asarray(jm).tolist() == tm.tolist()
        assert int(je) == int(te)


def test_participation_refuses_tau_below_one():
    with pytest.raises(ValueError, match="τ ≥ 1"):
        rounds.participation(rounds.VmapReducer(n=4), prng.PRNGKey(0), 0)


@pytest.mark.parametrize("p", [1.0, 0.3])
def test_xi_draws_match_reference(p):
    jR, tR = jrounds.VmapReducer(n=7), rounds.VmapReducer(n=7)
    for seed in range(4):
        with jax.threefry_partitionable(False):
            jm = jrounds.xi_mask(jR, jax.random.PRNGKey(seed), p)
            js = jrounds.xi_scalar(jax.random.PRNGKey(seed), p)
        assert np.asarray(jm).tolist() == rounds.xi_mask(tR, prng.PRNGKey(seed), p).tolist()
        assert bool(js) == bool(rounds.xi_scalar(prng.PRNGKey(seed), p))


def test_client_keys_match_reference():
    key = jax.random.PRNGKey(9)
    with jax.threefry_partitionable(False):
        want = np.asarray(jrounds.VmapReducer(n=5).client_keys(key)).astype(np.int64)
    assert rounds.VmapReducer(n=5).client_keys(prng.PRNGKey(9)).tolist() == want.tolist()


# --------------------------------------------------------------------------
# stochastic compressors, bitwise on the same keys and inputs
# --------------------------------------------------------------------------
def _keys(n, seed=0):
    with jax.threefry_partitionable(False):
        jk = jax.random.split(jax.random.PRNGKey(seed), n)
    return jk, torch.tensor(np.asarray(jk).astype(np.int64))


COMPRESSOR_CASES = [
    ("RandK", (5,), (4, 30)),
    ("RandK", (1,), (3, 60)),
    ("RandomDithering", (3,), (4, 25)),
    ("RandomDithering", (5, 1), (3, 8)),
    ("NaturalCompression", (), (4, 3, 7)),
    ("rtopk", (6,), (4, 6, 6)),
    ("ntopk", (9,), (5, 40)),
]


@pytest.mark.parametrize("name,args,shape", COMPRESSOR_CASES,
                         ids=[f"{c[0]}{c[1]}" for c in COMPRESSOR_CASES])
def test_stochastic_compressor_matches_reference(name, args, shape):
    """Same keys, same draws: every kept entry within 1e-14 relative (a
    flipped draw moves an entry by a whole level, 1/s of the norm or a
    factor of 2; what is left is an ulp of the norm's summation order or
    of XLA's exp2/log2), every dropped one exactly zero, bits exact."""
    x = np.random.default_rng(len(shape) + shape[-1]).standard_normal(shape)
    x[0, ..., :2] = 0.0                        # zeros take the where() branches
    if name == "RandomDithering" and shape[0] > 3:
        x[1] = 0.0                             # an all-zero row (norm 0)
    jk, tk = _keys(shape[0])
    jc, tc = getattr(jcomp, name)(*args), getattr(tcomp, name)(*args)
    with jax.threefry_partitionable(False):
        jout, jcounts = jc.compress(jk, jnp.asarray(x))
    tout, tcounts = tc.compress(tk, torch.tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=1e-14, atol=0)
    np.testing.assert_array_equal(np.asarray(jcomp.comm.price(jc.wire, jcounts)),
                                  tcomp.comm.price(tc.wire, tcounts).numpy())
    assert jc.deterministic == tc.deterministic is False


@pytest.mark.parametrize("kind", ["rrankr", "nrankr"])
def test_composed_rankr_matches_reference(kind):
    """Bits exact; the output within 1e-12 (the two libraries' SVDs agree
    to rounding, and both inner codecs are odd in their input)."""
    rng = np.random.default_rng(1)
    a = rng.standard_normal((3, 12, 12))
    x = np.concatenate([a[:2] + a[:2].transpose(0, 2, 1), a[2:]])   # symmetric and not
    jk, tk = _keys(3, seed=2)
    args = (2, 12) if kind == "rrankr" else (2,)
    jc, tc = getattr(jcomp, kind)(*args), getattr(tcomp, kind)(*args)
    with jax.threefry_partitionable(False):
        jout, jcounts = jc.compress(jk, jnp.asarray(x))
    tout, tcounts = tc.compress(tk, torch.tensor(x))
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(np.asarray(jcomp.comm.price(jc.wire, jcounts)),
                                  tcomp.comm.price(tc.wire, tcounts).numpy())


def test_stochastic_compressors_refuse_missing_keys():
    x = torch.ones((2, 5), dtype=torch.float64)
    for comp in (tcomp.RandK(2), tcomp.RandomDithering(3), tcomp.NaturalCompression(),
                 tcomp.rtopk(2), tcomp.rrankr(1, 5)):
        with pytest.raises(ValueError, match="stochastic"):
            comp.compress(None, x if not isinstance(comp, tcomp.ComposedRankR)
                          else torch.ones((2, 5, 5), dtype=torch.float64))


def test_composed_topk_selects_through_the_threshold_kernel(monkeypatch):
    """The composed codecs select with the shared keep-mask, one threshold
    call a compress."""
    from repro_torch.core import compressors as mod

    calls = []
    real = mod.topk_row_threshold
    monkeypatch.setattr(mod, "topk_row_threshold", lambda a, k: calls.append(k) or real(a, k))
    _, tk = _keys(4)
    tcomp.ntopk(7).compress(tk, torch.randn((4, 30), dtype=torch.float64))
    assert calls == [7]


# --------------------------------------------------------------------------
# the paper's stochastic cells against their committed artifacts
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def paper():
    return problems.build_problem(problems.ProblemSpec(), device="cpu")


@pytest.mark.parametrize("cell", problems.STOCHASTIC_CELLS,
                         ids=[f"{c.experiment}/{c.name}" for c in problems.STOCHASTIC_CELLS])
def test_stochastic_cell_matches_artifact(paper, cell):
    art = json.loads(cell.artifact.read_text())
    cfg = art["config"]
    assert cfg["problem"]["n_clients"] == cell.problem.n_clients and cfg["steps"] == cell.steps
    assert cfg["cell"]["method"] == cell.method and cfg["cell"]["basis"] == cell.basis
    assert dict(cfg["cell"]["params"]) == dict(cell.params)
    h = problems.run_cell(cell, paper)
    assert_same_history(h, art["history"],
                        problems.REFERENCE_SVD_NAN.get(f"{cell.experiment}/{cell.name}"))


def test_stochastic_cells_are_registered():
    """Twenty GLM cells here (fig-dnn/RTopK is in test_torch_bldnn.py):
    every committed artifact of fig1r3, fig3, fig4 and fig6, fig5's BL1-,
    BL2- and BL3-BC, and fig1r1/NL1."""
    names = {f"{c.experiment}/{c.name}" for c in problems.STOCHASTIC_CELLS}
    assert len(names) == 20 and "fig1r1/NL1" in names
    for exp in ("fig1r3", "fig3", "fig4", "fig6"):
        on_disk = {f"{exp}/{p.name.split('.seed0')[0]}"
                   for p in (problems.REPO_ROOT / "results" / "exp" / exp).glob("*.seed0.json")}
        assert on_disk <= names
    assert set(problems.REFERENCE_SVD_NAN) == {"fig1r3/RRankR", "fig1r3/NRankR"}


# --------------------------------------------------------------------------
# bl2-xl: the reference file the card's full-width run is held to
# --------------------------------------------------------------------------
def test_bl2_xl_reference_describes_the_cell():
    ref = json.loads(problems.BL2_XL_REFERENCE.read_text())
    cfg, cell = ref["config"], problems.BL2_XL
    p = cell.problem
    assert (cfg["n_clients"], cfg["m"], cfg["d"], cfg["r"], cfg["lam"]) == \
        (p.n_clients, p.m, p.d, p.r, p.lam)
    assert cfg["hess_comp"] == {"kind": cell.hess_comp.kind, "k": cell.hess_comp.k}
    assert cfg["model_comp"] == {"kind": cell.model_comp.kind} and cfg["steps"] == cell.steps
    assert dict(cell.params) == {"tau": cfg["tau"]} and ref["threefry_partitionable"] is False
    assert problems.BL2_XL_NARROW.problem.d == cfg["narrow_d"]
    assert [m.count("1") for m in ref["masks"]] == ref["participants"]


def test_bl2_xl_masks_are_the_ports_draws():
    """The port's participation draws at n = 512, τ = 256, from the keys
    BL2 splits each round, are the reference's masks."""
    ref = json.loads(problems.BL2_XL_REFERENCE.read_text())
    R = rounds.VmapReducer(n=512)
    keys = prng.split(prng.PRNGKey(0), 8)
    for t, want in enumerate(ref["masks"]):
        mask, event = rounds.participation(R, prng.split(keys[t], 4)[0], 256)
        assert "".join("1" if b else "0" for b in mask.tolist()) == want
        assert int(event) == rounds.EVENT_NONE


def test_bl2_xl_narrow_twin_matches_reference():
    """BL2 at n = 512, τ = 256 on the d = 40 fleet: gaps in the gate and
    every bit stream exact against the JAX package's run."""
    cell = problems.BL2_XL_NARROW
    prob = problems.build_problem(cell.problem, device="cpu")
    h = problems.run_cell(cell, prob)
    assert_same_history(h, json.loads(cell.artifact.read_text())["history"])
