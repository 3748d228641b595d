"""The first-order baselines (GD, DIANA, ADIANA, Local-GD, DORE) and
FedNL-BAG: the port (`repro_torch.core.baselines`) against the JAX package
in-process on a small fleet, and the ten artifact cells of fig1r2, fig5
(FedNL-BC, DORE) and fig1-bag (`problems.BASELINE_CELLS`) against their
committed artifacts, on the CPU.

Draws are jax's bit for bit (`repro_torch.core.prng`), so every run is
held to the GLM gate: gaps within |Δ| ≤ 1e-8·|ref| + 1e-12 and every bit
stream exact.  Runs that draw are held under both settings of
``jax_threefry_partitionable``; the artifacts were written under False.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbase
from repro.core import compressors as jcomp
from repro.core import glm as jglm
from repro.core.basis import make_bases as jmake_bases
from repro_torch.core import baselines as tbase
from repro_torch.core import compressors as tcomp
from repro_torch.core import glm as tglm
from repro_torch.core import prng
from repro_torch.core.basis import DataOuterBasis
from repro_torch.core.basis import make_bases as tmake_bases
from repro_torch.exp import problems

GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
N, M, D, R = 6, 20, 24, 6
FLAGS = (False, True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_same_history(h, ref):
    """Gaps within the GLM gate, every bit stream exact; a reference
    without ledger legs (its op-by-op loops) needs a history without."""
    g, gr = np.asarray(h.gaps), np.asarray(ref.gaps)
    assert g.shape == gr.shape and np.all(np.isfinite(g))
    ok = np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL
    assert ok.all(), f"gaps leave the gate at rounds {np.nonzero(~ok)[0].tolist()}: {g} vs {gr}"
    assert list(h.up_bits) == list(ref.up_bits)
    assert list(h.down_bits) == list(ref.down_bits)
    assert h.legs == ref.legs


@pytest.fixture(scope="module")
def small():
    """The small fleet of `test_torch_bl2.py` (n=6, m=20, d=24, r=6) in both
    packages, with the reference's optimum."""
    jc = jglm.make_synthetic(seed=2, n_clients=N, m=M, d=D, r=R, lam=1e-3)
    tc = tglm.make_synthetic(seed=2, n_clients=N, m=M, d=D, r=R, lam=1e-3, device="cpu")
    x0 = jnp.zeros(D, jnp.float64)
    x_star = jglm.newton_solve(jc, x0, 20)
    return jc, x0, x_star, tc, torch.zeros(D, dtype=torch.float64), \
        torch.tensor(np.asarray(x_star))


def _run(small, jfn, tfn, *args, flag=False, **kw):
    jc, x0, xs, tc, tx0, txs = small
    jargs = [a[0] if isinstance(a, tuple) else a for a in args]
    targs = [a[1] if isinstance(a, tuple) else a for a in args]
    with jax.threefry_partitionable(flag):
        ref = jfn(jc, x0, xs, *jargs, **kw)
    with prng.threefry_partitionable(flag):
        h = tfn(tc, tx0, txs, *targs, device="cpu", **kw)
    return h, ref


def test_smoothness_constant_matches_reference(small):
    jc, _, _, tc, _, _ = small
    assert tbase.smoothness_constant(tc) == pytest.approx(jbase.smoothness_constant(jc),
                                                          rel=1e-13)


@pytest.mark.parametrize("lr", [None, 0.5])
def test_gd_matches_reference(small, lr):
    h, ref = _run(small, jbase.gd, tbase.gd, 8, lr=lr, backend="fast")
    assert_same_history(h, ref)


def _dither(s):
    return jcomp.RandomDithering(s=s), tcomp.RandomDithering(s=s)


@pytest.mark.parametrize("flag", FLAGS)
def test_diana_matches_reference(small, flag):
    jcm, tcm = _dither(3)
    h, ref = _run(small, jbase.diana, tbase.diana, 8, (jcm, tcm), jcm.omega_for(D),
                  flag=flag, seed=4, backend="fast")
    assert_same_history(h, ref)


def test_diana_draws_nothing_with_a_deterministic_compressor(small):
    h, ref = _run(small, jbase.diana, tbase.diana, 6, (jcomp.TopK(k=5), tcomp.TopK(k=5)), 0.5,
                  lr=0.2, backend="fast")
    assert_same_history(h, ref)


@pytest.mark.parametrize("flag", FLAGS)
def test_adiana_matches_reference(small, flag):
    """ADIANA's key chain (n client keys for the xᵏ messages, n for the wᵏ
    messages, one for the Bernoulli draw) unrolled on the host."""
    jcm, tcm = _dither(4)
    h, ref = _run(small, jbase.adiana, tbase.adiana, 10, (jcm, tcm), jcm.omega_for(D),
                  flag=flag, seed=1)
    assert_same_history(h, ref)


@pytest.mark.parametrize("local_steps,lr", [(5, None), (2, 0.3)])
def test_local_gd_matches_reference(small, local_steps, lr):
    h, ref = _run(small, jbase.local_gd, tbase.local_gd, 6, local_steps=local_steps, lr=lr)
    assert_same_history(h, ref)


DORE_CASES = [("topk", ("TopK", 6), ("TopK", 6)),
              ("dither_up_randk_down", ("RandomDithering", 3), ("RandK", 5))]


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("name,up,down", DORE_CASES, ids=[c[0] for c in DORE_CASES])
def test_dore_matches_reference(small, name, up, down, flag):
    """Error feedback both ways, Top-K (no draw, the key chain kept) and
    stochastic codecs on both legs (the chain's keys used)."""
    comps = [(getattr(jcomp, c[0])(c[1]), getattr(tcomp, c[0])(c[1])) for c in (up, down)]
    h, ref = _run(small, jbase.dore_like, tbase.dore_like, 8, *comps, flag=flag, seed=2)
    assert_same_history(h, ref)


FEDNL_BAG_CASES = [("standard_rankr", "standard", ("RankR", 1), dict(q=0.5)),
                   ("standard_q1_eta1", "standard", ("RankR", 1), dict(q=1.0, eta=1.0)),
                   ("data_topk_block", "data_outer", ("TopK", 6), dict(q=0.3, alpha=0.8)),
                   ("data_topk_full", "data_outer", ("TopK", 40), dict(q=0.7))]


@pytest.mark.parametrize("flag", FLAGS)
@pytest.mark.parametrize("name,basis,comp,kw", FEDNL_BAG_CASES,
                         ids=[c[0] for c in FEDNL_BAG_CASES])
def test_fednl_bag_matches_reference(small, name, basis, comp, kw, flag):
    """FedNL-BAG's ``split(key_t, 2)`` and Bernoulli(q) report draws, in
    the standard basis (Rank-1) and the data basis (Top-K in blocks and in
    the full layout); its bits summed as the reference's compiled round."""
    jc, x0, xs, tc, tx0, txs = small
    jb = jmake_bases(basis, jc)
    if basis == "data_outer":
        tb = [DataOuterBasis(V=torch.tensor(np.asarray(b.V))) for b in jb]
    else:
        tb = tmake_bases(basis, tc)
    with jax.threefry_partitionable(flag):
        ref = jbase.fednl_bag(jc, jb, [getattr(jcomp, comp[0])(comp[1])] * N, x0, xs, 8,
                              seed=3, backend="fast", **kw)
    with prng.threefry_partitionable(flag):
        h = tbase.fednl_bag(tc, tb, [getattr(tcomp, comp[0])(comp[1])] * N, tx0, txs, 8,
                            seed=3, device="cpu", **kw)
    assert_same_history(h, ref)


def test_fednl_bag_errors(small):
    _, _, _, tc, tx0, txs = small
    args = (tc, tmake_bases("standard", tc), [tcomp.RankR(1)] * N, tx0, txs, 2)
    with pytest.raises(ValueError, match="spec-only"):
        tbase.fednl_bag(*args, backend="reference", device="cpu")
    # the sharded reducer (ROADMAP.md §1 item 13): one process is a one-rank
    # world, bitwise the fast path in both modes (exact is ignored off it)
    fast = tbase.fednl_bag(*args, device="cpu")
    for kw in ({"exact": False}, {"backend": "fast+sharded"},
               {"backend": "fast+sharded", "exact": False}):
        h = tbase.fednl_bag(*args, device="cpu", **kw)
        assert (h.gaps, h.up_bits, h.down_bits, h.legs) == \
            (fast.gaps, fast.up_bits, fast.down_bits, fast.legs), kw
    with pytest.raises(ValueError, match="stackable"):
        tbase.fednl_bag(*args[:2], [tcomp.RankR(1)] * (N - 1) + [tcomp.RankR(2)], *args[3:],
                        device="cpu")
    with pytest.raises(ValueError, match="backend"):
        tbase.gd(tc, tx0, txs, 2, backend="typo", device="cpu")


# --------------------------------------------------------------------------
# the artifact cells
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def paper():
    return problems.build_problem(problems.ProblemSpec(), device="cpu")


@pytest.mark.parametrize("cell", problems.BASELINE_CELLS,
                         ids=[f"{c.experiment}/{c.name}" for c in problems.BASELINE_CELLS])
def test_baseline_cell_matches_artifact(paper, cell):
    art = json.loads(cell.artifact.read_text())
    cfg = art["config"]
    assert cfg["problem"]["n_clients"] == cell.problem.n_clients and cfg["steps"] == cell.steps
    assert cfg["cell"]["method"] == cell.method
    assert cfg["cell"]["basis"] == cell.basis and dict(cfg["cell"]["params"]) == dict(cell.params)
    for leg in ("hess_comp", "model_comp"):
        want = getattr(cell, leg)
        assert cfg["cell"][leg] == (None if want is None else dataclasses.asdict(want))
    h = problems.run_cell(cell, paper)
    ref = art["history"]
    g, gr = np.asarray(h.gaps), np.asarray(ref["gaps"])
    assert np.all(np.abs(g - gr) <= GAP_RTOL * np.abs(gr) + GAP_ATOL), (g, gr)
    assert h.up_bits == ref["up_bits"] and h.down_bits == ref["down_bits"]
    assert h.legs == ref["legs"]


def test_baseline_cells_are_registered():
    """Every committed artifact of fig1r2 and fig1-bag, and fig5's FedNL-BC
    and DORE (its other three are stochastic cells, `test_torch_bl2.py`)."""
    names = {f"{c.experiment}/{c.name}" for c in problems.BASELINE_CELLS}
    assert len(names) == 10
    for exp in ("fig1r2", "fig1-bag"):
        on_disk = {f"{exp}/{p.name.split('.seed0')[0]}"
                   for p in (problems.REPO_ROOT / "results" / "exp" / exp).glob("*.seed0.json")}
        assert on_disk <= names
    stochastic = {f"{c.experiment}/{c.name}" for c in problems.STOCHASTIC_CELLS}
    fig5 = {f"fig5/{p.name.split('.seed0')[0]}"
            for p in (problems.REPO_ROOT / "results" / "exp" / "fig5").glob("*.seed0.json")}
    assert fig5 <= names | stochastic and not names & stochastic
