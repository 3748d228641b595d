"""BL1 end to end: the port (`repro_torch.core.bl.bl1`) against the
reference package and against the committed fig1r1 artifact, on the CPU.

Gaps must agree to |Δ| ≤ 1e-8·|ref| + 1e-12: the reference's own rerun of
fig1r1 on one CPU differs from its artifact by up to 5.3e-16 absolute,
which at the 5e-13 tail is 1.7e-4 relative, so a purely relative bound
cannot hold even for the reference.  Every bit stream must agree exactly.
"""
import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bl as jbl
from repro.core import client_batch as jcb
from repro.core import compressors as jcomp
from repro.core import glm as jglm
from repro.core.basis import make_bases as jmake_bases
from repro_torch.core import batched, rounds
from repro_torch.core import bl as tbl
from repro_torch.core import compressors as tcomp
from repro_torch.core.convert import problem_from_numpy
from repro_torch.exp import problems

GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
REPO = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_same_history(h, ref_gaps, ref_up, ref_down, ref_legs=None):
    g, gr = np.asarray(h.gaps), np.asarray(ref_gaps)
    assert g.shape == gr.shape and np.all(np.isfinite(g))
    bad = np.abs(g - gr) > GAP_RTOL * np.abs(gr) + GAP_ATOL
    assert not bad.any(), f"gaps {g} vs reference {gr}"
    assert list(h.up_bits) == list(ref_up)
    assert list(h.down_bits) == list(ref_down)
    if ref_legs is not None:
        assert sorted(h.legs) == sorted(ref_legs)
        for leg, stream in ref_legs.items():
            assert list(h.legs[leg]) == list(stream), leg


@pytest.fixture(scope="module")
def small():
    """n=4, m=20, d=24, r=6 in the reference, and the same problem in the
    port through `problem_from_numpy` (identical basis and optimum)."""
    clients = jglm.make_synthetic(seed=1, n_clients=4, m=20, d=24, r=6, lam=1e-3)
    x0 = jnp.zeros(24, jnp.float64)
    x_star = jglm.newton_solve(clients, x0, 20)
    jbases = jmake_bases("data_outer", clients)
    jbb = jcb.stack_bases(jbases)
    port = problem_from_numpy(
        np.stack([np.asarray(c.A) for c in clients]),
        np.stack([np.asarray(c.b) for c in clients]), 1e-3,
        np.asarray(jbb.V), jbb.rs, np.asarray(x0), np.asarray(x_star), device="cpu")
    return clients, jbases, x0, x_star, port


# k=6 = r keeps coefficient state in (n, r, r) blocks; k=40 > r² takes the
# full (n, d, d) layout through the basis projection; the standard basis
# (BL1 ≡ FedNL) takes the full layout with no analytic ridge
@pytest.mark.parametrize("basis,k,block", [("data_outer", 6, True),
                                           ("data_outer", 40, False),
                                           ("standard", 24, False)])
def test_bl1_small_problem_matches_reference(small, basis, k, block):
    clients, jbases, x0, x_star, port = small
    steps = 6
    if basis == "standard":
        from repro.core.basis import StandardBasis as JStd
        from repro_torch.core.basis import StandardBasis as TStd

        jb, tb = [JStd(24)] * 4, [TStd(24)] * 4
    else:
        jb, tb = jbases, port.bases
    ref = jbl.bl1(clients, jb, [jcomp.TopK(k=k)] * 4, jcomp.Identity(), x0, x_star,
                  steps, backend="fast")
    spec, _, _ = batched.bl1_setup(port.clients, tb, [tcomp.TopK(k=k)] * 4,
                                   tcomp.Identity())
    assert spec.block is block
    h = tbl.bl1(port.clients, tb, [tcomp.TopK(k=k)] * 4, tcomp.Identity(), port.x0,
                port.x_star, steps, backend="fast", device="cpu")
    assert_same_history(h, ref.gaps, ref.up_bits, ref.down_bits, ref.legs)
    assert h.metrics is None


def test_bl1_auto_backend_and_options_match_reference(small):
    """backend='auto' runs the port's fast path; α, η, μ and a zero
    initial Hessian go through unchanged."""
    clients, jbases, x0, x_star, port = small
    kw = dict(alpha=0.5, eta=0.9, mu=2e-3, init_exact_hessian=False)
    ref = jbl.bl1(clients, jbases, [jcomp.TopK(k=6)] * 4, jcomp.Identity(), x0,
                  x_star, 5, backend="fast", **kw)
    h = tbl.bl1(port.clients, port.bases, [tcomp.TopK(k=6)] * 4, tcomp.Identity(),
                port.x0, port.x_star, 5, backend="auto", device="cpu", **kw)
    assert_same_history(h, ref.gaps, ref.up_bits, ref.down_bits, ref.legs)


def test_fig1r1_from_port_problem_matches_artifact():
    """The port's own make_synthetic + make_bases + newton_solve against the
    committed results/exp/fig1r1/BL1.seed0.json."""
    cell = problems.FIG1R1
    assert cell.artifact == REPO / "results" / "exp" / "fig1r1" / "BL1.seed0.json"
    art = json.loads(cell.artifact.read_text())
    cfg = art["config"]
    assert cfg["problem"]["n_clients"] == cell.problem.n_clients
    assert (cfg["problem"]["d"], cfg["problem"]["r"]) == (cell.problem.d, cell.problem.r)
    assert cfg["cell"] == json.loads(json.dumps(dataclasses.asdict(cell.cell)))
    assert cfg["steps"] == cell.steps
    prob = problems.build_problem(cell.problem, device="cpu")
    h = problems.run_cell(cell, prob)
    ref = art["history"]
    assert_same_history(h, ref["gaps"], ref["up_bits"], ref["down_bits"], ref["legs"])


def test_fig1_xl_cell_matches_its_artifact_config():
    """The full-width cell the card runs is the registered one (its run is
    in chip_smoke.py; it is too large for this CPU)."""
    cell = problems.FIG1_XL
    cfg = json.loads(cell.artifact.read_text())["config"]
    p = cfg["problem"]
    assert (p["n_clients"], p["m"], p["d"], p["r"], p["lam"], p["newton_iters"],
            p["solver"]) == (cell.problem.n_clients, cell.problem.m, cell.problem.d,
                             cell.problem.r, cell.problem.lam,
                             cell.problem.newton_iters, cell.problem.solver)
    assert cfg["cell"]["hess_comp"] == {"kind": "topk", "k": 1024, "r": 0, "s": 0,
                                        "p": 0.0, "symmetrize": False}
    assert cfg["cell"] == json.loads(json.dumps(dataclasses.asdict(cell.cell)))
    assert cfg["steps"] == cell.steps and cfg["cell"]["basis"] == cell.basis


# --------------------------------------------------------------------------
# error paths
# --------------------------------------------------------------------------
def _args(port, steps=2):
    return (port.clients, port.bases, [tcomp.TopK(k=6)] * 4, tcomp.Identity(),
            port.x0, port.x_star, steps)


def test_unknown_backend_raises_value_error(small):
    with pytest.raises(ValueError, match="backend must be one of"):
        tbl.bl1(*_args(small[-1]), backend="fastest", device="cpu")


@pytest.mark.parametrize("backend,item", [("reference", "17"), ("fast+sharded", "13")])
def test_unported_backends_raise_naming_roadmap_item(small, backend, item):
    if backend == "fast+sharded":
        # item 13 is ported: one process is a one-rank world, bitwise "fast"
        assert tbl.bl1(*_args(small[-1]), backend=backend, device="cpu") == \
            tbl.bl1(*_args(small[-1]), backend="fast", device="cpu")
        return
    # item 17 is ported: the reference's loop, held to the JAX package's
    clients, jbases, x0, x_star, port = small
    h = tbl.bl1(*_args(port), backend=backend, device="cpu")
    ref = jbl.bl1(clients, jbases, [jcomp.TopK(k=6)] * 4, jcomp.Identity(), x0, x_star, 2,
                  backend=backend)
    assert h.legs is None
    assert_same_history(h, ref.gaps, ref.up_bits, ref.down_bits)


def test_p_below_one_raises_until_prng_port(small):
    """Since the PRNG port (ROADMAP.md §1 item 9) p < 1 no longer raises:
    BL1 draws its fleet-wide ξ from the round keys, as the reference
    does (fig5/BL1-BC runs p = 0.5 at seed 3)."""
    clients, jbases, x0, x_star, port = small
    import jax

    with jax.threefry_partitionable(False):
        ref = jbl.bl1(clients, jbases, [jcomp.TopK(k=6)] * 4, jcomp.TopK(k=6), x0, x_star,
                      8, p=0.5, seed=3, backend="fast")
    h = tbl.bl1(port.clients, port.bases, [tcomp.TopK(k=6)] * 4, tcomp.TopK(k=6), port.x0,
                port.x_star, 8, p=0.5, seed=3, device="cpu")
    assert_same_history(h, ref.gaps, ref.up_bits, ref.down_bits, ref.legs)
    steps = np.diff(h.legs["grad_up"])
    assert (steps == 0).any() and (steps > 0).any()       # ξ drew both ways


def test_symmetrized_topk_raises(small):
    """Since the triangular-half codec is ported, BL1 with a symmetrized
    Top-K runs (in the full layout: block mode refuses the codec) and
    matches the reference, bits exact."""
    clients, jbases, x0, x_star, port = small
    ref = jbl.bl1(clients, jbases, [jcomp.TopK(k=30, symmetrize=True)] * 4, jcomp.TopK(k=8),
                  x0, x_star, 6, backend="fast")
    comp = tcomp.TopK(k=30, symmetrize=True)
    assert not batched._block_mode(batched.client_batch.stack_bases(port.bases), comp)
    h = tbl.bl1(port.clients, port.bases, [comp] * 4, tcomp.TopK(k=8), port.x0,
                port.x_star, 6, device="cpu")
    assert_same_history(h, ref.gaps, ref.up_bits, ref.down_bits, ref.legs)


def test_fleet_the_fast_path_cannot_stack(small):
    """Heterogeneous compressors: 'fast' raises FastPathUnavailable, 'auto'
    falls back to the reference loops: bit for bit an explicit 'reference'
    run, and the JAX package's 'auto' in the GLM gate."""
    clients, jbases, x0, x_star, port = small
    mixed = [tcomp.TopK(k=6)] * 3 + [tcomp.TopK(k=5)]
    args = (port.clients, port.bases, mixed, tcomp.Identity(), port.x0, port.x_star, 2)
    with pytest.raises(batched.FastPathUnavailable):
        tbl.bl1(*args, backend="fast", device="cpu")
    auto = tbl.bl1(*args, backend="auto", device="cpu")
    ref = tbl.bl1(*args, backend="reference", device="cpu")
    assert (auto.gaps, auto.up_bits, auto.down_bits) == (ref.gaps, ref.up_bits, ref.down_bits)
    jauto = jbl.bl1(clients, jbases, [jcomp.TopK(k=6)] * 3 + [jcomp.TopK(k=5)],
                    jcomp.Identity(), x0, x_star, 2, backend="auto")
    assert_same_history(auto, jauto.gaps, jauto.up_bits, jauto.down_bits)


def test_run_rounds_options_not_ported_raise(small):
    port = small[-1]
    spec, batch, basisb = batched.bl1_setup(port.clients, port.bases,
                                            [tcomp.TopK(k=6)] * 4, tcomp.Identity())
    f_star = torch.tensor(0.0, dtype=torch.float64)
    # the sharded reducer (ROADMAP.md §1 item 13) on a one-rank world: the
    # reference's one-device mesh, bitwise the single-device run
    ev_s, led_s = rounds.run_rounds(spec, batch, basisb, port.x0, f_star, 2, sharded=True)
    ev_v, led_v = rounds.run_rounds(spec, batch, basisb, port.x0, f_star, 2)
    assert torch.equal(ev_s["gap"], ev_v["gap"])
    assert all(torch.equal(getattr(led_s, leg), getattr(led_v, leg))
               for leg in led_v.LEGS)
    # the stream hook is ported (the experiment layer): it fires every round
    # here and leaves the run bitwise as it is without it
    seen = []
    hook = rounds.StreamHook(every=1, callback=lambda t, x, led: seen.append(t))
    with_hook = rounds.run_rounds(spec, batch, basisb, port.x0, f_star, 2, stream=hook)
    plain = rounds.run_rounds(spec, batch, basisb, port.x0, f_star, 2)
    assert seen == [0, 1]
    assert torch.equal(with_hook[0]["gap"], plain[0]["gap"])
    with pytest.raises(ValueError, match="steps"):
        rounds.run_rounds(spec, batch, basisb, port.x0, f_star, 0)
