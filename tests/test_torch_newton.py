"""Newton (`repro_torch.core.baselines.newton`), FedNL (BL1 in the standard
basis with `RankR`) and the float32 Γ route against the reference package
and the committed artifacts, on the CPU.

The float64 cells must agree with their artifacts to |Δ| ≤ 1e-8·|ref| +
1e-12, as BL1 does (tests/test_torch_bl1.py), with every bit stream
exact.  The kernel route computes Γ = VᵀAV in float32 (the reference's
``REPRO_BL_PALLAS=1`` route), which leaves that envelope: the reference's
own f32 run differs from its f64 artifact by 2.4e-10 at a 4.1e-3 gap.  It
is held to |Δ| ≤ 2e-6·|ref| + 1e-12, the envelope the reference's f32
route keeps with a 4x margin on a 16-client fleet at fig1-xl's widths;
its bits are the f64 route's, exactly.
"""
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

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
from repro.core.basis import make_bases as jmake_bases
from repro_torch.core import baselines, batched
from repro_torch.core import bl as tbl
from repro_torch.core import compressors as tcomp
from repro_torch.core.basis import StandardBasis as TStd
from repro_torch.core.convert import problem_from_numpy
from repro_torch.exp import problems
from repro_torch.kernels import tiled_matmul as tm

GAP_RTOL, F32_GAP_RTOL, GAP_ATOL = 1e-8, 2e-6, 1e-12
REPO = pathlib.Path(__file__).resolve().parents[1]
F64_CELLS = [problems.FIG1R1_CELLS["Newton"], problems.FIG1R1_CELLS["FedNL"],
             problems.FIG2["newton_std"], problems.FIG2["newton_basis"]]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def assert_history(h, ref: dict, rtol: float = GAP_RTOL) -> None:
    g, gr = np.asarray(h.gaps), np.asarray(ref["gaps"])
    assert g.shape == gr.shape and np.all(np.isfinite(g))
    bad = np.abs(g - gr) > rtol * np.abs(gr) + GAP_ATOL
    assert not bad.any(), f"gaps {g} vs reference {gr}"
    assert list(h.up_bits) == list(ref["up_bits"])
    assert list(h.down_bits) == list(ref["down_bits"])
    assert sorted(h.legs) == sorted(ref["legs"])
    for leg, stream in ref["legs"].items():
        assert list(h.legs[leg]) == list(stream), leg


def _artifact(cell) -> dict:
    return json.loads(cell.artifact.read_text())


@pytest.fixture(scope="module")
def fig_problem():
    """fig1r1's and fig2's problem, built by the port."""
    return problems.build_problem(problems.ProblemSpec(), device="cpu")


@pytest.mark.parametrize("cell", F64_CELLS, ids=lambda c: f"{c.experiment}/{c.name}")
def test_f64_cell_matches_artifact(fig_problem, cell):
    art = _artifact(cell)
    cfg = art["config"]
    assert (cfg["cell"]["method"], cfg["cell"]["basis"], cfg["steps"]) == (
        cell.method, cell.basis, cell.steps)
    if cell.hess_comp is not None:
        assert cfg["cell"]["hess_comp"] == dataclasses.asdict(cell.hess_comp)
        assert cfg["cell"]["params"] == []       # α = η = p = 1 and an Identity model
        assert cfg["cell"]["model_comp"]["kind"] == "identity"
    assert cfg["problem"]["n_clients"] == fig_problem.spec.n_clients
    assert (cfg["problem"]["d"], cfg["problem"]["r"]) == (fig_problem.spec.d,
                                                          fig_problem.spec.r)
    assert_history(problems.run_cell(cell, fig_problem), art["history"])


def test_kernel_route_matches_artifact_and_counts_no_launch_on_cpu(fig_problem):
    cell = problems.FIG2["newton_basis"]
    before = tm.launches
    h = problems.run_cell(cell, fig_problem, basis_project="kernel")
    assert tm.launches == before             # CPU tensors take the plain version
    assert_history(h, _artifact(cell)["history"], rtol=F32_GAP_RTOL)
    # the f32 route really runs: it is not the f64 trajectory bit for bit
    h64 = problems.run_cell(cell, fig_problem)
    assert h.gaps != h64.gaps


_PALLAS_RUN = """
import json
from repro.exp import engine, registry
exp = registry.get_experiment("fig2")
cell = next(c for c in exp.cells if c.name == "newton_basis")
h = engine.run_cell(exp, cell, engine.build_problem(exp.problem))
print(json.dumps({"gaps": h.gaps, "up_bits": h.up_bits, "down_bits": h.down_bits,
                  "legs": h.legs}))
"""


def test_kernel_route_matches_reference_pallas_route(fig_problem):
    """fig2/newton_basis with Γ in float32 against the reference's
    ``REPRO_BL_PALLAS=1`` run (Pallas in interpret mode), in a subprocess:
    the flag is read when the reference traces."""
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "REPRO_BL_PALLAS": "1",
           "PYTHONPATH": str(REPO / "src")}
    proc = subprocess.run([sys.executable, "-c", _PALLAS_RUN], capture_output=True,
                          text=True, timeout=600, env=env, cwd=REPO)
    assert proc.returncode == 0, proc.stderr[-3000:]
    ref = json.loads(proc.stdout.strip().splitlines()[-1])
    h = problems.run_cell(problems.FIG2["newton_basis"], fig_problem, basis_project="kernel")
    assert_history(h, ref, rtol=F32_GAP_RTOL)


# --------------------------------------------------------------------------
# small fleets against the reference in process
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def small():
    """n=4, m=20, d=24, r=6 in the reference, and the same problem in the
    port through `problem_from_numpy` (identical basis and optimum)."""
    clients = jglm.make_synthetic(seed=2, n_clients=4, m=20, d=24, r=6, lam=1e-3)
    x0 = jnp.zeros(24, jnp.float64)
    x_star = jglm.newton_solve(clients, x0, 20)
    jbases = jmake_bases("data_outer", clients)
    jbb = jcb.stack_bases(jbases)
    port = problem_from_numpy(
        np.stack([np.asarray(c.A) for c in clients]),
        np.stack([np.asarray(c.b) for c in clients]), 1e-3,
        np.asarray(jbb.V), jbb.rs, np.asarray(x0), np.asarray(x_star), device="cpu")
    return clients, jbases, x0, x_star, port


@pytest.mark.parametrize("with_basis", [False, True], ids=["no_basis", "data_basis"])
def test_newton_matches_reference_fast_path(small, with_basis):
    clients, jbases, x0, x_star, port = small
    ref = jbaselines.newton(clients, x0, x_star, 6, bases=jbases if with_basis else None,
                            backend="fast")
    h = baselines.newton(port.clients, port.x0, port.x_star, 6,
                         bases=port.bases if with_basis else None, device="cpu")
    assert_history(h, {"gaps": ref.gaps, "up_bits": ref.up_bits,
                       "down_bits": ref.down_bits, "legs": ref.legs})


def test_fednl_matches_reference_fast_path(small):
    """BL1 in the standard basis with a Rank-1 Hessian compressor (FedNL)."""
    clients, _, x0, x_star, port = small
    ref = jbl.bl1(clients, [JStd(24)] * 4, [jcomp.RankR(r=1)] * 4, jcomp.Identity(), x0,
                  x_star, 6, backend="fast")
    spec, _, _ = batched.bl1_setup(port.clients, [TStd(24)] * 4, [tcomp.RankR(r=1)] * 4,
                                   tcomp.Identity())
    assert spec.block is False
    h = tbl.bl1(port.clients, [TStd(24)] * 4, [tcomp.RankR(r=1)] * 4, tcomp.Identity(),
                port.x0, port.x_star, 6, device="cpu")
    assert_history(h, {"gaps": ref.gaps, "up_bits": ref.up_bits,
                       "down_bits": ref.down_bits, "legs": ref.legs})


def test_bl1_full_layout_kernel_route_stays_in_f32_envelope(small):
    """BL1 in the data basis with k > r² keeps full (n, d, d) coefficients
    and so projects through Γ: the kernel route stays within the f32
    envelope of the f64 route, with the same bits."""
    _, _, _, _, port = small
    args = (port.clients, port.bases, [tcomp.TopK(k=40)] * 4, tcomp.Identity(), port.x0,
            port.x_star, 6)
    h64 = tbl.bl1(*args, device="cpu")
    h32 = tbl.bl1(*args, device="cpu", basis_project="kernel")
    assert_history(h32, {"gaps": h64.gaps, "up_bits": h64.up_bits,
                         "down_bits": h64.down_bits, "legs": h64.legs}, rtol=F32_GAP_RTOL)


@pytest.mark.parametrize("shape", [(5, 12, 12), (3, 9, 14)], ids=["symmetric", "rect"])
@pytest.mark.parametrize("r", [1, 3])
def test_rankr_matches_reference(shape, r):
    """The rank-r product (unique when σ_r > σ_{r+1}; the factors are not)
    and the counts of the reference's `RankR.compress`."""
    rng = np.random.default_rng(sum(shape) + r)
    x = rng.standard_normal(shape)
    if shape[1] == shape[2]:
        x = (x + x.transpose(0, 2, 1)) / 2
    out, counts = tcomp.RankR(r=r).compress(None, torch.from_numpy(x))
    jout, jcounts = jcomp.RankR(r=r).compress(None, jnp.asarray(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=0, atol=1e-12)
    np.testing.assert_array_equal(counts.floats.numpy(), np.asarray(jcounts.floats))
    assert counts.floats.numpy()[0] == r * (shape[1] + shape[2] + 1)
    if shape[1] == shape[2]:
        np.testing.assert_allclose(out.numpy(), out.numpy().transpose(0, 2, 1), atol=1e-12)


def test_rankr_needs_a_stack_of_matrices():
    with pytest.raises(ValueError, match="stack of matrices"):
        tcomp.RankR(r=1).compress(None, torch.ones((3, 4)))


# --------------------------------------------------------------------------
# error paths
# --------------------------------------------------------------------------
def _newton_args(port):
    return (port.clients, port.x0, port.x_star, 2)


@pytest.mark.parametrize("backend,item", [("reference", "17"), ("fast+sharded", "13")])
def test_unported_backends_raise_naming_roadmap_item(small, backend, item):
    if backend == "fast+sharded":
        # item 13 is ported: one process is a one-rank world, bitwise "fast"
        assert baselines.newton(*_newton_args(small[-1]), backend=backend, device="cpu") == \
            baselines.newton(*_newton_args(small[-1]), backend="fast", device="cpu")
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md §1 item {item}"):
        baselines.newton(*_newton_args(small[-1]), backend=backend, device="cpu")


def test_unknown_backend_and_route_raise_value_error(small):
    port = small[-1]
    with pytest.raises(ValueError, match="backend must be one of"):
        baselines.newton(*_newton_args(port), backend="fastest", device="cpu")
    with pytest.raises(ValueError, match="basis_project must be one of"):
        baselines.newton(*_newton_args(port), bases=port.bases, device="cpu",
                         basis_project="pallas")
    with pytest.raises(ValueError, match="basis_project must be one of"):
        tbl.bl1(port.clients, port.bases, [tcomp.TopK(k=6)] * 4, tcomp.Identity(),
                port.x0, port.x_star, 2, device="cpu", basis_project="f32")


def test_newton_with_a_basis_that_is_not_the_data_basis(small):
    """Bases of another kind: 'fast' raises FastPathUnavailable, 'auto'
    (whose reference fallback is not ported) raises NotImplementedError."""
    port = small[-1]
    std = [TStd(24)] * 4
    with pytest.raises(batched.FastPathUnavailable, match="DataOuterBasis"):
        baselines.newton(*_newton_args(port), bases=std, backend="fast", device="cpu")
    with pytest.raises(NotImplementedError, match="item 17"):
        baselines.newton(*_newton_args(port), bases=std, backend="auto", device="cpu")
