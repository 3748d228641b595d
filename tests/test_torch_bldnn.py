"""BL-DNN in the port (`repro_torch.fed.bldnn`) against the reference
package and against the committed fig-dnn artifact, on the CPU.

Inputs are made with numpy (or by the reference, then carried across as
numpy arrays) and handed to both packages.  Tolerances and why:

  * selection, shipment quantization, basis factors, bit counts: bitwise;
  * float32 matrix products (rotations, the MLP): within 1e-6·max|ref| —
    torch and XLA call different gemms, which round differently;
  * trajectories: loss within 1e-4 relative, error rate equal, every bit
    stream exact.  Training is chaotic at the ulp level: a one-ulp shift of
    the initial weights moves the fig-dnn loss by up to 5.5e-7 relative in
    rounds 0–3 but by 8e-4 at round 6, so trajectories are held only over
    their first rounds.

Run as a script, this file writes the carried fig-dnn problem
(``src/repro_torch/exp/data/fig_dnn_seed0.npz``) with the reference,
under ``jax_threefry_partitionable=False`` — the setting the committed
fig-dnn artifacts were written under; with ``--envelope`` it prints, for
the reference alone, how far its own reruns stray from the artifacts
(per cell, per round), how far a one-ulp shift of the initial weights
moves them, and why the per-layer SVD basis has to be carried (a few
minutes on a CPU):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_bldnn.py [out.npz]
    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/test_torch_bldnn.py --envelope
"""
import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import basis as jbasis
from repro.core import client_batch as jcb
from repro.core import comm as jcomm
from repro.core import compressors as jcomp
from repro.core import rounds as jrounds
from repro.fed import bldnn as jbldnn
from repro_torch.core import basis as tbasis
from repro_torch.core import client_batch as tcb
from repro_torch.core import comm as tcomm
from repro_torch.core import prng as tprng
from repro_torch.core import compressors as tcomp
from repro_torch.core import rounds as trounds
from repro_torch.core.convert import dnn_problem_from_numpy
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.exp import engine as tengine
from repro_torch.exp import problems
from repro_torch.exp import registry as tregistry
from repro_torch.fed import bldnn as tbldnn
from repro_torch.kernels import basis_transform as tbt

REPO = pathlib.Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-4
MATMUL_TOL = 1e-6
#: rounds of the fig-dnn artifact the CPU run holds
ARTIFACT_ROUNDS = 4
#: both settings of jax_threefry_partitionable
SETTINGS_BOTH = (False, True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(a, b, tol=MATMUL_TOL):
    a, b = _np(a), _np(b)
    assert a.shape == b.shape
    np.testing.assert_allclose(a, b, rtol=0, atol=tol * float(np.max(np.abs(b))))


def _bitwise(a, b):
    a, b = np.ascontiguousarray(_np(a)), np.ascontiguousarray(_np(b))
    assert a.shape == b.shape and a.dtype == b.dtype
    np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def _jtree(tree):
    """A port pytree (nested dicts of tensors) as the reference's."""
    return tree_map(lambda x: jnp.asarray(_np(x)), tree)


# --------------------------------------------------------------------------
# the kernel's plain version
# --------------------------------------------------------------------------
#: (da, d1), (n, d1, d2), (d2, db) of fig-dnn's four rotated leaves
PATH_ROTATIONS = [(96, 96, 32, 32), (32, 32, 64, 64), (64, 64, 32, 32), (32, 32, 4, 4)]


@pytest.mark.parametrize("da,d1,d2,db", PATH_ROTATIONS + [(5, 7, 3, 6)])
def test_basis_transform_plain_matches_reference_product(da, d1, d2, db):
    rng = np.random.default_rng(da * 1000 + d2)
    A = rng.standard_normal((da, d1)).astype(np.float32)
    g = rng.standard_normal((8, d1, d2)).astype(np.float32)
    B = rng.standard_normal((d2, db)).astype(np.float32)
    out = tbt.basis_transform(torch.from_numpy(A), torch.from_numpy(g), torch.from_numpy(B))
    assert out.shape == (8, da, db) and out.dtype == torch.float32
    _close(out, jnp.asarray(A) @ jnp.asarray(g) @ jnp.asarray(B))
    _close(out, np.einsum("ab,nbc,cd->nad", A.astype(np.float64), g.astype(np.float64),
                          B.astype(np.float64)))


@pytest.mark.parametrize("shapes,dtype,err", [
    (((4, 3), (3, 5), (5, 2)), torch.float32, ValueError),     # 2-D g
    (((4, 3), (2, 3, 5), (5, 2)), torch.float64, TypeError),   # f64
    (((4, 2), (2, 3, 5), (5, 2)), torch.float32, ValueError),  # A mismatch
])
def test_basis_transform_raises_on_unsupported_input(shapes, dtype, err):
    A, g, B = (torch.ones(s, dtype=dtype) for s in shapes)
    with pytest.raises(err):
        tbt.basis_transform(A, g, B)


def test_basis_transform_cpu_takes_plain_version_without_counting():
    before = tbt.launches
    tbt.basis_transform(torch.eye(3), torch.ones((2, 3, 4)), torch.eye(4))
    assert tbt.launches == before


# --------------------------------------------------------------------------
# modules against the reference
# --------------------------------------------------------------------------
@pytest.mark.parametrize("float_bits,col_frac", [(32, 1.0), (16, 1.0), (8, 1.0),
                                                 (32, 0.5), (8, 0.5)])
def test_quantize_ship_factor_matches_reference(float_bits, col_frac):
    rng = np.random.default_rng(float_bits)
    M = np.linalg.qr(rng.standard_normal((24, 24)))[0][:, :8].astype(np.float32)
    jW, jbits = jbasis.quantize_ship_factor(
        jnp.asarray(M), jcomm.BasisShipSpec(float_bits=float_bits, col_frac=col_frac))
    tW, tbits = tbasis.quantize_ship_factor(
        torch.from_numpy(M), tcomm.BasisShipSpec(float_bits=float_bits, col_frac=col_frac))
    _bitwise(tW, jW)
    assert tbits == jbits


def test_basis_ship_spec_rejects_bad_widths():
    with pytest.raises(ValueError):
        tcomm.BasisShipSpec(float_bits=12)
    with pytest.raises(ValueError):
        tcomm.BasisShipSpec(col_frac=0.0)


@pytest.fixture(scope="module")
def small():
    """A small BL-DNN problem built by the reference (n=4, m=16, d=24,
    width 8, 3 classes, r=4), its per-layer SVD basis, and the same
    problem carried into the port."""
    batch, params0 = jbldnn.make_synthetic_classification(
        seed=3, n_clients=4, m=16, d=24, classes=3, width=8, r=4)
    jb = jbasis.make_bases("per_layer_svd", params0)
    conv = dnn_problem_from_numpy(
        np.asarray(batch.data["x"]), np.asarray(batch.data["y"]),
        jax.tree.map(np.asarray, params0),
        [None if uv is None else (np.asarray(uv[0]), np.asarray(uv[1])) for uv in jb.UV],
        device="cpu")
    return batch, params0, jb, conv


def test_carried_problem_keeps_leaf_order_and_values(small):
    batch, params0, jb, conv = small
    for jl, tl in zip(jax.tree_util.tree_leaves(params0), tree_leaves(conv.params0)):
        _bitwise(tl, jl)
    assert [uv is None for uv in jb.UV] == [uv is None for uv in conv.basis.UV]
    _bitwise(conv.batch.data["y"], batch.data["y"])
    assert conv.batch.n == 4


@pytest.mark.parametrize("kind", ["per_layer_svd", "dct_tree", "hadamard_tree"])
def test_rotate_unrotate_match_reference(small, kind):
    batch, params0, jb, conv = small
    if kind == "per_layer_svd":
        jbase, tbase = jb, conv.basis
    else:
        jbase = jbasis.make_bases(kind, params0)
        tbase = tbasis.make_bases(kind, conv.params0)
        assert tbasis.is_pytree_basis(kind) and tbase.ship_floats() == 0.0
        for juv, tuv in zip(jbase.UV, tbase.UV):
            _bitwise(tuv[0], juv[0])
            _bitwise(tuv[1], juv[1])
    rng = np.random.default_rng(11)
    g = tree_map(lambda p: torch.from_numpy(
        rng.standard_normal((4,) + tuple(p.shape)).astype(np.float32)), conv.params0)
    t_rot, j_rot = tbase.rotate(g), jbase.rotate(_jtree(g))
    for tl, jl in zip(tree_leaves(t_rot), jax.tree_util.tree_leaves(j_rot)):
        _close(tl, jl)
    mean = tree_map(lambda x: x.mean(dim=0), t_rot)
    for tl, jl in zip(tree_leaves(tbase.unrotate(mean)),
                      jax.tree_util.tree_leaves(jbase.unrotate(_jtree(mean)))):
        _close(tl, jl)
    assert tbase.ship_floats() == jbase.ship_floats()


def test_shipped_basis_matches_reference(small):
    _, _, jb, conv = small
    ship = dict(float_bits=8)
    jq, jbits = jb.shipped(jcomm.BasisShipSpec(**ship))
    tq, tbits = conv.basis.shipped(tcomm.BasisShipSpec(**ship))
    assert tbits == jbits
    for juv, tuv in zip(jq.UV, tq.UV):
        _bitwise(tuv[0], juv[0])
        _bitwise(tuv[1], juv[1])


def test_tree_shift_update_sum_matches_reference(small):
    _, _, _, conv = small
    rng = np.random.default_rng(5)

    def draw(scale):
        return tree_map(lambda p: torch.from_numpy(
            (scale * rng.standard_normal((4,) + tuple(p.shape))).astype(np.float32)),
            conv.params0)

    target, shift = draw(1.0), draw(0.3)
    frac = 0.1
    tcomps = tbldnn.leaf_compressors("topk", frac, conv.params0)
    jcomps = jbldnn.leaf_compressors("topk", frac, _jtree(conv.params0))
    S, shift_n, auxs, sums = trounds.tree_shift_update_sum(
        lambda i, d: tcomps[i].compress_sum(None, d), target, shift, 0.1)
    jS, jshift_n, jauxs, jsums = jax.jit(lambda t, s: jrounds.tree_shift_update_sum(
        lambda i, d: jcomps[i].compress_sum(None, d), t, s, 0.1))(_jtree(target), _jtree(shift))
    for a, b in ((S, jS), (shift_n, jshift_n)):
        for tl, jl in zip(tree_leaves(a), jax.tree_util.tree_leaves(b)):
            _bitwise(tl, jl)
    for tl, jl in zip(tree_leaves(sums), jax.tree_util.tree_leaves(jsums)):
        np.testing.assert_allclose(_np(tl), np.asarray(jl), rtol=0,
                                   atol=4 * np.finfo(np.float32).eps * float(np.abs(jl).max()))
    for tc, jc, ta, ja in zip(tcomps, jcomps, auxs, jauxs):
        tb = tcomm.price(tcomm.with_float_bits(tc.wire, 32), ta)
        jb_ = jcomm.price(jcomm.with_float_bits(jc.wire, 32), ja)
        np.testing.assert_array_equal(_np(tb), np.asarray(jb_))


def test_refresh_due_matches_reference():
    for T in (0, 1, 3):
        for t in range(7):
            assert trounds.refresh_due(t, T) == bool(jrounds.refresh_due(t, T))


def _carry_to_torch(carry):
    params, shift, fshift, server_f, led = carry
    conv = lambda tree: jax.tree.map(lambda x: torch.from_numpy(np.array(x)), tree)
    tled = tcomm.CommLedger.create(*(float(getattr(led, k)) for k in tcomm.CommLedger.LEGS),
                                   device="cpu")
    return conv(params), conv(shift), conv(fshift), conv(server_f), tled


def test_one_step_from_the_same_carry_matches_reference(small):
    """Two reference rounds give a carry with nonzero shifts; one more
    round from it in both packages gives the same next carry."""
    batch, params0, jb, conv = small
    cfg = jbldnn.BLDNNConfig(top_k_frac=0.1, lr=0.05)
    jspec = jbldnn.build_spec(jbldnn.make_loss_fn(3), jbldnn.make_eval_fn(), params0, cfg)
    tspec = tbldnn.build_spec(tbldnn.make_loss_fn(3), tbldnn.make_eval_fn(),
                              conv.params0, tbldnn.BLDNNConfig(top_k_frac=0.1, lr=0.05))
    R = jrounds.VmapReducer(n=4)
    env = jrounds.Env(batch=batch, basisb=jb, x0=params0, extra=None)
    step = jax.jit(lambda carry, key, t: jspec.step(
        R, env, carry, jrounds.RoundCtx(key=key, t=t))[0])
    carry = jspec.init(R, env)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    for t in range(2):
        carry = step(carry, keys[t], jnp.int32(t))
    tcarry = _carry_to_torch(carry)
    jnext = step(carry, keys[2], jnp.int32(2))
    tenv = trounds.Env(batch=conv.batch, basisb=conv.basis, x0=conv.params0, extra=None)
    tnext, _ = tspec.step(trounds.VmapReducer(n=4), tenv, tcarry, trounds.RoundCtx(t=2))
    for part in range(4):
        for tl, jl in zip(tree_leaves(tnext[part]), jax.tree_util.tree_leaves(jnext[part])):
            _close(tl, jl, 1e-5)
    for leg in tcomm.CommLedger.LEGS:
        assert float(getattr(tnext[4], leg)) == float(getattr(jnext[4], leg))


# --------------------------------------------------------------------------
# the slice end to end
# --------------------------------------------------------------------------
def _assert_same_history(h, ref_gaps, ref_loss, ref_up, ref_down, ref_legs, rounds=None):
    rounds = len(ref_gaps) if rounds is None else rounds
    loss, rl = np.asarray(h.metrics["loss"]), np.asarray(ref_loss)
    assert np.all(np.isfinite(loss))
    np.testing.assert_allclose(loss[:rounds], rl[:rounds], rtol=LOSS_RTOL, atol=0)
    assert list(h.gaps[:rounds]) == list(ref_gaps[:rounds])
    assert list(h.up_bits) == list(ref_up)
    assert list(h.down_bits) == list(ref_down)
    assert sorted(h.legs) == sorted(ref_legs)
    for leg, stream in ref_legs.items():
        assert list(h.legs[leg]) == list(stream), leg


SMALL_CONFIGS = {
    "BLDNN": dict(top_k_frac=0.1, lr=0.05),
    "TopK": dict(top_k_frac=0.1, lr=0.05, use_basis=False),
    "FedAvg": dict(compressor="identity", lr=0.5, precondition=False, use_basis=False),
    "BLDNN_bf16": dict(top_k_frac=0.1, lr=0.05, ship_float_bits=16),
    "BLDNN_hadamard": dict(top_k_frac=0.1, lr=0.05, basis_kind="hadamard_tree"),
    "BLDNN_refresh": dict(top_k_frac=0.1, lr=0.05, rounds_per_refresh=2),
}


@pytest.mark.parametrize("name", sorted(SMALL_CONFIGS))
def test_small_problem_matches_reference(small, name):
    batch, params0, jb, conv = small
    steps = 6
    kw = SMALL_CONFIGS[name]
    carried = kw.get("basis_kind", "per_layer_svd") == "per_layer_svd"
    jh = jbldnn.run_bldnn(jbldnn.make_loss_fn(3), jbldnn.make_eval_fn(), params0, batch,
                          steps, jbldnn.BLDNNConfig(**kw), basis=jb if carried else None)
    th = tbldnn.run_bldnn(tbldnn.make_loss_fn(3), tbldnn.make_eval_fn(), conv.params0,
                          conv.batch, steps, tbldnn.BLDNNConfig(**kw),
                          basis=conv.basis if carried else None, device="cpu")
    _assert_same_history(th, jh.gaps, jh.metrics["loss"], jh.up_bits, jh.down_bits, jh.legs)


# --------------------------------------------------------------------------
# the carried fig-dnn problem
# --------------------------------------------------------------------------
def write_fixture(path) -> None:
    """Write the fig-dnn problem (seed 0) as the committed artifacts saw
    it: data, the student's parameters and its per-layer SVD factors."""
    jax.config.update("jax_threefry_partitionable", False)
    from repro.exp import engine, registry

    prob = engine.build_problem(registry.get_experiment("fig-dnn").problem)
    basis = jbasis.make_bases("per_layer_svd", prob.params0)
    arrays = {"x": np.asarray(prob.batch.data["x"], np.float32),
              "y": np.asarray(prob.batch.data["y"], np.int32)}
    flat, _ = jax.tree_util.tree_flatten_with_path(prob.params0)
    for (keys, leaf), uv in zip(flat, basis.UV):
        name = "/".join(k.key for k in keys)
        arrays[f"param:{name}"] = np.asarray(leaf, np.float32)
        if uv is not None:
            arrays[f"U:{name}"] = np.asarray(uv[0], np.float32)
            arrays[f"V:{name}"] = np.asarray(uv[1], np.float32)
    np.savez(path, **arrays)


def test_fixture_regenerates_bitwise(tmp_path):
    """The reference, in a process of its own (the threefry flag must not
    leak into this one), writes the committed fixture again, array for
    array."""
    out = tmp_path / "fig_dnn_seed0.npz"
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([str(REPO / "src"), os.environ.get("PYTHONPATH", "")])}
    subprocess.run([sys.executable, __file__, str(out)], check=True, env=env,
                   cwd=REPO, timeout=300, capture_output=True)
    with np.load(out) as new, np.load(problems.DNN_FIXTURE) as old:
        assert sorted(new.files) == sorted(old.files)
        for k in old.files:
            _bitwise(new[k], old[k])


def test_fixture_holds_the_fig_dnn_problem():
    prob = problems.load_dnn_problem(device="cpu")
    x, y = prob.batch.data["x"], prob.batch.data["y"]
    assert tuple(x.shape) == (8, 64, 96) and x.dtype == torch.float32
    assert tuple(y.shape) == (8, 64) and y.dtype == torch.int32
    shapes = [tuple(p.shape) for p in tree_leaves(prob.params0)]
    assert shapes == [(96, 32), (32, 64), (64, 32), (32, 4)]
    assert [tuple(uv[0].shape) + tuple(uv[1].shape) for uv in prob.basis.UV] == \
        [(96, 96, 32, 32), (32, 32, 64, 64), (64, 64, 32, 32), (32, 32, 4, 4)]
    assert problems.DNN_FIXTURE.stat().st_size < 400_000


def test_fig_dnn_bldnn_from_fixture_matches_artifact():
    prob = problems.load_dnn_problem(device="cpu")
    cell = problems.FIG_DNN["BLDNN"]
    ref = json.loads(cell.artifact.read_text())["history"]
    h = problems.run_dnn_cell(cell, prob, steps=ARTIFACT_ROUNDS)
    n = ARTIFACT_ROUNDS
    _assert_same_history(h, ref["gaps"][:n], ref["metrics"]["loss"][:n], ref["up_bits"][:n],
                         ref["down_bits"][:n], {k: v[:n] for k, v in ref["legs"].items()})


# --------------------------------------------------------------------------
# what is not ported raises, naming its ROADMAP item
# --------------------------------------------------------------------------
def test_unported_paths_raise_naming_their_item(small):
    """fig-dnn/RTopK and the composed Top-K run since the PRNG port (see
    `test_fig_dnn_rtopk_from_fixture_matches_artifact`); drawing the fleet
    itself runs since the port draws jax.random.normal (it raised item 9's
    remainder until then; its parity: `test_drawn_problem_is_the_references`)."""
    _, _, _, conv = small
    h = problems.run_dnn_cell(problems.FIG_DNN["RTopK"],
                              problems.DNNProblem(problems.DNN_FIG, conv.batch, conv.params0,
                                                  conv.basis, tbldnn.make_loss_fn(4),
                                                  tbldnn.make_eval_fn()), steps=1)
    assert len(h.gaps) == 1 and np.isfinite(h.metrics["loss"]).all()
    assert tcomp.ComposedTopK(k=3, inner=tcomp.NaturalCompression()).stochastic
    tiny, params = tbldnn.make_synthetic_classification(seed=0, n_clients=2, m=4, d=6,
                                                        classes=2, width=4, r=2, device="cpu")
    assert tuple(tiny.data["x"].shape) == (2, 4, 6) and tiny.data["y"].dtype == torch.int32
    assert [tuple(p.shape) for p in tree_leaves(params)] == [(6, 4), (4, 8), (8, 4), (4, 2)]
    # "fast+sharded" (ROADMAP.md §1 item 13) on a one-rank world: bitwise
    # the fast path, in both modes
    fns = (tbldnn.make_loss_fn(4), tbldnn.make_eval_fn())
    fast = tbldnn.run_bldnn(*fns, conv.params0, conv.batch, 2, basis=conv.basis,
                            device="cpu")
    for exact in (True, False):
        h = tbldnn.run_bldnn(*fns, conv.params0, conv.batch, 2, basis=conv.basis,
                             backend="fast+sharded", exact=exact, device="cpu")
        assert (h.gaps, h.metrics, h.legs) == (fast.gaps, fast.metrics, fast.legs)


def test_fig_dnn_rtopk_from_fixture_matches_artifact():
    """fig-dnn/RTopK (per-leaf RTop-K dithering draws from the round keys)
    from the carried problem: bits exact over every round; loss within
    1e-4·|ref| and the error rate exact over rounds 0–3."""
    prob = problems.load_dnn_problem(device="cpu")
    cell = problems.FIG_DNN["RTopK"]
    ref = json.loads(cell.artifact.read_text())["history"]
    h = problems.run_dnn_cell(cell, prob)
    assert h.up_bits == ref["up_bits"] and h.down_bits == ref["down_bits"]
    assert all(h.legs[k] == v for k, v in ref["legs"].items())
    n = ARTIFACT_ROUNDS
    loss, lr = np.asarray(h.metrics["loss"][:n]), np.asarray(ref["metrics"]["loss"][:n])
    assert (np.abs(loss - lr) <= 1e-4 * np.abs(lr)).all(), (loss, lr)
    assert h.gaps[:n] == ref["gaps"][:n]


# --------------------------------------------------------------------------
# problems drawn by the port (`prng.normal`: jax.random.normal bit for bit)
# --------------------------------------------------------------------------
#: respectralised leaves: another LAPACK SVD, in float64, as x64 computes it
DRAW_TOL = 1e-5
#: fig-dnn's registered problem and a reduced one
DRAW_SPECS = {"fig-dnn": dict(seed=0, n_clients=8, m=64, d=96, classes=4, width=32),
              "reduced": dict(seed=1, n_clients=4, m=16, d=24, classes=4, width=8)}


def _ref_draw(part, fn, *args, **kw):
    with jax.threefry_partitionable(part):
        return fn(*args, **kw)


@pytest.mark.parametrize("part", SETTINGS_BOTH, ids=["original", "partitionable"])
@pytest.mark.parametrize("decay", [0.0, 8.0])
def test_init_mlp_classifier_is_the_references(part, decay):
    """No decay: every leaf bit for bit.  Decay > 0: the re-spectralised
    leaves within 1e-5·max|ref| (another LAPACK SVD)."""
    want = _ref_draw(part, jbldnn.init_mlp_classifier, jax.random.PRNGKey(5), 24, 8, 4,
                     spectral_decay=decay)
    with tprng.threefry_partitionable(part):
        got = tbldnn.init_mlp_classifier(tprng.PRNGKey(5), 24, 8, 4, spectral_decay=decay,
                                         device="cpu")
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        if decay == 0.0:
            _bitwise(g, w)
        else:
            _close(g, w, DRAW_TOL)


@pytest.mark.parametrize("name,part", [("fig-dnn", False), ("reduced", False),
                                       ("reduced", True)])
def test_drawn_problem_is_the_references(name, part):
    """x bit for bit and y equal; the student's input layer bit for bit
    (numpy's float64 projection of a bitwise draw), its other leaves
    within 1e-5·max|ref| (the teacher's re-spectralising SVD)."""
    jb, jp = _ref_draw(part, jbldnn.make_synthetic_classification, **DRAW_SPECS[name])
    with tprng.threefry_partitionable(part):
        tb, tp = tbldnn.make_synthetic_classification(**DRAW_SPECS[name], device="cpu")
    _bitwise(tb.data["x"], jb.data["x"])
    np.testing.assert_array_equal(_np(tb.data["y"]), np.asarray(jb.data["y"]))
    _bitwise(tp["in"], jp["in"])
    for g, w in zip(tree_leaves(tp), jax.tree_util.tree_leaves(jp)):
        _close(g, w, DRAW_TOL)


def test_drawn_fig_dnn_problem_is_the_fixture():
    """The port's own draw of fig-dnn's `DNNProblemSpec` (under the
    fixture's threefry setting) against the carried reference problem."""
    spec = problems.DNN_FIG
    with tprng.threefry_partitionable(False):
        drawn = tengine.draw_dnn_problem(spec, device="cpu")
    fix = problems.load_dnn_problem(device="cpu")
    _bitwise(drawn.batch.data["x"], fix.batch.data["x"])
    assert torch.equal(drawn.batch.data["y"], fix.batch.data["y"])
    _bitwise(drawn.params0["in"], fix.params0["in"])
    for g, w in zip(tree_leaves(drawn.params0), tree_leaves(fix.params0)):
        _close(g, w, DRAW_TOL)
    # the input layer is bitwise, so host LAPACK gives the carried factors
    _bitwise(drawn.basis.UV[0][0], fix.basis.UV[0][0])
    _bitwise(drawn.basis.UV[0][1], fix.basis.UV[0][1])


@pytest.mark.parametrize("name,part", [("BLDNN", False), ("BLDNN", True), ("TopK", False)])
def test_drawn_reduced_problem_runs_as_the_references(name, part):
    """A reduced fig-dnn cell from the problem each package draws for
    itself (the port's basis by host LAPACK, the reference's by jax's
    SVD), in the BL-DNN gate: bits exact over all 8 rounds, loss within
    1e-4·|ref| and the error rate equal over rounds 0–3."""
    spec = tregistry.DNNProblemSpec(seed=1, n_clients=4, m=16, d=24, width=8)
    jb, jp = _ref_draw(part, jbldnn.make_synthetic_classification, **DRAW_SPECS["reduced"])
    with tprng.threefry_partitionable(part):
        prob = tengine.draw_dnn_problem(spec, device="cpu")
    kw = SMALL_CONFIGS[name]
    jh = jbldnn.run_bldnn(jbldnn.make_loss_fn(4), jbldnn.make_eval_fn(), jp, jb, 8,
                          jbldnn.BLDNNConfig(**kw))
    th = tbldnn.run_bldnn(prob.loss_fn, prob.eval_fn, prob.params0, prob.batch, 8,
                          tbldnn.BLDNNConfig(**kw), basis=prob.basis, device="cpu")
    _assert_same_history(th, jh.gaps, jh.metrics["loss"], jh.up_bits, jh.down_bits, jh.legs,
                         rounds=ARTIFACT_ROUNDS)


def test_tree_batch_validates_client_axis():
    with pytest.raises(ValueError):
        tcb.tree_batch({"x": torch.zeros((3, 2)), "y": torch.zeros((4,))})
    assert tcb.tree_batch({"x": torch.zeros((3, 2))}).n == 3


def report_envelope() -> None:
    """The reference's own envelope on fig-dnn(-ship), printed as JSON
    lines: what the port can be held to."""
    from repro.exp import engine, registry

    spec = registry.get_experiment("fig-dnn").problem
    kw = dict(seed=spec.seed, n_clients=spec.n_clients, m=spec.m, d=spec.d,
              classes=spec.classes, width=spec.width, r=spec.r,
              heterogeneity=spec.heterogeneity, label_noise=spec.label_noise)
    eval_fn = jbldnn.make_eval_fn()
    for flag in (True, False):
        jax.config.update("jax_threefry_partitionable", flag)
        batch, params0 = jbldnn.make_synthetic_classification(**kw)
        print(json.dumps({"threefry_partitionable": flag, "round0_error":
                          float(eval_fn(params0, batch.data)["gap"])}), flush=True)
    prob = engine.build_problem(spec)   # built under False, as the artifacts were
    svd = jbasis.make_bases("per_layer_svd", prob.params0)
    w_in = np.asarray(prob.params0["in"], np.float64)
    print(json.dumps({"w_in_smallest_singular_values":
                      np.linalg.svd(w_in, compute_uv=False)[-3:].tolist()}), flush=True)

    def run(cell, params0, basis):
        cfg = jbldnn.BLDNNConfig(compressor=cell.hess_comp.kind,
                                 use_basis=cell.basis is not None,
                                 basis_kind=cell.basis or "per_layer_svd",
                                 **cell.params_dict())
        return jbldnn.run_bldnn(prob.loss_fn, prob.eval_fn, params0, prob.batch,
                                cell.steps, cfg,
                                basis=basis if cell.basis == "per_layer_svd" else None)

    def ulp(kind, seed):
        def f(p):
            a = np.asarray(p)
            up, down = np.nextafter(a, np.inf), np.nextafter(a, -np.inf)
            if kind == "up":
                return jnp.asarray(up.astype(a.dtype))
            if kind == "down":
                return jnp.asarray(down.astype(a.dtype))
            r = np.random.default_rng(seed).integers(-1, 2, a.shape)
            return jnp.asarray(np.where(r > 0, up, np.where(r < 0, down, a)).astype(a.dtype))
        return jax.tree.map(f, prob.params0)

    def rel(h, l0):
        return np.abs(np.asarray(h.metrics["loss"]) - l0) / np.abs(l0)

    cells = [("fig-dnn", "BLDNN"), ("fig-dnn", "TopK"), ("fig-dnn", "FedAvg"),
             ("fig-dnn-ship", "BLDNN_int8"), ("fig-dnn-ship", "BLDNN_dct"),
             ("fig-dnn-ship", "BLDNN_hadamard")]
    for exp_name, name in cells:
        cell = next(c for c in registry.get_experiment(exp_name).cells if c.name == name)
        ref = json.loads((REPO / "results" / "exp" / exp_name / f"{name}.seed0.json")
                         .read_text())["history"]
        h0 = run(cell, prob.params0, svd)
        l0, e0 = np.asarray(h0.metrics["loss"]), np.asarray(h0.gaps)
        vs_art = np.abs(l0 - np.asarray(ref["metrics"]["loss"])) / np.abs(ref["metrics"]["loss"])
        ens = [run(cell, ulp(k, sd), svd) for k, sd in
               (("up", 0), ("down", 0), ("rand", 1), ("rand", 2), ("rand", 3))]
        ens_rel = np.max([rel(h, l0) for h in ens], axis=0)
        first_err = [int(np.argmax(np.asarray(h.gaps) != e0)) if (np.asarray(h.gaps) != e0).any()
                     else None for h in ens]
        print(json.dumps({
            "cell": f"{exp_name}/{name}",
            "rerun_vs_artifact_loss_rel": vs_art.tolist(),
            "rerun_vs_artifact_error_equal_rounds": int((e0 == np.asarray(ref["gaps"])).sum()),
            "rerun_vs_artifact_bits_equal": h0.up_bits == ref["up_bits"] and all(
                h0.legs[k] == v for k, v in ref["legs"].items()),
            "ulp_ensemble_max_loss_rel": ens_rel.tolist(),
            "ulp_ensemble_first_error_round": first_err}), flush=True)
    # a basis from numpy's SVD instead of the reference's, same weights
    UV = []
    for p, uv in zip(jax.tree_util.tree_leaves(prob.params0), svd.UV):
        u, _, vt = np.linalg.svd(np.asarray(p, np.float32), full_matrices=True)
        UV.append(None if uv is None else (jnp.asarray(u), jnp.asarray(vt.T)))
    cell = registry.get_experiment("fig-dnn").cells[0]
    h_np = run(cell, prob.params0, jbasis.PerLayerSVDBasis(UV=tuple(UV)))
    h0 = run(cell, prob.params0, svd)
    print(json.dumps({"numpy_svd_basis_max_error_rate_diff": float(np.max(np.abs(
        np.asarray(h_np.gaps) - np.asarray(h0.gaps))))}), flush=True)


if __name__ == "__main__":
    if "--envelope" in sys.argv:
        report_envelope()
    else:
        write_fixture(sys.argv[1] if len(sys.argv) > 1 else problems.DNN_FIXTURE)
