"""The port's basis-transform wrapper (`repro_torch.kernels.basis_transform`)
on the CPU: the plan that picks the kernel's form, the kernel's arithmetic
emulated in PyTorch, and the transposed-A layout.

The CUDA kernel itself runs only on the card, where chip_smoke.py (phase
kernels_bldnn) holds it to its plain version (1e-5·max|ref|) and to
float64 (1e-6·max|ref|) in both forms.  Here `basis_transform_emulated`,
which repeats the kernel's split TF32 products and its order of K-tile
partials, is held to the same float64 gate at 1024² with orthogonal
factors, as chip_smoke.py draws them; one TF32 product has to leave that
gate (which is why the kernel splits).  At the path's shapes and at odd
widths the emulation is held to the plain version and to the reference's
Pallas kernel (interpret mode) within 1e-6·max|ref|: the split's own
error is ~2e-7 of max|ref|, and torch and XLA call different gemms.
"""
import ctypes
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import SOURCES, _build
from repro_torch.kernels import basis_transform as bt

#: the gates chip_smoke.py holds the kernel to (share of max|ref|)
TOL_PLAIN, TOL_F64 = 1e-5, 1e-6
#: (n, da, d1, d2, db) of fig-dnn's four rotated leaves
PATH = [(8, 96, 96, 32, 32), (8, 32, 32, 64, 64), (8, 64, 64, 32, 32), (8, 32, 32, 4, 4)]
ODD = (8, 5, 7, 3, 6)
LARGE = (64, 1024, 1024, 1024, 1024)


def _operands(n, da, d1, d2, db, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((da, d1)).astype(np.float32)
    g = rng.standard_normal((n, d1, d2)).astype(np.float32)
    B = rng.standard_normal((d2, db)).astype(np.float32)
    return A, g, B


def _f64(A, g, B):
    A, g, B = (np.asarray(x, np.float64) for x in (A, g, B))
    return (A @ g) @ B


@pytest.mark.parametrize("shape", PATH, ids=lambda s: "x".join(map(str, s)))
def test_plan_fuses_every_path_leaf_in_one_launch(shape):
    for a_trans in (False, True):
        p = bt.plan(*shape, a_trans)
        assert (p.form, p.bm, p.launches, p.workspace_floats) == (bt.FUSED, 16, 1, 0)
        assert p.loader == bt.TMA


@pytest.mark.parametrize("shape,a_trans,form,why", [
    (LARGE, False, bt.TWO_STAGE, "wider than the fused form's 256"),
    (LARGE, True, bt.TWO_STAGE, "A read from its transpose"),
    ((1, 8, 8000, 64, 8), False, bt.TWO_STAGE, "d1 = 8000, the old refusal"),
    ((2, 4, 4, 4096, 4), False, bt.TWO_STAGE, "the stripe past shared memory"),
    (ODD, False, bt.FUSED, "odd widths"),
    ((1, 256, 256, 256, 256), False, bt.FUSED, "the widest fused shape"),
    ((2, 7, 300, 5, 260), True, bt.FUSED, "wide, but da = 7: no TMA rows for A's transpose"),
    ((2, 300, 301, 40, 8), False, bt.FUSED, "wide, but d1 = 301: no TMA rows for A"),
    ((2, 7, 300, 40, 260), False, bt.TWO_STAGE, "d1 = 300 is what TMA reads when A is not transposed"),
])
def test_plan_form_and_launches(shape, a_trans, form, why):
    p = bt.plan(*shape, a_trans)
    assert p.form == form, why
    assert p.launches == (1 if form == bt.FUSED else 2)
    assert p.bm == bt.BM[form]
    n, da, _, d2, _ = shape
    assert p.workspace_floats == (n * da * (-(-d2 // 4) * 4) if form == bt.TWO_STAGE else 0)
    if form == bt.TWO_STAGE:
        assert p.loader == bt.TMA


@pytest.mark.parametrize("shape,a_trans,aligned,form,loader,why", [
    (PATH[0], True, True, bt.FUSED, bt.TMA, "a path leaf, A = U.mT"),
    (PATH[3], False, True, bt.FUSED, bt.TMA, "d2 = db = 4: one 16-byte row"),
    (PATH[0], True, False, bt.FUSED, bt.CP_ASYNC, "an operand not on 16 bytes"),
    (ODD, False, True, bt.FUSED, bt.CP_ASYNC, "odd widths"),
    ((2, 7, 300, 5, 260), True, True, bt.FUSED, bt.CP_ASYNC, "da = 7 under A's transpose"),
    (LARGE, False, True, bt.TWO_STAGE, bt.TMA, "1024², aligned"),
    (LARGE, False, False, bt.FUSED, bt.CP_ASYNC, "1024², an operand not on 16 bytes"),
])
def test_plan_loader(shape, a_trans, aligned, form, loader, why):
    p = bt.plan(*shape, a_trans, aligned)
    assert (p.form, p.loader, p.a_trans) == (form, loader, a_trans), why


def test_alignment_is_read_from_each_operand():
    buf = torch.zeros(1 + 8 * 32 * 32)
    assert bt._aligned(buf[:4], buf[4:8])
    assert not bt._aligned(buf[:4], buf[1:].view(8, 32, 32))


def test_fused_stripe_fits_exactly_up_to_shared_memory():
    fits = [d2 for d2 in range(64, 8192, 64) if bt.fused_smem_bytes(d2) <= 227 * 1024]
    assert fits == list(range(64, fits[-1] + 1, 64)) and 2048 < fits[-1] < 4096
    assert bt.fused_smem_bytes(32) == 1024 + 4 * (6 * (640 + 32 * 36) + 16 * 40) + 8 * 6


@pytest.mark.parametrize("shape", PATH + [ODD, LARGE, (3, 1, 9, 9, 9), (2, 129, 4, 4, 4),
                                          (1, 300, 300, 40, 7)],
                         ids=lambda s: "x".join(map(str, s)))
def test_plan_row_blocks_cover_every_row_once(shape):
    p = bt.plan(*shape)
    blocks = p.row_blocks()
    rows = [r for a, b in blocks for r in range(a, b)]
    assert rows == list(range(shape[1]))
    assert all(0 < b - a <= p.bm for a, b in blocks)
    assert len(blocks) == -(-shape[1] // p.bm)


def test_split_parts_are_tf32_and_rebuild_the_value():
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(4096).astype(np.float32))
    hi = bt._tf32(x)
    lo = bt._tf32(x - hi)
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    # hi is x to nearest at 11 significant bits; hi + lo keeps ~22
    assert bool(((x - hi).abs() <= x.abs() * 2.0 ** -11).all())
    err = (x.double() - hi.double() - lo.double()).abs()
    assert bool((err <= x.abs().double() * 2.0 ** -22).all())


@pytest.fixture(scope="module")
def orthogonal_1024():
    """One client at 1024² with orthogonal A and B (a basis is orthogonal)
    and a Gaussian leaf, and its float64 product."""
    rng = np.random.default_rng(18)
    A = np.linalg.qr(rng.standard_normal((1024, 1024)))[0].astype(np.float32)
    B = np.linalg.qr(rng.standard_normal((1024, 1024)))[0].astype(np.float32)
    g = rng.standard_normal((1, 1024, 1024)).astype(np.float32)
    return A, g, B, _f64(A, g, B)


@pytest.mark.parametrize("products,inside", [("split", True), ("exact", True),
                                             ("single", False)])
def test_emulated_arithmetic_holds_the_f64_gate_only_with_split_products(
        orthogonal_1024, products, inside):
    A, g, B, ref = orthogonal_1024
    out = bt.basis_transform_emulated(*map(torch.from_numpy, (A, g, B)), products=products)
    rel = np.abs(out.numpy().astype(np.float64) - ref).max() / np.abs(ref).max()
    assert (rel <= TOL_F64) == inside, rel
    if products == "single":
        assert rel > 100 * TOL_F64


@pytest.mark.parametrize("shape", PATH + [ODD], ids=lambda s: "x".join(map(str, s)))
def test_emulated_matches_plain_and_reference_kernel(shape):
    A, g, B = _operands(*shape, seed=sum(shape))
    emu = bt.basis_transform_emulated(*map(torch.from_numpy, (A, g, B))).numpy()
    plain = bt.basis_transform_plain(*map(torch.from_numpy, (A, g, B))).numpy()
    jax_out = np.asarray(jops.basis_transform(*map(jnp.asarray, (A, g, B))))
    ref = _f64(A, g, B)
    scale = np.abs(ref).max()
    assert emu.shape == plain.shape == jax_out.shape == ref.shape
    for other in (plain, jax_out, ref):
        assert np.abs(emu - other).max() <= TOL_F64 * scale
    assert np.abs(plain - ref).max() <= TOL_F64 * scale


def test_emulated_k_tile_changes_only_the_rounding():
    A, g, B = (torch.from_numpy(x) for x in _operands(2, 40, 200, 24, 16, seed=5))
    ref = _f64(A, g, B)
    for k_tile in (8, 32, 200):
        out = bt.basis_transform_emulated(A, g, B, k_tile=k_tile).numpy()
        assert np.abs(out - ref).max() <= TOL_F64 * np.abs(ref).max()
    with pytest.raises(ValueError):
        bt.basis_transform_emulated(A, g, B, products="double")


def test_transposed_A_is_read_from_its_transpose_storage():
    U, g, B = (torch.from_numpy(x) for x in _operands(3, 32, 32, 8, 6, seed=7))
    A = U.mT                                    # (da, d1) view of a contiguous U
    assert bt._transposed(A) and not bt._transposed(U) and A.mT.data_ptr() == U.data_ptr()
    want = torch.matmul(torch.matmul(U.mT.contiguous(), g), B)
    assert torch.equal(bt.basis_transform(A, g, B), want)
    assert torch.equal(bt.basis_transform_emulated(A, g, B),
                       bt.basis_transform_emulated(A.contiguous(), g, B))
    with pytest.raises(ValueError, match="transpose"):
        bt.basis_transform(U[:, ::2], g[:, :16].contiguous(), B)


def test_cpu_tensors_count_no_launch():
    before = (bt.launches, bt.cuda_launches)
    for shape in PATH + [ODD]:
        bt.basis_transform(*(torch.from_numpy(x) for x in _operands(*shape)))
    assert (bt.launches, bt.cuda_launches) == before


def test_kernel_is_built_from_its_source_with_the_bound_prototype():
    path = _build.library_path("basis_transform")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("basis_transform-")
    assert "basis_transform" in SOURCES
    src = (_build.CSRC / "basis_transform.cu").read_text()
    sig = re.search(r'extern "C" int basis_transform_f32\(([^)]*)\)', src).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(bt._ARGS)
    for param, arg in zip(params, bt._ARGS):
        assert ("*" in param) == (arg is not ctypes.c_int), (param, arg)


def test_ops_basis_transform_is_the_wrapper_and_the_references():
    """`ops.basis_transform` (kernel 4's entry point) is `basis_transform`
    and the reference's `ops.basis_transform` within 1e-6·max|ref|."""
    from repro_torch.kernels import ops

    rng = np.random.default_rng(4)
    A = rng.standard_normal((24, 24)).astype(np.float32)
    g = rng.standard_normal((3, 24, 8)).astype(np.float32)
    B = rng.standard_normal((8, 8)).astype(np.float32)
    got = ops.basis_transform(torch.from_numpy(A), torch.from_numpy(g), torch.from_numpy(B))
    assert torch.equal(got, bt.basis_transform(torch.from_numpy(A), torch.from_numpy(g),
                                               torch.from_numpy(B)))
    want = np.asarray(jops.basis_transform(jnp.asarray(A), jnp.asarray(g), jnp.asarray(B)))
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=TOL_F64 * float(np.abs(want).max()))
