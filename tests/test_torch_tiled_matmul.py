"""The port's tiled matmul (`repro_torch.kernels.tiled_matmul`) and its
`ops.basis_project` / `ops.glm_hessian` against the reference Pallas
kernel in interpret mode, on the CPU; and the wrapper's launch plan (its
template and grid) at the path's shapes.

On the CPU the wrapper runs its plain version, ``a.float() @ b.float()``;
the CUDA kernel is held against the same plain version and float64 on the
card by chip_smoke.py.  Both sides convert their inputs to float32 and
accumulate in float32, in different orders, so results agree to within
`TOL` (1e-5) of the larger magnitude, a few float32 ulps of the sum;
inputs are converted exactly (bfloat16) or by the same round to nearest
(float64), so the tolerance is the same for every input type.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core  # noqa: F401  (turns on jax_enable_x64, as the engine runs)
from repro.kernels import ops as jops
from repro.kernels.tiled_matmul import matmul as jmatmul
from repro_torch.kernels import _build, ops
from repro_torch.kernels import tiled_matmul as tm

TOL = 1e-5
#: the reference's own sweep (tests/test_kernels.py), (M, K, N); K = 1 among them
SWEEP = ((64, 64, 64), (300, 500, 200), (128, 1, 7), (1, 257, 129), (513, 128, 255))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "float64": (jnp.float64, torch.float64)}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _pair(np_a: np.ndarray, dtype: str):
    """The same values as a jax array and a torch tensor of `dtype`
    (bfloat16 rounded once, by jax, and carried across exactly)."""
    jdt, tdt = DTYPES[dtype]
    j = jnp.asarray(np_a, jdt)
    t = torch.from_numpy(np.array(j.astype(jnp.float32) if dtype == "bfloat16" else j))
    return j, t.to(tdt)


def assert_close(port: torch.Tensor, ref) -> None:
    ref = np.asarray(ref, np.float64)
    assert tuple(port.shape) == ref.shape
    scale = max(np.abs(ref).max(), 1e-30)
    err = np.abs(port.double().numpy() - ref).max()
    assert err <= TOL * scale, f"|Δ| {err} > {TOL}·{scale}"


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("shape", SWEEP, ids=lambda s: "x".join(map(str, s)))
def test_plain_matmul_matches_reference_kernel(shape, dtype):
    M, K, N = shape
    rng = np.random.default_rng(M * 7 + K * 3 + N)
    ja, ta = _pair(rng.standard_normal((M, K)), dtype)
    jb, tb = _pair(rng.standard_normal((K, N)), dtype)
    out = tm.matmul(ta, tb)
    ref = jmatmul(ja, jb, bm=128, bn=128, bk=128, interpret=True)
    assert out.dtype == torch.float32 and np.asarray(ref).dtype == np.float32
    assert_close(out, ref)


def test_matmul_batched_broadcast_and_transposed_operands():
    """A leading batch axis on either operand, a 2-D operand broadcast over
    it, a transposed view, and `out_dtype`."""
    rng = np.random.default_rng(3)
    A = rng.standard_normal((4, 30, 20))
    B = rng.standard_normal((4, 20, 9))
    ref = np.einsum("nmk,nkj->nmj", A.astype(np.float32), B.astype(np.float32))
    assert_close(tm.matmul(torch.from_numpy(A), torch.from_numpy(B)), ref)
    assert_close(tm.matmul(torch.from_numpy(A), torch.from_numpy(B[0])),
                 A.astype(np.float32) @ B[0].astype(np.float32))
    assert_close(tm.matmul(torch.from_numpy(A[0]), torch.from_numpy(B)),
                 A[0].astype(np.float32) @ B.astype(np.float32))
    At = torch.from_numpy(np.ascontiguousarray(A[0].T)).T
    assert not At.is_contiguous()
    assert_close(tm.matmul(At, torch.from_numpy(B[0])),
                 A[0].astype(np.float32) @ B[0].astype(np.float32))
    out = tm.matmul(torch.from_numpy(A), torch.from_numpy(B), out_dtype=torch.float64)
    assert out.dtype == torch.float64


@pytest.mark.parametrize("case", ["2d", "batched", "broadcast_a", "broadcast_b",
                                  "transposed_a", "expanded_b"])
def test_kernel_geometry_addresses_every_operand_element(case):
    """The (batch, row, column) strides handed to the kernel reach exactly
    the elements of each operand, broadcast by a zero batch stride."""
    a, b = torch.randn(5, 12, 7, dtype=torch.float64), torch.randn(5, 7, 3)
    if case == "2d":
        a, b = a[0], b[0]
    elif case == "broadcast_a":
        a = a[0]
    elif case == "broadcast_b":
        b = b[0]
    elif case == "transposed_a":
        a = torch.randn(5, 7, 12, dtype=torch.float64).transpose(-1, -2)
    elif case == "expanded_b":
        b = b[0].expand(5, 7, 3)
    batch, M, N, K, sa, sb = tm.geometry(a, b)
    assert (M, K, N) == (a.shape[-2], a.shape[-1], b.shape[-1])
    assert batch == (1 if case == "2d" else 5)
    assert torch.equal(a.as_strided((batch, M, K), sa), a.expand(batch, M, K))
    assert torch.equal(b.as_strided((batch, K, N), sb), b.expand(batch, K, N))
    # the strides the plan passes reach the same elements, and its blocks
    # cover the product once
    p = tm.plan((batch, M, N, K, sa, sb), a.element_size(), b.element_size())
    assert torch.equal(a.as_strided((batch, M, K), p.a_strides), a.expand(batch, M, K))
    assert torch.equal(b.as_strided((batch, K, N), p.b_strides), b.expand(batch, K, N))
    _assert_exact_cover(p, batch, M, N, K)


def _assert_exact_cover(p, batch, M, N, K):
    """The plan's grid computes every (batch, m, n, k) of the product exactly
    once: per batch entry its blocks are the product of a partition of the
    rows and one of the columns, each over the whole of K."""
    gx, gy, gz = p.grid(batch, M, N)
    assert gz == batch
    blocks = {}
    for z in range(gz):
        for y in range(gy):
            for x in range(gx):
                b, mr, nr, kr = p.block(x, y, z, M, N, K)
                assert len(mr) and len(nr) and (len(kr) or K == 0)
                blocks.setdefault(b, []).append((mr, nr, kr))
    assert sorted(blocks) == list(range(batch))

    def partition(ranges, n):
        ranges = sorted(set(ranges), key=lambda r: r.start)
        assert [r.start for r in ranges] == [0] + [r.stop for r in ranges[:-1]]
        assert ranges[-1].stop == n
        return ranges

    for parts in blocks.values():
        ms = partition([mr for mr, _, _ in parts], M)
        ns = partition([nr for _, nr, _ in parts], N)
        ks = partition([kr for _, _, kr in parts], K) if K else [range(0)]
        assert len(parts) == len(set(parts)) == len(ms) * len(ns) * len(ks)
        # every block walks the whole of K
        assert ks == [range(0, K)] or K == 0


def _meta(*shape, dtype=torch.float64):
    return torch.empty(shape, dtype=dtype, device="meta")


#: products whose plan is checked: the kernel route's Γ = VᵀAV at fig2's and
#: Newton-XL's widths, the reference sweep in three types and transposed,
#: K = 1 and a broadcast operand
PLAN_CASES = {
    "newton-xl T": (lambda: (_meta(512, 1200, 1200), _meta(512, 1200, 32)), "stream_tall"),
    "newton-xl G": (lambda: (_meta(512, 1200, 32).transpose(-1, -2),
                             _meta(512, 1200, 32, dtype=torch.float32)), "stream_small"),
    "fig2 T": (lambda: (_meta(10, 120, 120), _meta(10, 120, 24)), "stream_tall"),
    "fig2 G": (lambda: (_meta(10, 120, 24).transpose(-1, -2),
                        _meta(10, 120, 24, dtype=torch.float32)), "stream_small"),
    "K = 1": (lambda: (_meta(128, 1), _meta(1, 7)), "stream_tall"),
    "f64 few tiles": (lambda: (_meta(300, 500), _meta(500, 200)), "stream_tall"),
    "f64 few tiles transposed": (lambda: (_meta(500, 300).T, _meta(200, 500).T), "stream_tall"),
    "odd row length": (lambda: (_meta(513, 128), _meta(128, 255)), "general"),
    "bf16 broadcast": (lambda: (_meta(3, 70, 90, dtype=torch.float32),
                                _meta(90, 33, dtype=torch.bfloat16)), "general"),
    "broadcast V": (lambda: (_meta(6, 96, 96), _meta(96, 8)), "stream_tall"),
}
for M, K, N in SWEEP:
    for dt in (torch.float64, torch.float32, torch.bfloat16):
        PLAN_CASES[f"sweep {M}x{K}x{N} {dt}"] = (
            lambda M=M, K=K, N=N, dt=dt: (_meta(M, K, dtype=dt), _meta(K, N, dtype=dt)), None)


@pytest.mark.parametrize("case", sorted(PLAN_CASES))
def test_plan_covers_every_element_once(case):
    """The planner's template and grid at the path's shapes, the sweep,
    K = 1 and broadcast operands: every (batch, m, n, k) computed once."""
    make, template = PLAN_CASES[case]
    a, b = make()
    geom = tm.geometry(a, b)
    p = tm.plan(geom, a.element_size(), b.element_size())
    if template is not None:
        assert tm.TEMPLATES[p.template] == template
    _assert_exact_cover(p, *geom[:4])


def test_plan_streams_only_aligned_layouts():
    """A misaligned address, a row stride that is not a whole number of
    16-byte chunks, or no unit-stride axis takes the general template."""
    geom = tm.geometry(_meta(64, 64), _meta(64, 64))
    assert tm.plan(geom, 8, 8).template == tm.STREAM_TALL
    assert tm.plan(geom, 8, 8, a_misalign=8).template == tm.GENERAL
    assert tm.plan(geom, 8, 8, b_misalign=4).template == tm.GENERAL
    strided = tm.geometry(_meta(64, 128)[:, ::2], _meta(64, 64))
    assert tm.plan(strided, 8, 8).template == tm.GENERAL
    odd = tm.geometry(_meta(64, 65)[:, :64], _meta(64, 64))
    assert tm.plan(odd, 8, 8).template == tm.GENERAL


@pytest.mark.parametrize("shared_v", [False, True], ids=["per_client_V", "shared_V"])
def test_basis_project_matches_reference(shared_v):
    rng = np.random.default_rng(11 + shared_v)
    n, d, r = 3, 40, 7
    A = rng.standard_normal((n, d, d))
    A = (A + A.transpose(0, 2, 1)) / 2
    V = np.linalg.qr(rng.standard_normal((n, d, r)))[0]
    if shared_v:
        V = V[0]
    out = ops.basis_project(torch.from_numpy(V), torch.from_numpy(A))
    ref = jops.basis_project(jnp.asarray(V), jnp.asarray(A))
    assert out.dtype == torch.float32 and out.shape == (n, r, r)
    assert_close(out, ref)
    # and against the float64 Γ it stands in for
    want = np.einsum("dr,nde,es->nrs" if shared_v else "ndr,nde,nes->nrs", V, A, V)
    assert_close(out, want)


def test_basis_project_two_dimensional():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((24, 24))
    V = np.linalg.qr(rng.standard_normal((24, 6)))[0]
    out = ops.basis_project(torch.from_numpy(V), torch.from_numpy(A))
    assert_close(out, jops.basis_project(jnp.asarray(V), jnp.asarray(A)))


def test_glm_hessian_matches_reference():
    rng = np.random.default_rng(9)
    A = rng.standard_normal((60, 120))
    w = rng.random(60)
    out = ops.glm_hessian(torch.from_numpy(A), torch.from_numpy(w), 1e-3)
    ref = jops.glm_hessian(jnp.asarray(A), jnp.asarray(w), 1e-3)
    assert_close(out, ref)
    assert_close(out, (A.T * w) @ A / 60 + 1e-3 * np.eye(120))


@pytest.mark.parametrize("a,b,err", [
    (torch.ones((4, 8), dtype=torch.int32), torch.ones((8, 2)), TypeError),
    (torch.ones((4, 8), dtype=torch.float16), torch.ones((8, 2)), TypeError),
    (torch.ones((8,)), torch.ones((8, 2)), ValueError),
    (torch.ones((2, 3, 4, 8)), torch.ones((8, 2)), ValueError),
    (torch.ones((4, 8)), torch.ones((7, 2)), ValueError),
    (torch.ones((3, 4, 8)), torch.ones((2, 8, 2)), ValueError),
])
def test_wrapper_raises_on_unsupported_input(a, b, err):
    with pytest.raises(err):
        tm.matmul(a, b)


def test_cpu_tensors_take_plain_version_without_counting():
    before = tm.launches
    tm.matmul(torch.ones((3, 4)), torch.ones((4, 2)))
    ops.basis_project(torch.ones((4, 2)), torch.ones((2, 4, 4)))
    assert tm.launches == before


def test_kernel_is_built_from_its_source():
    path = _build.library_path("tiled_matmul")
    assert path.parent == _build.BUILD_DIR and path.name.startswith("tiled_matmul-")
    from repro_torch.kernels import SOURCES

    assert "tiled_matmul" in SOURCES and (_build.CSRC / "tiled_matmul.cu").is_file()


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,K,N", SWEEP[:3])
def test_ops_matmul_is_the_references(M, K, N, out_dtype):
    """`ops.matmul(a, b, out_dtype)` (kernel 3's entry point) against the
    reference's `ops.matmul`; the output type is the one asked for."""
    rng = np.random.default_rng(M + K + N)
    a = rng.standard_normal((M, K)).astype(np.float32)
    b = rng.standard_normal((K, N)).astype(np.float32)
    jt, tt = DTYPES[out_dtype]
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b), out_dtype=tt)
    want = np.asarray(jops.matmul(jnp.asarray(a), jnp.asarray(b), out_dtype=jt), np.float32)
    assert got.dtype == tt and tuple(got.shape) == (M, N)
    tol = TOL if out_dtype == "float32" else 2.0 ** -8     # one bfloat16 rounding
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tol * max(float(np.abs(want).max()), 1.0))
