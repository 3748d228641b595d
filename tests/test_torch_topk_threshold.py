"""The port's exact Top-K threshold (`repro_torch.kernels.topk_threshold`)
against the reference Pallas kernel, bitwise.

On the CPU the wrapper runs its plain PyTorch version; the CUDA kernel is
held against the same plain version on the card by chip_smoke.py.  Every
comparison here is bitwise (int32 views), the reference's own contract:
the threshold equals the k-th largest value and `keep_mask` keeps exactly
k entries per row.  The kernels' radix select is held to the same
thresholds through its PyTorch emulation, and the fused kernel's plan (one
cluster launch or two) is checked for the columns its blocks sum.
"""
import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import topk_threshold as jtk
from repro_torch.kernels import _build
from repro_torch.kernels import topk_threshold as ttk


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rows(kind: str, rows: int, T: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "random":
        return np.abs(rng.standard_normal((rows, T))).astype(np.float32)
    if kind == "ties":
        return rng.integers(0, 4, (rows, T)).astype(np.float32)
    if kind == "zeros":
        return np.zeros((rows, T), np.float32)
    if kind == "inf":
        a = np.abs(rng.standard_normal((rows, T))).astype(np.float32)
        a[:, rng.integers(0, T, max(1, T // 8))] = np.inf
        return a
    if kind == "subnormal":
        tiny = np.finfo(np.float32).smallest_subnormal
        return (rng.integers(0, 20, (rows, T)) * tiny).astype(np.float32)
    if kind == "neg_zero":
        a = np.where(rng.random((rows, T)) < 0.5, -0.0,
                     rng.standard_normal((rows, T))).astype(np.float32)
        return np.abs(a)
    raise ValueError(kind)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _np_keep_mask(a: np.ndarray, t: np.ndarray, k: int) -> np.ndarray:
    """`keep_mask` in numpy, which compares subnormals exactly."""
    above = a > t
    eq = a == t
    return above | (eq & (np.cumsum(eq, axis=-1) <= k - above.sum(-1, keepdims=True)))


CASES = [(kind, rows, T, k)
         for kind, rows, T in (("random", 10, 576), ("random", 7, 333),
                               ("ties", 6, 200), ("zeros", 3, 64),
                               ("inf", 4, 96), ("subnormal", 4, 96),
                               ("neg_zero", 4, 96))
         for k in (1, 5, T // 2, T)]


@pytest.mark.parametrize("kind,rows,T,k", CASES)
def test_plain_threshold_and_mask_match_reference_bitwise(kind, rows, T, k):
    a = _rows(kind, rows, T, seed=rows * 1000 + T + k)
    t_port = ttk.topk_row_threshold(torch.from_numpy(a), k)
    t_pallas = jtk.topk_row_threshold(jnp.asarray(a), k, interpret=True)
    t_topk = jax.lax.top_k(jnp.asarray(a), k)[0][:, -1:]
    assert t_port.shape == (rows, 1) and t_port.dtype == torch.float32
    np.testing.assert_array_equal(_bits(t_port.numpy()), _bits(t_pallas))
    np.testing.assert_array_equal(_bits(t_port.numpy()), _bits(t_topk))

    m_port = ttk.keep_mask(torch.from_numpy(a), t_port, k).numpy()
    np.testing.assert_array_equal(m_port, _np_keep_mask(a, t_port.numpy(), k))
    assert (m_port.sum(axis=1) == k).all()
    if kind != "subnormal":
        # XLA on the CPU treats subnormal operands of a comparison as zero,
        # so only the exact masks above hold the subnormal rows
        m_ref = np.asarray(jtk.keep_mask(jnp.asarray(a), t_pallas, k))
        np.testing.assert_array_equal(m_port, m_ref)


def test_torch_topk_agrees_with_plain_version():
    """The library call chip_smoke.py times beside the kernel selects the
    same threshold (on the CPU, against the plain version)."""
    a = torch.from_numpy(_rows("random", 16, 1024, seed=5))
    for k in (1, 32, 1024):
        t_lib = torch.topk(a, k, dim=1).values[:, -1:].contiguous()
        assert torch.equal(ttk.topk_row_threshold_plain(a, k).view(torch.int32),
                           t_lib.view(torch.int32))


@pytest.mark.parametrize("k,kk", [(0, 1), (-3, 1), (40, 40), (41, 40), (10**6, 40)])
def test_k_is_clamped_to_row(k, kk):
    a = torch.from_numpy(_rows("random", 3, 40, seed=k % 97))
    want = torch.topk(a, kk, dim=1).values[:, -1:]
    assert torch.equal(ttk.topk_row_threshold(a, k), want)
    ref = jtk.topk_row_threshold(jnp.asarray(a.numpy()), k, interpret=True)
    np.testing.assert_array_equal(_bits(ttk.topk_row_threshold(a, k).numpy()), _bits(ref))


@pytest.mark.parametrize("bad,err", [
    (torch.ones((4, 8), dtype=torch.float64), TypeError),
    (torch.ones((2, 4, 8), dtype=torch.float32), ValueError),
    (torch.ones((8,), dtype=torch.float32), ValueError),
    (torch.ones((8, 4), dtype=torch.float32).T, ValueError),
])
def test_wrapper_raises_on_unsupported_input(bad, err):
    with pytest.raises(err):
        ttk.topk_row_threshold(bad, 2)


def test_cpu_tensor_takes_plain_version_without_counting():
    before = ttk.launches
    a = torch.from_numpy(_rows("random", 2, 16, seed=1))
    ttk.topk_row_threshold(a, 3)
    assert ttk.launches == before


def test_kernel_library_is_keyed_on_source_hash():
    path = _build.library_path("topk_threshold")
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("topk_threshold-") and path.suffix == ".so"
    assert path == _build.library_path("topk_threshold")
    assert (_build.CSRC / "topk_threshold.cu").is_file()


# --------------------------------------------------------------------------
# the fused compress-sum codec (BL-DNN's Fisher leg)
# --------------------------------------------------------------------------
def _signed(kind: str, rows: int, T: int, seed: int) -> np.ndarray:
    """Signed rows: the codec selects on |v| and keeps the signs."""
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.standard_normal((rows, T)).astype(np.float32)
    if kind == "ties":
        return (rng.integers(-3, 4, (rows, T))).astype(np.float32)
    if kind == "zeros":
        return np.zeros((rows, T), np.float32)
    raise ValueError(kind)


#: fig-dnn's four parameter leaves, flattened: (clients, numel) and the
#: per-leaf budget k = ⌊0.1·numel⌋; plus a clamped k
COMPRESS_SUM_CASES = [(kind, rows, T, k)
                      for kind in ("random", "ties", "zeros")
                      for rows, T, k in ((8, 3072, 307), (8, 2048, 204), (8, 128, 12),
                                         (3, 40, 10 ** 6))]


@pytest.mark.parametrize("kind,rows,T,k", COMPRESS_SUM_CASES)
def test_plain_compress_sum_matches_reference_kernel(kind, rows, T, k):
    v = _signed(kind, rows, T, seed=rows * 7 + T + k % 97)
    dense, col_sum = ttk.topk_compress_sum(torch.from_numpy(v), k)
    j_dense, j_sum = jtk.topk_compress_sum(jnp.asarray(v), k, interpret=True)
    np.testing.assert_array_equal(_bits(dense.numpy()), _bits(j_dense))
    kk = max(1, min(k, T))
    assert ((dense != 0).sum(dim=1) <= kk).all()
    # the row-order sum against XLA's reduction: within n ulps of the
    # column's magnitude
    tol = rows * np.finfo(np.float32).eps * np.abs(np.asarray(j_dense)).sum(axis=0)
    assert (np.abs(col_sum.numpy() - np.asarray(j_sum)) <= tol).all()
    # and the two-pass selection of the threshold kernel, bitwise
    a32 = torch.from_numpy(np.abs(v))
    two_pass = torch.where(ttk.keep_mask(a32, ttk.topk_row_threshold(a32, kk), kk),
                           torch.from_numpy(v), 0.0)
    np.testing.assert_array_equal(_bits(dense.numpy()), _bits(two_pass.numpy()))


def test_plain_compress_sum_sums_rows_in_order():
    v = torch.from_numpy(_signed("random", 5, 64, seed=2))
    dense, col_sum = ttk.topk_compress_sum_plain(v, 16)
    want = dense[0].clone()
    for row in dense[1:]:
        want = want + row
    assert torch.equal(col_sum.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("bad,err", [
    (torch.ones((4, 8), dtype=torch.float64), TypeError),
    (torch.ones((2, 4, 8), dtype=torch.float32), ValueError),
    (torch.ones((8, 4), dtype=torch.float32).T, ValueError),
])
def test_compress_sum_raises_on_unsupported_input(bad, err):
    with pytest.raises(err):
        ttk.topk_compress_sum(bad, 2)


def test_compress_sum_on_cpu_does_not_count_launches():
    before = ttk.compress_sum_launches
    ttk.topk_compress_sum(torch.from_numpy(_signed("random", 2, 16, seed=1)), 3)
    assert ttk.compress_sum_launches == before


# --------------------------------------------------------------------------
# the kernels' radix select, emulated in PyTorch, and the fused kernel's plan
# --------------------------------------------------------------------------
def _signed_zero_rows(rows: int, T: int, seed: int) -> np.ndarray:
    """Non-negative rows with half their entries the pattern of -0.0."""
    rng = np.random.default_rng(seed)
    a = np.abs(rng.standard_normal((rows, T))).astype(np.float32)
    a[rng.random((rows, T)) < 0.5] = -0.0
    return a


RADIX_CASES = [(kind, rows, T, k)
               for kind, rows, T in (("random", 5, 300), ("random", 3, 1000),
                                     ("ties", 4, 257), ("zeros", 2, 64), ("inf", 3, 300),
                                     ("subnormal", 3, 300), ("neg_zero", 3, 300),
                                     ("signed_zero", 3, 300))
               for k in (1, T // 2, T)]


def _radix_rows(kind: str, rows: int, T: int, seed: int) -> np.ndarray:
    if kind == "signed_zero":
        return _signed_zero_rows(rows, T, seed)
    return _rows(kind, rows, T, seed)


@pytest.mark.parametrize("kind,rows,T,k", RADIX_CASES)
def test_radix_emulation_matches_plain_and_reference_bitwise(kind, rows, T, k):
    """The kernels' four-pass radix select finds the plain version's and
    the reference Pallas kernel's threshold, bit for bit (T is no multiple
    of 256 but in the 64-key case; a -0.0 pattern counts as +0.0, as in
    both)."""
    a = _radix_rows(kind, rows, T, seed=rows * 1000 + T + k)
    t_radix, _ = ttk.topk_row_threshold_radix_emulated(torch.from_numpy(a), k)
    t_plain = ttk.topk_row_threshold_plain(torch.from_numpy(a), k)
    t_pallas = jtk.topk_row_threshold(jnp.asarray(a), k, interpret=True)
    assert t_radix.shape == (rows, 1) and t_radix.dtype == torch.float32
    np.testing.assert_array_equal(_bits(t_radix.numpy()), _bits(t_plain.numpy()))
    np.testing.assert_array_equal(_bits(t_radix.numpy()), _bits(t_pallas))


@pytest.mark.parametrize("kind,rows,T,k", RADIX_CASES)
def test_radix_emulation_counts_keys_above_threshold(kind, rows, T, k):
    """The count of keys above t that the passes accumulate (what the fused
    kernel keeps before its ties) is the direct count."""
    a = torch.from_numpy(_radix_rows(kind, rows, T, seed=rows * 1000 + T + k))
    t, above = ttk.topk_row_threshold_radix_emulated(a, k)
    assert above.shape == (rows, 1)
    assert torch.equal(above, (a > t).sum(dim=1, keepdim=True))
    assert bool((above < min(k, T)).all())


@pytest.mark.parametrize("n", [1, 3, 8, 9, 512])
@pytest.mark.parametrize("T,fits", [(128, True), (3072, True), (16384, True), (5001, True),
                                    (40960, True), (40961, False), (50000, False)])
def test_compress_sum_plan_takes_one_cluster_launch_exactly_for_small_stacks(n, T, fits):
    plan = ttk.compress_sum_plan(n, T)
    assert plan.cluster == (n <= ttk.MAX_CLUSTER and fits)
    assert plan.launches == (1 if plan.cluster else 2)
    assert (plan.stage, plan.run) == ttk.row_stage(T, ttk._COMPRESS_SUM_SMEM_LIMIT)
    assert (plan.stage == "global") == (not fits)
    assert plan.slice_cols == (-(-T // n) if plan.cluster else 0)


@pytest.mark.parametrize("T,smem_limit,stage", [
    (1, 48 * 1024, "registers"), (576, 48 * 1024, "registers"), (3072, 48 * 1024, "registers"),
    (17 * 256, 48 * 1024, "registers"), (17 * 256 + 1, 48 * 1024, "shared"),
    (12288, 48 * 1024, "shared"), (12289, 48 * 1024, "global"),
    (20000, 160 * 1024, "shared"), (50000, 160 * 1024, "global")])
def test_row_stage_takes_registers_then_shared_then_global(T, smem_limit, stage):
    """Both kernels' rows: runs of up to 17 keys a thread in registers, a
    longer row staged in shared memory when it fits, else read from global
    memory; the runs are odd and cover the row."""
    got, run = ttk.row_stage(T, smem_limit)
    assert got == stage
    assert run % 2 == 1 and run * ttk.THREADS >= T and (run - 2) * ttk.THREADS < T
    assert (run <= ttk.MAX_REGISTER_RUN) == (stage == "registers")


@pytest.mark.parametrize("n,T", [(1, 3072), (3, 2048), (8, 3072), (8, 128), (8, 3), (7, 1030),
                                 (5, 5001)])
def test_cluster_column_slices_cover_columns_once_and_sum_in_row_order(n, T):
    """Each cluster block sums its slice of columns over the rows in order
    from +0.0: the slices cover every column exactly once, and the
    slice-wise sums are bitwise the plain version's column sum, a column of
    -0.0 included (it sums to +0.0)."""
    plan = ttk.compress_sum_plan(n, T)
    assert plan.cluster
    cover = np.zeros(T, np.int64)
    for c0, c1 in plan.column_slices():
        assert 0 <= c0 <= c1 <= T
        cover[c0:c1] += 1
    assert (cover == 1).all()

    v = _signed("random", n, T, seed=n * 31 + T)
    v[:, T // 2] = -0.0
    dense, col_sum = ttk.topk_compress_sum_plain(torch.from_numpy(v), T)
    assert (_bits(dense[:, T // 2].numpy()) == _bits(np.float32(-0.0))).all()
    sliced = torch.empty(T)
    for c0, c1 in plan.column_slices():
        acc = torch.zeros(c1 - c0)
        for row in dense[:, c0:c1]:
            acc = acc + row
        sliced[c0:c1] = acc
    np.testing.assert_array_equal(_bits(sliced.numpy()), _bits(col_sum.numpy()))
    assert _bits(col_sum.numpy())[T // 2] == 0


def test_bind_sets_the_prototype_once(monkeypatch):
    """The wrappers' ctypes entry points are bound once per process, not
    on every call."""
    loads = []

    class Entry:
        argtypes = restype = None

    def load(name):
        loads.append(name)
        return type("Lib", (), {"entry": Entry()})()

    monkeypatch.setattr(_build, "load", load)
    name = f"fake-{id(loads)}"
    first = _build.bind(name, "entry", (ctypes.c_void_p, ctypes.c_int))
    again = _build.bind(name, "entry", (ctypes.c_void_p, ctypes.c_int))
    assert first is again and loads == [name]
    assert first.argtypes == [ctypes.c_void_p, ctypes.c_int] and first.restype is ctypes.c_int


# --------------------------------------------------------------------------
# the global Top-K entry points: topk_threshold and ops.topk_compress
# --------------------------------------------------------------------------
#: the reference's own sweep (tests/test_kernels.py)
GLOBAL_SWEEP = [((64, 64), 10), ((100, 100), 50), ((33, 77), 1), ((128,), 100),
                ((16, 16, 16), 64)]


@pytest.mark.parametrize("shape,k", GLOBAL_SWEEP, ids=str)
def test_topk_threshold_sweep(shape, k):
    """The threshold is the exact k-th largest |x| (and torch.topk's), the
    kept set everything above it plus the earliest of its ties, exactly
    min(k, numel) entries — bit for bit the reference's three outputs."""
    x = np.random.default_rng(k).standard_normal(shape).astype(np.float32)
    out, t, kept = ttk.topk_threshold(torch.from_numpy(x), k)
    jout, jt, jkept = jtk.topk_threshold(jnp.asarray(x), k)
    kk = min(k, x.size)
    flat = np.abs(x).ravel()
    assert int(kept) == kk == int(jkept)
    assert float(t) == np.sort(flat)[-kk] == float(jt)
    assert float(t) == float(torch.topk(torch.from_numpy(flat), kk).values[-1])
    assert out.shape == x.shape and out.dtype == torch.float32
    np.testing.assert_array_equal(out.numpy().view(np.int32), np.asarray(jout).view(np.int32))
    kept_mask = out.numpy().ravel() != 0
    assert kept_mask[flat > float(t)].all() and not kept_mask[flat < float(t)].any()
    # the plain twin the card's check holds the kernel route to
    for a, b in zip(ttk.topk_threshold_plain(torch.from_numpy(x), k), (out, t, kept)):
        assert torch.equal(a, b)


def test_topk_threshold_ties_zeros_and_k_zero():
    ones = torch.ones((10, 10))
    out, t, kept = ttk.topk_threshold(ones, 7)
    assert int(kept) == 7 and float(t) == 1.0
    assert out.ravel().nonzero().ravel().tolist() == list(range(7))   # earliest ties
    out0, t0, kept0 = ttk.topk_threshold(torch.zeros((10, 10)), 7)
    assert float(t0) == 0.0 and int(kept0) == 7
    for k in (0, -2):
        outz, tz, keptz = ttk.topk_threshold(ones, k)
        assert int(keptz) == 0 and float(tz) == float("inf") and not outz.any()
        jz = jtk.topk_threshold(jnp.ones((10, 10), jnp.float32), k)
        assert float(jz[1]) == float(tz) and int(jz[2]) == int(keptz)
    # k above numel keeps everything
    _, t_all, kept_all = ttk.topk_threshold(torch.arange(1.0, 7.0), 100)
    assert int(kept_all) == 6 and float(t_all) == 1.0


@pytest.mark.parametrize("shape,k", GLOBAL_SWEEP[:3], ids=str)
def test_ops_topk_compress_is_the_references(shape, k):
    from repro.kernels import ops as jops
    from repro_torch.kernels import ops

    x = np.random.default_rng(k + 1).standard_normal(shape).astype(np.float32)
    dense, kept = ops.topk_compress(torch.from_numpy(x), k)
    jdense, jkept = jops.topk_compress(jnp.asarray(x), k)
    np.testing.assert_array_equal(dense.numpy().view(np.int32), np.asarray(jdense).view(np.int32))
    assert int(kept) == int(jkept)


def test_topk_threshold_on_cpu_does_not_count_launches():
    before = ttk.launches
    ttk.topk_threshold(torch.randn(50), 5)
    assert ttk.launches == before
