"""The port's threefry2x32 PRNG (`repro_torch.core.prng`) against
`jax.random`, bitwise, in both settings of ``jax_threefry_partitionable``.

Every jax call runs under ``jax.threefry_partitionable(flag)`` and every
port call under ``prng.threefry_partitionable(flag)`` (or its explicit
``partitionable=`` argument), so no test leaves a setting behind.  Shapes
with odd and even element counts matter: the original layout pads an odd
counter array.  The JAX package runs with x64 on, so a Python-float ``p``
draws float64 uniforms and `randint` defaults to int64.

``python tests/test_torch_prng.py`` rewrites the committed table of jax
draws (``src/repro_torch/exp/data/prng_table.json``) that ``chip_smoke.py``
holds the card's draws to.
"""
import json
import math
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rounds as jrounds  # noqa: F401  (turns on x64, as the package does)
from repro_torch.core import prng, xla_math
from repro_torch.exp import problems
from repro_torch.kernels import threefry_normal as tn

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repo root's smoke script: its table adapter)

TABLE = problems.DATA / "prng_table.json"
SEEDS = (0, 3, 2**40 + 7, -1)
SETTINGS = (False, True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _np(x) -> np.ndarray:
    """A draw as numpy: bools stay bool, integer words int64."""
    a = np.asarray(x)
    return a if a.dtype.kind in "bf" else a.astype(np.int64)


def _same(jx, tx):
    a, b = _np(jx), tx.numpy()
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (a.shape, b.shape, a.dtype, b.dtype)
    if a.dtype.kind == "f":
        assert a.dtype == b.dtype
        assert a.tobytes() == b.tobytes(), (a, b)
    else:
        np.testing.assert_array_equal(a, b)


@pytest.fixture(params=SETTINGS, ids=["original", "partitionable"])
def setting(request):
    with jax.threefry_partitionable(request.param), \
            prng.threefry_partitionable(request.param):
        yield request.param


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    _same(jax.random.PRNGKey(seed), prng.PRNGKey(seed))


@pytest.mark.parametrize("num", [1, 2, 3, 4, 17, 24])
@pytest.mark.parametrize("seed", SEEDS[:3])
def test_split(setting, seed, num):
    _same(jax.random.split(jax.random.PRNGKey(seed), num),
          prng.split(prng.PRNGKey(seed), num))


@pytest.mark.parametrize("data", [0, 5, 2**31, 2**32 - 1])
def test_fold_in(setting, data):
    _same(jax.random.fold_in(jax.random.PRNGKey(7), data),
          prng.fold_in(prng.PRNGKey(7), data))


@pytest.mark.parametrize("data", [-1, 2**32])
def test_fold_in_refuses_what_is_not_a_uint32(data):
    with pytest.raises(OverflowError):
        jax.random.fold_in(jax.random.PRNGKey(7), data)
    with pytest.raises(ValueError, match="fold_in"):
        prng.fold_in(prng.PRNGKey(7), data)


SHAPES = [(), (1,), (5,), (6,), (3, 7), (2, 4)]


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_random_bits(setting, shape):
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    _same(jax.random.bits(jk, shape, jnp.uint32), prng.random_bits(tk, 32, shape))
    hi, lo = prng.random_bits(tk, 64, shape)
    b64 = np.asarray(jax.random.bits(jk, shape, jnp.uint64)).astype(np.uint64)
    np.testing.assert_array_equal((b64 >> np.uint64(32)).astype(np.int64), hi.numpy())
    np.testing.assert_array_equal((b64 & np.uint64(0xFFFFFFFF)).astype(np.int64), lo.numpy())


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_uniform(setting, shape, dtype):
    jk, tk = jax.random.PRNGKey(5), prng.PRNGKey(5)
    _same(jax.random.uniform(jk, shape, getattr(jnp, dtype)),
          prng.uniform(tk, shape, getattr(torch, dtype)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
def test_bernoulli_float64_from_a_python_p(setting, shape):
    """x64: a Python-float p draws float64 uniforms from 64-bit bits."""
    for p in (0.3, 0.5, 0.1):
        _same(jax.random.bernoulli(jax.random.PRNGKey(2), p, shape),
              prng.bernoulli(prng.PRNGKey(2), p, shape))


@pytest.mark.parametrize("T", [7, 8, 24])
def test_bernoulli_float32_from_a_tensor_p(setting, T):
    """The dithering's draw: float32 p of the key's batch and entry axes."""
    p = np.random.default_rng(T).random((3, T)).astype(np.float32)
    jks = jax.random.split(jax.random.PRNGKey(4), 3)
    want = jax.vmap(lambda k, pp: jax.random.bernoulli(k, pp))(jks, p)
    _same(want, prng.bernoulli(prng.split(prng.PRNGKey(4), 3), torch.tensor(p)))
    _same(jax.random.bernoulli(jks[0], p[0]), prng.bernoulli(prng.split(prng.PRNGKey(4), 3)[0],
                                                             torch.tensor(p[0])))


@pytest.mark.parametrize("dtype", ["int32", "int64"])
@pytest.mark.parametrize("span", [1, 2, 10, 512, 60000, 2**31 - 1])
@pytest.mark.parametrize("shape", [(), (5,), (6,)], ids=str)
def test_randint(setting, shape, span, dtype):
    jk, tk = jax.random.PRNGKey(9), prng.PRNGKey(9)
    _same(jax.random.randint(jk, shape, 0, span, getattr(jnp, dtype)),
          prng.randint(tk, shape, 0, span, getattr(torch, dtype)))
    _same(jax.random.randint(jk, shape, -3, span - 3, getattr(jnp, dtype)),
          prng.randint(tk, shape, -3, span - 3, getattr(torch, dtype)))


def test_randint_defaults_to_int64_and_empty_span(setting):
    jk, tk = jax.random.PRNGKey(1), prng.PRNGKey(1)
    want = jax.random.randint(jk, (4,), 0, 10)
    assert want.dtype == jnp.int64
    _same(want, prng.randint(tk, (4,), 0, 10))
    _same(jax.random.randint(jk, (3,), 5, 5), prng.randint(tk, (3,), 5, 5))


@pytest.mark.parametrize("n", [1, 2, 60, 1625, 1700])
def test_permutation(setting, n):
    """1625 and 1700 straddle the size where jax's shuffle takes a second
    round of stable sorts."""
    _same(jax.random.permutation(jax.random.PRNGKey(8), n),
          prng.permutation(prng.PRNGKey(8), n))


@pytest.mark.parametrize("n,shape,replace", [(60, (1,), False), (60, (5,), False),
                                             (7, (7,), False), (60, (4,), True),
                                             (10, (), True)])
def test_choice(setting, n, shape, replace):
    jks = jax.random.split(jax.random.PRNGKey(6), 4)
    tks = prng.split(prng.PRNGKey(6), 4)
    _same(jax.random.choice(jks[1], n, shape, replace=replace),
          prng.choice(tks[1], n, shape, replace=replace))
    _same(jax.vmap(lambda k: jax.random.choice(k, n, shape, replace=replace))(jks),
          prng.choice(tks, n, shape, replace=replace))


def test_batched_keys_split_and_bits(setting):
    jks = jax.random.split(jax.random.PRNGKey(3), 5)
    tks = prng.split(prng.PRNGKey(3), 5)
    _same(jax.vmap(lambda k: jax.random.split(k, 4))(jks), prng.split(tks, 4))
    _same(jax.vmap(lambda k: jax.random.bits(k, (9,), jnp.uint32))(jks),
          prng.random_bits(tks, 32, (9,)))
    _same(jax.vmap(lambda k: jax.random.fold_in(k, 3))(jks), prng.fold_in(tks, 3))


def test_host_and_tensor_paths_agree(monkeypatch):
    """A CPU key's small counts hash in Python ints; the tensor path (any
    device) gives the same words."""
    k = prng.PRNGKey(12)
    host = [prng.split(k, 4, partitionable=f) for f in SETTINGS] + [prng.fold_in(k, 3)]
    monkeypatch.setattr(prng, "HOST_PAIRS", 0)
    tensor = [prng.split(k, 4, partitionable=f) for f in SETTINGS] + [prng.fold_in(k, 3)]
    for a, b in zip(host, tensor):
        assert torch.equal(a, b)


def test_setting_is_scoped_and_explicit_argument_wins():
    k = prng.PRNGKey(0)
    orig, part = prng.split(k, partitionable=False), prng.split(k, partitionable=True)
    assert not torch.equal(orig, part)
    assert torch.equal(prng.split(k), orig)                 # the default: False
    with prng.threefry_partitionable(True):
        assert torch.equal(prng.split(k), part)
        assert torch.equal(prng.split(k, partitionable=False), orig)
    assert torch.equal(prng.split(k), orig)


NORMAL_SHAPES = [(), (1,), (7,), (1000,), (33, 77), (200_000,)]


@pytest.mark.parametrize("shape", NORMAL_SHAPES, ids=str)
@pytest.mark.parametrize("seed", [0, 1, 42])
def test_normal(setting, seed, shape):
    """float32 normals bit for bit: XLA's erf_inv and log1p with its fused
    multiply-adds (`xla_math`)."""
    _same(jax.random.normal(jax.random.PRNGKey(seed), shape, jnp.float32),
          prng.normal(prng.PRNGKey(seed), shape))


def test_normal_from_a_split_batch_of_keys(setting):
    jks = jax.random.split(jax.random.PRNGKey(7), 5)
    _same(jax.vmap(lambda k: jax.random.normal(k, (3, 11), jnp.float32))(jks),
          prng.normal(prng.split(prng.PRNGKey(7), 5), (3, 11)))


@pytest.mark.parametrize("n", [1, 2, 9, 10, 1001])
def test_normal_chunks_tile_the_draw(setting, n):
    """Chunks of any size (odd, even, larger than the draw) give the
    whole draw's values at their flat offsets."""
    whole = prng.normal(prng.PRNGKey(3), (n,))
    for chunk in ((1, 2, 3, 64) if n < 100 else (7, 64, 2000)):
        got = torch.empty(n)
        for start, z in prng.normal_chunks(prng.PRNGKey(3), (n,), chunk=chunk):
            got[start:start + z.numel()] = z
        assert got.view(torch.int32).equal(whole.view(torch.int32)), chunk
    # a window draws only the pieces that hold it, at their offsets
    lo, hi = n // 3, n // 3 + 2
    pieces = list(prng.normal_chunks(prng.PRNGKey(3), (n,), chunk=2, start=lo, stop=hi))
    covered = set()
    for start, z in pieces:
        assert z.view(torch.int32).equal(whole[start:start + z.numel()].view(torch.int32))
        covered |= set(range(start, start + z.numel()))
    assert set(range(lo, min(hi, n))) <= covered and len(pieces) <= 4


@pytest.mark.parametrize("lo,hi", [(-2.3, 7.1), (-1.0, 1.0), (0.5, 0.75), (-0.9999999403953552, 1.0)])
def test_uniform_float32_range(setting, lo, hi):
    """``floats·(hi − lo) + lo`` rounded once, as XLA's CPU code fuses it."""
    _same(jax.random.uniform(jax.random.PRNGKey(4), (2000,), jnp.float32, lo, hi),
          prng.uniform(prng.PRNGKey(4), (2000,), torch.float32, lo, hi))


def _exact_f32(v) -> float:
    """The float32 nearest the exact rational v (ties to even)."""
    from fractions import Fraction

    d = np.float32(float(v))                   # within one float32 ulp of v
    best = min((np.nextafter(d, np.float32(-np.inf)), d, np.nextafter(d, np.float32(np.inf))),
               key=lambda f: (abs(Fraction(float(f)) - v), int(np.float32(f).view(np.int32)) & 1))
    return float(best)


def test_fma_rounds_once():
    """`xla_math.fma` is the correctly rounded a·b + c, also where the
    float64 sum lands exactly halfway between two float32s and rounding it
    again would be wrong: (1 + 2⁻¹²)² = 1 + 2⁻¹¹ + 2⁻²⁴ is such a midpoint,
    and ±2⁻⁸⁰ decides its side."""
    from fractions import Fraction

    rng = np.random.default_rng(0)
    a, b, c = (rng.standard_normal(400).astype(np.float32) for _ in range(3))
    one = np.float32(1 + 2.0 ** -12)
    tiny = np.float32(2.0 ** -80)
    a2 = np.array([one, -one, one, one], np.float32)
    b2 = np.array([one, one, one, one], np.float32)
    c2 = np.array([tiny, -tiny, -tiny, 0.0], np.float32)
    A, B, C = (np.concatenate(z) for z in ((a, a2), (b, b2), (c, c2)))
    got = xla_math.fma(torch.tensor(A), torch.tensor(B), torch.tensor(C)).numpy()
    want = np.asarray([_exact_f32(Fraction(float(x)) * Fraction(float(y)) + Fraction(float(z)))
                       for x, y, z in zip(A, B, C)], np.float32)
    np.testing.assert_array_equal(got, want)
    # the cases bite: float64 then float32 rounds the first two wrongly
    twice = ((A.astype(np.float64) * B + C).astype(np.float32))[-4:]
    assert (twice != want[-4:]).tolist() == [True, True, False, False]


@pytest.mark.parametrize("fn", ["log", "log1p", "erf_inv"])
def test_xla_math_matches_xla(fn):
    rng = np.random.default_rng(1)
    if fn == "log":
        x = np.concatenate([np.arange(1, 300, dtype=np.float32),
                            np.exp(rng.standard_normal(20000) * 20).astype(np.float32),
                            np.array([0.0, np.inf, 1.0], np.float32)])
        want = jnp.log(jnp.asarray(x))
    elif fn == "log1p":
        x = (rng.random(20000) * 3 - 0.9999).astype(np.float32)
        want = jnp.log1p(jnp.asarray(x))
    else:
        x = np.concatenate([(rng.random(20000) * 2 - 1).astype(np.float32),
                            np.array([-1.0, 1.0, 0.0], np.float32)])
        want = jax.scipy.special.erfinv(jnp.asarray(x))
    _same(want, getattr(xla_math, fn)(torch.tensor(x)))


def test_bad_arguments_raise():
    k = prng.PRNGKey(0)
    with pytest.raises(ValueError, match="32 and 64"):
        prng.random_bits(k, 16, (2,))
    with pytest.raises(ValueError, match="float32 or float64"):
        prng.uniform(k, (2,), torch.float16)
    with pytest.raises(ValueError, match="float64 uniforms are drawn on"):
        prng.uniform(k, (2,), torch.float64, -1.0, 1.0)
    with pytest.raises(ValueError, match="float32"):
        prng.normal(k, (2,), torch.float64)
    with pytest.raises(ValueError, match="one"):
        list(prng.normal_chunks(prng.split(k, 2), (2,)))
    with pytest.raises(ValueError, match="int32 or int64"):
        prng.randint(k, (2,), 0, 3, torch.int16)
    with pytest.raises(ValueError, match="spans below"):
        prng.randint(k, (2,), 0, 2**31)
    with pytest.raises(ValueError, match="without replacement"):
        prng.choice(k, 3, (4,), replace=False)


@pytest.mark.parametrize("block,size", [(1001, 1001), (1001, 3 * 1001 + 17), (1000, 2500)])
def test_draws_past_a_block_split_the_key_as_jax(block, size):
    """From uint32's largest count of words on (2³² − 1: llama4-maverick's
    (128, 5120, 8192) expert leaves), jax's original layout splits the key
    into nblocks + 1 keys, hashes a whole block of counters under each of
    the first nblocks and the remainder under the last
    (`jax._src.prng._threefry_random_bits_original`).  The port's split, at
    a small block, against those primitives, windows included; the block is
    the one jax uses."""
    from jax._src import prng as jprng

    assert prng.M32 == int(np.iinfo(np.uint32).max)
    key = jax.random.PRNGKey(5)
    with jax.threefry_partitionable(False):
        nblocks, rem = divmod(size, block)
        keys = jprng.threefry_split(key, (nblocks + 1,))
        want = np.concatenate(
            [np.asarray(jprng.threefry_2x32(k, jax.lax.iota(np.uint32, block)))
             for k in keys[:-1]] + [np.asarray(jprng.threefry_2x32(
                 keys[-1], jax.lax.iota(np.uint32, rem)))]).astype(np.int64)
    got = np.empty(size, np.int64)
    for a, w in prng._bits32_chunks(prng.PRNGKey(5), size, torch.device("cpu"), False, 64,
                                    block=block):
        got[a:a + w.numel()] = w.numpy()
    np.testing.assert_array_equal(got, want)
    lo, hi = block - 5, min(size, block + 40)
    for a, w in prng._bits32_chunks(prng.PRNGKey(5), size, torch.device("cpu"), False, 16,
                                    lo, hi, block=block):
        np.testing.assert_array_equal(w.numpy(), want[a:a + w.numel()])


# --------------------------------------------------------------------------
# kernel 7 (`kernels.threefry_normal`): its launcher's geometry and its CPU route
# --------------------------------------------------------------------------
def _twin_words(size, lo, hi, part, key, block=prng.M32):
    """The words kernel 7 takes for the draws [lo, hi): its launcher's plan
    (`plan`, `block_keys`) walked pair by pair as the kernel walks it (pair
    p of a block hashes (p, h + p), the last counter 0 when the block is
    odd, and gives draws p and h + p; partitionable: (0, i) gives draw i as
    y0 ^ y1), hashed in Python integers: {flat index: uint32 word}."""
    table = tn.block_keys(key[None], size, part, block)[0].tolist()
    words = {}
    for r in tn.plan(size, lo, hi, part, block):
        for p in range(r.first, r.first + r.count):
            if part:
                y0, y1 = prng._threefry(*table[r.key], 0, p)
                out = [(r.off + p, y0 ^ y1)]
            else:
                x1 = 0 if (p == r.h - 1 and r.n % 2) else r.h + p
                y0, y1 = prng._threefry(*table[r.key], p, x1)
                out = [(r.off + p, y0)] + ([(r.off + r.h + p, y1)] if r.h + p < r.n else [])
            for i, w in out:
                if lo <= i < hi:
                    assert i not in words, i
                    words[i] = w
    return words


@pytest.mark.parametrize("size", [1, 2, 7, 8, 1000, 1001])
def test_launcher_geometry_picks_jax_normals_words(setting, size):
    """A pure-Python twin of kernel 7's launch (`plan`, `block_keys`,
    `sources`) picks, for odd and even sizes and for windows at the start,
    across h = ⌈n/2⌉ (where the original layout's pairs split) and at the
    end, exactly the words of ``jax.random.bits``, and through the port's
    transform exactly ``jax.random.normal``'s values."""
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(3), (size,), jnp.uint32))
    normal = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (size,), jnp.float32))
    h = (size + 1) // 2
    for lo, hi in ((0, size), (0, 3), (max(0, h - 3), min(size, h + 3)), (max(0, size - 2), size),
                   (size // 3, size // 3 + 5)):
        hi = min(hi, size)
        words = _twin_words(size, lo, hi, setting, prng.PRNGKey(3))
        assert sorted(words) == list(range(lo, hi)), (lo, hi)
        got = torch.tensor([words[i] for i in range(lo, hi)], dtype=torch.int64)
        np.testing.assert_array_equal(got.numpy(), bits[lo:hi].astype(np.int64))
        assert prng._normal_from_bits(got).numpy().tobytes() == normal[lo:hi].tobytes()


@pytest.mark.parametrize("block,size", [(1001, 1001), (1001, 3 * 1001 + 17), (1000, 2500)])
def test_launcher_geometry_splits_blocks_as_jax(block, size):
    """Past a block of counters (2³² − 1 in jax; a small ``block`` here)
    the twin's plan takes each block's words under its key of ``split(key,
    nblocks + 1)``, as jax's primitives draw them, also in a window across
    the first block's end, in at most `MAX_RANGES` ranges."""
    from jax._src import prng as jprng

    with jax.threefry_partitionable(False):
        nblocks, rem = divmod(size, block)
        keys = jprng.threefry_split(jax.random.PRNGKey(5), (nblocks + 1,))
        want = np.concatenate(
            [np.asarray(jprng.threefry_2x32(k, jax.lax.iota(np.uint32, block)))
             for k in keys[:-1]] + [np.asarray(jprng.threefry_2x32(
                 keys[-1], jax.lax.iota(np.uint32, rem)))]).astype(np.int64)
    for lo, hi in ((0, size), (block - 5, min(size, block + 40))):
        words = _twin_words(size, lo, hi, False, prng.PRNGKey(5), block)
        assert sorted(words) == list(range(lo, hi))
        np.testing.assert_array_equal([words[i] for i in range(lo, hi)], want[lo:hi])
        assert len(tn.plan(size, lo, hi, False, block)) <= tn.MAX_RANGES


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=str)
def test_kernel_wrapper_cpu_route_is_the_eager_draw(setting, dtype):
    """`threefry_normal` on a CPU ``out`` is the eager draw bit for bit —
    whole rows of a batch of keys, a window across h, a scale and the
    rounding to bfloat16 — launches nothing, and is `threefry_normal_plain`."""
    keys = prng.split(prng.PRNGKey(11), 3)
    n, lo, w = 1001, 480, 60
    whole = prng.normal(keys, (n,))
    tn.launches = 0
    out = tn.threefry_normal(torch.empty(3, n, dtype=dtype), keys, n, scale=0.02)
    assert out.view(torch.int16 if dtype == torch.bfloat16 else torch.int32).equal(
        (whole * 0.02).to(dtype).view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    part = torch.empty(3, w, dtype=dtype)
    tn.threefry_normal(part, keys, n, lo, scale=0.02)
    plain = tn.threefry_normal_plain(torch.empty(3, w, dtype=dtype), keys, n, lo, scale=0.02)
    assert torch.equal(part, out[:, lo:lo + w]) and torch.equal(plain, part)
    # a row of a wider buffer (a leaf's row stride)
    wide = torch.zeros(3, 2 * n, dtype=dtype)
    tn.threefry_normal(wide[:, :n], keys, n, scale=0.02)
    assert torch.equal(wide[:, :n], out) and not wide[:, n:].any()
    assert tn.launches == 0


def test_kernel_wrapper_refuses_what_it_cannot_draw():
    k = prng.PRNGKey(0)[None]
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        tn.threefry_normal(torch.empty(1, 4, dtype=torch.float64), k, 4)
    with pytest.raises(ValueError, match="unit inner stride"):
        tn.threefry_normal(torch.empty(4, 2)[:, :1].T, k, 4)
    with pytest.raises(ValueError, match="one \\(2,\\) key a row"):
        tn.threefry_normal(torch.empty(2, 4), k, 4)
    with pytest.raises(ValueError, match="outside"):
        tn.threefry_normal(torch.empty(1, 4), k, 6, start=3)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tn.threefry_normal(torch.empty(1, 4, device="meta"), k, 4)
    with pytest.raises(ValueError, match="partitionable=True"):
        tn.plan(prng.M32, 0, 8, True)


def test_every_init_leaf_is_one_launch():
    """Each row of every keyed leaf of the ten configs at full width (the
    largest, llama4-maverick's experts, past 2³² − 1 draws) plans into at
    most `MAX_RANGES` ranges: one launch a leaf."""
    from repro_torch import configs
    from repro_torch.models import model as M

    sizes = set()
    for arch in configs.ARCH_IDS:
        for name, leaf in chip_smoke._leaves(M.param_shapes(configs.get_config(arch))):
            if leaf.dim() >= 2 and not name.endswith("scale"):
                sizes.add(math.prod(leaf.shape[1:]) if name.startswith(("layers", "encoder"))
                          else leaf.numel())
    assert max(sizes) > prng.M32
    for n in sizes:
        for part in (False, True):
            if part and n >= prng.M32:
                continue
            ranges = tn.plan(n, 0, n, part)
            assert 1 <= len(ranges) <= tn.MAX_RANGES, (n, part)
            assert sum(r.count for r in ranges) == (n if part else sum(
                (r.n + 1) // 2 for r in ranges)), n


# --------------------------------------------------------------------------
# the committed table the card is held to (chip_smoke.py phase `prng`)
# --------------------------------------------------------------------------
class _Jax:
    """`chip_smoke.prng_draws`'s random module over `jax.random`."""

    PRNGKey = staticmethod(jax.random.PRNGKey)
    split = staticmethod(jax.random.split)
    fold_in = staticmethod(jax.random.fold_in)
    setting = staticmethod(jax.threefry_partitionable)

    @staticmethod
    def f32(values):
        return jnp.asarray(values, jnp.float32)

    @staticmethod
    def bernoulli(key, p, shape):
        return jax.random.bernoulli(key, p, shape)

    @staticmethod
    def randint(key, shape, lo, hi, dtype):
        return jax.random.randint(key, shape, lo, hi, getattr(jnp, dtype))

    @staticmethod
    def uniform(key, shape, dtype):
        return jax.random.uniform(key, shape, getattr(jnp, dtype))

    @staticmethod
    def normal(key, shape):
        return jax.random.normal(key, shape, jnp.float32)

    @staticmethod
    def choice(key, n, shape, replace):
        return jax.random.choice(key, n, shape, replace=replace)

    @staticmethod
    def tolist(x):
        return np.asarray(x).tolist()


def jax_table() -> dict:
    """The table of `jax.random` draws in both settings."""
    return chip_smoke.prng_table(_Jax)


def test_committed_table_is_jax():
    """The table the card is held to is jax's, draw for draw."""
    assert json.loads(TABLE.read_text()) == jax_table()


def test_port_draws_the_committed_table():
    """The port's draws of the table on the CPU, through the adapter
    chip_smoke.py holds the card's draws with."""
    assert chip_smoke.prng_table(chip_smoke.PortRandom(torch, prng, "cpu")) == \
        json.loads(TABLE.read_text())


if __name__ == "__main__":
    TABLE.write_text(json.dumps(jax_table(), sort_keys=True) + "\n")
    print(f"wrote {TABLE}")
