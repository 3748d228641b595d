"""Kernel 7's two launchers (`repro_torch.kernels.threefry_normal`) walked in
Python against `jax.random`, bitwise, in both settings of
``jax_threefry_partitionable``.

The CUDA kernels run only on the card (``chip_smoke.py`` phase prng holds
them to their plain versions there).  Here:

* the bits path's plan (`bits_plan`, `counters`, `slots`): for each word its
  counter pair, its key and the slot it lands in, hashed in Python integers,
  against ``jax.random.split`` / ``fold_in`` / ``bits`` / ``uniform`` /
  ``bernoulli``, single keys and batches, odd and even counts, 32 and 64
  bits, a ``p`` broadcast in float32 and float64; the wrapper's CPU route
  (its plain version) against the same walk;
* `core.prng`'s card route (every hash through `threefry_bits`) with the
  card swapped for the CPU, against jax;
* the normal launcher's warp tiles (`tiles`, `tile_slots`): their words,
  log1p's branch each draw selects, erf_inv's tail, and the lanes' vector
  and scalar stores (`store_lanes`), over windows and past a block of
  counters (a small ``block``);
* the wrappers refusing what they cannot run;
* `chip_smoke.bits_per_round`, the launches a round each phase of the
  script holds the card to, against the route's own count in a CPU run.
"""
import itertools
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
from repro_torch.exp import engine, problems
from repro_torch.kernels import threefry_normal as tn

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the repo root's smoke script: its launch counts)

SETTINGS = (False, True)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(params=SETTINGS, ids=["original", "partitionable"])
def setting(request):
    with jax.threefry_partitionable(request.param), \
            prng.threefry_partitionable(request.param):
        yield request.param


def _np(x) -> np.ndarray:
    a = np.asarray(x)
    return a if a.dtype.kind in "bf" else a.astype(np.int64)


def _same(jx, tx):
    a, b = _np(jx), tx.numpy()
    assert a.shape == b.shape and a.dtype.kind == b.dtype.kind, (a.shape, b.shape, a.dtype, b.dtype)
    assert a.tobytes() == b.astype(a.dtype).tobytes() if a.dtype.kind == "f" else \
        np.array_equal(a, b), (a, b)


# --------------------------------------------------------------------------
# the bits path's plan, walked word by word
# --------------------------------------------------------------------------
def _walk(bp, keys, shape, data=None, p=None, lo=0.0, hi=1.0) -> torch.Tensor:
    """The kernel's bits launch walked in Python: for each key row and pair
    i, its counters (`counters`), the Python-integer hash and the slots its
    words land in (`slots`), then each slot's value as the kernel computes
    it (prng's own unit floats, range and float64 mantissa)."""
    rows = keys.reshape(-1, 2).tolist() if keys.dim() > 1 else [keys.tolist()]
    words = [[None] * bp.width for _ in rows]
    for r, (k0, k1) in enumerate(rows):
        for i in range(bp.pairs):
            y0, y1 = prng._threefry(k0, k1, *tn.counters(bp, i, data))
            for slot, word in tn.slots(bp, i):
                assert words[r][slot] is None, (r, slot)
                words[r][slot] = {0: y0, 1: y1, "xor": y0 ^ y1, "wide": (y0, y1)}[word]
    assert all(w is not None for row in words for w in row)
    batch = tuple(keys.shape[:-1])
    if bp.form == tn.WIDE:
        hi_w = torch.tensor([[w[0] for w in row] for row in words], dtype=torch.int64)
        lo_w = torch.tensor([[w[1] for w in row] for row in words], dtype=torch.int64)
        vals = (((hi_w << 20) | (lo_w >> 12)) | 0x3FF0000000000000).view(torch.float64) - 1.0
    else:
        w = torch.tensor(words, dtype=torch.int64)
        if bp.value == tn.WORD:
            return w.reshape(batch + tuple(shape))
        vals = prng._scale_f32(prng._unit_floats(w), lo, hi)
    vals = vals.reshape(batch + tuple(shape))
    return vals < p if bp.value == tn.BOOL else vals


def _plain(bp, keys, shape, **kw) -> torch.Tensor:
    out = torch.empty(tuple(keys.shape[:-1]) + tuple(shape), dtype=bp.dtype)
    launched = tn.bits_launches
    tn.threefry_bits(out, keys, bp, **kw)
    assert tn.bits_launches == launched       # a CPU tensor takes the plain version
    return out


def _both(bp, keys, shape, **kw) -> torch.Tensor:
    """The walk, held bitwise to the wrapper's CPU route."""
    walked = _walk(bp, keys, shape, **kw)
    plain = _plain(bp, keys, shape, **kw)
    assert walked.dtype == plain.dtype and torch.equal(walked, plain)
    return walked


@pytest.mark.parametrize("num", [1, 2, 3, 7, 24])
@pytest.mark.parametrize("batch", [0, 3])
def test_bits_plan_split_is_jax(setting, num, batch):
    jk, tk = jax.random.PRNGKey(3), prng.PRNGKey(3)
    if batch:
        jk, tk = jax.random.split(jk, batch), prng.split(tk, batch)
        want = jax.vmap(lambda k: jax.random.split(k, num))(jk)
    else:
        want = jax.random.split(jk, num)
    _same(want, _both(tn.bits_plan("split", num, setting), tk, (num, 2)))


def test_bits_plan_fold_in_is_jax(setting):
    data = [0, 5, 2**31, 2**32 - 1, 7]
    want = jax.vmap(lambda i: jax.random.fold_in(jax.random.PRNGKey(7), i))(
        jnp.asarray(data, jnp.uint32))
    d = torch.tensor(data, dtype=torch.int64)
    _same(want, _both(tn.bits_plan("fold", len(data), setting), prng.PRNGKey(7), (len(data), 2),
                      data=d))
    for v in data:
        _same(jax.random.fold_in(jax.random.PRNGKey(7), v),
              _both(tn.bits_plan("fold1", 1, setting, base=v), prng.PRNGKey(7), (2,)))


BITS_SHAPES = [(1,), (7,), (8,), (3, 5), (2, 6)]


@pytest.mark.parametrize("shape", BITS_SHAPES, ids=str)
@pytest.mark.parametrize("batch", [0, 2])
def test_bits_plan_words_are_jax(setting, shape, batch):
    jk, tk = jax.random.PRNGKey(11), prng.PRNGKey(11)
    if batch:
        jk, tk = jax.random.split(jk, batch), prng.split(tk, batch)
    size = math.prod(shape)

    def jx(fn):
        return jax.vmap(fn)(jk) if batch else fn(jk)

    _same(jx(lambda k: jax.random.bits(k, shape, jnp.uint32)),
          _both(tn.bits_plan("bits32", size, setting), tk, shape))
    b64 = np.asarray(jx(lambda k: jax.random.bits(k, shape, jnp.uint64))).astype(np.uint64)
    w = _both(tn.bits_plan("bits64", size, setting), tk, (2, size))
    lead = tuple(tk.shape[:-1])
    np.testing.assert_array_equal((b64 >> np.uint64(32)).astype(np.int64),
                                  w[..., 0, :].reshape(lead + shape).numpy())
    np.testing.assert_array_equal((b64 & np.uint64(0xFFFFFFFF)).astype(np.int64),
                                  w[..., 1, :].reshape(lead + shape).numpy())
    _same(jx(lambda k: jax.random.uniform(k, shape, jnp.float32)),
          _both(tn.bits_plan("f32", size, setting), tk, shape))
    _same(jx(lambda k: jax.random.uniform(k, shape, jnp.float32, -2.3, 7.1)),
          _both(tn.bits_plan("f32", size, setting), tk, shape, lo=-2.3, hi=7.1))
    _same(jx(lambda k: jax.random.uniform(k, shape, jnp.float64)),
          _both(tn.bits_plan("f64", size, setting), tk, shape))


@pytest.mark.parametrize("T", [7, 8, 24])
def test_bits_plan_bernoulli_is_jax(setting, T):
    """float64 uniforms against a Python float and a float64 tensor p,
    float32 ones against a float32 p, each p broadcast over the keys'
    batch (a zero stride), over the entry axis, or full."""
    rng = np.random.default_rng(T)
    jks, tks = jax.random.split(jax.random.PRNGKey(4), 3), prng.split(prng.PRNGKey(4), 3)
    for p in (0.3, 0.5):
        _same(jax.vmap(lambda k: jax.random.bernoulli(k, p, (T,)))(jks),
              _both(tn.bits_plan("bool64", T, setting), tks, (T,), p=p))
    for dt, kind in ((np.float32, "bool32"), (np.float64, "bool64")):
        for pshape in ((3, T), (T,), (3, 1)):
            p = rng.random(pshape).astype(dt)
            full = np.broadcast_to(p, (3, T))
            want = jax.vmap(lambda k, pp: jax.random.bernoulli(k, pp))(jks, full)
            _same(want, _both(tn.bits_plan(kind, T, setting), tks, (T,), p=torch.tensor(p)))


def test_bits_plan_layouts():
    """The forms `prng._hash` lays out: the original layout's iota halves
    (h = ⌈n/2⌉, the last pair's second counter 0 when n is odd) and its
    64-bit (high, low) pairs; the partitionable pairs (0, i); fold_in's
    (0, data[i])."""
    bp = tn.bits_plan("bits32", 7, False)
    assert (bp.ctr, bp.pairs, bp.h, bp.odd, bp.form) == (tn.IOTA, 4, 4, True, tn.HALVES)
    assert [tn.counters(bp, i) for i in range(4)] == [(0, 4), (1, 5), (2, 6), (3, 0)]
    assert tn.slots(bp, 2) == [(2, 0), (6, 1)] and tn.slots(bp, 3) == [(3, 0)]
    bp = tn.bits_plan("f64", 5, False)
    assert [tn.counters(bp, i) for i in (0, 4)] == [(0, 5), (4, 9)]
    assert tn.slots(bp, 4) == [(4, "wide")]
    bp = tn.bits_plan("bits32", 5, True)
    assert [tn.counters(bp, i) for i in (0, 4)] == [(0, 0), (0, 4)]
    assert tn.slots(bp, 4) == [(4, "xor")]
    bp = tn.bits_plan("split", 3, True)
    assert tn.slots(bp, 1) == [(2, 0), (3, 1)] and bp.width == 6
    bp = tn.bits_plan("fold", 2, False)
    assert tn.counters(bp, 1, [9, 2**32 + 3]) == (0, 3)


# --------------------------------------------------------------------------
# prng's card route, the card swapped for the CPU
# --------------------------------------------------------------------------
@pytest.fixture
def card_route(monkeypatch):
    """Every hash `prng` makes takes its card route (`threefry_bits`), whose
    CPU tensors run the wrapper's plain version; counts the wrapper's
    calls."""
    calls = []
    real = tn.threefry_bits

    def counted(out, keys, bp, **kw):
        calls.append(bp)
        return real(out, keys, bp, **kw)

    monkeypatch.setattr(prng, "_on_card", lambda key, device: prng._out_device(key, device))
    monkeypatch.setattr(tn, "threefry_bits", counted)
    return calls


def test_card_route_draws_the_committed_table(card_route):
    """The committed table of jax draws (split, fold_in, bits, uniform,
    bernoulli, randint, permutation, choice, both settings) through the
    card route, one wrapper call a hash."""
    import json

    got = chip_smoke.prng_table(chip_smoke.PortRandom(torch, prng, "cpu"))
    want = json.loads((problems.DATA / "prng_table.json").read_text())
    assert got == want
    assert len(card_route) > 40


def test_card_route_one_call_a_hash(card_route, setting):
    """split, fold_in (a vector), random_bits (32 and 64), uniform and
    bernoulli make one call each, the comparison fused; randint and
    permutation one a `random_bits` (and a `split` of a batch)."""
    key, keys = prng.PRNGKey(5), prng.split(prng.PRNGKey(5), 3)
    assert len(card_route) == 1
    _same(jax.vmap(lambda k: jax.random.split(k, 4))(jax.random.split(jax.random.PRNGKey(5), 3)),
          prng.split(keys, 4))
    del card_route[:]
    prng.fold_in(key, torch.arange(6))
    prng.random_bits(keys, 32, (5,))
    prng.random_bits(keys, 64, (5,))
    prng.uniform(keys, (5,), torch.float32, -1.0, 2.0)
    prng.uniform(keys, (5,), torch.float64)
    prng.bernoulli(keys, 0.25, (5,))
    prng.bernoulli(keys, torch.rand(3, 5))
    assert len(card_route) == 7
    del card_route[:]
    _same(jax.random.permutation(jax.random.PRNGKey(8), 1700), prng.permutation(prng.PRNGKey(8),
                                                                                1700))
    assert len(card_route) == 2 * 2              # two rounds: a split and a random_bits each
    del card_route[:]
    _same(jax.random.randint(jax.random.PRNGKey(9), (5,), 0, 10),
          prng.randint(prng.PRNGKey(9), (5,), 0, 10))
    assert len(card_route) == 3                  # its split and two random_bits


# --------------------------------------------------------------------------
# the normal launcher's warp tiles
# --------------------------------------------------------------------------
def _tile_walk(size, lo, hi, part, key, block=prng.M32):
    """Kernel 7's normal launch walked tile by tile: each valid slot's word
    (`tile_slots`), then for each draw log1p's branch XLA selects (the
    kernel computes both and selects), erf_inv's polynomial (its tail
    only where the kernel's tail runs) and √2·u·p.  Returns ({flat index:
    word}, {flat index: float32 normal}, branch and store counts)."""
    table = tn.block_keys(key[None], size, part, block)[0].tolist()
    ranges = tn.plan(size, lo, hi, part, block)
    words, normals = {}, {}
    seen = {"rational": 0, "log": 0, "tail": 0, "vector": 0, "scalar": 0}
    for tile in tn.tiles(ranges, lo, hi, part):
        r = ranges[tile.range]
        # the tiles the kernel takes whole are exactly those with no clamp
        assert tile.full == (tile.lo == (0, 0) and tile.hi == (tn.HALF, tn.HALF))
        k0, k1 = table[r.key]
        slots = []
        for slot, lane, (x0, x1), word, flat in tn.tile_slots(tile, r, part):
            assert lane == (slot % tn.HALF) // tn.VEC
            y0, y1 = prng._threefry(k0, k1, x0, x1)
            w = {0: y0, 1: y1, "xor": y0 ^ y1}[word]
            assert flat not in words, flat
            words[flat] = w
            slots.append((flat, w))
        if not slots:
            continue
        flats = [f for f, _ in slots]
        u = prng._scale_f32(prng._unit_floats(torch.tensor([w for _, w in slots])),
                            prng._NORMAL_LO, 1.0)
        x = u * -u
        log = x.abs() >= xla_math._LOG1P_SMALL
        lval = torch.empty_like(u)
        lval[~log] = xla_math._log1p_small(x[~log])
        lval[log] = xla_math.log(x[log] + 1.0)
        far = ~(lval > -5.0)
        p = xla_math._erf_inv_poly(-2.5 - lval, xla_math._ERFINV_NEAR)
        p[far] = xla_math._erf_inv_poly(xla_math._sqrt(-lval[far]) - 3.0, xla_math._ERFINV_FAR)
        z = u * p * prng._SQRT2_F32
        normals.update(zip(flats, z.tolist()))
        seen["rational"] += int((~log).sum())
        seen["log"] += int(log.sum())
        seen["tail"] += int(far.sum())
        for how in tn.store_lanes(tile, lo, 2).values():
            if how in seen:
                seen[how] += 1
    return words, normals, seen


@pytest.mark.parametrize("size", [1, 7, 8, 255, 256, 257, 1001, 5000])
def test_normal_tiles_pick_jax_words_and_normals(setting, size):
    """The tiles of odd and even sizes, windows at the start, across h =
    ⌈n/2⌉, at the end and inside, take exactly the window's draws, each
    once, with jax's words; log1p and erf_inv through the branch each draw
    takes give ``jax.random.normal``'s bits."""
    bits = np.asarray(jax.random.bits(jax.random.PRNGKey(3), (size,), jnp.uint32))
    normal = np.asarray(jax.random.normal(jax.random.PRNGKey(3), (size,), jnp.float32))
    h = (size + 1) // 2
    seen_all = {}
    for lo, hi in ((0, size), (0, 3), (max(0, h - 3), min(size, h + 3)),
                   (max(0, size - 2), size), (size // 3, size // 3 + 300)):
        hi = min(hi, size)
        words, normals, seen = _tile_walk(size, lo, hi, setting, prng.PRNGKey(3))
        assert sorted(words) == list(range(lo, hi)), (lo, hi)
        np.testing.assert_array_equal([words[i] for i in range(lo, hi)],
                                      bits[lo:hi].astype(np.int64))
        got = np.asarray([normals[i] for i in range(lo, hi)], np.float32)
        assert got.tobytes() == normal[lo:hi].tobytes()
        for k, v in seen.items():
            seen_all[k] = seen_all.get(k, 0) + v
    if size >= 1001:
        assert seen_all["rational"] and seen_all["log"] and seen_all["tail"], seen_all


@pytest.mark.parametrize("block,size", [(1001, 1001), (1001, 3 * 1001 + 17), (1000, 2500)])
def test_normal_tiles_past_a_block_are_jax(block, size):
    """Past a block of counters (2³² − 1 in jax; a small ``block`` here)
    the tiles take each block's words under its key of ``split(key, nblocks
    + 1)``, also in a window across the first block's end."""
    from jax._src import prng as jprng

    with jax.threefry_partitionable(False):
        nblocks, rem = divmod(size, block)
        keys = jprng.threefry_split(jax.random.PRNGKey(5), (nblocks + 1,))
        want = np.concatenate(
            [np.asarray(jprng.threefry_2x32(k, jax.lax.iota(np.uint32, block)))
             for k in keys[:-1]] + [np.asarray(jprng.threefry_2x32(
                 keys[-1], jax.lax.iota(np.uint32, rem)))]).astype(np.int64)
    for lo, hi in ((0, size), (block - 5, min(size, block + 40))):
        words, _, _ = _tile_walk(size, lo, hi, False, prng.PRNGKey(5), block)
        assert sorted(words) == list(range(lo, hi))
        np.testing.assert_array_equal([words[i] for i in range(lo, hi)], want[lo:hi])


@pytest.mark.parametrize("part", SETTINGS)
@pytest.mark.parametrize("size,lo,hi", [(1001, 0, 1001), (1001, 3, 998), (5000, 17, 4000),
                                        (262144 * 2560, 0, 262144 * 2560)])
def test_store_lanes_cover_each_draw_once(part, size, lo, hi):
    """The stores: each lane's `VEC` draws of a stream go out as one
    8-byte vector (bfloat16) where all lie in the window on an 8-byte
    boundary, else one by one; together the lanes write each draw of a tile
    once.  The tiles the kernel takes as full (no clamps) are exactly those
    whose streams are whole.  At gemma3-4b's embedding (h a multiple of 4,
    the window the whole leaf) every full lane is a vector."""
    ranges = tn.plan(size, lo, hi, part)
    for tile in itertools.islice(tn.tiles(ranges, lo, hi, part), 64):
        lanes = tn.store_lanes(tile, lo, 2)
        covered = []
        for (lane, s), how in lanes.items():
            q0 = tn.VEC * lane
            mine = [q for q in range(q0, q0 + tn.VEC) if tile.lo[s] <= q < tile.hi[s]]
            assert (how == "none") == (not mine)
            if how == "vector":
                assert len(mine) == tn.VEC and (tile.d[s] + q0 - lo) * 2 % 8 == 0
            covered += [tile.d[s] + q for q in mine]
        valid = [tile.d[s] + q for s in (0, 1) for q in range(tile.lo[s], tile.hi[s])]
        assert tile.full == (tile.lo == (0, 0) and tile.hi == (tn.HALF, tn.HALF))
        assert sorted(covered) == sorted(valid) and len(set(covered)) == len(covered)
        if size == 262144 * 2560 and tile.hi == (tn.HALF, tn.HALF):
            assert set(lanes.values()) == {"vector"}


# --------------------------------------------------------------------------
# what the wrappers refuse
# --------------------------------------------------------------------------
def test_bits_wrapper_refuses_what_it_cannot_run():
    k, ks = prng.PRNGKey(0), prng.split(prng.PRNGKey(0), 3)
    bp = tn.bits_plan("bool32", 4, False)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tn.threefry_bits(torch.empty(3, 4, dtype=torch.bool, device="meta"), ks, bp,
                         p=torch.rand(3, 4))
    with pytest.raises(ValueError, match="does not broadcast"):
        tn.threefry_bits(torch.empty(3, 4, dtype=torch.bool), ks, bp, p=torch.rand(3, 5))
    with pytest.raises(TypeError, match="float32"):
        tn.threefry_bits(torch.empty(3, 4, dtype=torch.bool), ks, bp,
                         p=torch.rand(3, 4, dtype=torch.float64))
    with pytest.raises(TypeError, match="float32"):
        tn.threefry_bits(torch.empty(3, 4, dtype=torch.bool), ks, bp, p=0.5)
    with pytest.raises(ValueError, match="with a p"):
        tn.threefry_bits(torch.empty(3, 4, dtype=torch.bool), ks, bp)
    with pytest.raises(TypeError, match="torch.int64"):
        tn.threefry_bits(torch.empty(3, 4), ks, tn.bits_plan("bits32", 4, False))
    with pytest.raises(ValueError, match="contiguous"):
        tn.threefry_bits(torch.empty(3, 5, dtype=torch.int64), ks,
                         tn.bits_plan("bits32", 4, False))
    with pytest.raises(ValueError, match="data values"):
        tn.threefry_bits(torch.empty(3, 2, dtype=torch.int64), k, tn.bits_plan("fold", 3, False))
    with pytest.raises(ValueError, match="one key"):
        tn.threefry_bits(torch.empty(3, 3, 2, dtype=torch.int64), ks,
                         tn.bits_plan("fold", 3, False), data=torch.arange(3))
    with pytest.raises(ValueError, match="int64 keys"):
        tn.threefry_bits(torch.empty(4, dtype=torch.int64), k.to(torch.int32),
                         tn.bits_plan("bits32", 4, False))
    with pytest.raises(ValueError, match="unknown kind"):
        tn.bits_plan("normal", 4, False)


# --------------------------------------------------------------------------
# the launches a round chip_smoke.py holds the card to
# --------------------------------------------------------------------------
#: NL1 draws Rand-K from client keys split on the host, whose `permutation`
#: splits that host batch on the host; the count below sends every batch
#: hash to the card, so NL1's count is checked on the card alone
_COUNTED_CELLS = [c for c in (*problems.STOCHASTIC_CELLS, *problems.BASELINE_CELLS,
                              problems.BL2_XL_NARROW, problems.COHORT_SMOKE)
                  if c.name != "NL1"]


@pytest.mark.parametrize("cell", _COUNTED_CELLS, ids=lambda c: f"{c.experiment}/{c.name}")
def test_bits_per_round_counts_the_cells_draws(monkeypatch, cell):
    """Two rounds of the cell on the CPU, each hash counted where the card
    would launch the bits path (a call that names the fleet's device or
    hashes a batch of keys): `chip_smoke.bits_per_round` a round, and the
    history the eager route's bit for bit."""
    prob = problems.build_problem(cell.problem, device="cpu")
    steps = 2
    if cell is problems.COHORT_SMOKE:
        steps = cell.steps

    def run():
        if cell is problems.COHORT_SMOKE:
            return engine.run_cell(cell.exp, cell.cell, prob, device="cpu")
        return problems.run_cell(cell, prob, steps=steps)

    eager = run()
    calls = []
    real = tn.threefry_bits

    def counted(out, keys, bp, **kw):
        calls.append(bp)
        return real(out, keys, bp, **kw)

    monkeypatch.setattr(prng, "_on_card", lambda key, device: (
        prng._out_device(key, device) if device is not None or key.dim() > 1 else None))
    monkeypatch.setattr(tn, "threefry_bits", counted)
    routed = run()
    assert len(calls) == chip_smoke.bits_per_round(cell) * steps
    assert (routed.gaps, routed.up_bits, routed.down_bits) == \
        (eager.gaps, eager.up_bits, eager.down_bits)


def test_bits_per_round_of_the_dnn_cells():
    """fig-dnn/RTopK: each of the 4 leaves' gradient and Fisher legs splits
    its key into the 8 clients' and draws the dithering's levels, 16 a
    round; the Top-K and identity cells none."""
    for cell in problems.FIG_DNN.values():
        want = 16 if cell.name == "RTopK" else 0
        assert chip_smoke.bits_per_round(cell, 4) == want, cell.name
    assert chip_smoke.bits_per_round(problems.FIG1R1_CELLS["NL1"]) == 1
    assert chip_smoke.bits_per_round(problems.FIG1_XXL["BL2"]) == 2
    assert chip_smoke.bits_per_round(problems.BL2_XL) == 1
