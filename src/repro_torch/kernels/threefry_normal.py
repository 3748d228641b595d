"""Kernel 7: every threefry-2x32 hash the port makes on the card, fused,
through two entry points of one library — the CUDA kernels and their plain
versions.

Kernel 7 of the port replaces no Pallas kernel.  The reference draws every
LM weight with ``jax.random.normal`` (its `layers._init`) and every
per-round key, mask and compressor draw of its federated rounds with
``jax.random.split`` / ``fold_in`` / ``bits`` / ``uniform`` /
``bernoulli``, which the port matches bit for bit (`core.prng`: a
threefry-2x32 hash; for ``normal`` a uniform in (−1, 1) and XLA's CPU
``erf_inv``, `core.xla_math`).  Eagerly on the card a hash is ~100
elementwise launches and a chunk of 2²⁴ normals ~600; the kernels
(``csrc/threefry_normal.cu``, the hash and the float steps shared in
``csrc/threefry.cuh``) make one launch a call.

**The normal path.**  `threefry_normal(out, keys, size, start, scale)` fills
``out`` (rows, w), float32 or bfloat16, with ``(normal(keys[r],
(size,))[start:start + w] * scale).astype(out.dtype)`` for every row r of
the (rows, 2) keys (a stacked leaf, one key a row).  `plan` is the
launcher's geometry in Python: the window's draws as ranges of threefry
counter pairs, each inside one of jax's blocks of 2³² − 1 draws;
`block_keys` the keys of those blocks (computed on the host, only for a
leaf past one block; a batch of keys on the card is read there, one key
on the host goes with the launch as two words).  The kernel cuts each range
into warp tiles (`tiles`: `HALF` pairs, two streams of `HALF` draws in the
original layout), each warp a contiguous run of them, the tiles that lie
whole in the window (`full_tiles`) without clamps; lane l takes the `VEC`
consecutive pairs from p0 + `VEC`·l,
computes both of log1p's branches for each of its draws and selects (XLA's
own evaluation: no lane waits on another), runs erf_inv's tail only in a
warp that has a tail draw, and stores each stream's `VEC` draws as one
vector; `tile_slots` and `store_lanes` walk a tile as the kernel does, for
the tests.

**The bits path.**  `threefry_bits(out, keys, plan, data=, p=, lo=, hi=)`
hashes one `BitsPlan` — the counter pairs of one `prng` call, in the forms
``prng._hash`` lays out (`bits_plan`) — under one key or a batch, and
writes its words (int64), float32 or float64 uniforms, or bernoulli draws
``u < p`` into ``out``.  `core.prng` calls it for every hash whose result
lies on a CUDA device: `split`, `fold_in`, `random_bits`, `uniform`,
`bernoulli` (and through them `randint`, `permutation`, `choice`).

Each wrapper launches its kernel on a CUDA tensor and takes its plain
version (`threefry_normal_plain`, `threefry_bits_plain`: the eager hash of
`core.prng` on the tensor's device) only for a CPU one; any other device
raises.  ``launches`` counts the normal path's launches, ``bits_launches``
the bits path's.
"""
from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Iterator, Optional, Union

import torch

from ..core import prng
from . import _build

#: launches of the normal path's CUDA kernel since the last reset (the
#: plain version on a CPU tensor does not count)
launches = 0
#: launches of the bits path's CUDA kernel since the last reset
bits_launches = 0

#: ranges of counter pairs one launch takes (``kMaxRanges`` in the source)
MAX_RANGES = 8
#: consecutive pairs a lane takes a stream (``kLanePairs``), its draws of a
#: stream stored as one vector (8 bytes of bfloat16, 16 of float32)
VEC = 4
#: a warp tile's pairs a stream (``kHalf``): 32 lanes × `VEC` pairs
HALF = 32 * VEC
#: output types the normal path writes, by its code
_TYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_uint,
         ctypes.c_uint, ctypes.c_longlong, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong),
         ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
         ctypes.c_float, ctypes.c_void_p)


@dataclasses.dataclass(frozen=True)
class Range:
    """Counter pairs [first, first + count) of one block: the block's key
    (an index into the row's `block_keys`), its first flat index and its
    draws n, and h its pairs (⌈n/2⌉; n in the partitionable layout)."""
    key: int
    off: int
    n: int
    h: int
    first: int
    count: int


def _blocks(size: int, block: int):
    """(key index, first flat index, draws) of each block, as
    `prng._bits32_chunks` splits a draw of ``size``."""
    nblocks, rem = divmod(size, block)
    if not nblocks:
        return [(0, 0, size)]
    return [(b, b * block, block) for b in range(nblocks)] + [(nblocks, nblocks * block, rem)]


def plan(size: int, start: int, stop: int, partitionable: bool,
         block: int = prng.M32) -> list:
    """The ranges of counter pairs whose words hold the draws [start, stop)
    of a ``size``-draw leaf.  Original layout: pair p of a block of n draws
    gives draws p and h + p, so a window is up to two ranges of pairs a
    block (merged where they meet); partitionable: pair i gives draw i."""
    start, stop = max(0, int(start)), min(int(size), int(stop))
    if start >= stop:
        return []
    if partitionable:
        if size >= prng.M32:
            raise ValueError(f"normal draws fewer than 2**32 - 1 values under "
                             f"jax_threefry_partitionable=True, got {size}")
        return [Range(0, 0, size, size, start, stop - start)]
    out = []
    for key, off, n in _blocks(size, block):
        lo, hi = max(start, off) - off, min(stop, off + n) - off
        if lo >= hi:
            continue
        h = (n + 1) // 2
        spans = []
        if lo < h:
            spans.append([lo, min(hi, h)])
        if hi > h:
            a, b = max(lo, h) - h, hi - h
            if spans and a <= spans[0][1] and b >= spans[0][0]:
                spans[0] = [min(a, spans[0][0]), max(b, spans[0][1])]
            else:
                spans.append([a, b])
        out.extend(Range(key, off, n, h, a, b - a) for a, b in sorted(spans))
    return out


def block_keys(keys: torch.Tensor, size: int, partitionable: bool,
               block: int = prng.M32) -> torch.Tensor:
    """(rows, nkeys, 2): each row's key of every block of `_blocks` —
    ``split(key, nblocks + 1)`` past one block (the original layout), else
    the key itself."""
    nblocks = 0 if partitionable else size // block
    if not nblocks:
        return keys[:, None, :]
    return prng.split(keys, nblocks + 1, partitionable=False)


@dataclasses.dataclass(frozen=True)
class Tile:
    """One warp tile of the normal kernel: range ``range`` (an index into
    the plan), pairs from ``p0``; its two streams of `HALF` slots begin at
    the flat draws ``d`` = (dA, dB), and the slots of stream s in
    [lo[s], hi[s]) are draws of the window; ``full`` where the kernel skips
    the clamps (`full_tiles`)."""
    range: int
    p0: int
    d: tuple
    lo: tuple
    hi: tuple
    full: bool


def full_tiles(r: Range, start: int, stop: int, partitionable: bool) -> tuple:
    """The tiles [full0, full1) of range ``r`` (numbered from its first)
    whose two streams hold only draws of the range, below n and in [start,
    stop), as the kernel's host code bounds them: k·per between the largest
    lower bound and the smallest upper bound (per = `HALF`, 2·`HALF`
    partitionable)."""
    per = 2 * HALF if partitionable else HALF
    lower = start - r.off - r.first
    upper = min(r.count - per, stop - r.off - r.first - per)
    if not partitionable:
        lower = max(lower, start - r.off - r.h - r.first)
        upper = min(upper, r.n - r.h - r.first - HALF, stop - r.off - r.h - r.first - HALF)
    full0 = 0 if lower <= 0 else -(-lower // per)
    full1 = 0 if upper < 0 else upper // per + 1
    return full0, max(full0, full1)


def tiles(ranges: list, start: int, stop: int, partitionable: bool) -> Iterator[Tile]:
    """The warp tiles of one row, in the kernel's order (``tt``): each
    range cut into tiles of `HALF` pairs (2·`HALF` partitionable, whose
    second stream is the next `HALF` pairs), each tile's streams clipped
    to the range, to n and to the window, as the kernel computes them."""
    per = 2 * HALF if partitionable else HALF
    for j, r in enumerate(ranges):
        full0, full1 = full_tiles(r, start, stop, partitionable)
        for k, p0 in enumerate(range(r.first, r.first + r.count, per)):
            left = r.first + r.count - p0
            cap_a = min(left, HALF)
            if partitionable:
                d = (r.off + p0, r.off + p0 + HALF)
                cap_b = max(0, min(left - HALF, HALF))
            else:
                d = (r.off + p0, r.off + r.h + p0)
                cap_b = max(0, min(r.n - r.h - p0, cap_a))
            caps = (cap_a, cap_b)
            yield Tile(j, p0, d, tuple(min(max(start - d[s], 0), caps[s]) for s in (0, 1)),
                       tuple(min(max(stop - d[s], 0), caps[s]) for s in (0, 1)),
                       full0 <= k < full1)


def tile_slots(tile: Tile, r: Range, partitionable: bool) -> list:
    """The slots of a tile that hold draws of the window, in the kernel's
    order: (slot, lane, counter pair (x0, x1), word, flat index), ``word``
    0 or 1 (the pair's first or second word) or ``"xor"``.  Lane l hashes
    pairs p0 + `VEC`·l + v (v < `VEC`); stream 1's slot of that pair is
    `HALF` + `VEC`·l + v (partitionable: pair p0 + `HALF` + `VEC`·l + v)."""
    out = []
    for s in (0, 1):
        for q in range(tile.lo[s], tile.hi[s]):
            lane = q // VEC
            if partitionable:
                p = tile.p0 + s * HALF + q
                out.append((s * HALF + q, lane, (0, p), "xor", tile.d[s] + q))
            else:
                p = tile.p0 + q
                x1 = 0 if (p == r.h - 1 and r.n % 2) else r.h + p
                out.append((s * HALF + q, lane, (p, x1), s, tile.d[s] + q))
    return out


def store_lanes(tile: Tile, start: int, itemsize: int) -> dict:
    """The stores of a tile: lane l writes its `VEC` draws of each stream
    (slots [`VEC`·l, `VEC`·(l + 1))) as one vector of `VEC`·itemsize bytes
    when all lie in the window and the first one's byte offset in a row
    (from a 16-byte aligned row) is a multiple of the vector's, else one by
    one: {(lane, stream): "vector" | "scalar" | "none"}."""
    vec = VEC * itemsize
    out = {}
    for lane in range(32):
        q0 = VEC * lane
        for s in (0, 1):
            lo, hi = tile.lo[s], tile.hi[s]
            if q0 >= lo and q0 + VEC <= hi and (tile.d[s] + q0 - start) * itemsize % vec == 0:
                out[lane, s] = "vector"
            elif max(lo, q0) < min(hi, q0 + VEC):
                out[lane, s] = "scalar"
            else:
                out[lane, s] = "none"
    return out


def _check(out: torch.Tensor, keys: torch.Tensor, size: int, start: int) -> None:
    if out.dtype not in _TYPES:
        raise TypeError(f"threefry_normal writes float32 or bfloat16, got {out.dtype}")
    if out.dim() != 2 or (out.shape[1] > 1 and out.stride(1) != 1):
        raise ValueError(f"threefry_normal writes rows (rows, w) with a unit inner stride, "
                         f"got shape {tuple(out.shape)} strides {out.stride()}")
    if keys.dim() != 2 or keys.shape != (out.shape[0], 2):
        raise ValueError(f"threefry_normal takes one (2,) key a row: keys "
                         f"{tuple(keys.shape)} for {out.shape[0]} rows")
    if not 0 <= start <= start + out.shape[1] <= size:
        raise ValueError(f"window [{start}, {start + out.shape[1]}) outside a "
                         f"{size}-draw leaf")


def threefry_normal_plain(out: torch.Tensor, keys: torch.Tensor, size: int, start: int = 0,
                          scale: float = 1.0, partitionable: Optional[bool] = None,
                          block: int = prng.M32) -> torch.Tensor:
    """The eager draw of `core.prng` on ``out``'s device, piece by piece
    (`prng.normal_chunks`' pieces), each ``(z * scale).to(out.dtype)``
    written into its row: the kernel's function."""
    _check(out, keys, size, start)
    stop = start + out.shape[1]
    dev = out.device
    part = prng._part(partitionable)
    chunk = prng.NORMAL_CHUNK.get(dev.type, prng.NORMAL_CHUNK["cuda"])
    for row, key in zip(out, keys):
        for first, bits in prng._bits32_chunks(key, size, dev, part, chunk, start, stop, block):
            a, b = max(first, start), min(first + bits.numel(), stop)
            if a < b:
                z = prng._normal_from_bits(bits[a - first:b - first])
                row[a - start:b - start] = (z * scale).to(out.dtype)
    return out


def _kernel(out: torch.Tensor, keys: torch.Tensor, size: int, start: int, scale: float,
            partitionable: bool, block: int) -> torch.Tensor:
    global launches
    stop = start + out.shape[1]
    ranges = plan(size, start, stop, partitionable, block)
    if len(ranges) > MAX_RANGES:
        raise ValueError(f"threefry_normal: {len(ranges)} ranges of counter pairs, the "
                         f"kernel takes at most {MAX_RANGES}")
    if not ranges or out.shape[0] == 0:
        return out
    k0 = k1 = 0
    if not partitionable and size >= block:
        # past a block the host splits each row's key (jax's blocks)
        table = block_keys(keys.cpu(), size, partitionable, block).contiguous()
    elif keys.device.type == "cpu" and out.shape[0] == 1:
        # one key held on the host: its words go with the launch, no copy
        k0, k1 = (int(v) & prng.M32 for v in keys[0].tolist())
        table = None
    else:
        table = keys if keys.stride(1) == 1 else keys.contiguous()
    if table is not None:
        table = table.to(device=out.device, dtype=torch.int64)
    nkeys = table.shape[1] if table is not None and table.dim() == 3 else 1
    flat = [v for r in ranges for v in (r.key, r.off, r.n, r.h, r.first, r.count)]
    fn = _build.bind("threefry_normal", "threefry_normal", _ARGS)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = fn(out.data_ptr(), _TYPES[out.dtype], None if table is None else table.data_ptr(),
             0 if table is None else table.stride(0), k0, k1, out.shape[0], nkeys,
             (ctypes.c_longlong * len(flat))(*flat), len(ranges), start, stop, out.stride(0),
             int(partitionable), scale, stream)
    if err != 0:
        raise RuntimeError(f"threefry_normal kernel launch failed: CUDA error {err}")
    launches += 1
    return out


def threefry_normal(out: torch.Tensor, keys: torch.Tensor, size: int, start: int = 0,
                    scale: float = 1.0, partitionable: Optional[bool] = None,
                    block: int = prng.M32) -> torch.Tensor:
    """Fill ``out`` (rows, w) with the draws [start, start + w) of
    ``normal(keys[r], (size,))`` times ``scale`` (a float32 value), rounded
    to ``out``'s type (float32 or bfloat16), for each row r of the (rows, 2)
    ``keys``; returns ``out``.  One kernel launch on a CUDA ``out``; a CPU
    ``out`` takes `threefry_normal_plain`.  ``block`` is jax's block of
    counters (2³² − 1), a parameter only for the tests."""
    _check(out, keys, size, start)
    if out.device.type == "cpu":
        return threefry_normal_plain(out, keys, size, start, scale, partitionable, block)
    if out.device.type != "cuda":
        raise ValueError(f"threefry_normal runs on cuda or cpu, got {out.device}")
    return _kernel(out, keys, size, start, float(scale), prng._part(partitionable), block)


# ==========================================================================
# The bits path
# ==========================================================================
#: counters: the iota pairs (p, h + p), the pairs (0, base + i), (0, data[i])
IOTA, INDEX, DATA = 0, 1, 2
#: where a pair's two words land: word 0 at slot p and word 1 at h + p
#: (below ``width``); their xor at slot i; slots 2i and 2i + 1; one 64-bit
#: draw (high word first) at slot i
HALVES, XOR, PAIR, WIDE = 0, 1, 2, 3
#: what a slot holds: the word, a float32 / float64 uniform, ``u < p``
WORD, F32, F64, BOOL = 0, 1, 2, 3
#: most dims of ``p`` (after merging) the kernel reads through strides
MAX_P_DIMS = 4
_VALUE_DTYPES = {WORD: torch.int64, F32: torch.float32, F64: torch.float64, BOOL: torch.bool}
_BITS_ARGS = (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
              ctypes.c_uint, ctypes.c_uint, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
              ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
              ctypes.c_int, ctypes.c_double, ctypes.c_void_p, ctypes.c_int,
              ctypes.POINTER(ctypes.c_longlong), ctypes.POINTER(ctypes.c_longlong),
              ctypes.c_void_p)


@dataclasses.dataclass(frozen=True)
class BitsPlan:
    """One hash of `pairs` counter pairs a key.  ``ctr``: `IOTA` pairs
    (i, h + i), the last one's second counter 0 when ``odd``; `INDEX`
    pairs (0, base + i); `DATA` pairs (0, data[i]).  ``form`` places the
    words in a row of ``width`` slots; ``value`` says what a slot holds."""
    ctr: int
    pairs: int
    form: int
    width: int
    value: int = WORD
    h: int = 0
    odd: bool = False
    base: int = 0

    @property
    def dtype(self) -> torch.dtype:
        return _VALUE_DTYPES[self.value]


def bits_plan(kind: str, size: int, partitionable: bool, base: int = 0) -> BitsPlan:
    """The plan of one `prng` hash, as ``prng._hash`` lays its counters out:

    * ``"split"``: ``size`` keys, (…, size, 2) words;
    * ``"bits32"`` / ``"f32"`` / ``"bool32"``: ``size`` 32-bit draws as
      words, float32 uniforms or ``u < p`` (original layout: jax's iota of
      ``size`` words, halves of h = ⌈size/2⌉ pairs; partitionable: the xor
      of (0, i)'s words);
    * ``"bits64"``: ``size`` 64-bit draws, (…, 2, size): the high words,
      then the low ones; ``"f64"`` / ``"bool64"``: float64 uniforms or
      ``u < p`` from them (original: the iota of 2·size words, pair p's
      words the draw's high and low; partitionable: (0, i)'s);
    * ``"fold"``: fold_in of ``size`` data values read on the device,
      (…, size, 2); ``"fold1"``: of the one value ``base``."""
    size = int(size)
    if kind == "split":
        if partitionable:
            return BitsPlan(INDEX, size, PAIR, 2 * size)
        return BitsPlan(IOTA, size, HALVES, 2 * size, h=size)
    if kind in ("bits32", "f32", "bool32"):
        value = {"bits32": WORD, "f32": F32, "bool32": BOOL}[kind]
        if partitionable:
            return BitsPlan(INDEX, size, XOR, size, value)
        h = (size + 1) // 2
        return BitsPlan(IOTA, h, HALVES, size, value, h=h, odd=size % 2 == 1)
    if kind == "bits64":
        return BitsPlan(INDEX if partitionable else IOTA, size, HALVES, 2 * size, h=size)
    if kind in ("f64", "bool64"):
        value = F64 if kind == "f64" else BOOL
        return BitsPlan(INDEX if partitionable else IOTA, size, WIDE, size, value, h=size)
    if kind == "fold":
        return BitsPlan(DATA, size, PAIR, 2 * size)
    if kind == "fold1":
        return BitsPlan(INDEX, 1, PAIR, 2, base=int(base))
    raise ValueError(f"bits_plan: unknown kind {kind!r}")


def counters(bp: BitsPlan, i: int, data=None) -> tuple:
    """Pair i's counters (x0, x1) under ``bp``."""
    if bp.ctr == IOTA:
        return i, 0 if (bp.odd and i == bp.pairs - 1) else bp.h + i
    if bp.ctr == INDEX:
        return 0, (bp.base + i) & prng.M32
    return 0, int(data[i]) & prng.M32


def slots(bp: BitsPlan, i: int) -> list:
    """Where pair i's words land: (slot, word), ``word`` 0 or 1 (the pair's
    first or second word), ``"xor"`` or ``"wide"`` (both, one 64-bit draw)."""
    if bp.form == HALVES:
        return [(i, 0)] + ([(bp.h + i, 1)] if bp.h + i < bp.width else [])
    if bp.form == XOR:
        return [(i, "xor")]
    if bp.form == PAIR:
        return [(2 * i, 0), (2 * i + 1, 1)]
    return [(i, "wide")]


def _check_bits(out: torch.Tensor, keys: torch.Tensor, bp: BitsPlan, data, p) -> int:
    """The rows (keys) of a bits call, after checking its arguments."""
    if out.dtype != bp.dtype:
        raise TypeError(f"threefry_bits writes {bp.dtype} for this plan, got {out.dtype}")
    if keys.shape[-1:] != (2,) or keys.dtype != torch.int64:
        raise ValueError(f"threefry_bits takes int64 keys (..., 2), got {tuple(keys.shape)} "
                         f"{keys.dtype}")
    rows = math.prod(keys.shape[:-1])
    if not out.is_contiguous() or out.numel() != rows * bp.width:
        raise ValueError(f"threefry_bits writes a contiguous (rows, {bp.width}) for {rows} "
                         f"keys, got shape {tuple(out.shape)}")
    if bp.ctr == DATA and (data is None or data.shape != (bp.pairs,)):
        raise ValueError(f"threefry_bits folds in {bp.pairs} data values, got "
                         f"{None if data is None else tuple(data.shape)}")
    if bp.ctr == DATA and rows != 1:
        raise ValueError("threefry_bits folds data into one key")
    if bp.value == BOOL:
        if p is None:
            raise ValueError("threefry_bits draws bernoulli with a p")
        want = torch.float32 if bp.form != WIDE else torch.float64
        if isinstance(p, torch.Tensor):
            if p.dtype != want:
                raise TypeError(f"threefry_bits compares {want} uniforms with a p of that "
                                f"type, got {p.dtype}")
            try:
                p.expand(out.shape)
            except RuntimeError:
                raise ValueError(f"threefry_bits: p of shape {tuple(p.shape)} does not "
                                 f"broadcast to the draw's shape {tuple(out.shape)}") from None
        elif want != torch.float64:
            raise TypeError("threefry_bits compares float32 uniforms with a float32 tensor p")
    return rows


def threefry_bits_plain(out: torch.Tensor, keys: torch.Tensor, bp: BitsPlan,
                        data: Optional[torch.Tensor] = None,
                        p: Union[float, torch.Tensor, None] = None, lo: float = 0.0,
                        hi: float = 1.0) -> torch.Tensor:
    """The eager hash of `core.prng` (`prng._threefry` on int64 tensors) on
    ``out``'s device, the words placed as ``bp`` says: the kernel's
    function."""
    rows = _check_bits(out, keys, bp, data, p)
    dev = out.device
    k = keys.reshape(rows, 2).to(dev)
    i = torch.arange(bp.pairs, dtype=torch.int64, device=dev)
    if bp.ctr == IOTA:
        x0, x1 = i, bp.h + i
        if bp.odd:
            x1[-1] = 0
    elif bp.ctr == INDEX:
        x0, x1 = torch.zeros_like(i), (bp.base + i) & prng.M32
    else:
        x0, x1 = torch.zeros_like(i), data.to(device=dev, dtype=torch.int64) & prng.M32
    y0, y1 = prng._threefry(k[:, 0, None], k[:, 1, None], x0, x1)
    flat = out.view(rows, bp.width)
    if bp.form == PAIR:
        flat.copy_(torch.stack([y0, y1], dim=-1).reshape(rows, bp.width))
        return out
    if bp.form == WIDE:
        mant = (y0 << 20) | (y1 >> 12)
        vals = (mant | 0x3FF0000000000000).view(torch.float64) - 1.0
    else:
        words = y0 ^ y1 if bp.form == XOR else torch.cat([y0, y1], dim=-1)[:, :bp.width]
        if bp.value == WORD:
            flat.copy_(words)
            return out
        vals = prng._scale_f32(prng._unit_floats(words), float(lo), float(hi))
    if bp.value == BOOL:
        vals = vals.reshape(out.shape) < (p.to(dev) if isinstance(p, torch.Tensor) else p)
    out.copy_(vals.reshape(out.shape))
    return out


def _p_layout(p: torch.Tensor, shape) -> tuple:
    """``p`` broadcast to ``shape`` as (tensor, sizes, strides) over the
    output's row-major flat index, unit dims dropped and neighbours merged
    (a zero stride is a broadcast axis); at most `MAX_P_DIMS` dims (a copy
    of the broadcast ``p`` past that)."""
    e = p.expand(shape)
    dims = [(s, st) for s, st in zip(e.shape, e.stride()) if s != 1]
    merged = []
    for s, st in dims:
        if merged and merged[-1][1] == st * s:
            merged[-1] = (merged[-1][0] * s, st)
        else:
            merged.append((s, st))
    if len(merged) > MAX_P_DIMS:
        e = e.contiguous()
        merged = [(e.numel(), 1)]
    return e, [s for s, _ in merged], [st for _, st in merged]


def _bits_kernel(out: torch.Tensor, keys: torch.Tensor, bp: BitsPlan, rows: int, data, p,
                 lo: float, hi: float) -> torch.Tensor:
    global bits_launches
    if rows == 0 or bp.pairs == 0:
        return out
    dev = out.device
    k0 = k1 = 0
    kp, kstride = None, 0
    if keys.dim() == 1 and keys.device.type == "cpu":
        k0, k1 = (int(v) & prng.M32 for v in keys.tolist())
    else:
        kt = keys.reshape(rows, 2).to(dev)
        if kt.stride(1) != 1:
            kt = kt.contiguous()
        kp, kstride = kt, kt.stride(0)
    if data is not None:
        data = data.to(device=dev, dtype=torch.int64).contiguous()
    pkind, pscalar, pt, sizes, strides = 0, 0.0, None, [], []
    if bp.value == BOOL:
        if isinstance(p, torch.Tensor):
            pt, sizes, strides = _p_layout(p.to(dev), out.shape)
            pkind = 1 if p.dtype == torch.float32 else 2
        else:
            pscalar = float(p)
    scaled = bp.value in (F32, BOOL) and bp.form != WIDE and (float(lo), float(hi)) != (0.0, 1.0)
    fn = _build.bind("threefry_normal", "threefry_bits", _BITS_ARGS)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(out.data_ptr(), bp.width, None if kp is None else kp.data_ptr(), kstride, k0, k1,
             rows, bp.pairs, bp.ctr, bp.h, int(bp.odd), bp.base,
             None if data is None else data.data_ptr(), bp.form, bp.width, bp.value,
             int(scaled), float(lo), float(hi), pkind, pscalar,
             None if pt is None else pt.data_ptr(), len(sizes),
             (ctypes.c_longlong * MAX_P_DIMS)(*sizes), (ctypes.c_longlong * MAX_P_DIMS)(*strides),
             stream)
    if err != 0:
        raise RuntimeError(f"threefry_bits kernel launch failed: CUDA error {err}")
    bits_launches += 1
    return out


def threefry_bits(out: torch.Tensor, keys: torch.Tensor, bp: BitsPlan,
                  data: Optional[torch.Tensor] = None,
                  p: Union[float, torch.Tensor, None] = None, lo: float = 0.0,
                  hi: float = 1.0) -> torch.Tensor:
    """Hash ``bp``'s counter pairs under every key of ``keys`` (…, 2) — one
    (2,) key held on the CPU goes to the kernel as two scalar words, a
    batch is read on ``out``'s device — and write each row's ``bp.width``
    slots into ``out`` (contiguous, ``bp.dtype``, rows × width elements);
    ``data`` the `DATA` counters, ``p`` the bernoulli threshold (a float,
    compared in float64, or a tensor of the uniform's type broadcast to
    ``out``'s shape), [lo, hi) a float32 uniform's range.  Returns ``out``.
    One kernel launch on a CUDA ``out``; a CPU ``out`` takes
    `threefry_bits_plain`."""
    rows = _check_bits(out, keys, bp, data, p)
    if out.device.type == "cpu":
        return threefry_bits_plain(out, keys, bp, data, p, lo, hi)
    if out.device.type != "cuda":
        raise ValueError(f"threefry_bits runs on cuda or cpu, got {out.device}")
    return _bits_kernel(out, keys, bp, rows, data, p, lo, hi)
