"""The keyed normal draw, fused: the CUDA kernel and its plain version.

Kernel 7 of the port replaces no Pallas kernel.  The reference draws every
LM weight with ``jax.random.normal`` (its `layers._init`), which the port
matches bit for bit (`core.prng.normal`: a threefry-2x32 hash, a uniform in
(−1, 1) and XLA's CPU ``erf_inv``, `core.xla_math`).  Eagerly that is ~600
elementwise launches a chunk of 2²⁴ draws on the card; the kernel
(``csrc/threefry_normal.cu``) does the hash, the transform, the scale and
the rounding to the leaf's type in one pass and writes the leaf in place.

`threefry_normal(out, keys, size, start, scale)` fills ``out`` (rows, w),
float32 or bfloat16, with ``(normal(keys[r], (size,))[start:start + w] *
scale).astype(out.dtype)`` for every row r of the (rows, 2) keys (a
stacked leaf, one key a row).  It launches the kernel on a CUDA ``out`` and
takes the plain version, `threefry_normal_plain` (the eager draw of
`core.prng`, on ``out``'s device), only for an ``out`` on the CPU.

`plan` is the launcher's geometry in Python: the window's draws as ranges of
threefry counter pairs, each inside one of jax's blocks of 2³² − 1 draws,
which the kernel walks; `block_keys` the keys of those blocks.  The tests
walk the same plan in Python and hold the words it picks to jax's.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import torch

from ..core import prng
from . import _build

#: launches of the CUDA kernel since the last reset (the plain version on a
#: CPU tensor does not count)
launches = 0

#: ranges of counter pairs one launch takes (``kMaxRanges`` in the source)
MAX_RANGES = 8
#: output types the kernel writes, by its code
_TYPES = {torch.float32: 0, torch.bfloat16: 1}

_ARGS = (ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
         ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_longlong,
         ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int, ctypes.c_float, ctypes.c_void_p)


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
    table = block_keys(keys.cpu(), size, partitionable, block)
    table = table.to(torch.int32).contiguous().to(out.device)
    flat = [v for r in ranges for v in (r.key, r.off, r.n, r.h, r.first, r.count)]
    fn = _build.bind("threefry_normal", "threefry_normal", _ARGS)
    stream = torch.cuda.current_stream(out.device).cuda_stream
    err = fn(out.data_ptr(), _TYPES[out.dtype], table.data_ptr(), out.shape[0], table.shape[1],
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
