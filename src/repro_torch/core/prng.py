"""Counter-based random numbers — port of the `jax.random` functions the
JAX package calls, on jax's default generator, threefry2x32.

Keys are ``(..., 2)`` int64 tensors holding uint32 words; a key with
leading dimensions is a batch of keys, and every draw from it gains those
dimensions in front of its own shape (the port's form of ``jax.vmap`` over
keys).  Words and counts are held as uint32 values in int64 (a tensor
hash runs in int32, whose adds wrap as uint32 adds do), so no value ever
needs an unsigned type: a 64-bit draw is the pair of its (high, low)
words.

The bits are jax's, for both settings of ``jax_threefry_partitionable``:

  * ``False`` (the default here, and the setting every committed artifact
    was written under): a split or a draw hashes one iota of counters
    whose first half and second half form the pairs, and the output words
    are the first halves' hashes followed by the second halves';
  * ``True`` (jax 0.9.0's own default): pair i is (0, i) (the 64-bit iota
    of the output shape), a split key is the pair's two hashes and a
    32-bit draw their xor.

The setting is an argument of every function (``partitionable=``), or, for
calls that leave it as None, the innermost `threefry_partitionable`
context — never a process-wide flag a caller could leave set.

``jax_enable_x64`` is on in the JAX package, so the port follows its
conventions: a Python-float ``p`` draws float64 uniforms from 64-bit bits,
and `randint` defaults to int64.  `normal` draws float32 as XLA's CPU code
computes ``jax.random.normal``, its inverse error function included
(`xla_math`), and `normal_chunks` draws a leaf of any size in pieces.

Where the draws run: on ``device`` (default: the key's device).  On a CUDA
device every hash is one launch of kernel 7 (`kernels.threefry_normal`):
`normal` through its normal path (the hash, the transform and the store in
one launch), `split`, `fold_in`, `random_bits`, `uniform` and `bernoulli`
(``u < p`` fused) through its bits path, and through those `randint`,
`permutation` and `choice` one launch a `random_bits` (their sorts and
modular arithmetic stay tensor ops); the same bits, and never the eager
hash.  Elsewhere the draws run eagerly (`_threefry` on int64 tensors, the
kernels' plain version).  A single key held on the CPU hashes small counts
(at most `HOST_PAIRS` pairs) for a CPU result in Python integers, on the
host, and passes its words to a device draw as scalars, so per-round key
arithmetic costs no device launch and no copy; every draw over a client or
entry axis runs on the device it is asked for.
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional, Sequence, Union

import torch

from . import xla_math

M32 = 0xFFFFFFFF
#: key-schedule parity constant of Threefry (Salmon et al., 2011)
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
#: pairs hashed in Python integers for a single CPU key and a CPU result
HOST_PAIRS = 16

_PARTITIONABLE = contextvars.ContextVar("threefry_partitionable", default=False)


@contextlib.contextmanager
def threefry_partitionable(flag: bool):
    """Within the block, calls that pass ``partitionable=None`` lay out
    their counters as jax does under ``jax.threefry_partitionable(flag)``."""
    token = _PARTITIONABLE.set(bool(flag))
    try:
        yield
    finally:
        _PARTITIONABLE.reset(token)


def _part(partitionable: Optional[bool]) -> bool:
    return _PARTITIONABLE.get() if partitionable is None else bool(partitionable)


def _s32(v):
    """A uint32 value as int32 (the same 32 bits): a Python int or an
    int64 tensor."""
    if isinstance(v, torch.Tensor):
        return v.to(torch.int32)
    v &= M32
    return v - (1 << 32) if v >> 31 else v


def _threefry(k0, k1, x0, x1):
    """Threefry-2x32, 20 rounds, on Python ints or int64 tensors holding
    uint32 values (broadcasting); returns the two output words in the
    inputs' form.  Python ints are masked to 32 bits after every add; a
    tensor hash runs in int32 instead, whose adds wrap modulo 2³² as
    uint32 adds do (a right shift is masked to a logical one): several
    times faster than masked int64 arithmetic, and the same bits."""
    words = (k0, k1, x0, x1)
    tensor = any(isinstance(v, torch.Tensor) for v in words)
    if tensor:
        k0, k1, x0, x1 = (_s32(v) for v in words)

    def wrap(v):
        if not tensor:
            return v & M32
        return v if isinstance(v, torch.Tensor) else _s32(v)

    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0, x1 = wrap(x0 + ks[0]), wrap(x1 + ks[1])
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = wrap(x0 + x1)
            x1 = wrap((x1 << r) | ((x1 >> (32 - r)) & ((1 << r) - 1))) ^ x0
        x0 = wrap(x0 + ks[(i + 1) % 3])
        x1 = wrap(x1 + ks[(i + 2) % 3] + (i + 1))
    if tensor:
        return tuple(v.to(torch.int64) & M32 for v in (x0, x1))
    return x0, x1


Counts = Union[int, range, Sequence[int]]


def _as_list(c: Counts, n: int) -> list:
    return [c] * n if isinstance(c, int) else list(c)


def _as_tensor(c: Counts, device):
    if isinstance(c, int):
        return c
    if isinstance(c, range):
        return torch.arange(c.start, c.stop, dtype=torch.int64, device=device)
    return torch.tensor(list(c), dtype=torch.int64, device=device)


def _out_device(key: torch.Tensor, device) -> torch.device:
    return key.device if device is None else torch.device(device)


def _hash(key: torch.Tensor, x0: Counts, x1: Counts, n: int, device=None,
          zero_last: bool = False):
    """Hash the n counter pairs (x0[i], x1[i]) under every key of ``key``
    (..., 2), with x1's last counter replaced by 0 if ``zero_last``:
    ``(y0, y1)``, each (..., n) int64 on ``device``."""
    dev = _out_device(key, device)
    if key.dim() == 1 and key.device.type == "cpu":
        k0, k1 = key.tolist()
        if dev.type == "cpu" and n <= HOST_PAIRS:
            c1 = _as_list(x1, n)
            if zero_last:
                c1[-1] = 0
            ys = [_threefry(k0, k1, a, b) for a, b in zip(_as_list(x0, n), c1)]
            return (torch.tensor([y[0] for y in ys], dtype=torch.int64),
                    torch.tensor([y[1] for y in ys], dtype=torch.int64))
    else:
        key = key.to(dev)
        k0, k1 = key[..., 0, None], key[..., 1, None]
    c1 = _as_tensor(x1, dev)
    if zero_last:
        c1[-1] = 0
    y0, y1 = _threefry(k0, k1, _as_tensor(x0, dev), c1)
    shape = tuple(key.shape[:-1]) + (n,)
    return y0.expand(shape), y1.expand(shape)


def _iota_words(key: torch.Tensor, n_words: int, device=None) -> torch.Tensor:
    """jax's ``threefry_2x32(key, iota(n_words))``: the counters' halves
    form the pairs (an odd count pads the second half with a 0), the output
    is the first words, then the second, trimmed to ``n_words``."""
    h = (n_words + 1) // 2
    y0, y1 = _hash(key, range(0, h), range(h, 2 * h), h, device, zero_last=n_words % 2 == 1)
    return torch.cat([y0, y1], dim=-1)[..., :n_words]


def _numel(shape: Sequence[int]) -> int:
    return math.prod(int(s) for s in shape)


def _tn():
    """`kernels.threefry_normal` (imported at first use: it imports this
    module)."""
    from ..kernels import threefry_normal

    return threefry_normal


def _on_card(key: torch.Tensor, device) -> Optional[torch.device]:
    """The hash's output device when it is a CUDA device (kernel 7), else
    None (the eager route)."""
    dev = _out_device(key, device)
    return dev if dev.type == "cuda" else None


def _card_hash(key: torch.Tensor, dev: torch.device, kind: str, size: int, partitionable,
               shape: Sequence[int], **kw) -> torch.Tensor:
    """One launch of kernel 7's bits path on ``dev``: ``bits_plan(kind,
    size)`` under every key of ``key`` into a new (…, *shape) tensor."""
    tn = _tn()
    bp = tn.bits_plan(kind, size, _part(partitionable), kw.pop("base", 0))
    out = torch.empty(tuple(key.shape[:-1]) + tuple(shape), dtype=bp.dtype, device=dev)
    return tn.threefry_bits(out, key, bp, **kw)


# ==========================================================================
# Keys
# ==========================================================================
def PRNGKey(seed: int, *, device=None) -> torch.Tensor:
    """The key of an integer seed: its 64 bits as (high, low) words."""
    s = int(seed) & ((1 << 64) - 1)
    return torch.tensor([s >> 32, s & M32], dtype=torch.int64,
                        device="cpu" if device is None else device)


def split(key: torch.Tensor, num: int = 2, *, device=None,
          partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.split``: (..., 2) → (..., num, 2)."""
    num = int(num)
    dev = _on_card(key, device)
    if dev is not None:
        return _card_hash(key, dev, "split", num, partitionable, (num, 2))
    if _part(partitionable):
        y0, y1 = _hash(key, 0, range(num), num, device)
        return torch.stack([y0, y1], dim=-1)
    w = _iota_words(key, 2 * num, device)
    return w.reshape(tuple(w.shape[:-1]) + (num, 2))


def fold_in(key: torch.Tensor, data, *, device=None) -> torch.Tensor:
    """``jax.random.fold_in``: hash the pair (0, data) for a uint32
    ``data`` — the same in both settings.  ``data`` may also be a 1-D
    integer tensor of c values in [0, 2**32) (not checked: that would cost
    a device sync), folded into one key in one hash on the data's device
    (or ``device``): the (c, 2) keys of ``jax.vmap(lambda i: fold_in(key,
    i))(data)``."""
    if isinstance(data, torch.Tensor) and data.dim() == 1:
        if key.dim() != 1:
            raise ValueError(f"fold_in folds a vector into one (2,) key, got {tuple(key.shape)}")
        x1 = data.to(device=data.device if device is None else device, dtype=torch.int64)
        dev = _on_card(key, x1.device)
        if dev is not None:
            return _card_hash(key, dev, "fold", x1.numel(), None, (x1.numel(), 2), data=x1)
        k0, k1 = key.tolist()
        y0, y1 = _threefry(k0, k1, torch.zeros_like(x1), x1)
        return torch.stack([y0, y1], dim=-1)
    if not 0 <= int(data) <= M32:
        raise ValueError(f"fold_in takes data in [0, 2**32), got {data}")
    dev = _on_card(key, device)
    if dev is not None:
        return _card_hash(key, dev, "fold1", 1, None, (2,), base=int(data))
    y0, y1 = _hash(key, [0], [int(data)], 1, device)
    return torch.cat([y0, y1], dim=-1)


def random_bits(key: torch.Tensor, bit_width: int, shape: Sequence[int] = (), *,
                device=None, partitionable: Optional[bool] = None):
    """``jax.random.bits`` of width 32 (an int64 tensor of uint32 values)
    or 64 (a ``(high, low)`` pair of them), shaped (..., *shape)."""
    shape = tuple(int(s) for s in shape)
    size = _numel(shape)
    if size >= M32:
        raise ValueError(f"random_bits draws fewer than 2**32 - 1 words, got {size}")
    batch = tuple(key.shape[:-1])
    dev = _on_card(key, device) if bit_width in (32, 64) else None
    if dev is not None and bit_width == 32:
        return _card_hash(key, dev, "bits32", size, partitionable, shape)
    if dev is not None:
        w = _card_hash(key, dev, "bits64", size, partitionable, (2, size))
        return w[..., 0, :].reshape(batch + shape), w[..., 1, :].reshape(batch + shape)
    if bit_width == 32:
        if _part(partitionable):
            y0, y1 = _hash(key, 0, range(size), size, device)
            bits = y0 ^ y1
        else:
            bits = _iota_words(key, size, device)
        return bits.reshape(batch + shape)
    if bit_width == 64:
        if _part(partitionable):
            hi, lo = _hash(key, 0, range(size), size, device)
        else:
            w = _iota_words(key, 2 * size, device)
            hi, lo = w[..., :size], w[..., size:]
        return hi.reshape(batch + shape), lo.reshape(batch + shape)
    raise ValueError(f"random_bits supports widths 32 and 64, got {bit_width}")


# ==========================================================================
# Distributions
# ==========================================================================
_FLOAT_ONE = {torch.float32: 0x3F800000, torch.float64: 0x3FF0000000000000}


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """float32 in [0, 1) from 32-bit words: the top 23 bits as the mantissa
    of a number in [1, 2), minus 1."""
    return ((bits >> 9) | _FLOAT_ONE[torch.float32]).to(torch.int32).view(torch.float32) - 1.0


def _scale_f32(f: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """``max(lo, f·(hi − lo) + lo)`` in float32, the multiply–add one fused
    step as XLA's CPU code computes it; [0, 1) maps to itself."""
    if (minval, maxval) == (0.0, 1.0):
        return f
    lo = torch.tensor(minval, dtype=torch.float32, device=f.device)
    hi = torch.tensor(maxval, dtype=torch.float32, device=f.device)
    return torch.maximum(lo, xla_math.fma(f, hi - lo, lo))


def uniform(key: torch.Tensor, shape: Sequence[int] = (), dtype=torch.float64,
            minval: float = 0.0, maxval: float = 1.0, *, device=None,
            partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.uniform``: the mantissa from the top bits of a draw of
    the type's width, with the exponent of 1.0, minus 1 — a number in [0,
    1) — then ``max(minval, floats·(maxval − minval) + minval)`` in the
    type.  float32 draws take any range (the multiply–add rounded once, as
    XLA's CPU code fuses it); float64 draws only [0, 1), the one range the
    JAX package draws them on."""
    minval, maxval = float(minval), float(maxval)
    shape = tuple(int(s) for s in shape)
    dev = _on_card(key, device)
    if dev is not None and dtype == torch.float32:
        return _card_hash(key, dev, "f32", _numel(shape), partitionable, shape,
                          lo=minval, hi=maxval)
    if dtype == torch.float32:
        bits = random_bits(key, 32, shape, device=device, partitionable=partitionable)
        return _scale_f32(_unit_floats(bits), minval, maxval)
    if dtype != torch.float64:
        raise ValueError(f"uniform draws float32 or float64, got {dtype}")
    if (minval, maxval) != (0.0, 1.0):
        raise ValueError(f"float64 uniforms are drawn on [0, 1) only, got [{minval}, {maxval})")
    if dev is not None:
        return _card_hash(key, dev, "f64", _numel(shape), partitionable, shape)
    hi, lo = random_bits(key, 64, shape, device=device, partitionable=partitionable)
    mant = (hi << 20) | (lo >> 12)                  # the draw's top 52 bits
    return (mant | _FLOAT_ONE[dtype]).view(torch.float64) - 1.0


#: `normal`'s uniform range: (nextafter(−1, 0), 1) in float32
_NORMAL_LO = -0.9999999403953552
_SQRT2_F32 = 1.4142135381698608
#: draws `normal_chunks` makes at once, by device type: a CPU chunk's
#: temporaries stay near the caches, the card's amortise its launches
NORMAL_CHUNK = {"cpu": 1 << 17, "cuda": 1 << 24}


def _normal_from_bits(bits: torch.Tensor) -> torch.Tensor:
    u = _scale_f32(_unit_floats(bits), _NORMAL_LO, 1.0)
    return xla_math.erf_inv(u) * _SQRT2_F32


def _bits32_chunks(key: torch.Tensor, size: int, device, partitionable, chunk: int,
                   start: int = 0, stop: Optional[int] = None, block: int = M32):
    """The 32-bit words of ``random_bits(key, 32, (size,))`` for one key, in
    pieces of at most ``chunk`` words: ``(first flat index, words)``, only
    the pieces that hold a word of [start, stop).  Under the original
    layout the pair (i, h + i) hashes to words i and h + i (h = ⌈size/2⌉),
    so a range of pairs gives two ranges of words.  From ``block`` =
    2³² − 1 words on (uint32's largest count), the original layout draws as
    jax does: ``split(key, nblocks + 1)``, each of the first nblocks keys
    hashing a whole block of counters, the last key the remainder
    (``_threefry_random_bits_original``); ``block`` is a parameter only so
    that the tests can hold the split to jax's primitives at a small size."""
    stop = size if stop is None else min(int(stop), size)

    def wanted(a, b):
        return a < stop and b > start

    if _part(partitionable):
        if size >= M32:
            raise ValueError(f"normal draws fewer than 2**32 - 1 values under "
                             f"jax_threefry_partitionable=True, got {size}")
        for a in range(0, size, chunk):
            b = min(size, a + chunk)
            if wanted(a, b):
                y0, y1 = _hash(key, 0, range(a, b), b - a, device)
                yield a, y0 ^ y1
        return
    nblocks, rem = divmod(size, block)
    if nblocks:
        keys = split(key, nblocks + 1, partitionable=False)
        pieces = [(keys[i], i * block, block) for i in range(nblocks)]
        pieces.append((keys[nblocks], nblocks * block, rem))
    else:
        pieces = [(key, 0, size)]
    for k, off, n in pieces:
        if not wanted(off, off + n):
            continue
        h = (n + 1) // 2
        step = max(1, chunk // 2)
        for a in range(0, h, step):
            b = min(h, a + step)
            hi_stop = min(n, h + b)
            if not (wanted(off + a, off + b) or wanted(off + h + a, off + hi_stop)):
                continue
            y0, y1 = _hash(k, range(a, b), range(h + a, h + b), b - a, device,
                           zero_last=b == h and n % 2 == 1)
            yield off + a, y0
            yield off + h + a, y1[: hi_stop - (h + a)]


def normal_chunks(key: torch.Tensor, shape: Sequence[int] = (), *, device=None,
                  partitionable: Optional[bool] = None, chunk: Optional[int] = None,
                  start: int = 0, stop: Optional[int] = None):
    """`normal`'s draws for one (2,) key, flattened, in pieces of at most
    ``chunk`` (default `NORMAL_CHUNK` of the device): ``(first flat index,
    float32 draws)`` — a leaf of any size without a whole-leaf temporary,
    2³² − 1 draws and more included (llama4-maverick's expert leaves, in
    blocks as jax draws them; see `_bits32_chunks`).
    ``start``/``stop`` draw only the pieces that hold a flat index in
    [start, stop) (a window of a large leaf, to hold against another
    device's draw)."""
    if key.dim() != 1:
        raise ValueError(f"normal_chunks draws for one (2,) key, got {tuple(key.shape)}")
    size = _numel(shape)
    dev = _out_device(key, device)
    chunk = NORMAL_CHUNK.get(dev.type, NORMAL_CHUNK["cuda"]) if chunk is None else int(chunk)
    if dev.type == "cuda":
        # kernel 7, one launch a piece: pieces of `chunk` consecutive draws
        threefry_normal = _tn().threefry_normal
        stop = size if stop is None else min(int(stop), size)
        for a in range(0, size, chunk):
            b = min(size, a + chunk)
            if a < stop and b > start:
                out = torch.empty((1, b - a), dtype=torch.float32, device=dev)
                yield a, threefry_normal(out, key[None], size, a,
                                         partitionable=_part(partitionable))[0]
        return
    for first, bits in _bits32_chunks(key, size, dev, partitionable, chunk, start, stop):
        yield first, _normal_from_bits(bits)


def normal(key: torch.Tensor, shape: Sequence[int] = (), dtype=torch.float32, *,
           device=None, partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.normal`` in float32, bit for bit with jax on the CPU:
    u = ``uniform(key, shape, float32, nextafter(−1, 0), 1)`` and
    √2·erf_inv(u), with XLA's own erf_inv and log1p (`xla_math`).  On a
    CUDA device one launch of kernel 7 draws it all, for one key or a batch;
    elsewhere a single key draws in `normal_chunks`, a batch at once."""
    if dtype != torch.float32:
        raise ValueError(f"normal draws float32 (the JAX package's only type), got {dtype}")
    shape = tuple(int(s) for s in shape)
    dev = _out_device(key, device)
    if dev.type == "cuda":
        keys = key.reshape(-1, 2)
        out = torch.empty((keys.shape[0], _numel(shape)), dtype=torch.float32, device=dev)
        _tn().threefry_normal(out, keys, out.shape[1], partitionable=_part(partitionable))
        return out.reshape(tuple(key.shape[:-1]) + shape)
    if key.dim() > 1:
        bits = random_bits(key, 32, shape, device=device, partitionable=partitionable)
        return _normal_from_bits(bits)
    out = torch.empty(_numel(shape), dtype=torch.float32, device=_out_device(key, device))
    for start, z in normal_chunks(key, shape, device=device, partitionable=partitionable):
        out[start:start + z.numel()] = z
    return out.reshape(shape)


def bernoulli(key: torch.Tensor, p: Union[float, torch.Tensor] = 0.5,
              shape: Optional[Sequence[int]] = None, *, device=None,
              partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.bernoulli``: ``uniform < p`` in p's type — float64 for
    a Python float (x64), a tensor's own dtype otherwise.  ``shape``
    defaults to p's shape after the key's batch dimensions.  On a CUDA
    device the comparison runs in the hash's launch, ``p`` broadcast to the
    draw's (…, *shape)."""
    batch = tuple(key.shape[:-1])
    if isinstance(p, torch.Tensor):
        dtype = p.dtype
        if shape is None:
            shape = tuple(p.shape[len(batch):])
        if device is None:
            device = p.device
    else:
        dtype = torch.float64
        shape = () if shape is None else shape
    shape = tuple(int(s) for s in shape)
    dev = _on_card(key, device)
    if dev is not None:
        if dtype not in (torch.float32, torch.float64):
            raise ValueError(f"bernoulli draws float32 or float64 uniforms, got {dtype}")
        kind = "bool32" if dtype == torch.float32 else "bool64"
        return _card_hash(key, dev, kind, _numel(shape), partitionable, shape, p=p)
    u = uniform(key, shape, dtype, device=device, partitionable=partitionable)
    return u < p


def _mod_span(hi: torch.Tensor, lo: torch.Tensor, span: int) -> torch.Tensor:
    """(hi·2³² + lo) mod span, for span < 2³¹."""
    return ((hi % span) * ((1 << 32) % span) + lo % span) % span


def randint(key: torch.Tensor, shape: Sequence[int], minval: int, maxval: int,
            dtype=torch.int64, *, device=None,
            partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.randint``: two draws of the type's width, reduced by
    the multiplier-remainder identity of jax (``(a·b) mod N`` from ``a mod
    N`` and ``b mod N``).  Spans up to 2³¹ − 1."""
    nbits = {torch.int32: 32, torch.int64: 64}.get(dtype)
    if nbits is None:
        raise ValueError(f"randint draws int32 or int64, got {dtype}")
    minval, maxval = int(minval), int(maxval)
    span = 1 if maxval <= minval else maxval - minval
    if span >= 1 << 31:
        raise ValueError(f"randint spans below 2**31, got {span}")
    k1, k2 = split(key, 2, partitionable=partitionable).unbind(-2)
    higher = random_bits(k1, nbits, shape, device=device, partitionable=partitionable)
    lower = random_bits(k2, nbits, shape, device=device, partitionable=partitionable)
    mult = pow(2, nbits // 2, span)
    if nbits == 32:
        # uint32 arithmetic, wrapping as jax's does
        mult = ((mult * mult) & M32) % span
        a, b = higher % span, lower % span
        off = (((a * mult) & M32) + b) & M32
    else:
        mult = (mult * mult) % span
        off = _mod_span(*higher, span) * mult + _mod_span(*lower, span)
    return (minval + off % span).to(dtype)


def _shuffle_rounds(n: int) -> int:
    """jax's static round count: ⌈3·ln n / ln(2³² − 1)⌉ stable sorts on
    fresh 32-bit keys."""
    return int(math.ceil(3 * math.log(max(1, n)) / math.log(M32)))


def permutation(key: torch.Tensor, n: int, *, device=None,
                partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: (..., n) int64."""
    n = int(n)
    dev = _out_device(key, device)
    batch = tuple(key.shape[:-1])
    x = torch.arange(n, dtype=torch.int64, device=dev).expand(batch + (n,))
    for _ in range(_shuffle_rounds(n)):
        key, sub = split(key, 2, partitionable=partitionable).unbind(-2)
        sort_keys = random_bits(sub, 32, (n,), device=dev, partitionable=partitionable)
        order = torch.sort(sort_keys, dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def choice(key: torch.Tensor, n: int, shape: Sequence[int] = (), replace: bool = True, *,
           device=None, partitionable: Optional[bool] = None) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace)`` (uniform, no ``p``):
    with replacement a `randint`, without it the head of a `permutation`."""
    shape = tuple(int(s) for s in shape)
    draws = _numel(shape)
    if replace:
        return randint(key, shape, 0, n, device=device, partitionable=partitionable)
    if draws > n:
        raise ValueError(f"cannot take {draws} of {n} without replacement")
    perm = permutation(key, n, device=device, partitionable=partitionable)
    return perm[..., :draws].reshape(tuple(key.shape[:-1]) + shape)
