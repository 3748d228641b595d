"""float32 elementary functions as XLA's CPU backend computes them, bit for
bit: ``log``, ``log1p`` and ``erf_inv`` (the three that `jax.random.normal`
and the reference's LM init reach), and the single-rounded fused
multiply-add they are built from.

XLA lowers these ops to its own inlined polynomials (not libm), and LLVM
contracts a multiply whose only use is an add into one FMA when it emits
machine code; the other multiplies and adds round separately.  Which steps
became FMAs was read off XLA's output for ``jax.random.normal(key, (1024,),
float32)`` under jax 0.9.0 on x86-64, dumped with
``XLA_FLAGS=--xla_dump_to=<dir>``: the optimised LLVM IR (``*.ir-with-opt.ll``)
gives the order of operations and the constants, ``objdump -d`` of the
emitted object file which multiply–add pairs are ``vfmadd*ps`` /
``vfnmadd*ps``.  The functions below repeat that sequence; every fused step
is a call to `fma` and is named in a comment.

`fma` rounds once on any device: the float32 product is exact in float64,
and the float64 sum rounded to float32 is the correctly rounded ``a·b + c``
except where the sum fell exactly halfway between two float32s; there its
rounding error (TwoSum) moves it one float64 ulp toward the exact value
(round to odd) before the cast rounds to nearest.  Every other step is
one float32 operation, IEEE-rounded on the CPU and the card alike (the
divide and the square root go through float64, which rounds them correctly
too), so the CPU and the card draw the same bits.
"""
from __future__ import annotations

import torch

_F32, _F64 = torch.float32, torch.float64


def _t(x, like: torch.Tensor) -> torch.Tensor:
    """A Python float (a float32 constant) as a float32 tensor beside ``like``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.tensor(x, dtype=_F32, device=like.device)


def _f64(x):
    return x.to(_F64) if isinstance(x, torch.Tensor) else x


#: the low 29 bits of a float64 that lies halfway between two float32s
_HALF_ULP32, _LOW29 = 1 << 28, (1 << 29) - 1


def fma(a, b, c) -> torch.Tensor:
    """``a·b + c`` rounded once to float32 (float32 tensors or float32
    constants as Python floats; ``a`` or ``b`` a tensor)."""
    p = _f64(a) * _f64(b)                       # exact: 24 + 24 bits < 53
    c64 = _f64(c)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)           # TwoSum: p + c == s + err exactly
    bits = s.view(torch.int64)
    # s → float32 rounds twice only where s fell exactly halfway between
    # two float32s; there s moves one float64 ulp toward p + c (round to
    # odd), so the cast rounds to the exact sum's side
    # (err·s neither overflows nor, at a midpoint, underflows: both are
    # sums of products of float32s)
    half = (bits & _LOW29) == _HALF_ULP32
    step = torch.sign(err * s).to(torch.int64)
    return torch.where(half, bits + step, bits).view(_F64).to(_F32)


def _div(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a.to(_F64) / b.to(_F64)).to(_F32)


def _sqrt(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(a.to(_F64)).to(_F32)


#: Cephes ``logf``'s polynomial, as XLA splits it into three quadratics
_LOG_P = ((0.07037683576345444, -0.11514610052108765, 0.11676998436450958),
          (-0.12420140951871872, 0.14249323308467865, -0.16668057441711426),
          (0.2000071406364441, -0.24999994039535522, 0.3333333134651184))
_LN2_HI, _LN2_LO = 0.693359375, -0.00021219444170128554
_SQRT_HALF = 0.7071067690849304
_FLT_MIN = 1.1754943508222875e-38


def log(y: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log`` (its ``xla.log.f32`` intrinsic): y = 2^e·m with
    m in [√½, √2), log m by Cephes' polynomial in m − 1, plus e·ln 2 in two
    parts; 0 → −inf, +inf → +inf, a negative or NaN input → NaN."""
    yc = torch.maximum(y, _t(_FLT_MIN, y))
    ybits = yc.view(torch.int32)
    e = ((ybits >> 23) - 127).to(_F32) + 1.0
    m = ((ybits & 0x7FFFFF) | 0x3F000000).view(_F32)          # [0.5, 1)
    low = m < _SQRT_HALF
    x = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    e = e - low.to(_F32)
    x2 = x * x
    x3 = x2 * x
    y1, y2, y3 = (fma(fma(x, c0, c1), x, c2) for c0, c1, c2 in _LOG_P)
    r = fma(y1, x3, y2)
    r = fma(r, x3, y3)
    r = fma(r, x3, e * _LN2_LO)                   # the x³ product fused, e·ln2_lo not
    r = fma(x2, -0.5, x) + r                      # vfnmadd: x − x²/2 (exact product)
    r = fma(e, _LN2_HI, r)
    r = torch.where(y == 0, _t(float("-inf"), y), r)
    r = torch.where(y == float("inf"), y, r)
    return torch.where((y < 0) | torch.isnan(y), _t(float("nan"), y), r)


#: the rational approximation XLA uses for |x| < √2 − 1: x − x²/2 + x³·P/Q
_LOG1P_SMALL = 0.4142135679721832
_LOG1P_P = (4.527000055531971e-05, 0.4985410273075104, 6.578732490539551,
            29.91191864013672, 60.949668884277344, 57.11296463012695,
            20.039552688598633)
_LOG1P_Q = (1.0, 15.062909126281738, 83.04756927490234, 221.7624053955078,
            309.0987243652344, 216.42788696289062, 60.11865997314453)


def _log1p_small(x: torch.Tensor) -> torch.Tensor:
    x2 = x * x
    zero = x * 0.0
    p = zero + _LOG1P_P[0]
    q = zero + _LOG1P_Q[0]
    for c in _LOG1P_P[1:]:
        p = fma(p, x, c)
    for c in _LOG1P_Q[1:]:
        q = fma(q, x, c)
    t = (x * x2) * _div(p, q)
    return x + fma(x2, -0.5, t)                   # vfnmadd: t − x²/2 (exact product)


def _where_split(mask: torch.Tensor, x: torch.Tensor, if_true, if_false) -> torch.Tensor:
    """``where(mask, if_true(x), if_false(x))`` for elementwise functions,
    each evaluated only on its own elements."""
    out = torch.empty_like(x)
    out[mask] = if_true(x[mask])
    rest = ~mask
    out[rest] = if_false(x[rest])
    return out


def log1p(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``log1p``: the rational approximation for |x| < √2 − 1,
    `log` of the rounded 1 + x otherwise (XLA evaluates both and selects;
    each element here takes its own branch, the same bits)."""
    return _where_split(x.abs() < _LOG1P_SMALL, x, _log1p_small, lambda v: log(v + 1.0))


#: Giles' single-precision erfinv, w < 5 and w ≥ 5 coefficient sets
_ERFINV = ((2.810226362726098e-08, -0.0002002142573473975),
           (3.432739390518691e-07, 0.0001009505576803349),
           (-3.523387704262859e-06, 0.0013493432197719812),
           (-4.391506536194356e-06, -0.003673428436741233),
           (0.00021858086984138936, 0.005739507731050253),
           (-0.001253725029528141, -0.007622461300343275),
           (-0.004177681636065245, 0.00943887047469616),
           (0.24664072692394257, 1.0016740560531616),
           (1.5014094114303589, 2.832976818084717))


def _erf_inv_poly(t: torch.Tensor, coeffs) -> torch.Tensor:
    p = fma(coeffs[0], t, coeffs[1])
    for c in coeffs[2:]:
        p = fma(t, p, c)
    return p


_ERFINV_NEAR = tuple(a for a, _ in _ERFINV)
_ERFINV_FAR = tuple(b for _, b in _ERFINV)


def erf_inv(u: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` (Giles, 2010) for u in [−1, 1]: w =
    −log1p(−u²) and a degree-8 polynomial in w − 2.5 (w < 5) or √w − 3,
    every step an FMA; ±1 → ±inf."""
    l = log1p(u * -u)                              # product rounded: it has other uses
    p = _where_split(l > -5.0, l,
                     lambda v: _erf_inv_poly(-2.5 - v, _ERFINV_NEAR),
                     lambda v: _erf_inv_poly(_sqrt(-v) - 3.0, _ERFINV_FAR))
    p = torch.where(u.abs() == 1.0, _t(float("inf"), u), p)
    return u * p
