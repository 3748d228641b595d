"""Matrix/vector compression operators (paper §3, §A.2, §A.5) — port of
`repro.core.compressors`: `Identity`, `TopK` (BL1's and BL-DNN's main
paths), `RankR` (FedNL's Hessian codec), the unbiased `RandK`,
`RandomDithering`, `NaturalCompression` and `BernoulliLazy`, and the
composed codecs `ComposedTopK` (RTop-K, NTop-K) and `ComposedRankR`
(RRank-R, NRank-R).

One natively-batched contract: ``compress(keys, x)`` takes a stack of n
inputs (leading client axis) and per-client PRNG keys (n, 2)
(`repro_torch.core.prng`), and returns ``(compressed_dense, counts)`` —
zeros where entries were dropped, plus a `comm.Counts` record of what hit
the wire.  ``compress_sum`` adds the sum of the compressed stack over the
client axis (BL-DNN's Fisher leg).  ``keys=None`` is accepted only by the
deterministic compressors (`Identity`, `TopK`, `RankR`); stochastic ones
raise rather than repeat one fixed draw.  Each draw is jax's for the same
key, so a stochastic compressor's output equals the reference's bit for
bit wherever its inputs do.

|·|-Top-K selection is one routine, `topk_keep_mask`: the threshold search
runs on a float32 copy through the exact threshold kernel
(`repro_torch.kernels.topk_threshold`), then the shared tie-break mask
keeps exactly k entries per row.  `TopK.compress_sum` on a CUDA float32
stack runs selection and client sum in the fused kernel
(`topk_compress_sum`), whose dense output is bitwise the two-pass one.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ..kernels.topk_threshold import keep_mask, topk_compress_sum, topk_row_threshold
from . import comm, prng


def _numel(x: torch.Tensor) -> int:
    """Per-client element count of a client-stacked (n, ...) tensor."""
    n = 1
    for s in x.shape[1:]:
        n *= s
    return n


def _full(n: int, value, device) -> torch.Tensor:
    return torch.full((n,), float(value), dtype=torch.float64, device=device)


class Compressor:
    """Base class. Subclasses set `is_unbiased`, `delta` or `omega`."""

    is_unbiased: bool = False
    #: contraction parameter δ ∈ (0,1]  (contractive compressors)
    delta: Optional[float] = None
    #: variance parameter ω ≥ 0        (unbiased compressors)
    omega: Optional[float] = None
    #: True if C(A) is deterministic given A
    deterministic: bool = False

    @property
    def stochastic(self) -> bool:
        return not self.deterministic

    @property
    def wire(self):
        """`comm.WireFormat` (or tuple tree, for composed codecs) pricing
        this operator's `Counts`."""
        return comm.WireFormat()

    def _require_keys(self, keys, n: int):
        if keys is None and self.stochastic:
            raise ValueError(
                f"{type(self).__name__} is stochastic: compress() needs per-client "
                "PRNG keys (n, 2), got None — a substituted fixed key would repeat "
                "the same draw every call")
        return keys

    def compress(self, keys, x: torch.Tensor) -> Tuple[torch.Tensor, comm.Counts]:
        """Compress a client-stacked (n, ...) batch → ``(dense, counts)``
        with per-client (n,) counts; price them with
        ``comm.price(self.wire, counts)``."""
        raise NotImplementedError

    def compress_sum(self, keys, x: torch.Tensor
                     ) -> Tuple[torch.Tensor, comm.Counts, torch.Tensor]:
        """Fused compress-then-reduce: `compress` plus the sum of the
        compressed stack over the client axis, ``(dense, counts,
        local_sum)``.  The default is the two-pass composition."""
        dense, counts = self.compress(keys, x)
        return dense, counts, dense.sum(dim=0)

    def __call__(self, key, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Single-client adapter: compress one tensor with one (2,) key and
        price it.  Returns (compressed_dense, bits_transmitted)."""
        dense, counts = self.compress(None if key is None else key[None], x[None])
        return dense[0], comm.price(self.wire, counts)[0]


@dataclasses.dataclass(unsafe_hash=True)
class Identity(Compressor):
    """No compression; full tensor on the wire."""
    is_unbiased = True
    omega = 0.0
    delta = 1.0
    deterministic = True

    def compress(self, keys, x):
        return x, comm.Counts(floats=_full(x.shape[0], _numel(x), x.device))


def _selection_threshold(a32: torch.Tensor, k: int) -> torch.Tensor:
    """k-th largest per row of non-negative f32 `a32` (..., T) → (..., 1)."""
    t = topk_row_threshold(a32.reshape((-1,) + a32.shape[-1:]).contiguous(), k)
    return t.reshape(a32.shape[:-1] + (1,))


def topk_keep_mask(v: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the K largest-|v| entries along the last axis.

    Exactly K entries are kept per row: entries strictly above the f32
    threshold, then earliest-index entries inside the threshold tie group
    (sub-f32-ulp differences inside the group are broken by index)."""
    a32 = v.abs().to(torch.float32)
    return keep_mask(a32, _selection_threshold(a32, k), k)


@dataclasses.dataclass(unsafe_hash=True)
class TopK(Compressor):
    """Greedy sparsification (Eq. 21): keep K largest-|.| entries.

    Contractive with δ = K/numel.  Deterministic.  ``symmetrize=True`` is
    the triangular-half codec of §A.2 for a stack of square matrices: the
    upper triangle (diagonal included) is gathered into an (n, d(d+1)/2)
    row in ``triu_indices``' row-major order, Top-K selects there (its
    tie-break by earliest index runs over that order), and the kept upper
    half is mirrored below the diagonal; min(K, d(d+1)/2) floats and
    indices travel.  Anything else is selected flat."""
    k: int
    symmetrize: bool = False

    def __post_init__(self):
        self.deterministic = True

    def _symmetrized(self, x):
        n, d = x.shape[0], x.shape[1]
        rows, cols = torch.triu_indices(d, d, device=x.device)   # row-major
        v = x[:, rows, cols]                                  # (n, T)
        kk = min(self.k, v.shape[1])
        keep = torch.zeros((n, d, d), dtype=torch.bool, device=x.device)
        keep[:, rows, cols] = topk_keep_mask(v, kk)
        out = torch.where(keep, x, 0.0)
        out = out + torch.triu(out, 1).mT
        c = _full(n, kk, x.device)
        return out, comm.Counts(floats=c, indices=c)

    def compress(self, keys, x):
        if self.symmetrize and x.dim() == 3 and x.shape[1] == x.shape[2]:
            return self._symmetrized(x)
        n = x.shape[0]
        v = x.reshape(n, -1)
        kk = min(self.k, v.shape[1])
        out = torch.where(topk_keep_mask(v, kk), v, 0.0).reshape(x.shape)
        c = _full(n, kk, x.device)
        return out, comm.Counts(floats=c, indices=c)

    def compress_sum(self, keys, x):
        # a flat float32 stack runs the fused codec (the kernel on the card,
        # its plain version on the CPU); its dense output and counts equal
        # the two-pass default bitwise.  float64 streams and the
        # symmetrized codec take the default, as in the reference.
        if self.symmetrize or x.dtype != torch.float32:
            return super().compress_sum(keys, x)
        n = x.shape[0]
        v = x.reshape(n, -1).contiguous()
        kk = min(self.k, v.shape[1])
        out, s = topk_compress_sum(v, kk)
        c = _full(n, kk, x.device)
        return (out.reshape(x.shape), comm.Counts(floats=c, indices=c),
                s.reshape(x.shape[1:]))


@dataclasses.dataclass(unsafe_hash=True)
class RankR(Compressor):
    """Low-rank approximation via SVD (Eq. 19–20): the best rank-R
    approximation of each matrix of an (n, p, q) stack.

    Contractive with δ = R/d on d×d matrices.  Deterministic.  The
    singular vectors are not unique, but their product is (when σ_R >
    σ_{R+1}), so the output is comparable across libraries."""
    r: int

    def __post_init__(self):
        self.deterministic = True

    def compress(self, keys, x):
        if x.dim() != 3:
            raise ValueError(f"Rank-R needs a stack of matrices, got shape {tuple(x.shape)}")
        n = x.shape[0]
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        rr = min(self.r, s.shape[-1])
        out = torch.matmul(u[:, :, :rr] * s[:, None, :rr], vt[:, :rr, :])
        # wire format: rr singular triples (u_i, σ_i, v_i)
        c = _full(n, rr * (x.shape[1] + x.shape[2] + 1), x.device)
        return out, comm.Counts(floats=c)


@dataclasses.dataclass(unsafe_hash=True)
class RandK(Compressor):
    """Random sparsification (Eq. 22): K entries drawn without replacement
    (``prng.choice``), scaled by numel/K.  Unbiased, ω = numel/K − 1."""
    k: int

    def __post_init__(self):
        self.is_unbiased = True

    def compress(self, keys, x):
        n = x.shape[0]
        keys = self._require_keys(keys, n)
        numel = _numel(x)
        kk = min(self.k, numel)
        v = x.reshape(n, -1)
        idx = prng.choice(keys, numel, (kk,), replace=False, device=x.device)
        out = torch.zeros_like(v).scatter(1, idx, torch.gather(v, 1, idx) * (numel / kk))
        c = _full(n, kk, x.device)
        return out.reshape(x.shape), comm.Counts(floats=c, indices=c)


def _dither_vals(keys: torch.Tensor, x: torch.Tensor, s: int, q: int = 2) -> torch.Tensor:
    """Random dithering (Eq. 17–18) of each row of the (n, ...) stack `x`
    with s levels in the q-norm; level ups drawn in float32 as the
    reference's ``bernoulli(key, pup.astype(float32))``."""
    n = x.shape[0]
    v = x.reshape(n, -1)
    if q == 2:
        raw = torch.sqrt((v * v).sum(dim=1, keepdim=True))
    else:
        raw = (v.abs() ** q).sum(dim=1, keepdim=True) ** (1.0 / q)
    norm = torch.where(raw == 0, 1.0, raw)
    a = v.abs() / norm * s
    low = torch.floor(a)
    up = prng.bernoulli(keys, (a - low).to(torch.float32), (v.shape[1],))
    out = torch.sign(v) * norm * (low + up) / s
    return torch.where(raw == 0, 0.0, out).reshape(x.shape)


def _dither_level_bits(s: int) -> int:
    return math.ceil(math.log2(s + 1))


@dataclasses.dataclass(unsafe_hash=True)
class RandomDithering(Compressor):
    """Unbiased; ω ≤ min(d/s², √d/s) for q=2 [Alistarh et al. 2017].

    Wire: 1 norm float + per-entry (sign + ⌈log₂(s+1)⌉ level) bits."""
    s: int
    q: int = 2

    def __post_init__(self):
        self.is_unbiased = True

    @property
    def wire(self):
        return comm.WireFormat(entry_bits=1 + _dither_level_bits(self.s))

    def compress(self, keys, x):
        n = x.shape[0]
        keys = self._require_keys(keys, n)
        out = _dither_vals(keys, x, self.s, self.q)
        return out, comm.Counts(floats=_full(n, 1, x.device),
                                entries=_full(n, _numel(x), x.device))

    def omega_for(self, numel: int) -> float:
        return min(numel / self.s**2, numel**0.5 / self.s)


@dataclasses.dataclass(unsafe_hash=True)
class NaturalCompression(Compressor):
    """Round |x| to a power of two, randomly up/down (unbiased, ω = 1/8).

    Wire format: sign + 8-bit exponent = 9 bits/entry."""

    def __post_init__(self):
        self.is_unbiased = True
        self.omega = 1.0 / 8.0

    @property
    def wire(self):
        return comm.WireFormat(entry_bits=9)

    def compress(self, keys, x):
        n = x.shape[0]
        keys = self._require_keys(keys, n)
        v = x.reshape(n, -1)
        nz = v != 0
        absv = torch.where(nz, v.abs(), 1.0)
        low = torch.exp2(torch.floor(torch.log2(absv)))
        pup = (absv - low) / low                # ∈ [0, 1): P[round to 2^{e+1}]
        up = prng.bernoulli(keys, pup.to(torch.float32), (v.shape[1],))
        out = torch.sign(v) * low * torch.where(up, 2.0, 1.0)
        out = torch.where(nz, out, 0.0)
        return out.reshape(x.shape), comm.Counts(entries=_full(n, _numel(x), x.device))


def _omega(comp: Compressor, numel: int) -> float:
    return comp.omega if comp.omega is not None else comp.omega_for(numel)


@dataclasses.dataclass(unsafe_hash=True)
class ComposedTopK(Compressor):
    """Top-K followed by an unbiased compressor on the kept values (§A.5).

    RTop-K: inner = RandomDithering(s=√K);  NTop-K: inner =
    NaturalCompression.  Selection is the shared `topk_keep_mask` (the
    threshold kernel on the card); the kept values are compacted to (n, K)
    slots in index order, run through the inner compressor, scaled by
    1/(ω+1) and put back."""
    k: int
    inner: Compressor
    unbias_correct: bool = True

    def __post_init__(self):
        self.deterministic = self.inner.deterministic

    @property
    def wire(self):
        return (comm.WireFormat(), self.inner.wire)

    def compress(self, keys, x):
        n = x.shape[0]
        v = x.reshape(n, -1)
        kk = min(self.k, v.shape[1])
        keys = self._require_keys(keys, n)
        mask = topk_keep_mask(v, kk)
        slot = torch.cumsum(mask, dim=1) - 1             # target slot per kept
        slot = torch.where(mask, slot, kk)               # park dropped at k
        kept = torch.zeros((n, kk + 1), dtype=v.dtype, device=v.device).scatter_add_(
            1, slot, torch.where(mask, v, 0.0))[:, :kk]
        cv, inner_counts = self.inner.compress(keys, kept)
        if self.unbias_correct:
            cv = cv / (_omega(self.inner, kk) + 1.0)
        cvp = torch.cat([cv, torch.zeros((n, 1), dtype=cv.dtype, device=cv.device)], dim=1)
        out = torch.where(mask, torch.gather(cvp, 1, slot), 0.0)
        counts = (comm.Counts(indices=_full(n, kk, x.device)), inner_counts)
        return out.reshape(x.shape), counts


def _count_sum(c, n: int, rr: int):
    """A per-row count leaf of n·rr rows summed to n per-client totals."""
    if isinstance(c, torch.Tensor):
        return c.to(torch.float64).reshape(n, rr).sum(dim=1)
    return float(c) * rr


@dataclasses.dataclass(unsafe_hash=True)
class ComposedRankR(Compressor):
    """C1 of §3: Rank-R with unbiasedly-compressed singular vectors,
    δ = R / (d (ω₁+1)(ω₂+1)) (Prop. 3.2), a_i = b_i = 1.
    ``symmetrize=True`` gives C2 (Lemma 3.1 (ii)).

    Client i's key splits into 2R keys laid out as the reference's
    op-by-op loop: even ones compress the u-vectors, odd ones the
    v-vectors.  The singular vectors' signs are not unique, but each pair
    flips together and both inner codecs are odd in their input, so the
    product is comparable across libraries."""
    r: int
    inner_u: Compressor
    inner_v: Compressor
    symmetrize: bool = True

    def __post_init__(self):
        self.deterministic = self.inner_u.deterministic and self.inner_v.deterministic

    @property
    def wire(self):
        return (comm.WireFormat(), self.inner_u.wire, self.inner_v.wire)

    def compress(self, keys, x):
        if x.dim() != 3:
            raise ValueError(f"Rank-R needs a stack of matrices, got shape {tuple(x.shape)}")
        n, m, p = x.shape
        keys = self._require_keys(keys, n)
        if keys is None:  # fully deterministic inners (degenerate but legal)
            keys = torch.zeros((n, 2), dtype=torch.int64, device=x.device)
        u, s, vt = torch.linalg.svd(x, full_matrices=False)
        rr = min(self.r, s.shape[-1])
        om1, om2 = _omega(self.inner_u, m), _omega(self.inner_v, p)
        ks = prng.split(keys, 2 * rr)                                   # (n, 2rr, 2)
        qu, cu = self.inner_u.compress(ks[:, 0::2].reshape(n * rr, 2),
                                       u[:, :, :rr].mT.reshape(n * rr, m))
        qv, cv = self.inner_v.compress(ks[:, 1::2].reshape(n * rr, 2),
                                       vt[:, :rr, :].reshape(n * rr, p))
        out = torch.einsum("nr,nrm,nrp->nmp", s[:, :rr], qu.reshape(n, rr, m),
                           qv.reshape(n, rr, p)) / ((om1 + 1.0) * (om2 + 1.0))
        if self.symmetrize:
            xt = x.mT
            sym = ((x - xt).abs() <= 1e-8 + 1e-5 * xt.abs()).flatten(1).all(dim=1)
            out = torch.where(sym[:, None, None], (out + out.mT) / 2.0, out)
        counts = (comm.Counts(floats=_full(n, rr, x.device)),
                  comm.Counts(*(_count_sum(c, n, rr) for c in cu)),
                  comm.Counts(*(_count_sum(c, n, rr) for c in cv)))
        return out, counts


@dataclasses.dataclass(unsafe_hash=True)
class BernoulliLazy(Compressor):
    """Lazy Bernoulli compressor (§A.8): send the full tensor w.p. p, else
    zero.  Unbiased with ω = 1/p − 1.  Client i draws one
    ``bernoulli(keys[i], p)``, as the reference's vmap over its keys."""
    p: float

    def __post_init__(self):
        self.is_unbiased = True
        self.omega = 1.0 / self.p - 1.0

    def compress(self, keys, x):
        n = x.shape[0]
        keys = self._require_keys(keys, n)
        send = prng.bernoulli(keys, self.p, (), device=x.device)
        bshape = (n,) + (1,) * (x.dim() - 1)
        out = torch.where(send.reshape(bshape), x / self.p, torch.zeros_like(x))
        floats = torch.where(send, float(_numel(x)), 0.0).to(torch.float64)
        return out, comm.Counts(floats=floats)


def rtopk(k: int) -> ComposedTopK:
    """RTop-K: Top-K composed with random dithering at s = round(√K)."""
    s = max(1, int(round(k ** 0.5)))
    return ComposedTopK(k=k, inner=RandomDithering(s=s))


def ntopk(k: int) -> ComposedTopK:
    """NTop-K: Top-K composed with natural compression."""
    return ComposedTopK(k=k, inner=NaturalCompression())


def rrankr(r: int, d: int) -> ComposedRankR:
    """RRank-R: both singular-vector legs dithered at s = round(√d)."""
    s = max(1, int(round(d ** 0.5)))
    return ComposedRankR(r=r, inner_u=RandomDithering(s=s), inner_v=RandomDithering(s=s))


def nrankr(r: int) -> ComposedRankR:
    """NRank-R: both singular-vector legs naturally compressed."""
    return ComposedRankR(r=r, inner_u=NaturalCompression(), inner_v=NaturalCompression())
