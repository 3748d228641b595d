"""The port's SSD scan wrapper (`repro_torch.kernels.ssd_scan`, `ops.ssd`)
against the reference on the CPU.

On the CPU the wrapper runs its plain version, a transcription of the
model's `_ssd_chunked` that returns y and the final state; the CUDA kernel
is held against that plain version on the card by chip_smoke.py (phase
kernels_ssd).  Here the plain version is held to the reference's Pallas
kernel in interpret mode, to the sequential oracle `ref.ssd_scan_ref` and to
`_ssd_chunked` (y and the final state), within the reference's own 1e-3
(rtol and atol, `tests/test_kernels.py`).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as pallas_ssd
from repro.models.layers import _ssd_chunked
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as ss

TOL = dict(rtol=1e-3, atol=1e-3)
SWEEP = [
    dict(BH=2, S=64, hd=16, N=8, chunk=16),
    dict(BH=1, S=128, hd=32, N=16, chunk=32),
    dict(BH=4, S=96, hd=8, N=4, chunk=24),
    dict(BH=1, S=60, hd=16, N=8, chunk=32),   # chunk does not divide S: shrinks
]


def _inputs(seed, B, S, H, hd, N, dt_scale=0.5, a_scale=1.0, mamba2_init=False):
    """Seeded inputs; `mamba2_init` draws A and dt as mamba2-370m's init
    makes them: A = −exp(log(1..H)), dt = softplus of a N(0, 1)
    pre-activation (dt_bias 0)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    if mamba2_init:
        dt = np.logaddexp(0.0, rng.standard_normal((B, S, H))).astype(np.float32)
        A = -np.arange(1, H + 1).astype(np.float32)
    else:
        dt = (rng.random((B, S, H)) * dt_scale + 0.01).astype(np.float32)
        A = ((-rng.random(H) - 0.1) * a_scale).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


def _sequential_state(x, dt, A, Bm):
    """The state after the last position by the plain recurrence
    S_t = exp(dt_t A) S_{t−1} + dt_t x_t ⊗ B_t, in float64."""
    B, S, H, hd = x.shape
    s = np.zeros((B, H, hd, Bm.shape[-1]))
    for t in range(S):
        dec = np.exp(dt[:, t].astype(np.float64) * A)
        s = s * dec[:, :, None, None] + (dt[:, t, :, None, None] * x[:, t, :, :, None]
                                         * Bm[:, t, None, None, :])
    return s


@pytest.mark.parametrize("cfg", SWEEP, ids=lambda c: "{BH}x{S}x{hd}x{N}-c{chunk}".format(**c))
def test_plain_matches_pallas_kernel_and_oracle(cfg):
    """Each folded row (B·H) is a batch entry with one head and its own B, C
    (all rows share the one head's A)."""
    x, dt, A, Bm, Cm = _inputs(cfg["S"], cfg["BH"], cfg["S"], 1, cfg["hd"], cfg["N"])
    folded = (x[:, :, 0], dt[:, :, 0], A[0] * np.ones(cfg["BH"], np.float32), Bm, Cm)
    want_kernel = np.asarray(pallas_ssd(*map(jnp.asarray, folded), chunk=cfg["chunk"]))
    want_ref = np.asarray(ref.ssd_scan_ref(*map(jnp.asarray, folded)))
    y, state = ss.ssd_scan(*(torch.tensor(a) for a in (x, dt, A, Bm, Cm)), chunk=cfg["chunk"])
    assert y.shape == x.shape and state.shape == (cfg["BH"], 1, cfg["hd"], cfg["N"])
    np.testing.assert_allclose(y[:, :, 0].numpy(), want_kernel, **TOL)
    np.testing.assert_allclose(y[:, :, 0].numpy(), want_ref, **TOL)
    np.testing.assert_allclose(state.numpy(), _sequential_state(x, dt, A, Bm), **TOL)


@pytest.mark.parametrize("chunk", [16, 64])
def test_matches_model_ssd_chunked_with_shared_B_C(chunk):
    """Heads share B and C; y and the final state against `_ssd_chunked` at
    chunk 16 (the chunk length changes only the rounding)."""
    x, dt, A, Bm, Cm = _inputs(7, 2, 64, 3, 16, 8)
    y_ref, s_ref = _ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=16)
    y, s = ops.ssd(*(torch.tensor(a) for a in (x, dt, A, Bm, Cm)), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), _sequential_state(x, dt, A, Bm), **TOL)


def test_large_decay_underflows_as_the_reference():
    """|dt·A| in the hundreds: exp of the chunk's log-decay underflows to 0
    on purpose (masking comes before the exp), and both sides stay finite."""
    x, dt, A, Bm, Cm = _inputs(11, 2, 96, 2, 16, 8, dt_scale=10.0, a_scale=40.0)
    assert (dt[..., None] * A).min() < -100
    y_ref, s_ref = _ssd_chunked(*map(jnp.asarray, (x, dt, A, Bm, Cm)), chunk=32)
    y, s = ss.ssd_scan(*(torch.tensor(a) for a in (x, dt, A, Bm, Cm)), chunk=32)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    np.testing.assert_allclose(y.numpy(), np.asarray(y_ref), **TOL)
    np.testing.assert_allclose(s.numpy(), np.asarray(s_ref), **TOL)


def test_strided_views_give_the_contiguous_result():
    """The Mamba2 layer passes x, B and C as views of the conv output."""
    x, dt, A, Bm, Cm = _inputs(3, 2, 32, 4, 8, 8)
    conv = torch.cat([torch.tensor(x).reshape(2, 32, 32), torch.tensor(Bm),
                      torch.tensor(Cm)], dim=-1)
    xv, bv, cv = torch.split(conv, [32, 8, 8], dim=-1)
    got = ss.ssd_scan(xv.reshape(2, 32, 4, 8), torch.tensor(dt), torch.tensor(A), bv, cv,
                      chunk=8)
    want = ss.ssd_scan(*(torch.tensor(a) for a in (x, dt, A, Bm, Cm)), chunk=8)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_cpu_tensors_take_the_plain_version_and_bad_inputs_raise():
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in _inputs(2, 1, 16, 2, 8, 4))
    before = ss.launches
    y, s = ss.ssd_scan(x, dt, A, Bm, Cm, chunk=8)
    assert ss.launches == before
    yp, sp = ss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=8)
    assert torch.equal(y, yp) and torch.equal(s, sp)
    with pytest.raises(TypeError, match="float32-only"):
        ss.ssd_scan(x.double(), dt, A, Bm, Cm)
    with pytest.raises(ValueError, match="do not match"):
        ss.ssd_scan(x, dt[:, :8], A, Bm, Cm)


#: kernel 6's gate on the card (chip_smoke.py, phase kernels_ssd)
SSD_GATE = 1e-4
#: (inputs, the plain version's chunk as the card's check passes it, the
#: reference's chunk for `_ssd_chunked`, a divisor of S, and whether the
#: inputs are well conditioned).  With decays of |dt·A| up to 1e3 a step the
#: cumulative sums reach 1e4–1e5 and exp(cs_q − cs_k) is a difference of
#: large float32 numbers: the plain version's 150-position chunks and the
#: kernel's 128-position ones then round apart by up to about the gate
#: whatever the products (here 0.88 of it with exact float32 products), so
#: there the split is held to exact products instead of to half the gate.
ARITH_CASES = {
    "random": (dict(seed=21, B=2, S=300, H=3, hd=64, N=128), 256, 100, True),
    "mixed decays, |cs| to 1e5": (dict(seed=22, B=2, S=300, H=2, hd=64, N=128, dt_scale=20.0,
                                       a_scale=50.0), 256, 100, False),
    "small heads, shared B and C": (dict(seed=23, B=2, S=64, H=3, hd=16, N=8), 16, 16, True),
}


def _fold(x, dt, A, B, C):
    """(B, S, H, ·) as the reference kernel's folded (B·H, S, ·), each head a
    row with its own copy of B and C."""
    Bsz, S, H, hd = x.shape
    rows = lambda t: np.repeat(t, H, axis=0)  # noqa: E731
    return (x.transpose(0, 2, 1, 3).reshape(Bsz * H, S, hd),
            dt.transpose(0, 2, 1).reshape(Bsz * H, S), np.tile(A, Bsz),
            rows(B), rows(C))


def _share(got, want):
    """max|got − want| as a share of the gate on max|want|."""
    return float((got - want).abs().max() / want.abs().max()) / SSD_GATE


@pytest.mark.parametrize("case", sorted(ARITH_CASES))
@pytest.mark.parametrize("products", ["split", "single"])
def test_kernel_arithmetic_holds_the_chip_gate_only_with_split_products(case, products):
    """The chunk-parallel kernel's arithmetic, emulated.  With split TF32
    products: within 5 % of the card's gate (1e-4·max|·|) of the same
    arithmetic with exact float32 products, in y and the final state; within
    half the gate of the plain version on well-conditioned inputs and within
    the gate on mixed decays (see ARITH_CASES); within the gate of the
    reference's `_ssd_chunked` and sequential `ref.ssd_scan_ref`.  With one
    TF32 product y leaves the gate."""
    cfg, plain_chunk, ref_chunk, conditioned = ARITH_CASES[case]
    cfg = dict(cfg)
    seed = cfg.pop("seed")
    args = _inputs(seed, **cfg)
    t_args = [torch.tensor(a) for a in args]
    y, s = ss.ssd_scan_emulated(*t_args, products=products)
    yp, sp = ss.ssd_scan_plain(*t_args, chunk=plain_chunk)
    if products == "single":
        assert _share(y, yp) > 1.0, _share(y, yp)
        return
    ye, se = ss.ssd_scan_emulated(*t_args, products="exact")
    assert _share(y, ye) <= 0.05 and _share(s, se) <= 0.05, (_share(y, ye), _share(s, se))
    limit = 0.5 if conditioned else 1.0
    assert _share(y, yp) <= limit and _share(s, sp) <= limit, (_share(y, yp), _share(s, sp))
    y_ref, s_ref = (torch.tensor(np.asarray(a))
                    for a in _ssd_chunked(*map(jnp.asarray, args), chunk=ref_chunk))
    assert _share(y, y_ref) <= 1.0 and _share(s, s_ref) <= 1.0
    y_seq = torch.tensor(np.asarray(ref.ssd_scan_ref(*map(jnp.asarray, _fold(*args)))))
    y_fold = y.permute(0, 2, 1, 3).reshape(y_seq.shape)
    assert _share(y_fold, y_seq) <= 1.0



@pytest.mark.parametrize("chunk", [16, 32])
def test_plain_gradients_match_jax_grad_of_ssd_chunked(chunk):
    """The training path on CPU tensors: autograd through the plain version
    against jax.grad of the model's `_ssd_chunked` (float32; dx, ddt, dA, dB,
    dC of a loss on y and on the final state), within the reference's
    1e-3."""
    x, dt, A, Bm, Cm = _inputs(21 + chunk, 2, 64, 3, 16, 8)
    rng = np.random.default_rng(chunk)
    dy = rng.standard_normal(x.shape).astype(np.float32)
    ds = rng.standard_normal((2, 3, 16, 8)).astype(np.float32)

    def ref_loss(*args):
        y, s = _ssd_chunked(*args, chunk=chunk)
        return jnp.sum(y * dy) + jnp.sum(s * ds)

    want = jax.grad(ref_loss, argnums=tuple(range(5)))(*map(jnp.asarray, (x, dt, A, Bm, Cm)))
    ins = [torch.tensor(a, requires_grad=True) for a in (x, dt, A, Bm, Cm)]
    y, s = ss.ssd_scan(*ins, chunk=chunk)
    torch.autograd.backward([y, s], [torch.tensor(dy), torch.tensor(ds)])
    for t, w in zip(ins, want):
        w = np.asarray(w)
        np.testing.assert_allclose(t.grad.numpy(), w, rtol=1e-3, atol=1e-3 * np.abs(w).max())


def test_plain_version_takes_float64_and_the_cuda_path_is_an_autograd_function():
    """float64 runs of the plain version are the card's yardstick for the
    backward kernel; the wrapper still refuses float64."""
    x, dt, A, Bm, Cm = (torch.tensor(a) for a in _inputs(4, 1, 32, 2, 8, 4))
    y64, s64 = ss.ssd_scan_plain(*(t.double() for t in (x, dt, A, Bm, Cm)), chunk=8)
    y, s = ss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=8)
    assert y64.dtype == torch.float64
    np.testing.assert_allclose(y.numpy(), y64.numpy(), rtol=1e-5, atol=1e-5)
    with pytest.raises(TypeError, match="float32-only"):
        ss.ssd_scan(*(t.double() for t in (x, dt, A, Bm, Cm)))
    assert issubclass(ss.SSDScan, torch.autograd.Function)


#: kernel 6b's arithmetic, emulated: (inputs, whether a final-state gradient
#: is taken).  "mixed decays" is chip_smoke.py's case of that name (dt·A from
#: −0.05 to −550 a step, cumulative decays to −10⁴); "mamba2 init" draws A
#: and dt as mamba2-370m's init does, at its widths (32 heads × 64, N 128)
BWD_ARITH_CASES = {
    "random": (dict(seed=31, B=2, S=300, H=3, hd=64, N=128), True),
    "mixed decays": (dict(seed=32, B=2, S=300, H=2, hd=64, N=128, dt_scale=10.0,
                          a_scale=50.0), False),
    "mamba2 init": (dict(seed=33, B=1, S=300, H=32, hd=64, N=128, mamba2_init=True), True),
}
_BWD_NAMES = ("dx", "ddt", "dA", "dB", "dC")


@functools.lru_cache(maxsize=None)
def _bwd_case(case):
    """(inputs, dy, the final state's gradient or None, jax.grad of
    `_ssd_chunked` in float64).  The reference is taken in float64: in
    float32 its cumulative decays reach −10⁴ on "mixed decays", where their
    ulp is ~1e-3, and its own ddt and dA read 4–7× the gate off float64
    there (the repair of kernel 6b's first version)."""
    cfg, with_state = BWD_ARITH_CASES[case]
    cfg = dict(cfg)
    seed = cfg.pop("seed")
    args = _inputs(seed, **cfg)
    rng = np.random.default_rng(seed + 100)
    dy = rng.standard_normal(args[0].shape).astype(np.float32)
    ds = (rng.standard_normal((cfg["B"], cfg["H"], cfg["hd"], cfg["N"])).astype(np.float32)
          if with_state else None)

    def loss(*a):
        y, s = _ssd_chunked(*a, chunk=100)
        out = jnp.sum(y * dy)
        return out if ds is None else out + jnp.sum(s * ds)

    with jax.enable_x64(True):
        want = jax.grad(loss, argnums=tuple(range(5)))(
            *(jnp.asarray(a, jnp.float64) for a in args))
        want = tuple(torch.tensor(np.asarray(w)) for w in want)
    return ([torch.tensor(a) for a in args], torch.tensor(dy),
            None if ds is None else torch.tensor(ds), want)


@pytest.mark.parametrize("case", sorted(BWD_ARITH_CASES))
@pytest.mark.parametrize("products", ["split", "single"])
def test_backward_arithmetic_holds_the_chip_gate_only_with_split_products(case, products):
    """Kernel 6b's arithmetic, emulated (`ssd_scan_bwd_emulated`).  With
    split TF32 products: dx, ddt, dB and dC within 5 % of the card's gate
    (1e-4·max|·|) of the same arithmetic with exact float32 products, and dA
    no further from the reference than the exact products' dA plus 5 % (dA
    sums d(dt·A) over every position with cancellation, so float32 noise in
    either reads up to 10 % of the gate there); every output within half the
    gate of jax.grad of the reference's `_ssd_chunked` (float64).  With one
    TF32 product an output leaves the gate."""
    args, dy, ds, want = _bwd_case(case)
    got = ss.ssd_scan_bwd_emulated(*args, dy, ds, products=products)
    to_ref = {n: _share(g.double(), w) for n, g, w in zip(_BWD_NAMES, got, want)}
    if products == "single":
        assert max(to_ref.values()) > 1.0, to_ref
        return
    exact = ss.ssd_scan_bwd_emulated(*args, dy, ds, products="exact")
    to_exact = {n: _share(g, e) for n, g, e in zip(_BWD_NAMES, got, exact)}
    exact_to_ref = _share(exact[2].double(), want[2])
    assert all(to_exact[n] <= 0.05 for n in ("dx", "ddt", "dB", "dC")), to_exact
    assert to_ref["dA"] <= exact_to_ref + 0.05, (to_ref["dA"], exact_to_ref)
    assert max(to_ref.values()) <= 0.5, to_ref
