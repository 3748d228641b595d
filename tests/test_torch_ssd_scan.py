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


def _inputs(seed, B, S, H, hd, N, dt_scale=0.5, a_scale=1.0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
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
