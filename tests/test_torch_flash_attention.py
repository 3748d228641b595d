"""The port's attention kernel wrapper (`repro_torch.kernels.flash_attention`,
`ops.attention`) against the reference on the CPU.

On the CPU the wrapper runs its plain version (the exact masked softmax in
float32); the CUDA kernel is held against that plain version on the card by
chip_smoke.py (phase kernels_attn).  Here the plain version is held to the
reference's Pallas kernel in interpret mode and to `ref.attention_ref` on
the reference's sweep (`tests/test_kernels.py`), and `ops.attention` in the
grouped-query layout to the model's `_blocked_attn`.  Tolerances are the
reference's own: 2e-4 (rtol and atol) in float32, 2e-2 in bfloat16.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models import layers as JL
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops

SWEEP = [
    dict(BH=2, Sq=128, Sk=128, hd=64, causal=True, window=None),
    dict(BH=1, Sq=256, Sk=256, hd=32, causal=True, window=64),
    dict(BH=3, Sq=64, Sk=192, hd=64, causal=False, window=None),
    dict(BH=2, Sq=96, Sk=96, hd=128, causal=True, window=17),
]
F32_TOL = dict(rtol=2e-4, atol=2e-4)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _port(x: np.ndarray, dtype) -> torch.Tensor:
    """(BH, S, hd) as the port's (B, S, H, hd) with one head a batch entry."""
    return torch.tensor(x, dtype=torch.float32).to(dtype)[:, :, None, :]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cfg", SWEEP, ids=lambda c: "{BH}x{Sq}x{Sk}x{hd}-c{causal}-w{window}".format(**c))
def test_plain_matches_pallas_kernel_and_oracle(cfg, dtype):
    rng = np.random.default_rng(cfg["Sq"] * cfg["hd"])
    q, k, v = (rng.standard_normal((cfg["BH"], s, cfg["hd"])).astype(np.float32)
               for s in (cfg["Sq"], cfg["Sk"], cfg["Sk"]))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    want_kernel = np.asarray(pallas_flash(jq, jk, jv, causal=cfg["causal"],
                                          window=cfg["window"], bq=64, bk=64), np.float32)
    want_ref = np.asarray(ref.attention_ref(jq, jk, jv, causal=cfg["causal"],
                                            window=cfg["window"]), np.float32)
    got = fa.flash_attention(_port(q, tdt), _port(k, tdt), _port(v, tdt),
                             causal=cfg["causal"], window=cfg["window"])
    assert got.dtype == tdt and got.shape == (cfg["BH"], cfg["Sq"], 1, cfg["hd"])
    got = got[:, :, 0].float().numpy()
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(got, want_kernel, **tol)
    np.testing.assert_allclose(got, want_ref, **tol)


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)], ids=["rep1", "rep2", "rep8"])
@pytest.mark.parametrize("window", [None, 8])
def test_ops_attention_matches_blocked_model_attention(heads, window):
    """Grouped-query layout: query head h reads KV head h // (H // KVH)."""
    H, KVH = heads
    B, S, hd = 2, 64, 32
    rng = np.random.default_rng(H * 10 + KVH)
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KVH, hd)).astype(np.float32) for _ in range(2))
    if window is None:
        mask = lambda qi, ki: ki <= qi  # noqa: E731
    else:
        mask = lambda qi, ki: (ki <= qi) & (ki > qi - window)  # noqa: E731
    qg = jnp.asarray(q).reshape(B, S, KVH, H // KVH, hd)
    want = np.asarray(JL._blocked_attn(qg, jnp.asarray(k), jnp.asarray(v), mask, 16, None,
                                       window=window))
    got = ops.attention(*(torch.tensor(a) for a in (q, k, v)), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    pallas = np.asarray(jops.attention(*(jnp.asarray(a) for a in (q, k, v)), causal=True,
                                       window=window, bq=32, bk=32))
    np.testing.assert_allclose(got.numpy(), pallas, **F32_TOL)


def test_rows_that_see_no_key_average_every_value():
    """Non-causal with a window: queries q ≥ Sk + window − 1 see no key; the
    reference's −1e30 masking then gives the mean of v, and so does the port."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((1, s, 16)).astype(np.float32) for s in (40, 20, 20))
    want = np.asarray(ref.attention_ref(*(jnp.asarray(a) for a in (q, k, v)),
                                        causal=False, window=4))
    got = fa.flash_attention(_port(q, torch.float32), _port(k, torch.float32),
                             _port(v, torch.float32), causal=False, window=4)[:, :, 0]
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    np.testing.assert_allclose(got[0, 30].numpy(), v[0].mean(0), rtol=1e-5, atol=1e-6)


def test_mask_is_the_reference_kernels():
    for causal, window in ((True, None), (True, 3), (False, 5), (False, None)):
        m = fa.mask(7, 9, causal, window).numpy()
        qi, ki = np.arange(7)[:, None], np.arange(9)[None, :]
        want = np.ones((7, 9), bool)
        if causal:
            want &= ki <= qi
        if window is not None:
            want &= ki > qi - window
        np.testing.assert_array_equal(m, want)


def test_cpu_tensors_take_the_plain_version_without_a_launch():
    rng = np.random.default_rng(1)
    q = torch.tensor(rng.standard_normal((2, 10, 4, 8)), dtype=torch.float32)
    k, v = (torch.tensor(rng.standard_normal((2, 10, 2, 8)), dtype=torch.float32)
            for _ in range(2))
    before = fa.launches
    got = fa.flash_attention(q, k, v, causal=True, window=3)
    assert fa.launches == before
    assert torch.equal(got, fa.flash_attention_plain(q, k, v, causal=True, window=3))


def test_rejects_what_the_kernel_does_not_take():
    q = torch.zeros((1, 4, 4, 8))
    kv = torch.zeros((1, 4, 2, 8))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        fa.flash_attention(q.double(), kv.double(), kv.double())
    with pytest.raises(TypeError, match="differ in type"):
        fa.flash_attention(q, kv.bfloat16(), kv)
    with pytest.raises(ValueError, match="groups"):
        fa.flash_attention(q, torch.zeros((1, 4, 3, 8)), torch.zeros((1, 4, 3, 8)))
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, kv, kv, window=0)
    with pytest.raises(ValueError, match="do not match"):
        fa.flash_attention(q, kv, torch.zeros((1, 5, 2, 8)))
    with pytest.raises(ValueError, match="at least one key"):
        fa.flash_attention(q, kv[:, :0], kv[:, :0])
