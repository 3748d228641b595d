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


def _kernel_arithmetic(q, k, v, causal, window, split_p, bk=64, q_pos0=0):
    """What the bfloat16 tensor-core kernel computes, in torch on the CPU:
    bfloat16 inputs, float32 scores over 64-key tiles in base 2, the online
    softmax with a float32 running max and denominator, P rounded to
    bfloat16 before P·V — split into bf16(p) and bf16(p − bf16(p)), or once
    — and float32 accumulation.  Returns the float32 output before its
    final bfloat16 rounding.  Query row i stands at position q_pos0 + i."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KVH, H // KVH, hd)
    kf, vf = k.float(), v.float()
    keep = fa.mask(Sq, Sk, causal, window, q_pos0=q_pos0)
    scale_log2 = float(np.float32(np.log2(np.e) / np.sqrt(hd)))
    m = torch.full((B, KVH, H // KVH, Sq), -1e30)
    l = torch.zeros_like(m)
    acc = torch.zeros((B, KVH, H // KVH, Sq, hd))
    for k0 in range(0, Sk, bk):
        s = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf[:, k0:k0 + bk]) * scale_log2
        s = torch.where(keep[:, k0:k0 + bk], s, -1e30)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s - m_new[..., None])
        l = l * alpha + p.sum(-1)
        hi = p.bfloat16().float()
        if split_p:
            pv = (torch.einsum("bgrqk,bkgd->bgrqd", hi, vf[:, k0:k0 + bk])
                  + torch.einsum("bgrqk,bkgd->bgrqd", (p - hi).bfloat16().float(),
                                 vf[:, k0:k0 + bk]))
        else:
            pv = torch.einsum("bgrqk,bkgd->bgrqd", hi, vf[:, k0:k0 + bk])
        acc = acc * alpha[..., None] + pv
        m = m_new
    o = acc / l[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd)


MASKS = [(True, None, 0), (True, 100, 0), (True, 100, 100)]
MASK_IDS = ["causal", "window100", "window100_offset100"]


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("p_rounding", ["split", "single"])
def test_bf16_kernel_arithmetic_holds_the_chip_gate_only_with_p_split(mask, p_rounding):
    """The bfloat16 kernel's P·V takes P in bfloat16.  Held to the plain
    version under chip_smoke.py's gate (one bfloat16 ulp of the plain value
    + 1e-5·max|plain|, elementwise; compared before the output's bfloat16
    rounding, which both share), P split into two bfloat16 terms uses at
    most half the gate at hd 256; one bfloat16 rounding of P leaves it.
    The offset case is a sequence-parallel rank's slice: 200 queries at
    positions 100 .. 299 against 300 keys."""
    causal, window, q_pos0 = mask
    B, S, H, KVH, hd = 1, 300, 4, 2, 256
    rng = np.random.default_rng(15)
    q = torch.tensor(rng.standard_normal((B, S - q_pos0, H, hd)),
                     dtype=torch.float32).bfloat16()
    k, v = (torch.tensor(rng.standard_normal((B, S, KVH, hd)),
                         dtype=torch.float32).bfloat16() for _ in range(2))
    got = _kernel_arithmetic(q, k, v, causal, window, split_p=p_rounding == "split",
                             q_pos0=q_pos0)
    # the plain version's float32 value: its arithmetic on the same bf16 values
    plain = fa.flash_attention_plain(q.float(), k.float(), v.float(), causal=causal,
                                     window=window, q_pos0=q_pos0)
    ulp = torch.where(plain == 0, 0.0,
                      torch.ldexp(torch.ones_like(plain), torch.frexp(plain)[1] - 8))
    share = float(((got - plain).abs() / (1e-5 * plain.abs().max() + ulp)).max())
    if p_rounding == "split":
        assert share <= 0.5, share
    else:
        assert share > 1.0, share


def _bwd_kernel_arithmetic(q, k, v, do, causal, window, split_p, split_ds, bk=32, q_pos0=0):
    """What the bfloat16 backward kernels compute, in torch on the CPU:
    bfloat16 inputs and exact float32 products s = q·kᵀ, dP = dO·vᵀ; the
    scale applied in float32 after them, in base 2; launch 1's pass over
    `bk`-key tiles keeping each row's running max m, denominator l and
    Σ exp2(x − m)·dP; then P = exp2(x − m)/l and dS = P ∘ (dP − D), each
    entering its product in bfloat16 — split into bf16(x) and
    bf16(x − bf16(x)), or rounded once — with float32 sums: dq = dS·k·scale,
    dk = dSᵀ·q·scale, dv = Pᵀ·dO.  Returns float32 (dq, dk, dv) before their
    final bfloat16 rounding.  Query row i stands at position q_pos0 + i."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, Sq, KVH, H // KVH, hd)
    dog = do.float().reshape(B, Sq, KVH, H // KVH, hd)
    kf, vf = k.float(), v.float()
    keep = fa.mask(Sq, Sk, causal, window, q_pos0=q_pos0)
    scale = float(np.float32(1 / np.sqrt(hd)))
    scale_log2 = float(np.float32(np.log2(np.e) / np.sqrt(hd)))
    m = torch.full((B, KVH, H // KVH, Sq), -1e30)
    l = torch.zeros_like(m)
    dsum = torch.zeros_like(m)
    for k0 in range(0, Sk, bk):
        x = torch.einsum("bqgrd,bkgd->bgrqk", qg, kf[:, k0:k0 + bk]) * scale_log2
        x = torch.where(keep[:, k0:k0 + bk], x, -1e30)
        dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vf[:, k0:k0 + bk])
        m_new = torch.maximum(m, x.amax(-1))
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(x - m_new[..., None])
        l = l * alpha + p.sum(-1)
        dsum = dsum * alpha + (p * dp).sum(-1)
        m = m_new
    inv = 1 / l.clamp_min(1e-30)
    x = torch.where(keep, torch.einsum("bqgrd,bkgd->bgrqk", qg, kf) * scale_log2, -1e30)
    dp = torch.einsum("bqgrd,bkgd->bgrqk", dog, vf)
    p = torch.exp2(x - m[..., None]) * inv[..., None]
    ds = torch.where(keep, p * (dp - (dsum * inv)[..., None]), 0.0)

    def terms(a, split):
        hi = a.bfloat16().float()
        return (hi, (a - hi).bfloat16().float()) if split else (hi,)

    dq = sum(torch.einsum("bgrqk,bkgd->bqgrd", t, kf) for t in terms(ds, split_ds)) * scale
    dk = sum(torch.einsum("bgrqk,bqgrd->bkgd", t, qg) for t in terms(ds, split_ds)) * scale
    dv = sum(torch.einsum("bgrqk,bqgrd->bkgd", t, dog) for t in terms(p, split_p))
    return dq.reshape(B, Sq, H, hd), dk, dv


@pytest.mark.parametrize("mask", MASKS, ids=MASK_IDS)
@pytest.mark.parametrize("rounding", ["split", "single_p", "single_ds"])
def test_bf16_backward_arithmetic_holds_the_chip_gate_only_with_p_and_ds_split(mask, rounding):
    """The bfloat16 backward kernels take P (into dv) and dS (into dq and dk)
    in bfloat16.  Held to float64 autograd through the plain version under
    chip_smoke.py's backward gate (one bfloat16 ulp of the float64 value +
    1e-4·max|f64|, elementwise; compared before the outputs' bfloat16
    rounding), both split into two bfloat16 terms use at most half the gate
    at hd 256; one bfloat16 rounding of P leaves it in dv, of dS in dq and
    dk.  The offset case: 200 queries at positions 100 .. 299."""
    causal, window, q_pos0 = mask
    B, S, H, KVH, hd = 1, 300, 4, 2, 256
    rng = np.random.default_rng(16)
    q, do = (torch.tensor(rng.standard_normal((B, S - q_pos0, H, hd)),
                          dtype=torch.float32).bfloat16() for _ in range(2))
    k, v = (torch.tensor(rng.standard_normal((B, S, KVH, hd)),
                         dtype=torch.float32).bfloat16() for _ in range(2))
    got = _bwd_kernel_arithmetic(q, k, v, do, causal, window, split_p=rounding != "single_p",
                                 split_ds=rounding != "single_ds", q_pos0=q_pos0)
    ins = [x.double().requires_grad_(True) for x in (q, k, v)]
    out = fa.flash_attention_plain(*ins, causal=causal, window=window, q_pos0=q_pos0)
    want = torch.autograd.grad(out, ins, do.double())
    share = {}
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        ulp = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8))
        share[name] = float(((g.double() - w).abs() / (1e-4 * w.abs().max() + ulp)).max())
    if rounding == "split":
        assert max(share.values()) <= 0.5, share
    elif rounding == "single_p":
        assert share["dv"] > 1.0 and share["dq"] <= 0.5 and share["dk"] <= 0.5, share
    else:
        assert share["dq"] > 1.0 and share["dk"] > 1.0 and share["dv"] <= 0.5, share


def _round_toward_zero(exact: torch.Tensor) -> torch.Tensor:
    """float64 values to float32, rounded toward zero."""
    r = exact.float()
    return torch.where(r.double().abs() > exact.abs(), torch.nextafter(r, torch.zeros_like(r)), r)


def test_bf16_dkdv_accumulation_is_summed_a_query_head_at_a_time():
    """The bfloat16 dk/dv launch sums a KV head's rep query heads.  wgmma's
    float32 accumulation drops a little toward zero on every add (on the
    card, granite-20b's 48 query heads on one KV head at 4096 tokens left
    the backward's gate: dk and dv shrank by 4.7e-4 and 3.6e-4 on average
    over one accumulator's 24,576 adds).  Emulated here, each 16-query
    product added with rounding toward zero: the dk of the first 64 keys at
    48 heads of 2048 causal queries, one accumulator for the whole walk,
    shrinks by more than 1e-4 on average; the kernel's walk — the
    accumulator holding one query head's walk, each head's added to a
    float32 partial sum with one rounding to nearest — shrinks by less than
    a tenth of that and keeps half the gate (one bf16 ulp of the float64
    value + 1e-4·max|f64|)."""
    S, H, hd, kb = 2048, 48, 32, 64
    gen = torch.Generator().manual_seed(48)

    def draw(*shape):
        return torch.randn(*shape, generator=gen).bfloat16().double()

    q, do = draw(H, S, hd), draw(H, S, hd)
    k, v = draw(S, hd), draw(S, hd)
    keep = torch.ones(S, S, dtype=torch.bool).tril()
    truth = torch.zeros(kb, hd, dtype=torch.float64)
    steps = []                # each head's 16-query products, exact: (S / 16, kb, hd)
    for h in range(H):
        p = torch.softmax(torch.where(keep, q[h] @ k.T * hd ** -0.5, -1e300), -1)
        dp = do[h] @ v.T
        ds = (p * (dp - (p * dp).sum(-1, keepdim=True)))[:, :kb]
        truth += ds.T @ q[h]
        hi = ds.float().bfloat16().double()
        lo = (ds - hi).float().bfloat16().double()
        steps.append([torch.einsum("tqk,tqd->tkd", part.reshape(S // 16, 16, kb),
                                   q[h].reshape(S // 16, 16, hd)) for part in (hi, lo)])

    def walk(per_head: bool) -> torch.Tensor:
        acc, part = torch.zeros(kb, hd), None
        for h, (hi, lo) in enumerate(steps):
            for t in range(S // 16):
                acc = _round_toward_zero(acc.double() + hi[t])
                acc = _round_toward_zero(acc.double() + lo[t])
            if per_head and h < H - 1:
                part = acc if part is None else (part.double() + acc.double()).float()
                acc = torch.zeros(kb, hd)
        return acc if part is None else (part.double() + acc.double()).float()

    big = truth.abs() > 0.1 * truth.abs().max()
    ulp = torch.where(truth == 0, 0.0, torch.ldexp(torch.ones_like(truth),
                                                     torch.frexp(truth)[1] - 8))
    bias, share = {}, {}
    for per_head in (False, True):
        got = walk(per_head)
        bias[per_head] = float(((got.double() - truth) * torch.sign(truth))[big].mean()
                               / truth.abs()[big].mean())
        share[per_head] = float(((got.bfloat16().double() - truth).abs()
                                 / (1e-4 * truth.abs().max() + ulp)).max())
    assert bias[False] < -1e-4 and abs(bias[True]) < 0.1 * abs(bias[False]), bias
    assert share[True] <= 0.5, share


@pytest.mark.parametrize("case", ["ok", "hd_stride", "odd_stride", "hd_not_8", "misaligned"])
def test_bf16_kernel_layout_rules(case):
    """The bfloat16 kernel reads q, k, v in place through TMA: unit head-dim
    stride, other strides multiples of 8 elements, 16-byte aligned data and
    a head size that is a multiple of 8; anything else raises ValueError
    (the wrapper copies nothing)."""
    x = torch.zeros((2, 16, 4, 64), dtype=torch.bfloat16)
    bad = {"ok": x, "hd_stride": torch.zeros((2, 16, 4, 128), dtype=torch.bfloat16)[..., ::2],
           "odd_stride": torch.zeros((2, 16, 5 * 64 + 4), dtype=torch.bfloat16)[
               ..., :256].reshape(2, 16, 4, 64),
           "hd_not_8": torch.zeros((2, 16, 4, 36), dtype=torch.bfloat16),
           "misaligned": torch.zeros(2 * 16 * 4 * 64 + 1, dtype=torch.bfloat16)[1:].reshape(
               2, 16, 4, 64)}[case]
    if case == "ok":
        fa.check_tma_layout("q", bad)
        fa.check_tma_layout("q", x.transpose(1, 2).contiguous().transpose(1, 2))
    else:
        with pytest.raises(ValueError):
            fa.check_tma_layout("q", bad)


@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["rep1", "rep2"])
@pytest.mark.parametrize("window", [None, 8])
def test_plain_gradients_match_jax_grad_of_blocked_attention(heads, window):
    """The training path on CPU tensors: autograd through the plain version
    against jax.grad of the model's `_blocked_attn` (float32, the causal mask
    with and without a window, GQA), within the reference's float32
    tolerance."""
    import jax

    H, KVH = heads
    B, S, hd = 2, 48, 16
    rng = np.random.default_rng(100 + H * 10 + KVH + (window or 0))
    q = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    k, v = (rng.standard_normal((B, S, KVH, hd)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    if window is None:
        mask = lambda qi, ki: ki <= qi  # noqa: E731
    else:
        mask = lambda qi, ki: (ki <= qi) & (ki > qi - window)  # noqa: E731

    def ref_loss(q, k, v):
        o = JL._blocked_attn(q.reshape(B, S, KVH, H // KVH, hd), k, v, mask, 16, None,
                             window=window)
        return jnp.sum(o * jnp.asarray(do))

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = fa.flash_attention(tq, tk, tv, causal=True, window=window)
    out.backward(torch.tensor(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)


def test_cuda_path_is_an_autograd_function():
    """On a CUDA tensor that requires a gradient the wrapper goes through
    `FlashAttention` (its forward and backward kernels); on the CPU the plain
    version, which autograd differentiates, as the test above holds."""
    assert issubclass(fa.FlashAttention, torch.autograd.Function)
    q = torch.zeros((1, 4, 2, 8), requires_grad=True)
    kv = torch.zeros((1, 4, 1, 8))
    out = fa.flash_attention(q, kv, kv)
    assert out.grad_fn is not None and fa.bwd_launches == 0


@pytest.mark.parametrize("q_pos0", [16, 32])
@pytest.mark.parametrize("window", [None, 8])
def test_plain_at_a_query_offset_matches_blocked_attention(q_pos0, window):
    """A sequence-parallel rank's queries: the slice at positions q_pos0 ..
    of a 48-token sequence against all 48 keys, forward and gradients of
    the plain version against the reference's `_blocked_attn(...,
    q_pos0=)` and `jax.grad` of it (causal, with and without a window,
    GQA), and against the same rows of the unsliced call."""
    import jax

    B, S, H, KVH, hd, n = 2, 48, 4, 2, 16, 16
    rng = np.random.default_rng(200 + q_pos0 + (window or 0))
    qf = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    q = qf[:, q_pos0:q_pos0 + n]
    k, v = (rng.standard_normal((B, S, KVH, hd)).astype(np.float32) for _ in range(2))
    do = rng.standard_normal((B, n, H, hd)).astype(np.float32)
    if window is None:
        mask = lambda qi, ki: ki <= qi  # noqa: E731
    else:
        mask = lambda qi, ki: (ki <= qi) & (ki > qi - window)  # noqa: E731

    def ref_out(q, k, v):
        return JL._blocked_attn(q.reshape(B, n, KVH, H // KVH, hd), k, v, mask, 8, None,
                                q_pos0=q_pos0, window=window)

    want = ref_out(*(jnp.asarray(a) for a in (q, k, v)))
    wgrad = jax.grad(lambda *a: jnp.sum(ref_out(*a) * jnp.asarray(do)), argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.tensor(a, requires_grad=True) for a in (q, k, v))
    out = ops.attention(tq, tk, tv, causal=True, window=window, q_pos0=q_pos0)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want), **F32_TOL)
    full = fa.flash_attention(torch.tensor(qf), torch.tensor(k), torch.tensor(v), causal=True,
                              window=window)[:, q_pos0:q_pos0 + n]
    np.testing.assert_allclose(out.detach().numpy(), full.numpy(), rtol=1e-6, atol=1e-6)
    out.backward(torch.tensor(do))
    for got, w in zip((tq.grad, tk.grad, tv.grad), wgrad):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), **F32_TOL)


def test_an_offset_call_needs_its_keys():
    """A causal call at q_pos0 needs keys up to its last query's position."""
    q, kv = torch.zeros((1, 8, 2, 16)), torch.zeros((1, 20, 2, 16))
    fa.flash_attention(q, kv, kv, q_pos0=12)
    with pytest.raises(ValueError, match="need at least 21 keys"):
        fa.flash_attention(q, kv, kv, q_pos0=13)
    with pytest.raises(ValueError, match="q_pos0"):
        fa.flash_attention(q, kv, kv, q_pos0=-1)
