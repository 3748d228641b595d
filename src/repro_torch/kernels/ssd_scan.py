"""Mamba2 SSD chunked scan with its final state: the CUDA kernel and its
plain version.

Port of `repro.kernels.ssd_scan` in the model's layout, the function of
`repro.models.layers._ssd_chunked`: for x (B, S, H, hd), dt (B, S, H),
A (H,) < 0 and B, C (B, S, N) shared by every head, all float32,

    y_t = Σ_{k ≤ t} exp(cs_t − cs_k) (C_t·B_k) dt_k x_k,   cs = cumsum(dt·A),

returned with the state after the last position, (B, H, hd, N), which the
decode cache carries on.

`ssd_scan` launches the hand-written kernel (``csrc/ssd_scan.cu``) on CUDA
tensors, reading its inputs in place through their strides, and takes the
plain PyTorch version, `ssd_scan_plain`, only for tensors on the CPU.  The
plain version transcribes `_ssd_chunked` with chunks of `chunk` positions
(shrunk to a divisor of S, as the reference's `ssd_scan` wrapper does); the
kernel walks chunks of `KERNEL_CHUNK` positions whatever `chunk` says.  The
chunk length changes only the rounding.

The kernel is chunk-parallel: one call makes four CUDA launches (the
chunks' decays and C·Bᵀ shared by the heads, the chunk states, the state
pass over the chunks in order, the outputs; counted in `cuda_launches`)
through a float32 workspace that the wrapper allocates at the size the
library gives (`ssd_scan_workspace_floats`), with every product on the
tensor cores as three TF32 products of split operands.  `ssd_scan_emulated`
is the kernel's arithmetic in PyTorch, at any chunk length, for accuracy
studies; no path runs it.

Gradients: when grad mode is on and an input requires one, a CUDA call goes
through `SSDScan`, an autograd Function that keeps the forward's workspace
(its chunk-entry states, decays and C·Bᵀ) for the hand-written backward
(``csrc/ssd_scan_bwd.cu``: dx, ddt, dA, dB and dC in float32, five CUDA
launches, deterministic); the reference differentiates `_ssd_chunked` with
jax.grad.  The backward sums its cumulative decays again in double and runs
every product on the tensor cores as the forward does (three TF32 products
of split operands, operands staged whole by cp.async);
`ssd_scan_bwd_emulated` is its arithmetic in PyTorch, for accuracy studies.
A CPU call takes `ssd_scan_plain`, which autograd differentiates.

Fake tensors (the dry run, `repro_torch.launch.dryrun`), CUDA or CPU,
take the CUDA path with the kernels' fake-tensor routes (`_fake`) where it
launches: the
same outputs and workspaces (the forward's kept for the backward), the
plain version's flop count at `chunk`, no launch and no count.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build, _fake

#: calls of the CUDA kernel since the last reset, one a call whatever its
#: CUDA launches (the plain version on CPU tensors does not count)
launches = 0
#: CUDA launches those calls made, as the library reports them
cuda_launches = 0
#: calls of the CUDA backward since the last reset, one a call, and the CUDA
#: launches they made (five a call)
bwd_launches = 0
bwd_cuda_launches = 0

#: positions of the kernel's chunks, and the largest head size and state
#: size (each padded to a multiple of 32) it takes
KERNEL_CHUNK, MAX_PADDED = 128, 128
_MAX_BATCH = 65535
_NEG = -1e30
#: the C entries' prototypes: the workspace sizes (B, S, H, hd, N); the
#: forward (x, dt, A, B, C, y, state, workspace; sizes; strides, stream,
#: launches made); the backward (x, dt, A, B, C, dy, dstate, the forward's
#: workspace, its own, dx, ddt, dA, dB, dC; sizes; strides, stream, launches)
_SIZES = (ctypes.c_int,) * 5
_FWD_ARGS = ((ctypes.c_void_p,) * 8 + _SIZES + (ctypes.c_void_p,) * 2
             + (ctypes.POINTER(ctypes.c_int),))
_BWD_ARGS = ((ctypes.c_void_p,) * 14 + _SIZES + (ctypes.c_void_p,) * 2
             + (ctypes.POINTER(ctypes.c_int),))


def _check(x, dt, A, B, C, plain: bool = False) -> None:
    """Raise for what neither version takes; `plain` also admits float64
    operands, all of that type (the plain version's float64 runs are the
    backward's yardstick)."""
    want = x.dtype if plain and x.dtype == torch.float64 else torch.float32
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.dtype != want:
            raise TypeError(f"ssd_scan is float32-only; {name} is {t.dtype}")
    if x.dim() != 4:
        raise ValueError(f"x must be (batch, seq, heads, head_dim), got {tuple(x.shape)}")
    Bsz, S, H, _ = x.shape
    if dt.shape != (Bsz, S, H) or A.shape != (H,) or B.dim() != 3 \
            or B.shape[:2] != (Bsz, S) or C.shape != B.shape:
        raise ValueError(f"shapes do not match: x {tuple(x.shape)}, dt {tuple(dt.shape)}, "
                         f"A {tuple(A.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}")
    devices = {t.device for t in (x, dt, A, B, C)}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan operands lie on different devices {devices}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cuda or cpu, got {x.device}")


def plain_chunk(S: int, chunk: int) -> int:
    """The plain version's chunk: the largest divisor of S at most
    ``min(chunk, S)``."""
    c = max(1, min(chunk, S))
    while S % c:
        c -= 1
    return c


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, *, chunk: int = 256) -> tuple:
    """`_ssd_chunked` in PyTorch: returns (y (B, S, H, hd), final state
    (B, H, hd, N)), in float32 (or float64 for float64 operands)."""
    _check(x, dt, A, B, C, plain=True)
    Bsz, S, H, hd = x.shape
    N = B.shape[-1]
    c = plain_chunk(S, chunk)
    n = S // c
    xh = x.reshape(Bsz, n, c, H, hd)
    dtc = dt.reshape(Bsz, n, c, H)
    Bc = B.reshape(Bsz, n, c, N)
    Cc = C.reshape(Bsz, n, c, N)

    cs = torch.cumsum(dtc * A, dim=2)                       # (B, n, c, H)
    seg = cs[:, :, :, None, :] - cs[:, :, None, :, :]       # (B, n, q, k, H)
    causal = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()
    # mask before exp, as the reference does
    L = torch.exp(torch.where(causal[None, None, :, :, None], seg, _NEG))
    CB = torch.einsum("bnqs,bnks->bnqk", Cc, Bc)
    M = CB[..., None] * L * dtc[:, :, None, :, :]
    y_intra = torch.einsum("bnqkh,bnkhd->bnqhd", M, xh)

    w = torch.exp(cs[:, :, -1:, :] - cs) * dtc              # (B, n, c, H)
    states = torch.einsum("bnkhd,bnks->bnhds", xh * w[..., None], Bc)
    chunk_decay = torch.exp(cs[:, :, -1, :])                # (B, n, H)
    s = torch.zeros((Bsz, H, hd, N), dtype=x.dtype, device=x.device)
    s_in = []
    for i in range(n):
        s_in.append(s)
        s = s * chunk_decay[:, i, :, None, None] + states[:, i]
    s_in = torch.stack(s_in, dim=1)                         # (B, n, H, hd, N)
    y_inter = torch.einsum("bnqs,bnhds->bnqhd", Cc, s_in) * torch.exp(cs)[..., None]
    return (y_intra + y_inter).reshape(Bsz, S, H, hd), s


def _tf32(a: torch.Tensor) -> torch.Tensor:
    """`a` truncated to TF32 (its top 19 bits), as the kernel's split takes
    the high part and as the tensor core reads an operand."""
    return (a.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def _product(a: torch.Tensor, b: torch.Tensor, products: str) -> torch.Tensor:
    """a @ b with float32 sums as the kernel's tensor cores take it: three
    TF32 products of split operands (a = hi + lo, lo = a − hi; "split"), or
    one of the truncated operands ("single"); "exact" is the full float32
    product (TF32 off), to separate the split's error from the rest.
    Products of TF32 values are exact in float32."""
    if products == "exact":
        return a @ b
    ah, bh = _tf32(a), _tf32(b)
    if products == "single":
        return ah @ bh
    return _tf32(a - ah) @ bh + ah @ _tf32(b - bh) + ah @ bh


def _emulated_workspace(x, dt, A, B, C, chunk: int, products: str) -> dict:
    """The forward kernel's arithmetic up to its workspace: the inputs in
    chunks of `chunk` positions (zero past S), the in-order float32
    cumulative decays and their ends at each chunk's last real position, C·Bᵀ
    once for the heads, the chunk states xᵀ·(w∘B) with w = exp(cs_end −
    cs)·dt, and the state pass s ← s·exp(cs_end) + state, in order: the
    chunk-entry states and the final state."""
    Bsz, S, H, hd = x.shape
    N = B.shape[-1]
    L = chunk
    nc = -(-S // L)
    dev = x.device

    def pad(t):
        return torch.cat([t, t.new_zeros((Bsz, nc * L - S) + t.shape[2:])], dim=1)

    xc = pad(x).reshape(Bsz, nc, L, H, hd)
    dtc = pad(dt).reshape(Bsz, nc, L, H)
    Bc, Cc = pad(B).reshape(Bsz, nc, L, N), pad(C).reshape(Bsz, nc, L, N)
    cs = torch.empty_like(dtc)
    run = torch.zeros((Bsz, nc, H), device=dev)
    for t in range(L):
        run = run + dtc[:, :, t] * A
        cs[:, :, t] = run
    last = torch.tensor([min(L, S - c * L) - 1 for c in range(nc)], device=dev)
    cs_end = cs[:, torch.arange(nc, device=dev), last]               # (B, nc, H)
    CB = _product(Cc, Bc.transpose(-1, -2), products)                # (B, nc, q, k)
    w = (torch.exp(cs_end[:, :, None] - cs) * dtc).permute(0, 1, 3, 2)
    wB = w[..., None] * Bc[:, :, None]                               # (B, nc, H, L, N)
    states = _product(xc.permute(0, 1, 3, 4, 2), wB, products)       # (B, nc, H, hd, N)
    s = torch.zeros((Bsz, H, hd, N), device=dev)
    s_in = []
    for c in range(nc):
        s_in.append(s)
        s = s * torch.exp(cs_end[:, c])[:, :, None, None] + states[:, c]
    return dict(pad=pad, xc=xc, dtc=dtc, Bc=Bc, Cc=Cc, cs=cs, last=last, CB=CB,
                s_in=torch.stack(s_in, dim=1), state=s)


def ssd_scan_emulated(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, *, chunk: int = KERNEL_CHUNK,
                      products: str = "split") -> tuple:
    """What the chunk-parallel kernel computes, in PyTorch on any device:
    its workspace (`_emulated_workspace`), then y = exp(cs_q) C_q·s_in + M·x
    with M masked before its exponential; every product as `_product`
    takes it.  Returns (y, final state)."""
    _check(x, dt, A, B, C)
    Bsz, S, H, hd = x.shape
    L = chunk
    w = _emulated_workspace(x, dt, A, B, C, chunk, products)
    cs, dtc, Cc = w["cs"], w["dtc"], w["Cc"]
    nc = cs.shape[1]
    y = _product(Cc[:, :, None], w["s_in"].transpose(-1, -2), products)   # (B, nc, H, q, hd)
    y = y * torch.exp(cs).permute(0, 1, 3, 2)[..., None]
    causal = torch.ones((L, L), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    seg = torch.where(causal, cs[:, :, :, None, :] - cs[:, :, None, :, :], _NEG)
    M = torch.where(causal, w["CB"][..., None] * torch.exp(seg) * dtc[:, :, None], 0.0)
    y = y + _product(M.permute(0, 1, 4, 2, 3), w["xc"].permute(0, 1, 3, 2, 4), products)
    return y.permute(0, 1, 3, 2, 4).reshape(Bsz, nc * L, H, hd)[:, :S], w["state"]


def ssd_scan_bwd_emulated(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                          C: torch.Tensor, dy: torch.Tensor, dstate=None, *,
                          chunk: int = KERNEL_CHUNK, products: str = "split") -> tuple:
    """What the backward kernel computes (``csrc/ssd_scan_bwd.cu``), in
    PyTorch on any device, from the forward kernel's workspace as
    `_emulated_workspace` gives it: the cumulative decays summed again in
    double and every decay difference taken in double, rounded once; the
    state gradients R_c by the reverse pass; per head and chunk G = dy·uᵀ
    (u = dt·x), the strict row and column sums of L∘(C·Bᵀ)∘G for dcs, the
    read-out term C·S_inᵀ, du = exp(cs_end − cs_k)·B·Rᵀ + Pᵀ·dy with P =
    L∘(C·Bᵀ), dx = dt·du, and ddt and dA's shares from the reverse cumsum of
    dcs in double; per chunk dC = M·B + Σ_h exp(cs_q)·dy·S_in and dB = Mᵀ·C
    + Σ_h exp(cs_end − cs_k)·u·R with M = Σ_h L∘G; dA summed in double.
    Every product as `_product` takes it ("split": three TF32 products of
    split operands, as the kernel's mma.sync; "single"; "exact").  Returns
    (dx, ddt, dA, dB, dC), float32."""
    _check(x, dt, A, B, C)
    Bsz, S, H, hd = x.shape
    N = B.shape[-1]
    L = chunk
    dev = x.device
    w = _emulated_workspace(x, dt, A, B, C, chunk, products)
    xc, dtc, Bc, Cc, CB, s_in, last = (w[k] for k in ("xc", "dtc", "Bc", "Cc", "CB", "s_in",
                                                         "last"))
    nc = xc.shape[1]
    dyc = w["pad"](dy).reshape(Bsz, nc, L, H, hd).permute(0, 1, 3, 2, 4)   # (B, nc, H, L, hd)
    real = (last + 1)[:, None]                                             # (nc, 1)
    live = (torch.arange(L, device=dev)[None, :] < real).float()           # (nc, L)

    # launch 1: cs in double, exp(cs_q) and exp(cs_end − cs_k), Σ_q exp(cs_q) dy_q ⊗ C_q
    csd = torch.cumsum(dtc.double() * A.double(), dim=2).permute(0, 1, 3, 2)   # (B, nc, H, L)
    cs_end = csd.gather(3, last.view(1, nc, 1, 1).expand(Bsz, nc, H, 1))      # (B, nc, H, 1)
    ex = torch.exp(csd.float())
    e_end = torch.exp((cs_end - csd).float())
    dec = torch.exp(cs_end[..., 0].float())                                   # (B, nc, H)
    E = _product((ex[..., None] * dyc).transpose(-1, -2), Cc[:, :, None], products)
    # launch 2: R_c, the gradient of the state after chunk c, in reverse order
    s = dstate if dstate is not None else torch.zeros((Bsz, H, hd, N), device=dev)
    R = [None] * nc
    for c in range(nc - 1, -1, -1):
        R[c] = s
        s = s * dec[:, c, :, None, None] + E[:, c]
    R = torch.stack(R, dim=1)                                                 # (B, nc, H, hd, N)

    # launch 3, per head: dcs, du, dx, ddt, dA's shares
    u = (dtc[..., None] * xc).permute(0, 1, 3, 2, 4)                          # (B, nc, H, L, hd)
    G = _product(dyc, u.transpose(-1, -2), products)                          # (B, nc, H, q, k)
    Lm = torch.exp((csd[..., :, None] - csd[..., None, :]).float())
    tri = torch.ones((L, L), dtype=torch.bool, device=dev)
    Z = torch.where(tri.tril(-1), Lm * CB[:, :, None] * G, 0.0)
    P = torch.where(tri.tril(), Lm * CB[:, :, None], 0.0)
    Y = _product(Cc[:, :, None], s_in.transpose(-1, -2), products)          # (B, nc, H, q, hd)
    dcs = Z.sum(-1) + ex * (dyc * Y).sum(-1)
    du = _product(Bc[:, :, None], R.transpose(-1, -2), products) * e_end[..., None]
    wS = (u * du).sum(-1) * live[:, None]
    du = du + _product(P.transpose(-1, -2), dyc, products)
    dx = dtc.permute(0, 1, 3, 2)[..., None] * du
    xdu = (xc.permute(0, 1, 3, 2, 4) * du).sum(-1)
    dcs_end = dec * (R * s_in).sum((-1, -2)) + wS.sum(-1)
    at_end = (torch.arange(L, device=dev)[None, :] == last[:, None])[:, None]  # (nc, 1, L)
    dcs = (dcs - wS - Z.sum(-2) + torch.where(at_end, dcs_end[..., None], 0.0)) * live[:, None]
    run = torch.flip(torch.cumsum(torch.flip(dcs.double(), [-1]), -1), [-1])
    ddt = A[:, None] * run.float() + xdu                                      # (B, nc, H, L)
    dA = (dtc.permute(0, 1, 3, 2).double() * run).sum((0, 1, 3)).float()

    # launch 4, per chunk: dC and dB, summed over the heads
    M = torch.where(tri.tril(), Lm * G, 0.0).sum(2)                           # (B, nc, q, k)
    dC = _product(M, Bc, products) + _product(ex[..., None] * dyc, s_in, products).sum(2)
    dB = (_product(M.transpose(-1, -2), Cc, products)
          + _product(e_end[..., None] * u, R, products).sum(2))

    def unpad(t):                                                             # (B, nc, L, ...)
        return t.reshape((Bsz, nc * L) + t.shape[3:])[:, :S]

    return (unpad(dx.permute(0, 1, 3, 2, 4)), unpad(ddt.permute(0, 1, 3, 2)), dA, unpad(dB),
            unpad(dC))


def _strides(x, dt, B, C):
    return (ctypes.c_longlong * 13)(*x.stride(), *dt.stride(), *B.stride(), *C.stride())


def _kernel(x, dt, A, B, C, chunk: int = 256) -> tuple:
    """(y, final state, the workspace the call filled); `chunk` is the
    plain version's, for the fake-tensor route's flop count."""
    global launches, cuda_launches
    Bsz, S, H, hd = x.shape
    N = B.shape[-1]
    if max(-(-hd // 32), -(-N // 32)) * 32 > MAX_PADDED or max(Bsz, H) > _MAX_BATCH:
        raise ValueError(
            f"the SSD kernel takes head_dim and d_state up to {MAX_PADDED} (batch and heads "
            f"up to {_MAX_BATCH}); got head_dim={hd}, d_state={N}, batch={Bsz}, heads={H}")
    if _fake.is_fake(x):
        return _fake.ops().ssd_scan(x, dt, A, B, C, chunk)
    y = torch.empty((Bsz, S, H, hd), dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, hd, N), dtype=torch.float32, device=x.device)
    ws_fn = _build.bind("ssd_scan", "ssd_scan_workspace_floats", _SIZES, ctypes.c_longlong)
    ws = torch.empty(ws_fn(Bsz, S, H, hd, N), dtype=torch.float32, device=x.device)
    A = A.contiguous()
    fn = _build.bind("ssd_scan", "ssd_scan_f32", _FWD_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    made = ctypes.c_int(0)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
             y.data_ptr(), state.data_ptr(), ws.data_ptr(), Bsz, S, H, hd, N,
             ctypes.cast(_strides(x, dt, B, C), ctypes.c_void_p), stream, ctypes.byref(made))
    cuda_launches += made.value
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state, ws


def _kernel_bwd(x, dt, A, B, C, dy, dstate, fws, chunk: int = 256) -> tuple:
    """(dx, ddt, dA, dB, dC) through the backward kernel, from the forward's
    workspace `fws` on the same inputs; `dstate` may be None (zero)."""
    global bwd_launches, bwd_cuda_launches
    Bsz, S, H, hd = x.shape
    N = B.shape[-1]
    if _fake.is_fake(x):
        dstate = dstate.contiguous() if dstate is not None else None
        return _fake.ops().ssd_scan_bwd(x, dt, A, B, C, dy.contiguous(), dstate, fws,
                                        chunk)[:5]
    fwd_floats = _build.bind("ssd_scan_bwd", "ssd_scan_bwd_forward_workspace_floats", _SIZES,
                             ctypes.c_longlong)(Bsz, S, H, hd, N)
    if fwd_floats != fws.numel():
        raise RuntimeError(f"ssd_scan backward reads a forward workspace of {fwd_floats} "
                           f"floats; the forward left {fws.numel()}")
    ws_floats = _build.bind("ssd_scan_bwd", "ssd_scan_bwd_workspace_floats", _SIZES,
                            ctypes.c_longlong)(Bsz, S, H, hd, N)
    f32 = dict(dtype=torch.float32, device=x.device)
    dx = torch.empty((Bsz, S, H, hd), **f32)
    ddt = torch.empty((Bsz, S, H), **f32)
    dA = torch.zeros((H,), **f32)
    dB = torch.empty((Bsz, S, N), **f32)
    dC = torch.empty((Bsz, S, N), **f32)
    ws = torch.empty(ws_floats, **f32)
    dy = dy.contiguous()
    dstate = dstate.contiguous() if dstate is not None else None
    A = A.contiguous()
    fn = _build.bind("ssd_scan_bwd", "ssd_scan_bwd_f32", _BWD_ARGS)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    made = ctypes.c_int(0)
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
             dy.data_ptr(), None if dstate is None else dstate.data_ptr(), fws.data_ptr(),
             ws.data_ptr(), dx.data_ptr(), ddt.data_ptr(), dA.data_ptr(), dB.data_ptr(),
             dC.data_ptr(), Bsz, S, H, hd, N, ctypes.cast(_strides(x, dt, B, C), ctypes.c_void_p),
             stream, ctypes.byref(made))
    bwd_cuda_launches += made.value
    if err != 0:
        raise RuntimeError(f"ssd_scan backward launch failed: CUDA error {err}")
    bwd_launches += 1
    return dx, ddt, dA, dB, dC


def backward_attributes() -> dict:
    """Registers a thread and local (spill) bytes a thread of the backward's
    launches that stage products (``e``, ``head``, ``bc``; ``head`` at
    hd ≤ 64, the train path's template)."""
    fn = _build.bind("ssd_scan_bwd", "ssd_scan_bwd_attributes", (ctypes.c_void_p,))
    vals = (ctypes.c_int * 6)()
    err = fn(ctypes.cast(vals, ctypes.c_void_p))
    if err != 0:
        raise RuntimeError(f"cudaFuncGetAttributes failed: CUDA error {err}")
    return {name: {"num_regs": vals[2 * i], "local_bytes": vals[2 * i + 1]}
            for i, name in enumerate(("e", "head", "bc"))}


class SSDScan(torch.autograd.Function):
    """Kernel 6 forward and its backward kernel, for CUDA tensors."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk: int):
        y, state, ws = _kernel(x, dt, A, B, C, chunk)
        ctx.save_for_backward(x, dt, A, B, C, ws)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, dstate):
        x, dt, A, B, C, ws = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        return (*_kernel_bwd(x, dt, A, B, C, dy, dstate, ws, ctx.chunk), None)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int = 256) -> tuple:
    """The SSD over every position, (y (B, S, H, hd), final state
    (B, H, hd, N)).  CUDA tensors go through `SSDScan` (the forward kernel;
    its backward kernel when a gradient is taken), CPU tensors through
    `ssd_scan_plain` with chunks of `chunk` positions, fake tensors of
    either device through `SSDScan` to the kernels' fake-tensor routes.  `chunk` is the
    plain version's rounding choice only: the kernel walks its own
    `KERNEL_CHUNK`-position chunks whatever it says."""
    _check(x, dt, A, B, C)
    if x.device.type == "cpu" and not _fake.is_fake(x):
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    return SSDScan.apply(x, dt, A, B, C, chunk)
