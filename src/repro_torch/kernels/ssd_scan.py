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
kernel walks chunks of 64 positions whatever `chunk` says.  The chunk
length changes only the rounding.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

#: launches of the CUDA kernel since the last reset (the plain version on
#: CPU tensors does not count)
launches = 0

#: the most dynamic shared memory one block may use on an H100
_SMEM_MAX = 227 * 1024
_MAX_BATCH = 65535
_NEG = -1e30


def _check(x, dt, A, B, C) -> None:
    for name, t in (("x", x), ("dt", dt), ("A", A), ("B", B), ("C", C)):
        if t.dtype != torch.float32:
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


def ssd_scan_plain(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
                   C: torch.Tensor, *, chunk: int = 256) -> tuple:
    """`_ssd_chunked` in PyTorch: returns (y (B, S, H, hd), final state
    (B, H, hd, N))."""
    _check(x, dt, A, B, C)
    Bsz, S, H, hd = x.shape
    N = B.shape[-1]
    c = max(1, min(chunk, S))
    while S % c:
        c -= 1
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


def _kernel(x, dt, A, B, C) -> tuple:
    global launches
    lib = _build.load("ssd_scan")
    Bsz, S, H, hd = x.shape
    N = B.shape[-1]
    smem_fn = lib.ssd_scan_smem_bytes
    smem_fn.argtypes = [ctypes.c_int, ctypes.c_int]
    smem_fn.restype = ctypes.c_longlong
    smem = smem_fn(hd, N)
    if smem > _SMEM_MAX or Bsz > _MAX_BATCH:
        raise ValueError(
            f"the SSD kernel keeps a chunk and the (head_dim, d_state) state of one head "
            f"in shared memory: head_dim={hd}, d_state={N} need {smem} bytes of the "
            f"{_SMEM_MAX} an H100 block may use (and batch <= {_MAX_BATCH}, got {Bsz})")
    y = torch.empty((Bsz, S, H, hd), dtype=torch.float32, device=x.device)
    state = torch.empty((Bsz, H, hd, N), dtype=torch.float32, device=x.device)
    A = A.contiguous()
    fn = lib.ssd_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 2
    fn.restype = ctypes.c_int
    strides = (ctypes.c_longlong * 13)(*x.stride(), *dt.stride(), *B.stride(), *C.stride())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(), C.data_ptr(),
             y.data_ptr(), state.data_ptr(), Bsz, S, H, hd, N,
             ctypes.cast(strides, ctypes.c_void_p), stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed: CUDA error {err}")
    launches += 1
    return y, state


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B: torch.Tensor,
             C: torch.Tensor, *, chunk: int = 256) -> tuple:
    """The SSD over every position, (y (B, S, H, hd), final state
    (B, H, hd, N)).  Launches the CUDA kernel on CUDA tensors; CPU tensors
    take `ssd_scan_plain` with chunks of `chunk` positions.  `chunk` is the
    plain version's rounding choice only: the kernel walks its own
    64-position chunks whatever it says."""
    _check(x, dt, A, B, C)
    if x.device.type == "cpu":
        return ssd_scan_plain(x, dt, A, B, C, chunk=chunk)
    return _kernel(x, dt, A, B, C)
