"""The bfloat16 attention backward (kernel 5b) against its float64 truth on
one CUDA card, for the PyTorch port under a given source tree: how far dq,
dk and dv lean toward zero, and what share of chip_smoke.py's backward
gate each takes.

    python3 tools/attn_bwd_bias.py [--src DIR] [--seed 25]

DIR defaults to this checkout's ``src/``; point it at another checkout's
``src/`` (its kernels are built into that checkout) to compare two trees.
Shapes (B 1, 4096 tokens, causal, bf16): granite-20b's 48 query heads on
one KV head at hd 128, the same at 1024 tokens, 8 query heads on one KV
head, and jamba-1.5-large's 64 on 8; inputs standard normal draws on the
card.  The truth is autograd through `flash_attention_plain` in float64,
eight query heads at a time.  Prints the card's name and power limit, then
one JSON object a shape: for each output its largest |Δ| over max|f64|,
its bias (the mean of (got − f64)·sign(f64) over the elements above a
tenth of max|f64|, over their mean |f64|: negative when the kernel's
values shrink) and its gate share (|Δ| over one bf16 ulp of the f64 value
+ 1e-4·max|f64|, elementwise; above 1 leaves the gate).  Exits 1 without a
card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: (S, H, KVH, hd)
SHAPES = ((4096, 48, 1, 128), (1024, 48, 1, 128), (4096, 8, 1, 128), (4096, 64, 8, 128))
#: query heads a float64 truth takes at a time
TRUTH_HEADS = 8


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"))
    ap.add_argument("--seed", type=int, default=25)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("attn_bwd_bias: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.kernels import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)

    def draw(*shape):
        return torch.randn(*shape, device="cuda", generator=gen).bfloat16()

    def truth(q, k, v, do):
        H, KVH = q.shape[2], k.shape[2]
        rep = H // KVH
        r = min(rep, TRUTH_HEADS)
        out = {n: torch.zeros(x.shape, dtype=torch.float64, device="cuda")
               for n, x in (("dq", q), ("dk", k), ("dv", v))}
        for h in range(KVH):
            for r0 in range(0, rep, r):
                qs = slice(h * rep + r0, h * rep + r0 + r)
                ins = [q[:, :, qs].double().requires_grad_(True),
                       k[:, :, h:h + 1].double().requires_grad_(True),
                       v[:, :, h:h + 1].double().requires_grad_(True)]
                d = torch.autograd.grad(fa.flash_attention_plain(*ins, causal=True), ins,
                                        do[:, :, qs].double())
                out["dq"][:, :, qs] = d[0]
                out["dk"][:, :, h:h + 1] += d[1]
                out["dv"][:, :, h:h + 1] += d[2]
        return out

    for S, H, KVH, hd in SHAPES:
        q, do = draw(1, S, H, hd), draw(1, S, H, hd)
        k, v = draw(1, S, KVH, hd), draw(1, S, KVH, hd)
        got = dict(zip(("dq", "dk", "dv"), fa._kernel_bwd(q, k, v, do, True, None)))
        want = truth(q, k, v, do)
        rec = {"src": args.src, "shape": [1, S, S, H, KVH, hd], "causal": True}
        for name, w in want.items():
            d = got[name].double() - w
            scale = float(w.abs().max())
            big = w.abs() > 0.1 * scale
            ulp = torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w), torch.frexp(w)[1] - 8))
            rec[name] = {"rel": float(d.abs().max()) / scale,
                         "bias": float((d * torch.sign(w))[big].mean() / w.abs()[big].mean()),
                         "gate_share": float((d.abs() / (1e-4 * scale + ulp)).max())}
        print(json.dumps(rec), flush=True)
        del q, k, v, do, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
