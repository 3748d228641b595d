"""Trace kernel 5 (the bfloat16 attention kernel) at the LM configs'
full-width shapes on one CUDA card, beside SDPA on the same inputs.

    python3 tools/attn_config_trace.py [--reps 5] [--out DIR]

Three sets of shapes, each (B, Sq, Sk, H, KVH, hd, causal), inputs drawn on
the card from seed 0 in bfloat16:

  configs — chip_smoke.py's ATTN_CONFIG_SHAPES (the configs' prefills,
            whisper's encoder, cross-attention and decode);
  hd      — one shape, (4, 2048, 2048, 16, 16, hd, causal), at hd 64, 128
            and 256: the same queries and keys at each template;
  decode  — whisper-small's cross-attention at 1, 16, 64 and 128 queries
            against 1500 keys (one 128-query block each), then 1 query
            against 375, 750, 1500 and 3000 keys.

For each shape and each route (the kernel, SDPA) it reports milliseconds a
call (CUDA events over `reps` back-to-back calls after a warm-up), the bound
chip_smoke.py computes, and, from torch.profiler's Chrome trace of `reps`
calls, each CUDA kernel's device milliseconds a call and the launch record
the trace keeps (grid, block, registers a thread, shared memory, blocks and
warps an SM, estimated achieved occupancy).  Prints the card's name and
power limit, then one JSON object; the traces go to DIR (default
chiprun_out/attn_trace).  Exits 1 without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
HD_SWEEP = tuple((4, 2048, 2048, 16, 16, hd, True) for hd in (64, 128, 256))
DECODE_SWEEP = (tuple((4, sq, 1500, 12, 12, 64, False) for sq in (1, 16, 64, 128))
                + tuple((4, 1, sk, 12, 12, 64, False) for sk in (375, 750, 1500, 3000)))
#: the trace's per-launch fields that identify a run, not the launch
_IDS = ("External id", "correlation", "device", "context", "stream", "queued",
        "Record function id", "Ev Idx")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "attn_trace"))
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("attn_config_trace: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke
    from repro_torch.kernels import flash_attention as fa

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True).stdout.strip(), flush=True)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def traced(fn, path: pathlib.Path) -> dict:
        """CUDA-event ms a call, and each kernel's device ms a call and
        launch record from the Chrome trace of `reps` calls."""
        ms = chip_smoke.cuda_ms(torch, fn, args.reps, warmup=2)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(args.reps):
                fn()
            torch.cuda.synchronize()
        prof.export_chrome_trace(str(path))
        kernels = {}
        for ev in json.loads(path.read_text())["traceEvents"]:
            if ev.get("cat") != "kernel":
                continue
            name = (ev["name"].replace("void ", "").replace("(anonymous namespace)::", "")
                    .split("(")[0])
            k = kernels.setdefault(name, {"device_ms": 0.0, "launches": 0})
            k["device_ms"] += ev["dur"] / 1e3 / args.reps
            k["launches"] += 1
            k["launch"] = {a: v for a, v in ev.get("args", {}).items() if a not in _IDS}
        return {"ms": ms, "kernels": kernels}

    out = {"reps": args.reps}
    for label, shapes in (("configs", [s[1:] for s in chip_smoke.ATTN_CONFIG_SHAPES]),
                          ("hd", HD_SWEEP), ("decode", DECODE_SWEEP)):
        rows = out[label] = []
        for i, (B, Sq, Sk, H, KVH, hd, causal) in enumerate(shapes):
            q = torch.randn(B, Sq, H, hd, device="cuda", generator=gen).bfloat16()
            k, v = (torch.randn(B, Sk, KVH, hd, device="cuda", generator=gen).bfloat16()
                    for _ in range(2))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            bound, by = chip_smoke.attention_bound_ms(q, k, causal, None)
            row = {"shape": [B, Sq, Sk, H, KVH, hd], "causal": causal, "bound_ms": bound,
                   "bound_by": by}
            if label == "configs":
                row["name"] = chip_smoke.ATTN_CONFIG_SHAPES[i][0]
            row["kernel"] = traced(lambda: fa.flash_attention(q, k, v, causal=causal),
                                   out_dir / f"{label}{i}_kernel.json")
            row["sdpa"] = traced(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), out_dir / f"{label}{i}_sdpa.json")
            rows.append(row)
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
    out["templates"] = fa.kernel_attributes()
    (out_dir / "summary.json").write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
