"""Time the exact Top-K wrappers of the PyTorch port with their ctypes
prototypes bound once (as they are) and set again on every call (as they
were before `kernels._build.bind`), at the BL-DNN leaf shapes, on one CUDA
card.

    python3 tools/topk_prototype_ab.py

Prints the card's name and power limit, then one JSON object: for each
wrapper and shape the CUDA-event milliseconds a call in the order bound,
set, set, bound (`cuda_ms` of chip_smoke.py: back-to-back calls, so what
the host spends a call shows).  Exits 1 without a card.
"""
from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: BL-DNN's leaves as the Top-K wrappers see them: (clients, numel, k)
SHAPES = ((8, 3072, 307), (8, 2048, 204), (8, 128, 12))
ITERS = 200


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("topk_prototype_ab: no CUDA device is available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    from chip_smoke import cuda_ms
    from repro_torch.kernels import _build
    from repro_torch.kernels import topk_threshold as tk

    _build.build_all(["topk_threshold", "topk_compress_sum"])
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         check=True, capture_output=True, text=True, timeout=60).stdout.strip())

    def set_prototype(lib: str, fn: str, argtypes: tuple) -> None:
        f = getattr(_build.load(lib), fn)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int

    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for n, T, k in SHAPES:
        v = torch.randn((n, T), device="cuda", generator=gen)
        a = v.abs()
        calls = {
            "topk_row_threshold": (
                lambda: tk.topk_row_threshold(a, k),
                ("topk_threshold", "topk_row_threshold_f32", tk._THRESHOLD_ARGS)),
            "topk_compress_sum": (
                lambda: tk.topk_compress_sum(v, k),
                ("topk_compress_sum", "topk_compress_sum_f32", tk._COMPRESS_SUM_ARGS))}
        for name, (call, proto) in calls.items():
            def per_call(call=call, proto=proto):
                set_prototype(*proto)
                return call()

            order = (("bound", call), ("set", per_call), ("set", per_call), ("bound", call))
            times = {"bound": [], "set": []}
            for form, fn in order:
                times[form].append(cuda_ms(torch, fn, ITERS))
            out[f"{name} {n}x{T}"] = times
    print(json.dumps({"kernel_ms": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
