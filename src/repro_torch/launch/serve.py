"""Serving launcher: prefill, then greedy batched decode — port of
`repro.launch.serve` for one device.

  python -m repro_torch.launch.serve --arch gemma3_4b --debug --device cpu
  python -m repro_torch.launch.serve --arch gemma3-4b --shape decode_4k_b4 \\
      --gen 32                                                # one H100

`--debug` runs the reduced config in float32 with 4 requests of 32-token
prompts and a 96-token cache, as the reference does.  Otherwise the config
runs at full width in bfloat16 at the `--shape`'s sizes (`sizes`): its
batch, prompts of half its length and a cache of its length; the
`decode_4k_*` shapes are the ones one card holds.  Weights are drawn from
a generator seeded 0 (there is no checkpoint), prompts from numpy's
generator seeded 0.  Runs on the CUDA device unless `--device cpu`.  `--multi-pod` needs LM sharding
(ROADMAP.md §1 item 18.7) and raises.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import device as _device
from ..configs import get_config
from ..models import model as M
from ..models.config import ModelConfig
from ..models.steps import make_prefill_step, make_serve_step, stub_inputs
from . import shapes as SH


#: `--debug`'s requests, prompt tokens and cache length (reference serve.py)
DEBUG_SIZES = (4, 32, 96)


def sizes(shape: SH.InputShape) -> tuple:
    """(requests, prompt tokens, cache length) of a serve run at `shape`."""
    return shape.global_batch, shape.seq_len // 2, shape.seq_len


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def prefill(params, cfg: ModelConfig, prompts: torch.Tensor, cache,
            extras: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """Prefill `prompts` (B, P) into `cache`: the last position's logits,
    their greedy token (int32), the cache, and the seconds it took (host
    clock, synchronised)."""
    dev = prompts.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(cfg)(params, {"tokens": prompts, **(extras or {})},
                                           cache)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    _sync(dev)
    return {"logits": logits, "token": token, "cache": cache,
            "seconds": time.perf_counter() - t0}


def decode(params, cfg: ModelConfig, token: torch.Tensor, cache, start: int, steps: int,
           extras: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """`steps` greedy decode steps from `token` (B,) at position `start`:
    the tokens (B, steps), each step's logits, the cache and the seconds of
    the loop (host clock, synchronised at its end)."""
    serve = make_serve_step(cfg, return_logits=True)
    svex = {k: v for k, v in (extras or {}).items() if k == "frames"}
    tokens, logits = [], []
    t0 = time.perf_counter()
    for t in range(steps):
        token, cache, lg = serve(params, {"tokens": token[:, None], **svex}, cache, start + t)
        tokens.append(token)
        logits.append(lg)
    _sync(token.device)
    B = token.shape[0]
    return {"tokens": torch.stack(tokens, dim=1) if tokens else token.new_empty((B, 0)),
            "logits": logits, "cache": cache, "seconds": time.perf_counter() - t0}


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, cache, gen: int,
             extras: Optional[Dict[str, torch.Tensor]] = None) -> dict:
    """Prefill `prompts` (B, P) into `cache`, then `gen` greedy decode
    steps.  Returns the prefill's last-position logits, each decode step's
    logits, the tokens (B, gen + 1: the prefill's argmax, then each step's),
    the cache, and the seconds of the prefill and of the decode loop."""
    pre = prefill(params, cfg, prompts, cache, extras)
    dec = decode(params, cfg, pre["token"], pre["cache"], prompts.shape[1], gen, extras)
    return {"prefill_logits": pre["logits"], "step_logits": dec["logits"],
            "tokens": torch.cat([pre["token"][:, None], dec["tokens"]], dim=1),
            "cache": dec["cache"], "prefill_s": pre["seconds"], "decode_s": dec["seconds"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--shape", default="decode_32k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--debug", action="store_true")
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if args.multi_pod:
        raise NotImplementedError("--multi-pod serves on a sharded mesh: ROADMAP.md §1 "
                                  "item 18.7 (LM sharding) brings it")

    if args.debug:
        cfg = get_config(args.arch).reduced()
        B, prompt, max_seq = DEBUG_SIZES
        dtype = torch.float32
    else:
        cfg = get_config(args.arch)
        B, prompt, max_seq = sizes(SH.SHAPES[args.shape])
        dtype = torch.bfloat16
    dev = _device.resolve(args.device)

    gen = torch.Generator(device=dev).manual_seed(0)
    params = M.init_params(cfg, dtype, generator=gen, device=dev)
    cache = M.init_cache(cfg, B, max_seq, dtype, device=dev)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, prompt)),
                              dtype=torch.int32, device=dev)
    extras = stub_inputs(cfg, B, dtype, device=dev)
    out = generate(params, cfg, prompts, cache, args.gen, extras)
    print(f"prefill {B}×{prompt}: {out['prefill_s']:.2f}s", flush=True)
    dt = out["decode_s"]
    print(f"decoded {args.gen} steps × {B}: {dt:.2f}s "
          f"({args.gen * B / max(dt, 1e-9):.1f} tok/s)")
    print("done")
    return out


if __name__ == "__main__":
    main()
