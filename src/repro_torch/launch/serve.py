"""Serving launcher: prefill, then greedy batched decode — port of
`repro.launch.serve` for one device.

  python -m repro_torch.launch.serve --arch gemma3_4b --debug --device cpu
  python -m repro_torch.launch.serve --arch gemma3-4b --shape decode_4k_b4 \\
      --gen 32                                                # one H100

Any of the ten configs serves (`repro_torch.configs.ARCH_IDS`).  `--debug`
runs the reduced config in float32 with 4 requests of 32-token prompts and
a 96-token cache, as the reference does.  The audio and VLM backbones get
their stub inputs as zeros (`steps.stub_inputs`): whisper's frames on every
step, qwen2-vl's prefix embeddings in the prefill, after which decode
starts at prefix + prompt.  Otherwise the config
runs at full width in bfloat16 at the `--shape`'s sizes (`sizes`): its
batch, prompts of half its length and a cache of its length; the
`decode_4k_*` shapes are the ones one card holds.  Weights are the
reference's ``init_params(PRNGKey(--seed))`` bit for bit (default 0, the
reference's key; there is no checkpoint), prompts from numpy's generator
seeded 0.  Runs on the CUDA device unless `--device cpu`.

Without `--debug`, a world of 256 ranks (512 with `--multi-pod`) serves on
the production mesh (`mesh.make_production_mesh`) with the reference's
rules (`make_rules(mesh, batch_size=B, seq_parallel=...)`): every rank
draws its parameter shards, allocates its cache shards and prefills and
decodes its rows of the batch (`repro_torch.sharding`).  A one-rank world
keeps the one-card path; `--multi-pod` in a world of any other size raises
the mesh's error, naming the world it needs.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from .. import device as _device
from ..core import prng
from ..configs import get_config
from ..models import model as M
from ..models.config import ModelConfig
from ..models.steps import make_prefill_step, make_serve_step, stub_inputs
from ..sharding.rules import axes_of, make_rules, wants_seq_parallel
from . import mesh as LM
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
            extras: Optional[Dict[str, torch.Tensor]] = None, rules=None) -> dict:
    """Prefill `prompts` (B, P) into `cache`: the last position's logits,
    their greedy token (int32), the cache, and the seconds it took (host
    clock, synchronised).  With `rules`, this rank's rows and shards; the
    logits are gathered over the vocabulary."""
    dev = prompts.device
    _sync(dev)
    t0 = time.perf_counter()
    logits, cache = make_prefill_step(cfg, rules)(params, {"tokens": prompts, **(extras or {})},
                                                  cache)
    logits = M.gather_logits(logits, cfg, rules)
    token = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
    _sync(dev)
    return {"logits": logits, "token": token, "cache": cache,
            "seconds": time.perf_counter() - t0}


def decode(params, cfg: ModelConfig, token: torch.Tensor, cache, start: int, steps: int,
           extras: Optional[Dict[str, torch.Tensor]] = None, rules=None) -> dict:
    """`steps` greedy decode steps from `token` (B,) at position `start`:
    the tokens (B, steps), each step's logits, the cache and the seconds of
    the loop (host clock, synchronised at its end).  Of `extras`, only the
    encoder's frames reach the steps (prefix embeddings are the prefill's)."""
    serve = make_serve_step(cfg, rules, return_logits=True)
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


def decode_start(prompts: torch.Tensor,
                 extras: Optional[Dict[str, torch.Tensor]] = None) -> int:
    """The position of the first decode step: the prefix embeddings' length
    (when given) plus the prompt's."""
    prefix = (extras or {}).get("prefix_embeds")
    return prompts.shape[1] + (prefix.shape[1] if prefix is not None else 0)


def generate(params, cfg: ModelConfig, prompts: torch.Tensor, cache, gen: int,
             extras: Optional[Dict[str, torch.Tensor]] = None, rules=None) -> dict:
    """Prefill `prompts` (B, P) into `cache`, then `gen` greedy decode
    steps.  Returns the prefill's last-position logits, each decode step's
    logits, the tokens (B, gen + 1: the prefill's argmax, then each step's),
    the cache, and the seconds of the prefill and of the decode loop.

    Decode starts at the first free cache slot, `decode_start`: after the
    prefix embeddings and the prompt.  (The reference's launcher decodes at
    ``prompt + t``, which overwrites the prompt's last cached positions when
    there is a prefix; ROADMAP.md §3.)"""
    pre = prefill(params, cfg, prompts, cache, extras, rules)
    dec = decode(params, cfg, pre["token"], pre["cache"], decode_start(prompts, extras), gen,
                 extras, rules)
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
    ap.add_argument("--seed", type=int, default=0, help="the weights' PRNGKey seed")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.debug:
        cfg = get_config(args.arch).reduced()
        B, prompt, max_seq = DEBUG_SIZES
        dtype = torch.float32
    else:
        cfg = get_config(args.arch)
        B, prompt, max_seq = sizes(SH.SHAPES[args.shape])
        dtype = torch.bfloat16
    dev = _device.resolve(args.device)
    rules = production_rules(args, cfg, B, dev)
    rows = batch_rows(rules, B)

    t0 = time.perf_counter()
    params = M.init_params(prng.PRNGKey(args.seed), cfg, dtype, device=dev, rules=rules)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    print(f"init: {init_s:.2f}s", flush=True)
    cache = M.init_cache(cfg, B, max_seq, dtype, device=dev, rules=rules)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, prompt))[rows],
                              dtype=torch.int32, device=dev)
    extras = stub_inputs(cfg, rows.stop - rows.start, dtype, device=dev)
    out = {**generate(params, cfg, prompts, cache, args.gen, extras, rules), "init_s": init_s}
    print(f"prefill {B}×{prompt}: {out['prefill_s']:.2f}s", flush=True)
    dt = out["decode_s"]
    print(f"decoded {args.gen} steps × {B}: {dt:.2f}s "
          f"({args.gen * B / max(dt, 1e-9):.1f} tok/s)")
    print("done")
    return out


def production_rules(args, cfg: ModelConfig, B: int, dev: torch.device):
    """The production mesh's rules for a world of 256 ranks (512 with
    ``--multi-pod``) without ``--debug`` (the reference's launchers), None
    for a one-rank world; ``--multi-pod`` elsewhere raises the mesh's error."""
    LM.init_from_env(dev)
    if not (args.multi_pod or (not args.debug and LM.world()[1] > 1)):
        return None
    mesh = LM.make_production_mesh(multi_pod=args.multi_pod, device=dev)
    return make_rules(mesh, batch_size=B, seq_parallel=wants_seq_parallel(cfg, mesh)).bind(cfg)


def batch_rows(rules, B: int) -> slice:
    """This rank's rows of a global batch of B (all of them without rules)."""
    if rules is None:
        return slice(0, B)
    axes = axes_of(rules.amap["batch"])
    n = B // rules.mesh.size(axes)
    return slice(rules.mesh.index(axes) * n, (rules.mesh.index(axes) + 1) * n)


if __name__ == "__main__":
    main()
