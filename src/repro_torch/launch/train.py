"""Training launcher — port of `repro.launch.train` for one device.

  python -m repro_torch.launch.train --arch gemma3-4b --debug --device cpu
  python -m repro_torch.launch.train --arch gemma3-4b --shape train_4k_b1 \\
      --steps 4                                               # one H100

`--debug` runs the reduced config in float32 (parameters and AdamW state)
without rematerialisation, 4 sequences of 64 tokens, as the reference
does.  Otherwise the config runs at full width in bfloat16 with bfloat16
AdamW moments and each layer group rematerialised, at the `--shape`'s batch
and sequence length; the `train_4k_b*` shapes are the ones one card holds.
Weights are the reference's ``init_params(PRNGKey(--seed))`` bit for bit
(default 0, the reference's key; there is no checkpoint), the tokens from the reference's synthetic pipeline (`repro_torch.data`, bitwise
the reference's), with whisper's frames and qwen2-vl's prefix embeddings
drawn by it as the reference's launcher asks.  Any of the ten configs
trains; the loss adds the MoE configs' load-balance loss.  Runs on the CUDA device unless `--device cpu`.

Without `--debug`, a world of 256 ranks (512 with `--multi-pod`) trains on
the production mesh with the reference's rules, every rank stepping its
parameter and optimizer shards on its rows of the batch (as
`launch.serve.production_rules` builds them); a one-rank world keeps the
one-card path, and `--multi-pod` in a world of another size raises.
"""
from __future__ import annotations

import argparse
import time

import torch

from .. import device as _device
from ..core import prng
from ..configs import get_config
from ..data import make_batch_iterator
from ..models import model as M
from ..models.steps import make_train_step
from ..optim import adamw_init
from . import shapes as SH
from .serve import batch_rows, production_rules

#: `--debug`'s sequences and tokens a sequence (reference train.py)
DEBUG_SIZES = (4, 64)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> dict:
    """Runs the steps and returns the per-step losses and seconds (host
    clock around each step, which ends in reading its loss), the set-up
    seconds, and the run's sizes."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--debug", action="store_true",
                    help="reduced config, float32, no remat (a CPU run)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0, help="the weights' PRNGKey seed")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    if args.debug:
        cfg = get_config(args.arch).reduced()
        B, S = DEBUG_SIZES
        dtype = torch.float32
    else:
        cfg = get_config(args.arch)
        shp = SH.SHAPES[args.shape]
        B, S = shp.global_batch, shp.seq_len
        dtype = torch.bfloat16
    dev = _device.resolve(args.device)
    rules = production_rules(args, cfg, B, dev)
    rows = batch_rows(rules, B)

    _sync(dev)
    t0 = time.perf_counter()
    params = M.init_params(prng.PRNGKey(args.seed), cfg, dtype, device=dev, rules=rules)
    _sync(dev)
    init_s = time.perf_counter() - t0
    opt = adamw_init(params, dtype)
    step = make_train_step(cfg, rules, lr=args.lr, remat=not args.debug)
    extras = {}
    if cfg.n_enc_layers:
        extras["frames"] = (B, cfg.enc_seq, cfg.d_model)
    if cfg.n_prefix_embeds:
        extras["prefix_embeds"] = (B, cfg.n_prefix_embeds, cfg.d_model)
    it = make_batch_iterator(cfg.vocab_size, S + 1, B, seed=0, extras=extras, dtype=dtype,
                             device=dev)
    _sync(dev)
    setup_s = time.perf_counter() - t0

    losses, step_s = [], []
    t0 = time.time()
    for i in range(args.steps):
        batch = {k: v[rows] for k, v in next(it).items()}
        _sync(dev)
        ts = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        loss = float(m["loss"])
        step_s.append(time.perf_counter() - ts)
        losses.append(loss)
        print(f"step {i:4d} loss {loss:.4f} ({time.time() - t0:.1f}s)", flush=True)
    print("done")
    return {"losses": losses, "step_s": step_s, "setup_s": setup_s, "init_s": init_s,
            "config": cfg.name,
            "params": M.count_params(params), "batch": B, "seq_len": S,
            "dtype": str(dtype).replace("torch.", "")}


if __name__ == "__main__":
    main()
