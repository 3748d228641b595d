"""End-to-end language-model training on the PyTorch port: the port of
`examples/train_lm.py`, with the same flags plus ``--device``.

Default: a ~10M-param gemma3-family model, 60 AdamW steps.  The 100M run:
  PYTHONPATH=src python examples/torch_train_lm.py --preset 100m --steps 300

Add --fed to train through the BL-DNN federated path (the paper's
communication layer: per-layer SVD bases, compressed-difference learning
and Fisher preconditioning, `repro_torch.fed.bldnn.run_bldnn`) instead of
AdamW.  Each client keeps one fixed local batch; the per-client gradients
are ``torch.func.vmap(torch.func.grad(loss_fn))`` over the client axis, so
on the card kernel 5 and its backward run once for the whole fleet.

``--device`` defaults to ``cuda`` (raises without a GPU); ``--device cpu``
runs the kernels' plain versions:
  PYTHONPATH=src python examples/torch_train_lm.py --fed --device cpu \\
      --steps 2 --batch 2 --seq 64
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import torch

from repro_torch import device as _device
from repro_torch.core import prng
from repro_torch.core.client_batch import TreeBatch, tree_batch
from repro_torch.core.pytree import tree_leaves
from repro_torch.data import make_batch_iterator
from repro_torch.fed.bldnn import BLDNNConfig, run_bldnn
from repro_torch.models import model as M
from repro_torch.models.config import LayerSpec, ModelConfig
from repro_torch.models.steps import make_fused_vocab_xent, make_train_step
from repro_torch.optim import adamw_init


def make_cfg(preset: str) -> ModelConfig:
    if preset == "100m":
        return ModelConfig(
            name="lm-100m", n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
            d_ff=2048, vocab_size=32768, group=(LayerSpec(),), max_seq=1024)
    return ModelConfig(
        name="lm-10m", n_layers=4, d_model=384, n_heads=6, n_kv_heads=2,
        d_ff=1024, vocab_size=8192, group=(LayerSpec(),), max_seq=512)


def n_fed_clients() -> int:
    """The fleet: one client a rank of the launching world, at least two
    (the reference's ``max(len(jax.devices()), 2)``)."""
    return max(int(os.environ.get("WORLD_SIZE", "1")), 2)


def make_loss_fn(cfg: ModelConfig):
    """One client's loss: the fused next-token cross entropy of the final
    hidden states against the unembedding, plus the MoE aux loss (the
    reference script's ``loss_fn``)."""
    xent = make_fused_vocab_xent(cfg, None)

    def loss_fn(p, data):
        tokens = data["tokens"]
        h, _, aux = M.forward(p, cfg, tokens[:, :-1], remat=False, return_hidden=True)
        return xent(h, p["unembed"], tokens[:, 1:]) + aux
    return loss_fn


def make_eval_fn(loss_fn):
    """The fleet's mean loss as the ``gap`` stream: the loss vmapped over
    the client axis."""

    def eval_fn(p, data):
        losses = torch.func.vmap(lambda d: loss_fn(p, d))(data)
        return {"gap": torch.mean(losses)}
    return eval_fn


def fed_batch(it, n_clients: int) -> TreeBatch:
    """`n_clients` consecutive batches of the stream stacked on a leading
    client axis."""
    bs = [next(it) for _ in range(n_clients)]
    return tree_batch({k: torch.stack([b[k] for b in bs]) for k in bs[0]})


def run_fed(cfg: ModelConfig, params, batch: TreeBatch, steps: int, lr: float,
            device=None, basis=None):
    """``steps`` BL-DNN rounds of the script's wiring (Top-K 5 % on every
    leaf, per-layer SVD bases, the Fisher leg); returns the `History`."""
    loss_fn = make_loss_fn(cfg)
    backend = "fast+sharded" if int(os.environ.get("WORLD_SIZE", "1")) > 1 else "fast"
    return run_bldnn(loss_fn, make_eval_fn(loss_fn), params, batch, steps,
                     BLDNNConfig(lr=lr, top_k_frac=0.05), backend=backend,
                     basis=basis, device=device)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="10m", choices=["10m", "100m"])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--fed", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)

    dev = _device.resolve(args.device)
    cfg = make_cfg(args.preset)
    params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device=dev)
    n_params = sum(x.numel() for x in tree_leaves(params))
    print(f"model: {cfg.name}  params={n_params/1e6:.1f}M  device={dev}")

    it = make_batch_iterator(cfg.vocab_size, args.seq + 1, args.batch, seed=0, device=dev)

    if args.fed:
        args.steps = max(args.steps, 2)   # ≥1 round + a comparison point
        batch = fed_batch(it, n_fed_clients())
        t0 = time.time()
        hist = run_fed(cfg, params, batch, args.steps, args.lr, device=dev)
        for i in range(0, len(hist.gaps), 10):
            print(f"round {i:4d}  loss {hist.gaps[i]:.4f}")
        print(f"final loss {hist.gaps[-1]:.4f}  "
              f"uplink {hist.up_bits[-1]/1e6:.1f} Mbits/node  "
              f"({time.time()-t0:.0f}s)")
        # gaps[t] is the loss BEFORE round t's update — steps ≥ 2 above
        # guarantees there is a later round to compare against
        assert hist.gaps[-1] < hist.gaps[0], "loss must decrease"
        return hist

    opt = adamw_init(params)
    step = make_train_step(cfg, None, lr=args.lr, remat=False)
    t0 = time.time()
    losses = []
    for i in range(args.steps):
        params, opt, m = step(params, opt, next(it))
        losses.append(float(m["loss"]))
        if i % 10 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.4f}  ({time.time()-t0:.0f}s)")
    assert losses[-1] < losses[0], "loss must decrease"
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}) — OK")
    return losses


if __name__ == "__main__":
    main(sys.argv[1:])
