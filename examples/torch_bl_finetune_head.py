"""Federated last-layer fine-tuning with the paper-exact method (BL1) on
the PyTorch port: the port of `examples/bl_finetune_head.py`, with
``--device``.

A reduced stablelm-12b backbone produces mean-pooled features of each
client's private token sequences; n federated clients fine-tune a binary
logistic head on them with BL1 (exact d×d Hessians, the data-induced
bases, Top-K coefficient compression), beside FedNL (the standard basis
with Rank-1, a batched SVD) and GD.  Transformer features live near a
low-dimensional manifold, so each client's intrinsic dimension r is far
below d_model and Basis Learn pays off as in §2.3.

Run:  PYTHONPATH=src python examples/torch_bl_finetune_head.py [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from repro_torch import device as _device
from repro_torch.configs import get_config
from repro_torch.core import baselines, bl, glm, prng
from repro_torch.core.basis import StandardBasis, orth_basis_from_data
from repro_torch.core.compressors import Identity, RankR, TopK
from repro_torch.models import model as M

N_CLIENTS, M_ROWS, SEQ = 8, 48, 16


def backbone(device):
    """The reduced stablelm-12b config and its float32 weights of PRNGKey(0)."""
    cfg = get_config("stablelm_12b").reduced()
    return cfg, M.init_params(prng.PRNGKey(0), cfg, torch.float32, device=device)


def features(params, cfg, rng: np.random.Generator, device) -> list:
    """Each client's (m, d_model) float64 features: its private token
    sequences drawn from `rng`, the backbone's final hidden states
    mean-pooled over positions (in float32, then widened)."""
    feats = []
    for _ in range(N_CLIENTS):
        toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (M_ROWS, SEQ)),
                               dtype=torch.int32, device=device)
        with torch.no_grad():
            h, _, _ = M.forward(params, cfg, toks, remat=False, return_hidden=True)
        feats.append(h.mean(dim=1).cpu().numpy().astype(np.float64))
    return feats


def make_clients(feats: list, rng: np.random.Generator, device) -> list:
    """The fleet: labels planted from a random probe direction drawn from
    `rng` (after the tokens), ridge 1e-2."""
    d = feats[0].shape[1]
    w_true = rng.standard_normal(d) / np.sqrt(d)
    clients = []
    for F in feats:
        z = F @ w_true
        b = np.where(rng.random(F.shape[0]) < 1 / (1 + np.exp(-2 * z)), 1.0, -1.0)
        clients.append(glm.ClientData(A=torch.tensor(F, device=device),
                                      b=torch.tensor(b, device=device), lam=1e-2))
    return clients


def run_all(clients: list, device) -> dict:
    """The script's three runs from x = 0 toward the 20th Newton iterate."""
    d = clients[0].A.shape[1]
    x0 = torch.zeros(d, dtype=torch.float64, device=device)
    xs = glm.newton_solve(clients, x0, 20)
    bases = [orth_basis_from_data(c.A) for c in clients]
    sbases = [StandardBasis(d) for _ in clients]
    return {
        "BL1 (feature basis)": bl.bl1(clients, bases, [TopK(k=b.r) for b in bases],
                                      Identity(), x0, xs, 30, device=device),
        "FedNL (Rank-1)": bl.bl1(clients, sbases, [RankR(r=1) for _ in clients],
                                 Identity(), x0, xs, 30, device=device),
        "GD": baselines.gd(clients, x0, xs, 150, device=device),
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a GPU) or cpu")
    args = ap.parse_args(argv)
    dev = _device.resolve(args.device)

    cfg, params = backbone(dev)
    rng = np.random.default_rng(0)
    feats = features(params, cfg, rng, dev)
    ranks = []
    for F in feats:
        s = np.linalg.svd(F, compute_uv=False)
        ranks.append(int((s > s[0] * 1e-6).sum()))
    print(f"d_model={cfg.d_model}, per-client feature rank r≈{ranks} (m={M_ROWS})")

    runs = run_all(make_clients(feats, rng, dev), dev)
    print(f"{'method':22s} {'gap@end':>10s} {'Mbits/node to 1e-7':>20s}")
    for name, h in runs.items():
        g = np.asarray(h.gaps)
        hit = g < 1e-7
        bits = h.up_bits[int(np.argmax(hit))] / 1e6 if hit.any() else float("inf")
        print(f"{name:22s} {g[-1]:10.2e} {bits:20.3f}")
    return runs


if __name__ == "__main__":
    main(sys.argv[1:])
