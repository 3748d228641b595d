#!/usr/bin/env python3
"""Probe: torch.distributed's gloo backend on CUDA tensors, W ranks on one
card, and whether the card's batched library calls give each matrix of a
batch the same bits at batch sizes n and n/W.

    python3 tools/gloo_cuda_probe.py [--world 4] [--mb 256]

Each rank runs on cuda:0.  Prints one JSON line a check: which collectives
take CUDA tensors (all_gather, all_gather_into_tensor, all_reduce,
broadcast, gather), the seconds an all_gather of ``--mb`` MiB a rank takes,
and, on rank 0 alone, for bmm, einsum, eigh, svd and a client's sum over
its (d, d) block (in one reduction, and row by row then over the rows) in
float64 at the engine's shapes, and for the round engine's per-client GLM
operations on fig4's problem, whether the first n/W results of the batch-n
call equal the batch-n/W call's bitwise.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import socket
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _try(name, fn, rank):
    try:
        out = fn()
        print(json.dumps({"rank": rank, "check": name, "ok": True, **(out or {})}), flush=True)
    except Exception as e:  # a probe records what raises
        print(json.dumps({"rank": rank, "check": name, "ok": False,
                          "error": f"{type(e).__name__}: {e}"[:300]}), flush=True)


def _worker(rank: int, world: int, port: int, mb: int):
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    dev = torch.device("cuda", 0)
    x = torch.arange(6, dtype=torch.float64, device=dev) + 10 * rank

    def all_gather():
        outs = [torch.empty_like(x) for _ in range(world)]
        dist.all_gather(outs, x)
        ok = all(torch.equal(o.cpu(), (torch.arange(6, dtype=torch.float64) + 10 * r))
                 for r, o in enumerate(outs))
        return {"values_ok": ok, "out_device": str(outs[0].device)}

    def all_gather_into_tensor():
        out = torch.empty(world * 6, dtype=torch.float64, device=dev)
        dist.all_gather_into_tensor(out, x)
        return {"values_ok": bool(torch.equal(out.view(world, 6)[:, 0].cpu(),
                                              torch.arange(world, dtype=torch.float64) * 10))}

    def all_reduce():
        y = x.clone()
        dist.all_reduce(y)
        return {"values_ok": bool(torch.equal(y.cpu(), world * torch.arange(6, dtype=torch.float64)
                                              + 10 * sum(range(world))))}

    def all_reduce_max():
        y = x.clone()
        dist.all_reduce(y, op=dist.ReduceOp.MAX)
        return {"values_ok": bool(y[0].item() == 10 * (world - 1))}

    def broadcast():
        y = x.clone()
        dist.broadcast(y, src=0)
        negz = torch.tensor([-0.0], dtype=torch.float64, device=dev) if rank == 0 else \
            torch.zeros(1, dtype=torch.float64, device=dev)
        dist.broadcast(negz, src=0)
        return {"values_ok": bool(torch.equal(y.cpu(), torch.arange(6, dtype=torch.float64))),
                "neg_zero_kept": bool(torch.signbit(negz).item())}

    def broadcast_bool_int():
        b = torch.tensor([True, False], device=dev) if rank == 0 else torch.zeros(2, dtype=torch.bool, device=dev)
        dist.broadcast(b, src=0)
        i = torch.tensor([7], dtype=torch.int32, device=dev) if rank == 0 else torch.zeros(1, dtype=torch.int32, device=dev)
        dist.broadcast(i, src=0)
        return {"values_ok": bool(b[0].item() and not b[1].item() and i.item() == 7)}

    def gather():
        outs = [torch.empty_like(x) for _ in range(world)] if rank == 0 else None
        dist.gather(x, outs, dst=0)
        return {}

    def big_all_gather():
        n = mb * (1 << 20) // 8
        t = torch.full((n,), float(rank), dtype=torch.float64, device=dev)
        outs = [torch.empty_like(t) for _ in range(world)]
        dist.all_gather(outs, t)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dist.all_gather(outs, t)
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        return {"mib_a_rank": mb, "seconds": s,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30}

    for name, fn in [("all_gather", all_gather), ("all_gather_into_tensor", all_gather_into_tensor),
                     ("all_reduce", all_reduce), ("all_reduce_max", all_reduce_max),
                     ("broadcast", broadcast), ("broadcast_bool_int", broadcast_bool_int),
                     ("gather", gather), ("big_all_gather", big_all_gather)]:
        _try(name, fn, rank)
        dist.barrier()
    dist.destroy_process_group()


def _batch_invariance(world: int):
    dev = torch.device("cuda", 0)
    g = torch.Generator(device="cpu").manual_seed(0)
    res = {}
    for (n, a, b, c) in [(10, 120, 120, 120), (16, 24, 24, 24), (512, 1200, 24, 24),
                         (512, 24, 24, 1200), (64, 300, 64, 64)]:
        X = torch.randn(n, a, b, generator=g, dtype=torch.float64).to(dev)
        Y = torch.randn(n, b, c, generator=g, dtype=torch.float64).to(dev)
        k = n // world
        full = torch.bmm(X, Y)[:k]
        part = torch.bmm(X[:k], Y[:k])
        res[f"bmm{(n, a, b, c)}"] = bool(torch.equal(full, part))
        full = torch.einsum("nij,njk->nik", X, Y)[:k]
        part = torch.einsum("nij,njk->nik", X[:k], Y[:k])
        res[f"einsum{(n, a, b, c)}"] = bool(torch.equal(full, part))
    for (n, r) in [(10, 120), (16, 24), (512, 24), (64, 8)]:
        M = torch.randn(n, r, r, generator=g, dtype=torch.float64).to(dev)
        S = M + M.mT
        k = n // world
        wf, Vf = torch.linalg.eigh(S)
        wp, Vp = torch.linalg.eigh(S[:k])
        res[f"eigh{(n, r)}"] = bool(torch.equal(wf[:k], wp) and torch.equal(Vf[:k], Vp))
        Uf, sf, Vhf = torch.linalg.svd(M, full_matrices=False)
        Up, sp, Vhp = torch.linalg.svd(M[:k], full_matrices=False)
        res[f"svd{(n, r)}"] = bool(torch.equal(sf[:k], sp) and torch.equal(Uf[:k], Up))
    # a client's sum over its (d, d) block in one reduction, and row by row
    # then over the rows (`specs._fro_b`)
    for (n, d) in [(10, 120), (512, 24), (16, 64), (512, 1200)]:
        X = torch.randn(n, d, d, generator=g, dtype=torch.float64).to(dev)
        k = n // world
        for tag, f in (("sum_dd", lambda t: t.sum(dim=(1, 2))),
                       ("sum_rows_then_d", lambda t: t.sum(dim=2).sum(dim=1))):
            res[f"{tag}{(n, d)}"] = bool(torch.equal(f(X)[:k], f(X[:k].clone())))
    print(json.dumps({"check": "batch_invariance", "world": world, **res}), flush=True)


def _engine_ops(world: int):
    """The round engine's per-client GLM operations on fig4's problem
    (n = 10, m = 60, d = 120) at batch n and n/W: whether each client's
    result is the same bits in both calls."""
    import pathlib

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    from repro_torch.core import client_batch as cb
    from repro_torch.core import compressors as C
    from repro_torch.core import specs
    from repro_torch.exp import engine, registry

    dev = torch.device("cuda", 0)
    exp = registry.get_experiment("fig4")
    prob = engine.build_problem(exp.problem, dev)
    batch = cb.from_clients(prob.clients)
    basisb = cb.stack_bases(prob.bases("data_outer"))
    n, k = batch.n, batch.n // world
    g = torch.Generator(device="cpu").manual_seed(1)
    x = (0.1 * torch.randn(batch.d, generator=g, dtype=torch.float64)).to(dev)
    H = torch.randn(n, batch.d, batch.d, generator=g, dtype=torch.float64).to(dev)
    AV = cb.basis_AV(basisb, batch)
    half = cb.shard_batch(batch, slice(0, k))
    hb = cb.shard_basis(basisb, slice(0, k))
    ops = {
        "hess": lambda b, bb, t: cb.hess(b, x),
        "hess_weights": lambda b, bb, t: cb.hess_weights(b, x),
        "grads": lambda b, bb, t: cb.grads(b, x),
        "losses": lambda b, bb, t: cb.losses(b, x),
        "bmv": lambda b, bb, t: cb.bmv(t, x.expand(t.shape[0], batch.d)),
        "hess_coeff_block": lambda b, bb, t: cb.hess_coeff_block(
            bb, b, x, cb.basis_AV(bb, b)),
        "reconstruct_block": lambda b, bb, t: cb.reconstruct_block(bb, t[:, :24, :24]),
        "basis_h": lambda b, bb, t: bb.h(t),
        "psd_h_tilde": lambda b, bb, t: specs._psd_h_tilde(t),
        "fro": lambda b, bb, t: specs._fro_b(t),
        "rankr1": lambda b, bb, t: C.RankR(r=1).compress(None, t)[0],
        "einsum_nmd_nm_nme": lambda b, bb, t: torch.einsum(
            "nmd,nm,nme->nde", b.A, cb.hess_weights(b, x), b.A),
        "bmm_AtwA": lambda b, bb, t: torch.bmm(
            (b.A * cb.hess_weights(b, x)[..., None]).mT.contiguous(), b.A.contiguous()),
    }
    res = {}
    for name, f in ops.items():
        full = f(batch, basisb, H)
        part = f(half, hb, H[:k].clone())
        res[name] = bool(torch.equal(full[:k], part))
    del AV
    print(json.dumps({"check": "engine_ops", "world": world, **res}), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--mb", type=int, default=256)
    ap.add_argument("--no-collectives", action="store_true",
                    help="only the batch-invariance checks")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("no CUDA card")
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0],
                      "card": torch.cuda.get_device_name(0)}), flush=True)
    if not args.no_collectives:
        mp.spawn(_worker, args=(args.world, _free_port(), args.mb), nprocs=args.world,
                 join=True)
    _batch_invariance(args.world)
    _batch_invariance(2)
    _engine_ops(2)


if __name__ == "__main__":
    main()
