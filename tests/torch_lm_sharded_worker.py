"""One rank of `tests/test_torch_lm_sharded.py`'s world of W ranks (gloo on
the CPU), and of `chip_smoke.py`'s phase ``lm_sharded`` on the card.

    RANK=r WORLD_SIZE=W MASTER_ADDR=localhost MASTER_PORT=p \\
        python tests/torch_lm_sharded_worker.py JOB.json

The job names the mesh (``data``, ``model``), the device, the inputs'
directory and the cases; each rank builds the mesh over the world
(`repro_torch.launch.mesh.make_debug_mesh`), runs every case through the
port's public entry points on its shards (weights drawn by the keyed
`init_params`, seed 0, inputs from the job's ``.npz`` files, this rank's
batch rows) and pickles what it saw to ``OUT/rank{r}.pkl``:

* ``serve``: prefill, then ``gen`` greedy decode steps; the logits over the
  whole vocabulary of this rank's rows, the tokens, the collectives by
  kind, and (unless ``rerun`` is false) whether a rerun gives equal bits;
* ``moe``: one MoE layer (`layers.moe` with the rules) on the rank's rows
  of ``x``: its output, aux, the shard's own aux and expert ids;
* ``train``: the step-0 loss and every gradient leaf gathered whole (kept
  by rank 0 only with ``keep_grads``; in the case's ``dtype``, float32 by
  default), a rerun of it (bitwise; unless ``rerun`` is false), then
  ``steps`` AdamW steps' losses.

Every case also records the kernels' launches (their counts set to 0 just
before the case and read just after; on CPU tensors the plain versions
count none), with ``routes`` each MoE layer's router probabilities and
expert ids of the prefill, and the seconds and peak device memory of its
parts.  Imports the port only.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import pathlib
import pickle
import sys
import time

import numpy as np
import torch

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.core.pytree import tree_leaves, tree_map
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.kernels import threefry_normal as tn
from repro_torch.launch import mesh as LM
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.optim import adamw_init
from repro_torch.sharding import collectives as C
from repro_torch.sharding import rules as R


def _digest(arrays) -> str:
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().float().cpu().numpy()


def _reset_launches() -> None:
    fa.launches = fa.bwd_launches = ss.launches = ss.bwd_launches = tn.launches = 0


def _launches() -> dict:
    return {"flash_attention": fa.launches, "flash_attention_bwd": fa.bwd_launches,
            "ssd_scan": ss.launches, "ssd_scan_bwd": ss.bwd_launches,
            "threefry_normal": tn.launches}


class _Routes:
    """Records each MoE layer's router probabilities and expert ids while
    on (`layers.moe_route`)."""

    def __init__(self):
        self.seen, self.on = [], False
        self._route = L.moe_route
        L.moe_route = self

    def __call__(self, probs, k):
        vals, ids = self._route(probs, k)
        if self.on:
            self.seen.append((probs.float().cpu().numpy(), ids.cpu().numpy()))
        return vals, ids


def case_config(case: dict):
    """A case's config: reduced (with ``over``) unless ``reduced`` is
    false, cut to ``layers`` in depth (whole groups, or the first n layers
    of one group)."""
    cfg = configs.get_config(case["arch"])
    cfg = cfg.reduced(**case.get("over", {})) if case.get("reduced", True) else cfg
    n = case.get("layers")
    if n:
        cfg = dataclasses.replace(cfg, n_layers=n, group=cfg.group if n % len(cfg.group) == 0
                                  else cfg.group[:n])
    return cfg


def setup(case: dict, mesh, dev):
    """(config, rules bound to it, dtype: ``dtype``, float32 by default)."""
    cfg = case_config(case)
    rules = R.make_rules(mesh, batch_size=case["B"],
                         seq_parallel=R.wants_seq_parallel(cfg, mesh)).bind(cfg)
    return cfg, rules, getattr(torch, case.get("dtype", "float32"))


def init_params(cfg, dtype, dev, rules=None):
    """The keyed float32 weights (seed 0), every float leaf cast to `dtype`
    (float64: the norms' scales and the SSM's A_log, D and dt_bias too)."""
    params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device=dev, rules=rules)
    return params if dtype == torch.float32 else tree_map(
        lambda t: t.to(dtype) if t.is_floating_point() else t, params)


def rows(rules, B: int) -> slice:
    axes = R.axes_of(rules.amap["batch"])
    n = B // rules.mesh.size(axes)
    i = rules.mesh.index(axes)
    return slice(i * n, (i + 1) * n)


def inputs(case: dict, data: pathlib.Path, rules, dev, dtype) -> dict:
    z = np.load(data / case["inputs"])
    sl = rows(rules, case["B"])
    out = {}
    for k in z.files:
        t = torch.as_tensor(z[k][sl])
        out[k] = t.to(dev, torch.int32 if k == "tokens" else dtype)
    return out


def run_serve(case, data, mesh, dev) -> dict:
    cfg, rules, dtype = setup(case, mesh, dev)
    params = init_params(cfg, dtype, dev, rules)
    ex = inputs(case, data, rules, dev, dtype)
    toks = ex.pop("tokens")
    start = toks.shape[1] + cfg.n_prefix_embeds
    prefill = steps.make_prefill_step(cfg, rules)
    serve = steps.make_serve_step(cfg, rules, return_logits=True)
    out = {"rows": (rows(rules, case["B"]).start, toks.shape[0])}
    routes = _Routes() if case.get("routes") else None
    for rerun in (False, True) if case.get("rerun", True) else (False,):
        cache = M.init_cache(cfg, case["B"], case["max_seq"], dtype, device=dev, rules=rules)
        C.reset_stats()
        _sync(dev)
        if routes is not None:
            routes.on = not rerun
        t0 = time.perf_counter()
        lg, cache = prefill(params, {"tokens": toks, **ex}, cache)
        if routes is not None:
            routes.on = False
        lg = M.gather_logits(lg, cfg, rules)
        _sync(dev)
        prefill_s = time.perf_counter() - t0
        prefill_stats = C.snapshot()
        tok = torch.argmax(lg[:, -1], dim=-1).to(torch.int32)
        tokens, step_logits = [tok], []
        svex = {k: v for k, v in ex.items() if k == "frames"}
        C.reset_stats()
        t0 = time.perf_counter()
        for t in range(case["gen"]):
            tok, cache, slg = serve(params, {"tokens": tok[:, None], **svex}, cache, start + t)
            tokens.append(tok)
            step_logits.append(slg)
        _sync(dev)
        decode_s = time.perf_counter() - t0
        rec = {"prefill": _np(lg), "steps": [_np(s) for s in step_logits],
               "tokens": torch.stack(tokens, 1).cpu().numpy()}
        if rerun:
            out["rerun_equal"] = _digest([rec["prefill"], *rec["steps"]]) == _digest(
                [out["prefill"], *out["steps"]])
        else:
            out.update(rec, prefill_s=prefill_s, decode_s=decode_s, prefill_stats=prefill_stats,
                       decode_stats=C.snapshot(),
                       peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                       else None)
        del cache
    if routes is not None:
        L.moe_route = routes._route
        out["routes"] = routes.seen
    return out


def run_moe(case, data, mesh, dev) -> dict:
    cfg, rules, dtype = setup(case, mesh, dev)
    params = init_params(cfg, dtype, dev, rules)
    x = inputs(case, data, rules, dev, dtype)["x"]
    li = f"l{[s.ffn for s in cfg.group].index('moe')}"      # the first MoE layer
    mp = M._index(params["layers"], 0)[li]["moe"]
    out, aux = L.moe(mp, x, cfg, rules.at(f"layers/{li}/moe"))
    _, _, ids, aux_local = L._router(x.reshape(-1, x.shape[-1]), mp["router"], cfg)
    return {"rows": (rows(rules, case["B"]).start, x.shape[0]), "out": _np(out),
            "aux": float(aux), "aux_local": float(aux_local), "ids": ids.cpu().numpy()}


def run_train(case, data, mesh, dev) -> dict:
    cfg, rules, dtype = setup(case, mesh, dev)
    params = init_params(cfg, dtype, dev, rules)
    batch = inputs(case, data, rules, dev, dtype)
    remat = case.get("remat", False)
    grad_fn = steps.make_grad_fn(cfg, remat=remat, rules=rules)
    specs = R.param_specs(M.param_shapes(cfg), cfg, rules)
    out = {}
    for rerun in (False, True) if case.get("rerun", True) else (False,):
        C.reset_stats()
        loss, aux, grads = grad_fn(params, batch)
        stats = C.snapshot()
        full = tree_map(lambda g, sp: C.gather_to(g, mesh, sp).detach().cpu().numpy(),
                        grads, specs)
        d = _digest([float(loss)] + tree_leaves(full))
        if rerun:
            out["rerun_equal"] = d == out["digest"]
        else:
            kg = case.get("keep_grads", True)
            keep = kg is True or kg == mesh.rank
            out.update(loss=float(loss), aux=float(aux), digest=d, stats=stats,
                       grads=full if keep else None)
        del full, grads
    opt = adamw_init(params, dtype)
    step = steps.make_train_step(cfg, rules, remat=remat)
    losses, step_s = [], []
    C.reset_stats()
    for _ in range(case.get("steps", 0)):
        _sync(dev)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
    out["step_stats"] = C.snapshot()
    out.update(losses=losses, step_s=step_s,
               peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None)
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


RUN = {"serve": run_serve, "moe": run_moe, "train": run_train}


def main(job_path: str) -> None:
    job = json.loads(pathlib.Path(job_path).read_text())
    torch.set_num_threads(1)
    dev = torch.device(job.get("device", "cpu"))
    mesh = LM.make_debug_mesh(job["data"], job["model"], device=dev)
    if dev.type == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
    data = pathlib.Path(job["inputs"])
    results = {}
    for case in job["cases"]:
        if dev.type == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(dev)
        _reset_launches()
        t0 = time.perf_counter()
        results[case["name"]] = RUN[case["kind"]](case, data, mesh, dev)
        results[case["name"]].update(launches=_launches(), case_s=time.perf_counter() - t0)
    out = pathlib.Path(job["out"]) / f"rank{mesh.rank}.pkl"
    out.write_bytes(pickle.dumps({"coords": mesh.coords, "results": results}))
    torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])
