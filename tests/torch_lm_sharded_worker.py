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
  kind (``prefill_step_stats``: the prefill step's alone, as the dry run
  counts it), the prefill step's peak device memory and the bytes at its
  start (``prefill_peak_bytes``, ``prefill_window``), and (unless ``rerun``
  is false) whether a rerun gives equal bits;
* ``moe``: one MoE layer (`layers.moe` with the rules) on the rank's rows
  of ``x``: its output, aux, the shard's own aux and expert ids;
* ``train``: the step-0 loss and every gradient leaf gathered whole (kept
  by rank 0 only with ``keep_grads``; in the case's ``dtype``, float32 by
  default), a rerun of it (bitwise; unless ``rerun`` is false), then
  ``steps`` AdamW steps' losses, and the first step's collectives, peak
  device memory and the bytes at its start (``step0_stats``,
  ``step0_peak_bytes``, ``step0_window``: the step's arguments' and every
  allocated byte);
* ``reductions``: `collectives.reduce_scatter` and `all_reduce` (sum and
  max) over every axis run of the mesh, in each of the case's ``dtypes``,
  at sizes that do not divide by the ranks, ``dim`` 0 and last, held
  bitwise to the n-copy form (`n_copy_reduce`: every rank's operand
  gathered, summed in rank order), with each call's ``stats`` bytes.

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
from repro_torch.launch import dryrun
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
        before = _reset_peak(dev)
        window = _window(dev, params, toks, ex, cache)
        t0 = time.perf_counter()
        lg, cache = prefill(params, {"tokens": toks, **ex}, cache)
        prefill_step_stats, prefill_peak = C.snapshot(), _peak(dev)
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
                       prefill_step_stats=prefill_step_stats, prefill_peak_bytes=prefill_peak,
                       prefill_window=window,
                       decode_stats=C.snapshot(),
                       peak_bytes=_case_peak(dev, before))
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
    losses, step_s, before = [], [], None
    C.reset_stats()
    for i in range(case.get("steps", 0)):
        _sync(dev)
        if i == 0:
            before = _reset_peak(dev)
            out["step0_window"] = _window(dev, params, opt, batch)
        t0 = time.perf_counter()
        params, opt, m = step(params, opt, batch)
        losses.append(float(m["loss"]))
        step_s.append(time.perf_counter() - t0)
        if i == 0:
            out.update(step0_stats=C.snapshot(), step0_peak_bytes=_peak(dev))
    out["step_stats"] = C.snapshot()
    out.update(losses=losses, step_s=step_s,
               peak_bytes=_case_peak(dev, before))
    return out


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _reset_peak(dev):
    """Start a window of peak device memory (the allocated bytes now are
    its floor); returns the peak before it (None on the CPU)."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    before = torch.cuda.max_memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    return before


def _window(dev, *args) -> dict:
    """At a window's start: the step's arguments' bytes (their distinct
    storages, rounded as the allocator rounds a block) and every allocated
    byte (None on the CPU)."""
    return {"args_bytes": dryrun.storage_bytes([t for a in args for t in tree_leaves(a)]),
            "base_bytes": torch.cuda.memory_allocated(dev) if dev.type == "cuda" else None}


def _case_peak(dev, before):
    """The case's peak device bytes: its windows' and the one `before`
    them (None on the CPU)."""
    if dev.type != "cuda":
        return None
    return max(before or 0, torch.cuda.max_memory_allocated(dev))


def _peak(dev):
    """The window's peak allocated device bytes (None on the CPU)."""
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    return torch.cuda.max_memory_allocated(dev)


def n_copy_reduce(mesh, axes, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
    """The reduction as an all-gather of the n ranks' operands and their
    sum in rank order (or max): the form the all-to-all reductions must
    match bit for bit."""
    g = C._stacked(mesh, axes, x, "all_gather")
    if op == "max":
        return g.amax(dim=0)
    out = g[0]
    for i in range(1, g.shape[0]):
        out = out + g[i]
    return out


def n_copy_reduce_scatter(mesh, axes, x: torch.Tensor, dim: int) -> torch.Tensor:
    n = mesh.size(axes)
    size = x.shape[dim] // n
    return n_copy_reduce(mesh, axes, x).narrow(dim, mesh.index(axes) * size, size).contiguous()


def _bits(t: torch.Tensor) -> bytes:
    return t.detach().cpu().contiguous().view(torch.uint8).numpy().tobytes()


def reduction_axes(mesh) -> list:
    """Every run of the mesh's axes wider than one rank."""
    names = [a for a in mesh.axis_names if mesh.shape[a] > 1]
    runs = [(a,) for a in names]
    return runs + ([tuple(names)] if len(names) > 1 else [])


def run_reductions(case, data, mesh, dev) -> dict:
    """``checks``: each reduction against the n-copy form, (axes, kind,
    dtype, shape, dim) → (bitwise equal, the call's stats bytes, |x| in
    bytes)."""
    gen = torch.Generator().manual_seed(1000 + mesh.rank)
    out = {}
    for axes in reduction_axes(mesh):
        n = mesh.size(axes)
        for name in case["dtypes"]:
            dt = getattr(torch, name)

            def draw(*shape):
                scale = 10.0 ** (6 * torch.rand(shape, generator=gen, dtype=torch.float64) - 3)
                x = torch.randn(shape, generator=gen, dtype=torch.float64) * scale
                return x.to(dt).to(dev)
            for shape in ((101,), (5, 7, 3), (3, 1, 127)):
                x = draw(*shape)
                for op in ("sum", "max"):
                    C.reset_stats()
                    got = C.all_reduce(x, mesh, axes, op=op)
                    moved = C.snapshot()["all_reduce"]["bytes"]
                    want = n_copy_reduce(mesh, axes, x, op)
                    out[(axes, f"all_reduce/{op}", name, shape, None)] = (
                        _bits(got) == _bits(want) and got.shape == x.shape, moved,
                        x.numel() * x.element_size())
            for shape, dim in (((3 * n, 5, 7), 0), ((5, 7, 3 * n), -1), ((2 * n, 13), 0)):
                x = draw(*shape)
                C.reset_stats()
                got = C.reduce_scatter(x, mesh, axes, dim)
                moved = C.snapshot()["reduce_scatter"]["bytes"]
                want = n_copy_reduce_scatter(mesh, axes, x, dim % x.dim())
                out[(axes, "reduce_scatter", name, shape, dim)] = (
                    _bits(got) == _bits(want) and got.shape == want.shape, moved,
                    x.numel() * x.element_size())
    return {"checks": out}


RUN = {"serve": run_serve, "moe": run_moe, "train": run_train, "reductions": run_reductions}


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
