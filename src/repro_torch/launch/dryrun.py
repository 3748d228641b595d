"""The LM dry run — port of `repro.launch.dryrun`.

For every (architecture × input shape) on the production mesh, (16, 16)
or (2, 16, 16) with ``--multi-pod``, one step runs on fake tensors, and
the record says what one rank would hold, compute and move:

* ``memory``: ``argument_size_bytes`` (the rank's shards of the step's
  arguments: the parameters, the AdamW state for a train step, the batch
  and the cache), ``output_size_bytes`` (the step's outputs, the updated
  parameters and state included) and ``temp_size_bytes`` (the peak of
  live tensor bytes during the step above the arguments).  Each storage
  counts its bytes rounded up to the CUDA caching allocator's 512.
* ``cost``: ``flops`` as `torch.utils.flop_counter.FlopCounterMode`
  counts them (products, 2 a multiply-add; the kernels' fake-tensor routes
  count what it counts for their plain versions), ``bytes_accessed`` (each
  operation's inputs and outputs, views and allocations excepted), and
  ``model_flops`` from `repro_torch.models.analysis`.
* ``collectives``: ``bytes_by_kind``, ``counts`` and ``total_bytes`` from
  `repro_torch.sharding.collectives.stats`: the bytes this rank receives
  and holds by kind (``all_gather``, ``all_reduce``, ``reduce_scatter``),
  not XLA's output-operand sizes.
* ``status``: ``ok``, ``skipped`` (`shapes.shape_applicable`), ``lowered``
  (``--no-compile``: the arguments are built, the step is not run) or
  ``error``.

The world is torch's fake process group: this process stands for rank 0
of 256 (or 512) ranks, whose collectives move nothing.  The tensors are
fake (`torch._subclasses.fake_tensor.FakeTensorMode`): shapes and types,
no storage, on the CPU (no card is needed or touched; fake CUDA tensors
would abort a backward on a torch built without CUDA, whose autograd asks
the device for its stream).  The kernel wrappers take their CUDA path to
the kernels' fake-tensor routes for fake tensors of either device
(`repro_torch.kernels._fake`), so the memory is the card path's.
Parameters and the AdamW moments are bfloat16 (the reference's
``adam_dtype``).

``--extrapolate`` adds the reference's G = 1 / G = 2 estimate
(``corrected``): XLA counts a scanned loop body once, so the reference
extrapolates; the port's Python loop over the groups counts every layer,
so here it is a cross-check of the full count.

``--progcache-dir DIR`` activates the program cache
(`repro_torch.core.progcache`) for the run, as the reference's flag does,
and prints its summary to stderr at the end.  No kernel launches on fake
tensors, so the cache gains no entry and the records are unchanged.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma3-4b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--both-meshes] [--out out.json]

`dry_run` is the function for callers: an explicit `shapes.InputShape`,
a mesh shape, a depth and a type (`chip_smoke.py` dry-runs its sharded
cells with it).
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import math
import sys
import time
import traceback
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist

from ..configs import ARCH_IDS, get_config
from ..core import progcache
from ..core.pytree import tree_leaves, tree_map
from ..models import analysis
from ..models import model as M
from ..models.config import ModelConfig
from ..models.steps import make_prefill_step, make_serve_step, make_train_step
from ..optim import adamw_init
from ..sharding import collectives as C
from ..sharding.rules import cache_specs, make_rules, param_specs, wants_seq_parallel
from . import shapes as SH
from .mesh import make_debug_mesh, make_production_mesh

#: the reference's input shapes, the ones ``--all`` runs
REFERENCE_SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
#: the CUDA caching allocator's rounding of a block
ALLOC_ROUND = 512
#: the production meshes
PRODUCTION = {False: (16, 16), True: (2, 16, 16)}


def mesh_name(mesh_shape: tuple) -> str:
    return "x".join(map(str, mesh_shape))


@contextlib.contextmanager
def fake_world(size: int):
    """A fake process group of `size` ranks, this process rank 0, for the
    block's duration (none may exist before it)."""
    if dist.is_initialized():
        raise RuntimeError("the dry run builds its own fake world; a process group exists")
    from torch.testing._internal.distributed.fake_pg import FakeStore  # registers "fake"

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _rounded(n: int) -> int:
    return -(-n // ALLOC_ROUND) * ALLOC_ROUND


def storage_bytes(tensors) -> int:
    """Bytes of the distinct storages of `tensors`, each rounded as the
    CUDA caching allocator rounds a block."""
    seen, out = set(), 0
    for t in tensors:
        st = t.untyped_storage()
        if st._cdata not in seen:
            seen.add(st._cdata)
            out += _rounded(st.nbytes())
    return out


_NO_ACCESS = ("empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided")


class _Memory(torch.utils._python_dispatch.TorchDispatchMode):
    """Live bytes of the storages that operations make while on, and those
    handed to `hold`: each counts from its first sight until it is freed
    (a weak reference's callback); ``peak`` is their largest sum.
    ``accessed`` sums every operation's tensor inputs and outputs, views
    and allocations excepted."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = self.accessed = 0
        self._seen: dict = {}

    def hold(self, tensors) -> None:
        for t in tensors:
            self._add(t)

    def _add(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = _rounded(st.nbytes())
        self._seen[key] = weakref.ref(st, functools.partial(self._free, key, n))
        self.live += n
        self.peak = max(self.peak, self.live)

    def _free(self, key, n, _ref) -> None:
        self._seen.pop(key, None)
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in torch.utils._pytree.tree_leaves(out) if isinstance(t, torch.Tensor)]
        if not func.is_view and func.__name__.split(".")[0] not in _NO_ACCESS:
            ins = [t for t in torch.utils._pytree.tree_leaves((args, kwargs))
                   if isinstance(t, torch.Tensor)]
            self.accessed += sum(t.numel() * t.element_size() for t in ins + outs)
        for t in outs:
            self._add(t)
        return out


def _mesh(mesh_shape: tuple):
    if mesh_shape == PRODUCTION[False]:
        return make_production_mesh(device="cpu")
    if mesh_shape == PRODUCTION[True]:
        return make_production_mesh(multi_pod=True, device="cpu")
    return make_debug_mesh(*mesh_shape, device="cpu")


def cut(cfg: ModelConfig, groups: Optional[int] = None, layers: Optional[int] = None):
    """`cfg` cut to `groups` whole groups (the encoder to as many layers,
    as the reference's `lower_case_depth`), or to its first `layers`
    layers (whole groups, or the first layers of one group)."""
    if groups is not None:
        return dataclasses.replace(
            cfg, n_layers=len(cfg.group) * groups,
            n_enc_layers=min(cfg.n_enc_layers, groups) if cfg.n_enc_layers else 0)
    if layers is None:
        return cfg
    return dataclasses.replace(cfg, n_layers=layers, group=cfg.group if layers % len(cfg.group)
                               == 0 else cfg.group[:layers])


def dry_run(cfg: ModelConfig, shape: SH.InputShape, mesh_shape: tuple = PRODUCTION[False], *,
            layers: Optional[int] = None, dtype=torch.bfloat16, remat: bool = True,
            max_seq: Optional[int] = None, compile_: bool = True) -> Dict[str, Any]:
    """One step of `cfg` (cut to its first `layers` layers) at `shape` on
    rank 0 of a fake world of ``prod(mesh_shape)`` ranks laid out as the
    mesh: the record of this module's docstring.  Parameters in `dtype`,
    the AdamW state in `dtype` too, a train step
    rematerialised by group when `remat`; a prefill's or decode's cache of
    `max_seq` positions (default the shape's, with a VLM's prefix for a
    prefill).  A decode step runs at the cache's last position.  Every
    collective counter is reset first."""
    cfg = cut(cfg, layers=layers)
    ok, why = SH.shape_applicable(cfg, shape)
    out: Dict[str, Any] = {"arch": cfg.name, "shape": shape.name,
                           "mesh": mesh_name(mesh_shape)}
    if not ok:
        return dict(out, status="skipped", reason=why)
    with fake_world(math.prod(mesh_shape)):
        mesh = _mesh(tuple(mesh_shape))
        rules = make_rules(mesh, batch_size=shape.global_batch,
                           seq_parallel=wants_seq_parallel(cfg, mesh)).bind(cfg)
        # every shape and spec outside the fake mode (the keyed shapes read keys)
        pshapes = M.param_shapes(cfg, dtype)
        pspecs = param_specs(pshapes, cfg, rules)
        batch = SH.batch_struct(cfg, shape, rules)
        out["cost"] = {"model_flops": analysis.model_flops(cfg, shape.kind, shape.global_batch,
                                                           shape.seq_len)}
        if shape.kind != "train":
            n = max_seq or shape.seq_len + (cfg.n_prefix_embeds if shape.kind == "prefill"
                                            else 0)
            cshapes = M.cache_shapes(cfg, shape.global_batch, n, dtype)
            cspecs = cache_specs(cshapes, cfg, rules)
        t0 = time.time()
        from torch._subclasses.fake_tensor import FakeTensorMode

        with FakeTensorMode():
            def local(shape_, dtype_, spec):
                return torch.empty(M.local_shape(shape_, spec, mesh), dtype=dtype_)

            params = tree_map(lambda t, sp: local(t.shape, t.dtype, sp), pshapes, pspecs)
            args = [params]
            if shape.kind == "train":
                opt = adamw_init(params, dtype)
                args.append(opt)
            inputs = {k: local(s.shape, s.dtype if k == "tokens" else dtype, s.spec)
                      for k, s in batch.items()}
            args.append(inputs)
            if shape.kind != "train":
                cache = M.ShardedCache({li: {k: local(t.shape, t.dtype, cspecs[li][k])
                                             for k, t in leaves.items()}
                                        for li, leaves in cshapes.items()})
                cache.specs = cspecs
                args.append(cache)
            held = [t for a in args for t in tree_leaves(a)]
            out["memory"] = {"argument_size_bytes": storage_bytes(held)}
            out["lower_s"] = round(time.time() - t0, 1)
            if not compile_:
                return dict(out, status="lowered")
            t1 = time.time()
            from torch.utils.flop_counter import FlopCounterMode

            C.reset_stats()
            mem = _Memory()
            with FlopCounterMode(display=False) as flops, mem:
                mem.hold(held)
                if shape.kind == "train":
                    result = make_train_step(cfg, rules, remat=remat)(params, opt, inputs)
                elif shape.kind == "prefill":
                    result = make_prefill_step(cfg, rules)(params, inputs, cache)
                else:
                    result = make_serve_step(cfg, rules)(params, inputs, cache, n - 1)
            stats = C.snapshot()
            out["compile_s"] = round(time.time() - t1, 1)
            out["memory"].update(
                output_size_bytes=storage_bytes(t for part in result for t in tree_leaves(part)
                                                if isinstance(t, torch.Tensor)),
                temp_size_bytes=mem.peak - out["memory"]["argument_size_bytes"])
            out["cost"].update(flops=float(flops.get_total_flops()),
                               bytes_accessed=float(mem.accessed))
            out["collectives"] = {
                "bytes_by_kind": {k: float(v["bytes"]) for k, v in stats.items()},
                "counts": {k: v["calls"] for k, v in stats.items()},
                "total_bytes": float(sum(v["bytes"] for v in stats.values()))}
    out["status"] = "ok"
    return out


def lower_case(arch: str, shape_name: str, multi_pod: bool = False, compile_: bool = True,
               extrapolate: bool = False) -> Dict[str, Any]:
    """The reference's `lower_case`: `arch` at full width at one of
    `shapes.SHAPES`, bfloat16 with bfloat16 AdamW moments, on the
    production mesh; with `extrapolate`, the G = 1 / G = 2 estimate as
    ``corrected``."""
    cfg, shape, mesh_shape = get_config(arch), SH.SHAPES[shape_name], PRODUCTION[multi_pod]
    out = dict(dry_run(cfg, shape, mesh_shape, compile_=compile_), arch=arch)
    if extrapolate and out["status"] == "ok":
        corr = extrapolate_costs(cfg, shape, mesh_shape)
        if corr:
            out["corrected"] = corr
    return out


def extrapolate_costs(cfg: ModelConfig, shape: SH.InputShape,
                      mesh_shape: tuple = PRODUCTION[False], **kwargs) -> Optional[Dict[str, Any]]:
    """The reference's G = 1 / G = 2 estimate of the whole model's costs,
    ``c1 + (G − 1)·(c2 − c1)`` (the encoder cut alongside), from two dry
    runs of `cfg` cut to one and two groups (`kwargs`: `dry_run`'s)."""
    r1 = dry_run(cut(cfg, groups=1), shape, mesh_shape, **kwargs)
    r2 = dry_run(cut(cfg, groups=2), shape, mesh_shape, **kwargs)
    if r1.get("status") != "ok" or r2.get("status") != "ok":
        return None

    def lin(f1, f2):
        return f1 + (cfg.n_groups - 1) * (f2 - f1)

    return {"flops": lin(r1["cost"]["flops"], r2["cost"]["flops"]),
            "bytes_accessed": lin(r1["cost"]["bytes_accessed"], r2["cost"]["bytes_accessed"]),
            "collective_bytes": lin(r1["collectives"]["total_bytes"],
                                    r2["collectives"]["total_bytes"]),
            "method": "G1/G2 linear extrapolation",
            "note": "a cross-check: the port's loop over the groups counts every layer, "
                    "so cost.flops is already the whole model's"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--no-compile", action="store_true")
    ap.add_argument("--extrapolate", action="store_true",
                    help="also compute the G=1/G=2 cost extrapolation (a cross-check here)")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--progcache-dir", type=str, default=None,
                    help="activate the program cache here and print its summary "
                         "(stderr) at the end; the dry run launches no kernel on "
                         "fake tensors, so the summary is empty")
    args = ap.parse_args(argv)
    with progcache.scope(args.progcache_dir, "cpu") as cache:
        status = _run_cases(args)
        if cache is not None:
            print(f"# progcache {json.dumps(cache.summary(), sort_keys=True)}", file=sys.stderr)
    return status


def _run_cases(args) -> int:

    archs = ARCH_IDS if (args.all or not args.arch) else [args.arch]
    shapes = list(REFERENCE_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch in archs:
        for shp in shapes:
            for mp in meshes:
                try:
                    r = lower_case(arch, shp, multi_pod=mp, compile_=not args.no_compile,
                                   extrapolate=args.extrapolate)
                except Exception as e:
                    r = {"arch": arch, "shape": shp, "mesh": mesh_name(PRODUCTION[mp]),
                         "status": "error", "error": f"{type(e).__name__}: {e}",
                         "trace": traceback.format_exc()[-2000:]}
                results.append(r)
                print(json.dumps({k: v for k, v in r.items() if k != "trace"}), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    bad = [r for r in results if r["status"] == "error"]
    print(f"# {len(results)} cases, {len(bad)} errors", file=sys.stderr)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
