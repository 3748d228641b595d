"""The LM's spec tables on one side, for `tests/test_torch_lm_sharded.py`.

    python tests/torch_lm_specs_worker.py ref OUT.json    # the JAX package
    python tests/torch_lm_specs_worker.py port OUT.json   # the port

Writes ``{mesh: {config: {"params": {path: spec}, "cache": {shape: {path:
spec}}, "batch": {shape: spec}}}}`` for every config at full width, on the
production meshes (16, 16) and (2, 16, 16) and the debug meshes (2, 2),
(1, 3) and (4, 2), at the global batch of each of the four input shapes.
A spec is a list with one entry a dimension: null, an axis name, or a list
of axis names.  The reference's side also writes ``args``: {mesh: {config:
{shape: the dry run's arguments a rank, [local shape, bytes an element]
for each}}} on the production meshes, as its `launch.dryrun.lower_case`
builds them (bfloat16 parameters and AdamW moments, the batch, the cache;
each shard's shape from its `NamedSharding`; the decode position, a traced
scalar there, is left out), or ``"skipped"`` where `shape_applicable`
skips the case.  The reference's side needs 512 virtual CPU devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=512``, set here before
jax is imported); the port's builds each mesh over torch's fake process
group at its world size (256, 512, 4, 3, 8), one world after another.
"""
from __future__ import annotations

import json
import os
import sys

MESHES = {"16x16": (16, 16, False), "2x16x16": (None, None, True),
          "2x2": (2, 2, False), "1x3": (1, 3, False), "4x2": (4, 2, False)}


def _entry(e):
    if e is None or isinstance(e, str):
        return e
    return list(e)


def _flat(tree, to_spec, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(_flat(v, to_spec, path))
        else:
            out[path] = [_entry(e) for e in to_spec(v)]
    return out


def _max_seq(cfg, shape):
    return shape.seq_len + (cfg.n_prefix_embeds if shape.kind == "prefill" else 0)


def ref() -> dict:
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax.numpy as jnp

    from repro import configs
    from repro.launch import mesh as lm
    from repro.launch.shapes import SHAPES
    from repro.models import model as M
    from repro.sharding import rules as R

    def spec(ns):
        return tuple(ns.spec)

    cfgs = {arch: configs.get_config(arch) for arch in configs.ARCH_IDS}
    shapes = {arch: M.param_shapes(cfg, jnp.bfloat16) for arch, cfg in cfgs.items()}
    caches = {(arch, sname): M.cache_shapes(cfg, shp.global_batch, _max_seq(cfg, shp),
                                            jnp.bfloat16)
              for arch, cfg in cfgs.items() for sname, shp in SHAPES.items()}
    out = {"args": {}}
    for name, (d, m, pod) in MESHES.items():
        mesh = (lm.make_production_mesh(multi_pod=pod) if d is None or d == 16
                else lm.make_debug_mesh(d, m))
        if d is None or d == 16:
            out["args"][name] = {arch: dryrun_args(cfg, shapes[arch], mesh)
                                 for arch, cfg in cfgs.items()}
        out[name] = {}
        for arch, cfg in cfgs.items():
            rec = {"params": _flat(R.param_specs(shapes[arch], cfg, R.make_rules(mesh)), spec),
                   "cache": {}, "batch": {}}
            for sname, shp in SHAPES.items():
                rules = R.make_rules(mesh, batch_size=shp.global_batch)
                rec["cache"][sname] = _flat(R.cache_specs(caches[arch, sname], cfg, rules), spec)
                rec["batch"][sname] = [_entry(e) for e in R.batch_specs(rules).spec]
            out[name][arch] = rec
    return out


def dryrun_args(cfg, pshapes, mesh) -> dict:
    """The reference dry run's arguments on `mesh`, a rank's shard of each
    (`repro.launch.dryrun.lower_case`), by input shape."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from repro.launch import shapes as SH
    from repro.optim import adamw_init
    from repro.sharding import rules as R

    def local(sds, sharding):
        return [list(sharding.shard_shape(sds.shape)), jnp.dtype(sds.dtype).itemsize]

    out = {}
    for sname, shp in SH.SHAPES.items():
        if not SH.shape_applicable(cfg, shp)[0]:
            out[sname] = "skipped"
            continue
        rules = R.make_rules(mesh, batch_size=shp.global_batch,
                             seq_parallel=R.wants_seq_parallel(cfg, mesh))
        pspecs = R.param_specs(pshapes, cfg, rules)
        leaves = [local(s, sh) for s, sh in zip(jax.tree.leaves(pshapes),
                                                jax.tree.leaves(pspecs))]
        if shp.kind == "train":
            opt = jax.eval_shape(lambda p: adamw_init(p, jnp.bfloat16), pshapes)
            for part in ("m", "v"):
                leaves += [local(s, sh) for s, sh in zip(jax.tree.leaves(opt[part]),
                                                        jax.tree.leaves(pspecs))]
            leaves.append(local(opt["step"], NamedSharding(mesh, P())))
        else:
            leaves += [local(s, s.sharding)
                       for s in jax.tree.leaves(SH.cache_struct(cfg, shp, rules))]
        leaves += [local(s, s.sharding)
                   for s in jax.tree.leaves(SH.batch_struct(cfg, shp, rules))]
        out[sname] = leaves
    return out


def port() -> dict:
    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch import configs
    from repro_torch.launch import mesh as lm
    from repro_torch.launch.shapes import SHAPES
    from repro_torch.models import model as M
    from repro_torch.sharding import rules as R

    out = {}
    for name, (d, m, pod) in MESHES.items():
        size = 512 if pod else d * m
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=size)
        try:
            mesh = (lm.make_production_mesh(multi_pod=pod, device="cpu") if d in (None, 16)
                    else lm.make_debug_mesh(d, m, device="cpu"))
            out[name] = {}
            for arch in configs.ARCH_IDS:
                cfg = configs.get_config(arch)
                shapes = M.param_shapes(cfg, torch.bfloat16)
                rec = {"params": _flat(R.param_specs(shapes, cfg, R.make_rules(mesh)),
                                       lambda s: s),
                       "cache": {}, "batch": {}}
                for sname, shp in SHAPES.items():
                    if sname not in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
                        continue
                    rules = R.make_rules(mesh, batch_size=shp.global_batch)
                    cs = M.cache_shapes(cfg, shp.global_batch, _max_seq(cfg, shp),
                                        torch.bfloat16)
                    rec["cache"][sname] = _flat(R.cache_specs(cs, cfg, rules), lambda s: s)
                    rec["batch"][sname] = [_entry(e) for e in R.batch_specs(rules)]
                out[name][arch] = rec
        finally:
            dist.destroy_process_group()
    return out


if __name__ == "__main__":
    side, path = sys.argv[1], sys.argv[2]
    result = ref() if side == "ref" else port()
    with open(path, "w") as f:
        json.dump(result, f)
