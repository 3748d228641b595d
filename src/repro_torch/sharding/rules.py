"""Logical-axis sharding rules — port of `repro.sharding.rules`: one place
that decides how every parameter, activation and cache tensor of the LM
maps onto the (pod, data, model) mesh.

Scheme (the reference's):

* batch            → (pod, data)      (data parallelism)
* attention heads, FFN hidden, MoE experts, vocab → model  (tensor/expert par.)
* parameters       → FSDP over data on the d_model-ish dimension, TP over model
* KV caches        → batch over data when it divides; the *sequence* dimension
  shards over model (flash-decode style seq-parallel attention); for
  global_batch == 1 (long_500k) the sequence additionally shards over data.

A spec is a plain tuple, one entry a dimension: a mesh axis name, a tuple
of axis names (sharded over their product, the first the slowest), or
None (replicated) — the reference's ``PartitionSpec`` as data.  The trees
of specs (`param_specs`, `cache_specs`) are keyed by the reference's tree
paths.  The mesh is `repro_torch.launch.mesh.LMMesh` (``axis_names`` and
``shape``); the port's layers (`repro_torch.models.layers`) compute on each
rank's local shards with the collectives of
`repro_torch.sharding.collectives` rather than by constraints.

`Rules` also carries what the port's layers need to find a leaf's spec:
``table`` (path → spec, bound to a config by `Rules.bind`), the scope
``prefix`` a layer reads it under, and the scope's cache specs.  The
reference's ``client_chunk_specs`` / ``cohort_chunk_specs`` (shard_map
specs of the round engine) have no counterpart here: the port shards the
federated client axis with `repro_torch.core.rounds.ShardedReducer` over a
`repro_torch.launch.mesh.ClientGroup`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

# Mesh axis that client-stacked federated state shards over (the round
# engine and the BL-DNN layer map their leading n_clients axis onto it).
CLIENT_AXIS = "data"

Spec = Tuple[Any, ...]


def mesh_fingerprint(mesh) -> str:
    """Identity-free description of a mesh: axis names and sizes plus the
    device platform and kind, as the reference's program-cache key."""
    axes = ",".join(f"{a}={mesh.shape[a]}" for a in mesh.axis_names)
    return f"mesh({axes}|{mesh.platform}:{mesh.device_kind})"


def norm(entry):
    """A spec entry as ``PartitionSpec`` keeps it: a one-axis tuple is the
    axis, an empty one None."""
    if isinstance(entry, tuple):
        return None if not entry else entry[0] if len(entry) == 1 else entry
    return entry


def axes_of(entry) -> tuple:
    """The mesh axes of one spec entry (None → ())."""
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


@dataclasses.dataclass(frozen=True, eq=False)
class Rules:
    mesh: Any
    amap: Dict[str, Any]  # logical axis → mesh axis (or tuple / None)
    #: path → parameter spec of a bound config (`bind`), the scope's path
    #: prefix and the cache specs of the scope's layer (the port's layers
    #: read their leaves' specs through these)
    table: Optional[dict] = None
    prefix: str = ""
    cache: Optional[dict] = None

    def spec(self, axes) -> Spec:
        return tuple(norm(self.amap.get(a)) if a is not None else None for a in axes)

    def bind(self, cfg) -> "Rules":
        """These rules with the parameter spec table of `cfg`."""
        from ..models import model as M
        table = {}
        _walk(param_specs(M.param_shapes(cfg), cfg, self), "", table)
        return dataclasses.replace(self, table=table, prefix="", cache=None)

    def at(self, name: str, cache: Optional[dict] = None) -> "Rules":
        """The scope ``prefix/name`` (and its cache specs)."""
        prefix = f"{self.prefix}/{name}" if self.prefix else name
        return dataclasses.replace(self, prefix=prefix, cache=cache)

    def leaf(self, name: str) -> Spec:
        """The spec of leaf `name` in this scope, without the leading group
        (or encoder-layer) axis of a stacked leaf."""
        path = f"{self.prefix}/{name}" if self.prefix else name
        sp = self.table[path]
        return sp[1:] if path.split("/")[0] in ("layers", "encoder") else sp


def _walk(tree, prefix: str, out: dict) -> None:
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            _walk(v, path, out)
        else:
            out[path] = v


def data_axes(mesh) -> Tuple[str, ...]:
    """The mesh's data axes: (pod, data) on a multi-pod mesh, else (data,)."""
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def make_rules(mesh, *, batch_size: Optional[int] = None, fsdp: bool = True,
               seq_parallel: bool = False) -> Rules:
    """Build rules for a mesh with axes ('data','model') or ('pod','data','model').

    batch_size (global) decides whether batch can shard over the data axes:
    a batch of 1 hands the data axes to the KV cache's sequence; a batch
    smaller than the data size keeps the first data axis whose size divides
    it, or none."""
    axes = data_axes(mesh)
    data_size = math.prod(mesh.shape[a] for a in axes)
    batch_axes = axes
    kv_seq = None
    if batch_size is not None and batch_size < data_size:
        if batch_size == 1:
            batch_axes = None
            kv_seq = axes  # sequence takes over the idle data axes
        else:
            batch_axes = tuple(a for a in axes if batch_size % mesh.shape[a] == 0)[:1] or None
    amap = {
        "batch": batch_axes,
        "heads": "model",
        "kv_heads": None,       # most configs have kv < 16; see kv_seq instead
        "ffn": "model",
        "experts": "model",
        "vocab": "model",
        "kv_seq": kv_seq,       # extra data-axis seq sharding (long_500k)
        "fsdp": ("data" if fsdp else None),
        "model": "model",
        "act_seq": ("model" if seq_parallel else None),
    }
    return Rules(mesh=mesh, amap=amap)


def wants_seq_parallel(cfg, mesh) -> bool:
    m = mesh.shape["model"]
    pure_attn = all(s.mixer == "attn" for s in cfg.layer_specs())
    return pure_attn and cfg.n_heads % m != 0


# --------------------------------------------------------------------------
# Parameter / cache / batch specs by tree path
# --------------------------------------------------------------------------
def _param_spec_for(path: str, ndim: int, rules: Rules, cfg) -> Spec:
    f = rules.amap["fsdp"]
    m = "model"
    msize = rules.mesh.shape["model"]

    def fits(dim):  # only shard dims divisible by the mesh axis
        return dim % msize == 0

    # embed/unembed: vocab-only sharding (the fused cross entropy keeps its
    # dlogits vocab-sharded and all-reduces only dh)
    if path.endswith("unembed"):
        return (None, m if fits(cfg.padded_vocab) else None)
    if path.endswith("embed") and ndim == 2:
        return (m if fits(cfg.padded_vocab) else None, None)
    if path.endswith("enc_pos"):
        return (None, None)
    lead = (None,)   # stacked layer params: leading axis n_groups (or n_enc_layers)
    name = path.split("/")[-1]
    if name == "wq":
        return (*lead, f, m if fits(cfg.n_heads) else None, None)
    if name in ("wk", "wv"):
        return (*lead, f, m if fits(cfg.n_kv_heads) else None, None)
    if name == "wo" and ndim == 4:
        return (*lead, m if fits(cfg.n_heads) else None, None, f)
    if name in ("wi", "wg") and ndim == 3:   # dense MLP (G, D, F)
        return (*lead, f, m)
    if name == "wo" and ndim == 3:           # dense MLP out (G, F, D)
        return (*lead, m, f)
    if name in ("wi", "wg") and ndim == 4:   # MoE (G, E, D, F)
        return (*lead, m if fits(cfg.moe.n_experts) else None, f, None)
    if name == "router":
        return (*lead, None, None)
    if name == "in_proj":                    # mamba (G, D, E)
        return (*lead, f, m)
    if name == "out_proj":                   # mamba (G, di, D)
        return (*lead, m, f)
    if name == "conv_w":
        return (*lead, None, m)
    if name in ("A_log", "D", "dt_bias"):
        return (*lead, m if fits(cfg.n_ssm_heads) else None)
    # norms & everything else: replicated (tiny)
    return (None,) * ndim


def _drop_indivisible(sp: Spec, shape, mesh) -> Spec:
    """Replace any spec entry whose mesh-axis product doesn't divide the dim."""
    fixed = []
    for dim, entry in zip(shape, tuple(sp) + (None,) * (len(shape) - len(sp))):
        if entry is None:
            fixed.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in axes_of(entry))
        fixed.append(norm(entry) if dim % size == 0 else None)
    return tuple(fixed)


def map_with_path(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nested dict, keeping its structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else k)
                for k, v in tree.items()}
    return fn(prefix, tree)


def param_specs(params_tree, cfg, rules: Rules):
    """The spec tree matching the parameter tree (leaves: anything with a
    ``shape``, meta tensors included)."""
    def f(ps, leaf):
        shape = tuple(leaf.shape)
        sp = _param_spec_for(ps, len(shape), rules, cfg)
        # MoE expert wo vs attn wo: both ndim 4 — disambiguate by path
        if ps.split("/")[-1] == "wo" and len(shape) == 4:
            msize = rules.mesh.shape["model"]
            ok = (cfg.moe.n_experts if "moe" in ps else cfg.n_heads) % msize == 0
            sp = (None, "model" if ok else None, None, rules.amap["fsdp"])
        return _drop_indivisible(sp, shape, rules.mesh)
    return map_with_path(f, params_tree)


def cache_specs(cache_tree, cfg, rules: Rules):
    """KV/SSM cache specs.  Attn K/V: (G, B, S, KVH, hd) — batch over the
    batch axes, sequence over model (+ data when batch==1).  SSM states:
    (G, B, H, hd, N) — heads over model when divisible; the conv tail
    (G, B, W−1, conv_dim) over model on its channels when divisible."""
    msize = rules.mesh.shape["model"]
    batch_ax = rules.amap["batch"]
    kvseq_extra = rules.amap["kv_seq"]

    def f(ps, leaf):
        return tuple(norm(e) for e in spec_of(ps, tuple(leaf.shape)))

    def spec_of(ps, shape):
        name = ps.split("/")[-1]
        if name in ("k", "v"):
            seq_axes = ("model",) if kvseq_extra is None else tuple(kvseq_extra) + ("model",)
            if shape[2] % math.prod(rules.mesh.shape[a] for a in seq_axes) != 0:
                seq_axes = None
            return (None, batch_ax, seq_axes, None, None)
        if name == "ssm":
            return (None, batch_ax, "model" if shape[2] % msize == 0 else None, None, None)
        if name == "conv":
            return (None, batch_ax, None, "model" if shape[3] % msize == 0 else None)
        return (None,) * len(shape)
    return map_with_path(f, cache_tree)


def batch_specs(rules: Rules) -> Spec:
    return (norm(rules.amap["batch"]), None)
