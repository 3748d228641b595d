"""BL-DNN: the paper's communication layer applied to deep-network training
— port of `repro.fed.bldnn`.

Every 2-D weight's gradient travels in a per-layer basis (the SVD factors
of its initialization, or a structured DCT / Hadamard basis), through the
compressed-shift recursion of Alg. 1, and the server preconditions with a
Fisher diagonal learned through the same recursion.  The method is
`repro_torch.core.specs.BLDNNSpec` on the round engine
(`repro_torch.core.rounds`); this module holds the workload: the MLP
classifier, its loss and evaluation, the per-leaf compressors and the
public `run_bldnn`.

Parameters are nested dicts of float32 tensors (`repro_torch.core.pytree`),
data a `client_batch.TreeBatch` ``{"x": (n, m, d), "y": (n, m)}``.  The
reference draws its synthetic fleet and initial weights with
``jax.random.normal``, whose inverse-erf transform the port does not
reproduce bit for bit: a problem is carried across from the reference as
numpy arrays (`repro_torch.core.convert.dnn_problem_from_numpy`).  The
rounds' own draws (RTop-K's dithering) come from `repro_torch.core.prng`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from .. import device as _device
from ..core import batched, comm, rounds, specs
from ..core.basis import PerLayerSVDBasis, is_pytree_basis, make_bases
from ..core.bl import History
from ..core.client_batch import TreeBatch
from ..core.compressors import Compressor, Identity, TopK, rtopk
from ..core.pytree import tree_leaves, tree_map
from ..models import layers as L

_BACKENDS = ("fast", "fast+sharded")


@dataclasses.dataclass(frozen=True)
class BLDNNConfig:
    """BL-DNN hyperparameters (one frozen config → one `BLDNNSpec`)."""

    top_k_frac: float = 0.05       # per-leaf Top-K budget: k = max(1, ⌊frac·numel⌋)
    compressor: str = "topk"       # "topk" | "rtopk" | "identity"
    alpha: float = 1.0             # shift learning rate (contractive ⇒ 1)
    lr: float = 1e-3
    precondition: bool = True
    fisher_alpha: float = 0.1
    eps: float = 1e-2
    use_basis: bool = True
    #: which pytree basis: ``per_layer_svd`` | ``dct_tree`` | ``hadamard_tree``
    basis_kind: str = "per_layer_svd"
    #: shipment wire for the basis factors (`comm.BasisShipSpec`)
    ship_float_bits: int = 32
    ship_col_frac: float = 1.0
    #: amortized re-shipment (`specs.BasisRefreshPolicy`); 0 ships once
    rounds_per_refresh: int = 0
    drift_threshold: float = 0.0


_JAX_RANDOM = ("draws on jax.random.normal, whose inverse-erf transform "
               "(XLA's erf_inv) torch.erfinv does not reproduce bit for bit: "
               "ROADMAP.md §1 item 9's remainder (normal / erf_inv) brings it; "
               "until then carry a problem across from the reference "
               "(repro_torch.core.convert.dnn_problem_from_numpy, ROADMAP.md §1 item 11)")


def init_mlp_classifier(*args, **kwargs):
    """The reference's initializer; raises until the port draws normals."""
    raise NotImplementedError(f"init_mlp_classifier {_JAX_RANDOM}")


def make_synthetic_classification(*args, **kwargs):
    """The reference's synthetic fleet; raises until the port draws normals."""
    raise NotImplementedError(f"make_synthetic_classification {_JAX_RANDOM}")


def mlp_classifier_logits(params: dict, x: torch.Tensor) -> torch.Tensor:
    """(B, d_in) features → (B, classes) logits: input projection, the
    `models.layers` MLP block with a residual, class head."""
    h = torch.tanh(x @ params["in"])
    h = h + L.mlp(params["mlp"], h[:, None, :])[:, 0, :]
    return h @ params["out"]


def make_loss_fn(classes: int):
    """Per-client mean softmax cross-entropy: (params, {"x", "y"}) → scalar."""
    del classes  # shapes carry it

    def loss_fn(params, data):
        logp = F.log_softmax(mlp_classifier_logits(params, data["x"]), dim=-1)
        return -torch.mean(torch.gather(logp, 1, data["y"].long()[:, None]))
    return loss_fn


def make_eval_fn():
    """Fleet evaluation: the training error rate as the ``gap`` stream and
    the mean training loss as ``loss``, both float64 (the loss is a float32
    mean, cast)."""

    def eval_fn(params, data):
        logits = torch.func.vmap(lambda xb: mlp_classifier_logits(params, xb))(data["x"])
        logp = F.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, data["y"].long()[..., None])
        err = (logits.argmax(dim=-1) != data["y"]).to(torch.float64).mean()
        return {"gap": err, "loss": nll.mean().to(torch.float64)}
    return eval_fn


def leaf_compressors(kind: str, frac: float, params: dict) -> Tuple[Compressor, ...]:
    """One compressor per parameter leaf (in `tree_leaves` order), Top-K
    budgets scaled to the leaf: k_ℓ = max(1, ⌊frac·numel_ℓ⌋)."""
    comps = []
    for p in tree_leaves(params):
        k = max(1, int(frac * p.numel()))
        if kind == "identity":
            comps.append(Identity())
        elif kind == "topk":
            comps.append(TopK(k=k))
        elif kind == "rtopk":
            comps.append(rtopk(k))
        else:
            raise ValueError(f"unknown BL-DNN compressor kind {kind!r} "
                             "(expected identity | topk | rtopk)")
    return tuple(comps)


def build_spec(loss_fn, eval_fn, params: dict, cfg: BLDNNConfig, *,
               basis_ship_bits: Optional[float] = None) -> specs.BLDNNSpec:
    """`BLDNNSpec` for a parameter tree under one `BLDNNConfig`."""
    comps = leaf_compressors(cfg.compressor, cfg.top_k_frac, params)
    return specs.BLDNNSpec(
        loss_fn=loss_fn, eval_fn=eval_fn, grad_comps=comps, fisher_comps=comps,
        alpha=cfg.alpha, fisher_alpha=cfg.fisher_alpha, lr=cfg.lr, eps=cfg.eps,
        precondition=cfg.precondition, basis_ship_bits=basis_ship_bits,
        refresh=specs.BasisRefreshPolicy(rounds_per_refresh=cfg.rounds_per_refresh,
                                         drift_threshold=cfg.drift_threshold))


def run_bldnn(loss_fn, eval_fn, params0: dict, batch: TreeBatch, steps: int,
              cfg: BLDNNConfig = BLDNNConfig(), *, seed: int = 0,
              backend: str = "fast", exact: bool = True,
              basis: Optional[PerLayerSVDBasis] = None, stream=None,
              device=None) -> History:
    """Train `steps` BL-DNN rounds on the round engine.

    Args are the reference's (`repro.fed.bldnn.run_bldnn`), plus ``device``:
    the run's device, ``None`` meaning ``"cuda"`` (raises without a GPU);
    parameters, data and basis are moved there.  ``seed`` keys the rounds
    (the per-leaf draws of a stochastic compressor, ``rtopk``); ``exact``
    is accepted for the reference's signature: the "fast" backend reduces
    exactly.  ``basis`` overrides
    the basis built from ``params0`` (carry the reference's per-layer SVD
    factors here: they are not unique).  "fast+sharded" raises until
    ROADMAP.md §1 item 13.

    Returns a `History`: ``gaps`` is the training error rate,
    ``metrics["loss"]`` the loss stream, ``legs`` the per-leg bit streams
    (gradient coefficients on ``grad_up``, the Fisher stream on
    ``hess_up``, the basis shipment on ``basis_ship``)."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
    if backend == "fast+sharded":
        raise NotImplementedError(
            "backend='fast+sharded' is not ported yet: ROADMAP.md §1 item 13 "
            "(torch.distributed reducer) brings it")
    dev = _device.resolve(device)
    params0 = tree_map(lambda p: p.to(dev), params0)
    batch = TreeBatch(data=tree_map(lambda x: x.to(dev), batch.data),
                      n_clients=batch.n_clients)
    if cfg.use_basis and basis is None:
        if not is_pytree_basis(cfg.basis_kind):
            raise ValueError(
                f"BL-DNN needs a pytree basis, {cfg.basis_kind!r} is a d×d "
                "matrix basis (see basis.available_bases())")
        basis = make_bases(cfg.basis_kind, params0)
    if not cfg.use_basis:
        basis = None
    ship_bits = None
    if basis is not None:
        # the engine rotates with the basis as shipped, and bills its price
        ship = comm.BasisShipSpec(float_bits=cfg.ship_float_bits,
                                  col_frac=cfg.ship_col_frac)
        basis, ship_bits = basis.to(dev).shipped(ship)
    spec = build_spec(loss_fn, eval_fn, params0, cfg, basis_ship_bits=ship_bits)
    evals, leds = rounds.run_rounds(spec, batch, basis, params0, 0.0, steps,
                                    seed=seed, stream=stream)
    return batched._history(evals, leds)
