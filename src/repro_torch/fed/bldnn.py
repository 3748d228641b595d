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
data a `client_batch.TreeBatch` ``{"x": (n, m, d), "y": (n, m)}``.
`make_synthetic_classification` draws the reference's synthetic fleet and
student: numpy's draws made by numpy, the weights' ``jax.random.normal``
draws bit for bit through `repro_torch.core.prng.normal`.  The rounds' own
draws (RTop-K's dithering) come from `repro_torch.core.prng` too.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .. import device as _device
from ..core import batched, client_batch, comm, prng, rounds, specs
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


def _f32(v: float) -> torch.Tensor:
    """A Python float as the reference's weakly typed scalar: rounded to
    float32, so the product with a float32 tensor is one float32 multiply
    on any device."""
    return torch.tensor(v, dtype=torch.float32)


def init_mlp_classifier(key: torch.Tensor, d_in: int, width: int, classes: int,
                        spectral_decay: float = 0.0, *, device=None) -> dict:
    """Input projection → `models.layers` MLP block → class head, bit for
    bit the reference's draws from `key` (a `prng.PRNGKey`) in float32.

    ``spectral_decay > 0`` re-spectralizes every 2-D weight to singular
    values exp(−i/decay), rescaled to the weight's own Frobenius norm, in
    float64 as the reference (x64) computes it — within 1e-5·max|w| of the
    reference, whose SVD is another LAPACK call; 0 keeps the plain draws."""
    dev = _device.resolve(device)
    ks = prng.split(key, 3)
    params = {
        "in": L._init(ks[0], (d_in, width), d_in ** -0.5, torch.float32, dev),
        "mlp": L.init_mlp(ks[1], width, 2 * width, False, torch.float32, dev),
        "out": L._init(ks[2], (width, classes), width ** -0.5, torch.float32, dev),
    }
    if spectral_decay > 0.0:
        def respectralize(p):
            if p.dim() != 2 or min(p.shape) < 2:
                return p
            u, s, vt = torch.linalg.svd(p, full_matrices=False)
            snew = torch.exp(-torch.arange(s.shape[0], dtype=torch.float64, device=p.device)
                             / spectral_decay)
            snew = snew * (torch.linalg.norm(s).double() / torch.linalg.norm(snew))
            return ((u.double() * snew) @ vt.double()).to(p.dtype)
        params = tree_map(respectralize, params)
    return params


def make_synthetic_classification(seed: int, n_clients: int, m: int, d: int,
                                  classes: int, width: int, r: int = 8,
                                  heterogeneity: float = 0.5,
                                  label_noise: float = 0.05, *,
                                  device=None) -> Tuple[TreeBatch, dict]:
    """The reference's teacher-labelled classification fleet and
    near-teacher student (`repro.fed.bldnn.make_synthetic_classification`):
    client inputs in a shared r-dimensional subspace span(P), labels from a
    subspace-aligned teacher with decaying spectra plus `label_noise`
    flips, and the student 0.6·teacher + 0.4·fresh with the fresh input
    layer projected onto span(P).

    Drawn on the host, where every step is the reference's: numpy's draws
    and products by numpy (``P @ (P.T @ fresh_in)`` in float64), the
    weights' normals bit for bit, the teacher's labels from float32 logits
    on the CPU, the 0.6/0.4 mix as separate float32 operations.  So x and
    y are the reference's exactly and the student's input layer too; the
    other student leaves inherit the re-spectralising SVD's ~1e-7 relative
    difference.  Returns ``(batch, params0)`` on ``device``."""
    dev = _device.resolve(device)
    cpu = torch.device("cpu")
    rng = np.random.default_rng(seed)
    kt, ks = prng.split(prng.PRNGKey(seed), 2)
    P, _ = np.linalg.qr(rng.standard_normal((d, r)))      # shared subspace
    shifts = np.linspace(-1.0, 1.0, n_clients) * heterogeneity
    z = rng.standard_normal((n_clients, m, r)) + shifts[:, None, None]
    x = torch.from_numpy((z @ P.T).astype(np.float32))     # rank-r rows

    teacher = init_mlp_classifier(kt, d, width, classes, spectral_decay=8.0, device=cpu)
    M = rng.standard_normal((r, width)) / np.sqrt(r)
    teacher["in"] = torch.from_numpy((P @ M).astype(np.float32))
    logits = torch.stack([mlp_classifier_logits(teacher, xb) for xb in x])
    y = logits.argmax(dim=-1).numpy()
    flip = rng.random((n_clients, m)) < label_noise
    y = np.where(flip, rng.integers(0, classes, (n_clients, m)), y)

    fresh = init_mlp_classifier(ks, d, width, classes, device=cpu)
    fresh["in"] = torch.from_numpy(
        (P @ (P.T @ fresh["in"].numpy().astype(np.float64))).astype(np.float32))
    student = tree_map(lambda t, f: t * _f32(0.6) + f * _f32(0.4), teacher, fresh)
    batch = client_batch.tree_batch({"x": x.to(dev),
                                     "y": torch.from_numpy(y.astype(np.int32)).to(dev)})
    return batch, tree_map(lambda p: p.to(dev), student)


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
    (the per-leaf draws of a stochastic compressor, ``rtopk``).
    "fast+sharded" shards the clients over the ranks of a
    `torch.distributed` world (`rounds.ShardedReducer`; one process is a
    one-rank world) and ``exact`` chooses its collectives: the bitwise
    gather (default), or `BLDNNSpec.reduce_plan`, under which the Fisher
    leg reduces the compress-sum codec's local sums (kernel 2's second
    output).  ``basis`` overrides the basis built from ``params0`` (carry
    the reference's per-layer SVD factors here: they are not unique).

    Returns a `History`: ``gaps`` is the training error rate,
    ``metrics["loss"]`` the loss stream, ``legs`` the per-leg bit streams
    (gradient coefficients on ``grad_up``, the Fisher stream on
    ``hess_up``, the basis shipment on ``basis_ship``)."""
    if backend not in _BACKENDS:
        raise ValueError(f"backend must be one of {_BACKENDS}, got {backend!r}")
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
                                    seed=seed, stream=stream,
                                    sharded=backend == "fast+sharded", exact=exact)
    return batched._history(evals, leds)
