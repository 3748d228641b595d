"""BL-DNN on a language model in the port (`examples/torch_train_lm.py
--fed`: `repro_torch.fed.bldnn.run_bldnn` with the LM's fused cross
entropy) against the JAX package's `examples/train_lm.py --fed` wiring, on
the CPU, and the autograd Functions of that path under
``torch.func.vmap(torch.func.grad(...))``.

Both sides draw the weights from ``PRNGKey(0)`` under one threefry setting
(``jax_threefry_partitionable`` False, the port's default), the batches
from the synthetic pipeline (bitwise the same), and rotate with the
reference's per-layer SVD factors, carried across (they are not unique).
Tolerances and why:

  * round 0's per-client gradients: 1e-4·max|ref| a leaf (the train
    gate: float32 sums in another order through twelve layers);
  * the loss stream over 4 rounds: 1e-4 relative (the BL-DNN gate);
  * every leg's bits and the uplink: exact (counts of the Top-K legs and
    the shipment's floats);
  * the batched cross entropy and attention against a per-client loop:
    1e-6·max|ref| (the same products, batched).
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import basis as jbasis
from repro.core.client_batch import tree_batch as j_tree_batch
from repro.data import pipeline as jpipe
from repro.fed import bldnn as jbldnn
from repro.models import model as JM
from repro.models.config import LayerSpec as JLayerSpec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.steps import make_fused_vocab_xent as j_fused
from repro_torch.core import prng
from repro_torch.core.basis import PerLayerSVDBasis
from repro_torch.core.pytree import tree_leaves
from repro_torch.data import make_batch_iterator
from repro_torch.kernels import ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.models.config import LayerSpec, ModelConfig

REPO = pathlib.Path(__file__).resolve().parents[1]
GRAD_TOL = 1e-4
LOSS_RTOL = 1e-4
BATCHED_TOL = 1e-6
ROUNDS = 4
#: the reduced LM: 2 layers, d 64, 4 query heads on 2 KV heads, vocab 256;
#: 2 clients of 2 × 17 tokens
TINY = dict(name="lm-tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
            vocab_size=256, max_seq=64)
N_CLIENTS, B, SEQ = 2, 2, 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _load(name):
    spec = importlib.util.spec_from_file_location(name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    """`examples/torch_train_lm.py`, loaded by path."""
    return _load("torch_train_lm")


@pytest.fixture(scope="module")
def chip_smoke():
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(REPO))
        import chip_smoke
    return chip_smoke


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"|Δ| {err} > {tol}·max|ref| ({scale})"


def _ref_loss_fn(cfg):
    """`examples/train_lm.py`'s ``loss_fn`` and ``eval_fn``."""
    def loss_fn(p, data):
        tokens = data["tokens"]
        h, _, aux = JM.forward(p, cfg, None, tokens[:, :-1], remat=False, return_hidden=True)
        return j_fused(cfg, None)(h, p["unembed"], tokens[:, 1:]) + aux

    def eval_fn(p, data):
        losses = jax.vmap(lambda d: loss_fn(p, d))(data)
        return {"gap": jnp.mean(losses)}
    return loss_fn, eval_fn


@pytest.fixture(scope="module")
def ref():
    """The reference's side: weights, batches and SVD factors, round 0's
    per-client gradients and a 4-round run of the script's wiring."""
    jcfg = JModelConfig(group=(JLayerSpec(),), **TINY)
    with jax.threefry_partitionable(False):
        params = JM.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    it = jpipe.make_batch_iterator(jcfg.vocab_size, SEQ + 1, B, seed=0)
    batch = j_tree_batch(jax.tree.map(lambda *bs: jnp.stack(bs),
                                      *[next(it) for _ in range(N_CLIENTS)]))
    loss_fn, eval_fn = _ref_loss_fn(jcfg)
    grads0 = jax.vmap(jax.grad(loss_fn), in_axes=(None, 0))(params, batch.data)
    jb = jbasis.make_bases("per_layer_svd", params)
    hist = jbldnn.run_bldnn(loss_fn, eval_fn, params, batch, ROUNDS,
                            jbldnn.BLDNNConfig(lr=3e-4, top_k_frac=0.05), basis=jb)
    return dict(params=jax.tree.map(np.asarray, params),
                tokens=np.asarray(batch.data["tokens"]),
                grads0=jax.tree.map(np.asarray, grads0),
                UV=[None if uv is None else (np.asarray(uv[0]), np.asarray(uv[1]))
                    for uv in jb.UV],
                hist=hist)


def _cfg():
    return ModelConfig(group=(LayerSpec(),), **TINY)


def _port_side(example):
    cfg = _cfg()
    with prng.threefry_partitionable(False):
        params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu")
    it = make_batch_iterator(cfg.vocab_size, SEQ + 1, B, seed=0, device="cpu")
    return cfg, params, example.fed_batch(it, N_CLIENTS)


def _carried_basis(ref):
    return PerLayerSVDBasis(UV=tuple(None if uv is None else (torch.tensor(uv[0]),
                                                              torch.tensor(uv[1]))
                                     for uv in ref["UV"]))


def test_weights_and_batches_are_the_references(ref, example):
    cfg, params, batch = _port_side(example)
    assert example.n_fed_clients() == N_CLIENTS
    np.testing.assert_array_equal(batch.data["tokens"].numpy(), ref["tokens"])
    got, want = tree_leaves(params), jax.tree_util.tree_leaves(ref["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)


def test_round0_per_client_gradients_match_the_reference(ref, example):
    cfg, params, batch = _port_side(example)
    loss_fn = example.make_loss_fn(cfg)
    g = torch.func.vmap(torch.func.grad(loss_fn), in_dims=(None, 0))(params, batch.data)
    got, want = tree_leaves(g), jax.tree_util.tree_leaves(ref["grads0"])
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape[0] == N_CLIENTS
        _close(a, b, GRAD_TOL)


def test_fed_run_matches_the_reference(ref, example):
    cfg, params, batch = _port_side(example)
    h = example.run_fed(cfg, params, batch, ROUNDS, 3e-4, device="cpu",
                        basis=_carried_basis(ref))
    jh = ref["hist"]
    gaps, rg = np.asarray(h.gaps), np.asarray(jh.gaps)
    assert gaps.shape == (ROUNDS,) and np.all(np.isfinite(gaps))
    np.testing.assert_allclose(gaps, rg, rtol=LOSS_RTOL, atol=0)
    assert gaps[-1] < gaps[0]
    assert list(h.up_bits) == list(jh.up_bits)
    assert list(h.down_bits) == list(jh.down_bits)
    assert sorted(h.legs) == sorted(jh.legs)
    for leg, stream in jh.legs.items():
        assert list(h.legs[leg]) == list(stream), leg
    assert h.legs["basis_ship"][0] > 0


def test_example_main_runs_both_branches_on_the_cpu(example, monkeypatch, capsys):
    """The script's ``main`` at the reduced size: the fed branch asserts its
    loss falls, the AdamW branch likewise."""
    monkeypatch.setattr(example, "make_cfg", lambda preset: _cfg())
    hist = example.main(["--fed", "--device", "cpu", "--steps", "3", "--batch", "2",
                         "--seq", "16"])
    assert len(hist.gaps) == 3
    losses = example.main(["--device", "cpu", "--steps", "6", "--batch", "2", "--seq", "16",
                           "--lr", "3e-3"])
    assert len(losses) == 6
    out = capsys.readouterr().out
    assert "final loss" in out and "Mbits/node" in out and "OK" in out


def test_example_without_device_raises_when_cuda_is_unavailable(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        example.main(["--fed", "--steps", "2"])


# --------------------------------------------------------------------------
# the fused cross entropy under vmap(grad)
# --------------------------------------------------------------------------
def _xent_inputs(vocab=200, n=3, seed=0):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.standard_normal((n, 2, 9, 16)).astype(np.float32))
    W = torch.from_numpy((rng.standard_normal((16, 256)) / 4).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, vocab, (n, 2, 9)).astype(np.int32))
    return h, W, labels


@pytest.mark.parametrize("vocab", [256, 200], ids=["vocab", "padded"])
def test_fused_xent_under_vmap_grad_is_the_per_client_loop(vocab):
    """Each client's mean is over its own B·S tokens; the batched gradients
    equal a loop over clients."""
    cfg = ModelConfig(name="x", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_ff=32,
                      vocab_size=vocab)
    xent = steps.make_fused_vocab_xent(cfg)
    h, W, labels = _xent_inputs(vocab)
    f = torch.func.grad_and_value(xent, argnums=(0, 1))
    (dh, dW), val = torch.func.vmap(f, in_dims=(0, None, 0))(h, W, labels)
    for i in range(h.shape[0]):
        (rh, rW), rv = f(h[i], W, labels[i])
        _close(val[i], rv.numpy(), BATCHED_TOL)
        _close(dh[i], rh.numpy(), BATCHED_TOL)
        _close(dW[i], rW.numpy(), BATCHED_TOL)


def _old_fused_xent(cfg):
    """The fused cross entropy as the train path ran it before it took a
    vmap rule (in-place backward), for the bitwise check below."""
    V, Vp = cfg.vocab_size, cfg.padded_vocab

    def _logits(h, W):
        lg = torch.einsum("bsd,dv->bsv", h, W).float()
        if Vp != V:
            pad = torch.arange(Vp) >= V
            lg = lg + torch.where(pad, -1e30, 0.0).to(lg.dtype)
        return lg

    class Old(torch.autograd.Function):
        @staticmethod
        def forward(ctx, h, W, labels):
            ctx.save_for_backward(h, W, labels)
            return steps._xent(_logits(h, W), labels)

        @staticmethod
        def backward(ctx, g):
            h, W, labels = ctx.saved_tensors
            dlg = torch.softmax(_logits(h, W), dim=-1)
            n = h.shape[0] * h.shape[1]
            dlg.scatter_add_(-1, labels[..., None].long(),
                             torch.full(labels.shape + (1,), -1.0, dtype=dlg.dtype))
            dlg = dlg.mul_(g / n).to(h.dtype)
            return (torch.einsum("bsv,dv->bsd", dlg, W),
                    torch.einsum("bsd,bsv->dv", h, dlg).to(W.dtype), None)
    return Old.apply


@pytest.mark.parametrize("vocab", [256, 200], ids=["vocab", "padded"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_fused_xent_train_route_is_unchanged_bitwise(vocab, dtype):
    cfg = ModelConfig(name="x", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_ff=32,
                      vocab_size=vocab)
    h, W, labels = _xent_inputs(vocab, n=1)
    h, W, labels = h[0].to(dtype), W.to(dtype), labels[0]
    outs = []
    for fn in (steps.make_fused_vocab_xent(cfg), _old_fused_xent(cfg)):
        hh, WW = h.clone().requires_grad_(True), W.clone().requires_grad_(True)
        val = fn(hh, WW, labels)
        val.backward()
        outs.append((val.detach(), hh.grad, WW.grad))
    for a, b in zip(*outs):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_fused_xent_matches_the_reference_under_vmap():
    """The batched gradients against jax.vmap(jax.grad) of the reference's
    custom_vjp (the train gate)."""
    cfg = ModelConfig(name="x", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_ff=32,
                      vocab_size=200)
    jcfg = JModelConfig(name="x", n_layers=1, d_model=16, n_heads=2, n_kv_heads=1, d_ff=32,
                        vocab_size=200)
    h, W, labels = _xent_inputs(200)
    got = torch.func.vmap(torch.func.grad(steps.make_fused_vocab_xent(cfg), argnums=(0, 1)),
                          in_dims=(0, None, 0))(h, W, labels)
    want = jax.vmap(jax.grad(j_fused(jcfg, None), argnums=(0, 1)), in_axes=(0, None, 0))(
        jnp.asarray(h.numpy()), jnp.asarray(W.numpy()), jnp.asarray(labels.numpy()))
    for a, b in zip(got, want):
        _close(a, b, GRAD_TOL)


# --------------------------------------------------------------------------
# FlashAttention's vmap rules, their launches replaced by the plain versions
# --------------------------------------------------------------------------
@pytest.fixture
def plain_launches(monkeypatch):
    """Kernel 5's and 5b's launch functions replaced by the plain versions
    (the backward by functorch's vjp of the plain version), each call
    counted as the launch would be."""
    calls = {"fwd": 0, "bwd": 0, "fwd_shapes": [], "bwd_shapes": []}

    def kernel(q, k, v, causal, window, q_pos0=0):
        assert not q.is_cuda
        calls["fwd"] += 1
        calls["fwd_shapes"].append(tuple(q.shape))
        return fa.flash_attention_plain(q, k, v, causal=causal, window=window, q_pos0=q_pos0)

    def kernel_bwd(q, k, v, do, causal, window, q_pos0=0):
        calls["bwd"] += 1
        calls["bwd_shapes"].append(tuple(q.shape))
        _, vjp = torch.func.vjp(lambda a, b, c: fa.flash_attention_plain(
            a, b, c, causal=causal, window=window, q_pos0=q_pos0), q, k, v)
        return vjp(do.to(q.dtype))

    monkeypatch.setattr(fa, "_kernel", kernel)
    monkeypatch.setattr(fa, "_kernel_bwd", kernel_bwd)
    return calls


def _attn_inputs(n=3, Bq=2, S=16, H=6, KVH=2, hd=8, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s))     # noqa: E731 (float64)
    return f(n, Bq, S, H, hd), f(n, Bq, S, KVH, hd), f(n, Bq, S, KVH, hd), f(Bq, S, H, hd)


@pytest.mark.parametrize("in_dims", [(0, 0, 0), (0, None, 0), (None, 0, 0)],
                         ids=["batched", "k_unbatched", "q_unbatched"])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 5), (False, 7)],
                         ids=["causal", "windowed", "window_only"])
def test_attention_vmap_grad_is_one_launch_for_the_fleet(plain_launches, causal, window,
                                                         in_dims):
    """vmap(grad) over 3 clients (GQA rep 3): one forward and one backward
    launch at the folded batch 3·2, and each client's gradients those of a
    loop over clients."""
    q, k, v, w = _attn_inputs()
    args = [x if d is not None else x[0] for x, d in zip((q, k, v), in_dims)]

    def loss(a, b, c):
        return (fa.FlashAttention.apply(a, b, c, causal, window, 0) * w).sum()

    got = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2)), in_dims=in_dims)(*args)
    assert plain_launches["fwd"] == 1 and plain_launches["bwd"] == 1
    assert plain_launches["fwd_shapes"] == [(6, 16, 6, 8)] == plain_launches["bwd_shapes"]

    def ref(a, b, c):
        return (fa.flash_attention_plain(a, b, c, causal=causal, window=window) * w).sum()

    for i in range(3):
        one = [x[i] if d is not None else x for x, d in zip(args, in_dims)]
        want = torch.func.grad(ref, argnums=(0, 1, 2))(*one)
        for g, r in zip(got, want):
            _close(g[i], r.numpy(), BATCHED_TOL)


def test_attention_vmap_forward_is_one_launch(plain_launches):
    """Without a gradient (the eval stream) the vmapped forward is one
    launch, its values the loop's."""
    q, k, v, _ = _attn_inputs()
    out = torch.func.vmap(lambda a, b, c: fa.FlashAttention.apply(a, b, c, True, None, 0),
                          in_dims=(1, 1, 1), out_dims=1)(q.movedim(0, 1), k.movedim(0, 1),
                                                         v.movedim(0, 1))
    assert plain_launches["fwd"] == 1 and plain_launches["bwd"] == 0
    for i in range(3):
        _close(out[:, i], fa.flash_attention_plain(q[i], k[i], v[i]).numpy(), BATCHED_TOL)


def test_attention_function_without_vmap_is_unchanged(plain_launches):
    """Plain autograd through the Function (the train path): one launch each
    way, the plain version's gradients."""
    q, k, v, w = (x[0] for x in _attn_inputs())
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    (fa.FlashAttention.apply(*leaves, True, None, 0) * w[None]).sum().backward()
    assert plain_launches["fwd"] == 1 and plain_launches["bwd"] == 1
    want = torch.func.grad(lambda a, b, c: (fa.flash_attention_plain(a, b, c) * w[None]).sum(),
                           argnums=(0, 1, 2))(q, k, v)
    for x, r in zip(leaves, want):
        _close(x.grad, r.numpy(), BATCHED_TOL)


def test_attention_backward_function_refuses_a_second_order(plain_launches):
    q, k, v, w = (x[0] for x in _attn_inputs())
    with pytest.raises(RuntimeError, match="no backward"):
        torch.func.grad(lambda a: torch.func.grad(
            lambda b: (fa.FlashAttention.apply(b, k, v, True, None, 0) * w).sum())(a).sum())(q)


# --------------------------------------------------------------------------
# the launches of a round, at the wrappers
# --------------------------------------------------------------------------
def _count_wrappers(monkeypatch, plain_launches):
    """Calls of the wrappers of kernels 1, 2 and 4 at their call sites, and
    kernel 5/5b's launches through the Functions (CPU tensors forced onto the
    Function route, its launches the plain versions)."""
    from repro_torch.core import basis as tbasis
    from repro_torch.core import compressors

    calls = {"topk_row_threshold": 0, "topk_compress_sum": 0, "basis_transform": 0}

    def counted(mod, name, key):
        fn = getattr(mod, name)

        def wrapper(*a, **kw):
            calls[key] += 1
            return fn(*a, **kw)
        monkeypatch.setattr(mod, name, wrapper)

    counted(compressors, "topk_row_threshold", "topk_row_threshold")
    counted(compressors, "topk_compress_sum", "topk_compress_sum")
    counted(tbasis, "basis_transform", "basis_transform")
    monkeypatch.setattr(tbasis, "_two_sided", lambda A, g, Bm: (
        tbasis.basis_transform(A, g.contiguous(), Bm.contiguous()) if g.dim() == 3
        else A @ g @ Bm))

    def on_function(q, k, v, *, causal=True, window=None, q_pos0=0):
        return fa.FlashAttention.apply(q, k, v, causal, window, q_pos0)
    monkeypatch.setattr(ops, "flash_attention", on_function)
    return calls


def test_fed_lm_launches_are_the_wrappers_calls(monkeypatch, plain_launches, example,
                                                chip_smoke):
    """`chip_smoke.fed_lm_launches` against the wrappers' calls over a
    4-round run of the reduced LM: kernels 1 and 2 once a leaf a round,
    kernel 4 once a rotated leaf a round, kernel 5 once a layer a round for
    the gradient and once a layer a round for the eval stream, 5b once a
    layer a round."""
    calls = _count_wrappers(monkeypatch, plain_launches)
    cfg, params, batch = _port_side(example)
    example.run_fed(cfg, params, batch, ROUNDS, 3e-4, device="cpu")
    want = chip_smoke.fed_lm_launches(cfg, ROUNDS)
    assert calls["topk_row_threshold"] == want["topk_row_threshold"]
    assert calls["topk_compress_sum"] == want["topk_compress_sum"]
    assert calls["basis_transform"] == want["basis_transform"]
    assert plain_launches["fwd"] == want["flash_attention"]
    assert plain_launches["bwd"] == want["flash_attention_bwd"]
    assert set(plain_launches["fwd_shapes"]) == {(N_CLIENTS * B, SEQ, 4, 16)}
    assert set(want) == {"topk_row_threshold", "topk_compress_sum", "basis_transform",
                         "flash_attention", "flash_attention_bwd"}


def test_fed_lm_bits_are_the_runs_streams(example, chip_smoke):
    """`chip_smoke.fed_lm_bits` (the legs priced from the leaves' shapes)
    against a run's streams; at lm-100m the shipment is the 2,149,843,232
    floats of its four rotated leaves' factors."""
    cfg, params, batch = _port_side(example)
    h = example.run_fed(cfg, params, batch, ROUNDS, 3e-4, device="cpu")
    chip_smoke.check_fed_bits("lm-tiny", h, chip_smoke.fed_lm_bits(cfg, ROUNDS))
    full = example.make_cfg("100m")
    bits = chip_smoke.fed_lm_bits(full, ROUNDS)
    assert bits["basis_ship"] == [2_149_843_232 * 32.0] * ROUNDS
    assert chip_smoke.fed_lm_launches(full, 1) == {
        "topk_row_threshold": 12, "topk_compress_sum": 12, "basis_transform": 4,
        "flash_attention": 24, "flash_attention_bwd": 12}
    with pytest.raises(AssertionError, match="bit streams"):
        chip_smoke.check_fed_bits("lm-tiny", h, chip_smoke.fed_lm_bits(cfg, ROUNDS, 0.1))
