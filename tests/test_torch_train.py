"""The port's LM training path (`repro_torch.data`, `repro_torch.optim`,
`models.steps.make_train_step`, `launch.train`) against the JAX package on
the CPU.

Both sides start from the same state: the reference's
`init_params(PRNGKey(0), cfg, float32)` and `adamw_init` carried across
with `convert.params_from_numpy` / `convert.opt_state_from_numpy`, and the
tokens of the synthetic pipeline, which the port draws bitwise as the
reference does.  Everything compares in float32, where the kernels' plain
versions stand in for kernels 5 and 6 (the reference's `_blocked_attn`
rounds P to v's type, so a bfloat16 comparison would measure that).
Tolerances: AdamW 1e-6 of max|ref| per leaf; the fused cross entropy the
reference's own (`tests/test_steps.py:25-34`: value 1e-5 relative,
gradients 1e-4·max|ref| + 1e-6); the train step 1e-5 relative in the step-0
loss, 1e-4·max|ref| per gradient leaf, 1e-4 relative in the losses of
steps 1–2 (float32 sums in another order, compounded by three AdamW
steps).
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import pipeline as jpipe
from repro.models import model as JM
from repro.models.steps import make_fused_vocab_xent as j_fused
from repro.models.steps import make_train_step as j_train_step
from repro.optim import adamw as jadamw
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.data import pipeline
from repro_torch.kernels import basis_transform, tiled_matmul, topk_threshold
from repro_torch.launch import train
from repro_torch.models import convert, steps
from repro_torch.models import model as M
from repro_torch.optim import adamw

#: the reduced configs trained here: gemma3 and qwen2-vl with grouped KV
#: heads (8 over 4 and 64 over 8 at full width; the reduced config would
#: keep 4 over 4), deepseek-moe (the MoE's aux in the loss), whisper (the
#: encoder's gradients through cross-attention) and qwen2-vl (M-RoPE, and
#: the prefix's positions sliced off before the loss)
TRAIN_CFGS = {"gemma3_4b": dict(n_kv_heads=2), "mamba2_370m": {}, "deepseek_moe_16b": {},
              "whisper_small": {}, "qwen2_vl_72b": dict(n_kv_heads=2)}
B, S = 2, 32
#: the final weights after three AdamW steps: AdamW's first steps move each
#: weight by about lr·sign(gradient), so a gradient element at rounding
#: level moves its weight by ±lr in either package, and the next steps'
#: gradients follow.  Where a config has such elements (codeqwen's
#: embedding and wk, many of jamba's leaves), the reference run again from its
#: weights perturbed by CONTROL_PERTURBATION (about float32's unit
#: roundoff) moves by more than 1e-3·max|ref| itself (its embedding, in
#: codeqwen and jamba: `test_torch_train_configs.py`), and the port is held to
#: CONTROL_FACTOR times the largest of CONTROL_RUNS such controls, as phase
#: lm_sharded holds a train cell (`chip_smoke.LM_CONTROL_FACTOR`)
CONTROL_PERTURBATION, CONTROL_FACTOR, CONTROL_RUNS = 1e-7, 2.0, 4


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def rel_close(got, want, tol):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"|Δ| {err} > {tol}·max|ref| ({scale})"


def leaves(tree, prefix=""):
    """(path, leaf) pairs in sorted key order (jax.tree.map sorts dict keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    else:
        yield prefix.rstrip("/"), tree


# ----------------------------- tokens ---------------------------------------
@pytest.mark.parametrize("seed,i", [(0, 0), (0, 3), (7, 1)])
def test_tokens_are_the_references_bit_for_bit(seed, i):
    want = jpipe.SyntheticTokens(50280, 33, 3, seed).batch(i)
    got = pipeline.SyntheticTokens(50280, 33, 3, seed).batch(i)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_batch_iterator_and_extras_are_the_references(dtype):
    extras = {"frames": (2, 3, 8)}
    jit_ = jpipe.make_batch_iterator(1000, 17, 2, seed=5, extras=extras,
                                     dtype=getattr(jnp, dtype))
    it = pipeline.make_batch_iterator(1000, 17, 2, seed=5, extras=extras,
                                      dtype=getattr(torch, dtype), device="cpu")
    for _ in range(3):
        want, got = next(jit_), next(it)
        assert got["tokens"].dtype == torch.int32
        np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
        assert got["frames"].dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got["frames"].float().numpy(),
                                      np.asarray(want["frames"], np.float32))


# ----------------------------- optimizers -----------------------------------
def _opt_problem(seed):
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((6, 5)).astype(np.float32),
              "blk": {"a": rng.standard_normal(7).astype(np.float32),
                      "b": rng.standard_normal((2, 3, 4)).astype(np.float32)}}
    grads = [jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.1).astype(np.float32),
                          params) for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("state", ["float32", "bfloat16"])
@pytest.mark.parametrize("opt", ["adamw", "sgdm"])
def test_optimizer_steps_match_the_reference(opt, state):
    params, grads = _opt_problem(3)
    jinit, jupd = ((jadamw.adamw_init, jadamw.adamw_update) if opt == "adamw"
                   else (jadamw.sgdm_init, jadamw.sgdm_update))
    upd = adamw.adamw_update if opt == "adamw" else adamw.sgdm_update
    jp = jax.tree.map(jnp.asarray, params)
    jo = jinit(jp, getattr(jnp, state))
    tp = convert.params_from_numpy(params, device="cpu")
    to = convert.opt_state_from_numpy(jax.tree.map(np.asarray, jo), device="cpu")
    leaf = tp["w"]
    for g in grads:
        jp, jo = jupd(jax.tree.map(jnp.asarray, g), jo, jp)
        tp, to = upd(convert.params_from_numpy(g, device="cpu"), to, tp)
    assert tp["w"] is leaf          # updated in place, as the train step needs
    assert int(to["step"]) == int(jo["step"]) == 3
    for (name, got), (_, want) in zip(leaves(tp), leaves(jax.tree.map(np.asarray, jp))):
        rel_close(got, want, 1e-6)
    state_keys = ("m", "v") if opt == "adamw" else ("mom",)
    for key in state_keys:
        for (_, got), (_, want) in zip(leaves(to[key]),
                                       leaves(jax.tree.map(np.asarray, jo[key]))):
            assert got.dtype == getattr(torch, state)
            rel_close(got, want, 1e-6)


def test_adamw_slices_change_no_bit(monkeypatch):
    """A leaf larger than `SLICE` is updated a slice at a time: the same bits
    as in one piece."""
    params, grads = _opt_problem(5)
    outs = []
    for size in (adamw.SLICE, 7):
        monkeypatch.setattr(adamw, "SLICE", size)
        p = convert.params_from_numpy(params, device="cpu")
        o = adamw.adamw_init(p, torch.bfloat16)
        for g in grads:
            p, o = adamw.adamw_update(convert.params_from_numpy(g, device="cpu"), o, p)
        outs.append({"params": p, "state": o})
    for (_, a), (_, b) in zip(leaves(outs[0]), leaves(outs[1])):
        assert torch.equal(a, b)


# ----------------------------- fused cross entropy --------------------------
@pytest.mark.parametrize("arch", ["granite_20b", "mamba2_370m"])
def test_fused_cross_entropy_matches_the_reference(arch):
    """granite's reduced vocabulary fills its padding; mamba2's (50,280 in
    50,432 slots) does not, so its −1e30 padding mask is exercised."""
    jcfg, cfg = jconfigs.get_config(arch).reduced(), configs.get_config(arch).reduced()
    rng = np.random.default_rng(4)
    h = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    W = (rng.standard_normal((cfg.d_model, cfg.padded_vocab)) * 0.05).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    jx = j_fused(jcfg, None)
    want, (wdh, wdW) = jax.value_and_grad(jx, argnums=(0, 1))(jnp.asarray(h), jnp.asarray(W),
                                                                jnp.asarray(labels))
    th, tW = torch.tensor(h, requires_grad=True), torch.tensor(W, requires_grad=True)
    got = steps.make_fused_vocab_xent(cfg)(th, tW, torch.tensor(labels))
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in ((th.grad, wdh), (tW.grad, wdW)):
        w = np.asarray(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max() + 1e-6
    if cfg.padded_vocab != cfg.vocab_size:
        assert float(tW.grad[:, cfg.vocab_size:].abs().max()) < 1e-12
    # the plain cross entropy of the same logits, as the reference's test holds
    plain = steps._xent(torch.tensor(h) @ torch.tensor(W)
                        + torch.where(torch.arange(cfg.padded_vocab) >= cfg.vocab_size,
                                      -1e30, 0.0), torch.tensor(labels))
    np.testing.assert_allclose(float(plain), float(got.detach()), rtol=1e-5)


# ----------------------------- the train step -------------------------------
def _ref_loss_fn(jcfg):
    """The reference's train loss (`steps.make_train_step`'s `loss_fn`):
    (loss, aux)."""
    xent = j_fused(jcfg, None)

    def loss_fn(params, batch):
        toks = batch["tokens"]
        h, _, aux = JM.forward(params, jcfg, None, toks[:, :-1], remat=False,
                               return_hidden=True, frames=batch.get("frames"),
                               prefix_embeds=batch.get("prefix_embeds"))
        h = h[:, jcfg.n_prefix_embeds:, :]
        W = params["embed"].T if jcfg.tie_embeddings else params["unembed"]
        return xent(h, W, toks[:, 1:]) + aux, aux

    return loss_fn


@pytest.fixture(scope="module")
def chip_smoke():
    """The card's smoke script, imported from the repo's root: its helpers
    for the reduced LM configs are shared with these tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(pathlib.Path(__file__).resolve().parents[1]))
        import chip_smoke
    return chip_smoke


def reference_run(arch, overrides, chip_smoke, control=False):
    """The reference's step-0 loss, aux and gradients and three jitted train
    steps of the reduced `arch` (with `overrides`), and what the port needs
    to run the same: the weights, batches and stub inputs; for a MoE config
    also the reference's step with two microbatches (the capacity follows
    the microbatch's token count).  With `control`, also the reference's
    own three steps from its weights perturbed by CONTROL_PERTURBATION
    (relative), CONTROL_RUNS times: each leaf's largest distance from the
    unperturbed final weights, over max|ref|."""
    jcfg = jconfigs.get_config(arch).reduced(**overrides)
    cfg = configs.get_config(arch).reduced(**overrides)
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    gen = pipeline.SyntheticTokens(cfg.vocab_size, S + 1, B, seed=3)
    batches = [{"tokens": gen.batch(i), **chip_smoke.reduced_extras(cfg, B, 50 + i)}
               for i in range(3)]
    jb = [jax.tree.map(jnp.asarray, b) for b in batches]
    (loss0, aux0), grads0 = jax.jit(jax.value_and_grad(_ref_loss_fn(jcfg), has_aux=True))(
        params, jb[0])
    jstep = jax.jit(j_train_step(jcfg, None, remat=False))
    jp, jo, jlosses = params, jadamw.adamw_init(params), []
    for b in jb:
        jp, jo, m = jstep(jp, jo, b)
        jlosses.append(float(m["loss"]))
    final = jax.tree.map(np.asarray, jp)
    final_control = None
    if control:
        # each leaf's largest distance over CONTROL_RUNS perturbed runs
        final_control = {}
        for seed in range(1, CONTROL_RUNS + 1):
            rng = np.random.default_rng(seed)
            jp = jax.tree.map(lambda a: jnp.asarray((np.asarray(a, np.float64) * (
                1 + CONTROL_PERTURBATION * rng.standard_normal(a.shape))).astype(np.float32)),
                params)
            jo = jadamw.adamw_init(jp)
            for b in jb:
                jp, jo, _ = jstep(jp, jo, b)
            for (name, a), (_, w) in zip(leaves(jp), leaves(final)):
                d = float(np.abs(np.asarray(a) - w).max() / np.abs(w).max())
                final_control[name] = max(final_control.get(name, 0.0), d)
    mb = None
    if jcfg.moe is not None:
        mp, _, m = jax.jit(j_train_step(jcfg, None, remat=False, microbatch=2))(
            params, jadamw.adamw_init(params), jb[0])
        mb = dict(loss=float(m["loss"]), params=jax.tree.map(np.asarray, mp))
    np_params = jax.tree.map(np.asarray, params)
    return dict(arch=arch, cfg=cfg, np_params=np_params, batches=batches, loss0=float(loss0),
                aux0=float(aux0), grads0=jax.tree.map(np.asarray, grads0), losses=jlosses,
                final=final, final_control=final_control, microbatch_ref=mb)


@pytest.fixture(scope="module", params=list(TRAIN_CFGS))
def trained(request, chip_smoke):
    """`reference_run` of each config of TRAIN_CFGS."""
    return reference_run(request.param, TRAIN_CFGS[request.param], chip_smoke)


def _batch(trained, i):
    return {k: torch.tensor(v) for k, v in trained["batches"][i].items()}


def _port_run(trained, steps_=3, remat=False, microbatch=1):
    cfg = trained["cfg"]
    params = convert.params_from_numpy(trained["np_params"], device="cpu")
    opt = adamw.adamw_init(params)
    step = steps.make_train_step(cfg, remat=remat, microbatch=microbatch)
    losses = []
    for i in range(steps_):
        params, opt, m = step(params, opt, _batch(trained, i))
        losses.append(float(m["loss"]))
    return params, losses


def test_step0_loss_and_every_gradient_leaf_match_the_reference(trained):
    params = convert.params_from_numpy(trained["np_params"], device="cpu")
    loss, aux, grads = steps.make_grad_fn(trained["cfg"], remat=False)(
        params, _batch(trained, 0))
    if trained["cfg"].moe is None:
        assert float(aux) == trained["aux0"] == 0.0
    else:
        assert trained["aux0"] > 0
        np.testing.assert_allclose(float(aux), trained["aux0"], rtol=1e-5)
    np.testing.assert_allclose(float(loss), trained["loss0"], rtol=1e-5)
    want = dict(leaves(trained["grads0"]))
    got = dict(leaves(grads))
    assert got.keys() == want.keys()
    for name in want:
        assert got[name].dtype == torch.float32
        rel_close(got[name], want[name], 1e-4)


def test_three_train_steps_match_the_reference(trained):
    params, losses = _port_run(trained)
    np.testing.assert_allclose(losses[0], trained["losses"][0], rtol=1e-5)
    np.testing.assert_allclose(losses[1:], trained["losses"][1:], rtol=1e-4)
    assert losses[2] < losses[0]
    control = trained["final_control"]
    for (name, got), (_, want) in zip(leaves(params), leaves(trained["final"])):
        rel_close(got, want, 1e-3 if control is None else max(
            1e-3, CONTROL_FACTOR * control[name]))


def test_remat_is_bitwise_the_plain_forward(trained):
    """Recomputing each group in the backward (torch.utils.checkpoint) runs
    the same operations: gradients and the updated weights are equal bit for
    bit on the CPU."""
    batch = _batch(trained, 0)
    p = convert.params_from_numpy(trained["np_params"], device="cpu")
    _, _, g0 = steps.make_grad_fn(trained["cfg"], remat=False)(p, batch)
    _, _, g1 = steps.make_grad_fn(trained["cfg"], remat=True)(p, batch)
    for (_, a), (_, b) in zip(leaves(g0), leaves(g1)):
        assert torch.equal(a, b)
    p0, l0 = _port_run(trained, steps_=2, remat=False)
    p1, l1 = _port_run(trained, steps_=2, remat=True)
    assert l0 == l1
    for (_, a), (_, b) in zip(leaves(p0), leaves(p1)):
        assert torch.equal(a, b)


def wrapper_calls(cfg, remat, monkeypatch, chip_smoke):
    """The calls one gradient of `cfg` makes at the kernels' wrappers
    (`kernels.ops.attention` and `ops.ssd`, forward and backward), on its
    weights of PRNGKey(0) and one 16-token sequence."""
    from repro_torch.kernels import ops

    calls = dict.fromkeys(("flash_attention", "flash_attention_bwd", "ssd_scan",
                           "ssd_scan_bwd"), 0)

    class Backward(torch.autograd.Function):
        @staticmethod
        def forward(ctx, name, x):
            ctx.name = name
            return x.view_as(x)

        @staticmethod
        def backward(ctx, g):
            calls[f"{ctx.name}_bwd"] += 1
            return None, g

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            out = fn(*args, **kwargs)
            if isinstance(out, tuple):
                return (Backward.apply(name, out[0]),) + out[1:]
            return Backward.apply(name, out)
        return wrapper

    monkeypatch.setattr(ops, "attention", counted("flash_attention", ops.attention))
    monkeypatch.setattr(ops, "ssd", counted("ssd_scan", ops.ssd))
    params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu")
    batch = {"tokens": torch.zeros((1, 17), dtype=torch.int32),
             **{k: torch.tensor(v) for k, v in chip_smoke.reduced_extras(cfg, 1).items()}}
    steps.make_grad_fn(cfg, remat=remat)(params, batch)
    return calls


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", list(TRAIN_CFGS))
def test_kernel_calls_of_a_train_step(arch, remat, monkeypatch, chip_smoke):
    """The kernel calls `chip_smoke.train_launches` holds the card's train
    path to, counted here at the wrappers over one gradient: kernel 5 once a
    forward for each encoder layer, and for each decoder attention and
    cross-attention layer once, or twice under remat (the group again in
    the backward); kernel 6 likewise for each Mamba2 layer; each layer's
    backward once."""
    cfg = configs.get_config(arch).reduced(**TRAIN_CFGS[arch])
    assert wrapper_calls(cfg, remat, monkeypatch, chip_smoke) == chip_smoke.train_launches(
        cfg, remat)


def test_route_comparison_names_a_tie(chip_smoke):
    """`chip_smoke.compare_routes` passes equal expert ids, and names a
    token routed otherwise a tie when its two experts' probabilities are
    equal, not a tie when they are apart."""
    probs = torch.tensor([[0.5, 0.3, 0.2], [0.4, 0.4, 0.2]])
    ids = torch.tensor([[0], [0]])
    assert chip_smoke.compare_routes("t", [(probs, ids)], [(probs, ids)])["expert_ids_equal"]
    with pytest.raises(AssertionError, match=r"routes token 1 .*\(a tie"):
        chip_smoke.compare_routes("t", [(probs, torch.tensor([[0], [1]]))], [(probs, ids)])
    with pytest.raises(AssertionError, match=r"routes token 0 .*\(not a tie"):
        chip_smoke.compare_routes("t", [(probs, torch.tensor([[2], [0]]))], [(probs, ids)])


def test_microbatches_match_one_batch(trained):
    """As the reference's `tests/test_steps.py:55-69`: the same loss within
    1e-5 and weights within 1e-3 (Adam rescales the float32 ordering
    differences of the summed gradients).  A MoE config routes each
    microbatch with its own capacity and load-balance loss, so its two
    microbatches are held to the reference's two instead."""
    p2, l2 = _port_run(trained, steps_=1, microbatch=2)
    if trained["microbatch_ref"] is None:
        p1, l1 = _port_run(trained, steps_=1)
        np.testing.assert_allclose(l2, l1, rtol=1e-5)
    else:
        ref = trained["microbatch_ref"]
        np.testing.assert_allclose(l2, [ref["loss"]], rtol=1e-5)
        p1 = convert.params_from_numpy(ref["params"], device="cpu")
    assert max(float((a - b).abs().max()) for (_, a), (_, b) in zip(leaves(p1), leaves(p2))) \
        < 1e-3


# ----------------------------- the launcher ---------------------------------
@pytest.mark.parametrize("arch", list(TRAIN_CFGS))
def test_train_cli_debug_on_cpu_and_its_loss_falls(arch, capsys):
    out = train.main(["--arch", arch, "--debug", "--device", "cpu", "--steps", "3"])
    assert len(out["losses"]) == len(out["step_s"]) == 3
    assert all(np.isfinite(out["losses"])) and out["losses"][-1] < out["losses"][0]
    assert (out["batch"], out["seq_len"], out["dtype"]) == (*train.DEBUG_SIZES, "float32")
    text = capsys.readouterr().out
    assert text.count("step ") == 3 and "loss" in text and text.rstrip().endswith("done")


@pytest.mark.parametrize("arch", sorted(set(jconfigs.ARCH_IDS) - set(TRAIN_CFGS)))
def test_train_cli_debug_runs_every_other_config(arch, capsys):
    """The other five configs (granite, llama4, codeqwen, stablelm, jamba)
    train too: two finite steps each."""
    out = train.main(["--arch", arch, "--debug", "--device", "cpu", "--steps", "2"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert capsys.readouterr().out.rstrip().endswith("done")


def test_train_cli_refuses_multi_pod_naming_its_item():
    """`--multi-pod` trains on the (2, 16, 16) production mesh, whose world
    is 512 ranks: a one-rank world raises the mesh's error, naming the
    world it needs."""
    with pytest.raises(ValueError, match="needs a world of 512 ranks; this one has 1"):
        train.main(["--arch", "gemma3_4b", "--multi-pod", "--device", "cpu"])


def test_one_card_train_shapes_cut_only_the_batch():
    from repro_torch.launch import shapes

    base = shapes.SHAPES["train_4k"]
    for name, batch in (("train_4k_b1", 1), ("train_4k_b8", 8)):
        shp = shapes.SHAPES[name]
        assert dataclasses.replace(shp, name=base.name, global_batch=base.global_batch) == base
        assert shp.global_batch == batch and shp.kind == "train"


# ----------------------------- no silent loss of gradients ------------------
def _kernel_calls():
    v = torch.rand(4, 64)
    g = torch.rand(3, 6, 5)
    return {
        "topk_row_threshold": (lambda x: topk_threshold.topk_row_threshold(x, 8), v),
        "topk_compress_sum": (lambda x: topk_threshold.topk_compress_sum(x, 8), v),
        "tiled_matmul": (lambda x: tiled_matmul.matmul(x, torch.rand(64, 3)), v),
        "basis_transform": (lambda x: basis_transform.basis_transform(
            torch.rand(4, 6), x, torch.rand(5, 2)), g),
    }


@pytest.mark.parametrize("kernel", ["topk_row_threshold", "topk_compress_sum", "tiled_matmul",
                                    "basis_transform"])
def test_kernels_without_a_backward_refuse_a_gradient(kernel):
    """Kernels 1–4 have no backward (nor have the reference's): with grad
    mode on and an input that requires a gradient they raise, naming the
    kernel, before choosing a device, so a CUDA output without a grad_fn
    cannot drop a gradient silently.  Under no_grad, or on a tensor that
    needs none, they run."""
    fn, x = _kernel_calls()[kernel]
    with pytest.raises(RuntimeError, match=f"{kernel} has no backward"):
        fn(x.clone().requires_grad_(True))
    with torch.no_grad():
        fn(x.clone().requires_grad_(True))
    fn(x)
