"""The port's MoE layer (`repro_torch.models.layers.moe`, `init_moe`)
against the JAX package's global path (`repro.models.layers.moe` with no
sharding rules) on the CPU.

Both sides run the reference's weights (`init_moe(PRNGKey(s), cfg,
float32)` carried across) on seeded activations of reduced deepseek-moe
(top-2 of 4 experts and a shared expert), llama4 (top-1 and a shared
expert) and jamba (top-2, no shared expert).  Tolerance: the output, the
aux loss and every gradient within 1e-5·max|ref| (`TOL`; float32 sums in
another order).  Cases: the default capacity factor, a capacity factor
at which experts overflow and drop tokens, and a router with two
identical columns, so that equal probabilities decide which expert a
token takes (`jax.lax.top_k` takes the lower expert id first).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.models import convert
from repro_torch.models import layers as L

TOL = 1e-5
ARCHS = ("deepseek_moe_16b", "llama4_maverick_400b_a17b", "jamba_15_large_398b")
#: (case, capacity factor or None for the config's, tie the router's
#: columns 0 and 1)
CASES = (("default", None, False), ("drops", 0.5, False), ("ties", None, True))
B, S = 2, 40


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"{what}: |Δ| {err} > {tol}·max|ref| ({scale})"


def flat(tree, prefix=""):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from flat(tree[k], f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", tree[k]


def setup(arch, cf, tie, seed=0):
    jcfg = jconfigs.get_config(arch).reduced()
    cfg = configs.get_config(arch).reduced()
    if cf is not None:
        jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
    p = jax.tree.map(np.array, JL.init_moe(jax.random.PRNGKey(seed), jcfg, jnp.float32))
    if tie:
        p["router"][:, 1] = p["router"][:, 0]
    x = np.random.default_rng(seed).standard_normal((B, S, jcfg.d_model)).astype(np.float32)
    return jcfg, cfg, p, x


def routing(p, x, cfg):
    """The reference's routing on the host: (probs, expert ids, counts a
    expert, capacity)."""
    mc = cfg.moe
    probs = jax.nn.softmax(jnp.asarray(x.reshape(-1, x.shape[-1])) @ p["router"], -1)
    _, ids = jax.lax.top_k(probs, mc.top_k)
    counts = np.bincount(np.asarray(ids).ravel(), minlength=mc.n_experts)
    return np.asarray(probs), np.asarray(ids), counts, L.moe_capacity(B * S, cfg)


@pytest.mark.parametrize("case,cf,tie", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_matches_reference(arch, case, cf, tie):
    jcfg, cfg, p, x = setup(arch, cf, tie)
    probs, ids, counts, cap = routing(p, x, jcfg)
    if case == "drops":
        assert counts.max() > cap, (counts, cap)          # some tokens are dropped
    if tie:
        # some token's top-k meets an exact tie between experts 0 and 1
        assert (probs[:, 0] == probs[:, 1]).all()
        assert np.isin(ids, [0, 1]).any()
    want, want_aux = JL.moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, None)
    got, aux = L.moe(convert.params_from_numpy(p, device="cpu"), torch.tensor(x), cfg)
    close(got, want, what="out")
    assert aux.dtype == torch.float32 and aux.shape == ()
    close(aux, want_aux, what="aux")


@pytest.mark.parametrize("case,cf,tie", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_gradients_match_jax_grad(arch, case, cf, tie):
    """The gradient of c·⟨out, w⟩ + a·aux with respect to the router, the
    experts' wi, wg, wo, the shared expert and the activations, against
    jax.grad of the reference, at (c, a) = (1, 3).

    Top-1 routing (llama4): the gates renormalise to g/g ≡ 1, so the
    router's gradient through the output is zero in exact arithmetic and
    what either package returns there is the rounding of 1/g − g/g² (a few
    1e-6 here, against gradients of order 10 in the other leaves).  There
    the router is held at (c, a) = (0, 3) within TOL, each package's
    (1, 0) router gradient at rounding level (1e-6 of the largest other
    gradient), and the sum within TOL plus both roundings."""
    jcfg, cfg, p, x = setup(arch, cf, tie, seed=1)
    w = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def grads(c, a):
        def jloss(params, xx):
            out, aux = JL.moe(params, xx, jcfg, None)
            return c * jnp.sum(out * w) + a * aux

        want_p, want_x = jax.grad(jloss, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                                        jnp.asarray(x))
        tp = convert.params_from_numpy(p, device="cpu")
        leaves = dict(flat(tp))
        for t in leaves.values():
            t.requires_grad_(True)
        tx = torch.tensor(x, requires_grad=True)
        out, aux = L.moe(tp, tx, cfg)
        (c * torch.sum(out * torch.tensor(w)) + a * aux).backward()
        want = dict(flat(jax.tree.map(np.asarray, want_p)))
        want["x"] = np.asarray(want_x)
        got = {name: t.grad.numpy() for name, t in leaves.items()}
        got["x"] = tx.grad.numpy()
        return got, want

    got, want = grads(1.0, 3.0)
    assert want.keys() == got.keys()
    assert {"router", "wi", "wg", "wo"} <= set(want)
    for name, g in want.items():
        if name == "router" and cfg.moe.top_k == 1:
            continue
        close(got[name], g, what=name)
    if cfg.moe.top_k == 1:
        got_a, want_a = grads(0.0, 3.0)
        close(got_a["router"], want_a["router"], what="router, aux alone")
        got_o, want_o = grads(1.0, 0.0)
        level = 1e-6 * max(float(np.abs(g).max()) for n, g in want_o.items() if n != "router")
        noise = [float(np.abs(g["router"]).max()) for g in (got_o, want_o)]
        assert max(noise) <= level, (noise, level)
        err = float(np.abs(got["router"] - want["router"]).max())
        assert err <= TOL * float(np.abs(want["router"]).max()) + sum(noise), (err, noise)


@pytest.mark.parametrize("case,cf,tie", CASES, ids=[c[0] for c in CASES])
@pytest.mark.parametrize("arch", ARCHS)
def test_fixed_order_backward_is_autograd_of_the_gathers(arch, case, cf, tie, monkeypatch):
    """The MoE's dispatch and combine gathers (`layers._RowGather`) sum
    each token's slot gradients in a fixed order, with no index-add; every
    gradient equals autograd through plain indexing (an index-accumulate)
    within rounding (1e-6·max|ref|), with dropped tokens and router ties."""
    jcfg, cfg, p, x = setup(arch, cf, tie, seed=1)
    w = torch.tensor(np.random.default_rng(9).standard_normal(x.shape).astype(np.float32))

    def grads():
        tp = convert.params_from_numpy(p, device="cpu")
        leaves = dict(flat(tp))
        for t in leaves.values():
            t.requires_grad_(True)
        tx = torch.tensor(x, requires_grad=True)
        out, aux = L.moe(tp, tx, cfg)
        (torch.sum(out * w) + 3.0 * aux).backward()
        return {"x": tx.grad, **{name: t.grad for name, t in leaves.items()}}

    got = grads()
    with monkeypatch.context() as m:
        m.setattr(L._RowGather, "apply", staticmethod(
            lambda src, index, back: torch.cat([src, src.new_zeros((1, src.shape[1]))])[index]))
        want = grads()
    assert got.keys() == want.keys()
    for name, g in want.items():
        close(got[name], g.numpy(), tol=1e-6, what=name)


@pytest.mark.parametrize("k", [1, 2, 6])
def test_route_breaks_ties_as_lax_top_k(k):
    """Rows with many equal probabilities: the same values and expert ids
    as `jax.lax.top_k`, the lower id first among equals."""
    rng = np.random.default_rng(k)
    probs = rng.choice(np.array([0.1, 0.2, 0.3], np.float32), size=(64, 8))
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), k)
    got_v, got_i = L.moe_route(torch.tensor(probs), k)
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))


@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_is_the_references(arch):
    """``max(⌈T·K/E·cf⌉, K)`` in Python floats, as `layers.moe` computes it,
    at full width and reduced, for decode's and prefill's token counts."""
    for cfg in (configs.get_config(arch), configs.get_config(arch).reduced()):
        mc = cfg.moe
        for T in (1, 4, 80, 8192, 12345):
            want = max(int(np.ceil(T * mc.top_k / mc.n_experts * mc.capacity_factor)),
                       mc.top_k)
            assert L.moe_capacity(T, cfg) == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_moe_is_the_references(dtype):
    """Keyed `init_moe` bit for bit, the router float32 in either type."""
    jcfg = jconfigs.get_config("deepseek_moe_16b").reduced()
    cfg = configs.get_config("deepseek_moe_16b").reduced()
    with jax.threefry_partitionable(False):
        want = dict(flat(jax.tree.map(np.asarray, JL.init_moe(jax.random.PRNGKey(4), jcfg,
                                                              getattr(jnp, dtype)))))
    with prng.threefry_partitionable(False):
        got = dict(flat(L.init_moe(prng.PRNGKey(4), cfg, getattr(torch, dtype),
                                   torch.device("cpu"))))
    assert got.keys() == want.keys()
    assert got["router"].dtype == torch.float32
    for name, w in want.items():
        g = got[name]
        assert str(g.dtype) == f"torch.{w.dtype}", name
        assert g.view(torch.int16 if g.dtype == torch.bfloat16 else torch.int32).numpy() \
            .tobytes() == w.tobytes(), name


def test_bfloat16_moe_is_as_close_to_float32_as_the_references():
    """In bfloat16 (the card's serve type): the float32 router inside a
    bfloat16 tree, gates cast to bfloat16 before the product, each token's
    contributions summed in bfloat16.  The port's bfloat16 output is held
    to the reference's float32 output no further than twice the
    reference's own bfloat16 output is (the two round their bfloat16
    products' float32 sums in another order)."""
    jcfg, cfg, p, x = setup("deepseek_moe_16b", None, False, seed=2)
    want32, _ = JL.moe(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jcfg, None)
    jp = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), p)
    jp["router"] = jnp.asarray(p["router"])
    want16, _ = JL.moe(jp, jnp.asarray(x).astype(jnp.bfloat16), jcfg, None)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["router"].dtype == torch.float32 and tp["wi"].dtype == torch.bfloat16
    got, _ = L.moe(tp, torch.tensor(x).to(torch.bfloat16), cfg)
    assert got.dtype == torch.bfloat16
    ref32 = np.asarray(want32)
    ref_err = float(np.abs(np.asarray(want16, np.float32) - ref32).max())
    err = float(np.abs(got.float().numpy() - ref32).max())
    assert 0 < ref_err and err <= 2 * ref_err, (err, ref_err)
