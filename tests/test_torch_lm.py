"""The port's LM serving path (`repro_torch.models`, `repro_torch.configs`,
`repro_torch.launch`) against the JAX package on the CPU.

Both sides compute with the same weights: the reference's
`init_params(PRNGKey(s), cfg, float32)` carried across with
`convert.params_from_numpy` (the port's own draws cannot be `jax.random`'s
until ROADMAP.md §1 item 9).  Modules and whole models run on reduced
configs in float32, where the kernels' plain versions stand in for kernels
5 and 6.  Tolerance: |port − ref| ≤ 2e-4·max|ref| (`TOL`), the bound the
card's check holds the kernels' path to; the measured errors are 1e-6 to
1e-5 of max|ref| (float32 rounding in another order).  Greedy tokens must
be equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import shapes as jshapes
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.config import LayerSpec as JLayerSpec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.steps import make_prefill_step as j_prefill
from repro.models.steps import make_serve_step as j_serve
from repro_torch import configs
from repro_torch.launch import serve, shapes
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.models.config import LayerSpec, ModelConfig

TOL = 2e-4
#: the reduced serve configs: gemma3 with grouped KV heads (8 query heads
#: over 4 at full width; the reduced config would keep 4 over 4)
SERVE_CFGS = {"gemma3_4b": dict(n_kv_heads=2), "mamba2_370m": {}}


def close(got, want, tol=TOL):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"|Δ| {err} > {tol}·max|ref| ({scale})"


def close_tree(got: dict, want: dict, tol=TOL):
    assert got.keys() == want.keys()
    for k in want:
        if isinstance(want[k], dict):
            close_tree(got[k], want[k], tol)
        else:
            close(got[k], want[k], tol)


def tree_to_numpy(tree) -> dict:
    """A port tree as numpy arrays (bfloat16 through float32)."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def carry(tree):
    return convert.params_from_numpy(jax.tree.map(np.asarray, tree), device="cpu")


def both_cfgs(arch, **overrides):
    return (jconfigs.get_config(arch).reduced(**overrides),
            configs.get_config(arch).reduced(**overrides))


# ----------------------------- configs and shapes ---------------------------
def test_registry_is_the_references():
    assert configs.ARCH_IDS == jconfigs.ARCH_IDS
    assert configs.ALIASES == jconfigs.ALIASES


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_config_is_the_references(arch):
    want = jconfigs.get_config(arch)
    got = configs.get_config(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(got.reduced()) == dataclasses.asdict(want.reduced())
    assert (got.hd, got.padded_vocab, got.n_groups) == (want.hd, want.padded_vocab,
                                                        want.n_groups)
    for name, shp in jshapes.SHAPES.items():
        assert dataclasses.asdict(shapes.SHAPES[name]) == dataclasses.asdict(shp)
        assert shapes.shape_applicable(got, shapes.SHAPES[name]) == \
            jshapes.shape_applicable(want, shp)


def test_one_card_serve_shapes():
    """Beside the reference's four shapes, only the one-card serve shapes."""
    assert set(shapes.SHAPES) - set(jshapes.SHAPES) == {"decode_4k_b4", "decode_4k_b8"}
    assert serve.sizes(shapes.SHAPES["decode_4k_b4"]) == (4, 2048, 4096)
    assert serve.sizes(shapes.SHAPES["decode_4k_b8"]) == (8, 2048, 4096)
    assert serve.sizes(shapes.SHAPES["decode_32k"]) == (128, 16384, 32768)


@pytest.mark.parametrize("arch,count", [("gemma3_4b", 3_879_907_840),
                                        ("mamba2_370m", 420_025_856)])
def test_full_width_parameter_shapes_are_the_references(arch, count):
    cfg = configs.get_config(arch)
    got = M.param_shapes(cfg, torch.bfloat16)
    want = JM.param_shapes(jconfigs.get_config(arch), jnp.bfloat16)
    flat_got = {k: v for k, v in _flatten(got)}
    flat_want = {k: v for k, v in _flatten(want)}
    assert flat_got.keys() == flat_want.keys()
    for k, w in flat_want.items():
        assert tuple(flat_got[k].shape) == tuple(w.shape), k
        assert str(flat_got[k].dtype).split(".")[-1] == str(w.dtype), k
    assert M.count_params(got) == count
    cache = JM.cache_shapes(jconfigs.get_config(arch), 1, 16, jnp.bfloat16)
    tcache = M.init_cache(cfg, 1, 16, torch.bfloat16, device="cpu")
    for (k, w), (k2, g) in zip(sorted(_flatten(cache)), sorted(_flatten(tcache))):
        assert k == k2 and tuple(g.shape) == tuple(w.shape), k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k


def _flatten(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def test_init_params_draws_from_the_generator_at_the_references_scales():
    jcfg, cfg = both_cfgs("mamba2_370m")
    p1 = M.init_params(cfg, torch.float32, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    p2 = M.init_params(cfg, torch.float32, generator=torch.Generator().manual_seed(3),
                       device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flatten(p1), _flatten(p2)))
    ref = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32))
    m, mr = p1["layers"]["l0"]["mamba"], ref["layers"]["l0"]["mamba"]
    for leaf in ("A_log", "D", "dt_bias"):       # deterministic leaves (log to an ulp)
        np.testing.assert_allclose(m[leaf].numpy(), mr[leaf], rtol=2e-7, atol=0)
    # random leaves: the reference's scale (std) within sampling error
    for leaf in ("in_proj", "conv_w", "out_proj"):
        assert abs(float(m[leaf].std()) / float(mr[leaf].std()) - 1) < 0.05, leaf


# ----------------------------- single modules -------------------------------
def test_rmsnorm():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = JL.rmsnorm({"scale": jnp.asarray(scale)}, jnp.asarray(x), 1e-6)
    close(L.rmsnorm({"scale": torch.tensor(scale)}, torch.tensor(x), 1e-6), want)


@pytest.mark.parametrize("theta,offset", [(10_000.0, 0), (1_000_000.0, 37)])
def test_apply_rope_rotate_half(theta, offset):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 16, 4, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(16, dtype=np.int32) + offset, (2, 16))
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, False)
    close(L.apply_rope(torch.tensor(x), torch.tensor(pos), theta), want)
    close(L.rope_freqs(64, theta), JL.rope_freqs(64, theta))


@pytest.mark.parametrize("gated", [True, False], ids=["swiglu", "gelu"])
def test_mlp(gated):
    p = JL.init_mlp(jax.random.PRNGKey(2), 32, 96, gated, jnp.float32)
    x = np.random.default_rng(2).standard_normal((2, 7, 32)).astype(np.float32)
    want = JL.mlp(p, jnp.asarray(x), gated, None)
    close(L.mlp(carry(p), torch.tensor(x), gated), want)


def _attn_setup(window, seed=0, S=32):
    cfg_kw = dict(name="attn-test", n_layers=1, d_model=64, n_heads=4, n_kv_heads=2,
                  head_dim=32, d_ff=128, vocab_size=97,
                  group=(JLayerSpec(window=window),), rope_theta=10_000.0)
    jcfg = JModelConfig(**cfg_kw)
    cfg = ModelConfig(**{**cfg_kw, "group": (LayerSpec(window=window),)})
    p = JL.init_attention(jax.random.PRNGKey(seed), jcfg, jnp.float32)
    x = np.random.default_rng(seed).standard_normal((2, S, 64)).astype(np.float32)
    return jcfg, cfg, p, carry(p), x


@pytest.mark.parametrize("window", [None, 8])
def test_attention_train(window):
    jcfg, cfg, jp, tp, x = _attn_setup(window)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, None, jnp.asarray(pos), window=window)
    got, cache = L.attention(tp, torch.tensor(x), cfg, torch.tensor(pos), window=window)
    assert cache is None
    close(got, want)


@pytest.mark.parametrize("window,Sc", [(None, 48), (8, 8)], ids=["full", "ring"])
def test_attention_prefill_then_decode(window, Sc):
    """Prefill 32 tokens (into a full cache at 0, or the last 8 into a ring),
    then decode 12 tokens past the ring's wrap-around."""
    jcfg, cfg, jp, tp, x = _attn_setup(window, seed=1, S=44)
    K = np.zeros((2, Sc, 2, 32), np.float32)
    jcache = (jnp.asarray(K), jnp.asarray(K))
    tcache = (torch.tensor(K), torch.tensor(K))
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    want, jcache = JL.attention(jp, jnp.asarray(x[:, :32]), jcfg, None, jnp.asarray(pos),
                                window=window, cache=jcache, cache_pos=jnp.asarray(0))
    got, tcache = L.attention(tp, torch.tensor(x[:, :32]), cfg, torch.tensor(pos),
                              window=window, cache=tcache, cache_pos=0)
    close(got, want)
    close(tcache[0], jcache[0])
    close(tcache[1], jcache[1])
    for t in range(32, 44):
        p1 = np.full((2, 1), t, np.int32)
        want, jcache = JL.attention(jp, jnp.asarray(x[:, t:t + 1]), jcfg, None,
                                    jnp.asarray(p1), window=window, cache=jcache,
                                    cache_pos=jnp.asarray(t))
        got, tcache = L.attention(tp, torch.tensor(x[:, t:t + 1]), cfg, torch.tensor(p1),
                                  window=window, cache=tcache, cache_pos=t)
        close(got, want)
    close(tcache[0], jcache[0])


def test_attention_non_causal():
    jcfg, cfg, jp, tp, x = _attn_setup(None, seed=2)
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    want, _ = JL.attention(jp, jnp.asarray(x), jcfg, None, jnp.asarray(pos), causal=False)
    got, _ = L.attention(tp, torch.tensor(x), cfg, torch.tensor(pos), causal=False)
    close(got, want)


def test_attention_window_needs_causal():
    _, cfg, _, tp, x = _attn_setup(8)
    pos = torch.arange(32)[None].expand(2, 32)
    with pytest.raises(ValueError, match="causal attention only"):
        L.attention(tp, torch.tensor(x), cfg, pos, window=8, causal=False)


def test_attention_prefill_longer_than_the_ring_must_be_a_multiple():
    _, cfg, _, tp, x = _attn_setup(8, S=12)
    K = torch.zeros((2, 8, 2, 32))
    with pytest.raises(ValueError, match="multiple"):
        L.attention(tp, torch.tensor(x), cfg, torch.arange(12)[None].expand(2, 12),
                    window=8, cache=(K, K.clone()), cache_pos=0)


def test_mamba_prefill_decode_and_cache():
    jcfg, cfg = both_cfgs("mamba2_370m")
    jp = JL.init_mamba(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = carry(jp)
    x = np.random.default_rng(4).standard_normal((2, 36, jcfg.d_model)).astype(np.float32)
    # full sequence, no cache
    want, _ = JL.mamba(jp, jnp.asarray(x[:, :32]), jcfg, None)
    got, nc = L.mamba(tp, torch.tensor(x[:, :32]), cfg)
    assert nc is None
    close(got, want)
    # prefill into a cache, then four one-token steps
    conv_dim = jcfg.d_inner + 2 * jcfg.ssm.d_state
    jcache = {"conv": jnp.zeros((2, 3, conv_dim)),
              "ssm": jnp.zeros((2, jcfg.n_ssm_heads, 32, 16))}
    tcache = convert.cache_from_numpy(jax.tree.map(np.asarray, jcache), device="cpu")
    want, jcache = JL.mamba(jp, jnp.asarray(x[:, :32]), jcfg, None, cache=jcache)
    got, tcache = L.mamba(tp, torch.tensor(x[:, :32]), cfg, cache=tcache)
    close(got, want)
    close_tree(tcache, jcache)
    for t in range(32, 36):
        want, jcache = JL.mamba(jp, jnp.asarray(x[:, t:t + 1]), jcfg, None, cache=jcache)
        got, tcache = L.mamba(tp, torch.tensor(x[:, t:t + 1]), cfg, cache=tcache)
        close(got, want)
    close_tree(tcache, jcache)
    assert tcache["ssm"].dtype == torch.float32


# ----------------------------- whole model ----------------------------------
@pytest.fixture(scope="module", params=list(SERVE_CFGS))
def serve_ref(request):
    """Reference run of a reduced config: full forward over 32 tokens (the
    SSD needs whole chunks), then prefill 32 + 8 greedy decode steps
    (B = 2), with its weights."""
    arch = request.param
    jcfg, cfg = both_cfgs(arch, **SERVE_CFGS[arch])
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    full, _, _ = JM.forward(params, jcfg, None, jnp.asarray(toks), remat=False)
    cache = JM.init_cache(jcfg, 2, 96, jnp.float32)
    logits, cache = jax.jit(j_prefill(jcfg, None))(params, {"tokens": jnp.asarray(toks)},
                                                   cache)
    step = jax.jit(j_serve(jcfg, None))
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    tokens, caches = [np.asarray(tok)], []
    for t in range(8):
        tok, cache = step(params, {"tokens": tok[:, None]}, cache, jnp.asarray(32 + t, jnp.int32))
        tokens.append(np.asarray(tok))
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, params=params, tp=carry(params), toks=toks,
                full=np.asarray(full), prefill=np.asarray(logits),
                tokens=np.stack(tokens, 1), cache=jax.tree.map(np.asarray, cache))


def test_forward_matches_reference(serve_ref):
    r = serve_ref
    logits, cache, aux = M.forward(r["tp"], r["cfg"], torch.as_tensor(r["toks"]))
    assert cache is None and float(aux) == 0.0
    close(logits, r["full"])


def test_prefill_and_greedy_decode_match_reference(serve_ref):
    """Prefill 32 + 8 greedy steps: logits within TOL, tokens equal, and the
    cache leaf by leaf."""
    r = serve_ref
    cache = M.init_cache(r["cfg"], 2, 96, torch.float32, device="cpu")
    out = serve.generate(r["tp"], r["cfg"], torch.as_tensor(r["toks"]), cache, 8)
    close(out["prefill_logits"], r["prefill"])
    np.testing.assert_array_equal(out["tokens"].numpy(), r["tokens"])
    assert out["tokens"].dtype == torch.int32
    close_tree(tree_to_numpy(out["cache"]), r["cache"])
    assert all(torch.isfinite(lg).all() for lg in out["step_logits"])


def test_decode_after_prefill_matches_full_forward(serve_ref):
    """Decode with the cache reproduces the full forward's last logits
    (reference `test_arch_smoke.py:87-122`)."""
    r = serve_ref
    toks = torch.as_tensor(r["toks"][:1, :9])
    full, _, _ = M.forward(r["tp"], r["cfg"], toks)
    cache = M.init_cache(r["cfg"], 1, 16, torch.float32, device="cpu")
    _, cache = steps.make_prefill_step(r["cfg"])(r["tp"], {"tokens": toks[:, :8]}, cache)
    dec, _, _ = M.forward(r["tp"], r["cfg"], toks[:, 8:9], cache=cache, cache_pos=8)
    close(dec[0, 0], full[0, -1].detach())


def test_ring_cache_matches_window_mask():
    """Ring cache decode == full forward with the window mask, past the
    ring's wrap-around (reference `test_arch_smoke.py:124`); the padded
    vocabulary (97 → 256) scores −1e30."""
    kw = dict(name="win-test", n_layers=2, d_model=64, n_heads=2, n_kv_heads=2,
              head_dim=32, d_ff=128, vocab_size=97, max_seq=64)
    jcfg = JModelConfig(**kw, group=(JLayerSpec(window=4),))
    cfg = ModelConfig(**kw, group=(LayerSpec(window=4),))
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tp = carry(params)
    toks = np.random.default_rng(0).integers(0, 97, (1, 13)).astype(np.int32)
    want, _, _ = JM.forward(params, jcfg, None, jnp.asarray(toks), remat=False)
    full, _, _ = M.forward(tp, cfg, torch.as_tensor(toks))
    close(full, want)
    assert bool((full[..., 97:] == -1e30).all())
    cache = M.init_cache(cfg, 1, 8, torch.float32, device="cpu")
    assert cache["l0"]["k"].shape[2] == 4
    _, cache = steps.make_prefill_step(cfg)(tp, {"tokens": torch.as_tensor(toks[:, :8])}, cache)
    outs = []
    for t in range(8, 13):
        lg, cache, _ = M.forward(tp, cfg, torch.as_tensor(toks[:, t:t + 1]), cache=cache,
                                 cache_pos=t)
        outs.append(lg[0, 0, :97])
    close(torch.stack(outs), full[0, 8:, :97].detach())


# ----------------------------- launcher and error paths ---------------------
@pytest.mark.parametrize("arch", ["gemma3_4b", "mamba2_370m"])
def test_serve_cli_debug_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--debug", "--device", "cpu", "--gen", "3"])
    assert out["tokens"].shape == (4, 4)
    vocab = configs.get_config(arch).reduced().vocab_size
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < vocab)).all())
    assert torch.isfinite(out["prefill_logits"]).all()
    text = capsys.readouterr().out
    assert "prefill 4×32" in text and "done" in text


@pytest.mark.parametrize("arch,what", [("deepseek_moe_16b", "MoE"),
                                       ("whisper_small", "encoder"),
                                       ("qwen2_vl_72b", "M-RoPE"),
                                       ("jamba_15_large_398b", "MoE")])
def test_unported_model_parts_raise_naming_their_item(arch, what):
    cfg = configs.get_config(arch).reduced()
    with pytest.raises(NotImplementedError, match=f"{what}.*item 18"):
        M.init_params(cfg, torch.float32, generator=None, device="cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        M.forward({}, cfg, torch.zeros((1, 4), dtype=torch.int32))


def test_unported_entry_points_raise_naming_their_item():
    with pytest.raises(NotImplementedError, match="item 18.7"):
        serve.main(["--arch", "gemma3_4b", "--multi-pod", "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="item 18.7"):
        shapes.batch_struct(None, None, None)
    with pytest.raises(NotImplementedError, match="item 18"):
        steps.make_train_step(None)
    with pytest.raises(NotImplementedError, match="M-RoPE.*item 18"):
        L.apply_rope(torch.zeros((1, 2, 1, 4)), torch.zeros((3, 1, 2)), 1e4, mrope=True)
