"""The port's LM serving path (`repro_torch.models`, `repro_torch.configs`,
`repro_torch.launch`) against the JAX package on the CPU.

Both sides compute with the same weights: the reference's
`init_params(PRNGKey(s), cfg, float32)` carried across with
`convert.params_from_numpy` (the port's keyed `init_params` draws the same
weights bit for bit: `test_keyed_init_params_is_the_references`).  Modules and whole models run on reduced
configs in float32, where the kernels' plain versions stand in for kernels
5 and 6.  Tolerance: |port − ref| ≤ 2e-4·max|ref| (`TOL`), the bound the
card's check holds the kernels' path to; the measured errors are 1e-6 to
1e-5 of max|ref| (float32 rounding in another order).  Greedy tokens must
be equal.
"""
import dataclasses
import pathlib

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
from repro_torch.core import prng
from repro_torch.launch import serve, shapes
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.models.config import LayerSpec, ModelConfig

TOL = 2e-4
#: the reduced serve configs, all ten: where the full width groups its KV
#: heads (gemma3 8 over 4, llama4 40 over 8, qwen2-vl 64 over 8, jamba 64
#: over 8, stablelm 32 over 8) the reduced config would keep 4 over 4, so
#: they keep 2; stablelm also keeps its head size of 160 (granite's one KV
#: head survives the cut)
SERVE_CFGS = {"gemma3_4b": dict(n_kv_heads=2), "mamba2_370m": {},
              "deepseek_moe_16b": {}, "granite_20b": {},
              "llama4_maverick_400b_a17b": dict(n_kv_heads=2), "whisper_small": {},
              "codeqwen15_7b": {}, "qwen2_vl_72b": dict(n_kv_heads=2),
              "stablelm_12b": dict(n_kv_heads=2, head_dim=160),
              "jamba_15_large_398b": dict(n_kv_heads=2)}
#: full-width parameter counts (the reference's `param_shapes`)
PARAM_COUNTS = {"deepseek_moe_16b": 16_879_568_896, "mamba2_370m": 420_025_856,
                "granite_20b": 20_315_756_544, "llama4_maverick_400b_a17b": 400_713_815_040,
                "gemma3_4b": 3_879_907_840, "whisper_small": 279_203_328,
                "codeqwen15_7b": 8_189_644_800, "qwen2_vl_72b": 72_705_384_448,
                "stablelm_12b": 12_142_924_800, "jamba_15_large_398b": 397_710_891_264}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


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
    """Beside the reference's four shapes, only the one-card serve and train
    shapes."""
    assert set(shapes.SHAPES) - set(jshapes.SHAPES) == {"decode_4k_b4", "decode_4k_b8",
                                                        "train_4k_b1", "train_4k_b8"}
    assert serve.sizes(shapes.SHAPES["decode_4k_b4"]) == (4, 2048, 4096)
    assert serve.sizes(shapes.SHAPES["decode_4k_b8"]) == (8, 2048, 4096)
    assert serve.sizes(shapes.SHAPES["decode_32k"]) == (128, 16384, 32768)


@pytest.mark.parametrize("arch,count", list(PARAM_COUNTS.items()))
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
    # the draws are the key's (they came from a torch generator until the
    # port drew jax.random.normal): the reference's leaves bit for bit
    p1 = M.init_params(prng.PRNGKey(3), cfg, torch.float32, device="cpu")
    p2 = M.init_params(prng.PRNGKey(3), cfg, torch.float32, device="cpu")
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(_flatten(p1), _flatten(p2)))
    with jax.threefry_partitionable(False):
        ref = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(3), jcfg, jnp.float32))
    m, mr = p1["layers"]["l0"]["mamba"], ref["layers"]["l0"]["mamba"]
    for leaf in ("A_log", "D", "dt_bias", "in_proj", "conv_w", "out_proj"):
        assert m[leaf].numpy().tobytes() == mr[leaf].tobytes(), leaf


#: keyed-init configs: gemma3 cut to width 64 but two stacked groups (the
#: per-group keys), the reduced configs of the others (two groups, or one
#: group of two or eight layers; whisper with two encoder layers)
INIT_CFGS = {"gemma3_4b": dict(d_model=64, d_ff=128, n_layers=34), "mamba2_370m": {},
             "deepseek_moe_16b": {}, "llama4_maverick_400b_a17b": {}, "whisper_small": {},
             "qwen2_vl_72b": {}, "jamba_15_large_398b": {}}


@pytest.mark.parametrize("arch,dtype,part", [
    ("gemma3_4b", "float32", False), ("gemma3_4b", "bfloat16", True),
    ("mamba2_370m", "float32", True), ("mamba2_370m", "bfloat16", False),
    ("deepseek_moe_16b", "bfloat16", False), ("deepseek_moe_16b", "float32", True),
    ("llama4_maverick_400b_a17b", "bfloat16", False), ("whisper_small", "bfloat16", False),
    ("whisper_small", "float32", True), ("qwen2_vl_72b", "bfloat16", False),
    ("jamba_15_large_398b", "bfloat16", False)])
def test_keyed_init_params_is_the_references(arch, dtype, part):
    """`init_params(key, cfg, dtype)` bit for bit as the reference's
    launchers call it (eagerly: each weight one `jax.random.normal` call,
    scaled in float32 and cast), in both threefry settings; the MoE router
    stays float32 in a bfloat16 tree, as the reference's."""
    jcfg, cfg = both_cfgs(arch, **INIT_CFGS[arch])
    assert cfg.n_groups * len(cfg.group) >= 2
    with jax.threefry_partitionable(part):
        ref = dict(_flatten(JM.init_params(jax.random.PRNGKey(11), jcfg, getattr(jnp, dtype))))
    with prng.threefry_partitionable(part):
        got = dict(_flatten(M.init_params(prng.PRNGKey(11), cfg, getattr(torch, dtype),
                                          device="cpu")))
    assert got.keys() == ref.keys()
    for k, want in ref.items():
        g = got[k]
        assert tuple(g.shape) == want.shape and str(g.dtype) == f"torch.{want.dtype}", k
        assert g.view(torch.int16 if g.dtype == torch.bfloat16 else torch.int32).numpy() \
            .tobytes() == np.asarray(want).tobytes(), k


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "llama4_maverick_400b_a17b",
                                  "whisper_small", "qwen2_vl_72b", "jamba_15_large_398b"])
def test_reference_trees_carry_across(arch):
    """`convert.params_from_numpy` takes a bfloat16 tree of the reference's
    with its new leaves (the MoE's float32 router, the stacked encoder,
    `enc_pos`, `ln_x`/`xattn`): each leaf keeps its type and bits and the
    tree is the port's `init_params` tree; ``dtype`` casts every leaf."""
    jcfg, cfg = both_cfgs(arch, **SERVE_CFGS[arch])
    ref = jax.tree.map(np.asarray, JM.init_params(jax.random.PRNGKey(2), jcfg, jnp.bfloat16))
    got = dict(_flatten(convert.params_from_numpy(ref, device="cpu")))
    want = dict(_flatten(ref))
    shapes = dict(_flatten(M.param_shapes(cfg)))
    assert got.keys() == want.keys() == shapes.keys()
    for k, w in want.items():
        g = got[k]
        assert (tuple(g.shape), g.dtype) == (tuple(shapes[k].shape), shapes[k].dtype), k
        assert str(g.dtype) == f"torch.{w.dtype}", k
        assert g.view(torch.int16 if g.dtype == torch.bfloat16 else torch.int32).numpy() \
            .tobytes() == w.tobytes(), k
    if cfg.moe is not None:
        assert any(k.endswith("moe/router") and v.dtype == torch.float32 for k, v in got.items())
    f32 = convert.params_from_numpy(ref, dtype=torch.float32, device="cpu")
    assert all(v.dtype == torch.float32 for _, v in _flatten(f32))


def test_param_shapes_are_meta_tensors_of_init_params():
    cfg = configs.get_config("mamba2_370m").reduced()
    shapes = dict(_flatten(M.param_shapes(cfg)))
    real = dict(_flatten(M.init_params(prng.PRNGKey(0), cfg, torch.bfloat16, device="cpu")))
    assert all(v.device.type == "meta" for v in shapes.values())
    assert {k: (tuple(v.shape), v.dtype) for k, v in shapes.items()} == \
        {k: (tuple(v.shape), v.dtype) for k, v in real.items()}


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


@pytest.mark.parametrize("hd", [64, 160, 30])
def test_apply_mrope_at_three_distinct_position_components(hd):
    """M-RoPE with temporal, height and width positions that differ (a
    patch grid), at head sizes whose hd/2 slots split evenly (32: 12, 10,
    10) or not (80: 28, 26, 26; 15: 5, 5, 5)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, 12, 3, hd)).astype(np.float32)
    pos = np.stack([np.broadcast_to(np.arange(12) + 5, (2, 12)),
                    rng.integers(0, 50, (2, 12)),
                    rng.integers(0, 1000, (2, 12))]).astype(np.int32)
    assert len({tuple(c.ravel()) for c in pos}) == 3
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1_000_000.0, True)
    got = L.apply_rope(torch.tensor(x), torch.tensor(pos), 1_000_000.0, mrope=True)
    close(got, want)
    assert sum(L.mrope_sections(hd)) == hd // 2
    # three equal components are 1-D RoPE
    same = np.broadcast_to(pos[0], (3, 2, 12))
    close(L.apply_rope(torch.tensor(x), torch.tensor(same.copy()), 1e6, mrope=True),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos[0]), 1e6, False))
    with pytest.raises(ValueError, match="M-RoPE takes positions"):
        L.apply_rope(torch.tensor(x), torch.tensor(pos[0]), 1e6, mrope=True)


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


@pytest.mark.parametrize("Sq", [32, 1])
def test_cross_attention(Sq):
    """kv_override: K/V from 20 encoder positions, no RoPE on q, every key
    visible, no cache; decode's single query included."""
    jcfg, cfg, jp, tp, x = _attn_setup(None, seed=3)
    enc = np.random.default_rng(3).standard_normal((2, 20, 64)).astype(np.float32)
    k = np.einsum("bsd,dhk->bshk", enc, np.asarray(jp["wk"]))
    v = np.einsum("bsd,dhk->bshk", enc, np.asarray(jp["wv"]))
    pos = np.broadcast_to(np.arange(Sq, dtype=np.int32) + 7, (2, Sq))
    want, wc = JL.attention(jp, jnp.asarray(x[:, :Sq]), jcfg, None, jnp.asarray(pos),
                            kv_override=(jnp.asarray(k), jnp.asarray(v)), causal=False)
    got, cache = L.attention(tp, torch.tensor(x[:, :Sq]), cfg, torch.tensor(pos),
                             kv_override=(torch.tensor(k), torch.tensor(v)))
    assert wc is None and cache is None
    close(got, want)


def test_encoder_matches_reference():
    """`run_encoder` (frames + enc_pos, non-causal self-attention with RoPE,
    MLP, final norm) on whisper's reduced config with the reference's
    weights and seeded frames."""
    jcfg, cfg = both_cfgs("whisper_small")
    params = JM.init_params(jax.random.PRNGKey(5), jcfg, jnp.float32)
    frames = np.random.default_rng(5).standard_normal(
        (2, jcfg.enc_seq, jcfg.d_model)).astype(np.float32)
    want = JM._run_encoder(params, jcfg, None, jnp.asarray(frames))
    close(M.run_encoder(carry(params), cfg, torch.tensor(frames)), want)


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
@pytest.fixture(scope="module")
def chip_smoke():
    """The card's smoke script, imported from the repo's root: its helpers
    for the reduced LM configs are shared with these tests."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(pathlib.Path(__file__).resolve().parents[1]))
        import chip_smoke
    return chip_smoke


@pytest.fixture(scope="module", params=list(SERVE_CFGS))
def serve_ref(request, chip_smoke):
    """Reference run of a reduced config: full forward over 32 tokens (the
    SSD needs whole chunks), then prefill 32 + 8 greedy decode steps
    (B = 2), with its weights and seeded stub inputs.  Decode runs at the
    first free slot, P + 32 + t after P prefix embeddings (the reference's
    launcher uses 32 + t, ROADMAP.md §3)."""
    arch = request.param
    jcfg, cfg = both_cfgs(arch, **SERVE_CFGS[arch])
    params = JM.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 32)).astype(np.int32)
    ex = chip_smoke.reduced_extras(jcfg, 2)
    jex = {k: jnp.asarray(v) for k, v in ex.items()}
    full, _, full_aux = JM.forward(params, jcfg, None, jnp.asarray(toks), remat=False, **jex)
    cache = JM.init_cache(jcfg, 2, 96, jnp.float32)
    logits, cache = jax.jit(j_prefill(jcfg, None))(params, {"tokens": jnp.asarray(toks), **jex},
                                                   cache)
    step = jax.jit(j_serve(jcfg, None))
    svex = {k: v for k, v in jex.items() if k == "frames"}
    start = 32 + jcfg.n_prefix_embeds
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    tokens = [np.asarray(tok)]
    for t in range(8):
        tok, cache = step(params, {"tokens": tok[:, None], **svex}, cache,
                          jnp.asarray(start + t, jnp.int32))
        tokens.append(np.asarray(tok))
    return dict(arch=arch, cfg=cfg, jcfg=jcfg, params=params, tp=carry(params), toks=toks,
                extras={k: torch.tensor(v) for k, v in ex.items()},
                full=np.asarray(full), full_aux=float(full_aux), prefill=np.asarray(logits),
                tokens=np.stack(tokens, 1), cache=jax.tree.map(np.asarray, cache))


def test_forward_matches_reference(serve_ref):
    r = serve_ref
    logits, cache, aux = M.forward(r["tp"], r["cfg"], torch.as_tensor(r["toks"]),
                                   **r["extras"])
    assert cache is None and aux.dtype == torch.float32
    close(logits, r["full"])
    if r["cfg"].moe is None:
        assert float(aux) == r["full_aux"] == 0.0
    else:
        np.testing.assert_allclose(float(aux), r["full_aux"], rtol=1e-5)


def test_prefill_and_greedy_decode_match_reference(serve_ref):
    """Prefill 32 + 8 greedy steps: logits within TOL, tokens equal, and the
    cache leaf by leaf."""
    r = serve_ref
    cache = M.init_cache(r["cfg"], 2, 96, torch.float32, device="cpu")
    out = serve.generate(r["tp"], r["cfg"], torch.as_tensor(r["toks"]), cache, 8, r["extras"])
    close(out["prefill_logits"], r["prefill"])
    np.testing.assert_array_equal(out["tokens"].numpy(), r["tokens"])
    assert out["tokens"].dtype == torch.int32
    close_tree(tree_to_numpy(out["cache"]), r["cache"])
    assert all(torch.isfinite(lg).all() for lg in out["step_logits"])


def test_decode_after_prefill_matches_full_forward(serve_ref, chip_smoke):
    """Decode with the cache reproduces the full forward's last logits
    (reference `test_arch_smoke.py:87-122`), after the prefix embeddings and
    with the frames where the config takes them; a MoE config at a capacity
    factor that drops no token (its capacity depends on the token count)."""
    r = serve_ref
    cfg = chip_smoke.no_drop(r["cfg"])
    toks = torch.as_tensor(r["toks"][:1, :9])
    ex = {k: v[:1] for k, v in r["extras"].items()}
    full, _, _ = M.forward(r["tp"], cfg, toks, **ex)
    cache = M.init_cache(cfg, 1, 16, torch.float32, device="cpu")
    _, cache = steps.make_prefill_step(cfg)(r["tp"], {"tokens": toks[:, :8], **ex}, cache)
    dec, _, _ = M.forward(r["tp"], cfg, toks[:, 8:9], cache=cache,
                          cache_pos=8 + cfg.n_prefix_embeds, frames=ex.get("frames"))
    close(dec[0, 0], full[0, -1].detach())


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_kernel_calls_of_a_prefill_and_a_decode_step(arch, monkeypatch, chip_smoke):
    """The kernel calls `chip_smoke.lm_launches` holds the card's serve
    path to, counted here at the wrappers: kernel 5 once an attention layer
    in a prefill and once an encoder and a cross-attention layer on every
    call (whisper), kernel 6 once a Mamba2 layer in a prefill."""
    from repro_torch.kernels import ops

    calls = {"flash_attention": 0, "ssd_scan": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(ops, "attention", counted("flash_attention", ops.attention))
    monkeypatch.setattr(ops, "ssd", counted("ssd_scan", ops.ssd))
    cfg = configs.get_config(arch).reduced(**SERVE_CFGS[arch])
    params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu")
    ex = {k: torch.tensor(v) for k, v in chip_smoke.reduced_extras(cfg, 1).items()}
    toks = torch.zeros((1, 32), dtype=torch.int32)
    cache = M.init_cache(cfg, 1, 48, torch.float32, device="cpu")
    pre = serve.prefill(params, cfg, toks, cache, ex)
    assert calls == chip_smoke.lm_launches(cfg)
    calls.update(flash_attention=0, ssd_scan=0)
    serve.decode(params, cfg, pre["token"], pre["cache"], serve.decode_start(toks, ex), 1, ex)
    assert calls == chip_smoke.lm_launches(cfg, prefills=0, decode_steps=1)


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
@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_serve_cli_debug_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--debug", "--device", "cpu", "--gen", "3"])
    assert out["tokens"].shape == (4, 4)
    vocab = configs.get_config(arch).reduced().vocab_size
    assert bool(((out["tokens"] >= 0) & (out["tokens"] < vocab)).all())
    assert torch.isfinite(out["prefill_logits"]).all()
    text = capsys.readouterr().out
    assert "prefill 4×32" in text and "done" in text


def test_encoder_decoder_needs_its_frames():
    cfg = configs.get_config("whisper_small").reduced()
    params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu")
    with pytest.raises(ValueError, match="needs its frames"):
        M.forward(params, cfg, torch.zeros((1, 4), dtype=torch.int32))


def test_unported_entry_points_raise_naming_their_item():
    """Every LM entry point is ported: `--multi-pod` in a one-rank world
    raises the production mesh's world-size error, and the input spec
    builders return the reference's global shapes, types and specs (on the
    (1, 1) debug mesh, at each of the four input shapes)."""
    from repro.launch import mesh as jmesh
    from repro.sharding import rules as jrules
    from repro_torch.launch import mesh
    from repro_torch.sharding import rules

    with pytest.raises(ValueError, match="needs a world of 512 ranks; this one has 1"):
        serve.main(["--arch", "gemma3_4b", "--multi-pod", "--device", "cpu"])
    jm, tm = jmesh.make_debug_mesh(1, 1), mesh.make_debug_mesh(1, 1, device="cpu")
    types = {"int32": torch.int32, "bfloat16": torch.bfloat16, "float32": torch.float32}

    def same(got, want):
        assert got.shape == tuple(want.shape) and got.dtype == types[str(want.dtype)]
        assert got.spec == tuple(want.sharding.spec) + (None,) * (len(got.spec)
                                                                  - len(want.sharding.spec))

    for arch in ("whisper_small", "qwen2_vl_72b", "jamba_15_large_398b"):
        jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
        for name, shp in shapes.SHAPES.items():
            if name not in jshapes.SHAPES:
                continue
            jr = jrules.make_rules(jm, batch_size=shp.global_batch)
            tr = rules.make_rules(tm, batch_size=shp.global_batch)
            want, got = jshapes.batch_struct(jcfg, jshapes.SHAPES[name], jr), \
                shapes.batch_struct(cfg, shp, tr)
            assert sorted(got) == sorted(want)
            for k in want:
                same(got[k], want[k])
            want = jshapes.cache_struct(jcfg, jshapes.SHAPES[name], jr)
            got = shapes.cache_struct(cfg, shp, tr)
            for li in want:
                for k in want[li]:
                    same(got[li][k], want[li][k])
        same(shapes.pos_struct(tr), jshapes.pos_struct(jr))
    # the train step is ported (it raised here until then): one step runs
    cfg = configs.get_config("gemma3_4b").reduced()
    params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 9)),
                             dtype=torch.int32)
    from repro_torch.optim import adamw_init
    _, _, metrics = steps.make_train_step(cfg, remat=False)(params, adamw_init(params),
                                                            {"tokens": tokens})
    assert bool(torch.isfinite(metrics["loss"]))
