"""The port's LM sharding (`repro_torch.sharding`, the sharded layers,
forward, steps and meshes) against the JAX package and the one-process
port on the CPU.

* Spec tables: the port's `param_specs`, `cache_specs` and `batch_specs`
  equal the reference's entry for entry for all ten configs at full width
  on the production meshes (16, 16) and (2, 16, 16) and the debug meshes
  (2, 2), (1, 3), (4, 2), at the global batch of each of the four input
  shapes (`tests/torch_lm_specs_worker.py`: the reference with 512 virtual
  devices, the port over torch's fake process group at each world size).
* One launch of gloo ranks a world (`tests/torch_lm_sharded_worker.py`),
  float32, the kernels' plain versions: at (2, 2) (4 ranks) all ten reduced
  configs (gemma3 cut to its first 6 layers) prefill and decode 2 greedy
  steps, the MoE configs with 4096
  prompt tokens so the expert-parallel path runs (their reference is the
  global path on each data shard's rows: capacity and aux are local to a
  shard there, as the reference's `_moe_expert_parallel` defines them); at
  (1, 3) (3 ranks) gemma3 and whisper prefill 48 tokens, sequence-parallel
  (4 heads do not divide 3), kernel 5 at q_pos0 0, 16 and 32; four train
  steps' gradients (stablelm, deepseek-moe expert-parallel, mamba2's SSM
  heads at (2, 2); gemma3's tied embedding and sequence-parallel backward
  at (1, 3)).  Gates: logits within `TOL`·max|ref| of the JAX package's
  global path and 1e-5·max|ref| of the one-process port, greedy tokens
  equal; the train step's loss within 1e-5 relative and each leaf's
  gradient within 1e-4·max|ref| + 1e-6 of `jax.value_and_grad`, losses
  within 1e-6 relative of the one-process port; ranks that hold the same
  rows agree bitwise, and a rerun gives the same bits.
"""
import dataclasses
import functools
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import layers as JL
from repro.models import model as JM
from repro.models.steps import make_fused_vocab_xent as j_fused
from repro.models.steps import make_prefill_step as j_prefill
from repro_torch import configs
from repro_torch.core import prng
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.optim import adamw_init, adamw_update

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_lm_sharded_worker.py"
SPECS = REPO / "tests" / "torch_lm_specs_worker.py"
TOL = 2e-4
PORT_TOL = 1e-5
#: the reduced configs of `test_torch_lm.py` (grouped KV heads kept)
SERVE_CFGS = {"gemma3_4b": dict(n_kv_heads=2), "mamba2_370m": {},
              "deepseek_moe_16b": {}, "granite_20b": {},
              "llama4_maverick_400b_a17b": dict(n_kv_heads=2), "whisper_small": {},
              "codeqwen15_7b": {}, "qwen2_vl_72b": dict(n_kv_heads=2),
              "stablelm_12b": dict(n_kv_heads=2, head_dim=160),
              "jamba_15_large_398b": dict(n_kv_heads=2)}
#: gemma3's reduced group is 17 layers: its first 6 (5 window layers and the
#: global one) keep every kind of layer at a third of the time
LAYERS = {"gemma3_4b": 6}
MOE = ("deepseek_moe_16b", "llama4_maverick_400b_a17b", "jamba_15_large_398b")
GEN = 2
#: train cases: (arch, mesh, B sequences of S + 1 tokens, remat); deepseek-moe
#: at 4 × 1024 tokens runs the expert-parallel MoE, at 4 × 16 the global route
TRAIN = {"stablelm_12b": ("stablelm_12b", (2, 2), 4, 16, True),
         "deepseek_moe_16b": ("deepseek_moe_16b", (2, 2), 4, 1024, False),
         "deepseek_moe_16b_global": ("deepseek_moe_16b", (2, 2), 4, 16, False),
         "mamba2_370m": ("mamba2_370m", (2, 2), 4, 32, False),
         "gemma3_4b": ("gemma3_4b", (1, 3), 2, 48, False)}
SEQ_PARALLEL = ("gemma3_4b", "whisper_small")
#: the rounding witness: reduced mamba2 at mamba2-370m's full depth, its
#: step-0 gradients at (2, 2) in float64 and float32 (B sequences of S + 1)
WITNESS = dict(arch="mamba2_370m", layers=48, B=4, S=32)
WITNESS_DTYPES = ("float64", "float32")


def _reduced(registry, arch: str):
    """The reduced config of `arch` in either package (`SERVE_CFGS`), cut
    to `LAYERS` (as the worker's ``layers`` cuts it)."""
    cfg = registry.get_config(arch).reduced(**SERVE_CFGS[arch])
    n = LAYERS.get(arch)
    return dataclasses.replace(cfg, n_layers=n, group=cfg.group[:n]) if n else cfg


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def close(got, want, tol):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
    assert err <= tol * scale, f"|Δ| {err} > {tol}·max|ref| ({scale})"


def _free_port() -> int:
    """A free port below Linux's ephemeral range (32768–60999), so that
    tests started beside this one, whose ``bind(0)`` ports come from that
    range, cannot pick this world's store port before its rank 0 binds it."""
    rng = np.random.default_rng()
    while True:
        port = int(rng.integers(20000, 32000))
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port


def serve_sizes(arch: str, mesh: tuple) -> tuple:
    """(B, S, max_seq) of a serve case: 4096 prompt tokens for a MoE config
    (expert-parallel), 48 at (1, 3) (sequence-parallel), else 32."""
    if arch in MOE:
        return 2, 2048, 2056
    return (2, 48, 60) if mesh == (1, 3) else (2, 32, 48)


def _extras(cfg, B: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.n_enc_layers:
        out["frames"] = rng.standard_normal((B, cfg.enc_seq, cfg.d_model)) * 0.5
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal((B, cfg.n_prefix_embeds, cfg.d_model)) * 0.5
    return {k: v.astype(np.float32) for k, v in out.items()}


def serve_inputs(arch: str, mesh: tuple) -> dict:
    cfg = _reduced(configs, arch)
    B, S, _ = serve_sizes(arch, mesh)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    return {"tokens": toks, **_extras(cfg, B, 11)}


def train_inputs(name: str) -> dict:
    arch, _, B, S, _ = TRAIN[name]
    cfg = _reduced(configs, arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    return {"tokens": toks, **_extras(cfg, B, 13)}


def witness_inputs() -> dict:
    cfg = configs.get_config(WITNESS["arch"]).reduced()
    shape = (WITNESS["B"], WITNESS["S"] + 1)
    return {"tokens": np.random.default_rng(3).integers(0, cfg.vocab_size, shape).astype(
        np.int32)}


def moe_inputs(arch: str) -> dict:
    d = configs.get_config(arch).reduced().d_model
    return {"x": (np.random.default_rng(5).standard_normal((2, 2048, d)) * 0.5).astype(
        np.float32)}


def _launch(tmp: pathlib.Path, mesh: tuple, cases: list, inputs: dict) -> dict:
    """Start data·model ranks of the worker with `cases`; their results by
    rank (every rank must exit 0)."""
    tmp.mkdir(parents=True, exist_ok=True)
    for name, arrays in inputs.items():
        np.savez(tmp / name, **arrays)
    (tmp / "out").mkdir(exist_ok=True)
    job = tmp / "job.json"
    job.write_text(json.dumps({"data": mesh[0], "model": mesh[1], "device": "cpu",
                               "inputs": str(tmp), "out": str(tmp / "out"), "cases": cases}))
    W, port = mesh[0] * mesh[1], _free_port()
    procs = []
    for r in range(W):
        env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="1", MASTER_ADDR="localhost", MASTER_PORT=str(port),
                   RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(W), LOCAL_WORLD_SIZE=str(W),
                   REPRO_DIST_TIMEOUT_S="120")
        procs.append(subprocess.Popen([sys.executable, str(WORKER), str(job)], env=env,
                                      stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                      text=True))
    logs = [p.communicate(timeout=900)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}"
    return {r: pickle.loads((tmp / "out" / f"rank{r}.pkl").read_bytes())["results"]
            for r in range(W)}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    """One launch at (2, 2): every reduced config's serve case, the three
    MoE layers, and the train cases on that mesh."""
    cases, inputs = [], {}
    for arch, over in SERVE_CFGS.items():
        B, S, max_seq = serve_sizes(arch, (2, 2))
        inputs[f"serve_{arch}.npz"] = serve_inputs(arch, (2, 2))
        cases.append(dict(name=f"serve/{arch}", kind="serve", arch=arch, over=over, B=B,
                          max_seq=max_seq, gen=GEN, inputs=f"serve_{arch}.npz",
                          layers=LAYERS.get(arch)))
    for arch in MOE:
        inputs[f"moe_{arch}.npz"] = moe_inputs(arch)
        cases.append(dict(name=f"moe/{arch}", kind="moe", arch=arch, B=2,
                          inputs=f"moe_{arch}.npz"))
    for name, (arch, mesh, B, S, remat) in TRAIN.items():
        if mesh == (2, 2):
            inputs[f"train_{name}.npz"] = train_inputs(name)
            cases.append(dict(name=f"train/{name}", kind="train", arch=arch,
                              over=SERVE_CFGS[arch], B=B, remat=remat, steps=2,
                              inputs=f"train_{name}.npz", layers=LAYERS.get(arch)))
    inputs["witness.npz"] = witness_inputs()
    for dtype in WITNESS_DTYPES:
        cases.append(dict(name=f"witness/{dtype}", kind="train", arch=WITNESS["arch"],
                          layers=WITNESS["layers"], B=WITNESS["B"], dtype=dtype, rerun=False,
                          inputs="witness.npz"))
    return _launch(tmp_path_factory.mktemp("w4"), (2, 2), cases, inputs)


@pytest.fixture(scope="module")
def world3(tmp_path_factory):
    """One launch at (1, 3): gemma3 and whisper sequence-parallel serve
    cases and gemma3's train case."""
    cases, inputs = [], {}
    for arch in SEQ_PARALLEL:
        B, S, max_seq = serve_sizes(arch, (1, 3))
        inputs[f"serve_{arch}.npz"] = serve_inputs(arch, (1, 3))
        cases.append(dict(name=f"serve/{arch}", kind="serve", arch=arch, over=SERVE_CFGS[arch],
                          B=B, max_seq=max_seq, gen=GEN, inputs=f"serve_{arch}.npz",
                          layers=LAYERS.get(arch)))
    _, _, B, S, remat = TRAIN["gemma3_4b"]
    inputs["train_gemma3_4b.npz"] = train_inputs("gemma3_4b")
    cases.append(dict(name="train/gemma3_4b", kind="train", arch="gemma3_4b",
                      over=SERVE_CFGS["gemma3_4b"], B=B, remat=remat, steps=2,
                      inputs="train_gemma3_4b.npz", layers=LAYERS["gemma3_4b"]))
    return _launch(tmp_path_factory.mktemp("w3"), (1, 3), cases, inputs)


def _assemble(ranks: dict, name: str, key: str, B: int):
    """Rows of `key` from the ranks (each holds its rows; ranks that hold
    the same rows must hold the same bits)."""
    out = [None] * B
    for res in ranks.values():
        rec = res[name]
        start, n = rec["rows"]
        val = rec[key]
        for i in range(n):
            row = val[i] if not isinstance(val, list) else [v[i] for v in val]
            if out[start + i] is None:
                out[start + i] = row
            else:
                np.testing.assert_array_equal(np.asarray(row), np.asarray(out[start + i]))
    return out


def _gathered(ranks, name, B):
    pre = np.stack(_assemble(ranks, name, "prefill", B))
    stp = _assemble(ranks, name, "steps", B)
    steps_ = [np.stack([stp[b][t] for b in range(B)]) for t in range(GEN)]
    toks = np.stack(_assemble(ranks, name, "tokens", B))
    return pre, steps_, toks


# ----------------------------- references -----------------------------------
@functools.lru_cache(maxsize=None)
def _jax_params(jcfg):
    """The reference's weights as the port's keyed `init_params` draws them
    (``jax_threefry_partitionable`` off, the port's default); drawn once a
    config."""
    with jax.threefry_partitionable(False):
        return JM.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)


def _ep(cfg, B: int, S: int, mesh: tuple) -> bool:
    """Whether the expert-parallel path runs (the reference's gate)."""
    return cfg.moe is not None and cfg.moe.n_experts % mesh[1] == 0 and B * S >= 4096


def _jax_serve(arch: str, mesh: tuple) -> dict:
    """The JAX package's global path: prefill (on each data shard's rows
    when the sharded prefill is expert-parallel) and GEN greedy steps."""
    jcfg = _reduced(jconfigs, arch)
    B, S, max_seq = serve_sizes(arch, mesh)
    inp = serve_inputs(arch, mesh)
    params = _jax_params(jcfg)
    shards = mesh[0] if _ep(jcfg, B, S, mesh) else 1
    n = B // shards
    pre = jax.jit(j_prefill(jcfg, None))
    logits, caches = [], []
    for s in range(shards):
        b = {k: jnp.asarray(v[s * n:(s + 1) * n]) for k, v in inp.items()}
        lg, c = pre(params, b, JM.init_cache(jcfg, n, max_seq, jnp.float32))
        logits.append(lg)
        caches.append(c)
    logits = jnp.concatenate(logits, 0)
    cache = jax.tree.map(lambda *xs: jnp.concatenate(xs, 1), *caches)
    # the reference's serve step (`steps.make_serve_step`), its logits kept
    step = jax.jit(lambda p, t, c, pos, fr: JM.forward(p, jcfg, None, t, cache=c, cache_pos=pos,
                                                       frames=fr, remat=False)[:2])
    tok = jnp.argmax(logits[:, -1], -1).astype(jnp.int32)
    toks, step_logits = [np.asarray(tok)], []
    frames = jnp.asarray(inp["frames"]) if "frames" in inp else None
    start = S + jcfg.n_prefix_embeds
    for t in range(GEN):
        lg, cache = step(params, tok[:, None], cache, jnp.asarray(start + t, jnp.int32), frames)
        tok = jnp.argmax(lg[:, -1, :], axis=-1).astype(jnp.int32)
        step_logits.append(np.asarray(lg))
        toks.append(np.asarray(tok))
    return {"prefill": np.asarray(logits), "steps": step_logits, "tokens": np.stack(toks, 1)}


def _port_serve(arch: str, mesh: tuple) -> dict:
    """The one-process port, sharded by data shard as `_jax_serve`."""
    cfg = _reduced(configs, arch)
    B, S, max_seq = serve_sizes(arch, mesh)
    inp = {k: torch.as_tensor(v) for k, v in serve_inputs(arch, mesh).items()}
    params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu")
    shards = mesh[0] if _ep(cfg, B, S, mesh) else 1
    n = B // shards
    outs = []
    for s in range(shards):
        ex = {k: v[s * n:(s + 1) * n] for k, v in inp.items()}
        toks = ex.pop("tokens")
        outs.append(serve.prefill(params, cfg, toks,
                                  M.init_cache(cfg, n, max_seq, torch.float32, device="cpu"),
                                  ex))
    cache = {li: {k: torch.cat([o["cache"][li][k] for o in outs], 1) for k in outs[0]["cache"][li]}
             for li in outs[0]["cache"]}
    token = torch.cat([o["token"] for o in outs])
    ex = {k: v for k, v in inp.items() if k != "tokens"}
    dec = serve.decode(params, cfg, token, cache, S + cfg.n_prefix_embeds, GEN, ex)
    return {"prefill": torch.cat([o["logits"] for o in outs]).numpy(),
            "steps": [lg.numpy() for lg in dec["logits"]],
            "tokens": torch.cat([token[:, None], dec["tokens"]], 1).numpy()}


def _check_serve(ranks, arch, mesh):
    B = serve_sizes(arch, mesh)[0]
    pre, steps_, toks = _gathered(ranks, f"serve/{arch}", B)
    for ref, tol in ((_jax_serve(arch, mesh), TOL), (_port_serve(arch, mesh), PORT_TOL)):
        close(pre, ref["prefill"], tol)
        for got, want in zip(steps_, ref["steps"]):
            close(got, want, tol)
        np.testing.assert_array_equal(toks, ref["tokens"])
    assert all(res[f"serve/{arch}"]["rerun_equal"] for res in ranks.values())


# ----------------------------- spec tables ----------------------------------
@pytest.fixture(scope="module")
def spec_tables(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("specs")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    for side in ("ref", "port"):
        subprocess.run([sys.executable, str(SPECS), side, str(tmp / f"{side}.json")],
                       env=env, check=True, timeout=600)
    return {side: json.loads((tmp / f"{side}.json").read_text()) for side in ("ref", "port")}


@pytest.mark.parametrize("mesh", ["16x16", "2x16x16", "2x2", "1x3", "4x2"])
def test_spec_tables_are_the_references(spec_tables, mesh):
    ref, port = spec_tables["ref"][mesh], spec_tables["port"][mesh]
    assert sorted(ref) == sorted(port) == sorted(configs.ARCH_IDS)
    for arch in ref:
        assert port[arch]["params"] == ref[arch]["params"], arch
        assert sorted(ref[arch]["cache"]) == sorted(port[arch]["cache"])
        for shape in ref[arch]["cache"]:
            assert port[arch]["cache"][shape] == ref[arch]["cache"][shape], (arch, shape)
            assert port[arch]["batch"][shape] == ref[arch]["batch"][shape], (arch, shape)


# ----------------------------- serve -----------------------------------------
@pytest.mark.parametrize("arch", list(SERVE_CFGS))
def test_sharded_prefill_and_decode_at_2x2(world4, arch):
    """Heads (and experts, SSM heads, vocabulary) over `model`, batch over
    `data`, the KV cache's sequence over `model`: logits and greedy tokens
    of the gathered batch against the JAX package's global path and the
    one-process port."""
    _check_serve(world4, arch, (2, 2))


@pytest.mark.parametrize("arch", SEQ_PARALLEL)
def test_sequence_parallel_serve_at_1x3(world3, arch):
    """Four heads over a model axis of 3: sequence-parallel attention (the
    reference's `_seq_parallel_attn`, kernel 5 at q_pos0 0, 16, 32; gemma3's
    window 8), decode over the sequence-sharded cache (gemma3's ring of 8
    does not divide 3 and stays whole on each rank)."""
    _check_serve(world3, arch, (1, 3))
    stats = world3[0][f"serve/{arch}"]["prefill_stats"]
    assert stats["all_gather"]["calls"] > 0


@pytest.mark.parametrize("arch", MOE)
def test_expert_parallel_moe_matches_the_reference_shard_by_shard(world4, arch):
    """`layers.moe` with rules at 4096 tokens: each data shard's output,
    its own aux and expert ids are the reference's `layers.moe(p, x_shard,
    cfg, None)` (routing and capacity of the shard's tokens); the returned
    aux is their mean over the data axes."""
    jcfg = jconfigs.get_config(arch).reduced()
    params = _jax_params(jcfg)
    li = f"l{[s.ffn for s in jcfg.group].index('moe')}"     # the first MoE layer
    mp = jax.tree.map(lambda a: a[0], params["layers"][li]["moe"])
    x = moe_inputs(arch)["x"]
    auxes = []
    for s in range(2):
        out, aux = JL.moe(mp, jnp.asarray(x[s:s + 1]), jcfg, None)
        xt = jnp.asarray(x[s]).astype(jnp.float32)
        probs = jax.nn.softmax(xt @ mp["router"], -1)
        ids = np.asarray(jax.lax.top_k(probs, jcfg.moe.top_k)[1])
        auxes.append(float(aux))
        for res in world4.values():
            rec = res[f"moe/{arch}"]
            if rec["rows"][0] == s:
                close(rec["out"], np.asarray(out), TOL)
                np.testing.assert_allclose(rec["aux_local"], float(aux), rtol=1e-5)
                np.testing.assert_array_equal(rec["ids"], ids)
    for res in world4.values():
        np.testing.assert_allclose(res[f"moe/{arch}"]["aux"], np.mean(auxes), rtol=1e-5)


# ----------------------------- train -----------------------------------------
def _ref_loss_fn(jcfg):
    xent = j_fused(jcfg, None)

    def loss_fn(params, batch):
        toks = batch["tokens"]
        h, _, aux = JM.forward(params, jcfg, None, toks[:, :-1], remat=False,
                               return_hidden=True, frames=batch.get("frames"),
                               prefix_embeds=batch.get("prefix_embeds"))
        h = h[:, jcfg.n_prefix_embeds:, :]
        W = params["embed"].T if jcfg.tie_embeddings else params["unembed"]
        return xent(h, W, toks[:, 1:]) + aux

    return loss_fn


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, path) if isinstance(v, dict) else {path: np.asarray(v)})
    return out


@pytest.mark.parametrize("name", list(TRAIN))
def test_sharded_train_step(world4, world3, name):
    """Step-0 loss and every gathered gradient leaf against
    `jax.value_and_grad` of the reference's loss (the mean over the data
    shards of the global path's loss on each shard's rows where the MoE is
    expert-parallel, as the reference's `_moe_expert_parallel` defines
    it); two AdamW steps' losses against the one-process port.  At 4 × 16
    tokens deepseek-moe takes the global route: its reference is the global
    path on the whole batch."""
    arch, mesh, B, S, _ = TRAIN[name]
    ranks = world4 if mesh == (2, 2) else world3
    rec = ranks[0][f"train/{name}"]
    jcfg = _reduced(jconfigs, arch)
    cfg = _reduced(configs, arch)
    params = _jax_params(jcfg)
    inp = train_inputs(name)
    shards = mesh[0] if _ep(jcfg, B, S, mesh) else 1
    n = B // shards
    vg = jax.jit(jax.value_and_grad(_ref_loss_fn(jcfg)))
    loss, grads = 0.0, None
    for s in range(shards):
        l_s, g_s = vg(params, {k: jnp.asarray(v[s * n:(s + 1) * n]) for k, v in inp.items()})
        loss += float(l_s) / shards
        g_s = jax.tree.map(lambda g: np.asarray(g, np.float64) / shards, g_s)
        grads = g_s if grads is None else jax.tree.map(np.add, grads, g_s)
    np.testing.assert_allclose(rec["loss"], loss, rtol=1e-5)
    want, got = _flatten(grads), _flatten(rec["grads"])
    assert sorted(want) == sorted(got)
    for path in want:
        err = float(np.abs(got[path] - want[path]).max())
        assert err <= 1e-4 * float(np.abs(want[path]).max()) + 1e-6, (path, err)
    # every rank alike, reruns bitwise
    assert len({r[f"train/{name}"]["digest"] for r in ranks.values()}) == 1
    assert all(r[f"train/{name}"]["rerun_equal"] for r in ranks.values())
    assert all(r[f"train/{name}"]["losses"] == rec["losses"] for r in ranks.values())
    # the one-process port: two AdamW steps on each data shard's rows
    # (expert-parallel) or the whole batch
    p1 = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu")
    grad_fn = steps.make_grad_fn(cfg, remat=False)
    opt, losses = adamw_init(p1), []
    for _ in range(2):
        parts = [grad_fn(p1, {k: torch.as_tensor(v[s * n:(s + 1) * n]) for k, v in inp.items()})
                 for s in range(shards)]
        gs = parts[0][2]
        for _, _, g in parts[1:]:
            gs = _tree_add(gs, g)
        if shards > 1:
            gs = _tree_scale(gs, 1.0 / shards)
        p1, opt = adamw_update(gs, opt, p1, lr=3e-4)
        losses.append(sum(float(p[0]) for p in parts) / shards)
    np.testing.assert_allclose(rec["losses"], losses, rtol=1e-6)


@pytest.fixture(scope="module")
def worker():
    """The ranks' worker script as a module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(REPO / "tests"))
        import torch_lm_sharded_worker
    return torch_lm_sharded_worker


def test_sharded_gradient_differs_from_the_one_process_one_by_rounding(world4, worker):
    """The independent witness behind the card's mamba2 gate: at
    mamba2-370m's full depth (48 layers, reduced width) the sharded step-0
    loss and gradients equal the one-process port's to float64 rounding
    when both run in float64 (the same function, summed in another order),
    and in float32 the sharded gradient is no further from that float64
    truth than the one-process float32 gradient is (the float32 gap is
    the gradient's conditioning, not the sharding; both read ~1.6e-4 of a
    leaf's max at this depth)."""
    cfg = worker.case_config(WITNESS)
    toks = torch.as_tensor(witness_inputs()["tokens"])
    one = {}
    for dtype in WITNESS_DTYPES:
        p = worker.init_params(cfg, getattr(torch, dtype), torch.device("cpu"))
        loss, _, g = steps.make_grad_fn(cfg)(p, {"tokens": toks})
        one[dtype] = float(loss), {k: v.astype(np.float64) for k, v in _flatten(g).items()}
    truth = one["float64"][1]

    def rel(got):
        return {k: float(np.abs(np.asarray(got[k], np.float64) - w).max() / np.abs(w).max())
                for k, w in truth.items()}

    rec = {d: world4[0][f"witness/{d}"] for d in WITNESS_DTYPES}
    assert all(r[f"witness/{d}"]["digest"] == rec[d]["digest"]
               for r in world4.values() for d in WITNESS_DTYPES)
    np.testing.assert_allclose(rec["float64"]["loss"], one["float64"][0], rtol=1e-12)
    f64 = rel(_flatten(rec["float64"]["grads"]))
    assert max(f64.values()) <= 1e-11, max(f64.items(), key=lambda kv: kv[1])
    sharded32 = max(rel(_flatten(rec["float32"]["grads"])).values())
    one32 = max(rel(one["float32"][1]).values())
    assert sharded32 <= 2 * one32, (sharded32, one32)


def _tree_add(a, b):
    return {k: _tree_add(a[k], b[k]) if isinstance(a[k], dict) else a[k] + b[k] for k in a}


def _tree_scale(a, s):
    return {k: _tree_scale(v, s) if isinstance(v, dict) else v * s for k, v in a.items()}


# ----------------------------- meshes, shards, accounting --------------------
def _mesh_at(rank: int, shape=(2, 2)):
    """An `LMMesh` view of rank `rank` of a (data, model) world, without a
    process group (for what needs only the rank's coordinates)."""
    from repro_torch.launch.mesh import LMMesh
    return LMMesh(axis_names=("data", "model"), shape=dict(zip(("data", "model"), shape)),
                  rank=rank, world_size=shape[0] * shape[1], backend="none",
                  device=torch.device("cpu"))


@pytest.mark.parametrize("arch", ["mamba2_370m", "whisper_small", "deepseek_moe_16b"])
def test_shard_params_cuts_the_references_tree_as_init_params_draws_it(arch):
    """Each rank's keyed `init_params(..., rules=)` (a window of the draw
    where the shard is contiguous, else the leaf drawn and cut) is, bit for
    bit, `convert.shard_params` of the reference's whole tree."""
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.models import convert
    from repro_torch.sharding import rules as R

    jcfg = _reduced(jconfigs, arch)
    cfg = _reduced(configs, arch)
    full = jax.tree.map(np.asarray, _jax_params(jcfg))
    for rank in range(4):
        rules = R.make_rules(_mesh_at(rank), batch_size=4)
        got = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu", rules=rules)
        want = convert.shard_params(full, cfg, rules, device="cpu")
        for a, b in zip(tree_leaves(got), tree_leaves(want)):
            assert a.shape == b.shape and torch.equal(a, b)


def test_meshes_need_their_world_and_one_rank_is_the_identity():
    """The production meshes raise without their 256 or 512 ranks (as
    ``jax.make_mesh`` does without the devices); the (1, 1) debug mesh of a
    one-rank world has no groups and its collectives are identities."""
    from repro_torch.launch import mesh as LM
    from repro_torch.sharding import collectives as C

    with pytest.raises(ValueError, match="needs a world of 256 ranks; this one has 1"):
        LM.make_production_mesh(device="cpu")
    with pytest.raises(ValueError, match="needs a world of 512 ranks"):
        LM.make_production_mesh(multi_pod=True, device="cpu")
    with pytest.raises(ValueError, match="needs a world of 4 ranks"):
        LM.make_debug_mesh(2, 2, device="cpu")
    mesh = LM.make_debug_mesh(1, 1, device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("model") is None
    x = torch.arange(6.0).reshape(2, 3)
    C.reset_stats()
    for y in (C.all_gather(x, mesh, "model", 1), C.all_reduce(x, mesh, ("data", "model")),
              C.enter(x, mesh, "model"), C.take(x, mesh, "model", 0),
              C.reduce_scatter(x, mesh, "data")):
        assert torch.equal(y, x)
    assert all(v["calls"] == 0 for v in C.stats.values())


def test_rank_coordinates_are_row_major():
    mesh = _mesh_at(5, (2, 4))
    assert mesh.coords == {"data": 1, "model": 1}
    assert mesh.index(("data", "model")) == 5 and mesh.size(("data", "model")) == 8
    assert mesh.index("model") == 1 and mesh.size("model") == 4 and mesh.index("data") == 1


@pytest.mark.parametrize("arch", sorted(configs.ARCH_IDS))
def test_analysis_is_the_references(arch):
    """`models.analysis`: parameter counts and model FLOPs at full width."""
    from repro.models import analysis as janalysis
    from repro_torch.models import analysis

    jcfg, cfg = jconfigs.get_config(arch), configs.get_config(arch)
    assert analysis.param_count(cfg) == janalysis.param_count(jcfg)
    assert analysis.active_param_count(cfg) == janalysis.active_param_count(jcfg)
    for kind in ("train", "prefill", "decode"):
        assert analysis.model_flops(cfg, kind, 32, 4096) == janalysis.model_flops(
            jcfg, kind, 32, 4096)


def test_collectives_are_counted_by_kind(world4):
    """The sharded prefill all-gathers and all-reduces (TP products, the
    vocabulary-sharded embedding, FSDP gathers); the train step's backward
    reduce-scatters the FSDP leaves' gradients."""
    serve_stats = world4[0]["serve/codeqwen15_7b"]["prefill_stats"]
    assert serve_stats["all_reduce"]["calls"] > 0 and serve_stats["all_gather"]["calls"] > 0
    assert serve_stats["all_reduce"]["bytes"] > 0
    train_stats = world4[0]["train/stablelm_12b"]["stats"]
    assert train_stats["reduce_scatter"]["calls"] > 0


@pytest.fixture(scope="module")
def chip_smoke():
    """The card's smoke script, imported from the repo's root."""
    with pytest.MonkeyPatch.context() as mp:
        mp.syspath_prepend(str(REPO))
        import chip_smoke
    return chip_smoke


def test_chip_cells_are_the_workers_configs(chip_smoke, worker):
    """Phase lm_sharded's one-process reference builds each cell's config
    with the ranks' own `case_config` (`torch_lm_sharded_worker.py`):
    full width, cut in depth to the case's layers, float32."""
    assert pathlib.Path(chip_smoke.lm_worker().__file__) == pathlib.Path(worker.__file__)
    for name, mesh, case in chip_smoke.LM_SHARDED:
        cfg, rules, dtype = worker.setup(case, _mesh_at(0, mesh), None)
        assert cfg == worker.case_config(case) and dtype == torch.float32, name
        if not case.get("reduced", True):
            full = configs.get_config(case["arch"])
            assert (cfg.d_model, cfg.n_heads, cfg.vocab_size) == (
                full.d_model, full.n_heads, full.vocab_size), name
            assert cfg.n_layers == case["layers"] < full.n_layers, name


def test_chip_route_diff_compares_expert_sets(chip_smoke):
    """Expert ids in another order route a token alike; a token routed to
    another expert counts, with its probability gap."""
    probs = np.array([[0.5, 0.3, 0.2], [0.1, 0.45, 0.45]], np.float32)
    ref = [(probs, np.array([[0, 1], [1, 2]]))]
    same = chip_smoke.route_diff([(probs, np.array([[1, 0], [2, 1]]))], ref)
    assert same["tokens_routed_otherwise"] == 0 and same["first_layer"] is None
    other = chip_smoke.route_diff([(probs, np.array([[0, 1], [0, 1]]))], ref)
    assert other["tokens_routed_otherwise"] == 1 and other["first_layer"] == 0
    assert other["gaps"][0][:2] == [0, 1]


def test_chip_route_diff_judges_the_first_differing_layer_by_the_routers_drift(chip_smoke):
    """At the first layer whose routes differ, a token routed otherwise is
    a rounding tie only when its experts' gap is within twice the largest
    distance between the two paths' probabilities there; later layers are
    counted, not judged."""
    want = np.array([[0.4, 0.4 + 4e-7, 0.2 - 4e-7], [0.6, 0.3, 0.1]], np.float32)
    drifted = want + np.float32(3e-7) * np.array([[1, -1, 0], [0, 0, 0]], np.float32)
    ids, ref_ids = np.array([[0], [0]]), np.array([[1], [0]])
    tie = chip_smoke.route_diff([(drifted, ids)], [(want, ref_ids)])
    assert tie["first_layer"] == 0 and tie["ties"] and tie["drift"] > 0
    far = want.copy()
    far[0] = [0.3, 0.5, 0.2]
    fault = chip_smoke.route_diff([(far + (drifted - want), ids)], [(far, ref_ids)])
    assert not fault["ties"]
    later = chip_smoke.route_diff([(drifted, ids), (far, np.array([[2], [2]]))],
                                  [(want, ref_ids), (far, np.array([[1], [0]]))])
    assert later["ties"] and later["tokens_routed_otherwise"] == 3
