"""The LM dry run (`repro_torch.launch.dryrun`) and the kernels' fake-tensor
routes (`repro_torch.kernels._fake`) against the JAX package and the
port's own CPU route.

* Arguments: for every config × the reference's four input shapes × both
  production meshes, a rank's argument bytes equal those of the
  reference's dry run (`tests/torch_lm_specs_worker.py ref`: its
  parameters, AdamW moments, batch and cache, each shard's shape from its
  `NamedSharding`), each storage rounded as the CUDA allocator rounds it;
  `shape_applicable` skips the same cases.  ``model_flops`` equals
  `repro.models.analysis.model_flops`.
* Flops: at reduced configs on the (1, 1) debug mesh, a fake step's
  `FlopCounterMode` total equals the CPU plain route's count of the same
  step on real tensors exactly (train, prefill and decode); each kernel's
  fake route counts what the counter counts for its plain version.
* Collectives: at (2, 2) and (1, 3), a fake step's calls and bytes by kind
  equal each gloo CPU rank's `collectives.stats` for the same step
  (`tests/torch_lm_sharded_worker.py`).
* ``--extrapolate`` equals the full count for two stacks of whole groups;
  the reference's two failing cases (ROADMAP.md §3) are ``ok`` here;
  ``--progcache-dir`` gives the same records and an empty cache summary;
  a real tensor never takes a fake route.
"""
import contextlib
import dataclasses
import io
import json
import math
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import configs
from repro_torch.core import prng
from repro_torch.kernels import _fake
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ssd_scan as ss
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as LM
from repro_torch.launch.shapes import InputShape
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.optim import adamw_init
from repro_torch.sharding import rules as R

REPO = pathlib.Path(__file__).resolve().parents[1]
SPECS = REPO / "tests" / "torch_lm_specs_worker.py"
WORKER = REPO / "tests" / "torch_lm_sharded_worker.py"
MESHES = {"16x16": False, "2x16x16": True}
#: reduced configs whose flops are counted on both routes, and their
#: over-rides (grouped KV heads kept, as `test_torch_lm_sharded.py`'s)
FLOP_CFGS = {"gemma3_4b": dict(n_kv_heads=2), "mamba2_370m": {}, "deepseek_moe_16b": {},
             "whisper_small": {}, "qwen2_vl_72b": dict(n_kv_heads=2)}
#: cases run on gloo ranks and dry-run alike: (mesh, worker case)
RANK_CASES = {
    (2, 2): [dict(name="train/stablelm_12b", kind="train", arch="stablelm_12b",
                  over=dict(n_kv_heads=2, head_dim=160), B=4, S=16, remat=True, steps=1,
                  rerun=False, keep_grads=False),
             dict(name="train/mamba2_370m", kind="train", arch="mamba2_370m", B=4, S=32,
                  remat=False, steps=1, rerun=False, keep_grads=False),
             dict(name="serve/deepseek_moe_16b", kind="serve", arch="deepseek_moe_16b", B=2,
                  S=32, max_seq=40, gen=1, rerun=False)],
    (1, 3): [dict(name="serve/gemma3_4b", kind="serve", arch="gemma3_4b",
                  over=dict(n_kv_heads=2), layers=6, B=2, S=48, max_seq=60, gen=1,
                  rerun=False),
             dict(name="train/gemma3_4b", kind="train", arch="gemma3_4b",
                  over=dict(n_kv_heads=2), layers=6, B=2, S=48, remat=False, steps=1,
                  rerun=False, keep_grads=False)],
}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _rounded_bytes(leaves) -> int:
    return sum(dryrun._rounded(math.prod(shape) * size) for shape, size in leaves)


# ----------------------------- arguments -------------------------------------
@pytest.fixture(scope="module")
def ref_args(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref") / "ref.json"
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, str(SPECS), "ref", str(out)], env=env, check=True,
                   timeout=600)
    return json.loads(out.read_text())["args"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_argument_bytes_are_the_references(ref_args, mesh):
    from repro.models import analysis as janalysis
    from repro import configs as jconfigs

    for arch in configs.ARCH_IDS:
        for shape in dryrun.REFERENCE_SHAPES:
            rec = dryrun.lower_case(arch, shape, multi_pod=MESHES[mesh], compile_=False)
            ref = ref_args[mesh][arch][shape]
            if ref == "skipped":
                assert rec["status"] == "skipped", (arch, shape)
                continue
            assert rec["status"] == "lowered" and rec["mesh"] == mesh, (arch, shape)
            assert rec["memory"]["argument_size_bytes"] == _rounded_bytes(ref), (arch, shape)
            s = dryrun.SH.SHAPES[shape]
            if mesh == "16x16":             # the same on either mesh
                assert rec["cost"]["model_flops"] == janalysis.model_flops(
                    jconfigs.get_config(arch), s.kind, s.global_batch, s.seq_len), (arch, shape)


# ----------------------------- flops -----------------------------------------
def _reduced(arch):
    """The reduced config; gemma3's cut to its first 6 layers (5 window
    layers and the global one)."""
    cfg = configs.get_config(arch).reduced(**FLOP_CFGS.get(arch, {}))
    return dryrun.cut(cfg, layers=6) if arch == "gemma3_4b" else cfg


def _cpu_flops(cfg, shape: InputShape) -> int:
    """The step's `FlopCounterMode` total on real CPU tensors (the plain
    versions) on the one-rank (1, 1) mesh, as `dry_run` builds it."""
    mesh = LM.make_debug_mesh(1, 1, device="cpu")
    rules = R.make_rules(mesh, batch_size=shape.global_batch,
                         seq_parallel=R.wants_seq_parallel(cfg, mesh)).bind(cfg)
    params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu", rules=rules)
    rng = np.random.default_rng(0)
    B = shape.global_batch
    S = {"train": shape.seq_len + 1, "prefill": shape.seq_len, "decode": 1}[shape.kind]
    batch = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (B, S)), dtype=torch.int32)}
    if cfg.n_enc_layers:
        batch["frames"] = torch.randn((B, cfg.enc_seq, cfg.d_model))
    if cfg.n_prefix_embeds and shape.kind != "decode":
        batch["prefix_embeds"] = torch.randn((B, cfg.n_prefix_embeds, cfg.d_model))
    n = shape.seq_len + (cfg.n_prefix_embeds if shape.kind == "prefill" else 0)
    with FlopCounterMode(display=False) as fc:
        if shape.kind == "train":
            steps.make_train_step(cfg, rules)(params, adamw_init(params, torch.float32), batch)
        else:
            cache = M.init_cache(cfg, B, n, torch.float32, device="cpu", rules=rules)
            if shape.kind == "prefill":
                steps.make_prefill_step(cfg, rules)(params, batch, cache)
            else:
                steps.make_serve_step(cfg, rules)(params, batch, cache, n - 1)
    return fc.get_total_flops()


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", list(FLOP_CFGS))
def test_fake_step_flops_equal_the_cpu_routes(arch, kind):
    cfg = _reduced(arch)
    shape = InputShape(f"{kind}_32", 32, 2, kind)
    rec = dryrun.dry_run(cfg, shape, (1, 1), dtype=torch.float32)
    assert rec["status"] == "ok"
    assert rec["cost"]["flops"] == _cpu_flops(cfg, shape) > 0


ATTN_SHAPES = [(2, 8, 8, 4, 2, 16, True, None, 0), (1, 5, 12, 6, 3, 8, True, 4, 7),
               (2, 7, 9, 2, 2, 32, False, None, 0)]
#: (B, S, H, hd, N, chunk): several chunks, a chunk that shrinks to a
#: divisor, one chunk
SSD_SHAPES = [(2, 16, 3, 8, 4, 8), (1, 12, 2, 4, 8, 5), (2, 256, 2, 16, 8, 64),
              (2, 32, 3, 8, 4, 32)]


def _counted(fn) -> int:
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ATTN_SHAPES)
def test_attention_fake_route_counts_the_plain_versions_flops(case, dtype):
    from torch._subclasses.fake_tensor import FakeTensorMode

    B, Sq, Sk, H, KVH, hd, causal, window, q0 = case
    kw = dict(causal=causal, window=window, q_pos0=q0)

    def run(dev):
        q = torch.randn((B, Sq, H, hd), device=dev).to(dtype).requires_grad_(True)
        k = torch.randn((B, Sk, KVH, hd), device=dev).to(dtype).requires_grad_(True)
        v = torch.randn((B, Sk, KVH, hd), device=dev).to(dtype).requires_grad_(True)
        return lambda: fa.flash_attention(q, k, v, **kw).float().sum().backward()

    plain = _counted(run("cpu"))
    before = (fa.launches, fa.bwd_launches)
    with FakeTensorMode():
        fake = _counted(run("cpu"))
    assert fake == plain == _fake.attention_flops(B, Sq, Sk, H, hd) * 3
    assert (fa.launches, fa.bwd_launches) == before        # a fake route launches nothing


@pytest.mark.parametrize("case", SSD_SHAPES)
def test_ssd_fake_route_counts_the_plain_versions_flops(case):
    from torch._subclasses.fake_tensor import FakeTensorMode

    Bs, S, H, hd, N, chunk = case
    shapes = [(Bs, S, H, hd), (Bs, S, H), (H,), (Bs, S, N), (Bs, S, N)]

    def run(with_state):
        args = [torch.randn(s).requires_grad_(True) for s in shapes]

        def go():
            y, st = ss.ssd_scan(*args, chunk=chunk)
            (y.sum() + st.sum() if with_state else y.sum()).backward()
        return go

    for with_state in (True, False):
        plain = _counted(run(with_state))
        before = (ss.launches, ss.bwd_launches)
        with FakeTensorMode():
            fake = _counted(run(with_state))
        assert fake == plain == _fake.ssd_flops(Bs, S, H, hd, N, chunk) + _fake.ssd_flops(
            Bs, S, H, hd, N, chunk, backward=True, dstate=with_state)
        assert (ss.launches, ss.bwd_launches) == before


def test_fake_routes_allocate_the_cuda_paths_workspaces():
    """Kernel 6's forward keeps its workspace for 6b, at the library's
    size; 5b's and 6b's own are made and freed within the call."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty((2, 300, 3, 16))
        args = (x, torch.empty((2, 300, 3)), torch.empty((3,)), torch.empty((2, 300, 8)),
                torch.empty((2, 300, 8)))
        y, state, ws = ss._kernel(*args)
        assert (y.shape, state.shape) == ((2, 300, 3, 16), (2, 3, 16, 8))
        # 3 chunks of 128: decays 2·3·3·128, chunk decays 2·3·3, C·Bᵀ 2·3·128², states
        assert ws.numel() == 2304 + 20 + 98304 + 2304 == _fake.ssd_workspace_floats(
            2, 300, 3, 16, 8)
        grads = ss._kernel_bwd(*args, torch.empty_like(y), None, ws)
        assert [g.shape for g in grads] == [a.shape for a in args]
        q = torch.empty((1, 130, 4, 64), dtype=torch.bfloat16)
        kv = torch.empty((1, 130, 2, 64), dtype=torch.bfloat16)
        assert fa._kernel(q, kv, kv, True, None).shape == q.shape
        assert [t.shape for t in fa._kernel_bwd(q, kv, kv, q, True, None)] == [
            q.shape, kv.shape, kv.shape]
        # bfloat16 with grouped heads: float32 partial sums of dv and dk
        outs = _fake.ops().flash_attention_bwd(q, kv, kv, q, True, 0, 0)
        assert outs[4].numel() == 2 * 130 * 2 * 64 == _fake.attention_bwd_partial_floats(
            True, 1, 130, 4, 2, 64)
        outs = _fake.ops().flash_attention_bwd(q.float(), kv.float(), kv.float(), q.float(),
                                               True, 0, 0)
        assert outs[4].numel() == 0
    assert _fake.attention_bwd_workspace_floats(1, 130, 4) == 3 * 4 * 256


def test_a_real_tensor_never_takes_a_fake_route():
    q = torch.zeros((1, 4, 2, 8))
    with pytest.raises(RuntimeError, match="fake-tensor route"):
        torch.ops.repro_torch.flash_attention(q, q, q, True, 0, 0)
    x = torch.zeros((1, 4, 2, 8))
    with pytest.raises(RuntimeError, match="fake-tensor route"):
        torch.ops.repro_torch.ssd_scan(x, x[..., 0], x[0, 0, :, 0], x[:, :, 0],
                                       x[:, :, 0], 4)


# ----------------------------- collectives -----------------------------------
def _free_port() -> int:
    rng = np.random.default_rng()
    while True:
        port = int(rng.integers(20000, 32000))
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port


def _case_cfg(case):
    return configs.get_config(case["arch"]).reduced(**case.get("over", {}))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each mesh's cases on gloo CPU ranks: their results by rank."""
    out = {}
    for mesh, cases in RANK_CASES.items():
        tmp = tmp_path_factory.mktemp("x".join(map(str, mesh)))
        (tmp / "out").mkdir()
        jobs = []
        for i, case in enumerate(cases):
            cfg = _case_cfg(case)
            S = case["S"] + (1 if case["kind"] == "train" else 0)
            toks = np.random.default_rng(i).integers(0, cfg.vocab_size, (case["B"], S))
            np.savez(tmp / f"in{i}.npz", tokens=toks.astype(np.int32))
            jobs.append(dict(case, inputs=f"in{i}.npz"))
        job = tmp / "job.json"
        job.write_text(json.dumps({"data": mesh[0], "model": mesh[1], "device": "cpu",
                                   "inputs": str(tmp), "out": str(tmp / "out"),
                                   "cases": jobs}))
        W, port = mesh[0] * mesh[1], _free_port()
        procs = []
        for r in range(W):
            env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="1",
                       MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(r),
                       LOCAL_RANK=str(r), WORLD_SIZE=str(W), LOCAL_WORLD_SIZE=str(W),
                       REPRO_DIST_TIMEOUT_S="120")
            procs.append(subprocess.Popen([sys.executable, str(WORKER), str(job)], env=env,
                                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                          text=True))
        logs = [p.communicate(timeout=600)[0] for p in procs]
        for r, p in enumerate(procs):
            assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}"
        out[mesh] = {r: pickle.loads((tmp / "out" / f"rank{r}.pkl").read_bytes())["results"]
                     for r in range(W)}
    return out


@pytest.mark.parametrize("mesh,name", [(m, c["name"]) for m, cs in RANK_CASES.items()
                                       for c in cs])
def test_fake_collectives_equal_each_ranks(ranks, mesh, name):
    case = next(c for c in RANK_CASES[mesh] if c["name"] == name)
    shape = InputShape(name, case["S"], case["B"], "train" if case["kind"] == "train"
                       else "prefill")
    rec = dryrun.dry_run(_case_cfg(case), shape, mesh, layers=case.get("layers"),
                         dtype=torch.float32, remat=case.get("remat", True),
                         max_seq=case.get("max_seq"))
    assert rec["status"] == "ok"
    key = "step0_stats" if case["kind"] == "train" else "prefill_step_stats"
    for r, res in ranks[mesh].items():
        got = res[name][key]
        assert rec["collectives"]["counts"] == {k: v["calls"] for k, v in got.items()}, r
        assert rec["collectives"]["bytes_by_kind"] == {k: float(v["bytes"])
                                                       for k, v in got.items()}, r
    assert sum(rec["collectives"]["counts"].values()) > 0


# ----------------------------- the CLI ---------------------------------------
def test_extrapolation_equals_the_full_count_for_whole_groups():
    """Flops and collective bytes are affine in the number of groups.  The
    bytes accessed are not: each group's gradient of a stacked leaf is
    written into a zero tensor of the whole stack (the backward of taking
    the group's slice), so they grow faster than the groups."""
    shape = InputShape("train_16", 16, 4, "train")
    for arch, layers in (("mamba2_370m", 4), ("stablelm_12b", 3)):
        cfg = dataclasses.replace(configs.get_config(arch).reduced(), n_layers=layers)
        full = dryrun.dry_run(cfg, shape, (2, 2), dtype=torch.float32)
        corr = dryrun.extrapolate_costs(cfg, shape, (2, 2), dtype=torch.float32)
        assert corr["flops"] == full["cost"]["flops"] > 0, arch
        assert corr["collective_bytes"] == full["collectives"]["total_bytes"] > 0, arch
        assert "cross-check" in corr["note"]


@pytest.mark.parametrize("arch,shape", [("whisper_small", "decode_32k"),
                                        ("mamba2_370m", "long_500k")])
def test_the_references_failing_cases_run_in_the_port(arch, shape):
    rec = dryrun.lower_case(arch, shape)
    assert rec["status"] == "ok", rec
    assert rec["memory"]["argument_size_bytes"] > 0 and rec["cost"]["flops"] > 0


def test_cli_runs_a_case_and_refuses_a_program_cache(tmp_path):
    out = tmp_path / "out.json"
    assert dryrun.main(["--arch", "mamba2_370m", "--shape", "long_500k", "--no-compile",
                        "--out", str(out)]) == 0
    (rec,) = json.loads(out.read_text())
    assert rec["status"] == "lowered" and rec["mesh"] == "16x16"
    # the program cache (item 16) is ported: the same records with it on,
    # and an empty summary (no kernel launches on fake tensors)
    out_pc = tmp_path / "out_pc.json"
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        assert dryrun.main(["--arch", "mamba2_370m", "--shape", "long_500k", "--no-compile",
                            "--out", str(out_pc), "--progcache-dir",
                            str(tmp_path / "pc")]) == 0
    (rec_pc,) = json.loads(out_pc.read_text())
    drop = ("lower_s",)
    assert {k: v for k, v in rec_pc.items() if k not in drop} == \
        {k: v for k, v in rec.items() if k not in drop}
    summary = json.loads(err.getvalue().split("# progcache ", 1)[1])
    assert summary["stats"] == {} and summary["programs"] == []
    assert summary["dir"] == str(tmp_path / "pc") and not list((tmp_path / "pc").iterdir())
