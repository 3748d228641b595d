"""The LM's reductions (`repro_torch.sharding.collectives`): an all-to-all
of parts and a sum in rank order (a reduce-scatter; an all-reduce adds an
all-gather of the reduced slices), held bitwise to the n-copy form (every
rank's operand gathered, summed in rank order) on gloo CPU worlds of 2, 3
and 4 ranks (`tests/torch_lm_sharded_worker.py`, case ``reductions``):
float32, bfloat16 and float64, sizes that do not divide by the ranks,
``dim`` 0 and last, sum and max.  The bytes ``stats`` counts a call, on
those worlds and on torch's fake process group of 16 ranks: |x| for a
reduce-scatter, 2·|x| (padded to a multiple of the ranks) for an
all-reduce.  And the MoE's expert counts, now a fixed-size scatter-add,
keep the load-balance loss bitwise the ``bincount`` form's.
"""
import json
import os
import pathlib
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import mesh as LM
from repro_torch.models import layers as L
from repro_torch.sharding import collectives as C

REPO = pathlib.Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "torch_lm_sharded_worker.py"
#: (data, model) meshes of the worlds: 2, 3 and 4 ranks
MESHES = ((1, 2), (1, 3), (2, 2))
DTYPES = ("float32", "bfloat16", "float64")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _free_port() -> int:
    """A free port below Linux's ephemeral range (as
    `test_torch_lm_sharded._free_port`)."""
    rng = np.random.default_rng()
    while True:
        port = int(rng.integers(20000, 32000))
        with socket.socket() as s:
            try:
                s.bind(("localhost", port))
            except OSError:
                continue
            return port


def _launch(tmp: pathlib.Path, mesh: tuple) -> dict:
    """The worker's ``reductions`` case on a gloo CPU world laid out as
    `mesh`; its results by rank."""
    (tmp / "out").mkdir(parents=True)
    job = tmp / "job.json"
    job.write_text(json.dumps({"data": mesh[0], "model": mesh[1], "device": "cpu",
                               "inputs": str(tmp), "out": str(tmp / "out"),
                               "cases": [{"name": "reductions", "kind": "reductions",
                                          "dtypes": list(DTYPES)}]}))
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
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{logs[r][-4000:]}"
    return {r: pickle.loads((tmp / "out" / f"rank{r}.pkl").read_bytes())["results"]
            ["reductions"]["checks"] for r in range(W)}


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def world(request, tmp_path_factory):
    mesh = request.param
    return mesh, _launch(tmp_path_factory.mktemp("x".join(map(str, mesh))), mesh)


def test_reductions_are_the_n_copy_form_bitwise(world):
    mesh, ranks = world
    for r, res in ranks.items():
        kinds = {key[1] for key in res}
        assert kinds == {"all_reduce/sum", "all_reduce/max", "reduce_scatter"}, kinds
        assert {key[2] for key in res} == set(DTYPES)
        bad = [key for key, (equal, _, _) in res.items() if not equal]
        assert not bad, f"rank {r}: not the n-copy form's bits: {bad}"


def test_reductions_count_one_copy(world):
    """A reduce-scatter counts |x|, an all-reduce 2·|x| with x padded to a
    multiple of the ranks."""
    mesh, ranks = world
    for res in ranks.values():
        for (axes, kind, dtype, shape, dim), (_, moved, size) in res.items():
            n = mesh[0] * mesh[1] if len(axes) == 2 else mesh[["data", "model"].index(
                axes[0])]
            if kind == "reduce_scatter":
                assert moved == size, (axes, kind, dtype, shape)
            else:
                elem = size // int(np.prod(shape))
                padded = -(-int(np.prod(shape)) // n) * n
                assert moved == 2 * padded * elem, (axes, kind, dtype, shape)


@pytest.fixture
def fake16():
    """Rank 0 of torch's fake process group of 16 ranks, a (1, 16) mesh."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16)
    try:
        yield LM.make_debug_mesh(1, 16, device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("numel", [16 * 5, 16 * 5 + 3, 1])
def test_stats_count_one_copy_on_a_fake_world_of_16(fake16, numel):
    mesh = fake16
    x = torch.zeros((numel,), dtype=torch.float32)
    C.reset_stats()
    C.all_reduce(x, mesh, "model")
    assert C.stats["all_reduce"] == {"calls": 1, "bytes": 2 * (-(-numel // 16) * 16) * 4}
    C.reset_stats()
    y = C.reduce_scatter(torch.zeros((16, numel), dtype=torch.bfloat16), mesh, "model", 0)
    assert y.shape == (1, numel)
    assert C.stats["reduce_scatter"] == {"calls": 1, "bytes": 16 * numel * 2}
    C.reset_stats()
    C.all_gather(x, mesh, "model")
    assert C.stats["all_gather"] == {"calls": 1, "bytes": 16 * numel * 4}


def test_reduce_scatter_refuses_parts_that_do_not_divide(fake16):
    with pytest.raises(ValueError, match="equal parts"):
        C.reduce_scatter(torch.zeros((17, 3)), fake16, "model", 0)


def test_moe_expert_counts_keep_aux_bitwise():
    """The router's load-balance loss from the fixed-size expert counts
    equals the ``bincount`` form's bit for bit."""
    cfg = configs.get_config("deepseek_moe_16b").reduced()
    mc = cfg.moe
    gen = torch.Generator().manual_seed(0)
    for T in (1, 37, 512):
        xt = torch.randn((T, cfg.d_model), generator=gen)
        router = torch.randn((cfg.d_model, mc.n_experts), generator=gen) * 0.1
        probs, _, ids, aux = L._router(xt, router, cfg)
        E, K = mc.n_experts, mc.top_k
        ce = torch.bincount(ids.reshape(-1), minlength=E).float() / (T * K)
        want = E * torch.sum(probs.mean(0) * ce) * mc.router_aux_weight
        assert aux.dtype == want.dtype and torch.equal(aux, want), T
