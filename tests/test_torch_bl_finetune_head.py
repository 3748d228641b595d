"""`examples/torch_bl_finetune_head.py` against the reference's
`examples/bl_finetune_head.py` at the script's own sizes, on the CPU.

Both sides draw the reduced stablelm-12b weights from ``PRNGKey(0)`` under
one threefry setting (``jax_threefry_partitionable`` False, the port's
default) and the tokens, probe and labels from numpy's generator seeded 0.
Tolerances and why:

  * the backbone's features: 1e-5·max|ref| (float32 forwards through
    different gemms);
  * the GLM runs, both fed the reference's features: gaps in the GLM gate
    (|Δ| ≤ 1e-8·|ref| + 1e-12, as `test_torch_bl1.py`), bits exact.
"""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import baselines as jbaselines
from repro.core import bl as jbl
from repro.core import glm as jglm
from repro.core.basis import StandardBasis as JStandardBasis
from repro.core.basis import orth_basis_from_data as j_orth
from repro.core.compressors import Identity as JIdentity
from repro.core.compressors import RankR as JRankR
from repro.core.compressors import TopK as JTopK
from repro.models import model as JM
from repro_torch.core import prng

REPO = pathlib.Path(__file__).resolve().parents[1]
FEATURE_TOL = 1e-5
GAP_RTOL, GAP_ATOL = 1e-8, 1e-12


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def example():
    spec = importlib.util.spec_from_file_location(
        "torch_bl_finetune_head", REPO / "examples" / "torch_bl_finetune_head.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref(example):
    """The reference script's steps: features, fleet and its three runs."""
    cfg = j_get_config("stablelm_12b").reduced()
    with jax.threefry_partitionable(False):
        params = JM.init_params(jax.random.PRNGKey(0), cfg, jnp.float32)
    rng = np.random.default_rng(0)
    fwd = jax.jit(lambda p, t: JM.forward(p, cfg, None, t, remat=False,
                                          return_hidden=True)[0])
    feats = []
    for _ in range(example.N_CLIENTS):
        toks = jnp.asarray(rng.integers(0, cfg.vocab_size, (example.M_ROWS, example.SEQ)),
                           jnp.int32)
        feats.append(np.asarray(fwd(params, toks).mean(axis=1), np.float64))
    d = cfg.d_model
    w_true = rng.standard_normal(d) / np.sqrt(d)
    clients, labels = [], []
    for F in feats:
        z = F @ w_true
        b = np.where(rng.random(F.shape[0]) < 1 / (1 + np.exp(-2 * z)), 1.0, -1.0)
        labels.append(b)
        clients.append(jglm.ClientData(A=jnp.asarray(F), b=jnp.asarray(b), lam=1e-2))
    x0 = jnp.zeros(d, jnp.float64)
    xs = jglm.newton_solve(clients, x0, 20)
    bases = [j_orth(c.A) for c in clients]
    sbases = [JStandardBasis(d) for _ in clients]
    runs = {
        "BL1 (feature basis)": jbl.bl1(clients, bases, [JTopK(k=b.r) for b in bases],
                                       JIdentity(), x0, xs, 30),
        "FedNL (Rank-1)": jbl.bl1(clients, sbases, [JRankR(r=1) for _ in clients],
                                  JIdentity(), x0, xs, 30),
        "GD": jbaselines.gd(clients, x0, xs, 150),
    }
    return dict(feats=feats, labels=labels, runs=runs)


def test_features_match_the_reference(ref, example):
    with prng.threefry_partitionable(False):
        cfg, params = example.backbone("cpu")
    feats = example.features(params, cfg, np.random.default_rng(0), "cpu")
    assert len(feats) == len(ref["feats"]) == example.N_CLIENTS
    for got, want in zip(feats, ref["feats"]):
        assert got.shape == want.shape == (example.M_ROWS, cfg.d_model)
        err, scale = float(np.abs(got - want).max()), float(np.abs(want).max())
        assert err <= FEATURE_TOL * scale, f"|Δ| {err} > {FEATURE_TOL}·{scale}"


def test_runs_on_the_references_features_match(ref, example):
    """The fleet built from the reference's features (the generator past the
    same token draws), then BL1, FedNL and GD as the reference runs them."""
    rng = np.random.default_rng(0)
    for _ in range(example.N_CLIENTS):
        rng.integers(0, 2, (example.M_ROWS, example.SEQ))     # the tokens' draws
    clients = example.make_clients(ref["feats"], rng, "cpu")
    for c, b in zip(clients, ref["labels"]):
        np.testing.assert_array_equal(c.b.numpy(), b)
    runs = example.run_all(clients, "cpu")
    assert list(runs) == list(ref["runs"])
    for name, h in runs.items():
        jh = ref["runs"][name]
        g, gr = np.asarray(h.gaps), np.asarray(jh.gaps)
        assert g.shape == gr.shape
        bad = np.abs(g - gr) > GAP_RTOL * np.abs(gr) + GAP_ATOL
        assert not bad.any(), f"{name}: rounds {np.nonzero(bad)[0]}: {g[bad]} vs {gr[bad]}"
        assert list(h.up_bits) == list(jh.up_bits), name
        assert list(h.down_bits) == list(jh.down_bits), name


def test_main_prints_the_table_on_the_cpu(example, capsys):
    runs = example.main(["--device", "cpu"])
    assert set(runs) == {"BL1 (feature basis)", "FedNL (Rank-1)", "GD"}
    out = capsys.readouterr().out
    assert "per-client feature rank" in out and "Mbits/node to 1e-7" in out


def test_main_without_device_raises_when_cuda_is_unavailable(example, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        example.main([])
