"""The port stands alone: no module of `repro_torch` and not chip_smoke.py
imports JAX or the reference package, and its entry points run on the CUDA
device unless the caller asks for the CPU."""
import ast
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = (sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
              + sorted((REPO / "examples").glob("torch_*.py")))
FORBIDDEN = ("jax", "jaxlib", "repro")
CUDA_SOURCES = {p.name for p in (REPO / "src" / "repro_torch" / "kernels" / "csrc").glob("*.cu")}


def _imported_roots(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


def test_port_files_are_found():
    names = {p.name for p in PORT_FILES}
    assert {"bl.py", "topk_threshold.py", "problems.py", "chip_smoke.py",
            "bldnn.py", "basis_transform.py", "pytree.py", "layers.py",
            "baselines.py", "tiled_matmul.py", "ops.py", "flash_attention.py",
            "ssd_scan.py", "model.py", "steps.py", "config.py", "convert.py", "serve.py",
            "shapes.py", "gemma3_4b.py", "mamba2_370m.py", "registry.py", "engine.py",
            "artifacts.py", "metrics.py", "__main__.py", "cohort.py", "faults.py",
            "fed_serve.py", "mesh.py", "adamw.py", "pipeline.py", "train.py",
            "flash_attention_bwd.cu", "ssd_scan_bwd.cu", "rules.py", "collectives.py",
            "analysis.py", "torch_train_lm.py", "torch_bl_finetune_head.py"} <= names | CUDA_SOURCES


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_import(path):
    bad = sorted(set(_imported_roots(path)) & set(FORBIDDEN))
    assert not bad, f"{path.relative_to(REPO)} imports {bad}"


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_device_none_means_cuda_and_raises_without_it(monkeypatch):
    from repro_torch import device

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device.resolve(None)
    assert device.resolve("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        device.resolve("meta")


def test_bl1_without_device_raises_when_cuda_is_unavailable(monkeypatch):
    from repro_torch.core import bl, compressors, glm
    from repro_torch.core.basis import make_bases

    clients = glm.make_synthetic(seed=0, n_clients=2, m=8, d=6, r=3, device="cpu")
    bases = make_bases("data_outer", clients)
    x0 = torch.zeros(6, dtype=torch.float64)
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA device"):
        bl.bl1(clients, bases, [compressors.TopK(k=3)] * 2, compressors.Identity(),
               x0, x0, 2)
    with pytest.raises(RuntimeError, match="CUDA device"):
        glm.make_synthetic(seed=0, n_clients=2, m=8, d=6, r=3)


def test_newton_without_device_raises_when_cuda_is_unavailable(monkeypatch):
    from repro_torch.core import baselines, glm
    from repro_torch.core.basis import make_bases

    clients = glm.make_synthetic(seed=0, n_clients=2, m=8, d=6, r=3, device="cpu")
    bases = make_bases("data_outer", clients)
    x0 = torch.zeros(6, dtype=torch.float64)
    _no_cuda(monkeypatch)
    for route in ("einsum", "kernel"):
        with pytest.raises(RuntimeError, match="CUDA device"):
            baselines.newton(clients, x0, x0, 2, bases=bases, basis_project=route)


def test_run_bldnn_without_device_raises_when_cuda_is_unavailable(monkeypatch):
    from repro_torch.exp import problems
    from repro_torch.fed import bldnn

    prob = problems.load_dnn_problem(device="cpu")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA device"):
        bldnn.run_bldnn(prob.loss_fn, prob.eval_fn, prob.params0, prob.batch, 1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        problems.load_dnn_problem()


def test_lm_entry_points_without_device_raise_when_cuda_is_unavailable(monkeypatch):
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.core import prng
    from repro_torch.launch import serve
    from repro_torch.models import convert, model, steps

    cfg = get_config("gemma3_4b").reduced()
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA device"):
        model.init_params(prng.PRNGKey(0), cfg, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA device"):
        model.init_cache(cfg, 1, 8, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA device"):
        steps.stub_inputs(cfg, 1)
    with pytest.raises(RuntimeError, match="CUDA device"):
        convert.params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="CUDA device"):
        serve.main(["--arch", "gemma3_4b", "--debug"])


def test_train_entry_points_without_device_raise_when_cuda_is_unavailable(monkeypatch):
    import numpy as np

    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import train
    from repro_torch.models import convert

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA device"):
        train.main(["--arch", "gemma3_4b", "--debug", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA device"):
        next(make_batch_iterator(100, 9, 2))
    with pytest.raises(RuntimeError, match="CUDA device"):
        convert.opt_state_from_numpy({"m": {"w": np.zeros(2, np.float32)},
                                      "step": np.zeros((), np.int32)})


def test_fed_serve_without_device_raises_when_cuda_is_unavailable(monkeypatch, tmp_path):
    from repro_torch.launch import fed_serve

    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA device"):
        fed_serve.serve(exp_name="fig4", cell_name="BL2_tau_half", max_rounds=2,
                        ckpt_dir=str(tmp_path), log=lambda *a: None)
    with pytest.raises(RuntimeError, match="CUDA device"):
        fed_serve.main(["--exp", "fig4", "--cell", "BL2_tau_half", "--ckpt-dir", str(tmp_path)])
    assert not any(tmp_path.iterdir())


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_fails_without_cuda_or_outside_a_checkout(tmp_path, where):
    """No CUDA device here: the script exits non-zero and prints no result,
    from the repo and from a directory that holds nothing else."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        (tmp_path / "chip_smoke.py").write_text(script.read_text())
        script = tmp_path / "chip_smoke.py"
    proc = subprocess.run([sys.executable, str(script)], capture_output=True,
                          text=True, timeout=120, cwd=script.parent,
                          env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
