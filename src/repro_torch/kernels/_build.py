"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers) into its own shared library in
``build/repro_torch_kernels/`` at the repository root.  The library's file
name carries the hash of its source and of the shared headers
(``csrc/*.cuh``), so an edited source is rebuilt and an unchanged one is
loaded as it is.  `build_all` starts one ``nvcc`` per
source, all at once.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC))

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built "
                       "with the CUDA toolkit (set CUDA_HOME or PATH)")


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for `name` unless its library is built; returns
    ``(popen or None, tmp, out)``."""
    out = library_path(name)
    if out.exists():
        return None, None, out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish(name: str, proc, tmp, out) -> None:
    if proc is None:
        return
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{log}")
    os.replace(tmp, out)


def build_all(names: Iterable[str]) -> None:
    """Compile every named source in parallel (one nvcc each)."""
    names = list(names)
    started = [(n, *_start(n)) for n in names]
    errors = []
    for n, proc, tmp, out in started:
        try:
            _finish(n, proc, tmp, out)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = _LOADED[name] = ctypes.CDLL(str(library_path(name)))
        return lib


@functools.lru_cache(maxsize=None)
def bind(name: str, fn: str, argtypes: tuple, restype=ctypes.c_int):
    """Entry point `fn` of ``csrc/<name>.cu`` with its ctypes prototype set,
    once per process (setting it costs host time on every call)."""
    f = getattr(load(name), fn)
    f.argtypes = list(argtypes)
    f.restype = restype
    return f
