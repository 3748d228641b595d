"""Build the port's CUDA kernels at first use and load them with ctypes.

Each source under ``csrc/`` has a plain C interface and is compiled by
``nvcc`` alone (no PyTorch headers) into its own shared library in
``build/repro_torch_kernels/`` at the repository root (the program cache's
tier 2).  The library's file name carries the hash of its source and of the
shared headers (``csrc/*.cuh``), so an edited source is rebuilt and an
unchanged one is loaded as it is.  `build_all` starts one ``nvcc`` per
source, all at once.

When a program cache is active (`repro_torch.core.progcache`), `load`
resolves a library through its tier 1 first: a sound entry is loaded as it
is, with no ``nvcc`` and no touch of tier 2; on a miss the library comes
from tier 2 (``nvcc`` only if tier 2 lacks it), is stored in tier 1 and
loaded from there.  A library is loaded once a process, by name, so one
process never loads it from two paths.  ``nvcc_runs`` and ``dlopens``
count, by library, the compiles and loads this process made.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Dict, Iterable, Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-I", str(CSRC))

_LOADED: Dict[str, ctypes.CDLL] = {}
#: ctypes entry points with their prototypes set, by (library, entry, types)
_BOUND: dict = {}
#: (serial of a program cache, library) pairs resolved through its tier 1
_IN_TIER1: set = set()
_progcache = None
#: the sets `recording` fills with the names of the libraries a block used
_RECORDERS: list = []
_LOCK = threading.RLock()
nvcc_runs: collections.Counter = collections.Counter()
dlopens: collections.Counter = collections.Counter()


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


def portable_flags() -> tuple:
    """`NVCC_FLAGS` with the source directory's location left out: what a
    cache key may hold, so that a copy of the sources elsewhere keys the
    same entries."""
    return tuple("<csrc>" if f == str(CSRC) else f for f in NVCC_FLAGS)


def source_digest(name: str) -> str:
    """sha256 of ``csrc/<name>.cu`` and the shared headers (``csrc/*.cuh``)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return h.hexdigest()


def library_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"{name}-{source_digest(name)[:16]}.so"


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
    nvcc_runs[name] += 1
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


def _nvcc_release() -> Optional[str]:
    """The last line of ``nvcc --version``, or None without a toolkit."""
    try:
        out = subprocess.run([_nvcc(), "--version"], capture_output=True, text=True,
                             timeout=60).stdout
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    return lines[-1] if lines else None


def _open(name: str, path) -> ctypes.CDLL:
    """dlopen the library file at ``path`` (counted in ``dlopens``)."""
    lib = ctypes.CDLL(str(path))
    dlopens[name] += 1
    return lib


def _through_tier1(cache, name: str) -> ctypes.CDLL:
    """The library ``name`` resolved through ``cache``'s tier 1 (see the
    module docstring); a library this process has loaded already stays the
    one it uses, and only its entry is checked or stored."""
    loaded = _LOADED.get(name)

    def load(path):
        return loaded if loaded is not None else _open(name, path)

    def build() -> bytes:
        if loaded is None:
            _finish(name, *_start(name))
        return library_path(name).read_bytes()

    def aux() -> dict:
        return {"library": name, "nvcc": _nvcc_release() if nvcc_runs[name] else None}

    lib, _ = cache.load_or_build(
        name=f"kernel-{name}", key_parts=_key_parts(name), build=build, load=load, aux=aux,
        backend="cuda", fallback=lambda: load(library_path(name)))
    return lib


def _key_parts(name: str) -> tuple:
    """A library's cache key: its name, its sources' content and the
    compiler flags — never where the sources lie."""
    return ("kernel", name, source_digest(name), portable_flags())


def entry_name(name: str) -> str:
    """The tier-1 entry name (``kernel-<lib>-<key>``) of library ``name``."""
    return f"kernel-{name}-{_pc().entry_key(_key_parts(name), 'cuda')}"


def _pc():
    """The `repro_torch.core.progcache` module (imported at first use)."""
    global _progcache
    if _progcache is None:
        from ..core import progcache as _progcache
    return _progcache


def _active_cache():
    return _pc().active()


def note(name: str) -> None:
    """Record a use of library ``name`` in every open `recording` block."""
    for used in _RECORDERS:
        used.add(name)


class recording:
    """``with recording() as used:`` — ``used`` holds the names of the
    kernel libraries the block launched (through `bind` or `load`)."""

    def __enter__(self) -> set:
        self.used = set()
        _RECORDERS.append(self.used)
        return self.used

    def __exit__(self, *exc) -> None:
        _RECORDERS.remove(self.used)


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``: through the active program
    cache's tier 1 when there is one, else from tier 2, building it if
    needed."""
    note(name)
    cache = _active_cache()
    with _LOCK:
        if cache is not None and (cache.serial, name) not in _IN_TIER1:
            lib = _LOADED[name] = _through_tier1(cache, name)
            _IN_TIER1.add((cache.serial, name))
            return lib
        lib = _LOADED.get(name)
        if lib is None:
            _finish(name, *_start(name))
            lib = _LOADED[name] = _open(name, library_path(name))
        return lib


def bind(name: str, fn: str, argtypes: tuple, restype=ctypes.c_int):
    """Entry point `fn` of ``csrc/<name>.cu`` with its ctypes prototype set,
    once per process (setting it costs host time on every call).  Every
    call counts as a use of the library (`recording`), and under a newly
    active program cache resolves it through that cache once."""
    note(name)
    key = (name, fn, argtypes, restype)
    f = _BOUND.get(key)
    if f is None:
        f = getattr(load(name), fn)
        f.argtypes = list(argtypes)
        f.restype = restype
        _BOUND[key] = f
    else:
        cache = _active_cache()
        if cache is not None and (cache.serial, name) not in _IN_TIER1:
            load(name)
    return f
