"""Two-tier program cache: a serve that starts warm builds nothing — port of
`repro.core.progcache`.

The reference caches XLA executables.  The port runs its rounds eagerly, so
its only compiled artifacts are the kernel libraries that ``nvcc`` builds
from ``kernels/csrc/`` (`repro_torch.kernels._build`).  The two tiers hold
them so:

  * **Tier 1 — manifested entries** in ``<cache_dir>/``, each

        <cache_dir>/<name>-<key>.bin     the payload
        <cache_dir>/<name>-<key>.json    manifest (schema, sha256, env, aux)

    of two kinds.  A *kernel-library entry* (``kernel-<lib>-<key>``) holds
    the ``.so`` bytes ``nvcc`` built; its key is the library's name, the
    content of its sources and the compiler flags (never their location).
    A *program entry* (``serve_init-<key>``, ``serve_chunk-<key>``,
    ``cohort_chunk-<key>``; `repro_torch.core.rounds._Program`) is keyed as
    the reference keys a program — kind, `fingerprint` of the spec and of
    the backend scope, the abstract argument signature — and its payload
    is the JSON list of the kernel libraries the program's first call
    launched, which a hit loads before any round runs.  Every key also
    holds the `env_fingerprint`.
  * **Tier 2** — ``build/repro_torch_kernels/`` at the repository root, as
    `_build` has always kept it (libraries named by the hash of their
    sources): the counterpart of jax's persistent compilation cache, and
    the owner of everything tier 1 does not hold (the LM kernels, training,
    direct calls).

Fallback contract, the reference's: *any* anomaly — a missing entry, a torn
manifest, a payload whose sha256 differs, a foreign schema or environment,
a payload that fails to load — is a MISS of its own class, never an error:
the artifact is built again (tier 2, ``nvcc`` only if tier 2 lacks it) and
the fresh entry replaces the bad one.  A kernel that fails to build or to
load after that still raises.

Writes are atomic: a temporary file of a name unique to the process, then
``os.replace`` and an fsync of the directory, the payload before its
manifest — so concurrent writers (the ranks of a sharded serve, a killed
child) leave at worst an orphaned ``.bin`` that no manifest points at.

Activation: nothing happens unless a cache is active.
`repro_torch.launch.fed_serve` activates one per serve (``--progcache-dir``,
default ``<ckpt_dir>/progcache``); any process may opt in with the
``REPRO_PROGCACHE_DIR`` environment variable (``REPRO_PROGCACHE=0``
force-disables).  With no active cache the round engine's dispatch is its
eager path plus one memo lookup, and `_build` loads from tier 2 alone.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
import hashlib
import itertools
import json
import os
import platform
import sys
import time
from typing import Any, Callable, Optional, Tuple

import torch

SCHEMA_VERSION = 1
#: manifest schema tag of one cache entry (re-exported by
#: `repro_torch.exp.artifacts` beside the checkpoint schemas).  It differs
#: from the reference's tag on purpose: a JAX entry in the same directory
#: reads as ``skew``, a miss.
PROGCACHE_SCHEMA = f"repro_torch.progcache/entry@{SCHEMA_VERSION}"

_SERIALS = itertools.count()


# ==========================================================================
# Environment fingerprint
# ==========================================================================
@functools.lru_cache(maxsize=None)
def env_fingerprint(backend: str = "cpu") -> dict:
    """What can change the artifacts an identical program loads, as plain
    JSON data: torch and its CUDA release, the backend (``"cpu"`` or
    ``"cuda"``), the device count, the card's name and compute capability,
    the compiler flags of the kernel libraries (with the source directory's
    location left out), Python and the machine.  Hostname-free, and with no
    CUDA call for the CPU backend.  The ``nvcc`` release is left out: it
    rides in a library entry's ``aux``, so a host with the card but no
    toolkit still hits."""
    from ..kernels import _build

    env = {"torch": torch.__version__, "cuda": torch.version.cuda, "backend": backend,
           "device_count": 1, "device_kind": "cpu", "capability": None,
           "nvcc_flags": list(_build.portable_flags()),
           "python": "%d.%d.%d" % sys.version_info[:3], "machine": platform.machine()}
    if backend == "cuda":
        env.update(device_count=torch.cuda.device_count(),
                   device_kind=torch.cuda.get_device_name(0),
                   capability=list(torch.cuda.get_device_capability(0)))
    return env


def _backend_of(device) -> str:
    if device is None:
        return "cuda" if torch.cuda.is_available() else "cpu"
    return torch.device(device).type


# ==========================================================================
# Deterministic object fingerprints (the cache-key spec tier)
# ==========================================================================
def fingerprint(obj: Any) -> str:
    """A string for a cache-key object that is the same in every process
    that builds the object the same way.

    Specs are frozen dataclasses, some holding callables (compressors, the
    BL-DNN spec's loss and evaluation functions) whose ``repr`` holds
    process-local addresses.  This walks the object instead: dataclasses by
    qualified class name and field fingerprints, functions by
    ``module.qualname``, defaults and closure-cell contents, floats by
    `float.hex`, tensors by shape, dtype and the sha256 of their bytes,
    containers recursively (dicts in sorted key order).  Anything else
    becomes a type marker: at worst a spurious miss."""
    return _fp(obj, seen=frozenset(), depth=0)


def _tensor_digest(t: torch.Tensor) -> str:
    if t.device.type == "meta":
        return "abstract"
    raw = t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy()
    return hashlib.sha256(raw.tobytes()).hexdigest()[:16]


def _fp(o: Any, *, seen: frozenset, depth: int) -> str:
    if depth > 10:
        return "<depth>"
    if o is None or isinstance(o, (bool, int, str)):
        return repr(o)
    if isinstance(o, float):
        return float.hex(o)
    if isinstance(o, bytes):
        return f"bytes:{hashlib.sha256(o).hexdigest()[:16]}"
    if isinstance(o, (torch.dtype, torch.device)):
        return str(o)
    if isinstance(o, torch.Tensor):
        return f"tensor({tuple(o.shape)},{o.dtype},{_tensor_digest(o)})"
    if id(o) in seen:
        return "<cycle>"
    seen = seen | {id(o)}
    rec = functools.partial(_fp, seen=seen, depth=depth + 1)
    if isinstance(o, (tuple, list)):
        return "[" + ",".join(rec(v) for v in o) + "]"
    if isinstance(o, dict):
        items = sorted(o.items(), key=lambda kv: repr(kv[0]))
        return "{" + ",".join(f"{rec(k)}:{rec(v)}" for k, v in items) + "}"
    if isinstance(o, functools.partial):
        return f"partial({rec(o.func)},{rec(tuple(o.args))},{rec(dict(o.keywords))})"
    if dataclasses.is_dataclass(o) and not isinstance(o, type):
        fields = ",".join(f"{f.name}={rec(getattr(o, f.name))}" for f in dataclasses.fields(o))
        return f"{type(o).__module__}.{type(o).__qualname__}({fields})"
    if callable(o):
        qual = (f"{getattr(o, '__module__', '?')}."
                f"{getattr(o, '__qualname__', type(o).__qualname__)}")
        cells = getattr(o, "__closure__", None) or ()
        closure = ",".join(rec(_cell_contents(c)) for c in cells)
        defaults = rec(getattr(o, "__defaults__", None))
        return f"fn({qual},defaults={defaults},closure=[{closure}])"
    return f"<{type(o).__module__}.{type(o).__qualname__}>"


def _cell_contents(cell):
    try:
        return cell.cell_contents
    except ValueError:          # an empty cell
        return "<empty-cell>"


def entry_key(key_parts: Tuple, backend: str = "cpu") -> str:
    """sha256 over (the caller's key parts, `env_fingerprint`): the entry's
    name on disk.  A manifest's stored environment is compared again on
    load, so a digest can never bring back an entry of another
    environment."""
    blob = json.dumps([[str(p) for p in key_parts], env_fingerprint(backend)],
                      sort_keys=True).encode()
    return hashlib.sha256(blob).hexdigest()[:32]


# ==========================================================================
# Atomic file plumbing (the checkpoint idiom of `exp.artifacts`)
# ==========================================================================
def _sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def _atomic_write(path: str, data: bytes) -> None:
    """``data`` at ``path``, whole or not at all: a temporary file of a
    name no other process uses, fsynced, then ``os.replace`` and an fsync
    of the directory."""
    tmp = f"{path}.{os.getpid()}.{time.monotonic_ns()}.tmp"
    try:
        with open(tmp, "wb") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    try:
        dfd = os.open(os.path.dirname(path) or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(dfd)
    except OSError:
        pass
    finally:
        os.close(dfd)


# ==========================================================================
# The cache
# ==========================================================================
class ProgramCache:
    """One cache directory (tier 1).

    ``backend`` (``"cpu"`` or ``"cuda"``) is the environment a program
    entry is keyed under; kernel-library entries are always keyed under
    ``"cuda"``.  ``stats`` counts lookups: ``hit``, ``miss`` and the miss
    classes ``absent`` / ``corrupt`` / ``skew`` / ``load_error``, plus
    ``store_error`` for a write that failed; ``events`` is the per-entry
    log the serve loop reports in its record's meta."""

    def __init__(self, root: str, backend: str = "cpu"):
        self.root = os.path.abspath(root)
        self.backend = backend
        #: unique in the process (`_build` remembers which caches it has
        #: resolved a library through)
        self.serial = next(_SERIALS)
        os.makedirs(self.root, exist_ok=True)
        self.stats: collections.Counter = collections.Counter()
        self.events: list = []

    def _paths(self, name: str, key: str) -> Tuple[str, str]:
        base = os.path.join(self.root, f"{name}-{key}")
        return base + ".bin", base + ".json"

    def load_manifest(self, name: str, key: str) -> Optional[dict]:
        _, mpath = self._paths(name, key)
        try:
            with open(mpath) as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            return None
        return manifest if isinstance(manifest, dict) else None

    def _verified(self, name: str, key: str, backend: str):
        """(payload path, None) for a sound entry, else (None, miss class)."""
        bpath, mpath = self._paths(name, key)
        manifest = self.load_manifest(name, key)
        if manifest is None:
            return None, "absent" if not os.path.exists(mpath) else "corrupt"
        if manifest.get("schema") != PROGCACHE_SCHEMA:
            return None, "skew"
        if manifest.get("env") != env_fingerprint(backend):
            return None, "skew"
        try:
            if _sha256_file(bpath) != manifest.get("payload_sha256"):
                return None, "corrupt"
        except OSError:
            return None, "corrupt"
        return bpath, None

    def lookup(self, name: str, key: str, load: Callable[[str], Any],
               backend: Optional[str] = None):
        """``(object, status)``: ``load(payload path)`` of a sound entry and
        ``"hit"``, or None and the miss class; counted in ``stats``."""
        backend = backend or self.backend
        path, why = self._verified(name, key, backend)
        obj = None
        if path is not None:
            try:
                obj, why = load(path), "hit"
            except Exception:          # any failure to load is a miss, never an error
                why = "load_error"
        if why == "hit":
            self.stats["hit"] += 1
        else:
            self.stats["miss"] += 1
            self.stats[why] += 1
        self.events.append({"name": name, "key": key, "status": why})
        return obj, why

    def store(self, name: str, key: str, payload: bytes, aux=None,
              backend: Optional[str] = None) -> Optional[str]:
        """Write an entry, payload before manifest; returns the payload's
        path, or None (counted as ``store_error``) when the write failed.
        ``aux`` is a dict of extra facts for the manifest, or a callable
        that returns one when the entry is written."""
        if callable(aux):
            aux = aux()
        bpath, mpath = self._paths(name, key)
        try:
            _atomic_write(bpath, payload)
            manifest = {"schema": PROGCACHE_SCHEMA, "name": name, "key": key,
                        "payload_sha256": hashlib.sha256(payload).hexdigest(),
                        "payload_bytes": len(payload),
                        "env": env_fingerprint(backend or self.backend),
                        "created_unix": time.time(), "aux": aux or {}}
            _atomic_write(mpath, (json.dumps(manifest, indent=1) + "\n").encode())
        except OSError:
            self.stats["store_error"] += 1
            return None
        return bpath

    def load_or_build(self, name: str, key_parts: Tuple, build: Callable[[], bytes],
                      load: Callable[[str], Any], aux=None,
                      fallback: Optional[Callable[[], Any]] = None,
                      backend: Optional[str] = None):
        """The primitive: ``(object, status)``.  A sound entry is loaded
        (``load(payload path)``, status ``"hit"``); on any miss ``build()``
        makes the payload bytes, the entry is stored and the stored payload
        loaded (status: the miss class).  When the store fails the object
        comes from ``fallback()``.  An error of ``build``, or of ``load``
        on the payload just built, propagates."""
        backend = backend or self.backend
        key = entry_key(key_parts, backend)
        obj, why = self.lookup(name, key, load, backend)
        if why == "hit":
            return obj, why
        payload = build()
        path = self.store(name, key, payload, aux, backend)
        if path is None and fallback is not None:
            return fallback(), why
        if path is None:
            raise OSError(f"program cache {self.root}: cannot store {name}-{key}")
        return load(path), why

    def summary(self) -> dict:
        """Operational facts for a record's meta: the directory, the
        stats, the per-entry log, and the kernel libraries this process
        compiled (``nvcc_runs``) and loaded (``dlopens``), by name."""
        from ..kernels import _build

        return {"dir": self.root, "stats": dict(self.stats), "programs": list(self.events),
                "nvcc_runs": dict(_build.nvcc_runs), "dlopens": dict(_build.dlopens)}


# ==========================================================================
# The active cache
# ==========================================================================
_ACTIVE: Optional[ProgramCache] = None
#: whether the environment (`from_env`) has been read: on the first
#: `active()`, unless `activate` / `deactivate` / `scope` came first
_ENV_READ = False


def active() -> Optional[ProgramCache]:
    """The process's active `ProgramCache`, or None (caching off).  The
    first call reads the environment (`from_env`), so a process opts in
    before its first dispatch without any work at import."""
    global _ENV_READ
    if not _ENV_READ:
        _ENV_READ = True
        from_env()
    return _ACTIVE


def activate(root: str, device=None) -> ProgramCache:
    """Make the cache rooted at ``root`` the active one (the same object
    again for the same directory and backend); ``device`` is where the
    programs run (default: the card when there is one)."""
    global _ACTIVE, _ENV_READ
    _ENV_READ = True
    backend = _backend_of(device)
    if _ACTIVE is None or _ACTIVE.root != os.path.abspath(root) or _ACTIVE.backend != backend:
        _ACTIVE = ProgramCache(root, backend)
    return _ACTIVE


def deactivate() -> None:
    global _ACTIVE, _ENV_READ
    _ENV_READ = True
    _ACTIVE = None


@contextlib.contextmanager
def scope(root: Optional[str], device=None):
    """The cache at ``root`` active inside the block (none for a None
    root), the one active before it afterwards."""
    global _ACTIVE, _ENV_READ
    _ENV_READ = True
    before = _ACTIVE
    try:
        if root is None:
            _ACTIVE = None
            yield None
        else:
            yield activate(root, device)
    finally:
        _ACTIVE = before


def from_env() -> Optional[ProgramCache]:
    """Honour ``REPRO_PROGCACHE_DIR`` (subprocesses and tests opt in
    through the environment); ``REPRO_PROGCACHE=0`` turns the cache off."""
    if os.environ.get("REPRO_PROGCACHE", "1") == "0":
        return None
    root = os.environ.get("REPRO_PROGCACHE_DIR")
    if not root:
        return _ACTIVE
    return activate(root)


def validate_entry(manifest_path: str) -> list:
    """Check one entry's manifest (schema, keys, payload sha256); returns
    the problems found (empty: valid)."""
    problems = []
    try:
        with open(manifest_path) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        return [f"{manifest_path}: unreadable manifest ({e})"]
    if not isinstance(manifest, dict):
        return [f"{manifest_path}: the manifest is not a JSON object"]
    if manifest.get("schema") != PROGCACHE_SCHEMA:
        problems.append(f"{manifest_path}: schema {manifest.get('schema')!r} != "
                        f"{PROGCACHE_SCHEMA!r}")
    for req in ("name", "key", "payload_sha256", "env"):
        if req not in manifest:
            problems.append(f"{manifest_path}: missing key {req!r}")
    bpath = manifest_path[:-len(".json")] + ".bin"
    if "payload_sha256" in manifest:
        if not os.path.exists(bpath):
            problems.append(f"{manifest_path}: payload {bpath} missing")
        elif _sha256_file(bpath) != manifest["payload_sha256"]:
            problems.append(f"{manifest_path}: payload sha256 mismatch")
    return problems
