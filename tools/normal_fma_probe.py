"""Which multiply-adds XLA's CPU code fuses in ``jax.random.normal``, and
what each fusion is worth to the port's bit-for-bit `prng.normal`.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/normal_fma_probe.py [--draws N]

1. Compiles ``jax.random.normal(PRNGKey(0), (1024,), float32)`` in a child
   process with ``XLA_FLAGS=--xla_dump_to=<tmp>`` and counts, in
   ``objdump -d`` of each emitted object file, the fused multiply-adds
   (``vfmadd*``, ``vfnmadd*``) beside the separate multiplies and adds.
2. Draws N normals (default 10⁶) with the port and with jax under
   ``jax_threefry_partitionable=False`` and counts the draws whose bits
   differ: with `xla_math.fma` as it is (one rounding), with every fused
   step rounded twice (multiply, then add), and with each fused step
   computed in float64 and rounded once to float32 (double rounding).

Prints one JSON object.  Needs jax, binutils' ``objdump`` and a CPU.
"""
from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import re
import subprocess
import sys
import tempfile

CHILD = ("import jax, jax.numpy as jnp; "
         "jax.random.normal(jax.random.PRNGKey(0), (1024,), jnp.float32).block_until_ready()")


def count_instructions(dump: pathlib.Path) -> dict:
    out = {}
    for obj in sorted(dump.glob("*jit__normal*.o")):
        text = subprocess.run(["objdump", "-d", "--no-show-raw-insn", str(obj)],
                              capture_output=True, text=True, check=True).stdout
        ops = collections.Counter(re.findall(r"\t(v(?:fn?madd|mul|add)\w*)\s", text))
        fused = {k: v for k, v in ops.items() if "madd" in k}
        if fused:
            out[obj.name.split("obj-file.")[-1]] = dict(sorted(ops.items()))
    return out


def mismatches(n: int) -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import torch

    from repro_torch.core import prng, xla_math

    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (n,), jnp.float32))

    def twice(a, b, c):
        like = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
        a, b, c = (xla_math._t(x, like) for x in (a, b, c))
        return a * b + c

    def double_rounded(a, b, c):
        like = next(x for x in (a, b, c) if isinstance(x, torch.Tensor))
        a, b, c = (xla_math._t(x, like).double() for x in (a, b, c))
        return (a * b + c).float()

    out, fma = {}, xla_math.fma
    try:
        for name, fn in (("fma_rounded_once", fma), ("multiply_then_add", twice),
                         ("float64_then_float32", double_rounded)):
            xla_math.fma = fn
            got = prng.normal(prng.PRNGKey(5), (n,), partitionable=False).numpy()
            out[name] = int((got.view(np.int32) != want.view(np.int32)).sum())
    finally:
        xla_math.fma = fma
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--draws", type=int, default=1_000_000)
    args = ap.parse_args(argv)
    with tempfile.TemporaryDirectory() as tmp:
        env = {**os.environ, "JAX_PLATFORMS": "cpu", "XLA_FLAGS": f"--xla_dump_to={tmp}"}
        subprocess.run([sys.executable, "-c", CHILD], env=env, check=True)
        counts = count_instructions(pathlib.Path(tmp))
    import jax

    print(json.dumps({"jax": jax.__version__, "objdump_fusions": counts, "draws": args.draws,
                      "draws_differing_from_jax": mismatches(args.draws)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
