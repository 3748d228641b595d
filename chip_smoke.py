#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py              # what a checkout's check runs
    python3 chip_smoke.py --profile    # + torch.profiler passes over fig1-xl,
                                       #   fig2's and Newton-XL's kernel route,
                                       #   fig-dnn/BLDNN and a prefill + 4 decode
                                       #   steps of each serve cell

Phases, each printing one JSON line; any failure raises, so the exit code
is non-zero and no result line is printed:

  1. device   — the card's name, and its name and power limit from nvidia-smi;
  2. build    — compile every CUDA source of the port (one nvcc each, in
                parallel) from this checkout;
  3. kernels  — the threshold kernel against its plain PyTorch version,
                `torch.topk` and its radix select emulated in PyTorch on the
                card, bitwise, on the main path's shapes, on edge-case rows
                and on rows past its register path (staged in shared memory,
                and re-read from global memory), and timed beside its plain
                version, its library call and its bound at the main path's
                shapes and the other cells' (BL3's and fig6's full
                (10, 120²) layouts, the (10, 120) model streams,
                FedNL-BC's (10, 7260) upper triangles at k = 7200, the
                basis grid's blocks at k = T and full layouts, a1a's
                blocks, and the cohort path's (512, 576) k = 48 and
                (16, 64) k = 16, whose device time is taken on every run),
                each also held bitwise at k = T − 1 and T;
  4. kernels_matmul — the tiled-matmul kernel against its plain version and
                float64 (within 1e-5 of the larger magnitude of each), and
                bitwise equal to itself on a second call, at the
                Γ = VᵀAV path's shapes (fig2 and
                Newton-XL), the reference's test sweep, K = 1,
                float64/float32/bfloat16 inputs and a transposed view,
                `ops.basis_project` (batched and shared V) and
                `ops.glm_hessian`, each case's template named; then timed at
                the path shapes beside its plain version, its bound, the
                float64 einsum of the default route and three
                `torch.matmul` yardsticks: float64 on the same operands
                (the library time), float32 with the casts timed, and
                float32 on copies made outside the timing;
  5. prng     — the port's threefry draws (`repro_torch.core.prng`) on
                the card and on the CPU against the committed table of
                jax.random draws in both threefry settings
                (src/repro_torch/exp/data/prng_table.json), the card's draws
                at the path's shapes bitwise equal to the CPU's, and the host
                time and CUDA launches a round's draws cost;
     fig1r1   — BL1, FedNL (standard basis, Rank-1) and Newton through
                the experiment engine (`repro_torch.exp.problems.run_cell`
                → `exp.engine.run_cell` → `core.bl.bl1` /
                `core.baselines.newton`; every cell phase below goes the
                same way) against the committed artifacts
                results/exp/fig1r1/*.seed0.json;
  6. fig2     — Newton without a basis and in the data basis on the default
                float64 route against results/exp/fig2/*.seed0.json, and in
                the data basis on the kernel route (Γ in float32 through the
                tiled-matmul kernel) within |Δ| ≤ 2e-6·|ref| + 1e-12;
     fig4, fig6, fig3, fig5, fig1r1/NL1, fig1r3 — the stochastic paper
                cells (`problems.STOCHASTIC_CELLS`: BL2 and BL3 with
                partial participation, the composed compressors, BL1 with
                p < 1, NL1) through `bl.bl1/bl2/bl3` and `baselines.nl1`
                against their artifacts, the threshold kernel launched
                exactly once a round for each leg that selects by Top-K;
     fig1r2, fig5, fig1-bag — the rest of the paper's figures
                (`problems.BASELINE_CELLS`): BL1, GD, DIANA, ADIANA and
                Local-GD; FedNL-BC (symmetrized Top-K on the Hessian's
                upper triangle) and DORE (Top-K both ways); FedNL and
                FedNL-BAG at q = 0.5 and 1, through their public entry
                points against their artifacts, the threshold kernel
                exactly once a round for each Top-K leg and no other kernel;
     basis-grid — BL1 on fig1r1's problem for 16 rounds in the standard,
                symmetric, data, eigen and DCT bases under Top-576 and
                Rank-2, and on Table 2's a1a in the data basis with Top-64,
                against the JAX package's histories
                (src/repro_torch/exp/data/basis_grid_seed0.json, written by
                tools/basis_grid_reference.py), held the same way;
  7. fig1-xl  — BL1 at full width (n=512, d=1200) against
                results/exp/fig1-xl/BL1.seed0.json, with seconds per round,
                the Newton reference time and peak device memory; then
                newton-xl: 6 Newton rounds in the data basis on the same
                problem on both routes, the kernel route held to the
                float64 one within 2e-6, with seconds per round and peak
                memory; then bl2-xl: BL2 at the same widths with τ = 256
                (src/repro_torch/exp/data/bl2_xl_seed0.json, written by the
                JAX package through tools/bl2_xl_reference.py): the card's
                participation masks and every bit stream equal to the
                reference's, the threshold kernel once a round, three full
                runs bitwise equal, seconds a round, peak memory and CUDA
                launches a round; and the same run on the fleet narrowed to
                d = 40 against the reference's whole history;
  8. kernels_bldnn — the fused Top-K compress-sum kernel (bitwise against
                its plain version, the two-pass selection and its
                selection rebuilt from the radix emulation, with the CUDA
                launches each call made against its plan's: 1 on the
                cluster path, 2 otherwise) at BL-DNN's shapes, at 1, 3 and
                9 clients, on rows too long for shared memory, on a
                misaligned stack, in the forms its plan does not take at
                (8, 3072) and on edge-case rows, timed at those shapes and
                at one larger one (beside the two-launch form), and the
                threshold kernel timed at the gradient leg's shapes; then
                the basis-transform kernel (within 1e-5·max|ref| of its
                plain version, 1e-6·max|ref| of float64) in its plan's form
                (fused: one launch; two-stage: two) at BL-DNN's leaves with
                A as rotate passes it (U.mT) and contiguous, at (64; 1024³)
                in both layouts, at odd widths, one client, d1 = 8000 and
                widths TMA cannot take, in the other form too where it runs
                (bitwise equal), with each call's CUDA launches against its
                form's and its distance to the kernel's arithmetic emulated
                in PyTorch; the forms must refuse a stripe past shared
                memory and odd widths on TMA; timed in both forms at the
                leaves and at 1024² beside the plain version, the library
                pair matmul(matmul(A, g), B), the float32 bound and the
                3xTF32 bound, with the first leaf's device time; with
                --profile, every kernel's device time there;
  9. fig-dnn / fig-dnn-ship — BL-DNN through
                `repro_torch.fed.bldnn.run_bldnn` from the carried problem
                (src/repro_torch/exp/data/fig_dnn_seed0.npz): fig-dnn's
                BLDNN, TopK and FedAvg, fig-dnn-ship's TopK, BLDNN_f32,
                BLDNN_bf16, BLDNN_int8, BLDNN_dct and BLDNN_hadamard, and
                fig-dnn's RTopK
                (dithering draws from the round keys; the threshold kernel
                exactly 8 times and the basis transform exactly 4 times a
                round) against their artifacts under results/exp/, with the
                compress-sum and basis-transform kernels' CUDA launches (one
                a call on the 8-client path); with --profile, the CUDA
                launches a round of BLDNN.
     exp      — the experiment layer: ``python -m repro_torch.exp run --fig
                fig1r1 --fig fig-dnn --fig fig1-xl`` in-process on the card
                into a temporary directory: every artifact's config digest
                equal to the committed one, its history in the gates below,
                ``bits_to_tol.reached`` as committed, each CSV's header and
                length, tools/schema_diff.py exiting 0, every kernel's
                launches equal to the per-cell phases' counts of the same
                cells, a second run all "cached" with byte-identical CSVs,
                and the bare ``python3 -m repro_torch.exp run --fig fig1r1``
                (no --device: the card) in a subprocess; each experiment's
                wall and set-up seconds, and s/round through the engine
                beside the per-cell phases'.
     cohort   — the cohort-streaming engine (`repro_torch.core.cohort`):
                fig1-xxl's BL2 and FedNL-BAG at 131,072 clients (cohorts of
                512, 4 rounds a cohort, 16 rounds) and cohort-smoke's BL2
                through `exp.engine.run_cell`, each held to the JAX
                package's file (src/repro_torch/exp/data/fig1_xxl_seed0.json,
                written by tools/cohort_reference.py): the store's sha256,
                f* within 1e-14, every epoch's cohort, each round's
                participants (BL2) or report senders (FedNL-BAG) drawn on
                the card, every bit stream exact, gaps in the GLM gate, the
                threshold kernel exactly once a round; then cohort-smoke
                through ``python3 -m repro_torch.exp run --fig
                cohort-smoke`` in a subprocess, its artifact held the same
                way; the bytes moved to the card per fig1-xxl epoch
                (exactly 512·(8·24 + 8)·8 = 819,200), prefetch on and off
                bitwise equal, set-up seconds (store, x*, fleet init),
                s/round, the prefetch's overlap, CUDA launches a round, and
                the s/round of the same BL2 on a 1,024-client store, which
                fig1-xxl's may exceed by at most 2x (a per-round O(n) step
                would show as ~128x).
     serve    — the service loop (`repro_torch.launch.fed_serve`) in a
                temporary checkpoint directory: fig1-xxl/BL2 at 131,072
                clients (16 rounds in chunks of 8) and fig1-xl/BL1 at full
                width (8 rounds in chunks of 4), each served uninterrupted
                and stopped half way then resumed from its checkpoint, the
                two records equal and held to the JAX package's file
                (participants included) and the artifact; fig4/BL2_tau_half
                through ``python3 -m repro_torch.launch.fed_serve`` with
                dropout, killed by ``--crash-after-round 14`` (exit -9) and
                restarted, equal to the uninterrupted CLI serve, and
                written on the CPU to round 12 then resumed on the card
                (its coefficients mapped into the card's SVD basis); it and
                fig4/BL3_tau_half and fig1-bag/BAG_q0.5 (outages,
                stragglers; 8 rounds extended to 24) in-process, each held
                to src/repro_torch/exp/data/fed_serve_ref.json (written by
                tools/serve_reference.py: events and bits exact, gaps in
                the GLM gate); kernel 1 exactly once a round a Top-K leg;
                s/round served beside the direct call's, checkpoint bytes,
                write and load seconds, time to first round.
     sharded  — the client-sharded reducer (`repro_torch.core.rounds.
                ShardedReducer` over `repro_torch.launch.mesh`'s client
                group), its ranks sharing the one card through gloo, each a
                ``chip_smoke.py --sharded-worker JOB`` process with the
                environment torchrun sets (any rank failing fails the
                phase): fig1-xl/BL1 on its registered fast+sharded backend
                in this process (one rank) bitwise the "fast" run and in
                the artifact's gate; at W = 4 fig1r1/BL1 (2 of the 4 ranks
                hold its 10 clients), fig4/BL2_tau_half and BL3_tau_half,
                fig1-bag/BAG_q0.5 and fig-dnn/BLDNN, exact (every rank
                bitwise the one-process run, in the artifact's gate, each
                kernel of the cell launched as often as on one process on
                every rank holding clients) and exact=False (in the
                reference's envelope of the exact run: gaps 1e-6 relative
                + 1e-12, bits 1e-9; BL-DNN's loss in its rounds-0–3 gate,
                reading kernel 2's local sums), cohort-smoke on
                cohort+sharded (bitwise the one-process run, held to the
                JAX package's file with its participants) and
                fig4/BL2_tau_half served under the serve smoke's fault plan
                to round 12, then resumed here on one rank: bitwise the
                uninterrupted one-rank serve and held to fed_serve_ref.json;
                at W = 2 fig1-xl/BL1 (3 rounds at full width) exact and
                exact=False, and fig1-xxl/BL2 on cohort+sharded held to its
                file with the participants equal.  Each case prints W, the
                ranks holding clients, the process-group backend, s/round
                beside the one-process run's, the bytes each rank's
                collectives delivered a round and each rank's peak device
                memory, beside the card's name and power limit.
  10. kernels_attn — the attention kernels (bfloat16: wgmma fed by TMA;
                float32: CUDA-core FMAs) against their plain version (within
                1e-5·max|plain| in float32; in bfloat16 elementwise within
                one bfloat16 ulp of the plain value plus 1e-5·max|plain|),
                every case in both types: gemma3-4b's prefill shapes (window
                1024 and global), a ragged head-size-256 case, the
                reference's sweep, GQA rep 1/2/8, Sq ≠ Sk, rows that see no
                key, a window below the tile, ragged lengths, a padded head
                size and strided views; a bfloat16 view with head-dim stride
                2 must raise ValueError; each template's registers and
                local (spill) bytes; timed at the prefill shapes beside its
                plain version, SDPA and its bound;
  11. kernels_ssd — the SSD kernel's y and final state against its plain
                version (each within 1e-4·max|plain|) at mamba2-370m's
                prefill shape, the reference's sweep, ragged lengths, heads
                sharing B and C, head and state sizes of 5 and 3, exp
                underflow at large |dt·A|, large decays
                mixed with weak ones (also reported against a float64
                recurrence, beside the kernel's arithmetic emulated at
                chunks of 64 and 128 positions) and strided views; timed at
                the prefill shape beside its plain version and two bounds at
                the kernel's chunk length (float32 on the CUDA cores; its
                split TF32 products on the tensor cores), with the CUDA
                launches one call makes, as the library counts them;
  12. serve-gemma3 / serve-mamba2 — the LM serving path
                (`repro_torch.launch.serve.prefill` / `decode`): the reduced
                config in float32 on the card against the same weights on
                the CPU (prefill logits, every decode step's logits and the
                cache within 2e-4·max|ref|, 8 greedy tokens equal, decode
                after an 8-token prefill equal to the full forward), then
                the full-width config in bfloat16 with seeded weights: 4
                (gemma3) or 8 (mamba2) requests of 2048-token prompts and
                32 decode steps, every logit finite, exactly one kernel-5
                (gemma3, 34) or kernel-6 (mamba2, 48) launch a layer in the
                prefill, no other kernel, and no launch in decode.  A
                reduced reading above 10x the usual 2.4e-6 prints one more
                line: the largest differences, where they sit (the compared
                logits or cache leaf, its index) and both sides' values.

GLM gaps on the float64 route must agree to |Δ| ≤ 1e-8·|ref| + 1e-12 and
every bit stream exactly; a NaN gap agrees only with a NaN in the
artifact's same round, except the two rounds `problems.REFERENCE_SVD_NAN`
names (the reference's CPU SVD did not converge there; the port's gap must
be finite and the artifact's NaN).  BL-DNN bit streams must agree exactly over
every round, the loss within 1e-4·|ref| and the error rate exactly over
rounds 0–3 (training is chaotic at the ulp level; later rounds are
reported), and every loss must be finite.  Each path resets the kernels'
launch counts just before it runs and fails if a kernel of the path was
not launched, or if the tiled-matmul kernel ran on a path that must not
reach it (every float64 route).  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a CUDA device or outside a checkout of the repo.
"""
from __future__ import annotations

import ctypes
import hashlib
import json
import math
import os
import pathlib
from statistics import median
import subprocess
import sys
import time
from typing import Optional

ROOT = pathlib.Path(__file__).resolve().parent
GAP_RTOL, GAP_ATOL = 1e-8, 1e-12
#: NVIDIA H100 SXM data sheet: HBM3 rate, and the 32-bit rate outside the
#: tensor cores (the kernel's operations are 32-bit integer compares/adds)
HBM_BYTES_PER_S = 3.35e12
OPS32_PER_S = 67e12
#: the Top-K kernels' radix select: passes over the keys
RADIX_PASSES = 4
#: fig1-xl timing repeats (each a 1-round and a full run)
XL_REPEATS = 5
#: bl2-xl timing repeats (each a 1-round and a full run); every full run's
#: history must equal the first's bit for bit
BL2_XL_REPEATS = 3
#: kernel 1 at the stochastic cells' other shapes (rows, T, k, where): the
#: full (10, 120²) layout of BL3 (fig4, k = 120; fig5/BL3-BC, k = 60) and
#: of fig6's BL2 in the standard basis (k = 40), and the (10, 120) model
#: streams (fig3 and fig1r3 k = 12, fig5 k = 24 and 60, fig6 k = 40), one
#: client's for BL1-BC; fig3's Hessian leg is fig1r1's (10, 576) k = 24.
#: Then the shapes of the rest of the paper's figures and the basis grid:
#: FedNL-BC's upper triangles (10, 120·121/2) with k = 7200 (the 61st
#: smallest key), one client's model stream and DORE's downlink (1, 120)
#: k = 60 (DORE's uplink is the (10, 120) k = 60 row), the grid's data
#: basis in blocks at k = T = 576 and its full layouts (10, 120²) at
#: k = 576, and a1a's blocks (16, 64²) at k = 64
STOCHASTIC_THRESHOLD_SHAPES = (
    (10, 14400, 120, "fig4/BL3"), (10, 14400, 60, "fig5/BL3-BC"),
    (10, 14400, 40, "fig6/BL2_p0.33"), (10, 120, 12, "model/k12"),
    (10, 120, 24, "model/k24"), (10, 120, 40, "model/k40"), (10, 120, 60, "model/k60"),
    (1, 120, 24, "fig5/BL1-BC/model"), (10, 7260, 7200, "fig5/FedNL-BC"),
    (1, 120, 60, "one/k60"), (10, 576, 576, "basis-grid/data_outer"),
    (10, 14400, 576, "basis-grid/full"), (16, 4096, 64, "table2/a1a"))
#: kernel 1 on the cohort-streaming path (rows, T, k, where): BL2's and
#: FedNL-BAG's Hessian leg in the standard basis, one row a cohort slot:
#: fig1-xxl's (512, 24²) k = 48 and cohort-smoke's (16, 8²) k = 16; timed
#: with their device time on every run
COHORT_THRESHOLD_SHAPES = ((512, 576, 48, "fig1-xxl"), (16, 64, 16, "cohort-smoke"))
#: compressor kinds that select through kernel 1 (`topk_keep_mask`)
TOPK_KINDS = ("topk", "rtopk", "ntopk")
#: the cohort phase: the comparison fleet for the flat-in-n check (the same
#: cohort, τ and epochs as fig1-xxl's BL2), the s/round ratio it must stay
#: under, and the 16-round chunks timed on each fleet (median)
COHORT_FLAT_N = 1024
COHORT_FLAT_RATIO = 2.0
COHORT_TIMED_CHUNKS = 3
#: rounds of simulated draws timed in the prng phase
PRNG_COST_ROUNDS = 50
#: the experiments the exp phase runs through the CLI: the paper's headline
#: cell (kernel 1), BL-DNN (kernels 1, 2 and 4) and the full-width fig1-xl
EXP_FIGS = ("fig1r1", "fig-dnn", "fig1-xl")
#: BL-DNN: rounds whose loss and error rate are held to the artifact
DNN_HELD_ROUNDS = 4
DNN_LOSS_RTOL = 1e-4
#: basis_transform against its plain float32 version / against float64
BT_TOL_PLAIN, BT_TOL_F64 = 1e-5, 1e-6
#: tiled_matmul against its plain float32 version and against float64, as a
#: share of the larger magnitude of each
MM_TOL = 1e-5
#: the float32 Γ route's gap envelope: the reference's own f32 route leaves
#: the 1e-8 one (2.4e-10 absolute at a 4.1e-3 gap in fig2) and stays 4x
#: inside 2e-6 on a 16-client fleet at fig1-xl's widths
F32_GAP_RTOL = 2e-6
#: Newton in the data basis at fig1-xl's widths: rounds and timing repeats
NEWTON_XL_STEPS, NEWTON_XL_REPEATS = 6, 3
#: kernel 5 against its plain version: within ATTN_TOL·max|plain| in
#: float32; in bfloat16, where kernel and plain version round float32 sums
#: that differ in their last bits, elementwise within one bfloat16 ulp of
#: the plain value plus ATTN_TOL·max|plain|
ATTN_TOL = 1e-5
#: kernel 6's y and final state against its plain version, share of max|plain|
SSD_TOL = 1e-4
#: the reduced serve paths on the card against the same weights on the CPU;
#: the usual reduced-gemma3 reading (PRs 14–15) and the share above which a
#: run prints the largest differences before its last line
SERVE_TOL = 2e-4
SERVE_USUAL_REL = 2.4e-6
SERVE_UNUSUAL = 10 * SERVE_USUAL_REL
#: NVIDIA H100 SXM data sheet: dense bfloat16 and TF32 tensor-core rates;
#: kernel 6 takes each float32 product as three TF32 products of split
#: operands
BF16_OPS_PER_S = 989e12
TF32_OPS_PER_S = 495e12
TF32_SPLIT_PRODUCTS = 3
#: gemma3-4b's prefill attention: (B, S, H, KVH, hd, window) of its sliding
#: and its global layers
ATTN_PATH = ((4, 2048, 8, 4, 256, 1024), (4, 2048, 8, 4, 256, None))
#: the reference's attention test sweep (tests/test_kernels.py)
ATTN_SWEEP = ((2, 128, 128, 64, True, None), (1, 256, 256, 32, True, 64),
              (3, 64, 192, 64, False, None), (2, 96, 96, 128, True, 17))
#: mamba2-370m's prefill SSD: (B, S, H, hd, N) at the config's chunk 256
SSD_PATH = (8, 2048, 32, 64, 128)
#: chunk lengths at which kernel 6's arithmetic is emulated on the
#: mixed-decay inputs (its own, KERNEL_CHUNK, among them)
SSD_EMULATED_CHUNKS = (64, 128)
#: the reference's SSD test sweep: (BH, S, hd, N, chunk)
SSD_SWEEP = ((2, 64, 16, 8, 16), (1, 128, 32, 16, 32), (4, 96, 8, 4, 24), (1, 60, 16, 8, 32))
#: serve cells at full width on one card: arch, the port's one-card input
#: shape (`repro_torch.launch.shapes`: requests, prompt and cache length),
#: decode steps, and the kernel each prefill layer launches
SERVE_CELLS = (("gemma3_4b", "decode_4k_b4", 32, "flash_attention"),
               ("mamba2_370m", "decode_4k_b8", 32, "ssd_scan"))
#: the reduced configs of the card-against-CPU check (gemma3 with grouped
#: KV heads, as at full width)
SERVE_REDUCED = {"gemma3_4b": {"n_kv_heads": 2}, "mamba2_370m": {}}


#: the sharded phase (the client-sharded reducer, its ranks sharing the one
#: card through gloo): the world sizes, the cells held at W = 4 (exact and
#: exact=False), fig1-xl's rounds at W = 2 (each exact round gathers its
#: (512, 1200, 1200) float64 stack to both ranks), the serve case written at
#: W = 4 up to a round and resumed on one rank, each spawn's time limit
SHARDED_W, SHARDED_XL_W = 4, 2
SHARDED_CELLS = (("fig1r1", "BL1"), ("fig4", "BL2_tau_half"), ("fig4", "BL3_tau_half"),
                 ("fig1-bag", "BAG_q0.5"), ("fig-dnn", "BLDNN"))
SHARDED_XL_STEPS = 3
SERVE_SMOKE_CASE, SERVE_SMOKE_STOP = "fig4/BL2_tau_half", 12
SHARDED_TIMEOUT_S = 400
#: the reference's envelope of exact=False around the exact run
#: (tests/test_sharding_multidev.py): gaps, and the bit streams
ENV_RTOL, ENV_ATOL, ENV_BITS_RTOL = 1e-6, 1e-12, 1e-9

#: the committed table of jax.random draws in both threefry settings
#: (written by tests/test_torch_prng.py), the card's draws are held to
PRNG_TABLE = ROOT / "src" / "repro_torch" / "exp" / "data" / "prng_table.json"


def prng_draws(r) -> dict:
    """The draws of the PRNG table through a random module ``r`` (the
    port's, `PortRandom`, or jax's in the test that writes the table):
    split into 3 and 4, fold_in, bernoulli from a float64 and a float32 p,
    randint int32 and int64, uniform float32 and float64 over shapes of 5
    and 6 (odd and even counter counts), and choice of 1 and 5 of 60
    without replacement — as nested lists."""
    out = {}
    for seed in (0, 3):
        key = r.PRNGKey(seed)
        out[f"split3/{seed}"] = r.split(key, 3)
        out[f"split4/{seed}"] = r.split(key, 4)
        out[f"fold_in/{seed}"] = r.fold_in(key, 7)
        for n in (5, 6):
            tag = f"{n}/{seed}"
            out[f"bernoulli_f64/{tag}"] = r.bernoulli(key, 0.3, (n,))
            out[f"bernoulli_f32/{tag}"] = r.bernoulli(
                key, r.f32([i / (n - 1) for i in range(n)]), None)
            out[f"randint_i32/{tag}"] = r.randint(key, (n,), 0, 512, "int32")
            out[f"randint_i64/{tag}"] = r.randint(key, (n,), 0, 10, "int64")
            out[f"uniform_f32/{tag}"] = r.uniform(key, (n,), "float32")
            out[f"uniform_f64/{tag}"] = r.uniform(key, (n,), "float64")
        out[f"choice60x1/{seed}"] = r.choice(key, 60, (1,), False)
        out[f"choice60x5/{seed}"] = r.choice(key, 60, (5,), False)
    return {k: r.tolist(v) for k, v in out.items()}


def prng_table(r) -> dict:
    """`prng_draws` under both threefry settings."""
    table = {}
    for flag in (False, True):
        with r.setting(flag):
            table[f"partitionable={flag}"] = prng_draws(r)
    return table


class PortRandom:
    """`prng_draws`'s random module over `repro_torch.core.prng`: keys on
    the host, every draw on ``device``."""

    def __init__(self, torch, prng, device):
        self.torch, self.prng, self.device = torch, prng, device
        self.setting = prng.threefry_partitionable

    def PRNGKey(self, seed):
        return self.prng.PRNGKey(seed)

    def split(self, key, num):
        return self.prng.split(key, num, device=self.device)

    def fold_in(self, key, data):
        return self.prng.fold_in(key, data, device=self.device)

    def f32(self, values):
        return self.torch.tensor(values, dtype=self.torch.float32, device=self.device)

    def bernoulli(self, key, p, shape):
        return self.prng.bernoulli(key, p, shape, device=self.device)

    def randint(self, key, shape, lo, hi, dtype):
        return self.prng.randint(key, shape, lo, hi, getattr(self.torch, dtype),
                                 device=self.device)

    def uniform(self, key, shape, dtype):
        return self.prng.uniform(key, shape, getattr(self.torch, dtype), device=self.device)

    def choice(self, key, n, shape, replace):
        return self.prng.choice(key, n, shape, replace, device=self.device)

    def tolist(self, x):
        if x.device.type != self.torch.device(self.device).type:
            raise AssertionError(f"a draw landed on {x.device}, not {self.device}")
        return x.cpu().tolist()


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, iters: int, warmup: int = 5) -> float:
    """Mean device time of `fn` over `iters` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(torch, fns: dict, reps: int = 50) -> dict:
    """Device time a call of each of `fns` (name → callable), by CUDA
    kernel, from torch.profiler over `reps` calls after a warm-up call.  A
    trace that holds no kernel (the profiler now and then records none) is
    taken again, up to three times in all; an empty dict says it never
    did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        for _ in range(3):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            out[name] = {kernel_name(ev.key): ev.self_device_time_total / reps / 1e3
                         for ev in prof.key_averages()
                         if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0}
            if out[name]:
                break
    return out


def kernel_name(key: str) -> str:
    """A profiler's kernel key without its return type, namespace and
    parameter list."""
    return key.replace("void ", "").replace("(anonymous namespace)::", "").split("(")[0]


def threshold_bound_ms(rows: int, T: int) -> tuple:
    """Least time for the threshold of a (rows, T) f32 input: one read of
    the input and one write of the (rows, 1) output, or the radix select's
    passes of a compare and a count per element, whichever is larger."""
    bytes_ms = (rows * T * 4 + rows * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * RADIX_PASSES * rows * T / OPS32_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def compress_sum_bound_ms(n: int, T: int) -> tuple:
    """Least time for the fused compress-sum of an (n, T) f32 stack: read v
    and write dense once, write the (T,) sum, or the radix select's passes
    of a compare and a count over the n·T keys, whichever is larger."""
    bytes_ms = (2 * n * T * 4 + T * 4) / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * RADIX_PASSES * n * T / OPS32_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def basis_transform_bound_ms(n: int, da: int, d1: int, d2: int, db: int) -> tuple:
    """Least time for (A·gᵢ)·B over n clients in f32: the bytes of A, g, B
    and out once, or 2n(da·d1·d2 + da·d2·db) operations at the f32 rate."""
    bytes_ms = (da * d1 + n * d1 * d2 + d2 * db + n * da * db) * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * n * (da * d1 * d2 + da * d2 * db) / OPS32_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def basis_transform_bound_tc_ms(n: int, da: int, d1: int, d2: int, db: int) -> tuple:
    """Least time for the same work as kernel 4 does it: the bytes of A, g,
    B and out once, or three TF32 products of 2n(da·d1·d2 + da·d2·db)
    operations each at the TF32 tensor-core rate, whichever is larger."""
    bytes_ms = (da * d1 + n * d1 * d2 + d2 * db + n * da * db) * 4 / HBM_BYTES_PER_S * 1e3
    ops_ms = TF32_SPLIT_PRODUCTS * 2 * n * (da * d1 * d2 + da * d2 * db) / TF32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def matmul_bound_ms(a, b) -> tuple:
    """Least time for ``a @ b`` with float32 accumulation: each operand
    read once in its own type (a broadcast one once), the float32 output
    written once, or 2·batch·M·N·K operations at the f32 rate."""
    batch = a.shape[0] if a.dim() == 3 else (b.shape[0] if b.dim() == 3 else 1)
    M, K = a.shape[-2:]
    N = b.shape[-1]
    bytes_ = (a.numel() * a.element_size() + b.numel() * b.element_size()
              + batch * M * N * 4)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = 2 * batch * M * N * K / OPS32_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


#: Γ = VᵀAV on the kernel route: (clients, d, r) for fig2/newton_basis and
#: for Newton in the data basis at fig1-xl's widths
MM_PATHS = (("fig2", 10, 120, 24), ("newton-xl", 512, 1200, 32))
#: the reference's matmul test sweep (tests/test_kernels.py), (M, K, N)
MM_SWEEP = ((64, 64, 64), (300, 500, 200), (128, 1, 7), (1, 257, 129), (513, 128, 255))


def matmul_kernel_phase(torch, tm, ops) -> dict:
    """The tiled-matmul kernel against its plain version and float64 (each
    error within MM_TOL of the larger magnitude), and bitwise equal to
    itself on a second call (each tile is written once, in a fixed order), at
    the Γ path's shapes, the reference sweep in three input types, a
    transposed view and K = 1, then `ops.basis_project` and
    `ops.glm_hessian`; then timings at the path shapes."""
    gen = torch.Generator(device="cuda").manual_seed(3)

    def rnd(*shape, dtype=torch.float64):
        return torch.randn(*shape, device="cuda", dtype=torch.float64,
                           generator=gen).to(dtype)

    err = {"plain": 0.0, "f64": 0.0, "plain_rel": 0.0, "f64_rel": 0.0}
    templates = {}

    def hold(name, out, plain, ref, again=None):
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        e_plain = float((out.double() - plain.double()).abs().max())
        e_f64 = float((out.double() - ref).abs().max())
        p_scale = float(plain.double().abs().max())
        if not (e_plain <= MM_TOL * p_scale and e_f64 <= MM_TOL * scale):
            raise AssertionError(f"tiled_matmul on {name}: |Δ plain| {e_plain} "
                                 f"(max|plain| {p_scale}), |Δ f64| {e_f64} (max|ref| {scale})")
        if again is not None and not torch.equal(out, again):
            raise AssertionError(f"tiled_matmul on {name}: a second call differs in its bits")
        err["plain"] = max(err["plain"], e_plain)
        err["f64"] = max(err["f64"], e_f64)
        err["plain_rel"] = max(err["plain_rel"], e_plain / p_scale)
        err["f64_rel"] = max(err["f64_rel"], e_f64 / scale)

    def check(name, a, b):
        p = tm.plan(tm.geometry(a, b), a.element_size(), b.element_size(),
                    a.data_ptr() % 16, b.data_ptr() % 16)
        templates[name] = tm.TEMPLATES[p.template]
        hold(name, tm.matmul(a, b), tm.matmul_plain(a, b),
             torch.matmul(a.double(), b.double()), tm.matmul(a, b))

    cases = 0
    operands = {}
    for path, n, d, r in MM_PATHS:
        A = rnd(n, d, d)
        A = (A + A.transpose(-1, -2)) / 2          # a Hessian is symmetric
        # row-major, as the data basis is stacked (cuSOLVER's Q is column-major)
        V = torch.linalg.qr(rnd(n, d, r))[0].contiguous()
        T = tm.matmul(A, V)
        check(f"{path} T = A·V", A, V)
        check(f"{path} Γ = Vᵀ·T", V.transpose(-1, -2), T)
        hold(f"{path} basis_project", ops.basis_project(V, A),
             tm.matmul_plain(V.transpose(-1, -2), tm.matmul_plain(A, V)),
             torch.einsum("ndr,nde,nes->nrs", V, A, V))
        operands[path] = (A, V, T)
        cases += 3
    A, V, _ = operands["fig2"]
    hold("basis_project, shared 2-D V", ops.basis_project(V[0], A),
         tm.matmul_plain(V[0].T, tm.matmul_plain(A, V[0])),
         torch.einsum("dr,nde,es->nrs", V[0], A, V[0]))
    hold("basis_project, 2-D", ops.basis_project(V[0], A[0]),
         tm.matmul_plain(V[0].T, tm.matmul_plain(A[0], V[0])), V[0].T @ A[0] @ V[0])
    for M, K, N in MM_SWEEP:
        for dt in (torch.float64, torch.float32, torch.bfloat16):
            check(f"({M}, {K}, {N}) {dt}", rnd(M, K, dtype=dt), rnd(K, N, dtype=dt))
        check(f"({M}, {K}, {N}) transposed A and B", rnd(K, M).T, rnd(N, K).T)
        cases += 4
    check("f32 · bf16, batched · broadcast", rnd(3, 70, 90, dtype=torch.float32),
          rnd(90, 33, dtype=torch.bfloat16))
    Ag, w = rnd(60, 120), torch.rand(60, device="cuda", dtype=torch.float64, generator=gen)
    hold("glm_hessian", ops.glm_hessian(Ag, w, 1e-3),
         tm.matmul_plain(Ag.T, Ag * w[:, None]) / 60 + 1e-3 * torch.eye(120, device="cuda"),
         (Ag.T * w) @ Ag / 60 + 1e-3 * torch.eye(120, device="cuda", dtype=torch.float64))
    cases += 4

    timings = {}
    for path, n, d, r in MM_PATHS:
        A, V, T = operands[path]
        Vt = V.transpose(-1, -2)
        A32, V32, Vt32 = A.float(), V.float(), Vt.float()
        iters = 200 if n * d * d < 10 ** 7 else 10
        for prod, (a, b, a32, b32) in (("T", (A, V, A32, V32)), ("G", (Vt, T, Vt32, T))):
            bound, by = matmul_bound_ms(a, b)
            timings[f"{path}/{prod}"] = {
                "a": [list(a.shape), str(a.dtype)], "b": [list(b.shape), str(b.dtype)],
                "template": templates[f"{path} {'T = A·V' if prod == 'T' else 'Γ = Vᵀ·T'}"],
                "kernel_ms": cuda_ms(torch, lambda: tm.matmul(a, b), iters, warmup=2),
                "plain_ms": cuda_ms(torch, lambda: tm.matmul_plain(a, b), iters, warmup=2),
                # the same work from the same operands: cuBLAS in float64 (a
                # float32 operand cast inside the call, as for Γ's T)
                "library_ms": cuda_ms(torch, lambda: torch.matmul(a, b.to(a.dtype)), iters,
                                      warmup=2),
                # float32 cuBLAS with both casts inside the timed call
                "library_cast_f32_ms": cuda_ms(
                    torch, lambda: torch.matmul(a.float(), b.float()), iters, warmup=2),
                # float32 cuBLAS on float32 copies made outside the timed call
                # (half the bytes of a float64 operand: no kernel that reads
                # float64 can match it)
                "library_f32_copies_ms": cuda_ms(torch, lambda: torch.matmul(a32, b32), iters,
                                                 warmup=2),
                "bound_ms": bound, "bound_by": by}
        timings[f"{path}/basis_project"] = {
            "kernel_route_ms": cuda_ms(torch, lambda: ops.basis_project(V, A), iters, warmup=2),
            "einsum_f64_ms": cuda_ms(
                torch, lambda: torch.einsum("ndr,nde,nes->nrs", V, A, V), iters, warmup=2)}
        del A32, V32, Vt32
    del operands
    torch.cuda.empty_cache()
    return {"cases": cases, "max_abs_err": err, "bitwise_rerun": True,
            "templates": templates, "timings": timings}


def check_bits(name: str, hist, ref: dict) -> list:
    """Every bit stream (uplink, downlink, each ledger leg) exactly the
    reference's; returns the names of the streams compared.  A reference
    without legs (NL1's loop) needs a history without them."""
    legs = ref["legs"] or {}
    if ref["legs"] is None and hist.legs is not None:
        raise AssertionError(f"{name}: legs {sorted(hist.legs)} where the reference has none")
    streams = {"up_bits": hist.up_bits, "down_bits": hist.down_bits,
               **{f"legs.{k}": hist.legs[k] for k in legs}}
    want = {"up_bits": ref["up_bits"], "down_bits": ref["down_bits"],
            **{f"legs.{k}": v for k, v in legs.items()}}
    for k, v in streams.items():
        if list(v) != list(want[k]):
            raise AssertionError(f"{name}: bit stream {k} {v} != reference {want[k]}")
    return sorted(streams)


def check_history(name: str, hist, ref: dict, rtol: float = GAP_RTOL,
                  svd_nan_round=None) -> dict:
    """Gaps within |Δ| ≤ rtol·|ref| + 1e-12 and every bit stream exact.  A
    NaN gap agrees only with a NaN in the artifact's same round; at
    ``svd_nan_round`` (`problems.REFERENCE_SVD_NAN`: a NaN the reference's
    non-converged CPU SVD wrote) the artifact must be NaN and the port's
    gap finite, and the pair is reported."""
    import numpy as np

    g, gr = np.asarray(hist.gaps), np.asarray(ref["gaps"])
    if g.shape != gr.shape:
        raise AssertionError(f"{name}: gaps {g} against reference {gr}")
    nan_pair = np.isnan(g) & np.isnan(gr)
    reported = {}
    if svd_nan_round is not None:
        t = svd_nan_round
        if not (np.isnan(gr[t]) and np.isfinite(g[t])):
            raise AssertionError(f"{name}: round {t} should be NaN in the artifact and "
                                 f"finite here: {g[t]} vs {gr[t]}")
        nan_pair[t] = True
        reported = {"reference_svd_nan_round": t, "gap_at_that_round": float(g[t])}
    if not np.all(np.isfinite(g) | nan_pair):
        raise AssertionError(f"{name}: gaps {g} against reference {gr}")
    err = np.where(nan_pair, 0.0, np.abs(g - gr))
    bad = ~nan_pair & ~(err <= rtol * np.abs(gr) + GAP_ATOL)
    if bad.any():
        raise AssertionError(f"{name}: gaps leave |Δ| ≤ {rtol}·|ref| + 1e-12 at rounds "
                             f"{np.nonzero(bad)[0].tolist()}: {g} vs {gr}")
    big = ~nan_pair & (np.abs(gr) > 1e-9)   # the tail's relative error is noise
    return {"max_gap_abs_err": float(err.max()),
            "max_gap_rel_err_above_1e-9": float((err[big] / np.abs(gr[big])).max(initial=0.0)),
            "nan_rounds_agreeing": np.nonzero(np.isnan(g) & np.isnan(gr))[0].tolist(),
            **reported, "gaps": list(map(float, g)),
            "bit_streams_equal": check_bits(name, hist, ref)}


def history_dict(hist) -> dict:
    """A `History` as the artifact's ``history`` mapping."""
    return {"gaps": hist.gaps, "up_bits": hist.up_bits, "down_bits": hist.down_bits,
            "legs": hist.legs}


def kernel_phase(torch, tk, profile: bool) -> dict:
    """The threshold kernel against its plain version, torch.topk and its
    radix select emulated in PyTorch, bitwise (and the emulation's count
    above the threshold against a direct count), then keep-masks from both
    thresholds; then its timings (with `profile`, its device time)."""
    import numpy as np

    rng = np.random.default_rng(0)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device="cuda")

    cases = [(f"random{r}x{T}", dev(np.abs(rng.standard_normal((r, T)))), k)
             for r, T, ks in ((10, 576, (1, 24, 576)), (512, 1024, (32, 1024)))
             for k in ks]
    ties = rng.integers(0, 4, (64, 576)).astype(np.float32)
    zeros = np.zeros((8, 576), np.float32)
    infs = np.abs(rng.standard_normal((8, 576))).astype(np.float32)
    infs[:, rng.integers(0, 576, 40)] = np.inf
    tiny = np.finfo(np.float32).smallest_subnormal
    subn = (rng.integers(0, 50, (8, 576)) * tiny).astype(np.float32)
    negz = np.where(rng.random((8, 576)) < 0.5, -0.0,
                    rng.standard_normal((8, 576))).astype(np.float32)
    for name, arr in (("ties", ties), ("zeros", zeros), ("inf", infs),
                      ("subnormal", subn), ("neg_zero", negz)):
        for k in (1, 24, 300, 576):
            cases.append((name, torch.abs(dev(arr)).contiguous(), k))
    # the longest register run, then rows staged in shared memory
    # (T ≤ 12288) and re-read from global memory (T > 12288)
    for T in LONG_ROWS:
        for k in (1, T // 10, T):
            cases.append((f"random4x{T}", dev(np.abs(rng.standard_normal((4, T)))), k))
    # every path shape at its k and at both ends of the radix select
    # (k = T - 1 and k = T)
    for rows, T, k, tag in STOCHASTIC_THRESHOLD_SHAPES + COHORT_THRESHOLD_SHAPES:
        a = dev(np.abs(rng.standard_normal((rows, T))))
        for kk in sorted({k, T - 1, T}):
            cases.append((tag, a, kk))

    max_err = 0.0
    for name, a, k in cases:
        kk = max(1, min(k, a.shape[1]))
        t_kernel = tk.topk_row_threshold(a, k)
        t_plain = tk.topk_row_threshold_plain(a, k)
        t_lib = torch.topk(a, kk, dim=1).values[:, -1:].contiguous()
        t_emul, above = tk.topk_row_threshold_radix_emulated(a, k)
        torch.cuda.synchronize()
        for other, label in ((t_plain, "plain"), (t_lib, "torch.topk"),
                             (t_emul, "radix emulation")):
            if not torch.equal(t_kernel.view(torch.int32), other.view(torch.int32)):
                raise AssertionError(f"threshold kernel != {label} on {name} k={k}")
        if not torch.equal(above, (a > t_kernel).sum(dim=1, keepdim=True)):
            raise AssertionError(f"radix emulation's count above t is off on {name} k={k}")
        m_kernel = tk.keep_mask(a, t_kernel, kk)
        if not torch.equal(m_kernel, tk.keep_mask(a, t_plain, kk)):
            raise AssertionError(f"keep_mask differs on {name} k={k}")
        if not bool((m_kernel.sum(dim=1) == kk).all()):
            raise AssertionError(f"keep_mask keeps != {kk} per row on {name}")
        same = t_kernel == t_plain
        diff = torch.where(same, 0.0, (t_kernel.double() - t_plain.double()).abs())
        max_err = max(max_err, float(diff.max()))

    timings = {}
    for rows, T, k, path in ((10, 576, 24, "fig1r1"), (512, 1024, 1024, "fig1-xl"),
                             *STOCHASTIC_THRESHOLD_SHAPES, *COHORT_THRESHOLD_SHAPES):
        a = dev(np.abs(rng.standard_normal((rows, T))))
        if not torch.equal(tk.topk_row_threshold(a, k), tk.topk_row_threshold_plain(a, k)):
            raise AssertionError(f"threshold kernel != plain at {path} ({rows}, {T}) k={k}")
        bound, by = threshold_bound_ms(rows, T)
        timings[path] = {
            "shape": [rows, T], "k": k,
            "kernel_ms": cuda_ms(torch, lambda: tk.topk_row_threshold(a, k), 500),
            "plain_ms": cuda_ms(torch, lambda: tk.topk_row_threshold_plain(a, k), 50),
            "library_ms": cuda_ms(
                torch, lambda: torch.topk(a, k, dim=1).values[:, -1:], 500),
            "bound_ms": bound, "bound_by": by}
        if profile or path in {tag for *_, tag in COHORT_THRESHOLD_SHAPES}:
            timings[path]["device_ms"] = device_ms(
                torch, {"kernel": lambda: tk.topk_row_threshold(a, k)})["kernel"]
    return {"cases": len(cases), "max_abs_err": max_err, "timings": timings}


#: fig-dnn's four parameter leaves as the Fisher leg sees them: (clients,
#: numel) with k = ⌊0.1·numel⌋, and the rotations (da, d1, d2, db) of the
#: gradient leg, n = 8 clients
DNN_STACKS = ((8, 3072, 307), (8, 2048, 204), (8, 2048, 204), (8, 128, 12))
DNN_ROTATIONS = ((96, 96, 32, 32), (32, 32, 64, 64), (64, 64, 32, 32), (32, 32, 4, 4))
LARGE_STACK = (512, 16384, 1638)
#: kernel 2 at 1 and 3 clients (part of a cluster) and at 9 (two launches),
#: and at the longest register run (17 keys a thread)
EDGE_STACKS = ((1, 3072, 307), (3, 2048, 204), (9, 3072, 307), (2, 4352, 435))
#: kernel 1 rows at the end of its register path (17 keys a thread), past
#: it (staged in shared memory), and too long for shared memory (48 KB)
LONG_ROWS = (4352, 5000, 20000)
LARGE_ROTATION = (64, 1024, 1024, 1024, 1024)    # n, da, d1, d2, db


#: kernel 2 rows too long for shared memory (two launches, stage "global"),
#: and a stack whose rows are odd-length and start one float past an
#: aligned address, at 5 clients (cluster) and 9 (two launches)
GLOBAL_STACK = (2, 50000, 5000)
MISALIGNED_STACKS = ((5, 5001, 500), (9, 5001, 500))


def emulated_dense(torch, tk, v, k: int):
    """Kernel 2's selection rebuilt from the radix emulation: per row the
    |v| above the emulated threshold and the earliest ties up to k − above
    (its count of keys above)."""
    kk = max(1, min(k, v.shape[1]))
    a = v.abs()
    t, above = tk.topk_row_threshold_radix_emulated(a, kk)
    eq = a == t
    return torch.where((a > t) | (eq & (eq.cumsum(dim=1) <= kk - above)), v, 0.0)


def bldnn_kernel_phase(torch, tk, profile: bool) -> dict:
    """The fused compress-sum kernel against its plain version (dense and
    row-order sum bitwise), the two-pass selection and its selection
    rebuilt from the radix emulation (dense bitwise), in the plan's form
    and in every other form at (8, 3072), with its CUDA launches a call
    against its plan's; then its times at the path's shapes and at one
    larger shape, and the threshold kernel's time at the gradient leg's
    shapes (with `profile`, the Top-K kernels' device times)."""
    import dataclasses

    import numpy as np

    from repro_torch.core.compressors import TopK

    rng = np.random.default_rng(1)

    def dev(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32), device="cuda")

    tiny = np.finfo(np.float32).smallest_subnormal
    cases = []
    for n, T, k in DNN_STACKS + ((4, 40, 10 ** 6),) + EDGE_STACKS:
        infs = rng.standard_normal((n, T))
        infs[:, rng.integers(0, T, max(1, T // 16))] = np.inf
        infs[0, :3] = -np.inf
        for name, arr in (("random", rng.standard_normal((n, T))),
                          ("ties", rng.integers(-3, 4, (n, T))),
                          ("zeros", np.zeros((n, T))),
                          ("inf", infs),
                          ("subnormal", rng.integers(-40, 41, (n, T)) * tiny)):
            cases.append((f"{name}{n}x{T}", dev(arr), k, None))
    for n, T, k in (LARGE_STACK, GLOBAL_STACK):
        cases.append((f"random{n}x{T}", dev(rng.standard_normal((n, T))), k, None))
    for n, T, k in MISALIGNED_STACKS:
        buf = dev(rng.standard_normal(n * T + 1))
        cases.append((f"misaligned{n}x{T}", buf[1:].view(n, T), k, None))
    # the forms the plan does not take at (8, 3072): two launches, and the
    # row staged in shared memory (in a cluster and in two launches)
    n, T, k = DNN_STACKS[0]
    plan = tk.compress_sum_plan(n, T)
    two = dataclasses.replace(plan, cluster=False, slice_cols=0)
    for form, forced in (("two_launch", two),
                         ("shared", dataclasses.replace(plan, stage="shared")),
                         ("two_launch_shared", dataclasses.replace(two, stage="shared"))):
        for name, arr in (("random", rng.standard_normal((n, T))),
                          ("ties", rng.integers(-3, 4, (n, T)))):
            cases.append((f"{name}{n}x{T}_{form}", dev(arr), k, forced))
    cs_err = 0.0
    cs_launches = {}
    cs_forms = {}
    for name, v, k, forced in cases:
        n, T = v.shape
        plan = forced or tk.compress_sum_plan(n, T)
        if forced is None and plan.cluster != (n <= tk.MAX_CLUSTER and T * 4 <= 160 * 1024):
            raise AssertionError(f"{name}: a cluster launch exactly for ≤ 8 rows of ≤ 160 KB, "
                                 f"yet the plan is {plan}")
        made = tk.compress_sum_cuda_launches
        if forced is None:
            dense, col_sum = tk.topk_compress_sum(v, k)
        else:
            dense, col_sum = tk._compress_sum_kernel(v, max(1, min(k, T)), forced)
        made = tk.compress_sum_cuda_launches - made
        if made != plan.launches:
            raise AssertionError(f"{name}: {made} CUDA launches, the plan says {plan.launches}")
        cs_launches[name] = made
        cs_forms[name] = f"{'cluster' if plan.cluster else 'two_launch'}/{plan.stage}"
        p_dense, p_sum = tk.topk_compress_sum_plain(v, k)
        two_pass, _ = TopK(k=k).compress(None, v)
        e_dense = emulated_dense(torch, tk, v, k)
        torch.cuda.synchronize()
        for other, what in ((p_dense, "plain dense"), (two_pass, "two-pass TopK.compress"),
                            (e_dense, "radix emulation's dense")):
            if not torch.equal(dense.view(torch.int32), other.view(torch.int32)):
                raise AssertionError(f"topk_compress_sum != {what} on {name} k={k}")
        if not torch.equal(col_sum.view(torch.int32), p_sum.view(torch.int32)):
            raise AssertionError(f"topk_compress_sum col_sum != plain row-order sum on {name}")
        for a, b in ((dense, p_dense), (col_sum, p_sum)):
            same = a.view(torch.int32) == b.view(torch.int32)
            cs_err = max(cs_err, float(torch.where(same, 0.0, (a.double() - b.double()).abs())
                                       .nan_to_num(nan=float("inf")).max()))
        if bool(torch.isfinite(dense).all()):
            ulps = v.shape[0] * torch.finfo(torch.float32).eps * dense.abs().sum(dim=0)
            if bool(((col_sum - dense.sum(dim=0)).abs() > ulps).any()):
                raise AssertionError(f"col_sum leaves n·ulp of dense.sum(0) on {name}")

    cs_times, th_times = {}, {}
    for n, T, k in sorted(set(DNN_STACKS)):
        # the gradient leg's threshold alone: |v| of one leaf's stack
        a = torch.abs(dev(rng.standard_normal((n, T)))).contiguous()
        bound, by = threshold_bound_ms(n, T)
        th_times[f"{n}x{T}"] = {
            "shape": [n, T], "k": k,
            "kernel_ms": cuda_ms(torch, lambda: tk.topk_row_threshold(a, k), 200),
            "plain_ms": cuda_ms(torch, lambda: tk.topk_row_threshold_plain(a, k), 10),
            "library_ms": cuda_ms(torch, lambda: torch.topk(a, k, dim=1).values[:, -1:], 200),
            "bound_ms": bound, "bound_by": by}
        if profile:
            th_times[f"{n}x{T}"]["device_ms"] = device_ms(
                torch, {"kernel": lambda: tk.topk_row_threshold(a, k)})["kernel"]
    for n, T, k in sorted(set(DNN_STACKS)) + [LARGE_STACK]:
        v = dev(rng.standard_normal((n, T)))
        iters = 200 if n * T < 10 ** 6 else 20
        bound, by = compress_sum_bound_ms(n, T)
        plan = tk.compress_sum_plan(n, T)
        # the CUDA launches one call makes, as the C entry reports them
        made = tk.compress_sum_cuda_launches
        tk.topk_compress_sum(v, k)
        made = tk.compress_sum_cuda_launches - made
        if made != plan.launches:
            raise AssertionError(f"{n}x{T}: {made} CUDA launches, the plan says {plan.launches}")
        calls = {"plan": lambda: tk.topk_compress_sum(v, k)}
        if plan.cluster:
            # the same call in two launches: what the cluster form saves
            two = dataclasses.replace(plan, cluster=False, slice_cols=0)
            calls["two_launch"] = lambda two=two: tk._compress_sum_kernel(v, max(1, min(k, T)),
                                                                          two)

        def two_pass():
            dense, _ = TopK(k=k).compress(None, v)
            return dense.sum(dim=0)

        cs_times[f"{n}x{T}"] = {
            "shape": [n, T], "k": k, "plan": dataclasses.asdict(plan),
            "cuda_launches_per_call": made,
            "kernel_ms": cuda_ms(torch, calls["plan"], iters),
            "kernel_ms_forms": {form: cuda_ms(torch, fn, iters) for form, fn in calls.items()
                                if form != "plan"},
            "plain_ms": cuda_ms(torch, lambda: tk.topk_compress_sum_plain(v, k), 10),
            "two_pass_ms": cuda_ms(torch, two_pass, iters),
            "bound_ms": bound, "bound_by": by}
        if profile:
            cs_times[f"{n}x{T}"]["device_ms"] = device_ms(torch, calls, 50 if iters > 20 else 10)
    return {"compress_sum_cases": len(cases), "compress_sum_max_abs_err": cs_err,
            "compress_sum_cuda_launches": cs_launches, "compress_sum_forms": cs_forms,
            "threshold_timings": th_times, "compress_sum_timings": cs_times}


#: kernel 4 beyond the path's leaves: odd widths, one client (its A read
#: from its transpose, as rotate passes U.mT), a long K (d1 = 8000, the
#: two-stage form; the fused form runs it too), widths TMA cannot take and
#: a path leaf whose gᵢ starts one float past 16 bytes (both the fused form
#: by cp.async), each (n, da, d1, d2, db, A transposed, g offset)
BT_EXTRA = ((8, 5, 7, 3, 6, False, False), (1, 96, 96, 32, 32, True, False),
            (1, 8, 8000, 64, 8, False, False), (3, 130, 70, 200, 9, False, False),
            (8, 96, 96, 32, 32, True, True))
#: forms and loaders the operands cannot take, which must raise: a stripe
#: past a fused block's shared memory, odd widths on the two-stage form,
#: and TMA for a gᵢ that starts one float past 16 bytes, fused and
#: two-stage; each (n, da, d1, d2, db, form, loader, g offset)
BT_REFUSED = ((2, 16, 16, 4096, 16, "fused", "cp_async", False),
              (8, 5, 7, 3, 6, "two_stage", "tma", False),
              (8, 96, 96, 32, 32, "fused", "tma", True),
              (1, 8, 8000, 64, 8, "two_stage", "tma", True))


def basis_transform_phase(torch, bt, profile: bool) -> dict:
    """Kernel 4 through its wrapper, `basis_transform`, in the form and
    loader its plan takes, against its plain version (within
    BT_TOL_PLAIN·max|ref|) and float64 (BT_TOL_F64·max|ref|), at the path's
    leaves with A as rotate passes it (U.mT) and contiguous (TMA asserted
    there), at 1024² (both layouts) and at BT_EXTRA; where the other form
    can run (the path's leaves, 1024², d1 = 8000), that form too, forced,
    bitwise equal to the plan's; the CUDA launches of each call against
    its form's; the distance to its arithmetic emulated in PyTorch; the
    refusals of BT_REFUSED.  Then times the wrapper at the path's leaves
    (U.mT) and at 1024², and the other form forced, beside the plain
    version, `matmul(matmul(A, g), B)` and both bounds, with the device
    time of the first leaf's call (with `profile`, of every timed call).
    Fails where a time falls under the 3xTF32 bound, and where at 1024²
    the plan's form is slower than the library pair or than the other form
    (the two-stage form's reason to be)."""
    import dataclasses

    import numpy as np

    rng = np.random.default_rng(4)

    def operands(n, da, d1, d2, db, transposed, offset=False):
        if d1 >= 512 and da == d1 and d2 == db:
            # a basis is orthogonal: random orthogonal factors at the large shape
            A = torch.linalg.qr(torch.randn((da, d1), device="cuda", dtype=torch.float64))[0]
            B = torch.linalg.qr(torch.randn((d2, db), device="cuda", dtype=torch.float64))[0]
            A, B = A.float(), B.float().contiguous()
            g = torch.randn((n, d1, d2), device="cuda", dtype=torch.float32)
        else:
            A, g, B = (torch.as_tensor(rng.standard_normal(s).astype(np.float32), device="cuda")
                       for s in ((da, d1), (n, d1, d2), (d2, db)))
        # A as rotate passes it: the transpose of a contiguous U
        A = A.T.contiguous().T if transposed else A.contiguous()
        if offset:   # gᵢ one float past 16 bytes
            g = torch.cat([g.new_zeros(1), g.flatten()])[1:].view(g.shape)
        return A, g, B

    def forced(p, form, loader):
        return dataclasses.replace(p, form=form, bm=bt.BM[form], loader=loader)

    def other_form(p):
        if p.form == bt.FUSED:
            return forced(p, bt.TWO_STAGE, bt.TMA)
        return forced(p, bt.FUSED, p.loader)

    def counted(fn):
        """One call of fn, and the CUDA launches it made."""
        made = bt.cuda_launches
        out = fn()
        return out, bt.cuda_launches - made

    path = [(8,) + r for r in DNN_ROTATIONS]
    cases = ([(s, True, False, True) for s in path] + [(s, False, False, True) for s in path]
             + [(LARGE_ROTATION, False, False, True), (LARGE_ROTATION, True, False, False)]
             + [(s[:5], s[5], s[6], s[2] == 8000) for s in BT_EXTRA])
    err = {"plain": 0.0, "f64": 0.0, "plain_rel": 0.0, "f64_rel": 0.0, "emulated_rel": 0.0}
    results = {}
    for shape, transposed, offset, both in cases:
        A, g, B = operands(*shape, transposed, offset)
        p = bt.plan(*shape, transposed, not offset)
        name = "x".join(map(str, shape)) + ("_At" if transposed else "") + ("_g+1" if offset
                                                                            else "")
        if bt.plan(*shape, bt._transposed(A), bt._aligned(A, g, B)) != p:
            raise AssertionError(f"basis_transform {name}: the wrapper plans otherwise")
        if shape in path and not offset and p.loader != bt.TMA:
            raise AssertionError(f"basis_transform {name}: a path leaf loads by {p.loader}")
        runs = {p.form: counted(lambda: bt.basis_transform(A, g, B))}
        if both:
            q = other_form(p)
            runs[q.form] = counted(lambda: bt._kernel(A, g, B, q))
        plain = bt.basis_transform_plain(A, g, B)
        ref = torch.einsum("ab,nbc,cd->nad", A.double(), g.double(), B.double())
        emulated = bt.basis_transform_emulated(A, g, B)
        torch.cuda.synchronize()
        scale = float(ref.abs().max())
        rec = {"shape": list(shape), "a_transposed": transposed, "g_offset": offset,
               "form": p.form, "loader": p.loader, "cuda_launches": {}}
        for form, (out, made) in runs.items():
            want = 1 if form == bt.FUSED else 2
            if made != want:
                raise AssertionError(f"basis_transform {name} ({form}): {made} CUDA launches, "
                                     f"its form makes {want}")
            e_plain = float((out - plain).abs().max())
            e_f64 = float((out.double() - ref).abs().max())
            if e_plain > BT_TOL_PLAIN * scale or e_f64 > BT_TOL_F64 * scale:
                raise AssertionError(f"basis_transform {name} ({form}): |Δ plain| {e_plain}, "
                                     f"|Δ f64| {e_f64}, max|ref| {scale}")
            e_emul = float((out - emulated).abs().max()) / scale
            rec["cuda_launches"][form] = made
            rec[f"rel_err_{form}"] = {"plain": e_plain / scale, "f64": e_f64 / scale,
                                      "emulated": e_emul}
            for key, val in (("plain", e_plain), ("f64", e_f64), ("plain_rel", e_plain / scale),
                             ("f64_rel", e_f64 / scale), ("emulated_rel", e_emul)):
                err[key] = max(err[key], val)
        if both:
            (a, _), (b, _) = runs.values()
            rec["forms_bitwise"] = bool(torch.equal(a.view(torch.int32), b.view(torch.int32)))
            if not rec["forms_bitwise"]:
                raise AssertionError(f"basis_transform {name}: the fused and two-stage forms "
                                     f"differ (same products, same order)")
        results[name] = rec
    refused = []
    for n, da, d1, d2, db, form, loader, offset in BT_REFUSED:
        A, g, B = operands(n, da, d1, d2, db, False, offset)
        try:
            bt._kernel(A, g, B, forced(bt.plan(n, da, d1, d2, db), form, loader))
        except ValueError:
            refused.append([n, da, d1, d2, db, form, loader, offset])
        else:
            raise AssertionError(f"basis_transform's {form} form by {loader} took "
                                 f"{(n, da, d1, d2, db)}" + (" with gᵢ off 16 bytes" if offset
                                                             else ""))

    timings = {}
    for shape, transposed in [(s, True) for s in path] + [(LARGE_ROTATION, False)]:
        A, g, B = operands(*shape, transposed)
        p = bt.plan(*shape, transposed)
        q = other_form(p)
        large = shape == LARGE_ROTATION
        iters = 200 if not large else 5
        _, made = counted(lambda: bt.basis_transform(A, g, B))
        bound, by = basis_transform_bound_tc_ms(*shape)
        bound_f32, by_f32 = basis_transform_bound_ms(*shape)
        calls = {p.form: lambda: bt.basis_transform(A, g, B),
                 q.form: lambda: bt._kernel(A, g, B, q),
                 "library": lambda: torch.matmul(torch.matmul(A, g), B)}
        kernel_ms = cuda_ms(torch, calls[p.form], iters, warmup=2)
        rec = {
            "shape": list(shape), "a_transposed": transposed, "form": p.form,
            "loader": p.loader, "cuda_launches_per_call": made, "kernel_ms": kernel_ms,
            "kernel_ms_forms": {q.form: cuda_ms(torch, calls[q.form], 2 if large else iters,
                                                warmup=1)},
            "plain_ms": cuda_ms(torch, lambda: bt.basis_transform_plain(A, g, B), iters // 2 + 1,
                                warmup=2),
            "library_ms": cuda_ms(torch, calls["library"], iters, warmup=2),
            # the kernel's three split TF32 products on the tensor cores;
            # float32 FMAs on the CUDA cores, which the kernel does not use
            # and so may beat
            "bound_ms": bound, "bound_by": by, "share": bound / kernel_ms,
            "bound_tf32x3_ms": bound,
            "bound_f32_ms": bound_f32, "bound_f32_by": by_f32, "share_f32": bound_f32 / kernel_ms}
        if rec["share"] > 1.0:
            raise AssertionError(f"basis_transform ran under a bound it cannot beat: {rec}")
        if large and not kernel_ms <= min(rec["library_ms"], rec["kernel_ms_forms"][q.form]):
            raise AssertionError(f"basis_transform at {shape}: the plan's {p.form} form "
                                 f"({kernel_ms} ms) is slower than the library pair or the "
                                 f"{q.form} form: {rec}")
        if profile or shape == path[0]:
            dev = device_ms(torch, calls, 5 if large else 50)
            rec["device_ms"] = {call_name: sum(by_kernel.values()) if by_kernel else None
                                for call_name, by_kernel in dev.items()}
            rec["device_ms_by_kernel"] = dev
        timings["x".join(map(str, shape))] = rec
    return {"basis_transform_cases": results, "basis_transform_max_abs_err": err,
            "basis_transform_refused": refused, "basis_transform_timings": timings}


def prng_phase(torch, prng, rounds, device: str = "cuda") -> dict:
    """The port's threefry draws on the card: the committed table of
    jax.random draws (both settings) drawn on the card and on the CPU, equal
    to it entry for entry; draws at the path's shapes (a 512-client split
    and participation mask, the dithering's float32 level draws, Rand-K's
    choice, a 5000-long permutation) on the card bitwise equal to the CPU's;
    then the host time and CUDA launches a round's draws cost, replayed
    without the round's arithmetic, for bl2-xl, fig3/RTopK and
    fig-dnn/RTopK."""
    table = json.loads(PRNG_TABLE.read_text())
    for where in (device, "cpu"):
        got = prng_table(PortRandom(torch, prng, where))
        for flag, draws in table.items():
            bad = [k for k in draws if got[flag][k] != draws[k]]
            if bad:
                raise AssertionError(f"prng on {where}, {flag}: draws {bad} differ from jax's")
    key = prng.PRNGKey(0)
    p32 = torch.rand((10, 24), generator=torch.Generator().manual_seed(0))
    cases = {
        "split_512": lambda dev: prng.split(key, 512, device=dev),
        "bernoulli_f64_512": lambda dev: prng.bernoulli(key, 0.5, (512,), device=dev),
        "dither_levels_10x24": lambda dev: prng.bernoulli(
            prng.split(key, 10, device=dev), p32.to(dev), (24,)),
        "randk_choice_10x60": lambda dev: prng.choice(
            prng.split(key, 10, device=dev), 60, (1,), False),
        "permutation_5000": lambda dev: prng.permutation(key, 5000, device=dev),
        "randint_i64_7": lambda dev: prng.randint(key, (7,), 0, 512, device=dev),
    }
    for flag in (False, True):
        with prng.threefry_partitionable(flag):
            for name, fn in cases.items():
                card, host = fn(device), fn("cpu")
                if card.device.type != device or not torch.equal(card.cpu(), host):
                    raise AssertionError(f"prng {name} (partitionable={flag}): card != CPU")

    dev = torch.device(device)
    R512 = rounds.VmapReducer(n=512, device=dev)
    R10 = rounds.VmapReducer(n=10, device=dev)
    R8 = rounds.VmapReducer(n=8, device=dev)
    p10 = p32.to(dev)
    leaves = [(8, k) for k in (307, 204, 204, 12)]
    pleaf = [torch.rand((8, k), device=dev) for _, k in leaves]
    keys = prng.split(prng.PRNGKey(0), PRNG_COST_ROUNDS)

    def bl2_xl(t):
        k_part = prng.split(keys[t], 4)[0]
        return rounds.participation(R512, k_part, 256)

    def fig3_rtopk(t):
        k_part, _, k_h, k_xi = prng.split(keys[t], 4)
        rounds.participation(R10, k_part, 10)
        prng.bernoulli(R10.client_keys(k_h), p10, (24,))
        return rounds.xi_mask(R10, k_xi, 0.1)

    def fig_dnn_rtopk(t):
        k_g, k_f = prng.split(keys[t], 2)
        out = []
        for leg in (k_g, k_f):
            for k_leaf, p in zip(prng.split(leg, 4), pleaf):
                out.append(prng.bernoulli(R8.client_keys(k_leaf), p, (p.shape[1],)))
        return out

    cost = {}
    for name, fn in (("bl2-xl", bl2_xl), ("fig3/RTopK", fig3_rtopk),
                     ("fig-dnn/RTopK", fig_dnn_rtopk)):
        def run(fn=fn):
            for t in range(PRNG_COST_ROUNDS):
                fn(t)
        run()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = profile_run(torch, run, PRNG_COST_ROUNDS)
        cost[name] = {"host_ms_per_round": wall / PRNG_COST_ROUNDS * 1e3,
                      "cuda_launches_per_round": prof["cuda_launches_per_step"],
                      "device_ms_per_round": prof["device_busy_ms"] / PRNG_COST_ROUNDS}
    return {"table_entries": sum(len(v) for v in table.values()),
            "card_vs_cpu_cases": sorted(cases), "draw_cost": cost}


def topk_legs(cell) -> int:
    """Kernel-1 calls a round of a GLM cell: one for each leg whose
    compressor selects by Top-K (the Hessian leg, the model stream)."""
    return sum(1 for comp in (cell.hess_comp, cell.model_comp)
               if comp is not None and comp.kind in TOPK_KINDS)


def need_exact(name: str, counts: dict, want: dict) -> None:
    """Fail unless every kernel ran exactly as often as `want` says."""
    bad = {kn: (counts[kn], n) for kn, n in want.items() if counts[kn] != n}
    if bad:
        raise AssertionError(f"{name}: kernel launches (counted, expected) {bad}")


def bl2_xl_phase(torch, k, problems, prng, rounds, prob, device: str = "cuda") -> int:
    """BL2 at fig1-xl's widths (n=512, d=1200, τ = 256, 8 rounds) on the
    fig1-xl problem ``prob``, held to the JAX package's reference
    (`problems.BL2_XL_REFERENCE`): the participation masks the port draws
    on the card, every bit stream of each full run, kernel 1 exactly once a
    round; the gaps of every full run bitwise equal to the first's (the
    reference's own full-width gaps are not in the file); seconds a round
    by differencing a 1-round and the full run, medians of
    `BL2_XL_REPEATS`; peak memory; CUDA launches a round (torch.profiler
    over a 1-round and a 3-round run, differenced).  Then the same run on
    the fleet narrowed to d = 40, held to the reference's whole history.
    Returns kernel 1's launches in the last full run."""
    cell = problems.BL2_XL
    ref = json.loads(cell.artifact.read_text())
    R = rounds.VmapReducer(n=cell.problem.n_clients, device=torch.device(device))
    keys = prng.split(prng.PRNGKey(0), cell.steps)
    tau = dict(cell.params)["tau"]
    masks = []
    for t in range(cell.steps):
        mask, _ = rounds.participation(R, prng.split(keys[t], 4)[0], tau)
        masks.append("".join("1" if b else "0" for b in mask.tolist()))
    if masks != ref["masks"]:
        raise AssertionError("bl2-xl: the card's participation masks differ from the reference's")
    problems.run_cell(cell, prob, steps=1)                    # warm-up round
    per_round, t_ones, t_alls, gaps = [], [], [], []
    want = None
    for rep in range(BL2_XL_REPEATS):
        _, t_one, _ = drive(torch, k, lambda: problems.run_cell(cell, prob, steps=1))
        if rep == BL2_XL_REPEATS - 1:
            torch.cuda.reset_peak_memory_stats()
        hist, t_all, counts = drive(torch, k, lambda: problems.run_cell(cell, prob))
        if want is None:
            want = dict.fromkeys(counts, 0)
            want["topk_row_threshold"] = topk_legs(cell) * cell.steps
        need_exact("bl2-xl", counts, want)
        res = check_bits("bl2-xl", hist, ref["xl"])
        gaps.append(hist.gaps)
        t_ones.append(t_one)
        t_alls.append(t_all)
        per_round.append((t_all - t_one) / (cell.steps - 1))
    peak = torch.cuda.max_memory_allocated()
    if any(g != gaps[0] for g in gaps) or not all(map(math.isfinite, gaps[0])):
        raise AssertionError(f"bl2-xl: the full runs' gaps differ or are not finite: {gaps}")
    one = profile_run(torch, lambda: problems.run_cell(cell, prob, steps=1), 1)
    three = profile_run(torch, lambda: problems.run_cell(cell, prob, steps=3), 3)
    emit({"phase": "bl2-xl", "steps": cell.steps, "tau": tau,
          "participants": [m.count("1") for m in masks], "masks_equal": True,
          "run_1_round_s": t_ones, "run_s": t_alls, "s_per_round": sorted(per_round),
          "s_per_round_median": median(per_round), "max_memory_allocated": peak,
          "cuda_launches_per_round": (three["cuda_launches"] - one["cuda_launches"]) / 2,
          "device_busy_ms_per_round": (three["device_busy_ms"] - one["device_busy_ms"]) / 2,
          "launches": counts, "gaps": gaps[0], "reruns_bitwise": BL2_XL_REPEATS,
          "bit_streams_equal": res})

    narrow = problems.BL2_XL_NARROW
    nprob = problems.build_problem(narrow.problem, device=device)
    hist, secs, counts = drive(torch, k, lambda: problems.run_cell(narrow, nprob))
    res = check_history("bl2-xl/BL2_d40", hist, ref["history"])
    need_exact("bl2-xl/BL2_d40", counts, want)
    emit({"phase": "bl2-xl", "cell": narrow.name, "d": narrow.problem.d, "run_s": secs,
          "launches": counts, **res})
    return want["topk_row_threshold"]


def glm_cells_phase(torch, k, problems, cells, paper, phase=None,
                    device: str = "cuda", s_per_round: Optional[dict] = None) -> dict:
    """Run GLM cells on the card, each held to its reference history
    (`problems.Cell.reference_history`: the artifact or the reference file) at
    the GLM gate (`check_history`, with the cell's
    `problems.REFERENCE_SVD_NAN` round), bits exact, kernel 1 launched
    exactly once a round for each leg that selects by Top-K and no other
    kernel; ``paper`` is
    fig1r1's problem, a cell on another regime builds its own.  Emits one
    line a cell (under ``phase``, default the cell's experiment) and
    returns kernel 1's launches by cell; ``s_per_round`` (a dict) collects
    each cell's seconds a round."""
    out = {}
    for cell in cells:
        name = f"{cell.experiment}/{cell.name}"
        t0 = time.perf_counter()
        prob = paper if cell.problem == paper.spec else problems.build_problem(
            cell.problem, device=device)
        setup_s = time.perf_counter() - t0
        hist, secs, counts = drive(torch, k, lambda: problems.run_cell(cell, prob))
        res = check_history(name, hist, cell.reference_history(),
                            svd_nan_round=problems.REFERENCE_SVD_NAN.get(name))
        want = dict.fromkeys(counts, 0)
        want["topk_row_threshold"] = topk_legs(cell) * cell.steps
        need_exact(name, counts, want)
        out[name] = counts["topk_row_threshold"]
        if s_per_round is not None:
            s_per_round[name] = secs / cell.steps
        emit({"phase": phase or cell.experiment, "cell": cell.name, "method": cell.method,
              "basis": cell.basis, "steps": cell.steps, "setup_s": setup_s, "run_s": secs,
              "s_per_round": secs / cell.steps, "launches": counts, **res})
    return out


def _stream_arrays(ys) -> list:
    """A cohort run's (eval_x, ledger, events) streams as host tensors."""
    x, led, ev = ys
    return [x.cpu(), *(getattr(led, leg).cpu() for leg in led.LEGS), ev.cpu()]


def cohort_phase(torch, k, problems, prng, device: str = "cuda") -> dict:
    """The cohort-streaming engine on the card: fig1-xxl's BL2 and FedNL-BAG
    at 131,072 clients through `exp.engine.run_cell`, held to the JAX
    package's file (`problems.COHORT_REFERENCE`): the store's sha256, f*
    within 1e-14 relative, the cohorts of every epoch, each round's
    uploading clients as the run itself drew them (`History.uploads`: BL2's
    participants, FedNL-BAG's senders), every bit stream exact and the gaps
    in the GLM gate; kernel 1 exactly once a round and no other kernel;
    cohort-smoke's BL2 the same way in-process, then through ``python3 -m
    repro_torch.exp run --fig cohort-smoke`` in a subprocess (its artifact
    held to the file).  Then, on engines built directly: the bytes the
    engine copies to the card an epoch (every copy, counted where it is
    made: the cohort's A and b, exactly c·(m·d + m)·8, its carry rows, its
    int32 indices and the frozen statistics), equal at both fleet sizes,
    and the rows copied back; prefetch on and off bitwise equal; set-up
    seconds (store, x*, fleet init), s/round over `COHORT_TIMED_CHUNKS`
    16-round chunks, the prefetch's overlap, and CUDA launches a round
    (torch.profiler over one 4-round epoch, its load included); the same
    BL2 on a `COHORT_FLAT_N`-client store, whose s/round must be at least
    1/`COHORT_FLAT_RATIO` of fig1-xxl's."""
    import tempfile

    import numpy as np

    from repro_torch.core import client_batch, cohort
    from repro_torch.exp import engine

    ref_all = json.loads(problems.COHORT_REFERENCE.read_text())["experiments"]
    out = {}

    def hold(name, cell, prob, ref):
        p = cell.cell.params_dict()
        sha = {a: hashlib.sha256(getattr(prob.store, a).tobytes()).hexdigest() for a in "Ab"}
        if sha != ref["store_sha256"]:
            raise AssertionError(f"{name}: store sha256 {sha} != reference {ref['store_sha256']}"
                                 " (numpy's default_rng stream differs)")
        f_star = cohort.store_loss(prob.store, prob.x_star)
        if not abs(f_star - ref["f_star"]) <= 1e-14 * abs(ref["f_star"]):
            raise AssertionError(f"{name}: f* {f_star!r} != reference {ref['f_star']!r}")
        seed64 = cohort.sampler_seed(prng.PRNGKey(0))
        rpc, c, n = p["rounds_per_cohort"], p["cohort"], prob.n
        cohorts = [cohort.cohort_indices(seed64, n, c, e) for e in range(len(ref["cohorts"]))]
        if [x.tolist() for x in cohorts] != ref["cohorts"]:
            raise AssertionError(f"{name}: the epochs' cohorts differ from the reference's")
        run = ref["runs"][cell.name]
        t0 = time.perf_counter()
        hist, secs, counts = drive(torch, k, lambda: engine.run_cell(cell.exp, cell.cell, prob,
                                                                     device=device))
        want = dict.fromkeys(counts, 0)
        want["topk_row_threshold"] = topk_legs(cell) * cell.steps
        need_exact(name, counts, want)
        kind = "participants" if cell.method == "bl2" else "senders"
        if hist.uploads != run[kind]:
            raise AssertionError(f"{name}: the run's {kind} differ from the reference's")
        if not all(set(u) <= set(cohorts[t // rpc].tolist()) for t, u in enumerate(hist.uploads)):
            raise AssertionError(f"{name}: a round's {kind} lie outside its epoch's cohort")
        res = check_history(name, hist, run)
        out.setdefault("run_cell_s", {})[name] = secs
        emit({"phase": "cohort", "cell": name, "steps": cell.steps, "run_cell_s": secs,
              "wall_s": time.perf_counter() - t0, "launches": counts, "f_star": f_star,
              "store_sha256_equal": True, "epochs_equal": len(cohorts),
              f"{kind}_per_round": [len(u) for u in hist.uploads], f"{kind}_equal": True,
              **res})
        return counts["topk_row_threshold"]

    # ---- fig1-xxl at full size ---------------------------------------------
    cells = problems.FIG1_XXL
    spec = cells["BL2"].problem
    t0 = time.perf_counter()
    client_batch.synthetic_store(spec.seed, spec.n_clients, spec.m, spec.d, lam=spec.lam)
    store_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob = engine.build_problem(spec, device)
    build_s = time.perf_counter() - t0
    launches = {}
    for name, cell in cells.items():
        launches[f"fig1-xxl/{name}"] = hold(f"fig1-xxl/{name}", cell, prob, ref_all["fig1-xxl"])

    def stream_engine(store, prefetch=True, cell=cells["BL2"]):
        sspec, basis, csize, rpc, seed = engine.build_stream_spec(
            cell.cell, store.d, store.n, store.lam, cell.cell.params_dict())
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng = cohort.CohortEngine(sspec, store, torch.zeros(store.d, dtype=torch.float64,
                                                            device=device),
                                  cohort=csize, rounds_per_cohort=rpc,
                                  root_key=prng.PRNGKey(seed), basis=basis, prefetch=prefetch)
        torch.cuda.synchronize()
        return eng, time.perf_counter() - t0

    def timed_chunks(eng, steps):
        per_round, first = [], None
        for i in range(COHORT_TIMED_CHUNKS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ys = eng.run_chunk(i * steps, steps)
            torch.cuda.synchronize()
            per_round.append((time.perf_counter() - t0) / steps)
            first = ys if first is None else first
        return per_round, first

    def epoch_bytes(eng) -> dict:
        """The bytes an epoch copies to the card, by kind, from the shapes:
        the cohort's data, its carry rows, its int32 indices and the float64
        frozen statistics (the rows also come back when the epoch ends)."""
        c, st = eng.cohort, eng.store
        return {"data": c * (st.A[0].nbytes + st.b[0].nbytes),
                "rows": c * sum(v[0].nbytes for v in st.state.values()),
                "indices": c * 4,
                "frozen": sum(st.state[leaf][0].astype(np.float64).nbytes
                              for leaf, _ in eng.spec.cohort_aggregates().values())}

    steps = cells["BL2"].steps
    timing = {}
    for n_fleet in (spec.n_clients, COHORT_FLAT_N):
        st = prob.store if n_fleet == spec.n_clients else client_batch.synthetic_store(
            spec.seed, n_fleet, spec.m, spec.d, lam=spec.lam)
        eng, init_s = stream_engine(st)
        per_round, ys_on = timed_chunks(eng, steps)
        m = dict(eng.metrics)
        row = {"n": n_fleet, "fleet_init_s": init_s, "s_per_round": per_round,
               "s_per_round_median": median(per_round), "prefetch_overlap": eng.prefetch_overlap,
               "h2d_bytes_per_epoch": m["h2d_bytes"] / m["epochs_loaded"],
               "h2d_bytes_per_epoch_by_kind": epoch_bytes(eng), "metrics": m}
        if n_fleet == spec.n_clients:
            epoch, start = eng.rpc, [COHORT_TIMED_CHUNKS * steps]

            def next_epoch():
                eng.run_chunk(start[0], epoch)
                start[0] += epoch

            # each profiled run is a fresh epoch: its (prefetched) load included
            prof = profile_run(torch, next_epoch, epoch)
            row.update(cuda_launches_per_round=prof["cuda_launches_per_step"],
                       device_busy_ms_per_round=prof["device_busy_ms"] / epoch,
                       profile_top=prof["top"][:6])
            m = dict(eng.metrics)
            row["metrics"] = m
            by_kind = epoch_bytes(eng)
            # the registered config's c·(m·d + m)·8: 819,200 at fig1-xxl
            want = cells["BL2"].cell.params_dict()["cohort"] * (spec.m * spec.d + spec.m) * 8
            if by_kind["data"] != want:
                raise AssertionError(f"cohort: the cohort's A and b are {by_kind['data']} "
                                     f"bytes, not c·(m·d + m)·8 = {want}")
            if m["h2d_bytes"] != sum(by_kind.values()) * m["epochs_loaded"]:
                raise AssertionError(f"cohort: {m['h2d_bytes']} bytes copied to the card in "
                                     f"{m['epochs_loaded']} epochs, not {by_kind} an epoch")
            if m["d2h_bytes"] != by_kind["rows"] * (m["epochs_loaded"] - 1):
                raise AssertionError(f"cohort: {m['d2h_bytes']} bytes copied back in "
                                     f"{m['epochs_loaded'] - 1} unloads, not "
                                     f"{by_kind['rows']} each")
            eng.close()
            eng, _ = stream_engine(st, prefetch=False)
            ys_off = eng.run_chunk(0, steps)
            if not all(torch.equal(a, b) for a, b in zip(_stream_arrays(ys_on),
                                                         _stream_arrays(ys_off))):
                raise AssertionError("cohort: prefetch on and off give different streams")
            row["prefetch_off_bitwise"] = True
        eng.close()
        timing[n_fleet] = row
    if (timing[spec.n_clients]["h2d_bytes_per_epoch"]
            != timing[COHORT_FLAT_N]["h2d_bytes_per_epoch"]):
        raise AssertionError("cohort: the bytes an epoch copies to the card grow with the fleet")
    ratio = (timing[spec.n_clients]["s_per_round_median"]
             / timing[COHORT_FLAT_N]["s_per_round_median"])
    if not ratio <= COHORT_FLAT_RATIO:
        raise AssertionError(f"cohort: s/round at n={spec.n_clients} is {ratio:.3f}x "
                             f"n={COHORT_FLAT_N}'s (limit {COHORT_FLAT_RATIO})")
    out["fig1-xxl"] = {"store_s": store_s, "build_problem_s": build_s,
                       "newton_s": build_s - store_s, "timing": timing,
                       "s_per_round_ratio": ratio}
    # fig1-xxl's problem stays in the engine's memo: the serve phase serves it

    # ---- cohort-smoke: in-process, then the CLI in a subprocess --------------
    cell = problems.COHORT_SMOKE
    prob = engine.build_problem(cell.problem, device)
    launches["cohort-smoke/BL2"] = hold("cohort-smoke/BL2", cell, prob, ref_all["cohort-smoke"])
    with tempfile.TemporaryDirectory(prefix="chip_smoke_cohort_") as tmp:
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.exp", "run", "--fig",
                               "cohort-smoke", "--out", tmp, "--artifacts", f"{tmp}/exp"],
                              capture_output=True, text=True, timeout=600, cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        cli_s = time.perf_counter() - t0
        path = pathlib.Path(tmp) / "exp" / "cohort-smoke" / "BL2.seed0.json"
        if proc.returncode != 0 or not path.is_file():
            raise AssertionError(f"cohort: the CLI exited {proc.returncode}: "
                                 f"{proc.stderr[-2000:]}")
        from types import SimpleNamespace

        rec = json.loads(path.read_text())
        held = check_history("cohort/cli/cohort-smoke", SimpleNamespace(**rec["history"]),
                             cell.reference_history())
    out["cohort-smoke_cli"] = {"rc": proc.returncode, "wall_s": cli_s,
                               "runtime_s": rec["runtime_s"],
                               "max_gap_abs_err": held["max_gap_abs_err"]}
    out["launches"] = launches
    return out


SERVE_CRASH_AFTER = 14          # case (a): the kill lands mid-run, after round 14
SERVE_XL_CHUNK = 4              # case (c): fig1-xl/BL1, 8 rounds, stopped at 4
SERVE_XXL = (0, 16, 8)          # case (d): fig1-xxl/BL2 seed, rounds, chunk (stopped at 8)
SERVE_CROSS_STOP = 12           # case (a): written on the CPU to here, resumed on the card


def hold_serve(name: str, rec: dict, ref: dict) -> dict:
    """A serve record against the reference's, ``meta`` aside on both:
    events and every bit stream exact, gaps in the GLM gate, everything
    else (config, digest, rounds, degraded count) equal."""
    from types import SimpleNamespace

    res = check_history(name, SimpleNamespace(**rec["history"]), ref["history"])
    if rec["history"]["events"] != ref["history"]["events"]:
        raise AssertionError(f"{name}: events {rec['history']['events']} != reference "
                             f"{ref['history']['events']}")
    rest = {k for k in ref if k not in ("meta", "history") and rec.get(k) != ref[k]}
    if rest:
        raise AssertionError(f"{name}: the record's {sorted(rest)} differ from the reference's")
    res.pop("gaps")
    return res


def strip_meta(rec: dict) -> dict:
    return {k: v for k, v in rec.items() if k != "meta"}


def ckpt_bytes(ckpt_dir) -> int:
    """Bytes of the newest checkpoint in a directory (its npz and manifest)."""
    from repro_torch.exp import artifacts

    t, manifest = artifacts.list_checkpoints(str(ckpt_dir))[-1]
    return os.path.getsize(manifest) + os.path.getsize(str(manifest)[:-len(".json")] + ".npz")


def serve_phase(torch, k, problems, direct: dict, device: str = "cuda") -> dict:
    """The service loop (`repro_torch.launch.fed_serve`) on the card, in a
    temporary checkpoint directory it deletes:

      (d) fig1-xxl/BL2 at 131,072 clients (the cohort phase's memoized
          problem): 16 rounds in chunks of 8 uninterrupted, and stopped at
          round 8 then resumed from its ckpt@2 ``host_state`` checkpoint;
          the two records equal (``meta`` aside), and equal to the JAX
          package's file `problems.COHORT_REFERENCE` (gaps in the GLM gate,
          bits exact, each round's participants as the serve drew them);
      (c) fig1-xl/BL1 at n = 512, d = 1200 on its registered backend
          (``fast+sharded``: one rank runs the single-device path), 8
          rounds in chunks of 4, uninterrupted and stopped at 4 then
          resumed; equal, and equal to results/exp/fig1-xl/BL1.seed0.json
          (BL1 with Top-K and Identity draws nothing);
      (a) fig4/BL2_tau_half through ``python3 -m repro_torch.launch.fed_serve``
          with the reference CI's serve-smoke command: uninterrupted, killed
          by ``--crash-after-round 14`` (exit -9, newest checkpoint below
          30), restarted; the restart's record equals the uninterrupted one
          and both the JAX package's (`problems.SERVE_REFERENCE`); then the
          same serve in-process, counted and timed; then written on the CPU
          to round 12 and resumed on the card, held to the same file: its L
          is in the CPU's data basis, whose SVD column signs may differ
          from cuSOLVER's, and the resume maps it into the card's
          (`fed_serve.basis_fingerprint`; the flipped columns are counted);
      (b) fig4/BL3_tau_half and fig1-bag/BAG_q0.5 (8 rounds, then extended
          to 24 from its checkpoint) in-process with their fault plans,
          against the same file.

    Every in-process serve runs under `drive`: kernel 1 exactly once a
    round a Top-K leg, no other kernel.  Each case reports s/round served
    (the record's runtime less its checkpoint writes, over the rounds it
    ran: the carry's init or the load, the rounds and the final gap
    evaluation) and s/round in its chunks alone (``meta.chunk_s``) beside
    the direct call's, the newest checkpoint's bytes, its write and load
    seconds, and ``ttfr_s``."""
    import shutil
    import tempfile
    from types import SimpleNamespace

    from repro_torch.exp import artifacts, engine
    from repro_torch.launch import fed_serve

    ref = json.loads(problems.SERVE_REFERENCE.read_text())["cases"]
    quiet = {"log": lambda *a: None}
    out, launches = {}, {}
    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))

    def want_k1(name, cell, rounds_run, counts):
        want = dict.fromkeys(counts, 0)
        want["topk_row_threshold"] = topk_legs(cell) * rounds_run
        need_exact(name, counts, want)
        launches[name] = launches.get(name, 0) + counts["topk_row_threshold"]

    def timing(rec, secs, ckpt_dir) -> dict:
        m = rec["meta"]
        ran = rec["rounds"] - (m["resumed_from"] or 0)
        return {"rounds_run": ran, "wall_s": secs, "runtime_s": m["runtime_s"],
                "s_per_round_served": (m["runtime_s"] - sum(m["checkpoint_s"])) / ran,
                "s_per_round_chunks": sum(m["chunk_s"]) / ran,
                "ttfr_s": m["ttfr_s"], "checkpoint_write_s": m["checkpoint_s"],
                "checkpoint_load_s": m["restore_s"], "checkpoint_bytes": ckpt_bytes(ckpt_dir),
                "resumed_from": m["resumed_from"]}

    def served(name, cell, ckpt_dir, **kw):
        rec, secs, counts = drive(torch, k, lambda: fed_serve.serve(
            exp_name=cell.experiment, cell_name=cell.name, ckpt_dir=str(ckpt_dir),
            device=device, **quiet, **kw))
        want_k1(name, cell, rec["rounds"] - (rec["meta"]["resumed_from"] or 0), counts)
        rec = json.loads(json.dumps(rec))        # the record as its JSON file holds it
        return rec, timing(rec, secs, ckpt_dir)

    def split_equal(name, cell, whole, stop, **kw):
        """Stop at ``stop`` rounds, resume to the end in a second call: the
        record equals ``whole`` (meta aside)."""
        d = tmp / f"{name.replace('/', '_')}_split"
        first, t1 = served(f"{name} (to {stop})", cell, d, max_rounds=stop, **kw)
        rec, t2 = served(f"{name} (resumed)", cell, d, max_rounds=whole["rounds"], **kw)
        if rec["meta"]["resumed_from"] != stop:
            raise AssertionError(f"{name}: resumed from {rec['meta']['resumed_from']}, not {stop}")
        if strip_meta(rec) != strip_meta(whole):
            raise AssertionError(f"{name}: resumed at round {stop}, the record differs from "
                                 "the uninterrupted serve's")
        shutil.rmtree(d)
        return first, rec, t1, t2

    try:
        # ---- (d) fig1-xxl/BL2 at 131,072 clients ---------------------------------
        cell = problems.FIG1_XXL["BL2"]
        name = "fig1-xxl/BL2"
        seed, total, chunk = SERVE_XXL
        fref = json.loads(problems.COHORT_REFERENCE.read_text())["experiments"]["fig1-xxl"]
        whole, tw = served(name, cell, tmp / "xxl", seed=seed, chunk=chunk, max_rounds=total)
        shutil.rmtree(tmp / "xxl")
        first, rec, t1, t2 = split_equal(name, cell, whole, total // 2, seed=seed, chunk=chunk)
        run = fref["runs"]["BL2"]
        if whole["meta"]["uploads"] != run["participants"] or \
                first["meta"]["uploads"] + rec["meta"]["uploads"] != run["participants"]:
            raise AssertionError(f"{name}: the serve's participants differ from the reference's")
        res = check_history(name, SimpleNamespace(**whole["history"]), run)
        res.pop("gaps")
        out[name] = {"n_clients": whole["meta"]["n_clients"], "uninterrupted": tw,
                     "stopped": t1, "resumed": t2, "participants_equal": True,
                     "s_per_round_direct": direct[name], **res}
        emit({"phase": "serve", "case": "d", "cell": name, **out[name]})
        engine.build_problem.cache_clear()
        torch.cuda.empty_cache()

        # ---- (c) fig1-xl/BL1 at full width ---------------------------------------
        cell = problems.FIG1_XL
        name = "fig1-xl/BL1"
        t0 = time.perf_counter()
        engine.build_problem(cell.problem, device).bases(cell.basis)
        build_s = time.perf_counter() - t0
        whole, tw = served(name, cell, tmp / "xl", chunk=SERVE_XL_CHUNK, max_rounds=cell.steps)
        shutil.rmtree(tmp / "xl")
        _, rec, t1, t2 = split_equal(name, cell, whole, SERVE_XL_CHUNK, chunk=SERVE_XL_CHUNK)
        registered = "fast" if cell.cell.backend == "auto" else cell.cell.backend
        if whole["config"]["backend"] != registered:        # fig1-xl: "fast+sharded"
            raise AssertionError(f"{name}: served on {whole['config']['backend']!r}, not the "
                                 f"registered {registered!r}")
        res = check_history(name, SimpleNamespace(**whole["history"]),
                            json.loads(cell.artifact.read_text())["history"])
        res.pop("gaps")
        out[name] = {"problem_build_s": build_s, "uninterrupted": tw, "stopped": t1,
                     "resumed": t2, "s_per_round_direct": direct[name], **res}
        emit({"phase": "serve", "case": "c", "cell": name, **out[name]})
        engine.build_problem.cache_clear()
        torch.cuda.empty_cache()

        # ---- (a) kill -9 through the CLI -----------------------------------------
        name = "fig4/BL2_tau_half"
        case = ref[name]

        def cli(ckpt, *extra):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.fed_serve", *case["args"],
                 "--ckpt-dir", str(ckpt), "--device", device, *extra], capture_output=True,
                text=True,
                timeout=600, cwd=ROOT, env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
            return proc, time.perf_counter() - t0

        p_ref, s_ref = cli(tmp / "cli_ref", "--result", str(tmp / "cli_ref.json"))
        if p_ref.returncode != 0:
            raise AssertionError(f"{name}: the CLI exited {p_ref.returncode}: "
                                 f"{p_ref.stderr[-2000:]}")
        p_kill, s_kill = cli(tmp / "cli_crash", "--crash-after-round", str(SERVE_CRASH_AFTER))
        ts = [t for t, _ in artifacts.list_checkpoints(str(tmp / "cli_crash"))]
        if p_kill.returncode != -9 or not ts or max(ts) >= case["record"]["rounds"]:
            raise AssertionError(f"{name}: the armed CLI exited {p_kill.returncode} with "
                                 f"checkpoints {ts}: {p_kill.stderr[-2000:]}")
        p_res, s_res = cli(tmp / "cli_crash", "--result", str(tmp / "cli_res.json"))
        if p_res.returncode != 0 or "resumed from checkpoint" not in p_res.stdout:
            raise AssertionError(f"{name}: the restart exited {p_res.returncode}: "
                                 f"{p_res.stdout[-1000:]} {p_res.stderr[-2000:]}")
        whole = json.loads((tmp / "cli_ref.json").read_text())
        resumed = json.loads((tmp / "cli_res.json").read_text())
        if resumed["meta"]["resumed_from"] != max(ts) or strip_meta(resumed) != strip_meta(whole):
            raise AssertionError(f"{name}: kill -9 and restart differ from the uninterrupted "
                                 "serve")
        held = hold_serve(name, whole, case["record"])
        rec, tin = served(name, problems.FIG4["BL2_tau_half"], tmp / "inproc",
                          **_serve_kwargs(case))
        hold_serve(f"{name} (in-process)", rec, case["record"])
        xd = tmp / "cross_device"
        fed_serve.serve(exp_name="fig4", cell_name="BL2_tau_half", ckpt_dir=str(xd),
                        device="cpu", **quiet,
                        **{**_serve_kwargs(case), "max_rounds": SERVE_CROSS_STOP})
        digest = case["record"]["config_digest"]
        pivots_cpu = artifacts.load_checkpoint(str(xd), config_digest=digest)["host_state"]
        rec_x, tx = served(f"{name} (CPU checkpoint)", problems.FIG4["BL2_tau_half"], xd,
                           **_serve_kwargs(case))
        if rec_x["meta"]["resumed_from"] != SERVE_CROSS_STOP:
            raise AssertionError(f"{name}: the card resumed the CPU's checkpoint from "
                                 f"{rec_x['meta']['resumed_from']}")
        hold_serve(f"{name} (CPU checkpoint, resumed on the card)", rec_x, case["record"])
        pivots_card = artifacts.load_checkpoint(str(xd), config_digest=digest)["host_state"]
        flipped = int((pivots_card["basis/pivot_val"] * pivots_cpu["basis/pivot_val"] < 0).sum())
        out[name] = {"cpu_checkpoint_on_card": {**tx, "columns_flipped": flipped,
                                                "columns": int(pivots_cpu["basis/pivot_val"].size)},
                     "cli_s": {"uninterrupted": s_ref, "killed": s_kill, "restart": s_res},
                     "killed_rc": p_kill.returncode, "checkpoints_at_kill": ts,
                     "resumed_from": resumed["meta"]["resumed_from"],
                     "cli_ttfr_s": {"uninterrupted": whole["meta"]["ttfr_s"],
                                    "restart": resumed["meta"]["ttfr_s"]},
                     "cli_checkpoint_load_s": resumed["meta"]["restore_s"],
                     "in_process": tin, "s_per_round_direct": direct[name], **held}
        emit({"phase": "serve", "case": "a", "cell": name, **out[name]})

        # ---- (b) in-process against the file ---------------------------------------
        for name, cell, ckpt in (("fig4/BL3_tau_half", problems.FIG4["BL3_tau_half"], "bl3"),
                                 ("fig1-bag/BAG_q0.5@8", problems.FIG1_BAG["BAG_q0.5"], "bag"),
                                 ("fig1-bag/BAG_q0.5@24", problems.FIG1_BAG["BAG_q0.5"], "bag")):
            case = ref[name]
            rec, tin = served(name, cell, tmp / ckpt, **_serve_kwargs(case))
            if rec["meta"]["resumed_from"] != case["resumed_from"]:
                raise AssertionError(f"{name}: resumed from {rec['meta']['resumed_from']}")
            held = hold_serve(name, rec, case["record"])
            out[name] = {**tin, "degraded_rounds": rec["degraded_rounds"],
                         "s_per_round_direct": direct[name.split("@")[0]], **held}
            emit({"phase": "serve", "case": "b", "cell": name, **out[name]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["seconds"] = time.perf_counter() - t_phase
    return out


def _serve_kwargs(case: dict) -> dict:
    """`fed_serve.serve` keyword arguments from a reference case: its CLI
    arguments through the CLI's own parser and fault-plan builder."""
    from repro_torch.launch import fed_serve

    a = fed_serve._parser().parse_args(case["args"])
    return {"seed": a.seed, "chunk": a.chunk, "max_rounds": a.max_rounds,
            "plan": fed_serve._build_plan(a, case["record"]["config"]["faults"]["n"])}


def drive(torch, k, run) -> tuple:
    """Drive one path, ``run()``, with every kernel's launch count reset
    just before it and read just after (``k`` holds the kernel modules
    ``tk``, ``tm``, ``bt``, ``fa``, ``ss``); returns (result, seconds,
    launches by kernel, with the CUDA launches of kernel 2's and kernel 4's
    calls as ``topk_compress_sum_cuda`` and ``basis_transform_cuda``).
    Kernel 6's CUDA launches (``ss.cuda_launches``) are reset too, for the
    caller to read."""
    torch.cuda.synchronize()
    k.tk.launches = k.tk.compress_sum_launches = k.tk.compress_sum_cuda_launches = 0
    k.tm.launches = k.bt.launches = k.bt.cuda_launches = 0
    k.fa.launches = k.ss.launches = k.ss.cuda_launches = 0
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0, {"topk_row_threshold": k.tk.launches,
                                           "topk_compress_sum": k.tk.compress_sum_launches,
                                           "topk_compress_sum_cuda":
                                               k.tk.compress_sum_cuda_launches,
                                           "tiled_matmul": k.tm.launches,
                                           "basis_transform": k.bt.launches,
                                           "basis_transform_cuda": k.bt.cuda_launches,
                                           "flash_attention": k.fa.launches,
                                           "ssd_scan": k.ss.launches}


def check_dnn_history(name: str, hist, ref: dict) -> dict:
    """Bit streams exact over every round; loss within 1e-4·|ref| and the
    error rate exact over the held rounds; every loss finite."""
    import numpy as np

    loss, lr = np.asarray(hist.metrics["loss"]), np.asarray(ref["metrics"]["loss"])
    err, er = np.asarray(hist.gaps), np.asarray(ref["gaps"])
    if loss.shape != lr.shape or not np.all(np.isfinite(loss)):
        raise AssertionError(f"{name}: loss {loss} against reference {lr}")
    rel = np.abs(loss - lr) / np.abs(lr)
    h = DNN_HELD_ROUNDS
    if (rel[:h] > DNN_LOSS_RTOL).any() or list(err[:h]) != list(er[:h]):
        raise AssertionError(f"{name}: rounds 0-{h - 1} leave the envelope: loss "
                             f"{loss[:h]} vs {lr[:h]}, error {err[:h]} vs {er[:h]}")
    return {"held_rounds": h, "max_loss_rel_err_held": float(rel[:h].max()),
            "loss_rel_err": list(map(float, rel)),
            "error_rate_diff": list(map(float, err - er)),
            "rounds_error_equal": int((err == er).sum()),
            "bit_streams_equal": check_bits(name, hist, ref)}


def attention_pairs(Sq: int, Sk: int, causal: bool, window) -> int:
    """Visible (query, key) pairs of one head: keys j ≤ i (causal) and
    j > i − window; a row that sees no key averages all Sk values."""
    import numpy as np

    qi = np.arange(Sq)
    hi = np.minimum(qi, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qi - window + 1, 0) if window else np.zeros(Sq, np.int64)
    n = np.maximum(hi - lo + 1, 0)
    return int(np.where(n > 0, n, Sk).sum())


def attention_bound_ms(q, k, causal: bool, window) -> tuple:
    """Least time for masked attention: q, k, v read once and o written once
    in their type, or 4·hd operations (two multiply-adds) a visible pair and
    head at the bfloat16 tensor-core rate (bfloat16 inputs) or the float32
    rate (TF32 stays off), whichever is larger."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    eb = q.element_size()
    bytes_ms = eb * (2 * B * Sq * H * hd + 2 * B * Sk * KVH * hd) / HBM_BYTES_PER_S * 1e3
    rate = BF16_OPS_PER_S if str(q.dtype) == "torch.bfloat16" else OPS32_PER_S
    ops_ms = 4 * hd * B * H * attention_pairs(Sq, Sk, causal, window) / rate * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def ssd_ops_bytes(B: int, S: int, H: int, hd: int, N: int, chunk: int) -> tuple:
    """Operations of the SSD in float32 by the chunked algorithm at the
    kernel's chunk: per batch entry and chunk of c positions, C·Bᵀ once
    (2c²N, shared by the heads), and per head M·x (2c²hd), the chunk state
    (2c·hd·N) and the state's read-out (2c·hd·N); and the bytes of x, dt, A,
    B, C read once and y and the final state written once."""
    c = min(chunk, S)
    ops = B * -(-S // c) * (2 * c * c * N + H * (2 * c * c * hd + 4 * c * hd * N))
    bytes_ = 4 * (2 * B * S * H * hd + B * S * H + H + 2 * B * S * N + B * H * hd * N)
    return ops, bytes_


def ssd_bound_ms(B: int, S: int, H: int, hd: int, N: int, chunk: int) -> tuple:
    """Least time for the SSD's float32 work on the CUDA cores: its
    operations at the float32 rate, or its bytes, whichever is larger."""
    ops, bytes_ = ssd_ops_bytes(B, S, H, hd, N, chunk)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / OPS32_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def ssd_bound_tc_ms(B: int, S: int, H: int, hd: int, N: int, chunk: int) -> tuple:
    """Least time for the same work as kernel 6 issues it: every product as
    TF32_SPLIT_PRODUCTS TF32 products of split operands at the TF32
    tensor-core rate, or the bytes, whichever is larger."""
    ops, bytes_ = ssd_ops_bytes(B, S, H, hd, N, chunk)
    bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    ops_ms = TF32_SPLIT_PRODUCTS * ops / TF32_OPS_PER_S * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), bytes_ms


def attention_kernel_phase(torch, fa) -> dict:
    """Kernel 5 against its plain version (within ATTN_TOL, see there) on the
    path's shapes and the edge cases, then timings at the path's shapes
    beside the plain version, SDPA (`enable_gqa`; the window as a boolean
    mask) and the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(5)

    def rnd(*shape, dtype):
        return torch.randn(*shape, device="cuda", generator=gen).to(getattr(torch, dtype))

    cases = [(f"gemma3 prefill, window {w}", B, S, S, H, KVH, hd, True, w)
             for B, S, H, KVH, hd, w in ATTN_PATH]
    for BH, Sq, Sk, hd, causal, window in ATTN_SWEEP:
        cases.append((f"sweep {BH}x{Sq}x{Sk}x{hd}", BH, Sq, Sk, 1, 1, hd, causal, window))
    for H, KVH in ((4, 4), (8, 4), (8, 1)):
        cases.append((f"GQA rep {H // KVH}", 2, 128, 128, H, KVH, 64, True, None))
    cases += [("Sq != Sk, non-causal", 2, 100, 260, 4, 2, 128, False, None),
              ("rows that see no key", 1, 90, 40, 2, 1, 64, False, 8),
              ("window 5 below the tile", 2, 200, 200, 4, 2, 64, True, 5),
              ("S 333 ragged, hd 256", 1, 333, 333, 8, 4, 256, True, 100),
              ("S 77 ragged, hd 32", 3, 77, 77, 2, 2, 32, True, None),
              ("hd 80, padded to 128", 2, 64, 64, 2, 1, 80, True, None)]
    cases = [c + (dt,) for c in cases for dt in ("bfloat16", "float32")]
    err = {"float32": 0.0, "bfloat16": 0.0}
    rel = {"float32": 0.0, "bfloat16": 0.0}
    #: the largest share of its limit an element's error takes, by type
    share = {"float32": 0.0, "bfloat16": 0.0}

    def hold(name, dt, q, k, v, causal, window):
        out = fa.flash_attention(q, k, v, causal=causal, window=window)
        plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window).float()
        torch.cuda.synchronize()
        d = (out.float() - plain).abs()
        scale = float(plain.abs().max())
        lim = torch.full_like(plain, ATTN_TOL * scale)
        if dt == "bfloat16":
            # one bfloat16 ulp of each plain value: 2^(e−8) for |x| in [2^(e−1), 2^e)
            lim += torch.where(plain == 0, 0.0,
                               torch.ldexp(torch.ones_like(plain), torch.frexp(plain)[1] - 8))
        worst = float((d / lim).max())
        e = float(d.max())
        if not (worst <= 1.0) or out.dtype != q.dtype:
            i = tuple(int(j) for j in torch.nonzero(d > lim)[0]) if worst > 1.0 else None
            raise AssertionError(f"flash_attention on {name} ({dt}): |Δ plain| {e}, "
                                 f"max|plain| {scale}, first element out of bounds {i}")
        share[dt] = max(share[dt], worst)
        err[dt] = max(err[dt], e)
        rel[dt] = max(rel[dt], e / scale)

    for name, B, Sq, Sk, H, KVH, hd, causal, window, dt in cases:
        hold(name, dt, rnd(B, Sq, H, hd, dtype=dt), rnd(B, Sk, KVH, hd, dtype=dt),
             rnd(B, Sk, KVH, hd, dtype=dt), causal, window)
    # q, k, v read through strides: views of head-major (B, H, S, hd) arrays
    for dt in ("float32", "bfloat16"):
        hold("strided views", dt, rnd(2, 8, 96, 64, dtype=dt).transpose(1, 2),
             rnd(2, 4, 96, 64, dtype=dt).transpose(1, 2),
             rnd(2, 4, 96, 64, dtype=dt).transpose(1, 2), True, 24)
    # the bfloat16 kernel reads through TMA, which needs unit head-dim stride
    q, k, v = (rnd(2, 96, n, 128, dtype="bfloat16")[..., ::2] for n in (8, 4, 4))
    try:
        fa.flash_attention(q, k, v, causal=True)
    except ValueError:
        pass
    else:
        raise AssertionError("flash_attention took a bfloat16 view with head-dim stride 2")
    timings = {}
    for B, S, H, KVH, hd, w in ATTN_PATH:
        q, k, v = (rnd(B, S, n, hd, dtype="bfloat16") for n in (H, KVH, KVH))
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        if w is None:
            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                      enable_gqa=True)
        else:
            mask = fa.mask(S, S, True, w, q.device)

            def sdpa():
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
        plain = fa.flash_attention_plain(q, k, v, causal=True, window=w)
        sdpa_err = float((sdpa().transpose(1, 2).float() - plain.float()).abs().max())
        bound, by = attention_bound_ms(q, k, True, w)
        timings["global" if w is None else f"window{w}"] = {
            "shape": [B, S, H, KVH, hd], "window": w, "dtype": "bfloat16",
            "kernel_ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=True,
                                                                  window=w), 20, warmup=2),
            "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_plain(
                q, k, v, causal=True, window=w), 5, warmup=1),
            "library_ms": cuda_ms(torch, sdpa, 20, warmup=2), "sdpa_vs_plain": sdpa_err,
            "bound_ms": bound, "bound_by": by,
            "pairs_per_head": attention_pairs(S, S, True, w)}
        del q, k, v, qt, kt, vt, plain
    torch.cuda.empty_cache()
    return {"cases": len(cases) + 2, "max_abs_err": err, "max_rel_err": rel,
            "limit_share": share, "timings": timings, "templates": fa.kernel_attributes()}


def ssd_kernel_phase(torch, ss) -> dict:
    """Kernel 6's y and final state against its plain version (each within
    SSD_TOL of max|plain|) on the path's shape and the edge cases, then its
    time at the path's shape beside the plain version and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(6)

    def inputs(B, S, H, hd, N, dt_scale=0.5, a_scale=1.0, dt_min=0.01):
        x = torch.randn(B, S, H, hd, device="cuda", generator=gen)
        dt = torch.rand(B, S, H, device="cuda", generator=gen) * dt_scale + dt_min
        A = -(torch.rand(H, device="cuda", generator=gen) + 0.1) * a_scale
        Bm, Cm = (torch.randn(B, S, N, device="cuda", generator=gen) for _ in range(2))
        return x, dt, A, Bm, Cm

    err = {"y": 0.0, "state": 0.0, "y_rel": 0.0, "state_rel": 0.0}

    def hold(name, args, chunk):
        y, s = ss.ssd_scan(*args, chunk=chunk)
        yp, sp = ss.ssd_scan_plain(*args, chunk=chunk)
        torch.cuda.synchronize()
        for key, a, b in (("y", y, yp), ("state", s, sp)):
            e, scale = float((a - b).abs().max()), float(b.abs().max())
            if not (e <= SSD_TOL * scale):
                raise AssertionError(f"ssd_scan on {name}: {key} |Δ plain| {e}, "
                                     f"max|plain| {scale}")
            err[key] = max(err[key], e)
            err[f"{key}_rel"] = max(err[f"{key}_rel"], e / scale)

    cases = 0
    hold("mamba2 prefill", inputs(*SSD_PATH), 256)
    for BH, S, hd, N, chunk in SSD_SWEEP:
        hold(f"sweep {BH}x{S}x{hd}x{N}", inputs(BH, S, 1, hd, N), chunk)
    hold("S 200 ragged", inputs(2, 200, 3, 64, 128), 256)
    hold("heads sharing B and C", inputs(2, 64, 3, 16, 8), 16)
    # rows of 5 and 3 floats: 4-byte copies and a scalar state pass
    hold("head size 5, state size 3", inputs(2, 150, 3, 5, 3), 256)
    # every step decays by exp(−25) or less: the chunk's exponentials underflow
    hold("exp underflow, |dt·A| ≥ 25 a step", inputs(2, 300, 2, 64, 128, 10.0, 50.0, 5.0), 256)
    # x, B and C as views of one conv output, as the Mamba2 layer passes them
    x, dt, A, Bm, Cm = inputs(2, 128, 4, 64, 128)
    conv = torch.cat([x.reshape(2, 128, 256), Bm, Cm], dim=-1)
    xv, bv, cv = torch.split(conv, [256, 128, 128], dim=-1)
    hold("strided views", (xv.reshape(2, 128, 4, 64), dt, A, bv, cv), 256)
    # large decays mixed with near-zero ones: exp(cs_q − cs_k) is a difference
    # of float32 cumulative sums that reach 1e4–1e5 here, so both versions
    # lose digits on the weak decays; held to each other, and each compared
    # with the float64 sequential recurrence
    x, dt, A, Bm, Cm = inputs(2, 300, 2, 64, 128, 20.0, 50.0)
    hold("mixed decays, |cs| to 1e5", (x, dt, A, Bm, Cm), 256)
    cases = len(SSD_SWEEP) + 7
    y = ss.ssd_scan(x, dt, A, Bm, Cm)[0]
    yp = ss.ssd_scan_plain(x, dt, A, Bm, Cm, chunk=256)[0]
    s = torch.zeros(2, 2, 64, 128, dtype=torch.float64, device="cuda")
    y64 = []
    for i in range(300):
        s = (s * torch.exp(dt[:, i].double() * A.double())[:, :, None, None]
             + (dt[:, i, :, None, None] * x[:, i, :, :, None] * Bm[:, i, None, None, :]).double())
        y64.append(torch.einsum("bn,bhdn->bhd", Cm[:, i].double(), s))
    y64 = torch.stack(y64, dim=1)
    scale = float(y64.abs().max())
    mixed = {"kernel_vs_f64": float((y.double() - y64).abs().max()) / scale,
             "plain_vs_f64": float((yp.double() - y64).abs().max()) / scale,
             "kernel_vs_plain": float((y - yp).abs().max()) / float(yp.abs().max())}
    # the kernel's arithmetic (split TF32 products) emulated at other chunk
    # lengths on the same inputs: how much of its distance from float64 the
    # chunk length makes
    for c in SSD_EMULATED_CHUNKS:
        ye = ss.ssd_scan_emulated(x, dt, A, Bm, Cm, chunk=c)[0]
        mixed[f"emulated_chunk{c}_vs_f64"] = float((ye.double() - y64).abs().max()) / scale

    args = inputs(*SSD_PATH)
    ss.cuda_launches = 0
    ss.ssd_scan(*args)
    cuda_launches = ss.cuda_launches
    bound, by = ssd_bound_ms(*SSD_PATH, chunk=ss.KERNEL_CHUNK)
    bound_tc, by_tc, bytes_ms = ssd_bound_tc_ms(*SSD_PATH, chunk=ss.KERNEL_CHUNK)
    kernel_ms = cuda_ms(torch, lambda: ss.ssd_scan(*args), 20, warmup=2)
    # the bounds count the operations of the kernel's own chunk length
    timing = {"shape": list(SSD_PATH), "chunk": 256, "kernel_chunk": ss.KERNEL_CHUNK,
              "kernel_ms": kernel_ms,
              "plain_ms": cuda_ms(torch, lambda: ss.ssd_scan_plain(*args, chunk=256), 5,
                                  warmup=1),
              "library_ms": None,
              # float32 FMAs on the CUDA cores; the kernel's split TF32
              # products on the tensor cores; the bytes alone
              "bound_f32_ms": bound, "bound_f32_by": by, "share_f32": bound / kernel_ms,
              "bound_ms": bound_tc, "bound_by": by_tc, "share": bound_tc / kernel_ms,
              "bound_bytes_ms": bytes_ms}
    if timing["share"] > 1.0 or timing["share_f32"] > 1.0:
        raise AssertionError(f"ssd_scan ran under a bound it cannot beat: {timing}")
    del args
    torch.cuda.empty_cache()
    from repro_torch.kernels import _build

    lib = _build.load("ssd_scan")
    lib.ssd_scan_workspace_floats.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_workspace_floats.restype = ctypes.c_longlong
    return {"cases": cases, "max_abs_err": err, "timing": timing,
            "mixed_decay_y_rel_err": mixed, "cuda_launches_per_call": cuda_launches,
            "workspace_bytes_at_path_shape": 4 * lib.ssd_scan_workspace_floats(*SSD_PATH)}


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {key: _tree_map(fn, v) for key, v in tree.items()}
    return fn(tree)


def _leaves(tree, prefix=""):
    for key, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{key}/")
        else:
            yield f"{prefix}{key}", v


def serve_cell(torch, k, drive, arch, shape, steps, kernel, profile) -> dict:
    """One serve cell: the reduced config on the card against the CPU, then
    the full-width config in bfloat16 at `shape` (see the module docstring)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.launch import serve, shapes
    from repro_torch.models import model as M

    diagnosis = []

    def close(name, got, want):
        got, want = got.float().cpu(), want.float().cpu()
        d = (got - want).abs()
        e, scale = float(d.max()), float(want.abs().max())
        if not (e <= SERVE_TOL * scale):
            raise AssertionError(f"{arch} reduced, {name}: |Δ| {e} > {SERVE_TOL}·{scale}")
        if e > SERVE_UNUSUAL * scale:
            # keep what explains an unusual reading: the largest differences,
            # where they sit and both sides' values
            flat = d.flatten()
            top = torch.topk(flat, min(5, flat.numel())).indices.tolist()
            diagnosis.append({
                "compared": name, "shape": list(d.shape), "rel": e / scale,
                "largest": [{"index": [int(j) for j in np.unravel_index(i, tuple(d.shape))],
                             "card": float(got.flatten()[i]), "cpu": float(want.flatten()[i]),
                             "abs_diff": float(flat[i])} for i in top]})
        return e / scale

    # ---- reduced config: the card's kernels against the CPU's plain versions
    cfg = configs.get_config(arch).reduced(**SERVE_REDUCED[arch])
    n_kernel_layers = sum(1 for s in cfg.layer_specs()
                          if (s.mixer == "attn") == (kernel == "flash_attention"))
    cpu_params = M.init_params(cfg, torch.float32, generator=torch.Generator().manual_seed(0),
                               device="cpu")
    params = _tree_map(lambda t: t.cuda(), cpu_params)
    B, prompt, max_seq = serve.DEBUG_SIZES
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, prompt)),
                              dtype=torch.int32)
    ref = serve.generate(cpu_params, cfg, prompts,
                         M.init_cache(cfg, B, max_seq, torch.float32, device="cpu"), 8)
    out, _, counts = drive(torch, k, lambda: serve.generate(
        params, cfg, prompts.cuda(), M.init_cache(cfg, B, max_seq, torch.float32, device="cuda"),
        8))
    rel = {"prefill_logits": close("prefill logits", out["prefill_logits"],
                                   ref["prefill_logits"])}
    rel["step_logits"] = max(close(f"decode step {i} logits", a, b)
                             for i, (a, b) in enumerate(zip(out["step_logits"],
                                                            ref["step_logits"])))
    rel["cache"] = max(close(f"cache {name}", a, b) for (name, a), (_, b) in
                       zip(_leaves(out["cache"]), _leaves(ref["cache"])))
    if not torch.equal(out["tokens"].cpu(), ref["tokens"]):
        raise AssertionError(f"{arch} reduced: greedy tokens {out['tokens'].tolist()} != "
                             f"CPU {ref['tokens'].tolist()}")
    want = {name: 0 for name in counts}
    want[kernel] = n_kernel_layers
    if counts != want:
        raise AssertionError(f"{arch} reduced: kernel launches {counts}, want {want}")
    toks = prompts[:1, :9].cuda()
    full, _, _ = M.forward(params, cfg, toks)
    cache = M.init_cache(cfg, 1, 16, torch.float32, device="cuda")
    pre = serve.prefill(params, cfg, toks[:, :8], cache)
    dec, _, _ = M.forward(params, cfg, toks[:, 8:9], cache=pre["cache"], cache_pos=8)
    rel["decode_vs_full_forward"] = close("decode after prefill vs full forward",
                                          dec[0, 0], full[0, -1])
    reduced = {"config": cfg.name, "layers": cfg.n_layers, "max_rel_err": rel,
               "tokens_equal": True, "launches": counts}
    if diagnosis:
        emit({"phase": f"serve-{arch.split('_')[0]}-reduced-diagnosis",
              "usual_rel": SERVE_USUAL_REL, "threshold_rel": SERVE_UNUSUAL,
              "items": diagnosis})
    del params, cpu_params, out, ref

    # ---- full width, bfloat16, seeded weights drawn on the card
    cfg = configs.get_config(arch)
    B, prompt, max_seq = serve.sizes(shapes.SHAPES[shape])
    n_kernel_layers = sum(1 for s in cfg.layer_specs()
                          if (s.mixer == "attn") == (kernel == "flash_attention"))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = M.init_params(cfg, torch.bfloat16,
                           generator=torch.Generator(device="cuda").manual_seed(0), device="cuda")
    cache = M.init_cache(cfg, B, max_seq, torch.bfloat16, device="cuda")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, prompt)),
                              dtype=torch.int32, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # warm-up: one prefill and two decode steps (library handles, new shapes);
    # the measured runs overwrite the same cache slots with the same values
    warm = serve.prefill(params, cfg, prompts, cache)
    serve.decode(params, cfg, warm["token"], warm["cache"], prompt, 2)
    pre, _, pre_counts = drive(torch, k, lambda: serve.prefill(params, cfg, prompts, cache))
    pre_ssd_cuda = k.ss.cuda_launches
    dec, _, dec_counts = drive(torch, k, lambda: serve.decode(
        params, cfg, pre["token"], pre["cache"], prompt, steps))
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(pre["logits"]).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in dec["logits"])
    if not finite:
        raise AssertionError(f"{arch}: a prefill or decode logit is not finite")
    want = {name: 0 for name in pre_counts}
    want[kernel] = n_kernel_layers
    if pre_counts != want:
        raise AssertionError(f"{arch} prefill: kernel launches {pre_counts}, want {want}")
    if any(dec_counts.values()):
        raise AssertionError(f"{arch} decode launched a kernel: {dec_counts}")
    result = {"reduced": reduced, "config": cfg.name, "layers": cfg.n_layers,
              "params": M.count_params(params), "shape": shape, "requests": B, "prompt": prompt,
              "max_seq": max_seq, "decode_steps": steps, "setup_s": setup_s,
              "prefill_s": pre["seconds"], "prefill_tok_s": B * prompt / pre["seconds"],
              "decode_s": dec["seconds"], "decode_s_per_step": dec["seconds"] / steps,
              "decode_tok_s": B * steps / dec["seconds"], "max_memory_allocated": peak,
              "logits_finite": finite, "tokens_head": dec["tokens"][0, :8].tolist(),
              "launches_prefill": pre_counts, "launches_decode": dec_counts,
              "ssd_scan_cuda_launches_prefill": pre_ssd_cuda}
    if profile:
        def run():
            p = serve.prefill(params, cfg, prompts, cache)
            serve.decode(params, cfg, p["token"], p["cache"], prompt, 4)
        result["profile"] = profile_run(torch, run, 1)
    del params, cache, pre, dec, warm
    torch.cuda.empty_cache()
    return result


#: substrings of the hand-written kernels' names in a profiler trace
HAND_KERNELS = ("threshold", "select_rows", "column_sum", "compress_sum", "tiled_matmul",
                "stream_kernel", "basis_transform", "flash_kernel", "ssd_prep", "ssd_state",
                "ssd_pass", "ssd_out")


class _StampedLines:
    """A text sink for the CLI's standard output that keeps each line with
    the host time it was written at."""

    def __init__(self):
        self.lines, self._part = [], ""

    def write(self, text: str) -> int:
        self._part += text
        *done, self._part = self._part.split("\n")
        self.lines += [(time.perf_counter(), line) for line in done]
        return len(text)

    def flush(self) -> None:
        pass


def exp_phase(torch, k, per_cell: dict, direct_s_per_round: dict,
              device: str = "cuda") -> dict:
    """The experiment layer on the card: ``python -m repro_torch.exp run
    --fig fig1r1 --fig fig-dnn --fig fig1-xl`` in-process
    (`repro_torch.exp.__main__.main`, ``--device cuda``) into a temporary
    directory, launch counts reset just before it.  Holds every artifact's
    ``config_digest`` to the committed one, its history to the GLM or
    BL-DNN gates, ``bits_to_tol.reached`` to the committed value, each CSV's
    header and length, ``tools/schema_diff.py`` (exit 0), the launches of
    every kernel to the sum of the per-cell phases' counts of the same
    cells (``per_cell``), and a second identical run to all "cached" with
    byte-identical CSVs; then the bare ``python3 -m repro_torch.exp run
    --fig fig1r1`` (no ``--device``: the card) in a subprocess.  Reports
    each experiment's wall and set-up seconds (wall less its cells' runs)
    and s/round through the engine beside ``direct_s_per_round``."""
    import contextlib
    import tempfile
    from types import SimpleNamespace

    from repro_torch.exp import __main__ as cli
    from repro_torch.exp import artifacts, engine, registry

    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_exp_") as tmp:
        argv = ["run", *(a for n in EXP_FIGS for a in ("--fig", n)), "--out", tmp,
                "--artifacts", f"{tmp}/exp", "--device", device]
        sink = _StampedLines()
        with contextlib.redirect_stdout(sink):
            rc, wall, counts = drive(torch, k, lambda: cli.main(argv))
        if rc != 0:
            raise AssertionError(f"exp: the CLI exited {rc}: {sink.lines}")
        stamps = {line: t for t, line in sink.lines}
        csvs = {}
        for name in EXP_FIGS:
            exp = registry.get_experiment(name)
            t0 = stamps[f"== {name}: {exp.title}"]
            t1 = next(t for line, t in stamps.items() if line.startswith(f"== {name} done in"))
            cells, run_total = {}, 0.0
            for cell in exp.cells:
                rec = artifacts.load_json(artifacts.artifact_path(f"{tmp}/exp", name,
                                                                  cell.name, 0))
                ref = json.loads((ROOT / "results" / "exp" / name /
                                  f"{cell.name}.seed0.json").read_text())
                tag = f"exp/{name}/{cell.name}"
                if rec["config_digest"] != ref["config_digest"]:
                    raise AssertionError(f"{tag}: digest {rec['config_digest']} != "
                                         f"committed {ref['config_digest']}")
                hist = SimpleNamespace(**rec["history"])
                if cell.method == "bldnn":
                    held = check_dnn_history(tag, hist, ref["history"])
                else:
                    held = check_history(tag, hist, ref["history"])
                if rec["bits_to_tol"]["reached"] != ref["bits_to_tol"]["reached"]:
                    raise AssertionError(f"{tag}: bits_to_tol {rec['bits_to_tol']} vs "
                                         f"committed {ref['bits_to_tol']}")
                path = pathlib.Path(artifacts.csv_path(tmp, name, cell.name))
                csvs[path] = path.read_bytes()
                rows = path.read_text().splitlines()
                if rows[0] != ",".join(artifacts.CSV_COLUMNS) or len(rows) != cell.steps + 1:
                    raise AssertionError(f"{tag}: CSV header {rows[0]!r}, {len(rows)} lines")
                run_total += rec["runtime_s"]
                cells[cell.name] = {
                    "steps": cell.steps, "runtime_s": rec["runtime_s"],
                    "s_per_round": rec["runtime_s"] / cell.steps,
                    "bits_to_tol": rec["bits_to_tol"],
                    "max_gap_abs_err": held.get("max_gap_abs_err"),
                    "max_loss_rel_err_held": held.get("max_loss_rel_err_held")}
            res[name] = {"wall_s": t1 - t0, "setup_s": t1 - t0 - run_total, "cells": cells}
        diff = subprocess.run([sys.executable, str(ROOT / "tools" / "schema_diff.py"), tmp,
                               str(ROOT / "results")], capture_output=True, text=True,
                              timeout=120)
        if diff.returncode != 0:
            raise AssertionError(f"exp: schema_diff exited {diff.returncode}: {diff.stdout}")
        again = _StampedLines()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(again):
            rc = cli.main(argv)
        cached_s = time.perf_counter() - t0
        statuses = [line.split("[")[1].split("]")[0] for _, line in again.lines
                    if " seed=0 [" in line]
        if rc != 0 or statuses != ["cached"] * len(csvs) or any(
                p.read_bytes() != b for p, b in csvs.items()):
            raise AssertionError(f"exp: the rerun is not all cached with the same CSVs: "
                                 f"rc {rc}, {statuses}")

        bare = pathlib.Path(tmp) / "bare"
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "repro_torch.exp", "run", "--fig",
                               "fig1r1", "--out", str(bare), "--artifacts", str(bare / "exp")],
                              capture_output=True, text=True, timeout=600, cwd=ROOT,
                              env={**os.environ, "PYTHONPATH": str(ROOT / "src")})
        bare_s = time.perf_counter() - t0
        written = sorted(p.name for p in (bare / "exp" / "fig1r1").glob("*.json"))
        if proc.returncode != 0 or len(written) != 4:
            raise AssertionError(f"exp: bare CLI exited {proc.returncode}, wrote {written}: "
                                 f"{proc.stderr[-2000:]}")
    want = {kn: sum(c[kn] for c in per_cell.values()) for kn in counts}
    need_exact("exp", counts, want)
    for kn in ("topk_row_threshold", "topk_compress_sum", "basis_transform"):
        if not counts[kn]:
            raise AssertionError(f"exp: kernel {kn} was not launched: {counts}")
    engine_vs_direct = {
        tag: {"engine": res[tag.split("/")[0]]["cells"][tag.split("/")[1]]["s_per_round"],
              **direct} for tag, direct in direct_s_per_round.items()}
    if "fig1-xl" in EXP_FIGS:
        # a cell's runtime_s holds its problem's basis build (the engine
        # builds bases inside run_cell, as the reference does) and the
        # first run on a fresh problem, which the per-cell phase times
        # apart or warms up: time the build, then two engine runs, on a
        # fresh problem
        xl = registry.get_experiment("fig1-xl")
        prob = engine.build_problem(xl.problem, device)
        runs = []
        for step in [lambda: prob.bases(xl.cells[0].basis)] + [
                lambda: engine.run_cell(xl, xl.cells[0], prob, device=device)] * 2:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            runs.append(time.perf_counter() - t0)
        del prob
        engine.build_problem.cache_clear()
        run = res["fig1-xl"]["cells"]["BL1"]
        engine_vs_direct["fig1-xl/BL1"].update(
            bases_s=runs[0], engine_less_bases=(run["runtime_s"] - runs[0]) / run["steps"],
            engine_run_cell_s_per_round=[t / run["steps"] for t in runs[1:]])
    return {"experiments": res, "cli_s": wall, "launches": counts, "launches_expected": want,
            "digests_equal": len(csvs), "schema_diff": "ok", "cached_rerun_s": cached_s,
            "cached_rerun": statuses, "bare_cli": {"rc": proc.returncode, "artifacts": written,
                                                   "wall_s": bare_s},
            "s_per_round_engine_vs_direct": engine_vs_direct}


def profile_run(torch, run, steps: int) -> dict:
    """Device time by CUDA kernel, the CUDA launches (kernels, copies and
    sets), and host time by operator, over `run()`, a `steps`-round run
    (torch.profiler; a first profiled run warms the profiler up)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = sorted(((ev.self_device_time_total, ev.key, ev.count)
                   for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CUDA and ev.self_device_time_total > 0),
                  reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    host = sorted(((ev.self_cpu_time_total, ev.key, ev.count) for ev in prof.key_averages()
                   if ev.device_type == DeviceType.CPU and ev.self_cpu_time_total > 0),
                  reverse=True)
    launched = sum(r[2] for r in rows)
    return {"steps": steps, "wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "cuda_launches": launched, "cuda_launches_per_step": launched / steps,
            "top": [{"name": k[:100], "device_ms": us / 1e3, "calls": c}
                    for us, k, c in rows[:15]],
            "hand_kernels": [{"name": k[:100], "device_ms": us / 1e3, "calls": c}
                             for us, k, c in rows if any(h in k for h in HAND_KERNELS)],
            "top_host": [{"name": k[:100], "self_cpu_ms": us / 1e3, "calls": c}
                         for us, k, c in host[:15]]}


# ==========================================================================
# sharded: the client-sharded reducer, W ranks sharing the one card (gloo)
# ==========================================================================
def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def sharded_worker(job_file: str) -> int:
    """One rank of the sharded phase (``chip_smoke.py --sharded-worker
    JOB``), started by `run_ranks` with the environment ``torchrun`` sets:
    runs the job's cases through the port's entry points, each with the
    kernels' launch counts and the collectives' bytes reset just before it
    and read just after, and writes what it saw to ``rank{r}.json``."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from types import SimpleNamespace

    from repro_torch.core import cohort, rounds
    from repro_torch.exp import engine, registry
    from repro_torch.kernels import basis_transform as bt
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import tiled_matmul as tm
    from repro_torch.kernels import topk_threshold as tk
    from repro_torch.launch import fed_serve, mesh

    job = json.loads(pathlib.Path(job_file).read_text())
    mesh.init_from_env("cuda")
    rank, size = mesh.world()
    k = SimpleNamespace(tk=tk, tm=tm, bt=bt, fa=fa, ss=ss)
    out, probs = {}, {}
    for case in job["cases"]:
        exp = registry.get_experiment(case["exp"])
        if case["kind"] == "serve":
            a = fed_serve._parser().parse_args(case["args"])
            t0 = time.perf_counter()
            rec = fed_serve.serve(exp_name=a.exp, cell_name=a.cell, seed=a.seed, chunk=a.chunk,
                                  max_rounds=case["stop"], ckpt_dir=case["ckpt_dir"],
                                  plan=fed_serve._build_plan(a, case["n"]),
                                  backend="fast+sharded", device="cuda", log=lambda *x: None)
            out[case["key"]] = {"meta": rec["meta"], "seconds": time.perf_counter() - t0}
            continue
        cell = exp.cell(case["cell"])
        if exp.problem not in probs:
            probs[exp.problem] = engine.build_problem(exp.problem, "cuda")
        prob = probs[exp.problem]
        steps = case["steps"] or cell.steps

        def run(steps=steps):
            return engine.run_cell(exp, cell, prob, steps=steps, backend=case["backend"],
                                   exact=case["exact"], device="cuda")

        if case["warmup"]:
            run(1)
        rounds.collective_stats.update(collectives=0, bytes=0)
        torch.cuda.reset_peak_memory_stats()
        hist, secs, counts = drive(torch, k, run)
        stats = dict(rounds.collective_stats)
        n = (cohort.capacity(int(cell.params_dict()["cohort"]), prob.n)
             if isinstance(prob, engine.StreamProblem) else prob.n)
        out[case["key"]] = {
            "history": {**history_dict(hist), "metrics": hist.metrics, "uploads": hist.uploads},
            "seconds": secs, "steps": steps, "launches": counts,
            "collectives": stats["collectives"], "collective_bytes": stats["bytes"],
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "layout": mesh.client_group(n, "cuda").describe()}
    (pathlib.Path(job["out"]) / f"rank{rank}.json").write_text(json.dumps(out))
    return 0


def run_ranks(world: int, cases: list, tmp: pathlib.Path, timeout: float) -> dict:
    """Start ``world`` ranks of `sharded_worker` on the one card (gloo: the
    ranks share it) with the job ``cases``; every rank must exit 0 within
    ``timeout`` seconds, or the phase fails (and every rank still running is
    killed).  Returns {rank: its results}."""
    tag = f"w{world}_{len(list(tmp.glob('job*.json')))}"
    out = tmp / tag
    out.mkdir()
    job = tmp / f"job_{tag}.json"
    job.write_text(json.dumps({"cases": cases, "out": str(out)}))
    port = _free_port()
    procs, logs = [], []
    try:
        for r in range(world):
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                       OMP_NUM_THREADS="2", REPRO_DIST_TIMEOUT_S=str(int(timeout)))
            logs.append(open(out / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                           "--sharded-worker", str(job)], env=env,
                                          stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
            time.sleep(0.5)
            if any(p.returncode not in (None, 0) for p in procs):
                time.sleep(5.0)        # the others leave their collective
                break
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for f in logs:
            f.close()
    bad = {r: p.returncode for r, p in enumerate(procs) if p.returncode != 0}
    if bad:
        tails = {r: (out / f"rank{r}.log").read_text()[-3000:] for r in bad}
        raise AssertionError(f"sharded ranks failed (rank: exit code) {bad}: {tails}")
    return {r: json.loads((out / f"rank{r}.json").read_text()) for r in range(world)}


def _sharded_launches(sh: dict, kernel: str) -> dict:
    """A kernel's launches on each rank in phase sharded's cases, where it
    ran: {case: [rank 0's, rank 1's, ...]}."""
    out = {}
    for case, row in sh.items():
        if isinstance(row, dict) and "launches_by_rank" in row:
            counts = [row["launches_by_rank"][r][kernel] for r in sorted(row["launches_by_rank"])]
            if any(counts):
                out[case] = counts
    return out


def _hist_tuple(h: dict) -> tuple:
    return (h["gaps"], h["up_bits"], h["down_bits"], h["legs"], h.get("metrics"))


def _envelope(name: str, ap: dict, ex: dict, dnn: bool) -> dict:
    """exact=False against exact: the reference's envelope (gaps rtol
    1e-6, atol 1e-12; bits rtol 1e-9); BL-DNN's loss in its rounds-0–3
    gate, its error rate and bits exact."""
    import numpy as np

    if dnn:
        loss, le = np.asarray(ap["metrics"]["loss"]), np.asarray(ex["metrics"]["loss"])
        h = DNN_HELD_ROUNDS
        rel = np.abs(loss - le) / np.abs(le)
        if (rel[:h] > DNN_LOSS_RTOL).any() or ap["gaps"][:h] != ex["gaps"][:h] \
                or ap["legs"] != ex["legs"] or not np.all(np.isfinite(loss)):
            raise AssertionError(f"{name}: exact=False leaves BL-DNN's gate: loss {loss[:h]} "
                                 f"vs {le[:h]}, error {ap['gaps'][:h]} vs {ex['gaps'][:h]}")
        return {"max_loss_rel_diff_held": float(rel[:h].max())}
    g, ge = np.asarray(ap["gaps"]), np.asarray(ex["gaps"])
    if not np.all(np.abs(g - ge) <= ENV_RTOL * np.abs(ge) + ENV_ATOL):
        raise AssertionError(f"{name}: exact=False gaps {g} leave the envelope of {ge}")
    for key in ("up_bits", "down_bits"):
        if not np.allclose(ap[key], ex[key], rtol=ENV_BITS_RTOL, atol=0.0):
            raise AssertionError(f"{name}: exact=False {key} {ap[key]} vs {ex[key]}")
    return {"max_gap_abs_diff": float(np.abs(g - ge).max()),
            "bits_equal": ap["up_bits"] == ex["up_bits"] and ap["down_bits"] == ex["down_bits"]}


def sharded_phase(torch, k, problems, smi: str, one_s_per_round: dict) -> dict:
    """The client-sharded reducer (`repro_torch.core.rounds.ShardedReducer`)
    with W ranks sharing the one card through gloo; see the module
    docstring's phase ``sharded``.  Every case prints one line with W,
    the ranks holding clients, the process-group backend, s/round beside
    the one-process run's, the bytes a rank's collectives delivered a round
    and each rank's peak device memory, beside the card's name and power
    limit."""
    import tempfile
    from types import SimpleNamespace

    from repro_torch.exp import engine, registry
    from repro_torch.launch import fed_serve

    res = {}
    t_phase = time.perf_counter()
    # exact runs that are not bitwise the one-process run: collected so one
    # call reports every case, and the phase fails at its end
    not_bitwise = {}

    def bitwise(case: str, ranks: dict, one: dict) -> bool:
        """Every rank's history bitwise ``one``; else the first round and
        the largest gap difference are noted under ``case``."""
        import numpy as np

        for r in sorted(ranks):
            got = ranks[r]["history"]
            if _hist_tuple(got) != _hist_tuple(one):
                g, go = np.asarray(got["gaps"]), np.asarray(one["gaps"])
                diff = np.nonzero(g != go)[0]
                not_bitwise[case] = {
                    "rank": r, "first_round": int(diff[0]) if diff.size else None,
                    "max_gap_abs_diff": float(np.abs(g - go).max()),
                    "bits_equal": (got["up_bits"], got["down_bits"], got["legs"]) ==
                                  (one["up_bits"], one["down_bits"], one["legs"])}
                return False
        return True

    def line(case: str, ranks: dict, one: Optional[float], extra: dict) -> None:
        r0 = ranks[0]
        row = {"phase": "sharded", "case": case, "card": smi, "W": len(ranks),
               "ndev": r0["layout"]["ndev"], "process_group": r0["layout"]["backend"],
               "s_per_round": r0["seconds"] / r0["steps"], "one_process_s_per_round": one,
               "collective_bytes_a_round_a_rank": [
                   ranks[r]["collective_bytes"] / ranks[r]["steps"] for r in sorted(ranks)],
               "collectives_a_round": r0["collectives"] / r0["steps"],
               "peak_bytes_a_rank": [ranks[r]["peak_bytes"] for r in sorted(ranks)],
               "launches_by_rank": {r: ranks[r]["launches"] for r in sorted(ranks)}, **extra}
        emit(row)
        res[case] = row

    def need_rank_launches(case: str, ranks: dict, want: dict) -> None:
        """Every rank that holds clients launched each named kernel exactly
        ``want`` times (a rank off the client group none)."""
        for r, got in ranks.items():
            active = r < got["layout"]["ndev"]
            bad = {kn: (got["launches"][kn], n if active else 0) for kn, n in want.items()
                   if got["launches"][kn] != (n if active else 0)}
            if bad:
                raise AssertionError(f"{case} rank {r}: kernel launches (counted, needed) {bad}")

    # ---- one rank: fig1-xl's registered fast+sharded is "fast", bit for bit
    xl = problems.FIG1_XL
    prob = problems.build_problem(xl.problem, device="cuda")
    engine.run_cell(xl.exp, xl.cell, prob, steps=1, backend="fast", device="cuda")  # warm-up
    one_xl, secs_one, counts = drive(torch, k, lambda: engine.run_cell(
        xl.exp, xl.cell, prob, backend="fast", device="cuda"))
    sh1, secs_sh1, counts1 = drive(torch, k, lambda: problems.run_cell(xl, prob))
    if _hist_tuple(history_dict(sh1) | {"metrics": None}) != \
            _hist_tuple(history_dict(one_xl) | {"metrics": None}):
        raise AssertionError("fig1-xl: fast+sharded on one rank is not bitwise fast")
    held = check_history("fig1-xl (fast+sharded, one rank)", sh1,
                         json.loads(xl.artifact.read_text())["history"])
    need_exact("fig1-xl one rank", counts1, {"topk_row_threshold": xl.steps, "tiled_matmul": 0})
    emit({"phase": "sharded", "case": "fig1-xl/BL1 W=1", "card": smi, "W": 1, "ndev": 1,
          "process_group": "none", "s_per_round": secs_sh1 / xl.steps,
          "one_process_s_per_round": secs_one / xl.steps, "bitwise_fast": True,
          "launches": counts1, "max_gap_abs_err": held["max_gap_abs_err"]})
    xl_one, xl_one_s, _ = drive(torch, k, lambda: engine.run_cell(
        xl.exp, xl.cell, prob, steps=SHARDED_XL_STEPS, backend="fast", device="cuda"))
    xl_one = history_dict(xl_one) | {"metrics": None}
    del prob, one_xl, sh1
    problems.build_problem.cache_clear()
    torch.cuda.empty_cache()

    # ---- the one-process runs the W = 4 cells are held to -------------------
    ones = {}
    for exp_name, cell_name in SHARDED_CELLS:
        exp = registry.get_experiment(exp_name)
        cell = exp.cell(cell_name)
        prob = engine.build_problem(exp.problem, "cuda")
        engine.run_cell(exp, cell, prob, steps=1, backend="fast", device="cuda")   # warm-up
        hist, secs, counts = drive(torch, k, lambda: engine.run_cell(
            exp, cell, prob, backend="fast", device="cuda"))
        ones[f"{exp_name}/{cell_name}"] = (history_dict(hist) | {"metrics": hist.metrics},
                                           secs / cell.steps, counts)
    smoke = registry.get_experiment("cohort-smoke")
    sprob = engine.build_problem(smoke.problem, "cuda")
    hist, secs, _ = drive(torch, k, lambda: engine.run_cell(
        smoke, smoke.cell("BL2"), sprob, device="cuda"))
    ones["cohort-smoke/BL2"] = (history_dict(hist) | {"metrics": None, "uploads": hist.uploads},
                                secs / smoke.cell("BL2").steps, None)
    serve_case = json.loads((ROOT / "src/repro_torch/exp/data/fed_serve_ref.json").read_text())
    serve_case = serve_case["cases"][SERVE_SMOKE_CASE]
    problems.build_problem.cache_clear()
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="chip_smoke_sharded_") as tmp:
        tmp = pathlib.Path(tmp)
        # ---- W = 4: the cells exact and exact=False, cohort-smoke, a serve
        cases = [{"key": f"{e}/{c}/{'exact' if ex else 'ring'}", "kind": "cell", "exp": e,
                  "cell": c, "steps": None, "backend": "fast+sharded", "exact": ex,
                  "warmup": True}
                 for e, c in SHARDED_CELLS for ex in (True, False)]
        cases.append({"key": "cohort-smoke/BL2", "kind": "cell", "exp": "cohort-smoke",
                      "cell": "BL2", "steps": None, "backend": "cohort+sharded",
                      "exact": True, "warmup": False})
        a = fed_serve._parser().parse_args(serve_case["args"])
        cases.append({"key": "serve", "kind": "serve", "exp": a.exp, "args": serve_case["args"],
                      "stop": SERVE_SMOKE_STOP, "ckpt_dir": str(tmp / "serve"),
                      "n": serve_case["record"]["config"]["faults"]["n"]})
        t0 = time.perf_counter()
        w4 = run_ranks(SHARDED_W, cases, tmp, SHARDED_TIMEOUT_S)
        w4_s = time.perf_counter() - t0
        for e, c in SHARDED_CELLS:
            name = f"{e}/{c}"
            one, one_s, one_counts = ones[name]
            ex = {r: w4[r][f"{name}/exact"] for r in w4}
            ring = {r: w4[r][f"{name}/ring"] for r in w4}
            dnn = e == "fig-dnn"
            for r in w4:
                if ring[r]["history"] != ring[0]["history"]:
                    raise AssertionError(f"{name}: rank {r}'s exact=False run differs from "
                                         "rank 0's")
            exact_bitwise = bitwise(name, ex, one)
            cellobj = registry.get_experiment(e).cell(c)
            art = json.loads((ROOT / "results/exp" / e / f"{c}.seed0.json").read_text())
            h0 = SimpleNamespace(**ex[0]["history"])
            held = (check_dnn_history(name, h0, art["history"]) if dnn
                    else check_history(name, h0, art["history"]))
            held.pop("gaps", None)
            held.pop("loss_rel_err", None)
            held.pop("error_rate_diff", None)
            want = {kn: one_counts[kn] for kn in ("topk_row_threshold", "topk_compress_sum",
                                                   "basis_transform") if one_counts[kn]}
            need_rank_launches(name, ex, want)
            need_rank_launches(f"{name} exact=False", ring, want)
            env = _envelope(name, ring[0]["history"], ex[0]["history"], dnn)
            line(f"{name} W={SHARDED_W} exact", ex, one_s,
                 {"bitwise_one_process": exact_bitwise, "artifact": held,
                  "steps": cellobj.steps})
            line(f"{name} W={SHARDED_W} exact=False", ring, one_s, {"envelope": env})
        co = {r: w4[r]["cohort-smoke/BL2"] for r in w4}
        one = ones["cohort-smoke/BL2"][0]
        co_bitwise = bitwise("cohort-smoke/BL2", co, one)
        for r in co:
            if co[r]["history"]["uploads"] != one["uploads"]:
                raise AssertionError(f"cohort-smoke: rank {r}'s participants are not the "
                                     "one-process run's")
        file = json.loads(problems.COHORT_REFERENCE.read_text())["experiments"]["cohort-smoke"]
        held = check_history("cohort-smoke (cohort+sharded)",
                             SimpleNamespace(**co[0]["history"]), file["runs"]["BL2"])
        if co[0]["history"]["uploads"] != file["runs"]["BL2"]["participants"]:
            raise AssertionError("cohort-smoke (cohort+sharded): participants differ from file")
        need_rank_launches("cohort-smoke", co, {"topk_row_threshold": smoke.cell("BL2").steps})
        held.pop("gaps")
        line(f"cohort-smoke/BL2 W={SHARDED_W} cohort+sharded", co,
             ones["cohort-smoke/BL2"][1], {"bitwise_one_process": co_bitwise, "file": held})

        # the serve: written at W = 4 to round SERVE_SMOKE_STOP, resumed here
        # on one rank; the uninterrupted one-rank serve beside it
        kw = _serve_kwargs(serve_case)
        t0 = time.perf_counter()
        resumed = fed_serve.serve(exp_name=a.exp, cell_name=a.cell, ckpt_dir=str(tmp / "serve"),
                                  backend="fast+sharded", device="cuda",
                                  log=lambda *x: None, **kw)
        resumed_s = time.perf_counter() - t0
        whole = fed_serve.serve(exp_name=a.exp, cell_name=a.cell, ckpt_dir=str(tmp / "whole"),
                                backend="fast+sharded", device="cuda",
                                log=lambda *x: None, **kw)
        if resumed["meta"]["resumed_from"] != SERVE_SMOKE_STOP or \
                strip_meta(resumed) != strip_meta(whole):
            raise AssertionError("serve: the W=4 checkpoint resumed on one rank is not the "
                                 "uninterrupted one-rank serve")
        ref = serve_case["record"]
        held = check_history("serve (W=4 → 1)", SimpleNamespace(**resumed["history"]),
                             ref["history"])
        if resumed["history"]["events"] != ref["history"]["events"]:
            raise AssertionError("serve (W=4 → 1): events differ from the reference's")
        held.pop("gaps")
        sv = {r: w4[r]["serve"] for r in w4}
        emit({"phase": "sharded", "case": f"serve {SERVE_SMOKE_CASE} W={SHARDED_W} → 1",
              "card": smi, "W": SHARDED_W, "ndev": sv[0]["meta"]["layout"]["ndev"],
              "process_group": sv[0]["meta"]["layout"]["backend"],
              "rounds_at_W": SERVE_SMOKE_STOP, "seconds_at_W": sv[0]["seconds"],
              "chunk_s_at_W": sv[0]["meta"]["chunk_s"], "resumed_seconds_one_rank": resumed_s,
              "resumed_from": resumed["meta"]["resumed_from"],
              "equals_uninterrupted": True, "reference": held})
        res["serve"] = held

        # ---- W = 2: fig1-xl at full width, fig1-xxl on cohort+sharded ------
        cases = [{"key": "fig1-xl/ring", "kind": "cell", "exp": "fig1-xl", "cell": "BL1",
                  "steps": SHARDED_XL_STEPS, "backend": "fast+sharded", "exact": False,
                  "warmup": True},
                 {"key": "fig1-xl/exact", "kind": "cell", "exp": "fig1-xl", "cell": "BL1",
                  "steps": SHARDED_XL_STEPS, "backend": "fast+sharded", "exact": True,
                  "warmup": False},
                 {"key": "fig1-xxl/BL2", "kind": "cell", "exp": "fig1-xxl", "cell": "BL2",
                  "steps": None, "backend": "cohort+sharded", "exact": True,
                  "warmup": False}]
        t0 = time.perf_counter()
        w2 = run_ranks(SHARDED_XL_W, cases, tmp, SHARDED_TIMEOUT_S)
        w2_s = time.perf_counter() - t0
    ex = {r: w2[r]["fig1-xl/exact"] for r in w2}
    ring = {r: w2[r]["fig1-xl/ring"] for r in w2}
    xl_bitwise = bitwise("fig1-xl/BL1", ex, xl_one)
    held_xl = check_history(f"fig1-xl W={SHARDED_XL_W}", SimpleNamespace(**ex[0]["history"]),
                            xl_one)
    held_xl.pop("gaps")
    need_rank_launches("fig1-xl", ex, {"topk_row_threshold": SHARDED_XL_STEPS})
    need_rank_launches("fig1-xl exact=False", ring, {"topk_row_threshold": SHARDED_XL_STEPS})
    line(f"fig1-xl/BL1 W={SHARDED_XL_W} exact", ex, xl_one_s / SHARDED_XL_STEPS,
         {"bitwise_one_process": xl_bitwise, "one_process": held_xl,
          "steps": SHARDED_XL_STEPS})
    line(f"fig1-xl/BL1 W={SHARDED_XL_W} exact=False", ring, xl_one_s / SHARDED_XL_STEPS,
         {"envelope": _envelope("fig1-xl", ring[0]["history"], ex[0]["history"], False),
          "steps": SHARDED_XL_STEPS})
    xxl = {r: w2[r]["fig1-xxl/BL2"] for r in w2}
    file = json.loads(problems.COHORT_REFERENCE.read_text())["experiments"]["fig1-xxl"]
    held = check_history("fig1-xxl (cohort+sharded)", SimpleNamespace(**xxl[0]["history"]),
                         file["runs"]["BL2"])
    held.pop("gaps")
    for r in xxl:
        if xxl[r]["history"] != xxl[0]["history"]:
            raise AssertionError(f"fig1-xxl: rank {r} differs from rank 0")
    if xxl[0]["history"]["uploads"] != file["runs"]["BL2"]["participants"]:
        raise AssertionError("fig1-xxl (cohort+sharded): participants differ from the file")
    need_rank_launches("fig1-xxl", xxl, {"topk_row_threshold": problems.FIG1_XXL["BL2"].steps})
    # s/round here is `engine.run_cell`'s wall over its rounds (the fleet init
    # and the host's gap evaluation included), as is the one-process figure
    line(f"fig1-xxl/BL2 W={SHARDED_XL_W} cohort+sharded", xxl,
         one_s_per_round.get("fig1-xxl/BL2"), {"file": held, "participants_equal": True,
                                                "s_per_round_is": "run_cell wall / rounds"})
    res["seconds"] = time.perf_counter() - t_phase
    res["spawn_seconds"] = {"W4": w4_s, "W2": w2_s}
    if not_bitwise:
        raise AssertionError(f"sharded: exact runs not bitwise the one-process run: "
                             f"{not_bitwise}")
    return res


def main(argv) -> int:
    if argv[:1] == ["--sharded-worker"]:
        return sharded_worker(argv[1])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: {ROOT} is not a checkout of the repo (no src/repro_torch)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from types import SimpleNamespace

    from repro_torch import device as _device
    from repro_torch.core import baselines, client_batch, prng, rounds
    from repro_torch.exp import problems
    from repro_torch.kernels import SOURCES, _build, ops
    from repro_torch.kernels import basis_transform as bt
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import tiled_matmul as tm
    from repro_torch.kernels import topk_threshold as tk

    k = SimpleNamespace(tk=tk, tm=tm, bt=bt, fa=fa, ss=ss)
    _device.resolve("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    emit({"phase": "build", "sources": list(SOURCES),
          "seconds": time.perf_counter() - t0})

    kern = kernel_phase(torch, tk, "--profile" in argv)
    emit({"phase": "kernels", "kernel": "topk_row_threshold", **kern})
    km = matmul_kernel_phase(torch, tm, ops)
    emit({"phase": "kernels_matmul", "kernel": "tiled_matmul", **km})
    emit({"phase": "prng", **prng_phase(torch, prng, rounds)})

    def need(name, counts, want):
        """Fail unless every kernel ran at least (or, for 0, exactly) as
        often as `want` says."""
        bad = {kn: (counts[kn], n) for kn, n in want.items()
               if (counts[kn] < n if n else counts[kn] != 0)}
        if bad:
            raise AssertionError(f"{name}: kernel launches (counted, needed) {bad}")

    launches = {}
    # ---- fig1r1: the paper's cell, then FedNL and Newton -------------------
    cell = problems.FIG1R1
    t0 = time.perf_counter()
    prob = problems.build_problem(cell.problem, device="cuda")
    prob.bases(cell.basis)
    setup_s = time.perf_counter() - t0
    hist, secs, counts = drive(torch, k, lambda: problems.run_cell(cell, prob))
    launches["fig1r1"] = counts["topk_row_threshold"]
    # the exp phase's launches are held to these per-cell phases' counts
    per_cell = {"fig1r1/BL1": counts}
    direct = {"fig1r1/BL1": {"direct": secs / cell.steps}}
    res = check_history("fig1r1", hist, json.loads(cell.artifact.read_text())["history"])
    need("fig1r1", counts, {"topk_row_threshold": cell.steps, "tiled_matmul": 0})
    emit({"phase": "fig1r1", "setup_s": setup_s, "run_s": secs, "launches": counts, **res})
    for cell in (problems.FIG1R1_CELLS["FedNL"], problems.FIG1R1_CELLS["Newton"]):
        hist, secs, counts = drive(torch, k, lambda: problems.run_cell(cell, prob))
        res = check_history(f"fig1r1/{cell.name}", hist,
                            json.loads(cell.artifact.read_text())["history"])
        need(f"fig1r1/{cell.name}", counts, {"tiled_matmul": 0})
        per_cell[f"fig1r1/{cell.name}"] = counts
        emit({"phase": "fig1r1", "cell": cell.name, "run_s": secs, "launches": counts, **res})

    # ---- fig2: Newton without and with the data basis, both Γ routes -------
    fig2_launches = {}
    for cell, route in ((problems.FIG2["newton_std"], "einsum"),
                        (problems.FIG2["newton_basis"], "einsum"),
                        (problems.FIG2["newton_basis"], "kernel")):
        hist, secs, counts = drive(
            torch, k, lambda: problems.run_cell(cell, prob, basis_project=route))
        f32 = route == "kernel"
        res = check_history(f"fig2/{cell.name} ({route})", hist,
                            json.loads(cell.artifact.read_text())["history"],
                            rtol=F32_GAP_RTOL if f32 else GAP_RTOL)
        need(f"fig2/{cell.name} ({route})", counts,
             {"tiled_matmul": 2 * cell.steps if f32 else 0})
        fig2_launches[f"{cell.name}/{route}"] = counts["tiled_matmul"]
        emit({"phase": "fig2", "cell": cell.name, "basis_project": route, "run_s": secs,
              "launches": counts, **res})
    if "--profile" in argv:
        cell = problems.FIG2["newton_basis"]
        emit({"phase": "profile_fig2_newton_basis_kernel", **profile_run(
            torch, lambda: problems.run_cell(cell, prob, steps=4, basis_project="kernel"), 4)})

    # ---- the stochastic paper cells: fig4, fig6, fig3, fig5, NL1, fig1r3 ----
    cell_s = {}                                  # s/round by cell, for the serve phase
    stochastic = glm_cells_phase(torch, k, problems, problems.STOCHASTIC_CELLS, prob,
                                 s_per_round=cell_s)
    per_cell["fig1r1/NL1"] = {**dict.fromkeys(counts, 0),
                              "topk_row_threshold": stochastic["fig1r1/NL1"]}

    # ---- fig1r2, fig5 (FedNL-BC, DORE), fig1-bag; then the basis grid and a1a
    baseline = glm_cells_phase(torch, k, problems, problems.BASELINE_CELLS, prob,
                               s_per_round=cell_s)
    grid = glm_cells_phase(torch, k, problems, (*problems.BASIS_GRID.values(),
                                                problems.TABLE2_A1A), prob, "basis-grid")

    # ---- fig1-xl: full width on one card ------------------------------------
    cell = problems.FIG1_XL
    t0 = time.perf_counter()
    prob = problems.build_problem(cell.problem, device="cuda")
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    client_batch.newton_solve_fused(client_batch.from_clients(prob.clients), prob.x0,
                                    cell.problem.newton_iters)
    torch.cuda.synchronize()
    newton_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    prob.bases(cell.basis)
    torch.cuda.synchronize()
    bases_s = time.perf_counter() - t0
    problems.run_cell(cell, prob, steps=1)                    # warm-up round
    # seconds per round by differencing a 1-round and a full run, repeated;
    # the last full run is the main path's checked run
    per_round, t_ones, t_alls = [], [], []
    for rep in range(XL_REPEATS):
        _, t_one, _ = drive(torch, k, lambda: problems.run_cell(cell, prob, steps=1))
        if rep == XL_REPEATS - 1:
            torch.cuda.reset_peak_memory_stats()
        hist, t_all, counts = drive(torch, k, lambda: problems.run_cell(cell, prob))
        launches["fig1-xl"] = counts["topk_row_threshold"]
        t_ones.append(t_one)
        t_alls.append(t_all)
        per_round.append((t_all - t_one) / (cell.steps - 1))
    peak = torch.cuda.max_memory_allocated()
    per_cell["fig1-xl/BL1"] = counts
    direct["fig1-xl/BL1"] = {"direct": median(per_round),
                             "direct_full_run": t_alls[-1] / cell.steps}
    res = check_history("fig1-xl", hist, json.loads(cell.artifact.read_text())["history"])
    need("fig1-xl", counts, {"topk_row_threshold": cell.steps, "tiled_matmul": 0})
    emit({"phase": "fig1-xl", "problem_build_s": build_s, "newton_s": newton_s,
          "bases_s": bases_s, "run_1_round_s": t_ones, "run_s": t_alls,
          "s_per_round": sorted(per_round), "s_per_round_median": median(per_round),
          "max_memory_allocated": peak, "launches": counts, **res})

    if "--profile" in argv:
        emit({"phase": "profile_fig1-xl",
              **profile_run(torch, lambda: problems.run_cell(cell, prob, steps=2), 2)})

    # ---- newton-xl: Newton in the data basis at fig1-xl's widths ------------
    def newton_xl(route, steps=NEWTON_XL_STEPS):
        return baselines.newton(prob.clients, prob.x0, prob.x_star, steps,
                                bases=prob.bases(cell.basis), backend="fast",
                                device="cuda", basis_project=route)

    nx = {}
    for route in ("einsum", "kernel"):
        newton_xl(route, steps=1)                             # warm-up round
        per_round, t_ones, t_alls = [], [], []
        for rep in range(NEWTON_XL_REPEATS):
            _, t_one, _ = drive(torch, k, lambda: newton_xl(route, steps=1))
            if rep == NEWTON_XL_REPEATS - 1:
                torch.cuda.reset_peak_memory_stats()
            hist, t_all, counts = drive(torch, k, lambda: newton_xl(route))
            t_ones.append(t_one)
            t_alls.append(t_all)
            per_round.append((t_all - t_one) / (NEWTON_XL_STEPS - 1))
        need(f"newton-xl ({route})", counts,
             {"tiled_matmul": 2 * NEWTON_XL_STEPS if route == "kernel" else 0})
        nx[route] = {"hist": hist, "s_per_round": sorted(per_round),
                     "s_per_round_median": median(per_round), "run_1_round_s": t_ones,
                     "run_s": t_alls, "max_memory_allocated": torch.cuda.max_memory_allocated(),
                     "launches": counts}
    f64 = history_dict(nx["einsum"].pop("hist"))
    res = check_history("newton-xl (kernel route vs float64 route)", nx["kernel"].pop("hist"),
                        f64, rtol=F32_GAP_RTOL)
    launches["newton-xl"] = nx["kernel"]["launches"]["tiled_matmul"]
    emit({"phase": "newton-xl", "steps": NEWTON_XL_STEPS, "f64_gaps": f64["gaps"], **nx,
          "kernel_vs_f64": res})
    if "--profile" in argv:
        emit({"phase": "profile_newton-xl_kernel",
              **profile_run(torch, lambda: newton_xl("kernel", steps=2), 2)})

    # ---- bl2-xl: BL2 at fig1-xl's widths with τ = 256 ---------------------
    launches["bl2-xl"] = bl2_xl_phase(torch, k, problems, prng, rounds, prob)
    del prob
    problems.build_problem.cache_clear()         # the engine's memo holds fig1-xl's
    torch.cuda.empty_cache()

    # ---- BL-DNN kernels -------------------------------------------------------
    kb = bldnn_kernel_phase(torch, tk, "--profile" in argv)
    kb.update(basis_transform_phase(torch, bt, "--profile" in argv))
    emit({"phase": "kernels_bldnn", **kb})

    # ---- fig-dnn / fig-dnn-ship from the carried problem ---------------------
    t0 = time.perf_counter()
    prob = problems.build_problem(problems.DNN_FIG, device="cuda")
    problems.run_dnn_cell(problems.FIG_DNN["BLDNN"], prob, steps=2)   # warm-up
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    dnn_launches = {}
    for cell in (problems.FIG_DNN["BLDNN"], problems.FIG_DNN["TopK"],
                 problems.FIG_DNN["FedAvg"], problems.FIG_DNN_SHIP["TopK"],
                 problems.FIG_DNN_SHIP["BLDNN_f32"], problems.FIG_DNN_SHIP["BLDNN_bf16"],
                 problems.FIG_DNN_SHIP["BLDNN_int8"], problems.FIG_DNN_SHIP["BLDNN_dct"],
                 problems.FIG_DNN_SHIP["BLDNN_hadamard"], problems.FIG_DNN["RTopK"]):
        hist, secs, counts = drive(torch, k, lambda: problems.run_dnn_cell(cell, prob))
        res = check_dnn_history(f"{cell.experiment}/{cell.name}", hist,
                                json.loads(cell.artifact.read_text())["history"])
        if cell.hess_comp.kind == "rtopk":
            # RTop-K selects through kernel 1 on both legs of all 4 leaves
            # (its compress-sum is the two-pass one: no kernel 2); the
            # gradient leg's 4 rotations through kernel 4
            want = dict.fromkeys(counts, 0)
            want["topk_row_threshold"] = 8 * cell.steps
            want["basis_transform"] = want["basis_transform_cuda"] = 4 * cell.steps
            need_exact(f"{cell.experiment}/{cell.name}", counts, want)
        else:
            want = {"tiled_matmul": 0}
            if cell.hess_comp.kind == "topk":
                want["topk_row_threshold"] = want["topk_compress_sum"] = 4 * cell.steps
            if cell.basis is not None:
                want["basis_transform"] = 4 * cell.steps
            need(f"{cell.experiment}/{cell.name}", counts, want)
        if counts["topk_compress_sum_cuda"] != counts["topk_compress_sum"]:
            raise AssertionError(f"{cell.experiment}/{cell.name}: the 8-client compress-sum "
                                 f"should make one CUDA launch a call: {counts}")
        if counts["basis_transform_cuda"] != counts["basis_transform"]:
            raise AssertionError(f"{cell.experiment}/{cell.name}: every leaf's rotation "
                                 f"should be one fused CUDA launch: {counts}")
        dnn_launches[f"{cell.experiment}/{cell.name}"] = counts
        if cell.experiment == "fig-dnn":
            per_cell[f"fig-dnn/{cell.name}"] = counts
        if (cell.experiment, cell.name) == ("fig-dnn", "BLDNN"):
            dnn_s_per_round = secs / cell.steps
        emit({"phase": cell.experiment, "cell": cell.name, "steps": cell.steps,
              "setup_s": setup_s, "run_s": secs, "s_per_round": secs / cell.steps,
              "launches": counts, **res})
    if "--profile" in argv:
        cell = problems.FIG_DNN["BLDNN"]
        emit({"phase": "profile_fig-dnn_BLDNN",
              **profile_run(torch, lambda: problems.run_dnn_cell(cell, prob, steps=4), 4)})
    direct["fig-dnn/BLDNN"] = {"direct": dnn_s_per_round}

    # ---- exp: the CLI over fig1r1, fig-dnn and fig1-xl ----------------------
    del prob
    problems.build_problem.cache_clear()         # the CLI builds its problems itself
    torch.cuda.empty_cache()
    emit({"phase": "exp", **exp_phase(torch, k, per_cell, direct)})
    problems.build_problem.cache_clear()
    torch.cuda.empty_cache()

    # ---- cohort: fig1-xxl (131,072 clients) and cohort-smoke, streamed ------
    co = cohort_phase(torch, k, problems, prng)
    emit({"phase": "cohort", **co})

    # ---- serve: the service loop, kill -9 and resume (fig1-xxl still memoized)
    xxl = problems.FIG1_XXL["BL2"].problem.n_clients
    sv = serve_phase(torch, k, problems, {
        "fig1-xl/BL1": direct["fig1-xl/BL1"]["direct"],
        "fig1-xxl/BL2": co["fig1-xxl"]["timing"][xxl]["s_per_round_median"],
        **{name: cell_s[name] for name in ("fig4/BL2_tau_half", "fig4/BL3_tau_half",
                                           "fig1-bag/BAG_q0.5")}})
    emit({"phase": "serve", "seconds": sv["seconds"], "launches": sv["launches"]})
    problems.build_problem.cache_clear()
    torch.cuda.empty_cache()

    # ---- sharded: the client-sharded reducer, W ranks on the one card ------
    sh = sharded_phase(torch, k, problems, smi, {
        "fig1-xxl/BL2": co["run_cell_s"]["fig1-xxl/BL2"] / problems.FIG1_XXL["BL2"].steps})
    emit({"phase": "sharded", "seconds": sh["seconds"], "spawn_seconds": sh["spawn_seconds"]})
    problems.build_problem.cache_clear()
    torch.cuda.empty_cache()

    # ---- LM serving: kernels 5 and 6, then gemma3-4b and mamba2-370m --------
    ka = attention_kernel_phase(torch, fa)
    emit({"phase": "kernels_attn", "kernel": "flash_attention", **ka})
    ks = ssd_kernel_phase(torch, ss)
    emit({"phase": "kernels_ssd", "kernel": "ssd_scan", **ks})
    serve_res = {}
    for arch, shape, steps, kernel in SERVE_CELLS:
        serve_res[arch] = serve_cell(torch, k, drive, arch, shape, steps, kernel,
                                     "--profile" in argv)
        emit({"phase": f"serve-{arch.split('_')[0]}", **serve_res[arch]})

    xl = kern["timings"]["fig1-xl"]
    cs = kb["compress_sum_timings"]["8x3072"]
    bt_path = kb["basis_transform_timings"]["8x96x96x32x32"]
    bt_large = kb["basis_transform_timings"]["x".join(map(str, LARGE_ROTATION))]
    mm, mg = km["timings"]["newton-xl/T"], km["timings"]["newton-xl/G"]
    fg, fw = ka["timings"]["global"], ka["timings"]["window1024"]
    sd = ks["timing"]
    main = dnn_launches["fig-dnn/BLDNN"]
    emit({"kernels": [{
        "name": "topk_row_threshold", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_threshold.cu",
        "replaces": "src/repro/kernels/topk_threshold.py:73",
        "launches": main["topk_row_threshold"], "max_abs_err": kern["max_abs_err"],
        "ms": xl["kernel_ms"], "plain_ms": xl["plain_ms"], "bound_ms": xl["bound_ms"],
        "bound_by": xl["bound_by"], "library_ms": xl["library_ms"],
        "shape": xl["shape"], "launches_fig1-xl": launches["fig1-xl"],
        "launches_bl2-xl": launches["bl2-xl"], "launches_stochastic_cells": stochastic,
        "launches_fig-dnn/RTopK": dnn_launches["fig-dnn/RTopK"]["topk_row_threshold"],
        "launches_baseline_cells": baseline, "launches_basis_grid": grid,
        "launches_cohort": co["launches"], "launches_serve": sv["launches"],
        "launches_sharded": _sharded_launches(sh, "topk_row_threshold"),
        "path_shapes": {tag: {key: kern["timings"][tag][key] for key in (
            "shape", "k", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for *_, tag in STOCHASTIC_THRESHOLD_SHAPES},
        "cohort_shapes": {tag: {key: kern["timings"][tag][key] for key in (
            "shape", "k", "kernel_ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")} for *_, tag in COHORT_THRESHOLD_SHAPES}}, {
        "name": "topk_compress_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_compress_sum.cu",
        "replaces": "src/repro/kernels/topk_threshold.py:123",
        "launches": main["topk_compress_sum"], "max_abs_err": kb["compress_sum_max_abs_err"],
        "ms": cs["kernel_ms"], "plain_ms": cs["plain_ms"], "bound_ms": cs["bound_ms"],
        "bound_by": cs["bound_by"], "library_ms": None,
        "two_pass_ms": cs["two_pass_ms"], "shape": cs["shape"],
        "cuda_launches": main["topk_compress_sum_cuda"],
        "cuda_launches_per_call": cs["cuda_launches_per_call"],
        "launches_sharded": _sharded_launches(sh, "topk_compress_sum")}, {
        "name": "tiled_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tiled_matmul.cu",
        "replaces": "src/repro/kernels/tiled_matmul.py:70",
        "launches": launches["newton-xl"], "max_abs_err": km["max_abs_err"]["plain"],
        "ms": mm["kernel_ms"], "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
        "bound_by": mm["bound_by"], "library_ms": mm["library_ms"],
        "library_cast_f32_ms": mm["library_cast_f32_ms"],
        "library_f32_copies_ms": mm["library_f32_copies_ms"],
        "shape": [mm["a"], mm["b"]], "launches_fig2": fig2_launches["newton_basis/kernel"],
        "gamma": {key: mg[key] for key in ("a", "b", "template", "kernel_ms", "plain_ms",
                                           "bound_ms", "bound_by", "library_ms",
                                           "library_cast_f32_ms",
                                           "library_f32_copies_ms")}}, {
        "name": "basis_transform", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/basis_transform.cu",
        "replaces": "src/repro/kernels/basis_transform.py:56",
        "launches": main["basis_transform"],
        "max_abs_err": kb["basis_transform_max_abs_err"]["plain"],
        "ms": bt_path["kernel_ms"], "plain_ms": bt_path["plain_ms"],
        "bound_ms": bt_path["bound_ms"], "bound_by": bt_path["bound_by"],
        "library_ms": bt_path["library_ms"], "shape": bt_path["shape"],
        "bound_f32_ms": bt_path["bound_f32_ms"],
        "a_transposed": bt_path["a_transposed"], "form": bt_path["form"],
        "loader": bt_path["loader"],
        "cuda_launches": main["basis_transform_cuda"],
        "cuda_launches_per_call": bt_path["cuda_launches_per_call"],
        "launches_sharded": _sharded_launches(sh, "basis_transform"),
        "device_ms": bt_path["device_ms"][bt_path["form"]],
        "library_device_ms": bt_path["device_ms"]["library"],
        "bound_tf32x3_ms": bt_path["bound_tf32x3_ms"],
        "large": {key: bt_large[key] for key in (
            "shape", "form", "loader", "kernel_ms", "kernel_ms_forms", "plain_ms",
            "library_ms", "bound_ms", "bound_by", "bound_tf32x3_ms", "bound_f32_ms",
            "cuda_launches_per_call")}}, {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:86",
        "launches": serve_res["gemma3_4b"]["launches_prefill"]["flash_attention"],
        "max_abs_err": max(ka["max_abs_err"].values()), "max_rel_err": ka["max_rel_err"],
        "ms": fg["kernel_ms"], "plain_ms": fg["plain_ms"], "bound_ms": fg["bound_ms"],
        "bound_by": fg["bound_by"], "library_ms": fg["library_ms"],
        "shape": fg["shape"] + ["global"], "window1024": {
            key: fw[key] for key in ("kernel_ms", "plain_ms", "bound_ms", "bound_by",
                                     "library_ms")}}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:73",
        "launches": serve_res["mamba2_370m"]["launches_prefill"]["ssd_scan"],
        "max_abs_err": max(ks["max_abs_err"]["y"], ks["max_abs_err"]["state"]),
        "ms": sd["kernel_ms"], "plain_ms": sd["plain_ms"], "bound_ms": sd["bound_ms"],
        "bound_by": sd["bound_by"], "library_ms": None, "shape": sd["shape"],
        "bound_f32_ms": sd["bound_f32_ms"],
        "cuda_launches": serve_res["mamba2_370m"]["ssd_scan_cuda_launches_prefill"],
        "cuda_launches_per_call": ks["cuda_launches_per_call"]}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
