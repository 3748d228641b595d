#!/usr/bin/env python3
"""Smoke test of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py              # what a checkout's check runs
    python3 chip_smoke.py --profile    # + torch.profiler passes over fig1-xl,
                                       #   fig2's and Newton-XL's kernel route,
                                       #   fig-dnn/BLDNN and a prefill + 4 decode
                                       #   steps of each serve cell, and
                                       #   gemma3-4b's keyed init the eager way

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
                blocks, the cohort path's (512, 576) k = 48 and
                (16, 64) k = 16, and a sharded rank's rows (5, 576),
                (5, 14400), (256, 1024) and (256, 576), whose device time
                is taken on every run),
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
     kernels_entry_points — ROADMAP item 20's entry points on the card:
                `topk_threshold` and `ops.topk_compress` (kernel 1) at
                (256, 256) k = 512 and one 1200² row k = 14,400 bitwise
                against their plain twin, `ops.matmul` (kernel 3) at 512²
                to float32 and bfloat16, `ops.basis_transform` (kernel 4)
                at fig-dnn's first leaf, each in its kernel's gate, one
                launch a call, timed beside its plain version, bound and
                library call;
  5. prng     — the port's threefry draws (`repro_torch.core.prng`) on
                the card and on the CPU against the committed table of
                jax.random draws in both threefry settings
                (src/repro_torch/exp/data/prng_table.json, `normal` among
                them), every card hash through kernel 7 (its bits path for
                split, fold_in, bits, uniform and bernoulli; the eager hash
                refused on the card meanwhile), the card's draws at the
                path's shapes bitwise equal to the CPU's with each one's
                exact bits-path launches, `normal` (kernel 7's normal path,
                one launch a piece) at every draw shape of the ten configs'
                inits and BL-DNN (whole leaves to 2¹⁸ draws; the large
                leaves, up to jamba's 3.2 G-draw expert rows, drawn whole on
                the card and held in three windows) in both settings,
                llama4's 5.4 G-draw expert leaf past 2³² − 1 in one launch
                and in windows, the host time, device time and CUDA
                launches a round's draws cost through the bits path and
                through the eager hash (equal draws), and the bits path at
                the rounds' shapes beside its plain version and bound; then
                kernel 7's normal path (`kernels.threefry_normal`): the keyed
                `init_params` of the ten reduced configs card = CPU bitwise
                (bf16 and f32, one launch a drawn leaf), gemma3-4b's
                embedding leaf bitwise its plain version on the card and
                timed beside it, its bound and its bound with every
                operation at the float32 rate, its SASS instruction
                counts and `torch.randn`'s fill, and gemma3-4b's
                full keyed init through the kernel (seconds and ns a draw;
                with --profile also through the eager route, bitwise
                equal).  Every later phase that holds kernel 1 to exactly
                one launch a round a Top-K leg holds the bits path to
                exactly `bits_per_round` a round (the cell's draws);
     fig1r1   — BL1, FedNL (standard basis, Rank-1) and Newton through
                the experiment engine (`repro_torch.exp.problems.run_cell`
                → `exp.engine.run_cell` → `core.bl.bl1` /
                `core.baselines.newton`; every cell phase below goes the
                same way) against the committed artifacts
                results/exp/fig1r1/*.seed0.json;
     fig1r1-reference — the same three cells through
                ``backend="reference"`` (the op-by-op loops,
                `core.bl_reference`), held to their artifacts in the
                reference's envelope between its two backends (gaps atol
                1e-8 and rtol 1e-9, bits rtol 1e-12) and to the same loops
                on the CPU in the GLM gate, kernel 1 exactly once a client a
                round on BL1's Top-K leg (120); and a fleet the fast path
                cannot stack (Top-K on half the clients, Rank-R on the
                rest): "fast" raises `FastPathUnavailable`, "auto" equals
                "reference" bit for bit;
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
     dnn-drawn — a BL-DNN problem the port draws (`DNNProblemSpec(seed=1)`
                at fig-dnn's widths; numpy's and jax.random.normal's draws
                on the host, the per-layer SVD basis by host LAPACK) built
                for the card and for the CPU through `engine.build_problem`,
                fig-dnn/BLDNN and TopK for 40 rounds on each, the card held
                to the CPU in the BL-DNN gate with kernel 1, 2 and 4 launch
                counts exact; and the port's draw of fig-dnn's own spec
                against the carried fixture (x bitwise, y equal, the input
                layer bitwise, the other leaves within 1e-5·max|ref|).
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
                dropout and the default program cache, killed by
                ``--crash-after-round 14`` (exit -9) and restarted from a
                fresh copy of src/ (tier 2 empty) with ``nvcc`` hidden,
                the restart only cache hits and no nvcc run (one dlopen
                each of kernel 1's and kernel 7's libraries), equal to the
                uninterrupted CLI serve bit for bit, and
                written on the CPU to round 12 then resumed on the card
                (its coefficients mapped into the card's SVD basis); it and
                fig4/BL3_tau_half and fig1-bag/BAG_q0.5 (outages,
                stragglers; 8 rounds extended to 24) in-process, each held
                to src/repro_torch/exp/data/fed_serve_ref.json (written by
                tools/serve_reference.py: events and bits exact, gaps in
                the GLM gate); cohort-smoke in-process twice through one
                program cache, the second after `rounds.clear_aot_memo`
                (equal bits, no cohort_chunk trace); kernel 1 exactly
                once a round a Top-K leg; s/round served beside the direct
                call's, checkpoint bytes, write and load seconds, time to
                first round cold and warm.
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
                at W = 2 fig1-xl/BL1 (1 round at full width) exact and
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
                plain version, SDPA and its bound; then, in bfloat16, held
                and timed the same way at the other configs' full-width
                shapes (`ATTN_CONFIG_SHAPES`: granite's 48 query heads on
                one KV head, stablelm's head size 160 on the 256 template,
                codeqwen, deepseek-moe, llama4's rep 5, qwen2-vl's 2304
                positions, whisper's decoder, non-causal encoder over 1500
                frames, and cross-attention of 2048 and of 1 query against
                1500 keys; and the (1, 4096) train shapes of granite,
                stablelm, codeqwen and jamba), with device times; and at a
                sequence-parallel rank's query offset
                (`q_pos0`: phase lm_sharded's gemma3 slices, 1024 queries
                at 0 / 1024 / 2048 against 3072 keys, window 1024 and
                global) in both types, timed at the last slice beside SDPA
                with the offset mask and the bound over the visible pairs;
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
                launches one call makes, as the library counts them; then
                held and timed at jamba-1.5-large's width (4, 2048, 256
                heads of 64, N 128), with random decays and with its init's
                (A = −(1..256), dt a softplus), the latter also against the
                plain version's arithmetic in float64;
  12. serve-<arch> — the LM serving path
                (`repro_torch.launch.serve.prefill` / `decode`) for the ten
                configs (`SERVE_CELLS`; `REDUCED_ONLY` is empty): the reduced
                config in float32 on the card against the same weights and seeded
                stub inputs (whisper's frames, qwen2-vl's prefix
                embeddings) on the CPU (prefill logits, every decode step's
                logits and the cache within 2e-4·max|ref|, 8 greedy tokens
                equal, decode after an 8-token prefill equal to the full
                forward, a MoE config at a capacity that drops nothing),
                then the full-width config in bfloat16 with the reference's
                weights of PRNGKey(0), cut in depth where `SERVE_CELLS`
                says (`cut_layers`; init seconds and peak reported): 4
                requests (mamba2:
                8) of 2048-token prompts, 16 decode steps (gemma3, mamba2)
                or 4 (the others), every logit finite, exactly the kernel
                calls `lm_launches` counts (kernel 5 once an attention
                layer a prefill and, for whisper, once an encoder and a
                cross-attention layer every call; kernel 6 once a Mamba2
                layer a prefill), no other kernel; kernel 7 once a drawn
                leaf of the init; a MoE config's two prefills bitwise equal:
                all ten configs at full width (llama4-maverick one group, 37
                GB; jamba-1.5-large the first five layers of its group, 48
                GB: kernel 5 once and kernel 6 four times a prefill).  A
                reduced reading above 10x the
                usual 2.4e-6 prints one more line:
                the largest differences, where they sit (the compared
                logits or cache leaf, its index) and both sides' values;
  13. kernels_attn_bwd / kernels_ssd_bwd — the backward kernels of kernels
                5 and 6 (`flash_attention_bwd.cu`, `ssd_scan_bwd.cu`)
                through their autograd Functions against autograd through
                the plain versions in float64, the truth (kernel 5's dq, dk,
                dv within 1e-4·max|f64| in f32, elementwise within one bf16
                ulp of the f64 value + 1e-4·max|f64| in bf16; kernel 6's dx,
                ddt, dA, dB, dC within 1e-4·max|f64|), at the train path's
                shapes (gemma3's global and window-1024 layers at (1, 4096,
                8 | 4, 256) in both types, and `ATTN_BWD_PATH`'s other
                shapes: deepseek-moe's, qwen2-vl's, whisper's non-causal
                encoder, decoder and 4096 × 1500 cross-attention, granite's
                48 query heads on one KV head, stablelm's head size 160,
                codeqwen's MHA and jamba's rep 8, their float64 truths a
                batch entry and a few KV heads, or some query heads of one,
                at a time; mamba2's layer at (8, 4096, 32, 64) and jamba's
                at (1, 4096, 256, 64), N 128, with A and dt drawn as their
                inits make them) and
                edge cases (among them decays of up to exp(−550) a step),
                bitwise over two reruns at the path's shapes, each launch's
                registers and spill bytes printed (kernel 5's bfloat16
                templates must be its wgmma kernels and spill nothing), and
                timed beside the plain version's backward, the library's
                (SDPA's backward; none for the SSD) and the bound; kernel
                5's backward also at phase lm_sharded's gemma3 slices
                (query offsets 0 / 1024 / 2048, both types, bitwise over
                reruns), timed at the last;
  14. train   — the LM training path (`repro_torch.launch.train`,
                `models.steps.make_train_step`): all ten configs
                (`TRAIN_REDUCED`) reduced in
                float32 on the card against the CPU from the same weights,
                batches and seeded frames / prefix embeddings (a MoE's
                expert ids compared first, a mismatch named a tie or not;
                2 steps' losses within 2e-4 relative, step 0's gradients
                within 2e-4·max|ref| a leaf), then at full width through
                `launch.train.main`, cut in depth only where `TRAIN_CELLS`
                says (`cut_layers`: gemma3-4b, deepseek-moe at 12 layers,
                qwen2-vl at 6, granite-20b at 18, stablelm-12b at 22,
                codeqwen1.5-7b at 28, jamba-1.5-large at layers 0 and 4 of
                its group at train_4k_b1; mamba2-370m, whisper-small at
                train_4k_b8; no llama4-maverick cell: one MoE layer is 147
                GB of training state;
                bf16 weights and AdamW moments, remat; `TRAIN_STEPS` 2
                steps): every loss finite and exactly the kernel calls
                `train_launches` counts
                (68 kernel-5 forward and 34 backward calls a step for
                gemma3, 96 kernel-6 forward and 48 backward for mamba2,
                whisper's encoder once and its self- and cross-attention
                twice, jamba's two layers 2 + 1 of kernels 5 and 6 each),
                kernel 7 once a drawn leaf, no other kernel;
                deepseek-moe's step-0 gradient twice from the same weights,
                bitwise equal; s/step (the second step's time: the first
                warms up), tokens/s, peak memory, set-up and init s (the
                reference's weights of PRNGKey(0));
                then gemma3-4b, mamba2-370m, granite-20b and jamba-1.5-large
                again through the plain versions (losses
                within 1e-2 relative of the kernels' at step 0, 5e-2 at
                step 1); and the bf16 witness: gemma3-4b at full width,
                cut to 6 layers, one gradient on one 4096-token batch
                through the kernels and through the plain versions in bf16,
                each leaf's relative distance from the float32 plain
                versions' gradient at most twice the bf16 plain versions'
                (or 2⁻⁸);
  15. lm_sharded — the LM's sharding (`repro_torch.sharding`): the cells of
                `LM_SHARDED`, float32, full width cut in depth (deepseek-
                moe-16b (8 layers) prefill of 2 × 4096 tokens and 2 decode
                steps at mesh (2, 2): the expert-parallel MoE, heads and
                vocabulary over `model`, FSDP; gemma3-4b prefill of 3072 tokens and 4
                decode steps at (1, 3): sequence-parallel attention, kernel
                5 at q_pos0 0 / 1024 / 2048; mamba2-370m (12 layers) train,
                8 × 4096, 3 steps at (2, 2): SSM heads over `model`, the
                vocabulary-parallel fused CE; the reduced deepseek-moe
                train: the expert-parallel backward), the one-process port
                on the card first from the same weights and tokens, then the
                ranks of `tests/torch_lm_sharded_worker.py` sharing the card
                through gloo: logits within 2e-4·max|ref|, greedy tokens
                equal, each data shard's expert ids equal or first
                differing at near-ties (a gap within twice the router's
                rounding drift there, `route_diff`), ranks holding the same
                rows bitwise alike; losses within 1e-5 relative and each
                step-0 gradient leaf within 1e-4·max|ref|, or within twice
                the one-process port's own distance under a 1e-7 relative
                perturbation of its weights where that is larger (the
                in-run control, `LM_CONTROL_FACTOR`), every rank's bits
                alike, a rerun bitwise; prefill / decode s or s/step, peak
                memory and collectives by kind and bytes (gloo through host
                memory: a check's seconds, not the path's speed); kernels 5,
                5b, 6, 6b and 7 each launched, counted on every rank; each
                mesh's ranks first hold the reductions (reduce-scatter by
                one all-to-all and a sum in rank order, all-reduce by that
                and an all-gather) bitwise against the n-copy form on CUDA
                tensors through gloo, float32 and bfloat16, sizes that do
                not divide by n, dim 0 and last, sum and max, each counted
                as |x| or 2·|x| padded;
  16. dryrun  — the kernels' fake-tensor routes size their workspaces as
                the built libraries do (kernels 6, 6b, 5b at the cells'
                shapes); `repro_torch.launch.dryrun` in 4 host processes
                started after the build (fake tensors on the CPU, torch's
                fake process group; no card): each lm_sharded cell dry-run at
                its mesh, depth, type and sizes, its collective calls and
                bytes by kind equal to rank 0's measured ones, its argument
                bytes to rank 0's arguments', its peak within 0.75–1.25 of
                rank 0's measured window (less what the process held
                before it); then the reference's four shapes for every
                config on the (16, 16) mesh, each ok or skipped, its peak
                printed beside the card's memory;
  17. fed-lm  — BL-DNN on a language model (`examples/torch_train_lm.py
                --fed`, per-client gradients by torch.func.vmap(grad) with
                the client axis folded into one kernel-5 / 5b launch a
                layer): a reduced LM on the card against the CPU from the
                same weights, batches and SVD factors (round 0's gradients
                and 4 rounds' losses within FED_LM_TOL, bits exact);
                lm-100m at full width, 4 rounds (finite, falling losses,
                bits the CPU's pricing, launches exactly `fed_lm_launches`,
                round 0's loss against a CPU forward, the host SVDs' set-up
                (~160 s, in this process), s/round, peak memory and one
                profiled round); kernels 1,
                2, 4, 5 and 5b at that path's shapes against their plain
                versions, timed beside their bounds and library calls; the
                BL1 head fine-tune (`examples/torch_bl_finetune_head.py`)
                on the card against the CPU.

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

import contextlib
import ctypes
import hashlib
import io
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
#: 32-bit integer operations a second outside the tensor cores: an H100 SXM
#: SM has 64 INT32 lanes (half its 128 FP32 lanes; the Hopper white paper),
#: 132 SMs at 1.98 GHz
INT32_OPS_PER_S = 64 * 132 * 1.98e9
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
#: kernel 1 on the sharded path, a rank's rows (rows, T, k, where): fig1r1's
#: and fig4/BL2's (5, 576) k = 24 and fig4/BL3's (5, 14400) k = 120 at W = 4
#: (two ranks hold the 10 clients), fig1-xl's (256, 1024) k = 1024 and
#: fig1-xxl's (256, 576) k = 48 at W = 2; timed with their device time
SHARDED_THRESHOLD_SHAPES = ((5, 576, 24, "sharded/fig1r1"), (5, 14400, 120, "sharded/fig4-BL3"),
                            (256, 1024, 1024, "sharded/fig1-xl"),
                            (256, 576, 48, "sharded/fig1-xxl"))
#: compressor kinds that select through kernel 1 (`topk_keep_mask`)
TOPK_KINDS = ("topk", "rtopk", "ntopk")
#: the cohort phase: the comparison fleet for the flat-in-n check (the same
#: cohort, τ and epochs as fig1-xxl's BL2), the s/round ratio it must stay
#: under, and the 16-round chunks timed on each fleet (median)
COHORT_FLAT_N = 1024
COHORT_FLAT_RATIO = 2.0
COHORT_TIMED_CHUNKS = 2   # cut from 3 to fit phase lm_sharded in the script's time
#: rounds of simulated draws timed in the prng phase: the launch counts a
#: round are exact at any length, and the profiled pass over fig-dnn/RTopK
#: costs ~1.6 s a round (50 rounds held the whole script ~80 s longer; cut
#: from 10 to fit phase lm_sharded in the script's time)
PRNG_COST_ROUNDS = 4
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
#: kernel 5 and its backward at a sequence-parallel rank's query offset:
#: the three slices of phase lm_sharded's gemma3-4b cell (B 1, a 3072-token
#: prompt over 3 ranks: 1024 queries against 3072 keys, 8 query / 4 KV
#: heads, hd 256) at q_pos0 0, 1024 and 2048, in its window-1024 layers and
#: its global one: (B, Sq, Sk, H, KVH, hd), then (q_pos0, window) pairs
ATTN_OFFSET_SHAPE = (1, 1024, 3072, 8, 4, 256)
ATTN_OFFSETS = tuple((q0, w) for w in (1024, None) for q0 in (0, 1024, 2048))
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
#: decode steps, and the layers kept (`cut_layers`: None for full depth, a
#: count, or a tuple of the group's layer indices).  The cut cells keep
#: every width and the first layers of the pattern; their weights are the
#: reference's `init_params(PRNGKey(0))` of the cut config: qwen2-vl-72b 2
#: layers (4.25 B parameters), granite-20b, stablelm-12b and codeqwen1.5-7b
#: 4 layers (2.12, 2.14, 1.69 B), against full depths' bf16 weights of 145,
#: 41, 24 and 16 GB; llama4-maverick one group (a MoE layer of 128 experts
#: and a dense one: 18.68 B, 37.4 GB); jamba-1.5-large the first five layers
#: of its group of 8 (Mamba2 + MLP, Mamba2 + MoE, twice, then attention +
#: MLP: 23.99 B, 48.0 GB; the whole group is 90.3 GB).  The keyed inits run
#: through kernel 7.  The new cells' 4 decode steps keep the whole script's
#: time down: with 8 steps it ran 823 s (PERF.md §6); gemma3-4b and
#: mamba2-370m decode 16 (32 until cut to fit phase lm_sharded in the
#: script's time)
SERVE_CELLS = (("gemma3_4b", "decode_4k_b4", 16, None),
               ("mamba2_370m", "decode_4k_b8", 16, None),
               ("deepseek_moe_16b", "decode_4k_b4", 4, None),
               ("qwen2_vl_72b", "decode_4k_b4", 4, 2),
               ("granite_20b", "decode_4k_b4", 4, 4),
               ("stablelm_12b", "decode_4k_b4", 4, 4),
               ("codeqwen15_7b", "decode_4k_b4", 4, 4),
               ("whisper_small", "decode_4k_b4", 4, None),
               ("llama4_maverick_400b_a17b", "decode_4k_b4", 4, 2),
               ("jamba_15_large_398b", "decode_4k_b4", 4, 5))
#: configs held by their reduced check alone: none since every config has a
#: full-width cell
REDUCED_ONLY = ()
#: the reduced configs of the card-against-CPU check, all ten: where the
#: full width groups its KV heads the reduced config (4 query heads) keeps
#: 2 KV heads, and stablelm its head size of 160
SERVE_REDUCED = {"gemma3_4b": {"n_kv_heads": 2}, "mamba2_370m": {},
                 "deepseek_moe_16b": {}, "granite_20b": {},
                 "llama4_maverick_400b_a17b": {"n_kv_heads": 2}, "whisper_small": {},
                 "codeqwen15_7b": {}, "qwen2_vl_72b": {"n_kv_heads": 2},
                 "stablelm_12b": {"n_kv_heads": 2, "head_dim": 160},
                 "jamba_15_large_398b": {"n_kv_heads": 2}}
#: kernel 5 at the other configs' full-width prefill shapes (decode_4k_b4:
#: 4 × 2048 tokens; qwen2-vl's 256 prefix embeddings in front) and at the
#: train cells' train_4k_b1 shapes of granite, stablelm, codeqwen and jamba
#: (1 × 4096), bfloat16: (name, B, Sq, Sk, H, KVH, hd, causal)
ATTN_CONFIG_SHAPES = (("granite-20b", 4, 2048, 2048, 48, 1, 128, True),
                      ("stablelm-12b", 4, 2048, 2048, 32, 8, 160, True),
                      ("codeqwen1.5-7b", 4, 2048, 2048, 32, 32, 128, True),
                      ("deepseek-moe-16b", 4, 2048, 2048, 16, 16, 128, True),
                      ("llama4-maverick", 4, 2048, 2048, 40, 8, 128, True),
                      ("qwen2-vl-72b", 4, 2304, 2304, 64, 8, 128, True),
                      ("whisper decoder", 4, 2048, 2048, 12, 12, 64, True),
                      ("whisper encoder", 4, 1500, 1500, 12, 12, 64, False),
                      ("whisper cross", 4, 2048, 1500, 12, 12, 64, False),
                      ("whisper cross, decode", 4, 1, 1500, 12, 12, 64, False),
                      ("granite-20b train", 1, 4096, 4096, 48, 1, 128, True),
                      ("stablelm-12b train", 1, 4096, 4096, 32, 8, 160, True),
                      ("codeqwen1.5-7b train", 1, 4096, 4096, 32, 32, 128, True),
                      ("jamba-1.5-large train", 1, 4096, 4096, 64, 8, 128, True))
#: kernel 6 at jamba-1.5-large's full width: (name, B, S, H, hd, N, A and
#: dt as its init draws them): random decays, and the init's (A = −(1..256)
#: from `A_log`, dt a softplus; `ssd_kernel_phase`), which also reads the
#: float64 truth
SSD_CONFIG_SHAPES = (("jamba-1.5-large", 4, 2048, 256, 64, 128, False),
                     ("jamba-1.5-large, its init's decays", 4, 2048, 256, 64, 128, True))
#: the backward kernels against float64 autograd through the plain versions,
#: share of max|f64| (PERF.md §2); bf16 adds one bf16 ulp of the f64 value
BWD_TOL = 1e-4
#: the training attention of the train cells: (name, B, Sq, Sk, H, KVH, hd,
#: causal, window): gemma3-4b's global and window-1024 layers at
#: train_4k_b1, deepseek-moe-16b's (MHA, hd 128) and qwen2-vl-72b's (GQA
#: rep 8 over 256 prefix + 4096 tokens) at train_4k_b1, whisper-small's
#: non-causal encoder over 1500 frames, its decoder's self-attention and its
#: cross-attention of 4096 queries against 1500 keys at train_4k_b8;
#: granite-20b's 48 query heads on one KV head, stablelm-12b's head size
#: 160 (on the 256 template), codeqwen1.5-7b's MHA and jamba-1.5-large's
#: rep 8 at train_4k_b1
ATTN_BWD_PATH = (("global", 1, 4096, 4096, 8, 4, 256, True, None),
                 ("window1024", 1, 4096, 4096, 8, 4, 256, True, 1024),
                 ("deepseek-moe-16b", 1, 4096, 4096, 16, 16, 128, True, None),
                 ("qwen2-vl-72b", 1, 4352, 4352, 64, 8, 128, True, None),
                 ("whisper encoder", 8, 1500, 1500, 12, 12, 64, False, None),
                 ("whisper decoder", 8, 4096, 4096, 12, 12, 64, True, None),
                 ("whisper cross", 8, 4096, 1500, 12, 12, 64, False, None),
                 ("granite-20b", 1, 4096, 4096, 48, 1, 128, True, None),
                 ("stablelm-12b", 1, 4096, 4096, 32, 8, 160, True, None),
                 ("codeqwen1.5-7b", 1, 4096, 4096, 32, 32, 128, True, None),
                 ("jamba-1.5-large", 1, 4096, 4096, 64, 8, 128, True, None))
#: float64 truths of the path cases are taken this many float64 score
#: elements at a time (a batch entry and a few KV heads' query heads, or
#: some of one KV head's query heads: granite's 48), so whisper's 8 × 12 ×
#: 4096² scores never stand whole in float64
BWD_TRUTH_ELEMS = 1 << 27
#: edge cases: (name, B, Sq, Sk, H, KVH, hd, causal, window)
ATTN_BWD_SWEEP = (("GQA rep 2, hd 64", 2, 128, 128, 4, 2, 64, True, None),
                  ("window 64, hd 256", 1, 256, 256, 8, 4, 256, True, 64),
                  ("Sq != Sk, non-causal", 2, 100, 260, 4, 2, 128, False, None),
                  ("rows that see no key", 1, 90, 40, 2, 1, 64, False, 8),
                  ("S 333 ragged, window 100", 1, 333, 333, 8, 4, 256, True, 100),
                  ("S 77 ragged, hd 32", 3, 77, 77, 2, 2, 32, True, None),
                  ("hd 80, padded to 128", 2, 64, 64, 2, 1, 80, True, None),
                  ("GQA rep 8", 1, 128, 128, 8, 1, 64, True, 24))
#: mamba2-370m's training SSD at train_4k_b8: (B, S, H, hd, N), 32 of
#: kernel 6's 128-position chunks
SSD_BWD_PATH = (8, 4096, 32, 64, 128)
#: jamba-1.5-large's training SSD at train_4k_b1: the same B·H·S as
#: mamba2's, 256 heads of one batch entry, its init's decays
SSD_BWD_JAMBA = (1, 4096, 256, 64, 128)
#: edge cases: (name, B, S, H, hd, N, with the final state's gradient,
#: dt scale, A scale, dt's least value), dt uniform in [least, least +
#: scale] and A in −scale·[0.1, 1.1]; None for the scales draws A and dt as
#: mamba2-370m's init makes them (`ssd_bwd_phase`).  "strong decays" reach
#: exp(−8) a step; "mixed decays" reach exp(−550) beside exp(−0.05), so
#: a chunk's cumulative decay runs to −10⁴ while neighbours differ by
#: −0.05 (kernel 6b's ddt read 2e-4 of max|f64| off here while it summed
#: that decay in float32)
SSD_BWD_SWEEP = (("two chunks, state gradient", 2, 256, 3, 64, 128, True, 0.5, 1.0, 0.01),
                 ("S 200 ragged, N 16", 1, 200, 2, 32, 16, True, 0.5, 1.0, 0.01),
                 ("head size 5, state size 3", 2, 150, 3, 5, 3, False, 0.5, 1.0, 0.01),
                 ("hd 128, N 64", 1, 384, 4, 128, 64, True, 0.5, 1.0, 0.01),
                 ("strong decays", 2, 300, 2, 64, 128, True, 0.7, 10.0, 0.01),
                 ("mixed decays", 2, 300, 2, 64, 128, False, 10.0, 50.0, 0.01),
                 ("mamba2 init, 3 chunks ragged, state gradient", 2, 300, 32, 64, 128, True,
                  None, None, None))
#: the train phase: the reduced configs held card against CPU (all ten:
#: llama4-maverick's MoE trains on the card here only), then the full-width
#: cells (arch, one-card shape, the layers kept as `cut_layers` takes them,
#: whether the cell runs again through the plain versions), steps; the
#: reduced check's steps and its (batch, tokens).  bf16 weights, gradients
#: and two AdamW moments take 8 B a parameter, so the deep configs are cut
#: in depth only, each to the deepest that keeps the peak under ~70 GB:
#: deepseek-moe-16b to 12 of its 28 layers (0.588 B a layer plus 0.42 B of
#: embedding and head: 7.47 B, peak 65.2 GB on the card, so 13 layers would
#: read ~69.9 GB), qwen2-vl-72b to 6 of its 80 (0.878 B a layer plus 2.49
#: B: 7.76 B; 5 layers peaked at 57.1 GB, so 6 read ~64 GB and 7 ~71 GB;
#: PERF.md §6); granite-20b to 18 of 52 (7.43 B), stablelm-12b to 22 of 40
#: (7.14 B), codeqwen1.5-7b to 28 of 32 (7.26 B; its full depth's 8.19 B
#: read ~66 GB before activations); jamba-1.5-large to layers 0 and 4 of
#: its group (Mamba2 + MLP, attention + MLP: 2.84 B; one MoE layer is 9.7
#: B, 78 GB at 8 B a parameter); whisper-small (279 M) runs whole at 8 ×
#: 4096 tokens (21.4 GB).  llama4-maverick has no full-width cell: one MoE
#: layer with the embedding and head is 18.37 B, ~147 GB
TRAIN_REDUCED = ("gemma3_4b", "mamba2_370m", "deepseek_moe_16b", "whisper_small",
                 "qwen2_vl_72b", "granite_20b", "stablelm_12b", "codeqwen15_7b",
                 "llama4_maverick_400b_a17b", "jamba_15_large_398b")
TRAIN_CELLS = (("gemma3_4b", "train_4k_b1", None, True),
               ("mamba2_370m", "train_4k_b8", None, True),
               ("deepseek_moe_16b", "train_4k_b1", 12, False),
               ("whisper_small", "train_4k_b8", None, False),
               ("qwen2_vl_72b", "train_4k_b1", 6, False),
               ("granite_20b", "train_4k_b1", 18, True),
               ("stablelm_12b", "train_4k_b1", 22, False),
               ("codeqwen15_7b", "train_4k_b1", 28, False),
               ("jamba_15_large_398b", "train_4k_b1", (0, 4), True))
#: the MoE cell whose step-0 gradient runs twice from the same weights and
#: must give the same bits (the MoE's backward sums in a fixed order)
TRAIN_RERUN = "deepseek_moe_16b"
TRAIN_STEPS = 2       # cut from 4 to fit phase lm_sharded in the script's time
TRAIN_REDUCED_STEPS, TRAIN_REDUCED_SIZES = 2, (4, 64)   # steps cut from 3, as TRAIN_STEPS
TRAIN_TOL = 2e-4
#: the bfloat16 witness (PERF.md §2): gemma3-4b at full width cut to one
#: period of its layer pattern (5 window-1024 layers, then a global one),
#: one gradient on one train_4k_b1 batch; a leaf's (and the loss's)
#: relative distance from the float32 plain versions may be at most
#: WITNESS_FACTOR times the bf16 plain versions', or WITNESS_FLOOR (one
#: bf16 ulp, 2⁻⁸, relative; storing a gradient in bf16 alone costs half
#: that); the full-depth cells' losses through the plain versions within
#: WITNESS_LOSS_TOL of the kernels' (step 0, the later steps)
WITNESS_LAYERS = 6
WITNESS_FACTOR, WITNESS_FLOOR = 2.0, 2.0 ** -8
WITNESS_LOSS_TOL = (1e-2, 5e-2)


#: the sharded phase (the client-sharded reducer, its ranks sharing the one
#: card through gloo): the world sizes, the cells held at W = 4 (exact and
#: exact=False), fig1-xl's rounds at W = 2 (each exact round gathers its
#: (512, 1200, 1200) float64 stack to both ranks), the serve case written at
#: W = 4 up to a round and resumed on one rank, each spawn's time limit
SHARDED_W, SHARDED_XL_W = 4, 2
SHARDED_CELLS = (("fig1r1", "BL1"), ("fig4", "BL2_tau_half"), ("fig4", "BL3_tau_half"),
                 ("fig1-bag", "BAG_q0.5"), ("fig-dnn", "BLDNN"))
SHARDED_XL_STEPS = 1  # cut from 2 to fit phase lm_sharded in the script's time
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
    randint int32 and int64, uniform float32 and float64 and normal float32
    over shapes of 5 and 6 (odd and even counter counts) and normal over
    (3, 7), and choice of 1 and 5 of 60 without replacement — as nested
    lists."""
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
            out[f"normal_f32/{tag}"] = r.normal(key, (n,))
        out[f"normal_f32x2/{seed}"] = r.normal(key, (3, 7))
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

    def normal(self, key, shape):
        return self.prng.normal(key, shape, device=self.device)

    def choice(self, key, n, shape, replace):
        return self.prng.choice(key, n, shape, replace, device=self.device)

    def tolist(self, x):
        if x.device.type != self.torch.device(self.device).type:
            raise AssertionError(f"a draw landed on {x.device}, not {self.device}")
        return x.cpu().tolist()


_T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line carries the script's wall seconds so
    far (`wall_s`)."""
    if "phase" in obj:
        obj = {**obj, "wall_s": time.perf_counter() - _T0}
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


#: the entry points of item 20 at the reference's benchmark lanes' shapes:
#: ``ktopk``'s (256, 256) k = 512, one 1200² row (the threshold's
#: `threshold_global` template) with k = 14,400, ``kmatmul``'s 512², and
#: kernel 4 at fig-dnn's first leaf
ENTRY_TOPK = (((256, 256), 512, "ktopk"), ((1, 1200 * 1200), 14400, "global_1200sq"))
ENTRY_MATMUL = (512, 512, 512)
ENTRY_ROTATION = (8, 96, 96, 32, 32)


def entry_points_phase(torch, k) -> dict:
    """The four entry points of ROADMAP item 20 on the card: kernel 1's
    `topk_threshold` and `ops.topk_compress` bitwise against their plain
    twin (dense, threshold, kept), `ops.matmul` within MM_TOL of its plain
    version in float32 and bfloat16 out, `ops.basis_transform` within
    kernel 4's 1e-5·max|plain|; each timed beside its plain version, its
    bound and the library call (`torch.topk` of the flattened |x|,
    `torch.matmul`), with the kernel launches one call makes."""
    from repro_torch.kernels import ops

    gen = torch.Generator(device="cuda").manual_seed(27)
    out = {}
    for shape, kk, tag in ENTRY_TOPK:
        x = torch.randn(shape, device="cuda", generator=gen)
        for name, fn in (("topk_threshold", lambda: k.tk.topk_threshold(x, kk)),
                         ("topk_compress", lambda: ops.topk_compress(x, kk))):
            got, secs, counts = drive(torch, k, fn)
            plain = k.tk.topk_threshold_plain(x, kk)
            want = plain if name == "topk_threshold" else (plain[0], plain[2])
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError(f"{name} {tag}: the kernel route differs from its plain "
                                     f"twin")
            err = max(float((torch.as_tensor(a).double() - torch.as_tensor(b).double())
                            .abs().max()) for a, b in zip(got, want))
            if counts["topk_row_threshold"] != 1 or int(got[-1]) != min(kk, x.numel()):
                raise AssertionError(f"{name} {tag}: launches {counts}, kept {int(got[-1])}")
            bytes_ms = 2 * x.numel() * 4 / HBM_BYTES_PER_S * 1e3   # read x, write dense
            out[f"{name}/{tag}"] = {
                "shape": list(shape), "k": kk, "launches_per_call": counts["topk_row_threshold"],
                "max_abs_err": err, "kernel_ms": cuda_ms(torch, fn, 20),
                "plain_ms": cuda_ms(torch, lambda: k.tk.topk_threshold_plain(x, kk), 5, 1),
                "library_ms": cuda_ms(torch, lambda: torch.topk(x.abs().flatten(), kk), 20),
                "bound_ms": bytes_ms, "bound_by": "bytes"}
    M, K, N = ENTRY_MATMUL
    a = torch.randn(M, K, device="cuda", generator=gen)
    b = torch.randn(K, N, device="cuda", generator=gen)
    for dt in (torch.float32, torch.bfloat16):
        fn = lambda dt=dt: ops.matmul(a, b, out_dtype=dt)         # noqa: E731
        got, _, counts = drive(torch, k, fn)
        want = k.tm.matmul_plain(a, b, out_dtype=dt)
        err = float((got.float() - want.float()).abs().max())
        scale = float(want.float().abs().max())
        tol = MM_TOL if dt == torch.float32 else 2.0 ** -8       # one bfloat16 rounding
        if got.dtype != dt or counts["tiled_matmul"] != 1 or not err <= tol * scale:
            raise AssertionError(f"ops.matmul {M}x{K}x{N} -> {dt}: |Δ| {err} vs {tol}·{scale}, "
                                 f"launches {counts}")
        bound, by = matmul_bound_ms(a, b)
        out[f"matmul/{M}x{K}x{N}/{str(dt).replace('torch.', '')}"] = {
            "launches_per_call": counts["tiled_matmul"], "max_abs_err": err,
            "kernel_ms": cuda_ms(torch, fn, 50),
            "plain_ms": cuda_ms(torch, lambda dt=dt: k.tm.matmul_plain(a, b, out_dtype=dt), 50),
            "library_ms": cuda_ms(torch, lambda: torch.matmul(a, b), 50),
            "bound_ms": bound, "bound_by": by}
    n, da, d1, d2, db = ENTRY_ROTATION
    A = torch.linalg.qr(torch.randn(da, d1, device="cuda", generator=gen))[0].contiguous()
    B = torch.linalg.qr(torch.randn(d2, db, device="cuda", generator=gen))[0].contiguous()
    g = torch.randn(n, d1, d2, device="cuda", generator=gen)
    fn = lambda: ops.basis_transform(A, g, B)                     # noqa: E731
    got, _, counts = drive(torch, k, fn)
    want = k.bt.basis_transform_plain(A, g, B)
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    if counts["basis_transform"] != 1 or not err <= 1e-5 * scale:
        raise AssertionError(f"ops.basis_transform: |Δ| {err} vs 1e-5·{scale}, {counts}")
    bound, by = basis_transform_bound_tc_ms(n, da, d1, d2, db)
    out["basis_transform/" + "x".join(map(str, ENTRY_ROTATION))] = {
        "launches_per_call": counts["basis_transform"], "max_abs_err": err,
        "kernel_ms": cuda_ms(torch, fn, 50),
        "plain_ms": cuda_ms(torch, lambda: k.bt.basis_transform_plain(A, g, B), 50),
        "library_ms": cuda_ms(torch, lambda: torch.matmul(torch.matmul(A, g), B), 50),
        "bound_ms": bound, "bound_by": by}
    return out


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
                             *STOCHASTIC_THRESHOLD_SHAPES, *COHORT_THRESHOLD_SHAPES,
                             *SHARDED_THRESHOLD_SHAPES):
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
        if profile or path in {tag for *_, tag in (*COHORT_THRESHOLD_SHAPES,
                                                    *SHARDED_THRESHOLD_SHAPES)}:
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


#: kernel 7's bits-path launches of each card-vs-CPU case of phase prng:
#: one a hash the card makes (a single CPU key's splits of a few pairs hash
#: on the host; `permutation` of 5000 is two rounds of `random_bits`, of 60
#: one, each round's `split` of the card's keys one more)
PRNG_CASE_LAUNCHES = {"split_512": 1, "bernoulli_f64_512": 1, "dither_levels_10x24": 2,
                      "randk_choice_10x60": 3, "permutation_5000": 2, "randint_i64_7": 2}
#: the bits path timed at the rounds' shapes: fig-dnn's (8, 3072) dithering
#: levels (float32 p), bl2-xl's (512,) participation (float64), and the
#: split of its round key into 512 client keys
BITS_TIMED = (("bernoulli_f32_8x3072", "bool32", 8, 3072),
              ("bernoulli_f64_512", "bool64", 1, 512), ("split_512", "split", 1, 512))


@contextlib.contextmanager
def eager_card_hash(prng):
    """Within the block, `prng` hashes on the card eagerly (`_threefry`'s
    tensor ops, the bits path's plain version) instead of through kernel 7."""
    saved = prng._on_card
    prng._on_card = lambda key, device: None
    try:
        yield
    finally:
        prng._on_card = saved


@contextlib.contextmanager
def no_eager_card_hash(prng):
    """Within the block, `prng._threefry` on a CUDA tensor raises: every
    hash on the card must go through kernel 7."""
    import torch

    saved = prng._threefry

    def guarded(*words):
        if any(isinstance(w, torch.Tensor) and w.is_cuda for w in words):
            raise AssertionError("prng hashed eagerly on the card (no kernel-7 launch)")
        return saved(*words)

    prng._threefry = guarded
    try:
        yield
    finally:
        prng._threefry = saved


def threefry_bits_bound_ms(pairs: int, elements: int, in_bytes: int, out_bytes: int) -> tuple:
    """Least time for one bits-path hash: its pairs' integer operations
    (`TN_HASH_OPS_PER_PAIR`) at the integer rate and ~4 float operations an
    element (the uniform, a range or a compare) at the float32 rate, or its
    bytes (keys, p and data read once, the output written once)."""
    ops_ms = max(pairs * TN_HASH_OPS_PER_PAIR / INT32_OPS_PER_S,
                 elements * 4 / OPS32_PER_S) * 1e3
    bytes_ms = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def _host_lists(x):
    """Tensors nested in tuples and lists, as nested Python lists."""
    if isinstance(x, (tuple, list)):
        return [_host_lists(v) for v in x]
    return x.cpu().tolist()


def bits_timing_phase(torch, prng, tn) -> dict:
    """Kernel 7's bits path at the rounds' shapes (`BITS_TIMED`), in the
    original layout: through its wrapper, its device time, its plain version
    (the eager hash) on the card, bitwise equal, and its bound."""
    out = {}
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, kind, rows, size in BITS_TIMED:
        keys = prng.split(prng.PRNGKey(0), rows, device="cuda")
        bp = tn.bits_plan(kind, size, False)
        shape = (rows, size, 2) if kind == "split" else (rows, size)
        dt = torch.float32 if kind == "bool32" else torch.float64
        p = torch.rand((rows, size), generator=gen, device="cuda", dtype=dt) \
            if kind == "bool32" else 0.5
        card = torch.empty(shape, dtype=bp.dtype, device="cuda")
        plain = torch.empty_like(card)

        def kernel():
            return tn.threefry_bits(card, keys, bp, p=p)

        kernel()
        tn.threefry_bits_plain(plain, keys, bp, p=p)
        if not torch.equal(card, plain):
            raise AssertionError(f"bits path {name}: kernel != plain version on the card")
        in_bytes = rows * 16 + (p.numel() * p.element_size() if isinstance(p, torch.Tensor)
                                else 0)
        bound, by = threefry_bits_bound_ms(rows * bp.pairs, rows * bp.width, in_bytes,
                                           card.numel() * card.element_size())
        ms = cuda_ms(torch, kernel, 200)
        dev = device_ms(torch, {"kernel": kernel}, reps=20)["kernel"]
        out[name] = {"shape": list(shape), "pairs": rows * bp.pairs, "kernel_ms": ms,
                     "device_ms": sum(dev.values()) if dev else None,
                     "plain_ms": cuda_ms(torch, lambda: tn.threefry_bits_plain(
                         plain, keys, bp, p=p), 20),
                     "bound_ms": bound, "bound_by": by, "library_ms": None}
    return out


def prng_phase(torch, prng, rounds, tn, device: str = "cuda",
               eager_init: bool = False) -> dict:
    """The port's threefry draws on the card: the committed table of
    jax.random draws (both settings) drawn on the card and on the CPU, equal
    to it entry for entry, every card hash through kernel 7 (`prng._threefry`
    refuses a CUDA tensor meanwhile); draws at the path's shapes (a
    512-client split and participation mask, the dithering's float32 level
    draws, Rand-K's choice, a 5000-long permutation) on the card bitwise
    equal to the CPU's, each with exactly its `PRNG_CASE_LAUNCHES` of the
    bits path; `normal` at every draw shape of the path (`normal_phase`);
    then the host time, device time and CUDA launches a round's draws cost,
    replayed without the round's arithmetic, for bl2-xl, fig3/RTopK and
    fig-dnn/RTopK, through the bits path and through the eager hash (the
    route before it); the bits path timed at the rounds' shapes
    (`bits_timing_phase`); then kernel 7's normal path
    (`threefry_normal_phase`)."""
    seconds = {}
    t_part = time.perf_counter()
    table = json.loads(PRNG_TABLE.read_text())
    with no_eager_card_hash(prng):
        tn.bits_launches = 0
        got = prng_table(PortRandom(torch, prng, device))
        table_launches = tn.bits_launches
    for where, draws_got in ((device, got), ("cpu", prng_table(PortRandom(torch, prng, "cpu")))):
        for flag, draws in table.items():
            bad = [k for k in draws if draws_got[flag][k] != draws[k]]
            if bad:
                raise AssertionError(f"prng on {where}, {flag}: draws {bad} differ from jax's")
    if not table_launches:
        raise AssertionError("prng: the table's card draws made no bits-path launch")
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
                with no_eager_card_hash(prng):
                    tn.bits_launches = tn.launches = 0
                    card = fn(device)
                    launched = (tn.bits_launches, tn.launches)
                host = fn("cpu")
                if card.device.type != device or not torch.equal(card.cpu(), host):
                    raise AssertionError(f"prng {name} (partitionable={flag}): card != CPU")
                if launched != (PRNG_CASE_LAUNCHES[name], 0):
                    raise AssertionError(f"prng {name} (partitionable={flag}): kernel-7 "
                                         f"launches (bits, normal) {launched}, want "
                                         f"({PRNG_CASE_LAUNCHES[name]}, 0)")

    seconds["table_and_cases"] = time.perf_counter() - t_part
    t_part = time.perf_counter()
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
    for name, fn, per_round in (("bl2-xl", bl2_xl, 1), ("fig3/RTopK", fig3_rtopk, 3),
                                ("fig-dnn/RTopK", fig_dnn_rtopk, 16)):
        def run(fn=fn):
            for t in range(PRNG_COST_ROUNDS):
                fn(t)

        row = {}
        for route in ("bits", "eager"):
            ctx = eager_card_hash(prng) if route == "eager" else no_eager_card_hash(prng)
            with ctx:
                run()
                torch.cuda.synchronize()
                tn.bits_launches = 0
                t0 = time.perf_counter()
                run()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
                launched = tn.bits_launches
                prof = profile_run(torch, run, PRNG_COST_ROUNDS)
            want = per_round * PRNG_COST_ROUNDS if route == "bits" else 0
            if launched != want:
                raise AssertionError(f"prng draw cost {name} ({route}): {launched} bits-path "
                                     f"launches, want {want}")
            row[route] = {"host_ms_per_round": wall / PRNG_COST_ROUNDS * 1e3,
                          "cuda_launches_per_round": prof["cuda_launches_per_step"],
                          "device_ms_per_round": prof["device_busy_ms"] / PRNG_COST_ROUNDS,
                          "bits_launches_per_round": launched / PRNG_COST_ROUNDS}
        with no_eager_card_hash(prng):
            card = [fn(t) for t in range(PRNG_COST_ROUNDS)]
        with eager_card_hash(prng):
            eager = [fn(t) for t in range(PRNG_COST_ROUNDS)]
        if _host_lists(card) != _host_lists(eager):
            raise AssertionError(f"prng draw cost {name}: the bits path's draws differ from "
                                 "the eager hash's")
        cost[name] = {**row["bits"], "eager": row["eager"]}
    seconds["draw_cost"] = time.perf_counter() - t_part
    out = {"table_entries": sum(len(v) for v in table.values()),
           "table_bits_launches": table_launches,
           "card_vs_cpu_cases": {name: PRNG_CASE_LAUNCHES[name] for name in cases},
           "draw_cost": cost}
    for key, part in (("bits_timings", lambda: bits_timing_phase(torch, prng, tn)),
                      ("normal", lambda: normal_phase(torch, prng, tn)),
                      ("normal_past_a_block", lambda: blocked_normal_windows(torch, prng, tn)),
                      ("threefry_normal", lambda: threefry_normal_phase(torch, prng, tn,
                                                                        eager_init))):
        t_part = time.perf_counter()
        out[key] = part()
        seconds[key] = time.perf_counter() - t_part
    return {**out, "seconds": seconds}


#: normal draws held card = CPU over the whole leaf up to this many draws;
#: a larger leaf is drawn whole on the card (in chunks) and held in windows
#: (whole leaves to 2²¹ draws and windows of 2¹⁶ until cut to fit phase
#: lm_sharded in the script's time: the CPU's draws took ~25 s)
NORMAL_WHOLE = 1 << 18
#: the windows' length (start, across the half ⌈n/2⌉ where the original
#: layout's pairs split, end)
NORMAL_WINDOW = 1 << 14


#: leaves `init_params` does not draw (norm scales, the Mamba2 block's
#: A_log, D and dt_bias)
UNDRAWN_LEAVES = ("scale", "A_log", "D", "dt_bias")


def drawn_leaves(tree) -> list:
    """(name, leaf) of each leaf of a parameter tree that `layers._init`
    draws: one kernel-7 launch each on the card."""
    return [(name, leaf) for name, leaf in _leaves(tree)
            if name.rsplit("/", 1)[-1] not in UNDRAWN_LEAVES]


def draw_shape(name: str, leaf) -> tuple:
    """The shape of one `jax.random.normal` draw of a leaf: a stacked leaf
    (the decoder's groups, the encoder's layers) is one draw a row."""
    return tuple(leaf.shape[1:]) if name.startswith(("layers", "encoder")) else tuple(leaf.shape)


def normal_draw_shapes() -> list:
    """The shapes of every `jax.random.normal` draw the main path makes:
    the ten configs' weights at full width (one draw a leaf, a stacked leaf
    one a row) and fig-dnn's four leaves, one shape a draw size (a draw
    depends on its shape only through its size), those past 2³² − 1 draws
    left to `blocked_normal_windows`."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.models import model as M

    shapes = {(96, 32), (32, 64), (64, 32), (32, 4)}
    for arch in configs.ARCH_IDS:
        for name, leaf in drawn_leaves(M.param_shapes(configs.get_config(arch))):
            shapes.add(draw_shape(name, leaf))
    by_size = {}
    for shape in sorted(shapes):
        if math.prod(shape) < prng.M32:
            by_size.setdefault(math.prod(shape), shape)
    return [by_size[n] for n in sorted(by_size)]


def normal_phase(torch, prng, tn) -> dict:
    """`prng.normal` on the card (kernel 7, one launch a piece of
    `prng.NORMAL_CHUNK` draws) against the CPU's eager draw at every draw
    shape of the path, in both threefry settings: whole leaves up to
    NORMAL_WHOLE draws, larger ones (up to qwen2-vl's 1.2 G-draw embedding
    and jamba's 3.2 G-draw expert rows) drawn whole on the card and held to
    the CPU's draw of three windows; bitwise.  Times the card's whole-leaf
    draw."""
    out = {}
    chunk = prng.NORMAL_CHUNK["cuda"]
    for flag in (False, True):
        with prng.threefry_partitionable(flag):
            for shape in normal_draw_shapes():
                n = math.prod(shape)
                key = prng.fold_in(prng.PRNGKey(27), n % (1 << 32))
                card = torch.empty(n, device="cuda")
                torch.cuda.synchronize()
                tn.launches = 0
                t0 = time.perf_counter()
                for start, z in prng.normal_chunks(key, shape, device="cuda"):
                    card[start:start + z.numel()] = z
                torch.cuda.synchronize()
                secs = time.perf_counter() - t0
                if tn.launches != -(-n // chunk):
                    raise AssertionError(f"normal {shape}: {tn.launches} kernel-7 launches, "
                                         f"want one a piece of {chunk}")
                h, w = (n + 1) // 2, NORMAL_WINDOW
                whole = n <= NORMAL_WHOLE
                windows = [(0, n)] if whole else [(0, w), (h - w // 2, h + w // 2), (n - w, n)]
                for lo, hi in windows:
                    host = card[lo:hi].cpu()
                    for start, z in prng.normal_chunks(key, shape, device="cpu",
                                                       chunk=None if whole else w,
                                                       start=lo, stop=hi):
                        a, b = max(start, lo), min(start + z.numel(), hi)
                        got = host[a - lo:b - lo]
                        if not torch.equal(got.view(torch.int32),
                                           z[a - start:b - start].view(torch.int32)):
                            raise AssertionError(f"normal {shape} (partitionable={flag}): "
                                                 f"card != CPU in [{a}, {b})")
                if not bool(torch.isfinite(card).all()):
                    raise AssertionError(f"normal {shape}: a draw is not finite")
                out[f"{'x'.join(map(str, shape))}/partitionable={flag}"] = {
                    "draws": n, "held": "whole" if whole else "3 windows",
                    "card_s": secs, "card_ns_per_draw": secs / n * 1e9,
                    "kernel_launches": -(-n // chunk)}
                del card
    torch.cuda.empty_cache()
    return out


#: kernel 7's work a draw (csrc/threefry_normal.cu): a pair's hash is 72
#: integer operations (20 rounds of add, rotate and xor; 5 key injections of
#: two adds; two first adds), two draws a pair in the original layout and
#: one (plus the xor) in the partitionable; the unit float 2 integer and 1
#: float operation; the scale to (−1, 1) an FMA and a max; then erf_inv: on
#: its log1p's rational branch (|u| < 0.6436) 31 float operations, on its log
#: branch 41 and 4 integer ones, the polynomial 18, and u·p, ·√2, ·scale and
#: the cast 5; an FMA counts 2 operations, every other step 1
TN_HASH_OPS_PER_PAIR = 72
TN_OPS_SMALL, TN_OPS_LOG = 2 + 1 + 3 + 1 + 31 + 1 + 18 + 5, 2 + 1 + 3 + 1 + 41 + 4 + 1 + 18 + 5


#: of those, the integer ones outside the hash: the unit float's shift and
#: or, and the log branch's 4
TN_INT_SMALL, TN_INT_LOG = 2, 2 + 4


def threefry_normal_ops(draws: int, log_share: float, partitionable: bool = False) -> tuple:
    """(integer, float32) operations of `draws` keyed normals, this run's
    share of them on log1p's log branch."""
    hash_ops = TN_HASH_OPS_PER_PAIR + 1 if partitionable else TN_HASH_OPS_PER_PAIR / 2
    ints = hash_ops + (1 - log_share) * TN_INT_SMALL + log_share * TN_INT_LOG
    floats = ((1 - log_share) * (TN_OPS_SMALL - TN_INT_SMALL)
              + log_share * (TN_OPS_LOG - TN_INT_LOG))
    return draws * ints, draws * floats


def threefry_normal_bound_ms(draws: int, log_share: float, out_bytes: int,
                             partitionable: bool = False) -> tuple:
    """Least time for `draws` keyed normals: the integer operations on the
    SMs' INT32 lanes (`INT32_OPS_PER_S`) and the float32 ones at the 32-bit
    float rate, the two pipes running side by side, or the output written
    once, whichever is largest (`threefry_normal_bound_f32_rate_ms`
    charges every operation at the float32 rate)."""
    ints, floats = threefry_normal_ops(draws, log_share, partitionable)
    ops_ms = max(ints / INT32_OPS_PER_S, floats / OPS32_PER_S) * 1e3
    bytes_ms = draws * out_bytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def threefry_normal_bound_f32_rate_ms(draws: int, log_share: float, out_bytes: int) -> float:
    """The bound with every operation, integer ones too, at the float32
    rate (`OPS32_PER_S`)."""
    ints, floats = threefry_normal_ops(draws, log_share)
    return max((ints + floats) / OPS32_PER_S, draws * out_bytes / HBM_BYTES_PER_S) * 1e3


def sass_counts(lib) -> Optional[dict]:
    """Static SASS instructions of each kernel in the library at ``lib``
    (``cuobjdump -sass``), with its funnel shifts (the hash's rotates: 20 a
    hash inlined) and its longest loop (kernel 7's normal kernels: the tile
    loop, whole and clamped tiles' code and erf_inv's tail together).  A
    count a draw needs the instructions that run, which no tool on the card
    reads (no ncu).  None where the toolkit has no cuobjdump."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          timeout=120).stdout
    out, name, code = {}, None, []

    def close():
        if name is None:
            return
        longest = 0
        for i, (addr, op) in enumerate(code):
            m = re.search(r"BRA\s+.*?0x([0-9a-f]+)", op)
            if m and int(m.group(1), 16) <= addr:
                start = next((j for j, (a, _) in enumerate(code) if a == int(m.group(1), 16)), i)
                longest = max(longest, i - start + 1)
        out[name] = {"instructions": len(code), "longest_loop": longest,
                     "funnel_shifts": sum(1 for _, op in code if op.startswith("SHF.L.W"))}

    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            close()
            name, code = m.group(1), []
            continue
        m = re.match(r"\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and name is not None:
            code.append((int(m.group(1), 16), re.sub(r"^@!?U?P[T0-6]\s+", "", m.group(2).strip())))
    close()
    return out


#: kernel 7 timed at gemma3-4b's embedding leaf (262,144 × 2560 draws,
#: scale 0.02, bfloat16), and the full keyed init it is timed in
TN_TIMED_ARCH = "gemma3_4b"


def threefry_normal_phase(torch, prng, tn, eager_init: bool = False) -> dict:
    """Kernel 7 on the init path: the keyed `init_params` of the ten reduced
    configs on the card bitwise the CPU's (bfloat16 and float32, exactly one
    launch a drawn leaf); at gemma3-4b's embedding leaf the kernel against
    its plain version on the card (the eager draw; bitwise), timed beside it,
    its bound and `torch.randn`'s fill of the same leaf (no PyTorch call
    draws jax's stream: a note, not a yardstick); then gemma3-4b's full
    keyed init through the kernel, twice, timed, with the kernel's launches
    (one a drawn leaf), and with `eager_init` (``--profile``) once more
    through the eager route (~16 s), bitwise equal, timed."""
    from repro_torch import configs
    from repro_torch.kernels import _build
    from repro_torch.models import layers as L
    from repro_torch.models import model as M

    reduced = {}
    for arch in configs.ARCH_IDS:
        cfg, cpu = reduced_cpu_params(arch)
        for dt in (torch.bfloat16, torch.float32):
            tn.launches = 0
            card = M.init_params(prng.PRNGKey(0), cfg, dt, device="cuda")
            launched = tn.launches
            # a bfloat16 leaf is the float32 one rounded once: (z·s).astype
            for (name, a), (_, b) in zip(_leaves(card), _leaves(cpu)):
                if not torch.equal(a.cpu(), b.to(a.dtype)):
                    raise AssertionError(f"{arch} reduced init ({dt}): {name} card != CPU")
            want = len(drawn_leaves(cpu))
            if launched != want:
                raise AssertionError(f"{arch} reduced init: {launched} kernel-7 launches, "
                                     f"want one a drawn leaf ({want})")
            reduced[f"{arch}/{str(dt)[6:]}"] = {"leaves": want, "launches": launched}

    cfg = configs.get_config(TN_TIMED_ARCH)
    V, D = cfg.padded_vocab, cfg.d_model
    n = V * D
    key = prng.split(prng.PRNGKey(0), 6)[0][None]
    s = float(torch.tensor(0.02, dtype=torch.float32))
    out = torch.empty((1, n), dtype=torch.bfloat16, device="cuda")
    plain = torch.empty_like(out)

    def kernel():
        return tn.threefry_normal(out, key, n, scale=s)

    plain_ms = cuda_ms(torch, lambda: tn.threefry_normal_plain(plain, key, n, scale=s), 1,
                       warmup=0)
    kernel()
    if not torch.equal(out.view(torch.int16), plain.view(torch.int16)):
        bad = int((out.view(torch.int16) != plain.view(torch.int16)).sum())
        raise AssertionError(f"kernel 7 at {TN_TIMED_ARCH}'s embedding ({V} x {D}): {bad} "
                             f"draws differ from the plain version on the card")
    # the log branch: |u| ≥ √(√2 − 1), XLA's log1p switch, i.e. |z| ≥ √2·erf_inv of it
    z_log = math.sqrt(2.0) * float(torch.erfinv(torch.tensor(math.sqrt(math.sqrt(2.0) - 1.0),
                                                             dtype=torch.float64)))
    log_share = float((out.float().abs() >= z_log * s).double().mean())
    bound, by = threefry_normal_bound_ms(n, log_share, 2)
    kernel_ms = cuda_ms(torch, kernel, 5, warmup=1)
    randn_ms = cuda_ms(torch, lambda: plain.normal_(), 5, warmup=1)
    ints, floats = threefry_normal_ops(n, log_share)
    leaf = {"shape": [V, D], "draws": n, "dtype": "bfloat16", "kernel_ms": kernel_ms,
            "ns_per_draw": kernel_ms / n * 1e6, "plain_ms": plain_ms,
            "plain_ns_per_draw": plain_ms / n * 1e6, "bound_ms": bound, "bound_by": by,
            "share": bound / kernel_ms, "log_branch_share": log_share,
            "bound_f32_rate_ms": threefry_normal_bound_f32_rate_ms(n, log_share, 2),
            "int_ops_per_draw": ints / n, "float_ops_per_draw": floats / n,
            "torch_randn_fill_ms": randn_ms,
            "device_ms": device_ms(torch, {"kernel": kernel}, reps=3)["kernel"],
            "sass": sass_counts(_build.library_path("threefry_normal"))}
    del out, plain
    torch.cuda.empty_cache()

    # the full keyed init, through the kernel (twice) and through the eager route
    nleaves = len(drawn_leaves(M.param_shapes(cfg)))
    draws = sum(x.numel() for _, x in drawn_leaves(M.param_shapes(cfg)))

    def init(route):
        saved = L.threefry_normal
        if route == "eager":
            L.threefry_normal = tn.threefry_normal_plain
        try:
            torch.cuda.synchronize()
            tn.launches = 0
            t0 = time.perf_counter()
            params = M.init_params(prng.PRNGKey(0), cfg, torch.bfloat16, device="cuda")
            torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        finally:
            L.threefry_normal = saved
        want = nleaves if route == "kernel" else 0
        if tn.launches != want:
            raise AssertionError(f"{TN_TIMED_ARCH} init ({route}): {tn.launches} kernel-7 "
                                 f"launches, want {want}")
        return params, secs

    first, kernel_s = init("kernel")
    eager_s = None
    if eager_init:
        eager, eager_s = init("eager")
        if not all(torch.equal(a, b) for (_, a), (_, b) in zip(_leaves(first),
                                                                _leaves(eager))):
            raise AssertionError(f"{TN_TIMED_ARCH} init: the kernel's weights differ from "
                                 f"the eager route's")
        del eager
    del first
    torch.cuda.empty_cache()
    again, kernel_s2 = init("kernel")
    del again
    torch.cuda.empty_cache()
    init_s = min(kernel_s, kernel_s2)
    return {"reduced_init_card_eq_cpu": reduced, "embedding": leaf, "init": {
        "config": cfg.name, "dtype": "bfloat16", "draws": draws, "launches": nleaves,
        "kernel_s": [kernel_s, kernel_s2], "eager_s": eager_s,
        "ns_per_draw": init_s / draws * 1e9,
        "eager_ns_per_draw": None if eager_s is None else eager_s / draws * 1e9,
        "bound_ms": threefry_normal_bound_ms(draws, log_share, 2)[0]}}


#: llama4-maverick's (128, 5120, 8192) expert leaves: 5.4 G draws a group,
#: past uint32's count of words, so jax draws them in blocks of 2³² − 1
BLOCKED_DRAW_SHAPE = (128, 5120, 8192)


def blocked_normal_windows(torch, prng, tn) -> dict:
    """`prng.normal` past 2³² − 1 draws (the original layout splits the key
    into blocks, `prng._bits32_chunks`) on the card against the CPU,
    bitwise, in windows at the leaf's start, across the first block's end
    and at its end: the card draws each window in one kernel-7 launch (the
    block keys computed on the host), the CPU only the pieces that hold
    it; then the whole leaf in one launch (5.4 G bfloat16 draws, as
    llama4-maverick's init writes a group's expert leaf), its windows held
    the same way."""
    n = math.prod(BLOCKED_DRAW_SHAPE)
    w, block = NORMAL_WINDOW, prng.M32
    key = prng.fold_in(prng.PRNGKey(28), 1)
    windows = ((0, w), (block - w // 2, block + w // 2), (n - w, n))
    out = {}
    with prng.threefry_partitionable(False):
        whole = torch.empty((1, n), dtype=torch.bfloat16, device="cuda")
        tn.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tn.threefry_normal(whole, key[None], n, scale=0.02)
        torch.cuda.synchronize()
        whole_s = time.perf_counter() - t0
        for lo, hi in windows:
            card = torch.empty((1, hi - lo), device="cuda")
            tn.threefry_normal(card, key[None], n, lo)
            card = card[0]
            if not torch.equal(whole[0, lo:hi], (card * 0.02).to(torch.bfloat16)):
                raise AssertionError(f"normal {BLOCKED_DRAW_SHAPE}: the whole leaf's draw "
                                     f"differs from its window [{lo}, {hi})")
            host = card.cpu()
            for start, z in prng.normal_chunks(key, BLOCKED_DRAW_SHAPE, device="cpu", chunk=w,
                                               start=lo, stop=hi):
                a, b = max(start, lo), min(start + z.numel(), hi)
                if a < b and not torch.equal(host[a - lo:b - lo].view(torch.int32),
                                             z[a - start:b - start].view(torch.int32)):
                    raise AssertionError(f"normal {BLOCKED_DRAW_SHAPE}: card != CPU in "
                                         f"[{a}, {b})")
            out[f"[{lo}, {hi})"] = "card = CPU bitwise"
        if tn.launches != 1 + len(windows):
            raise AssertionError(f"normal {BLOCKED_DRAW_SHAPE}: {tn.launches} kernel-7 "
                                 f"launches, want {1 + len(windows)}")
        del whole
        torch.cuda.empty_cache()
    return {"shape": list(BLOCKED_DRAW_SHAPE), "draws": n, "blocks": n // block + 1,
            "windows": out, "whole_leaf_bf16_s": whole_s,
            "whole_leaf_ns_per_draw": whole_s / n * 1e9}


def topk_legs(cell) -> int:
    """Kernel-1 calls a round of a GLM cell: one for each leg whose
    compressor selects by Top-K (the Hessian leg, the model stream)."""
    return sum(1 for comp in (cell.hess_comp, cell.model_comp)
               if comp is not None and comp.kind in TOPK_KINDS)


def codec_draws(comp) -> int:
    """Bits-path launches of a compressor's own draws in one `compress`
    call (its client keys aside): a dithering, natural-compression or
    lazy-Bernoulli codec one `bernoulli`; Top-K composed with one, the
    inner's; Rank-R composed with two, a `split` of the keys and the
    inners'.  Rand-K's `choice` depends on the stack's width (see
    `bits_per_round`'s nl1)."""
    from repro_torch.core import compressors as C

    if comp.deterministic:
        return 0
    if isinstance(comp, C.ComposedTopK):
        return codec_draws(comp.inner)
    if isinstance(comp, C.ComposedRankR):
        return 1 + codec_draws(comp.inner_u) + codec_draws(comp.inner_v)
    if isinstance(comp, (C.RandomDithering, C.NaturalCompression, C.BernoulliLazy)):
        return 1
    raise ValueError(f"no bits-path count for {type(comp).__name__}")


def leg_draws(comp) -> int:
    """A round's bits-path launches for one compressed leg of the fleet:
    none for a deterministic codec, else the `split` of the leg's key into
    the clients' keys on the card and the codec's draws."""
    return 0 if comp is None or comp.deterministic else 1 + codec_draws(comp)


def bits_per_round(cell, leaves: int = 0) -> int:
    """Kernel 7's bits-path launches a round of a cell, from its draws: the
    round key's splits hash on the host (a CPU key, a few pairs); BL2 and
    BL3 draw participation (one `bernoulli` over the fleet when τ < n; a
    cohort's one `fold_in` of its slots and one `bernoulli`), the model
    stream's and the Hessian leg's codecs (`leg_draws`) and ξ (one
    `bernoulli` when p < 1); BL1 its Hessian leg (ξ and the model stream
    are single-key draws on the host); FedNL-BAG its reporters (one
    `bernoulli`) and its Hessian leg; DIANA its leg; ADIANA two codec calls
    on host keys; NL1 Rand-K's `choice` without replacement over the m
    coefficients, whose `permutation` splits host keys and draws
    ⌈3 ln m / ln(2³² − 1)⌉ `random_bits`; a BL-DNN cell each of its
    ``leaves`` gradient legs and, preconditioned, as many Fisher legs; GD,
    local GD, Newton and DORE's Top-K none."""
    from repro_torch.core import prng
    from repro_torch.exp import engine

    p = cell.cell.params_dict()
    spec = cell.problem
    n = getattr(spec, "n_clients", 0)
    d = getattr(spec, "d", 0)

    def comp(cfg):
        return None if cfg is None else engine.build_compressor(cfg, d)

    hc, mc = comp(cell.hess_comp), comp(cell.model_comp)
    m = cell.method
    if m in ("gd", "local_gd", "newton"):
        return 0
    if m == "dore":
        if leg_draws(hc) or leg_draws(mc):
            raise ValueError(f"{cell.name}: no bits-path count for DORE's stochastic codecs")
        return 0
    if m == "bl1":
        if leg_draws(mc):
            raise ValueError(f"{cell.name}: no bits-path count for BL1's stochastic model stream")
        return leg_draws(hc)
    if m in ("bl2", "bl3"):
        if "cohort" in p:
            part = 2
        else:
            part = 1 if int(p.get("tau", n)) < n else 0
        return part + leg_draws(mc) + leg_draws(hc) + (1 if float(p.get("p", 1.0)) < 1 else 0)
    if m == "fednl_bag":
        return 1 + leg_draws(hc)
    if m == "diana":
        return leg_draws(hc)
    if m == "adiana":
        return 2 * codec_draws(hc)
    if m == "nl1":
        return prng._shuffle_rounds(spec.m)
    if m == "bldnn":
        legs = 2 if p.get("precondition", True) else 1
        return leaves * legs * leg_draws(hc)
    raise ValueError(f"no bits-path count for method {m!r}")


def need_exact(name: str, counts: dict, want: dict) -> None:
    """Fail unless every kernel ran exactly as often as `want` says."""
    bad = {kn: (counts[kn], n) for kn, n in want.items() if counts[kn] != n}
    if bad:
        raise AssertionError(f"{name}: kernel launches (counted, expected) {bad}")


def bl2_xl_phase(torch, k, problems, prng, rounds, prob, device: str = "cuda") -> tuple:
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
    Returns kernel 1's and kernel 7's bits path's launches in the last full
    run."""
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
            want["threefry_bits"] = bits_per_round(cell) * cell.steps
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
    return want["topk_row_threshold"], want["threefry_bits"]


def glm_cells_phase(torch, k, problems, cells, paper, phase=None,
                    device: str = "cuda", s_per_round: Optional[dict] = None,
                    bits: Optional[dict] = None) -> dict:
    """Run GLM cells on the card, each held to its reference history
    (`problems.Cell.reference_history`: the artifact or the reference file) at
    the GLM gate (`check_history`, with the cell's
    `problems.REFERENCE_SVD_NAN` round), bits exact, kernel 1 launched
    exactly once a round for each leg that selects by Top-K and no other
    kernel; ``paper`` is
    fig1r1's problem, a cell on another regime builds its own.  Emits one
    line a cell (under ``phase``, default the cell's experiment) and
    returns kernel 1's launches by cell; ``s_per_round`` (a dict) collects
    each cell's seconds a round.  Kernel 7's bits path launches exactly
    `bits_per_round` a round (the cell's draws on the card); ``bits`` (a
    dict) collects its launches by cell."""
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
        want["threefry_bits"] = bits_per_round(cell) * cell.steps
        need_exact(name, counts, want)
        out[name] = counts["topk_row_threshold"]
        if bits is not None:
            bits[name] = counts["threefry_bits"]
        if s_per_round is not None:
            s_per_round[name] = secs / cell.steps
        emit({"phase": phase or cell.experiment, "cell": cell.name, "method": cell.method,
              "basis": cell.basis, "steps": cell.steps, "setup_s": setup_s, "run_s": secs,
              "s_per_round": secs / cell.steps, "launches": counts, **res})
    return out


def check_backend_envelope(name: str, hist, ref: dict) -> dict:
    """The reference's envelope between its two backends
    (tests/test_batched_parity.py ``_assert_parity``): gaps within
    1e-8 + 1e-9·|ref|, uplink and downlink bits within 1e-12·|ref|."""
    import numpy as np

    g, gr = np.asarray(hist.gaps), np.asarray(ref["gaps"])
    if g.shape != gr.shape or not np.all(np.abs(g - gr) <= 1e-8 + 1e-9 * np.abs(gr)):
        raise AssertionError(f"{name}: gaps leave the backends' envelope: {g} vs {gr}")
    worst = {}
    for key in ("up_bits", "down_bits"):
        b, br = np.asarray(getattr(hist, key)), np.asarray(ref[key])
        if b.shape != br.shape or not np.all(np.abs(b - br) <= 1e-12 * np.abs(br)):
            raise AssertionError(f"{name}: {key} {b} leave 1e-12 of {br}")
        worst[key] = float(np.max(np.abs(b - br)))
    return {"envelope_max_gap_abs_err": float(np.max(np.abs(g - gr))),
            "envelope_max_bits_abs_err": worst}


def fig1r1_reference_phase(torch, k, problems, prob, device: str = "cuda") -> dict:
    """fig1r1's BL1, FedNL and Newton through ``backend="reference"`` on the
    card, each held to its artifact in the backends' envelope
    (`check_backend_envelope`) and to the same loops on the CPU in the GLM
    gate (integer bits exact); kernel 1 exactly once a client a round on a
    Top-K Hessian leg and once a round on a Top-K model stream (BL1: 12
    rounds of 10 clients, 120).  Then a fleet the fast path cannot stack,
    Top-K on half the clients and Rank-R on the rest, 6 rounds: "fast"
    raises `batched.FastPathUnavailable` and "auto" is "reference" bit for
    bit."""
    from repro_torch.core import batched, bl
    from repro_torch.core import compressors as C

    cpu = problems.build_problem(problems.FIG1R1.problem, device="cpu")
    out = {}
    for name in ("BL1", "FedNL", "Newton"):
        cell = problems.FIG1R1_CELLS[name]
        hist, secs, counts = drive(torch, k, lambda: problems.run_cell(cell, prob,
                                                                       backend="reference"))
        n = cell.problem.n_clients
        want = dict.fromkeys(counts, 0)
        want["topk_row_threshold"] = cell.steps * sum(
            per for comp, per in ((cell.hess_comp, n), (cell.model_comp, 1))
            if comp is not None and comp.kind in TOPK_KINDS)
        need_exact(f"fig1r1/{name} (reference)", counts, want)
        env = check_backend_envelope(f"fig1r1/{name} (reference)", hist,
                                     json.loads(cell.artifact.read_text())["history"])
        t0 = time.perf_counter()
        on_cpu = problems.run_cell(cell, cpu, backend="reference")
        cpu_s = time.perf_counter() - t0
        res = check_history(f"fig1r1/{name} (reference, card vs CPU)", hist,
                            history_dict(on_cpu))
        res.pop("gaps")
        out[name] = {"run_s": secs, "cpu_run_s": cpu_s, "s_per_round": secs / cell.steps,
                     "launches": counts, **env, "card_vs_cpu": res}
    clients, bases = prob.clients, prob.bases("data_outer")
    half = len(clients) // 2
    comps = [C.TopK(k=bases[0].r ** 2)] * half + [C.RankR(r=2)] * (len(clients) - half)
    args = (clients, bases, comps, C.Identity(), prob.x0, prob.x_star, 6)
    try:
        bl.bl1(*args, backend="fast", device=device)
    except batched.FastPathUnavailable as e:
        refused = str(e)
    else:
        raise AssertionError("fig1r1 mixed fleet: backend='fast' ran a fleet it cannot stack")
    auto, secs, counts = drive(torch, k, lambda: bl.bl1(*args, backend="auto", device=device))
    ref = bl.bl1(*args, backend="reference", device=device)
    if (auto.gaps, auto.up_bits, auto.down_bits) != (ref.gaps, ref.up_bits, ref.down_bits):
        raise AssertionError("fig1r1 mixed fleet: 'auto' differs from 'reference'")
    want = dict.fromkeys(counts, 0)
    want["topk_row_threshold"] = 6 * half
    need_exact("fig1r1 mixed fleet (auto)", counts, want)
    out["mixed_fleet"] = {"fast_refused": refused, "auto_equals_reference": True,
                          "run_s": secs, "launches": counts, "gaps": auto.gaps}
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
        want["threefry_bits"] = bits_per_round(cell) * cell.steps
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
        out.setdefault("bits_launches", {})[name] = counts["threefry_bits"]
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


def served_cache_line(name: str, stdout: str) -> dict:
    """The ``[serve] progcache {...}`` line a serve child logs after its
    first chunk (a killed child writes no record)."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith("[serve] progcache ")]
    if not lines:
        raise AssertionError(f"{name}: the serve child logged no program-cache line: "
                             f"{stdout[-1000:]}")
    return json.loads(lines[-1][len("[serve] progcache "):])


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
          with the reference CI's serve-smoke command and the default
          program cache (``<ckpt-dir>/progcache``): uninterrupted and killed
          by ``--crash-after-round 14`` (exit -9, newest checkpoint below
          30), both cache misses only; restarted from a fresh copy of
          ``src/`` (its tier 2, ``<copy>/build/``, empty) with ``nvcc``
          hidden (``PATH`` without it, ``CUDA_HOME`` an empty directory):
          only cache hits, no nvcc run and one dlopen each of kernel 1's
          and kernel 7's libraries, and its record equals the
          uninterrupted one bit for bit and both the JAX package's
          (`problems.SERVE_REFERENCE`); then the
          same serve in-process, counted and timed; then written on the CPU
          to round 12 and resumed on the card, held to the same file: its L
          is in the CPU's data basis, whose SVD column signs may differ
          from cuSOLVER's, and the resume maps it into the card's
          (`fed_serve.basis_fingerprint`; the flipped columns are counted);
      (b) fig4/BL3_tau_half and fig1-bag/BAG_q0.5 (8 rounds, then extended
          to 24 from its checkpoint) in-process with their fault plans,
          against the same file;
      (e) cohort-smoke/BL2 in-process with its cache, then again in a new
          checkpoint directory through the first one's cache after
          `rounds.clear_aot_memo`: equal records (meta aside), the second
          all cache hits and no ``cohort_chunk`` trace.

    Every in-process serve runs under `drive`: kernel 1 exactly once a
    round a Top-K leg, kernel 7's bits path exactly `bits_per_round` a
    round, no other kernel.  Each case reports s/round served
    (the record's runtime less its checkpoint writes, over the rounds it
    ran: the carry's init or the load, the rounds and the final gap
    evaluation) and s/round in its chunks alone (``meta.chunk_s``) beside
    the direct call's, the newest checkpoint's bytes, its write and load
    seconds, and ``ttfr_s``."""
    import shutil
    import tempfile
    from types import SimpleNamespace

    from repro_torch.core import rounds
    from repro_torch.exp import artifacts, engine
    from repro_torch.launch import fed_serve

    ref = json.loads(problems.SERVE_REFERENCE.read_text())["cases"]
    quiet = {"log": lambda *a: None}
    out, launches, bits = {}, {}, {}
    t_phase = time.perf_counter()
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="chip_smoke_serve_"))

    def want_k1(name, cell, rounds_run, counts):
        want = dict.fromkeys(counts, 0)
        want["topk_row_threshold"] = topk_legs(cell) * rounds_run
        want["threefry_bits"] = bits_per_round(cell) * rounds_run
        need_exact(name, counts, want)
        launches[name] = launches.get(name, 0) + counts["topk_row_threshold"]
        bits[name] = bits.get(name, 0) + counts["threefry_bits"]

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

        def cli(ckpt, *extra, src=ROOT / "src", env=None):
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.fed_serve", *case["args"],
                 "--ckpt-dir", str(ckpt), "--device", device, *extra], capture_output=True,
                text=True, timeout=600, cwd=src.parent,
                env={**os.environ, **(env or {}), "PYTHONPATH": str(src)})
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
        cold = {"uninterrupted": served_cache_line(name, p_ref.stdout),
                "killed": served_cache_line(name, p_kill.stdout)}
        for which, line in cold.items():
            if line["stats"].get("hit", 0) or not line["stats"].get("miss", 0):
                raise AssertionError(f"{name}: the {which} child's cache should only miss: "
                                     f"{line}")
        # the restart: a fresh copy of src/ (an empty tier 2) and no toolkit
        fresh = tmp / "fresh_checkout"
        shutil.copytree(ROOT / "src", fresh / "src",
                        ignore=shutil.ignore_patterns("__pycache__"))
        (fresh / "no_cuda").mkdir()
        path = os.pathsep.join(d for d in os.environ.get("PATH", "").split(os.pathsep)
                               if d and not os.path.exists(os.path.join(d, "nvcc")))
        if shutil.which("nvcc", path=path) is not None:
            raise AssertionError(f"{name}: nvcc is still on the restart's PATH")
        p_res, s_res = cli(tmp / "cli_crash", "--result", str(tmp / "cli_res.json"),
                           src=fresh / "src",
                           env={"PATH": path, "CUDA_HOME": str(fresh / "no_cuda")})
        if p_res.returncode != 0 or "resumed from checkpoint" not in p_res.stdout:
            raise AssertionError(f"{name}: the restart exited {p_res.returncode}: "
                                 f"{p_res.stdout[-1000:]} {p_res.stderr[-2000:]}")
        whole = json.loads((tmp / "cli_ref.json").read_text())
        resumed = json.loads((tmp / "cli_res.json").read_text())
        if resumed["meta"]["resumed_from"] != max(ts) or strip_meta(resumed) != strip_meta(whole):
            raise AssertionError(f"{name}: kill -9 and restart differ from the uninterrupted "
                                 "serve")
        warm = resumed["meta"]["progcache"]
        built = sorted(p.name for p in (fresh / "build").rglob("*")) \
            if (fresh / "build").exists() else []
        if warm["stats"].get("miss", 0) != 0 or not warm["stats"].get("hit", 0) \
                or warm["nvcc_runs"] or built:
            raise AssertionError(f"{name}: the warm restart should only hit the cache and "
                                 f"build nothing: {warm['stats']}, nvcc {warm['nvcc_runs']}, "
                                 f"tier 2 {built}")
        if warm["dlopens"] != {"topk_threshold": 1, "threefry_normal": 1}:
            raise AssertionError(f"{name}: the warm restart loaded {warm['dlopens']}, not "
                                 "kernel 1's and kernel 7's libraries once each")
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
                     "progcache_cold": {**cold, "uninterrupted_record":
                                        {key: whole["meta"]["progcache"][key] for key in
                                         ("stats", "nvcc_runs", "dlopens")}},
                     "progcache_warm": {key: warm[key] for key in
                                        ("stats", "nvcc_runs", "dlopens", "programs")},
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

        # ---- (e) cohort-smoke twice through one program cache ----------------------
        name, cell = "cohort-smoke/BL2", problems.COHORT_SMOKE
        kw = dict(seed=2, chunk=3, max_rounds=12)
        first, t1 = served(name, cell, tmp / "cs1", **kw)
        rounds.clear_aot_memo()
        before = rounds.trace_counts()
        again, t2 = served(f"{name} (memo cleared)", cell, tmp / "cs2",
                           progcache_dir=str(tmp / "cs1" / "progcache"), **kw)
        traced = rounds.trace_counts().get("cohort_chunk", 0) - before.get("cohort_chunk", 0)
        if strip_meta(again) != strip_meta(first) or traced:
            raise AssertionError(f"{name}: the second serve differs ({traced} cohort_chunk "
                                 "traces) from the first")
        if again["meta"]["progcache"]["stats"].get("miss", 0):
            raise AssertionError(f"{name}: the second serve missed the cache: "
                                 f"{again['meta']['progcache']['stats']}")
        out[name] = {"first": t1, "second": t2, "cohort_chunk_traces_second": traced,
                     "progcache_first": first["meta"]["progcache"]["stats"],
                     "progcache_second": again["meta"]["progcache"]["stats"]}
        emit({"phase": "serve", "case": "e", "cell": name, **out[name]})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["launches"] = launches
    out["bits_launches"] = bits
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
    caller to read; the backward kernels' calls count as
    ``flash_attention_bwd`` and ``ssd_scan_bwd``, kernel 7's (``tn``) as
    ``threefry_normal`` (its normal path) and ``threefry_bits`` (its bits
    path)."""
    torch.cuda.synchronize()
    k.tk.launches = k.tk.compress_sum_launches = k.tk.compress_sum_cuda_launches = 0
    k.tm.launches = k.bt.launches = k.bt.cuda_launches = 0
    k.fa.launches = k.ss.launches = k.ss.cuda_launches = 0
    k.fa.bwd_launches = k.ss.bwd_launches = k.tn.launches = k.tn.bits_launches = 0
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
                                           "ssd_scan": k.ss.launches,
                                           "flash_attention_bwd": k.fa.bwd_launches,
                                           "ssd_scan_bwd": k.ss.bwd_launches,
                                           "threefry_normal": k.tn.launches,
                                           "threefry_bits": k.tn.bits_launches}


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


#: the BL-DNN problem the port draws for phase dnn-drawn: fig-dnn's widths
#: (n = 8, m = 64, d = 96) at another seed
DRAWN_DNN_SEED = 1
#: the carried fixture's leaves against the port's own draw: the teacher's
#: re-spectralising SVD is another LAPACK call (share of max|ref|)
DRAWN_DNN_TOL = 1e-5


def dnn_drawn_phase(torch, k, problems) -> dict:
    """A BL-DNN problem the port draws (`DNNProblemSpec(seed=1)` at fig-dnn's
    widths) through `engine.build_problem` on the card and on the CPU, then
    fig-dnn/BLDNN and fig-dnn/TopK for their rounds through the engine, the
    card held to the CPU in the BL-DNN gate (bits exact every round, loss
    within 1e-4·|ref| and the error rate equal over rounds 0–3) with kernel
    1, 2 and 4 launch counts exact; then the port's draw of fig-dnn's own
    spec, made for the card, against the carried fixture: x bit for bit, y
    equal, the student's input layer bit for bit, its other leaves within
    DRAWN_DNN_TOL."""
    import dataclasses

    from repro_torch.core.pytree import tree_leaves
    from repro_torch.exp import engine

    spec = dataclasses.replace(problems.DNN_FIG, seed=DRAWN_DNN_SEED)
    t0 = time.perf_counter()
    card = problems.build_problem(spec, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    cpu = problems.build_problem(spec, device="cpu")
    if not all(torch.equal(a.cpu(), b) for a, b in zip(tree_leaves(card.params0),
                                                       tree_leaves(cpu.params0))):
        raise AssertionError("dnn-drawn: the card's problem is not the CPU's")
    cells = {}
    for cell in (problems.FIG_DNN["BLDNN"], problems.FIG_DNN["TopK"]):
        hist, secs, counts = drive(torch, k, lambda: problems.run_dnn_cell(cell, card))
        t0 = time.perf_counter()
        ref = problems.run_dnn_cell(cell, cpu)
        cpu_s = time.perf_counter() - t0
        res = check_dnn_history(f"dnn-drawn/{cell.name}", hist,
                                {**history_dict(ref), "metrics": ref.metrics})
        want = dict.fromkeys(counts, 0)
        want["topk_row_threshold"] = want["topk_compress_sum"] = 4 * cell.steps
        want["topk_compress_sum_cuda"] = 4 * cell.steps
        if cell.basis is not None:
            want["basis_transform"] = want["basis_transform_cuda"] = 4 * cell.steps
        need_exact(f"dnn-drawn/{cell.name}", counts, want)
        cells[cell.name] = {"steps": cell.steps, "run_s": secs, "cpu_run_s": cpu_s,
                            "s_per_round": secs / cell.steps, "launches": counts,
                            "losses": list(hist.metrics["loss"]), **res}
    # fig-dnn's own spec, drawn by the port for the card, against the fixture
    drawn = engine.draw_dnn_problem(problems.DNN_FIG, device="cuda")
    fix = problems.load_dnn_problem(device="cpu")
    x, y = drawn.batch.data["x"].cpu(), drawn.batch.data["y"].cpu()
    if not (torch.equal(x.view(torch.int32), fix.batch.data["x"].view(torch.int32))
            and torch.equal(y, fix.batch.data["y"])):
        raise AssertionError("dnn-drawn: the port's draw of fig-dnn's x or y is not the "
                             "fixture's")
    leaf_rel = {}
    for (name, a), b in zip(_leaves(drawn.params0), tree_leaves(fix.params0)):
        a = a.cpu()
        rel = float((a - b).abs().max()) / float(b.abs().max())
        exact = torch.equal(a.view(torch.int32), b.view(torch.int32))
        if not rel <= DRAWN_DNN_TOL or (name == "in" and not exact):
            raise AssertionError(f"dnn-drawn: the port's fig-dnn leaf {name} is {rel} "
                                 f"(relative) off the fixture's (bitwise: {exact})")
        leaf_rel[name] = {"max_rel_err": rel, "bitwise": exact}
    return {"spec": dataclasses.asdict(spec), "setup_s": setup_s, "cells": cells,
            "fixture": {"x_bitwise": True, "y_equal": True, "params0": leaf_rel}}


def attention_pairs(Sq: int, Sk: int, causal: bool, window, q_pos0: int = 0) -> int:
    """Visible (query, key) pairs of one head: keys j ≤ i (causal) and
    j > i − window for the query at position i (q_pos0 + its row); a row
    that sees no key averages all Sk values."""
    import numpy as np

    qi = q_pos0 + np.arange(Sq)
    hi = np.minimum(qi, Sk - 1) if causal else np.full(Sq, Sk - 1)
    lo = np.maximum(qi - window + 1, 0) if window else np.zeros(Sq, np.int64)
    n = np.maximum(hi - lo + 1, 0)
    return int(np.where(n > 0, n, Sk).sum())


def attention_bound_ms(q, k, causal: bool, window, q_pos0: int = 0) -> tuple:
    """Least time for masked attention: q, k, v read once and o written once
    in their type, or 4·hd operations (two multiply-adds) a visible pair and
    head at the bfloat16 tensor-core rate (bfloat16 inputs) or the float32
    rate (TF32 stays off), whichever is larger."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    eb = q.element_size()
    bytes_ms = eb * (2 * B * Sq * H * hd + 2 * B * Sk * KVH * hd) / HBM_BYTES_PER_S * 1e3
    rate = BF16_OPS_PER_S if str(q.dtype) == "torch.bfloat16" else OPS32_PER_S
    ops_ms = 4 * hd * B * H * attention_pairs(Sq, Sk, causal, window, q_pos0) / rate * 1e3
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

    def hold(name, dt, q, k, v, causal, window, q_pos0=0):
        out = fa.flash_attention(q, k, v, causal=causal, window=window, q_pos0=q_pos0)
        plain = fa.flash_attention_plain(q, k, v, causal=causal, window=window,
                                         q_pos0=q_pos0).float()
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
    # a sequence-parallel rank's slice: its queries at q_pos0 against every key
    B, Sq, Sk, H, KVH, hd = ATTN_OFFSET_SHAPE
    for q0, w in ATTN_OFFSETS:
        for dt in ("bfloat16", "float32"):
            hold(f"gemma3 slice at q_pos0 {q0}, window {w}", dt, rnd(B, Sq, H, hd, dtype=dt),
                 rnd(B, Sk, KVH, hd, dtype=dt), rnd(B, Sk, KVH, hd, dtype=dt), True, w, q0)
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
    # the last slice (q_pos0 2048) of each layer kind, in both types, beside
    # SDPA with the offset mask as a boolean mask
    B, Sq, Sk, H, KVH, hd = ATTN_OFFSET_SHAPE
    for q0, w in ATTN_OFFSETS:
        if q0 != 2048:
            continue
        for dt in ("float32", "bfloat16"):
            q = rnd(B, Sq, H, hd, dtype=dt)
            k, v = (rnd(B, Sk, KVH, hd, dtype=dt) for _ in range(2))
            qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
            mask = fa.mask(Sq, Sk, True, w, q.device, q0)
            bound, by = attention_bound_ms(q, k, True, w, q0)
            timings[f"offset{q0}_{'global' if w is None else f'window{w}'}_{dt}"] = {
                "shape": [B, Sq, Sk, H, KVH, hd], "q_pos0": q0, "window": w, "dtype": dt,
                "kernel_ms": cuda_ms(torch, lambda: fa.flash_attention(
                    q, k, v, causal=True, window=w, q_pos0=q0), 20, warmup=2),
                "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_plain(
                    q, k, v, causal=True, window=w, q_pos0=q0), 5, warmup=1),
                "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, attn_mask=mask, enable_gqa=True), 20, warmup=2),
                "bound_ms": bound, "bound_by": by,
                "pairs_per_head": attention_pairs(Sq, Sk, True, w, q0)}
            del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    # the other configs' full-width shapes, bfloat16: held, then timed
    config_timings = {}
    for name, B, Sq, Sk, H, KVH, hd, causal in ATTN_CONFIG_SHAPES:
        q = rnd(B, Sq, H, hd, dtype="bfloat16")
        k, v = (rnd(B, Sk, KVH, hd, dtype="bfloat16") for _ in range(2))
        hold(name, "bfloat16", q, k, v, causal, None)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))

        def sdpa():
            return F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                  enable_gqa=True)
        bound, by = attention_bound_ms(q, k, causal, None)
        hdp = next(t for t in fa.TEMPLATES["bfloat16"] if hd <= t)
        config_timings[name] = {
            "shape": [B, Sq, Sk, H, KVH, hd], "causal": causal, "dtype": "bfloat16",
            "kernel_ms": cuda_ms(torch, lambda: fa.flash_attention(q, k, v, causal=causal),
                                 20, warmup=2),
            "device_ms": device_ms(torch, {"fwd": lambda: fa.flash_attention(
                q, k, v, causal=causal)}, reps=5)["fwd"],
            "plain_ms": cuda_ms(torch, lambda: fa.flash_attention_plain(q, k, v, causal=causal),
                                5, warmup=1),
            "library_ms": cuda_ms(torch, sdpa, 20, warmup=2),
            "bound_ms": bound, "bound_by": by, "template_hd": hdp,
            # the head dims the template computes past hd: zero-filled by TMA
            "padded_share": 1.0 - hd / hdp}
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    return {"cases": len(cases) + 2 + len(ATTN_CONFIG_SHAPES) + 2 * len(ATTN_OFFSETS),
            "max_abs_err": err,
            "max_rel_err": rel, "limit_share": share, "timings": timings,
            "config_timings": config_timings, "templates": fa.kernel_attributes()}


def ssd_kernel_phase(torch, ss) -> dict:
    """Kernel 6's y and final state against its plain version (each within
    SSD_TOL of max|plain|) on the path's shape and the edge cases, then its
    time at the path's shape beside the plain version and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(6)

    def inputs(B, S, H, hd, N, dt_scale=0.5, a_scale=1.0, dt_min=0.01, init=False):
        """dt uniform in [dt_min, dt_min + dt_scale], A in −a_scale·[0.1,
        1.1]; or with `init` both as the Mamba2 init draws them (see
        `ssd_bwd_phase`): A = −(1..H), dt = softplus(z), z ~ N(0, 1)."""
        x = torch.randn(B, S, H, hd, device="cuda", generator=gen)
        if init:
            dt = torch.nn.functional.softplus(torch.randn(B, S, H, device="cuda", generator=gen))
            A = -torch.arange(1, H + 1, dtype=torch.float32, device="cuda")
        else:
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
    # the other configs' full-width shapes: held, then timed; at the init's
    # decays (dt·A to −256·softplus(z) a step) each version's y also against
    # the plain version's arithmetic in float64
    config_timings = {}
    for name, B, S, H, hd, N, init in SSD_CONFIG_SHAPES:
        args = inputs(B, S, H, hd, N, init=init)
        vs_f64 = None
        if init:
            y, yp = ss.ssd_scan(*args)[0], ss.ssd_scan_plain(*args, chunk=256)[0]
            y64 = ss.ssd_scan_plain(*(t.double() for t in args), chunk=256)[0]
            scale = float(y64.abs().max())
            vs_f64 = {"kernel_vs_f64": float((y.double() - y64).abs().max()) / scale,
                      "plain_vs_f64": float((yp.double() - y64).abs().max()) / scale,
                      "kernel_vs_plain": float((y - yp).abs().max()) / float(yp.abs().max())}
            del y, yp, y64
        try:
            hold(name, args, 256)
        except AssertionError as e:
            raise AssertionError(f"{e}; y against the float64 truth: {vs_f64}") from None
        cases += 1
        bound_tc, by_tc, bytes_ms = ssd_bound_tc_ms(B, S, H, hd, N, chunk=ss.KERNEL_CHUNK)
        config_timings[name] = {
            "shape": [B, S, H, hd, N], "chunk": 256, "init_decays": init, "y_rel_err": vs_f64,
            "kernel_ms": cuda_ms(torch, lambda: ss.ssd_scan(*args), 20, warmup=2),
            "device_ms": device_ms(torch, {"fwd": lambda: ss.ssd_scan(*args)}, reps=5)["fwd"],
            "plain_ms": cuda_ms(torch, lambda: ss.ssd_scan_plain(*args, chunk=256), 5,
                                warmup=1),
            "library_ms": None, "bound_ms": bound_tc, "bound_by": by_tc,
            "bound_f32_ms": ssd_bound_ms(B, S, H, hd, N, chunk=ss.KERNEL_CHUNK)[0]}
        del args
        torch.cuda.empty_cache()
    from repro_torch.kernels import _build

    lib = _build.load("ssd_scan")
    lib.ssd_scan_workspace_floats.argtypes = [ctypes.c_int] * 5
    lib.ssd_scan_workspace_floats.restype = ctypes.c_longlong
    return {"cases": cases, "max_abs_err": err, "timing": timing,
            "config_timings": config_timings, "mixed_decay_y_rel_err": mixed, "cuda_launches_per_call": cuda_launches,
            "workspace_bytes_at_path_shape": 4 * lib.ssd_scan_workspace_floats(*SSD_PATH)}


def attention_bwd_bound_ms(q, k, causal: bool, window, q_pos0: int = 0) -> tuple:
    """Least time for attention's gradient: q, k, v and dO read once and dq,
    dk, dv written once in their type, or five products of 2·hd operations
    a visible pair and query head (s, dP, dv, dq, dk) at the bfloat16
    tensor-core rate (bfloat16 inputs) or the float32 rate, whichever is
    larger."""
    B, Sq, H, hd = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    eb = q.element_size()
    bytes_ms = eb * (3 * B * Sq * H * hd + 4 * B * Sk * KVH * hd) / HBM_BYTES_PER_S * 1e3
    rate = BF16_OPS_PER_S if str(q.dtype) == "torch.bfloat16" else OPS32_PER_S
    ops_ms = 10 * hd * B * H * attention_pairs(Sq, Sk, causal, window, q_pos0) / rate * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def ssd_bwd_ops_bytes(B: int, S: int, H: int, hd: int, N: int, chunk: int) -> tuple:
    """Operations of the SSD's gradient by the chunked algorithm at chunk c
    from the forward's saved chunk states: per batch entry and chunk, M·B
    and Mᵀ·C once for the heads (2 x 2c²N), and per head dy·uᵀ and Pᵀ·dy
    (2 x 2c²hd) and five state products (dy ⊗ C summed into the state
    gradient, R·B, C·S_in, and the state terms of dC and dB; 5 x 2c·hd·N);
    and the bytes of x, dt, A, B, C, dy and the saved states read once and of
    dx, ddt, dA, dB, dC written once, all float32."""
    c = min(chunk, S)
    nc = -(-S // c)
    ops = B * nc * (4 * c * c * N + H * (4 * c * c * hd + 10 * c * hd * N))
    bytes_ = 4 * (3 * B * S * H * hd + 2 * B * S * H + 2 * H + 4 * B * S * N
                  + B * nc * H * hd * N)
    return ops, bytes_


def _bwd_err(name: str, got: dict, want: dict, bf16: bool) -> dict:
    """Each output of a backward kernel against its float64 truth: the
    largest |Δ| over max|f64| and the largest share of the limit (BWD_TOL ·
    max|f64|, plus one bf16 ulp of the f64 value in bf16) an element takes;
    raises past the limit."""
    import torch

    out = {}
    for key, w in want.items():
        d = (got[key].double() - w).abs()
        scale = float(w.abs().max())
        lim = torch.full_like(w, BWD_TOL * scale)
        if bf16:
            lim += torch.where(w == 0, 0.0, torch.ldexp(torch.ones_like(w),
                                                        torch.frexp(w)[1] - 8))
        share = float((d / lim).max())
        if not share <= 1.0:
            raise AssertionError(f"{name}: {key} off its float64 truth by {float(d.max())} "
                                 f"(max|f64| {scale}; {share:.3f} of the limit)")
        out[key] = {"abs": float(d.max()), "rel": float(d.max()) / scale,
                    "limit_share": share}
    return out


def attention_bwd_phase(torch, fa) -> dict:
    """Kernel 5's backward through `FlashAttention` against float64 autograd
    through `flash_attention_plain` (see _bwd_err), bitwise over reruns at
    the path's shapes, then timed there in bf16 beside the plain version's
    backward, SDPA's and the bound."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(25)

    def rnd(*shape, dtype):
        return torch.randn(*shape, device="cuda", generator=gen).to(dtype)

    def grads(q, k, v, do, causal, window, q0=0):
        ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
        out = fa.flash_attention(*ins, causal=causal, window=window, q_pos0=q0)
        if out.grad_fn is None or out.dtype != q.dtype:
            raise AssertionError("flash_attention on tensors that require a gradient "
                                 "returned no grad_fn")
        return dict(zip(("dq", "dk", "dv"), torch.autograd.grad(out, ins, do)))

    def truth(q, k, v, do, causal, window, q0=0):
        """float64 autograd through the plain version, a batch entry and a
        group of KV heads (with their query heads) at a time, or a part of
        one KV head's query heads at a time (its dk and dv summed over the
        parts)."""
        B, Sq, H, _ = q.shape
        Sk, KVH = k.shape[1], k.shape[2]
        rep = H // KVH
        g = max(1, min(KVH, BWD_TRUTH_ELEMS // (rep * Sq * Sk)))
        r = rep if g > 1 else max(1, min(rep, BWD_TRUTH_ELEMS // (Sq * Sk)))
        while rep % r:
            r -= 1
        out = {key: torch.zeros(x.shape, dtype=torch.float64, device=x.device)
               for key, x in (("dq", q), ("dk", k), ("dv", v))}
        for b in range(B):
            for h0 in range(0, KVH, g):
                n = min(g, KVH - h0)
                ks = slice(h0, h0 + n)
                for r0 in range(0, rep, r):
                    # query heads r0 .. r0 + r of each KV head of the group
                    qs = torch.arange(h0 * rep, (h0 + n) * rep, device=q.device).view(
                        n, rep)[:, r0:r0 + r].flatten()
                    ins = [q[b:b + 1].index_select(2, qs).double().detach()
                           .requires_grad_(True)] + [
                        x[b:b + 1, :, ks].double().detach().requires_grad_(True)
                        for x in (k, v)]
                    o = fa.flash_attention_plain(*ins, causal=causal, window=window,
                                                 q_pos0=q0)
                    d = torch.autograd.grad(o, ins, do[b:b + 1].index_select(2, qs).double())
                    out["dq"][b:b + 1].index_copy_(2, qs, d[0])
                    out["dk"][b:b + 1, :, ks] += d[1]
                    out["dv"][b:b + 1, :, ks] += d[2]
                    del ins, o, d
        return out

    cases, errs, bitwise = [], {}, {}
    for name, B, Sq, Sk, H, KVH, hd, causal, w in ATTN_BWD_PATH:
        label = f"gemma3 train, window {w}" if name in ("global", "window1024") else name
        cases.append((label, B, Sq, Sk, H, KVH, hd, causal, w, True))
    cases = [c + (0,) for c in cases] + [c + (False, 0) for c in ATTN_BWD_SWEEP]
    # a sequence-parallel rank's slices (phase lm_sharded's gemma3 cell)
    cases += [(f"gemma3 slice at q_pos0 {q0}, window {w}", *ATTN_OFFSET_SHAPE, True, w, True, q0)
              for q0, w in ATTN_OFFSETS]
    for name, B, Sq, Sk, H, KVH, hd, causal, window, path, q0 in cases:
        for dt in (torch.bfloat16, torch.float32):
            q, do = rnd(B, Sq, H, hd, dtype=dt), rnd(B, Sq, H, hd, dtype=dt)
            k, v = rnd(B, Sk, KVH, hd, dtype=dt), rnd(B, Sk, KVH, hd, dtype=dt)
            got = grads(q, k, v, do, causal, window, q0)
            tag = f"{name} ({str(dt)[6:]})"
            errs[tag] = _bwd_err(f"flash_attention backward on {tag}", got,
                                 truth(q, k, v, do, causal, window, q0), dt == torch.bfloat16)
            if path:
                again = grads(q, k, v, do, causal, window, q0)
                bitwise[tag] = all(torch.equal(got[key], again[key]) for key in got)
                if not bitwise[tag]:
                    raise AssertionError(f"flash_attention backward on {tag}: two runs differ")
            del q, k, v, do, got
            torch.cuda.empty_cache()

    timings = {}
    for name, B, Sq, Sk, H, KVH, hd, causal, w in ATTN_BWD_PATH:
        q, do = (rnd(B, Sq, H, hd, dtype=torch.bfloat16) for _ in range(2))
        k, v = (rnd(B, Sk, KVH, hd, dtype=torch.bfloat16) for _ in range(2))
        ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
        # the plain version's float32 scores: 6.4 GB at whisper's decoder
        out_plain = fa.flash_attention_plain(*ins, causal=causal, window=w)
        qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
        if w is None:
            out_sdpa = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                                      enable_gqa=KVH != H)
        else:
            out_sdpa = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=fa.mask(Sq, Sk, causal, w, q.device),
                enable_gqa=KVH != H)
        dot = do.transpose(1, 2)

        def kernel():
            return fa._kernel_bwd(q, k, v, do, causal, w)

        bound, by = attention_bwd_bound_ms(q, k, causal, w)
        fa.bwd_cuda_launches = 0
        kernel()
        cuda_launches = fa.bwd_cuda_launches
        kernel_ms = cuda_ms(torch, kernel, 5, warmup=1)
        timings[name] = {
            "shape": [B, Sq, Sk, H, KVH, hd], "causal": causal, "window": w,
            "dtype": "bfloat16", "kernel_ms": kernel_ms,
            "device_ms": device_ms(torch, {"bwd": kernel}, reps=3)["bwd"],
            "plain_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                out_plain, ins, do, retain_graph=True), 3, warmup=1),
            "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                out_sdpa, (qt, kt, vt), dot, retain_graph=True), 5, warmup=1),
            "bound_ms": bound, "bound_by": by, "share": bound / kernel_ms,
            "pairs_per_head": attention_pairs(Sq, Sk, causal, w),
            "cuda_launches_per_call": cuda_launches}
        del q, k, v, do, ins, out_plain, qt, kt, vt, out_sdpa, dot
        torch.cuda.empty_cache()
    # the last slice (q_pos0 2048) of each layer kind, in both types, beside
    # the plain version's backward and SDPA's with the offset mask
    B, Sq, Sk, H, KVH, hd = ATTN_OFFSET_SHAPE
    for q0, w in ATTN_OFFSETS:
        for dt in (torch.float32, torch.bfloat16) if q0 == 2048 else ():
            q, do = (rnd(B, Sq, H, hd, dtype=dt) for _ in range(2))
            k, v = (rnd(B, Sk, KVH, hd, dtype=dt) for _ in range(2))
            ins = [x.detach().requires_grad_(True) for x in (q, k, v)]
            out_plain = fa.flash_attention_plain(*ins, causal=True, window=w, q_pos0=q0)
            qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True) for x in (q, k, v))
            out_sdpa = F.scaled_dot_product_attention(
                qt, kt, vt, attn_mask=fa.mask(Sq, Sk, True, w, q.device, q0), enable_gqa=True)
            dot = do.transpose(1, 2)

            def kernel():
                return fa._kernel_bwd(q, k, v, do, True, w, q0)

            bound, by = attention_bwd_bound_ms(q, k, True, w, q0)
            kernel_ms = cuda_ms(torch, kernel, 5, warmup=1)
            timings[f"offset{q0}_{'global' if w is None else f'window{w}'}_{str(dt)[6:]}"] = {
                "shape": [B, Sq, Sk, H, KVH, hd], "causal": True, "window": w, "q_pos0": q0,
                "dtype": str(dt)[6:], "kernel_ms": kernel_ms,
                "device_ms": device_ms(torch, {"bwd": kernel}, reps=3)["bwd"],
                "plain_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                    out_plain, ins, do, retain_graph=True), 3, warmup=1),
                "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                    out_sdpa, (qt, kt, vt), dot, retain_graph=True), 5, warmup=1),
                "bound_ms": bound, "bound_by": by, "share": bound / kernel_ms,
                "pairs_per_head": attention_pairs(Sq, Sk, True, w, q0)}
            del q, k, v, do, ins, out_plain, qt, kt, vt, out_sdpa, dot
            torch.cuda.empty_cache()
    attrs = fa.backward_attributes()
    for key, a in attrs.items():
        if key.startswith("bfloat16/") and (a["kernel"] != fa.BWD_KERNELS["bfloat16"][
                key.endswith("dkdv")] or a["local_bytes"]):
            raise AssertionError(f"flash_attention backward template {key} is {a}: bfloat16 "
                                 f"runs the wgmma kernels, without spills")
    return {"cases": len(cases) * 2, "errors": errs, "bitwise_reruns": bitwise,
            "max_abs_err": max(e["abs"] for c in errs.values() for e in c.values()),
            "max_rel_err": max(e["rel"] for c in errs.values() for e in c.values()),
            "timings": timings, "templates": attrs,
            "spills": {key: a["local_bytes"] for key, a in attrs.items() if a["local_bytes"]}}


def ssd_bwd_phase(torch, ss) -> dict:
    """Kernel 6's backward through `SSDScan` against float64 autograd
    through `ssd_scan_plain` (see _bwd_err), bitwise over reruns at the
    path's shape, then timed there beside the plain version's backward and
    the bound (no single PyTorch call computes it)."""
    gen = torch.Generator(device="cuda").manual_seed(26)

    def inputs(B, S, H, hd, N, dt_scale=None, a_scale=None, dt_min=None):
        """Scales None: A and dt as mamba2-370m's init makes them, A =
        −exp(A_log) with A_log = log(1..H), dt = softplus(z + dt_bias) with
        dt_bias 0 and z ~ N(0, 1), in_proj's dt columns (scale d^-½) on an
        RMS-normalised input; dt·A reaches about −22 a step at the last
        head, more in the tail of z."""
        x = torch.randn(B, S, H, hd, device="cuda", generator=gen)
        if dt_scale is None:
            A = -torch.exp(torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                                  device="cuda")))
            dt = torch.nn.functional.softplus(torch.randn(B, S, H, device="cuda",
                                                          generator=gen))
        else:
            dt = torch.rand(B, S, H, device="cuda", generator=gen) * dt_scale + dt_min
            A = -(torch.rand(H, device="cuda", generator=gen) + 0.1) * a_scale
        Bm, Cm = (torch.randn(B, S, N, device="cuda", generator=gen) for _ in range(2))
        return x, dt, A, Bm, Cm

    names = ("dx", "ddt", "dA", "dB", "dC")

    def grads(args, dy, ds):
        ins = [t.detach().requires_grad_(True) for t in args]
        y, s = ss.ssd_scan(*ins)
        if y.grad_fn is None:
            raise AssertionError("ssd_scan on tensors that require a gradient returned no "
                                 "grad_fn")
        outs, gs = ([y, s], [dy, ds]) if ds is not None else ([y], [dy])
        return dict(zip(names, torch.autograd.grad(outs, ins, gs)))

    def truth(args, dy, ds, chunk):
        ins = [t.double().detach().requires_grad_(True) for t in args]
        y, s = ss.ssd_scan_plain(*ins, chunk=chunk)
        outs, gs = (([y, s], [dy.double(), ds.double()]) if ds is not None
                    else ([y], [dy.double()]))
        return dict(zip(names, torch.autograd.grad(outs, ins, gs)))

    errs, bitwise = {}, {}
    path = {"mamba2 train": SSD_BWD_PATH, "jamba train": SSD_BWD_JAMBA}
    cases = [(name, *shape, False, None, None, None) for name, shape in path.items()]
    cases += list(SSD_BWD_SWEEP)
    for name, B, S, H, hd, N, with_state, dts, As, dt_min in cases:
        args = inputs(B, S, H, hd, N, dts, As, dt_min)
        dy = torch.randn(B, S, H, hd, device="cuda", generator=gen)
        ds = torch.randn(B, H, hd, N, device="cuda", generator=gen) if with_state else None
        got = grads(args, dy, ds)
        errs[name] = _bwd_err(f"ssd_scan backward on {name}", got,
                              truth(args, dy, ds, 256 if S % 256 == 0 else S), False)
        if name in path:
            again = grads(args, dy, ds)
            bitwise[name] = all(torch.equal(got[key], again[key]) for key in got)
            if not bitwise[name]:
                raise AssertionError(f"ssd_scan backward on {name}: two runs differ")
        del args, dy, ds, got
        torch.cuda.empty_cache()

    def timed(shape) -> dict:
        """6b at `shape` with the init's decays beside the plain version's
        backward and the bounds."""
        args = inputs(*shape)
        dy = torch.randn(*shape[:4], device="cuda", generator=gen)
        _, _, fws = ss._kernel(*args)
        ss.bwd_cuda_launches = 0
        ss._kernel_bwd(*args, dy, None, fws)
        cuda_launches = ss.bwd_cuda_launches

        def kernel():
            return ss._kernel_bwd(*args, dy, None, fws)

        ins = [t.detach().requires_grad_(True) for t in args]
        y_plain = ss.ssd_scan_plain(*ins, chunk=256)[0]
        ops, bytes_ = ssd_bwd_ops_bytes(*shape, chunk=ss.KERNEL_CHUNK)
        # the card's peak for float32 products is three split TF32 products on
        # the tensor cores, as kernel 6's bound counts them; the CUDA cores'
        # float32 rate, which this kernel's FMAs run at, is bound_f32_ms
        bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
        ops_ms = TF32_SPLIT_PRODUCTS * ops / TF32_OPS_PER_S * 1e3
        ops_f32_ms = ops / OPS32_PER_S * 1e3
        kernel_ms = cuda_ms(torch, kernel, 5, warmup=1)
        out = {"shape": list(shape), "kernel_chunk": ss.KERNEL_CHUNK,
               "kernel_ms": kernel_ms,
               "device_ms": device_ms(torch, {"bwd": kernel}, reps=3)["bwd"],
               "plain_ms": cuda_ms(torch, lambda: torch.autograd.grad(
                   y_plain, ins, dy, retain_graph=True), 3, warmup=1),
               "library_ms": None,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "bound_bytes_ms": bytes_ms, "share": max(bytes_ms, ops_ms) / kernel_ms,
               "bound_f32_ms": max(bytes_ms, ops_f32_ms),
               "bound_f32_by": "bytes" if bytes_ms >= ops_f32_ms else "operations",
               "cuda_launches_per_call": cuda_launches}
        del args, dy, fws, ins, y_plain
        torch.cuda.empty_cache()
        return out

    timing = timed(SSD_BWD_PATH)
    config_timings = {"jamba-1.5-large": timed(SSD_BWD_JAMBA)}
    attrs = ss.backward_attributes()
    return {"cases": len(cases), "errors": errs, "bitwise_reruns": bitwise,
            "max_abs_err": max(e["abs"] for c in errs.values() for e in c.values()),
            "max_rel_err": max(e["rel"] for c in errs.values() for e in c.values()),
            "timing": timing, "config_timings": config_timings, "templates": attrs,
            "spills": {key: a["local_bytes"] for key, a in attrs.items() if a["local_bytes"]}}


def train_launches(cfg, remat: bool, steps: int = 1) -> dict:
    """Kernel calls of `steps` train steps of `cfg`: kernel 5 once a
    forward for each encoder layer (outside the rematerialised groups),
    and for each decoder attention layer, and whisper's cross-attention
    beside it, twice with remat (the forward, then the group again in the
    backward) or once without; kernel 6 likewise for each Mamba2 layer;
    each of those layers' backward once."""
    specs = cfg.layer_specs()
    n_attn = sum(1 for sp in specs if sp.mixer == "attn")
    n_ssd = len(specs) - n_attn
    dec = n_attn * (2 if cfg.n_enc_layers else 1)
    f = 2 if remat else 1
    return {"flash_attention": steps * (cfg.n_enc_layers + f * dec),
            "flash_attention_bwd": steps * (cfg.n_enc_layers + dec),
            "ssd_scan": steps * f * n_ssd, "ssd_scan_bwd": steps * n_ssd}


def fed_lm_launches(cfg, rounds: int) -> dict:
    """Kernel calls of `rounds` BL-DNN rounds of a dense LM
    (`examples/torch_train_lm.py --fed`): kernels 1 (the gradient leg's
    Top-K) and 2 (the Fisher leg's compress-sum) once a leaf a round,
    kernel 4 once a rotated (2-D) leaf a round, kernel 5 once an attention
    layer a round for the vmapped gradient and once for the eval stream's
    evaluation of that round's parameters, 5b once a layer a round: the
    client axis folds into one launch."""
    import torch
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.models import model as M

    leaves = tree_leaves(M.param_shapes(cfg, torch.float32))
    rotated = sum(1 for p in leaves if p.dim() == 2 and min(p.shape) >= 2)
    n_attn = sum(1 for sp in cfg.layer_specs() if sp.mixer == "attn")
    return {"topk_row_threshold": rounds * len(leaves),
            "topk_compress_sum": rounds * len(leaves),
            "basis_transform": rounds * rotated,
            "flash_attention": 2 * rounds * n_attn,
            "flash_attention_bwd": rounds * n_attn}


def cut_layers(cfg, layers):
    """`cfg` cut in depth only: `layers` None keeps it whole; a count keeps
    that many layers, whole groups or the first layers of one group; a
    tuple of indices keeps those layers of the group, in order, as one
    group."""
    import dataclasses

    if layers is None:
        return cfg
    if isinstance(layers, tuple):
        group, n = tuple(cfg.group[i] for i in layers), len(layers)
    elif layers % len(cfg.group) == 0:
        group, n = cfg.group, layers
    elif layers < len(cfg.group):
        group, n = cfg.group[:layers], layers
    else:
        raise ValueError(f"{cfg.name}: {layers} layers is neither whole groups of "
                         f"{len(cfg.group)} nor part of one")
    return dataclasses.replace(cfg, n_layers=n, group=group)


@contextlib.contextmanager
def cut_config(train, cfg):
    """`launch.train.main` builds `cfg` (a config cut in depth) for its
    ``--arch``: the launcher runs unchanged, with no flag the reference's
    lacks."""
    saved = train.get_config
    train.get_config = lambda arch: cfg
    try:
        yield
    finally:
        train.get_config = saved


def moe_routes(torch, M, L, params, cfg, batch) -> list:
    """Each MoE layer's router probabilities and expert ids in a forward of
    ``batch``'s inputs (host copies), in layer order."""
    got, route = [], L.moe_route

    def recorded(probs, k):
        vals, ids = route(probs, k)
        got.append((probs.detach().cpu(), ids.cpu()))
        return vals, ids

    L.moe_route = recorded
    try:
        with torch.no_grad():
            M.forward(params, cfg, batch["tokens"][:, :-1], frames=batch.get("frames"),
                      prefix_embeds=batch.get("prefix_embeds"), remat=False)
    finally:
        L.moe_route = route
    return got


def compare_routes(name: str, card: list, cpu: list) -> dict:
    """The card's expert ids against the CPU's, layer by layer, before any
    gradient is compared: a token routed otherwise is a tie when its two
    experts' CPU probabilities lie within 4 float32 ulps (then the gradients
    may differ by O(1), and the reading says so), else a fault."""
    import torch

    for layer, ((p_card, i_card), (p_cpu, i_cpu)) in enumerate(zip(card, cpu)):
        bad = (i_card != i_cpu).any(dim=-1).nonzero().flatten()
        if bad.numel():
            t = int(bad[0])
            a, b = i_card[t], i_cpu[t]
            pa, pb = p_cpu[t, a], p_cpu[t, b]
            gap = float((pa - pb).abs().max())
            ulp = float(torch.finfo(torch.float32).eps * p_cpu[t].max())
            kind = "a tie" if gap <= 4 * ulp else "not a tie"
            raise AssertionError(f"{name}: MoE layer {layer} routes token {t} to experts "
                                 f"{a.tolist()} on the card and {b.tolist()} on the CPU "
                                 f"({kind}: CPU probabilities {pa.tolist()} / "
                                 f"{pb.tolist()}, gap {gap})")
    return {"moe_layers": len(cpu), "expert_ids_equal": True}


def train_reduced_check(torch, k, arch) -> dict:
    """The reduced config of `arch` in float32 on the card against the CPU
    from the same weights, batches and stub inputs: a MoE's expert ids
    first, then step 0's loss and gradients (TRAIN_TOL·max|ref| a leaf, the
    kernel calls exact) and TRAIN_REDUCED_STEPS AdamW steps' losses
    (TRAIN_TOL relative)."""
    from repro_torch.data import pipeline
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.optim import adamw_init

    cfg, cpu = reduced_cpu_params(arch)
    card = _tree_map(lambda t: t.cuda(), cpu)
    Bsz, S = TRAIN_REDUCED_SIZES
    gen = pipeline.SyntheticTokens(cfg.vocab_size, S + 1, Bsz, seed=0)
    extras = {key: torch.tensor(v) for key, v in reduced_extras(cfg, Bsz).items()}
    batches = [{"tokens": torch.as_tensor(gen.batch(i)), **extras}
               for i in range(TRAIN_REDUCED_STEPS)]

    def on_card(b):
        return {key: v.cuda() for key, v in b.items()}

    routes = None
    if cfg.moe is not None:
        routes = compare_routes(f"{arch} reduced", moe_routes(
            torch, M, L, card, cfg, on_card(batches[0])), moe_routes(
            torch, M, L, cpu, cfg, batches[0]))
    grad_fn = steps.make_grad_fn(cfg, remat=False)
    l_cpu, _, g_cpu = grad_fn(cpu, batches[0])
    (l_card, _, g_card), _, counts = drive(
        torch, k, lambda: grad_fn(card, on_card(batches[0])))
    want = {name: 0 for name in counts}
    want.update(train_launches(cfg, remat=False))
    if counts != want:
        raise AssertionError(f"{arch} reduced gradient: kernel launches {counts}, "
                             f"want {want}")
    grad_rel = {}
    for (name, a), (_, b) in zip(_leaves(g_card), _leaves(g_cpu)):
        e, scale = float((a.cpu() - b).abs().max()), float(b.abs().max())
        if not e <= TRAIN_TOL * scale:
            raise AssertionError(f"{arch} reduced, step-0 gradient {name}: |Δ| {e} > "
                                 f"{TRAIN_TOL}·{scale}")
        grad_rel[name] = e / scale if scale else 0.0
    step = steps.make_train_step(cfg, remat=False)
    losses = {}
    for where, params, to in (("cpu", cpu, dict), ("card", card, on_card)):
        opt = adamw_init(params)
        losses[where] = []
        for b in batches:
            params, opt, m = step(params, opt, to(b))
            losses[where].append(float(m["loss"]))
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(losses["card"], losses["cpu"])]
    if not (max(loss_rel) <= TRAIN_TOL and all(map(math.isfinite, losses["card"]))):
        raise AssertionError(f"{arch} reduced: losses {losses}")
    del cpu, card, g_cpu, g_card
    torch.cuda.empty_cache()
    return {"config": cfg.name, "layers": cfg.n_layers, "loss_rel": loss_rel,
            "losses": losses, "loss0": [float(l_card), float(l_cpu)],
            "grad_max_rel": max(grad_rel.values()),
            "grad_max_rel_leaf": max(grad_rel, key=grad_rel.get), "launches_grad": counts,
            "routes": routes}


def train_phase(torch, k) -> dict:
    """The LM training path: the reduced configs on the card against the CPU,
    then the full-width cells through the launcher (see the module
    docstring)."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import shapes, train
    from repro_torch.models import model as M
    from repro_torch.models import steps

    res = {}
    for arch in TRAIN_REDUCED:
        # ---- reduced, float32: the card's kernels against the CPU's plain versions
        res[arch] = {"reduced": train_reduced_check(torch, k, arch)}
        if arch not in {cell[0] for cell in TRAIN_CELLS}:
            emit({"phase": f"train-{arch.split('_')[0]}", **res[arch]})
    for arch, shape, layers, with_plain in TRAIN_CELLS:
        # ---- full width through the launcher, cut in depth where TRAIN_CELLS says
        full = configs.get_config(arch)
        cfg = cut_layers(full, layers)
        shp = shapes.SHAPES[shape]
        rerun = None
        if arch == TRAIN_RERUN:
            # step 0's gradient twice from the same weights and batch: the same bits
            params = M.init_params(prng.PRNGKey(0), cfg, torch.bfloat16, device="cuda")
            batch = next(make_batch_iterator(cfg.vocab_size, shp.seq_len + 1, shp.global_batch,
                                             seed=0, dtype=torch.bfloat16, device="cuda"))
            grad_fn = steps.make_grad_fn(cfg, remat=True)
            l1, a1, g1 = grad_fn(params, batch)
            l2, a2, g2 = grad_fn(params, batch)
            differ = [name for (name, a), (_, b) in zip(_leaves(g1), _leaves(g2))
                      if not torch.equal(a, b)]
            if differ or not (torch.equal(l1, l2) and torch.equal(a1, a2)):
                raise AssertionError(f"{arch} at full width: two step-0 gradients from the "
                                     f"same weights differ (loss {float(l1)} / {float(l2)}; "
                                     f"leaves {differ})")
            rerun = {"loss": float(l1), "aux": float(a1), "leaves": len(list(_leaves(g1))),
                     "bitwise": True}
            del params, batch, g1, g2
            torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        text = io.StringIO()
        argv = ["--arch", arch, "--shape", shape, "--steps", str(TRAIN_STEPS)]
        with contextlib.redirect_stdout(text), cut_config(train, cfg):
            out, wall, counts = drive(torch, k, lambda: train.main(argv))
        peak = torch.cuda.max_memory_allocated()
        if not all(map(math.isfinite, out["losses"])):
            raise AssertionError(f"{arch} {shape}: losses {out['losses']}")
        want = {name: 0 for name in counts}
        want.update(train_launches(cfg, remat=True, steps=TRAIN_STEPS))
        want["threefry_normal"] = len(drawn_leaves(M.param_shapes(cfg)))    # the keyed init
        if counts != want:
            raise AssertionError(f"{arch} {shape}: kernel launches {counts}, want {want} "
                                 f"({TRAIN_STEPS} steps)")
        s_step = median(out["step_s"][1:])
        tokens = out["batch"] * out["seq_len"]
        res[arch].update({
            "config": cfg.name, "layers": cfg.n_layers, "layer_specs": [
                f"{sp.mixer}+{sp.ffn}" for sp in cfg.group], "full_layers": full.n_layers,
            "params": out["params"], "shape": shape, "batch": out["batch"],
            "seq_len": out["seq_len"], "steps": TRAIN_STEPS, "losses": out["losses"],
            "step_s": out["step_s"], "s_per_step": s_step, "tokens_per_s": tokens / s_step,
            "setup_s": out["setup_s"], "init_s": out["init_s"], "wall_s_run": wall,
            "max_memory_allocated": peak, "launches": counts,
            "launches_per_step": {key: n / TRAIN_STEPS for key, n in counts.items()
                                  if key != "threefry_normal"},
            "rerun_step0": rerun, "log": text.getvalue().splitlines()})
        if with_plain:
            # the same run through the plain versions: is the loss's course the
            # kernels' or the optimiser's?
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            with plain_routes(), contextlib.redirect_stdout(io.StringIO()), \
                    cut_config(train, cfg):
                plain, _, counts_plain = drive(torch, k, lambda: train.main(argv))
            if any(n for name, n in counts_plain.items() if name != "threefry_normal"):
                raise AssertionError(f"{arch} {shape} through the plain versions launched "
                                     f"kernels: {counts_plain}")
            plain_rel = [abs(a - b) / abs(b) for a, b in zip(out["losses"], plain["losses"])]
            if not (plain_rel[0] <= WITNESS_LOSS_TOL[0]
                    and max(plain_rel[1:]) <= WITNESS_LOSS_TOL[1]):
                raise AssertionError(f"{arch} {shape}: losses {out['losses']} through the "
                                     f"kernels, {plain['losses']} through the plain versions")
            res[arch].update(plain_losses=plain["losses"], plain_loss_rel=plain_rel,
                             plain_step_s=plain["step_s"],
                             plain_max_memory_allocated=torch.cuda.max_memory_allocated())
        emit({"phase": f"train-{arch.split('_')[0]}", **res[arch]})
        torch.cuda.empty_cache()
    return res


@contextlib.contextmanager
def plain_routes():
    """`kernels.ops`' attention and SSD through their plain versions, for
    the bfloat16 witness only: the paths the gates count never run here."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops
    from repro_torch.kernels import ssd_scan as ss

    saved = ops.flash_attention, ops.ssd_scan
    ops.flash_attention, ops.ssd_scan = fa.flash_attention_plain, ss.ssd_scan_plain
    try:
        yield
    finally:
        ops.flash_attention, ops.ssd_scan = saved


def bf16_witness(torch, k) -> dict:
    """Gemma3-4b's bf16 training composition (wgmma forward, kernel 5's
    backward, the fused cross entropy's bf16 dlogits) at full width, depth
    cut to WITNESS_LAYERS: one gradient on one train_4k_b1 batch through the
    kernels and through the plain versions, both in bf16 from the same
    weights, each against the plain versions in float32 from those weights
    (see WITNESS_FACTOR)."""
    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch import shapes
    from repro_torch.models import model as M
    from repro_torch.models import steps

    full = configs.get_config("gemma3_4b")
    cfg = cut_layers(full, WITNESS_LAYERS)
    shp = shapes.SHAPES["train_4k_b1"]
    batch = next(make_batch_iterator(cfg.vocab_size, shp.seq_len + 1, shp.global_batch,
                                     seed=0, dtype=torch.bfloat16, device="cuda"))
    params = M.init_params(prng.PRNGKey(0), cfg, torch.bfloat16, device="cuda")
    grad_fn = steps.make_grad_fn(cfg, remat=True)
    (loss_k, _, g_k), _, counts = drive(torch, k, lambda: grad_fn(params, batch))
    want = {name: 0 for name in counts}
    want["flash_attention"], want["flash_attention_bwd"] = 2 * WITNESS_LAYERS, WITNESS_LAYERS
    if counts != want:
        raise AssertionError(f"bf16 witness: kernel launches {counts}, want {want}")
    g_k = _tree_map(lambda t: t.cpu(), g_k)
    with plain_routes():
        (loss_p, _, g_p), _, counts = drive(torch, k, lambda: grad_fn(params, batch))
    if any(counts.values()):
        raise AssertionError(f"bf16 witness through the plain versions launched {counts}")
    g_p = _tree_map(lambda t: t.cpu(), g_p)
    params = _tree_map(lambda t: t.float(), params)
    torch.cuda.empty_cache()
    with plain_routes():
        loss_t, _, g_t = grad_fn(params, batch)

    def dist(got, truth):
        scale = float(truth.norm())
        return float((got.to(truth.device, torch.float32) - truth).norm()) / (scale or 1.0)

    leaves = {"loss": (dist(loss_k, loss_t), dist(loss_p, loss_t))}
    for (name, t), (_, a), (_, b) in zip(_leaves(g_t), _leaves(g_k), _leaves(g_p)):
        leaves[name] = (dist(a, t), dist(b, t))
    for name, (ek, ep) in leaves.items():
        if not ek <= max(WITNESS_FACTOR * ep, WITNESS_FLOOR):
            raise AssertionError(f"bf16 witness, {name}: the kernels' gradient is {ek} "
                                 f"(relative) off the float32 plain versions', the bf16 "
                                 f"plain versions' {ep}")
    del params, g_t, g_k, g_p
    torch.cuda.empty_cache()
    return {"config": f"{full.name} at full width, {WITNESS_LAYERS} layers",
            "tokens": shp.global_batch * shp.seq_len,
            "losses": {"kernels_bf16": float(loss_k), "plain_bf16": float(loss_p),
                       "plain_f32": float(loss_t)},
            "rel_dist_kernels": {name: v[0] for name, v in leaves.items()},
            "rel_dist_plain": {name: v[1] for name, v in leaves.items()},
            "max_rel_dist": {"kernels_bf16": max(v[0] for v in leaves.values()),
                             "plain_bf16": max(v[1] for v in leaves.values())}}


_REDUCED_CPU = {}


def reduced_cpu_params(arch):
    """The reduced config of `arch` (`SERVE_REDUCED`) and a fresh copy of
    its float32 weights of PRNGKey(0) drawn on the CPU (the eager draw,
    ~1 µs a draw there): drawn once, shared by the prng, serve and train
    phases, each of which may update its copy."""
    import torch

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.models import model as M

    cfg = configs.get_config(arch).reduced(**SERVE_REDUCED[arch])
    if arch not in _REDUCED_CPU:
        _REDUCED_CPU[arch] = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu")
    return cfg, _tree_map(lambda t: t.clone(), _REDUCED_CPU[arch])


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


def lm_launches(cfg, prefills: int = 1, decode_steps: int = 0) -> dict:
    """The kernel calls `prefills` prefills and `decode_steps` decode steps
    of `cfg` make: kernel 5 once an attention layer a prefill, and once an
    encoder layer and once a cross-attention layer on every call (whisper's
    encoder runs on every step, as the reference's does); kernel 6 once a
    Mamba2 layer a prefill.  No other kernel."""
    specs = cfg.layer_specs()
    n_attn = sum(1 for sp in specs if sp.mixer == "attn")
    every_call = cfg.n_enc_layers + (n_attn if cfg.n_enc_layers else 0)
    return {"flash_attention": every_call * (prefills + decode_steps) + n_attn * prefills,
            "ssd_scan": (len(specs) - n_attn) * prefills}


def no_drop(cfg):
    """`cfg` with a capacity factor at which no MoE token is dropped at any
    token count (capacity ≥ T): decode then routes as the full forward."""
    import dataclasses

    if cfg.moe is None:
        return cfg
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=float(cfg.moe.n_experts)))


def reduced_extras(cfg, batch: int, seed: int = 100) -> dict:
    """Seeded random stub inputs of a reduced config (numpy, float32, scale
    0.5): whisper's frames, qwen2-vl's prefix embeddings."""
    import numpy as np

    rng = np.random.default_rng(seed)
    out = {}
    if cfg.n_enc_layers:
        out["frames"] = rng.standard_normal((batch, cfg.enc_seq, cfg.d_model)) * 0.5
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.standard_normal((batch, cfg.n_prefix_embeds,
                                                    cfg.d_model)) * 0.5
    return {key: v.astype(np.float32) for key, v in out.items()}


def serve_cell(torch, k, drive, arch, shape, steps, layers, profile) -> dict:
    """One serve cell: the reduced config on the card against the CPU, then
    the full-width config in bfloat16 at `shape`, cut to `layers` layers
    when given (see the module docstring)."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.core import prng
    from repro_torch.launch import serve, shapes
    from repro_torch.models import model as M
    from repro_torch.models.steps import stub_inputs

    # ---- reduced config: the card's kernels against the CPU's plain versions
    reduced = serve_reduced_check(torch, k, drive, arch)

    # ---- full width, bfloat16, the reference's weights of PRNGKey(0) drawn
    # on the card, cut in depth only
    cfg = cut_layers(configs.get_config(arch), layers)
    B, prompt, max_seq = serve.sizes(shapes.SHAPES[shape])
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    k.tn.launches = 0
    t0 = time.perf_counter()
    params = M.init_params(prng.PRNGKey(0), cfg, torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    init_peak = torch.cuda.max_memory_allocated()
    init_launches = k.tn.launches
    if init_launches != len(drawn_leaves(params)):
        raise AssertionError(f"{arch} init: {init_launches} kernel-7 launches, want one a "
                             f"drawn leaf ({len(drawn_leaves(params))})")
    cache = M.init_cache(cfg, B, max_seq, torch.bfloat16, device="cuda")
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, prompt)),
                              dtype=torch.int32, device="cuda")
    # the stub frontends' inputs: a standard normal draw scaled by 0.02, as
    # the data pipeline draws them
    gen = torch.Generator(device="cuda").manual_seed(0)
    extras = {key: (torch.randn(v.shape, generator=gen, device="cuda") * 0.02).to(v.dtype)
              for key, v in stub_inputs(cfg, B, torch.bfloat16, device="cuda").items()}
    start = serve.decode_start(prompts, extras)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # warm-up: one prefill and two decode steps (library handles, new shapes);
    # then the cache is zeroed again, as init_cache made it: a Mamba2 layer's
    # prefill continues from the conv state in the cache, as the reference's
    # does, and an attention layer after it sees the difference (jamba)
    warm = serve.prefill(params, cfg, prompts, cache, extras)
    serve.decode(params, cfg, warm["token"], warm["cache"], start, 2, extras)
    _tree_map(lambda t: t.zero_(), cache)
    pre, _, pre_counts = drive(torch, k, lambda: serve.prefill(params, cfg, prompts, cache,
                                                               extras))
    pre_ssd_cuda = k.ss.cuda_launches
    # two prefills of the same inputs: the same bits (the MoE's combine sums
    # each token's expert outputs in a fixed order, with no atomics)
    repeat_bitwise = bool(torch.equal(warm["logits"], pre["logits"]))
    if cfg.moe is not None and not repeat_bitwise:
        raise AssertionError(f"{arch}: two prefills of the same inputs differ in their bits")
    dec, _, dec_counts = drive(torch, k, lambda: serve.decode(
        params, cfg, pre["token"], pre["cache"], start, steps, extras))
    peak = torch.cuda.max_memory_allocated()
    finite = bool(torch.isfinite(pre["logits"]).all()) and all(
        bool(torch.isfinite(lg).all()) for lg in dec["logits"])
    if not finite:
        raise AssertionError(f"{arch}: a prefill or decode logit is not finite")
    calls = lm_launches(cfg)
    want = {name: calls.get(name, 0) for name in pre_counts}
    if pre_counts != want:
        raise AssertionError(f"{arch} prefill: kernel launches {pre_counts}, want {want}")
    calls = lm_launches(cfg, prefills=0, decode_steps=steps)
    want = {name: calls.get(name, 0) for name in dec_counts}
    if dec_counts != want:
        raise AssertionError(f"{arch} decode: kernel launches {dec_counts}, want {want}")
    tokens = B * (prompt + cfg.n_prefix_embeds)
    result = {"reduced": reduced, "config": cfg.name, "layers": cfg.n_layers,
              "full_layers": configs.get_config(arch).n_layers,
              "params": M.count_params(params), "shape": shape, "requests": B, "prompt": prompt,
              "prefix_embeds": cfg.n_prefix_embeds, "enc_seq": cfg.enc_seq,
              "max_seq": max_seq, "decode_steps": steps, "decode_start": start,
              "setup_s": setup_s, "init_s": init_s, "init_max_memory_allocated": init_peak,
              "init_launches": init_launches,
              "prefill_s": pre["seconds"], "prefill_tok_s": tokens / pre["seconds"],
              "decode_s": dec["seconds"], "decode_s_per_step": dec["seconds"] / steps,
              "decode_tok_s": B * steps / dec["seconds"], "max_memory_allocated": peak,
              "logits_finite": finite, "prefill_repeat_bitwise": repeat_bitwise,
              "tokens_head": dec["tokens"][0, :8].tolist(),
              "launches_prefill": pre_counts, "launches_decode": dec_counts,
              "ssd_scan_cuda_launches_prefill": pre_ssd_cuda}
    if profile:
        def run():
            p = serve.prefill(params, cfg, prompts, cache, extras)
            serve.decode(params, cfg, p["token"], p["cache"], start, 4, extras)
        result["profile"] = profile_run(torch, run, 1)
    del params, cache, pre, dec, warm, extras
    torch.cuda.empty_cache()
    return result


def serve_reduced_check(torch, k, drive, arch) -> dict:
    """The reduced config of `arch` (`SERVE_REDUCED`) in float32 with the
    same weights and stub inputs on the card and on the CPU: prefill and 8
    greedy decode steps (logits and the cache within SERVE_TOL, tokens
    equal, exact launch counts), and decode after an 8-token prefill equal
    to the full forward (a MoE config at a capacity that drops nothing).
    A reading above SERVE_UNUSUAL prints where its largest differences
    sit."""
    import numpy as np

    from repro_torch.launch import serve
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

    def to_card(tree):
        return _tree_map(lambda t: t.cuda(), tree)

    cfg, cpu_params = reduced_cpu_params(arch)
    params = to_card(cpu_params)
    B, prompt, max_seq = serve.DEBUG_SIZES
    prompts = torch.as_tensor(np.random.default_rng(0).integers(0, cfg.vocab_size, (B, prompt)),
                              dtype=torch.int32)
    extras = {key: torch.tensor(v) for key, v in reduced_extras(cfg, B).items()}
    ref = serve.generate(cpu_params, cfg, prompts,
                         M.init_cache(cfg, B, max_seq, torch.float32, device="cpu"), 8, extras)
    out, _, counts = drive(torch, k, lambda: serve.generate(
        params, cfg, prompts.cuda(), M.init_cache(cfg, B, max_seq, torch.float32, device="cuda"),
        8, to_card(extras)))
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
    calls = lm_launches(cfg, decode_steps=8)
    want = {name: calls.get(name, 0) for name in counts}
    if counts != want:
        raise AssertionError(f"{arch} reduced: kernel launches {counts}, want {want}")
    dcfg = no_drop(cfg)
    toks = prompts[:1, :9].cuda()
    ex = {key: v[:1].cuda() for key, v in extras.items()}
    full, _, _ = M.forward(params, dcfg, toks, **ex)
    cache = M.init_cache(dcfg, 1, 16, torch.float32, device="cuda")
    pre = serve.prefill(params, dcfg, toks[:, :8], cache, ex)
    dec, _, _ = M.forward(params, dcfg, toks[:, 8:9], cache=pre["cache"],
                          cache_pos=serve.decode_start(toks[:, :8], ex), frames=ex.get("frames"))
    rel["decode_vs_full_forward"] = close("decode after prefill vs full forward",
                                          dec[0, 0], full[0, -1])
    if diagnosis:
        emit({"phase": f"serve-{arch.split('_')[0]}-reduced-diagnosis",
              "usual_rel": SERVE_USUAL_REL, "threshold_rel": SERVE_UNUSUAL,
              "items": diagnosis})
    return {"config": cfg.name, "layers": cfg.n_layers, "max_rel_err": rel,
            "tokens_equal": True, "launches": counts}


#: substrings of the hand-written kernels' names in a profiler trace
HAND_KERNELS = ("threshold", "select_rows", "column_sum", "compress_sum", "tiled_matmul",
                "stream_kernel", "basis_transform", "flash_kernel", "ssd_prep", "ssd_state",
                "ssd_pass", "ssd_out", "threefry_normal", "threefry_bits")


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
    from repro_torch.kernels import threefry_normal as tn
    from repro_torch.kernels import tiled_matmul as tm
    from repro_torch.kernels import topk_threshold as tk
    from repro_torch.launch import fed_serve, mesh

    job = json.loads(pathlib.Path(job_file).read_text())
    mesh.init_from_env("cuda")
    rank, size = mesh.world()
    k = SimpleNamespace(tk=tk, tm=tm, bt=bt, fa=fa, ss=ss, tn=tn)
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
    need_exact("fig1-xl one rank", counts1, {"topk_row_threshold": xl.steps, "tiled_matmul": 0,
                                             "threefry_bits": 0})
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
            # every rank draws the fleet's keys and masks, as one process does
            want["threefry_bits"] = bits_per_round(
                problems.cells(e)[c], len(DNN_STACKS) if dnn else 0) * cellobj.steps
            if one_counts["threefry_bits"] != want["threefry_bits"]:
                raise AssertionError(f"{name} (one process): {one_counts['threefry_bits']} "
                                     f"bits-path launches, want {want['threefry_bits']}")
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
        need_rank_launches("cohort-smoke", co, {
            "topk_row_threshold": smoke.cell("BL2").steps,
            "threefry_bits": bits_per_round(problems.COHORT_SMOKE) * smoke.cell("BL2").steps})
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
    need_rank_launches("fig1-xl", ex, {"topk_row_threshold": SHARDED_XL_STEPS,
                                       "threefry_bits": 0})
    need_rank_launches("fig1-xl exact=False", ring, {"topk_row_threshold": SHARDED_XL_STEPS,
                                                     "threefry_bits": 0})
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
    xxl_cell = problems.FIG1_XXL["BL2"]
    need_rank_launches("fig1-xxl", xxl, {"topk_row_threshold": xxl_cell.steps,
                                         "threefry_bits": bits_per_round(xxl_cell)
                                         * xxl_cell.steps})
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


def lm_serve_phases(torch, k, fa, ss, profile: bool) -> tuple:
    """Phases 10–12: kernels 5 and 6 against their plain versions and timed,
    then each serve cell of `SERVE_CELLS` and the reduced check of each
    config of `REDUCED_ONLY`; returns (attention phase, SSD phase, serve
    results by arch)."""
    ka = attention_kernel_phase(torch, fa)
    emit({"phase": "kernels_attn", "kernel": "flash_attention", **ka})
    ks = ssd_kernel_phase(torch, ss)
    emit({"phase": "kernels_ssd", "kernel": "ssd_scan", **ks})
    serve_res = {}
    for arch, shape, steps, layers in SERVE_CELLS:
        t0 = time.perf_counter()
        serve_res[arch] = serve_cell(torch, k, drive, arch, shape, steps, layers, profile)
        serve_res[arch]["phase_s"] = time.perf_counter() - t0
        emit({"phase": f"serve-{arch.split('_')[0]}", **serve_res[arch]})
    for arch in REDUCED_ONLY:
        serve_res[arch] = {"reduced": serve_reduced_check(torch, k, drive, arch)}
        emit({"phase": f"serve-{arch.split('_')[0]}", **serve_res[arch]})
    return ka, ks, serve_res


#: phase lm_sharded: the LM's sharded path (`repro_torch.sharding`), ranks
#: sharing the card through gloo (`tests/torch_lm_sharded_worker.py`), held
#: to the one-process port on the card from the same weights and inputs.
#: Every cell is float32 and full width, cut in depth for time: gloo carries
#: every collective through host memory at ~0.7 GB/s a rank (PERF.md §6),
#: and FSDP gathers each expert weight every step.  deepseek-moe-16b keeps
#: LM_DEEPSEEK_LAYERS of its 28 layers (~1.2 GB of expert weights gathered
#: a layer and a step, ~9 s a layer for the prefill and 4 decode steps),
#: decodes LM_DEEPSEEK_DECODE steps (cut from 4 to keep the script near its
#: time when the train cells of all ten configs came in) and skips the
#: serve rerun; gemma3-4b its first 6 (5 window-1024 layers and
#: its global one); mamba2-370m LM_MAMBA_LAYERS of 48 (~1 GB of collectives
#: a layer a rank a step); the reduced deepseek-moe trains 4 × 1024 tokens.
#: Each cell: (name, mesh, worker case)
LM_DEEPSEEK_LAYERS = 8
LM_DEEPSEEK_DECODE = 2
LM_MAMBA_LAYERS = 12
LM_SHARDED = (
    ("deepseek-moe-16b/prefill@2x2", (2, 2),
     dict(kind="serve", arch="deepseek_moe_16b", reduced=False, layers=LM_DEEPSEEK_LAYERS, B=2,
          S=4096, max_seq=4100, gen=LM_DEEPSEEK_DECODE, routes=True, rerun=False)),
    ("deepseek-moe-reduced/train@2x2", (2, 2),
     dict(kind="train", arch="deepseek_moe_16b", B=4, S=1024, steps=2, remat=False)),
    ("mamba2-370m/train@2x2", (2, 2),
     dict(kind="train", arch="mamba2_370m", reduced=False, layers=LM_MAMBA_LAYERS, B=8, S=4096,
          steps=2, remat=True, keep_grads=0)),   # cut from 3 to fit phase fed-lm
    ("gemma3-4b/prefill@1x3", (1, 3),
     dict(kind="serve", arch="gemma3_4b", reduced=False, layers=6, B=1, S=3072, max_seq=3078,
          gen=4)),
)
#: the sharded cells against the one-process port on the card: logits share
#: of max|ref|, losses relative, step-0 gradients share of each leaf's max
LM_SHARDED_TOL = {"logits": 2e-4, "loss": 1e-5, "grad": 1e-4}
LM_SHARDED_TIMEOUT = 600
#: a train cell's control: the one-process port run again from its weights
#: under a relative perturbation of LM_PERTURBATION (about float32's unit
#: roundoff), its step-0 gradients' and its steps' losses' distance from
#: the unperturbed run.  The sharded path reorders float32 sums, so its
#: distance is held to LM_CONTROL_FACTOR times the control's (the control is
#: one random draw), or to LM_SHARDED_TOL where that is larger.  The float64
#: witness in `tests/test_torch_lm_sharded.py` shows the gap is rounding:
#: in float64 the sharded gradient is the one-process one to ~1e-13 at
#: mamba2-370m's full depth.
LM_PERTURBATION = 1e-7
LM_CONTROL_FACTOR = 2.0
#: each mesh's first case: the all-to-all reductions against the n-copy
#: form, bitwise, on CUDA tensors through gloo (`torch_lm_sharded_worker`)
LM_REDUCTIONS = {"name": "reductions", "kind": "reductions", "dtypes": ["float32", "bfloat16"]}
#: the kernels the sharded path launches
LM_SHARDED_KERNELS = ("flash_attention", "flash_attention_bwd", "ssd_scan", "ssd_scan_bwd",
                      "threefry_normal")


def lm_worker():
    """`tests/torch_lm_sharded_worker.py`, the ranks' script, as a module:
    its `case_config` builds a cell's config for the one-process port as
    the ranks build it."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "torch_lm_sharded_worker", ROOT / "tests" / "torch_lm_sharded_worker.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def lm_cell_inputs(cfg, case: dict) -> dict:
    import numpy as np

    rng = np.random.default_rng(17)
    S = case["S"] + (1 if case["kind"] == "train" else 0)
    return {"tokens": rng.integers(0, cfg.vocab_size, (case["B"], S)).astype(np.int32)}


def lm_one_process(torch, cfg, case: dict, inputs: dict, mesh: tuple) -> dict:
    """The one-process port on the card from the cell's weights and inputs:
    a serve cell's prefill (on each data shard's rows where the MoE is
    expert-parallel, as the sharded path defines it) and greedy decode, its
    routes; a train cell's step-0 loss and gradients (host copies) and its
    AdamW steps' losses (the mean of the data shards' gradients where
    expert-parallel), and the control: the same from weights perturbed by
    LM_PERTURBATION."""
    from repro_torch.core import prng
    from repro_torch.launch import serve
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.optim import adamw_init, adamw_update

    B = case["B"]
    ep = (cfg.moe is not None and cfg.moe.n_experts % mesh[1] == 0
          and B * case["S"] >= 4096)
    shards = mesh[0] if ep else 1
    n = B // shards
    params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cuda")
    toks = torch.as_tensor(inputs["tokens"], device="cuda")
    out = {}
    if case["kind"] == "serve":
        routes, route = [], L.moe_route

        def recorded(probs, k):
            vals, ids = route(probs, k)
            routes.append((probs.float().cpu().numpy(), ids.cpu().numpy()))
            return vals, ids
        pres = []
        L.moe_route = recorded
        try:
            for s in range(shards):
                cache = M.init_cache(cfg, n, case["max_seq"], torch.float32, device="cuda")
                pres.append(serve.prefill(params, cfg, toks[s * n:(s + 1) * n], cache))
                out[f"routes{s}"] = list(routes)
                routes.clear()
        finally:
            L.moe_route = route
        cache = {li: {key: torch.cat([p["cache"][li][key] for p in pres], 1)
                      for key in pres[0]["cache"][li]} for li in pres[0]["cache"]}
        token = torch.cat([p["token"] for p in pres])
        dec = serve.decode(params, cfg, token, cache, case["S"], case["gen"])
        out.update(prefill=torch.cat([p["logits"] for p in pres]).float().cpu().numpy(),
                   steps=[lg.float().cpu().numpy() for lg in dec["logits"]],
                   tokens=torch.cat([token[:, None], dec["tokens"]], 1).cpu().numpy(),
                   prefill_s=sum(p["seconds"] for p in pres), decode_s=dec["seconds"])
        return out
    grad_fn = steps.make_grad_fn(cfg, remat=case.get("remat", False))

    def grads_of(p):
        parts = [grad_fn(p, {"tokens": toks[s * n:(s + 1) * n]}) for s in range(shards)]
        g = parts[0][2]
        for _, _, gi in parts[1:]:
            g = _tree_add(g, gi)
        if shards > 1:
            g = _tree_map(lambda a: a / shards, g)
        return sum(float(x[0]) for x in parts) / shards, g

    def train(p):
        opt, losses, step_s = adamw_init(p, torch.float32), [], []
        for _ in range(case["steps"]):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, g = grads_of(p)
            p, opt = adamw_update(g, opt, p, lr=3e-4)
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            losses.append(loss)
            del g
        return losses, step_s

    loss, g = grads_of(params)
    out.update(loss=loss, grads=_tree_map(lambda t: t.float().cpu().numpy(), g))
    del g
    # the control (LM_PERTURBATION): every float weight perturbed, the
    # gradient's worst leaf's distance (share of the leaf's max) and the
    # steps' losses' relative distances from the unperturbed run
    gen = torch.Generator(device="cuda").manual_seed(0)
    noisy = _tree_map(lambda t: t * (1 + LM_PERTURBATION * torch.randn(
        t.shape, generator=gen, device="cuda")) if t.is_floating_point() else t, params)
    want = dict(_leaves(out["grads"]))
    out["perturbed_grad_rel_err"] = max(
        float(abs(g.float().cpu().numpy() - want[path]).max()
              / max(abs(want[path]).max(), 1e-30))
        for path, g in _leaves(grads_of(noisy)[1]))
    noisy_losses, _ = train(noisy)
    del noisy
    losses, step_s = train(params)
    out.update(losses=losses, step_s=step_s, perturbed_losses_rel_err=[
        abs(a - b) / abs(b) for a, b in zip(noisy_losses, losses)])
    return out


def _tree_add(a: dict, b: dict) -> dict:
    return {key: _tree_add(v, b[key]) if isinstance(v, dict) else v + b[key]
            for key, v in a.items()}


def run_lm_ranks(mesh: tuple, cases: list, tmp: pathlib.Path, timeout: float) -> dict:
    """Start data·model ranks of `tests/torch_lm_sharded_worker.py` on the
    one card (gloo: the ranks share it) with `cases`; every rank must exit 0
    within `timeout` seconds (collectives time out sooner), or the phase
    fails and every rank still running is killed.  Returns {rank: results}."""
    import pickle

    tag = "x".join(map(str, mesh))
    out = tmp / f"out{tag}"
    out.mkdir()
    job = tmp / f"job{tag}.json"
    job.write_text(json.dumps({"data": mesh[0], "model": mesh[1], "device": "cuda",
                               "inputs": str(tmp), "out": str(out), "cases": cases}))
    world, port = mesh[0] * mesh[1], _free_port()
    procs, logs = [], []
    try:
        for r in range(world):
            env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), MASTER_ADDR="localhost",
                       MASTER_PORT=str(port), RANK=str(r), LOCAL_RANK=str(r),
                       WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                       OMP_NUM_THREADS="2", REPRO_DIST_TIMEOUT_S=str(int(timeout / 2)))
            logs.append(open(out / f"rank{r}.log", "w"))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "tests" / "torch_lm_sharded_worker.py"), str(job)],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
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
        raise AssertionError(f"lm_sharded ranks failed (rank: exit code) {bad}: {tails}")
    return {r: pickle.loads((out / f"rank{r}.pkl").read_bytes())["results"]
            for r in range(world)}


def route_diff(got: list, want: list) -> dict:
    """Each MoE layer's (probabilities, expert ids) of the sharded prefill
    against the one-process port's: the tokens routed otherwise, and for
    each the gap between the one-process probabilities of the experts that
    differ (over the row's largest), the first layer that differs, and
    there the router's drift, the largest distance between the two paths'
    probabilities (over the row's largest).  Up to that layer the paths'
    inputs differ only by the order of float32 sums, so the drift is their
    rounding; ``ties`` is whether every token routed otherwise there has a
    gap within LM_CONTROL_FACTOR times it (a near-tie the rounding flips).
    Past it the inputs differ by a route (capacity, attention), so later
    layers are counted, not judged."""
    import numpy as np

    out = {"moe_layers": len(want), "tokens_routed_otherwise": 0, "first_layer": None,
           "gaps": [], "drift": None, "ties": True}
    for layer, ((p_got, ids), (probs, ref_ids)) in enumerate(zip(got, want)):
        # a token's experts as a set: their order does not enter its output
        ids, ref_ids = np.sort(ids, axis=-1), np.sort(ref_ids, axis=-1)
        bad = np.nonzero((ids != ref_ids).any(axis=-1))[0]
        out["tokens_routed_otherwise"] += int(bad.size)
        if not bad.size:
            continue
        first = out["first_layer"] is None
        if first:
            out["first_layer"] = layer
            out["drift"] = float((np.abs(p_got - probs).max(axis=-1)
                                  / probs.max(axis=-1)).max())
        for t in bad[:8] if not first else bad:
            a = sorted(set(ids[t].tolist()) ^ set(ref_ids[t].tolist()))
            p = probs[t]
            gap = float((p[a].max() - p[a].min()) / p.max())
            out["gaps"].append([layer, int(t), gap])
            if first and gap > LM_CONTROL_FACTOR * out["drift"]:
                out["ties"] = False
    return out


def _rel(got, want) -> float:
    import numpy as np

    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _lm_sharded_launches(lms: dict, kernel: str) -> dict:
    """A kernel's launches on each rank in phase lm_sharded's cells, where
    it ran: {cell: [rank 0's, rank 1's, ...]}."""
    out = {}
    for name, rec in lms["cells"].items():
        counts = [rec["launches_by_rank"][r][kernel] for r in sorted(rec["launches_by_rank"])]
        if any(counts):
            out[name] = counts
    return out


def lm_sharded_phase(torch, smi: str) -> dict:
    """The LM's sharded cells (LM_SHARDED): the one-process port first on
    the card (kept on the host, freed), then the ranks, two launches (the
    (2, 2) and the (1, 3) mesh), each case with the kernels' counts set to 0
    just before it and read just after.  A serve cell's gathered logits
    within LM_SHARDED_TOL of the one-process port's, greedy tokens equal,
    each data shard's expert ids equal or first differing at rounding ties
    (`route_diff`), ranks holding the same rows equal bitwise, a rerun
    bitwise; a train cell's step-0 loss and each gradient
    leaf and its steps' losses within LM_SHARDED_TOL or LM_CONTROL_FACTOR
    times the control's distance, whichever is larger, every rank's bits
    alike, a rerun bitwise.  Fails if a kernel of the path (5, 5b, 6, 6b,
    7) was launched no time.  Gloo moves every collective through host
    memory: the seconds are a check's, not the path's speed."""
    import shutil
    import tempfile

    import numpy as np

    tmp = pathlib.Path(tempfile.mkdtemp(prefix="lm_sharded_"))
    out = {}
    try:
        refs, jobs, worker = {}, {}, lm_worker()
        for name, mesh, case in LM_SHARDED:
            cfg = worker.case_config(case)
            inputs = lm_cell_inputs(cfg, case)
            fname = name.replace("/", "_").replace("@", "_") + ".npz"
            np.savez(tmp / fname, **inputs)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            refs[name] = lm_one_process(torch, cfg, case, inputs, mesh)
            refs[name]["ref_s"] = time.perf_counter() - t0
            emit({"phase": "lm_sharded", "one_process": name, "seconds": refs[name]["ref_s"]})
            refs[name]["ref_peak_bytes"] = torch.cuda.max_memory_allocated()
            jobs.setdefault(mesh, []).append(dict(case, name=name, inputs=fname))
        t0 = time.perf_counter()
        ranks = {}
        for mesh, cases in jobs.items():
            t1 = time.perf_counter()
            ranks[mesh] = run_lm_ranks(mesh, [LM_REDUCTIONS] + cases, tmp, LM_SHARDED_TIMEOUT)
            emit({"phase": "lm_sharded", "ranks": list(mesh),
                  "seconds": time.perf_counter() - t1,
                  "case_s": {n: ranks[mesh][0][n]["case_s"] for n in ranks[mesh][0]}})
        ranks_s = time.perf_counter() - t0
        reductions = {"x".join(map(str, mesh)): check_reductions(mesh, r)
                      for mesh, r in ranks.items()}
        emit({"phase": "lm_sharded", "reductions": reductions})
        for name, mesh, case in LM_SHARDED:
            res = {r: v[name] for r, v in ranks[mesh].items()}
            ref = refs[name]
            rec = {"mesh": list(mesh), "ranks": len(res), "card": smi,
                   "launches_by_rank": {r: v["launches"] for r, v in res.items()},
                   "case_s_by_rank": {r: v["case_s"] for r, v in res.items()},
                   "peak_bytes_by_rank": {r: v["peak_bytes"] for r, v in res.items()},
                   "one_process_s": ref["ref_s"], "one_process_peak_bytes": ref["ref_peak_bytes"]}
            if case["kind"] == "serve":
                B = case["B"]
                rows = [None] * B
                for v in res.values():
                    s0, nrow = v["rows"]
                    for i in range(nrow):
                        got = (v["prefill"][i], [st[i] for st in v["steps"]], v["tokens"][i])
                        if rows[s0 + i] is None:
                            rows[s0 + i] = got
                        elif not (np.array_equal(got[0], rows[s0 + i][0]) and all(
                                np.array_equal(a, b) for a, b in zip(got[1], rows[s0 + i][1]))):
                            raise AssertionError(f"lm_sharded {name}: ranks holding row "
                                                 f"{s0 + i} differ")
                pre = np.stack([r[0] for r in rows])
                steps_ = [np.stack([r[1][t] for r in rows]) for t in range(case["gen"])]
                toks = np.stack([r[2] for r in rows])
                errs = [_rel(pre, ref["prefill"])] + [_rel(a, b) for a, b in
                                                       zip(steps_, ref["steps"])]
                if max(errs) > LM_SHARDED_TOL["logits"]:
                    raise AssertionError(f"lm_sharded {name}: logits off the one-process "
                                         f"port by {errs} of max|ref|")
                if not np.array_equal(toks, ref["tokens"]):
                    raise AssertionError(f"lm_sharded {name}: greedy tokens differ")
                if case.get("routes"):
                    rec["routes"] = {}
                    for r, v in res.items():
                        s = v["rows"][0] // v["rows"][1]
                        rec["routes"][r] = route_diff(v["routes"], ref[f"routes{s}"])
                    bad = {r: d for r, d in rec["routes"].items() if not d["ties"]}
                    if bad:
                        raise AssertionError(f"lm_sharded {name}: expert ids differ from the "
                                             f"one-process port's past a rounding tie "
                                             f"(by rank) {bad}")
                if not all(v.get("rerun_equal", True) for v in res.values()):
                    raise AssertionError(f"lm_sharded {name}: a rerun's logits differ")
                rec["dryrun_window"] = {"stats": res[0]["prefill_step_stats"],
                                        "peak_bytes": res[0]["prefill_peak_bytes"],
                                        **res[0]["prefill_window"]}
                rec.update(logits_rel_err=errs, tokens=toks.tolist(),
                           prefill_s=max(v["prefill_s"] for v in res.values()),
                           decode_s=max(v["decode_s"] for v in res.values()),
                           prefill_collectives=res[0]["prefill_stats"],
                           decode_collectives=res[0]["decode_stats"],
                           one_process_prefill_s=ref["prefill_s"],
                           one_process_decode_s=ref["decode_s"])
            else:
                r0 = res[0]
                loss_rel = abs(r0["loss"] - ref["loss"]) / abs(ref["loss"])
                grad, want = {}, dict(_leaves(ref["grads"]))
                for path, g in _leaves(r0["grads"]):
                    w = want[path]
                    grad[path] = float(np.abs(g - w).max() / max(np.abs(w).max(), 1e-30))
                worst = max(grad, key=grad.get)
                losses_rel = [abs(a - b) / abs(b) for a, b in zip(r0["losses"], ref["losses"])]
                gate = {"grad": max(LM_SHARDED_TOL["grad"],
                                    LM_CONTROL_FACTOR * ref["perturbed_grad_rel_err"]),
                        "loss": max(LM_SHARDED_TOL["loss"],
                                    LM_CONTROL_FACTOR * max(ref["perturbed_losses_rel_err"]))}
                if (max([loss_rel] + losses_rel) > gate["loss"]
                        or grad[worst] > gate["grad"]):
                    raise AssertionError(f"lm_sharded {name}: loss {loss_rel}, losses "
                                         f"{losses_rel}, gradient {worst} {grad[worst]} off "
                                         f"the one-process port, over the gates {gate}")
                if len({v["digest"] for v in res.values()}) != 1 or not all(
                        v["rerun_equal"] and v["losses"] == r0["losses"] for v in res.values()):
                    raise AssertionError(f"lm_sharded {name}: ranks or reruns differ")
                rec["dryrun_window"] = {"stats": r0["step0_stats"],
                                        "peak_bytes": r0["step0_peak_bytes"],
                                        **r0["step0_window"]}
                rec.update(loss=r0["loss"], loss_rel_err=loss_rel, losses=r0["losses"],
                           losses_rel_err=losses_rel, worst_grad_leaf=worst,
                           worst_grad_rel_err=grad[worst],
                           s_per_step=float(np.median(r0["step_s"])),
                           step_s_by_rank={r: v["step_s"] for r, v in res.items()},
                           one_process_s_per_step=float(np.median(ref["step_s"])),
                           one_process_perturbed_grad_rel_err=ref["perturbed_grad_rel_err"],
                           one_process_perturbed_losses_rel_err=ref["perturbed_losses_rel_err"],
                           gates=gate,
                           grad_collectives=r0["stats"], step_collectives=r0["step_stats"])
            out[name] = rec
            emit({"phase": "lm_sharded", "cell": name, **rec})
        total = {kname: sum(c[kname] for rec in out.values()
                            for c in rec["launches_by_rank"].values())
                 for kname in LM_SHARDED_KERNELS}
        missing = [kname for kname, n in total.items() if not n]
        if missing:
            raise AssertionError(f"lm_sharded: the path launched no {missing}")
        return {"cells": out, "launches": total, "ranks_s": ranks_s, "reductions": reductions}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def check_reductions(mesh: tuple, ranks: dict) -> dict:
    """Each rank's ``reductions`` case (`LM_REDUCTIONS`): every all-to-all
    reduction bitwise the n-copy form, and counted as |x| (reduce-scatter)
    or 2·|x| padded to a multiple of n (all-reduce).  Returns the checks a
    rank by n."""
    import numpy as np

    sizes = dict(zip(("data", "model"), mesh))
    by_n = {}
    for r, res in ranks.items():
        for (axes, kind, dtype, shape, dim), (equal, moved, size) in res["reductions"][
                "checks"].items():
            n = math.prod(sizes[a] for a in axes)
            if kind == "reduce_scatter":
                want = size
            else:
                numel = int(np.prod(shape))
                want = 2 * (-(-numel // n) * n) * (size // numel)
            if not equal or moved != want:
                raise AssertionError(f"lm_sharded {mesh} rank {r}: {kind} over {axes} "
                                     f"({dtype}, {shape}, dim {dim}): bitwise the n-copy "
                                     f"form {equal}, {moved} bytes counted, want {want}")
            if r == 0:
                by_n[n] = by_n.get(n, 0) + 1
    return {"checks_a_rank_by_n": by_n, "ranks": len(ranks), "bitwise": True}


#: phase dryrun: `repro_torch.launch.dryrun` in DRYRUN_PROCS processes of
#: its own (`--dryrun-worker`), started after the build and read after
#: phase lm_sharded.  They run on the host alone (fake tensors on the CPU,
#: torch's fake process group; CUDA_VISIBLE_DEVICES is empty, niced): each
#: LM_SHARDED cell at its mesh, depth, type and sizes, whose collective
#: calls and bytes by kind must equal rank 0's measured ones exactly, its
#: argument bytes rank 0's arguments', and its peak (arguments + temp) lie
#: within DRYRUN_PEAK_BAND of rank 0's measured peak over the same window,
#: less the bytes the process held at the window's start beyond the step's
#: arguments (the 64 MiB of cuBLAS workspaces an earlier product made: in
#: the reduced deepseek train's ~160 MB window they alone would read 0.58);
#: and `--all` on the (16, 16) mesh (the reference's four shapes for every
#: config), each case ok or skipped, its peak beside the card's memory.
DRYRUN_PROCS = 4
DRYRUN_PEAK_BAND = (0.75, 1.25)
DRYRUN_TIMEOUT_S = 900


def dryrun_jobs() -> list:
    """The phase's dry runs: the sharded cells, then every (config, shape)
    of ``--all`` on (16, 16)."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import ARCH_IDS
    from repro_torch.launch.dryrun import REFERENCE_SHAPES

    return [("cell", name) for name, _, _ in LM_SHARDED] + [
        ("all", arch, shape) for arch in ARCH_IDS for shape in REFERENCE_SHAPES]


def dryrun_share(jobs: list, parts: int) -> list:
    """`jobs` dealt to `parts` processes, the costliest first to the least
    loaded (cost: a train step 4, another step 1, times the config's
    layers)."""
    from repro_torch.configs import get_config

    def cost(job):
        if job[0] == "cell":
            case = next(c for n, _, c in LM_SHARDED if n == job[1])
            return 4 * (case.get("layers") or 4)
        return (4 if job[2] == "train_4k" else 1) * get_config(job[1]).n_layers
    load, out = [0] * parts, [[] for _ in range(parts)]
    for job in sorted(jobs, key=cost, reverse=True):
        i = load.index(min(load))
        load[i] += cost(job)
        out[i].append(job)
    return out


def dryrun_worker(out_path: str, part: str, parts: str) -> int:
    """`--dryrun-worker OUT PART PARTS`: this process's share of the
    phase's dry runs, their records written to OUT (a case that raises is
    recorded with status ``error``)."""
    import traceback

    import torch
    from repro_torch.launch import dryrun
    from repro_torch.launch.shapes import InputShape

    torch.set_num_threads(1)
    worker = lm_worker()
    res = {}
    for job in dryrun_share(dryrun_jobs(), int(parts))[int(part)]:
        t0 = time.perf_counter()
        key = job[1] if job[0] == "cell" else f"{job[1]}/{job[2]}"
        try:
            if job[0] == "cell":
                name, mesh, case = next(c for c in LM_SHARDED if c[0] == job[1])
                kind = "train" if case["kind"] == "train" else "prefill"
                rec = dryrun.dry_run(worker.case_config(case),
                                     InputShape(name, case["S"], case["B"], kind), mesh,
                                     dtype=torch.float32, remat=case.get("remat", True),
                                     max_seq=case.get("max_seq"))
            else:
                rec = dryrun.lower_case(job[1], job[2])
        except Exception as e:
            rec = {"status": "error", "error": f"{type(e).__name__}: {e}",
                   "trace": traceback.format_exc()[-2000:]}
        res[key] = dict(rec, seconds=time.perf_counter() - t0)
    pathlib.Path(out_path).write_text(json.dumps(res))
    return 0


def start_dryrun(tmp: pathlib.Path) -> list:
    """Start the phase's DRYRUN_PROCS processes on the host; returns
    [(process, its output file, its log)]."""
    import atexit

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    procs = []
    for part in range(DRYRUN_PROCS):
        log = open(tmp / f"dryrun{part}.log", "w")
        out = tmp / f"dryrun{part}.json"
        procs.append((subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dryrun-worker", str(out),
             str(part), str(DRYRUN_PROCS)], env=env, stdout=log, stderr=subprocess.STDOUT,
            preexec_fn=lambda: os.nice(19)), out, log))

    def stop():
        for p, _, log in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    atexit.register(stop)
    return procs


#: (B, S, H, hd, N) of kernel 6's calls and (B, Sq, H) of kernel 5b's whose
#: workspaces the fake-tensor routes must size as the libraries do: the
#: mamba2 cells (a rank's 4 × 4096 at 16 heads; one card's 8 × 4096 at 32),
#: a tail chunk; the gemma3 slice and train layer, a padded row count
DRYRUN_SSD_WORKSPACES = ((4, 4096, 16, 64, 128), (8, 4096, 32, 64, 128), (1, 300, 3, 16, 8))
DRYRUN_ATTN_WORKSPACES = ((1, 1024, 8), (1, 4096, 8), (2, 130, 4))
#: (bfloat16, B, Sk, H, KVH, hd) of kernel 5b's partial sums
DRYRUN_ATTN_PARTIALS = ((1, 1, 4096, 48, 1, 128), (1, 2, 130, 4, 4, 64), (0, 1, 1024, 8, 4, 256))


def fake_workspaces() -> dict:
    """The fake-tensor routes' workspace sizes (`kernels._fake`) against
    the built libraries' at DRYRUN_*_WORKSPACES; raises on a difference."""
    from repro_torch.kernels import _build, _fake

    sizes, ll = (ctypes.c_int,) * 5, ctypes.c_longlong
    lib = {"ssd": _build.bind("ssd_scan", "ssd_scan_workspace_floats", sizes, ll),
           "ssd_bwd_forward": _build.bind("ssd_scan_bwd",
                                          "ssd_scan_bwd_forward_workspace_floats", sizes, ll),
           "ssd_bwd": _build.bind("ssd_scan_bwd", "ssd_scan_bwd_workspace_floats", sizes, ll),
           "attn_bwd": _build.bind("flash_attention_bwd", "flash_attention_bwd_workspace_floats",
                                   (ctypes.c_int,) * 3, ll),
           "attn_bwd_partial": _build.bind("flash_attention_bwd",
                                           "flash_attention_bwd_partial_floats",
                                           (ctypes.c_int,) * 6, ll)}
    pairs = []
    for shape in DRYRUN_SSD_WORKSPACES:
        pairs += [("ssd", shape, _fake.ssd_workspace_floats(*shape)),
                  ("ssd_bwd_forward", shape, _fake.ssd_workspace_floats(*shape)),
                  ("ssd_bwd", shape, _fake.ssd_bwd_workspace_floats(*shape))]
    pairs += [("attn_bwd", shape, _fake.attention_bwd_workspace_floats(*shape))
              for shape in DRYRUN_ATTN_WORKSPACES]
    pairs += [("attn_bwd_partial", shape, _fake.attention_bwd_partial_floats(*shape))
              for shape in DRYRUN_ATTN_PARTIALS]
    out = {}
    for name, shape, fake in pairs:
        got = lib[name](*shape)
        if got != fake:
            raise AssertionError(f"dryrun: {name} workspace at {shape}: the library's {got} "
                                 f"floats, the fake route's {fake}")
        out[f"{name}{list(shape)}"] = got
    return out


def dryrun_phase(torch, smi: str, lms: dict, procs: list, started: float) -> dict:
    """Phase dryrun's checks (see DRYRUN_PROCS) on the records of the
    processes `start_dryrun` started at `started` (a perf_counter time),
    after the fake routes' workspace sizes against the libraries'."""
    emit({"phase": "dryrun", "workspace_floats": fake_workspaces()})
    deadline = started + DRYRUN_TIMEOUT_S
    res = {}
    for p, out, log in procs:
        try:
            p.wait(timeout=max(deadline - time.perf_counter(), 1.0))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
        log.flush()
        if p.returncode != 0:
            raise AssertionError(f"dryrun: a process exited {p.returncode}: "
                                 f"{pathlib.Path(log.name).read_text()[-3000:]}")
        res.update(json.loads(out.read_text()))
    bad = {key: r["error"] for key, r in res.items() if r["status"] not in ("ok", "skipped")}
    if bad:
        raise AssertionError(f"dryrun: cases that did not run: {bad}")
    cells = {}
    for name, mesh, case in LM_SHARDED:
        d, w = res[name], lms["cells"][name]["dryrun_window"]
        counts = {k: v["calls"] for k, v in w["stats"].items()}
        nbytes = {k: float(v["bytes"]) for k, v in w["stats"].items()}
        if d["collectives"]["counts"] != counts or d["collectives"]["bytes_by_kind"] != nbytes:
            raise AssertionError(f"dryrun {name}: collectives {d['collectives']} where rank 0 "
                                 f"counted {w['stats']}")
        args = d["memory"]["argument_size_bytes"]
        if args != w["args_bytes"]:
            raise AssertionError(f"dryrun {name}: argument bytes {args}, rank 0's arguments "
                                 f"{w['args_bytes']}")
        pred = args + d["memory"]["temp_size_bytes"]
        # bytes held at the window's start that are not the step's (cuBLAS's
        # workspaces, made at an earlier product of the process)
        held = w["base_bytes"] - w["args_bytes"]
        ratio = pred / (w["peak_bytes"] - held)
        cells[name] = {"mesh": list(mesh), "predicted_peak_bytes": pred,
                       "measured_peak_bytes": w["peak_bytes"], "held_before_bytes": held,
                       "ratio": ratio, "ratio_with_held": pred / w["peak_bytes"],
                       "argument_bytes": args, "collectives": d["collectives"],
                       "flops": d["cost"]["flops"], "seconds": d["seconds"], "card": smi}
        emit({"phase": "dryrun", "cell": name, **cells[name]})
        lo, hi = DRYRUN_PEAK_BAND
        if not lo <= ratio <= hi:
            raise AssertionError(f"dryrun {name}: predicted peak {pred} is {ratio} of the "
                                 f"measured {w['peak_bytes']} less the {held} bytes held "
                                 f"before the step, outside {DRYRUN_PEAK_BAND}")
    total = torch.cuda.get_device_properties(0).total_memory
    cases = {}
    for key, r in res.items():
        if "/" not in key or key in cells:
            continue
        line = {"case": key, "status": r["status"], "seconds": r["seconds"],
                "card_memory_bytes": total}
        if r["status"] == "ok":
            peak = r["memory"]["argument_size_bytes"] + r["memory"]["temp_size_bytes"]
            line.update(peak_bytes=peak, fits=peak <= total,
                        collective_bytes=r["collectives"]["total_bytes"],
                        flops=r["cost"]["flops"], model_flops=r["cost"]["model_flops"])
        cases[key] = line
        emit({"phase": "dryrun", "mesh": "16x16", **line})
    return {"cells": cells, "cases": cases,
            "seconds": max(r["seconds"] for r in res.values()),
            "wall_s": time.perf_counter() - started}


# ==========================================================================
# fed-lm: the paper's BL-DNN on a language model (examples/torch_train_lm.py
# --fed), the per-client gradients through torch.func.vmap(grad)
# ==========================================================================
#: rounds of each run (the script's 300 cut to 4)
FED_LM_ROUNDS = 4
#: the reduced check's LM: 2 layers, d 64, 4 query heads on 2 KV heads, vocab
#: 512; each client 2 sequences of 33 tokens
FED_LM_REDUCED = dict(name="lm-reduced", n_layers=2, d_model=64, n_heads=4, n_kv_heads=2,
                      d_ff=128, vocab_size=512, max_seq=64)
FED_LM_REDUCED_SIZES = (2, 32)
#: lm-100m's batch and sequence a client (the script's defaults)
FED_LM_SIZES = (8, 256)
FED_LM_LR = 3e-4
#: lm-100m's parameters (the script's preset)
FED_LM_PARAMS = 125_848_320
#: card against the CPU: the train phase's gates (gradients a leaf, losses
#: relative)
FED_LM_TOL = TRAIN_TOL
#: kernels 1 and 2 at the path's rows: (T, k, leaf) of the largest leaves
#: (embed, unembed: 32768 × 768 and k = 5 %) and the smallest (final_norm)
FED_LM_TOPK = ((25_165_824, 1_258_291, "embed"), (768, 38, "final_norm"))
#: kernels 5 and 5b at the path's shape: the 2 clients' 8 sequences folded
#: into one batch axis, (B, S, H, KVH, hd), causal, float32
FED_LM_ATTN = (16, 256, 12, 4, 64)
#: the features of examples/torch_bl_finetune_head.py, card against the CPU
FINETUNE_FEATURE_TOL = 1e-5


def load_example(name: str):
    """A script of `examples/`, loaded by path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def fed_lm_bits(cfg, rounds: int, top_k_frac: float = 0.05) -> dict:
    """The legs' cumulative bit streams of `rounds` BL-DNN rounds of `cfg`
    (one client's), priced on the CPU from the leaves' shapes alone: each
    leaf's Top-K (k = max(1, ⌊frac·numel⌋) floats and indices at the f32
    wire) on ``grad_up`` and ``hess_up`` every round, and one dense f32
    shipment of every rotated leaf's U (rows²) and V (cols²) on
    ``basis_shipment`` at round 0 (`comm.price`)."""
    import torch
    from repro_torch.core import comm
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.fed import bldnn
    from repro_torch.models import model as M

    shapes = M.param_shapes(cfg, torch.float32)
    leaves = tree_leaves(shapes)
    per_round = 0.0
    for c, p in zip(bldnn.leaf_compressors("topk", top_k_frac, shapes), leaves):
        kk = torch.full((1,), float(min(c.k, p.numel())), dtype=torch.float64)
        per_round += float(comm.price(comm.with_float_bits(c.wire, 32),
                                      comm.Counts(floats=kk, indices=kk))[0])
    ship = comm.BasisShipSpec()
    shipment = sum(float(comm.price(ship.wire, ship.factor_counts(r, r)))
                   for p in leaves if p.dim() == 2 and min(p.shape) >= 2 for r in p.shape)
    return {"grad_up": [t * per_round for t in range(rounds)],
            "hess_up": [t * per_round for t in range(rounds)],
            "model_down": [0.0] * rounds, "basis_ship": [shipment] * rounds}


def check_fed_bits(name: str, hist, want: dict) -> dict:
    """Every leg's stream and the uplink exactly `want`'s (`fed_lm_bits`)."""
    got = {leg: list(map(float, stream)) for leg, stream in hist.legs.items()}
    up = [want["grad_up"][t] + want["hess_up"][t] + want["basis_ship"][t]
          for t in range(len(want["grad_up"]))]
    if got != want or list(map(float, hist.up_bits)) != up:
        raise AssertionError(f"{name}: bit streams {got}, uplink {list(hist.up_bits)}; the "
                             f"CPU's pricing {want}, uplink {up}")
    return {"basis_ship": want["basis_ship"][0], "per_round": want["grad_up"][1:2]}


def fed_lm_counts(name: str, counts: dict, want: dict) -> None:
    """The five kernels of the path exactly as `want` says, and the GLM and
    SSM kernels not at all."""
    need_exact(name, counts, {**want, "tiled_matmul": 0, "ssd_scan": 0, "ssd_scan_bwd": 0})


def fed_lm_reduced_check(torch, k, ex) -> dict:
    """The reduced LM on the card against the CPU, from the same weights,
    batches and per-layer SVD factors: round 0's per-client gradients
    (vmap(grad), one kernel-5 and one 5b launch a layer for both clients)
    within FED_LM_TOL·max|cpu| a leaf, then FED_LM_ROUNDS rounds' losses
    within FED_LM_TOL relative, bits exact and `fed_lm_bits`', launches
    exactly `fed_lm_launches`."""
    import math

    from repro_torch.core import prng
    from repro_torch.core.basis import per_layer_svd_basis
    from repro_torch.core.client_batch import TreeBatch
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import model as M
    from repro_torch.models.config import LayerSpec, ModelConfig

    cfg = ModelConfig(group=(LayerSpec(),), **FED_LM_REDUCED)
    cpu = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cpu")
    card = _tree_map(lambda t: t.cuda(), cpu)
    Bsz, S = FED_LM_REDUCED_SIZES
    batch = ex.fed_batch(make_batch_iterator(cfg.vocab_size, S + 1, Bsz, seed=0, device="cpu"),
                         ex.n_fed_clients())
    on_card = TreeBatch(data=_tree_map(lambda t: t.cuda(), batch.data),
                        n_clients=batch.n_clients)
    basis = per_layer_svd_basis(cpu)          # one set of factors for both
    per_client = torch.func.vmap(torch.func.grad(ex.make_loss_fn(cfg)), in_dims=(None, 0))
    g_cpu = per_client(cpu, batch.data)
    g_card, _, counts = drive(torch, k, lambda: per_client(card, on_card.data))
    n_attn = cfg.n_layers
    fed_lm_counts("fed-lm reduced gradient", counts, {
        "flash_attention": n_attn, "flash_attention_bwd": n_attn, "topk_row_threshold": 0,
        "topk_compress_sum": 0, "basis_transform": 0})
    grad_rel = {}
    for (name, a), (_, b) in zip(_leaves(g_card), _leaves(g_cpu)):
        e, scale = float((a.cpu() - b).abs().max()), float(b.abs().max())
        if a.shape != b.shape or not e <= FED_LM_TOL * scale:
            raise AssertionError(f"fed-lm reduced, round-0 gradient {name}: |Δ| {e} > "
                                 f"{FED_LM_TOL}·{scale}")
        grad_rel[name] = e / scale if scale else 0.0
    h_cpu = ex.run_fed(cfg, cpu, batch, FED_LM_ROUNDS, FED_LM_LR, device="cpu", basis=basis)
    h_card, secs, counts = drive(torch, k, lambda: ex.run_fed(
        cfg, card, on_card, FED_LM_ROUNDS, FED_LM_LR, device="cuda", basis=basis))
    fed_lm_counts("fed-lm reduced run", counts, fed_lm_launches(cfg, FED_LM_ROUNDS))
    loss_rel = [abs(a - b) / abs(b) for a, b in zip(h_card.gaps, h_cpu.gaps)]
    if not (max(loss_rel) <= FED_LM_TOL and all(map(math.isfinite, h_card.gaps))):
        raise AssertionError(f"fed-lm reduced: losses card {list(h_card.gaps)}, cpu "
                             f"{list(h_cpu.gaps)}")
    want = fed_lm_bits(cfg, FED_LM_ROUNDS)
    check_fed_bits("fed-lm reduced (cpu)", h_cpu, want)
    bits = check_fed_bits("fed-lm reduced (card)", h_card, want)
    return {"config": FED_LM_REDUCED, "sizes": [batch.n_clients, Bsz, S + 1],
            "grad_max_rel": max(grad_rel.values()),
            "grad_max_rel_leaf": max(grad_rel, key=grad_rel.get),
            "losses": {"card": list(map(float, h_card.gaps)),
                       "cpu": list(map(float, h_cpu.gaps))},
            "loss_rel": loss_rel, "bits": bits, "run_s": secs, "launches": counts}


def fed_lm_full(torch, k, ex) -> tuple:
    """lm-100m at full width: the keyed init on the card, the host SVDs of
    the per-layer basis (the set-up: `per_layer_svd_basis` in this process),
    FED_LM_ROUNDS rounds through the script's `run_fed` (finite, falling
    losses; bits the CPU's pricing; launches exactly `fed_lm_launches`), a
    1-round run for s/round by differencing, a profiled round (its device
    time by kernel), round 0's loss against one CPU forward of the same
    weights and batches.  Returns the result and the embedding's and
    unembedding's (U, V) for the kernel checks."""
    import math

    from repro_torch.core import prng
    from repro_torch.core.basis import per_layer_svd_basis
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.data import make_batch_iterator
    from repro_torch.models import model as M

    cfg = ex.make_cfg("100m")
    t0 = time.perf_counter()
    params = M.init_params(prng.PRNGKey(0), cfg, torch.float32, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(p.numel() for p in tree_leaves(params))
    if n_params != FED_LM_PARAMS:
        raise AssertionError(f"lm-100m has {n_params} parameters, not {FED_LM_PARAMS}")
    Bsz, S = FED_LM_SIZES
    batch = ex.fed_batch(make_batch_iterator(cfg.vocab_size, S + 1, Bsz, seed=0,
                                             device="cuda"), ex.n_fed_clients())
    t0 = time.perf_counter()
    basis = per_layer_svd_basis(params)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    def run(rounds):
        return ex.run_fed(cfg, params, batch, rounds, FED_LM_LR, device="cuda", basis=basis)

    _, one_s, counts1 = drive(torch, k, lambda: run(1))
    fed_lm_counts("fed-lm lm-100m, 1 round", counts1, fed_lm_launches(cfg, 1))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    hist, secs, counts = drive(torch, k, lambda: run(FED_LM_ROUNDS))
    peak = torch.cuda.max_memory_allocated()
    fed_lm_counts("fed-lm lm-100m", counts, fed_lm_launches(cfg, FED_LM_ROUNDS))
    gaps = list(map(float, hist.gaps))
    if not (all(map(math.isfinite, gaps)) and gaps[-1] < gaps[0]):
        raise AssertionError(f"fed-lm lm-100m: losses {gaps} are not finite and falling")
    bits = check_fed_bits("fed-lm lm-100m", hist, fed_lm_bits(cfg, FED_LM_ROUNDS))
    prof = profile_run(torch, lambda: run(1), 1)
    # round 0's loss: one CPU forward of the same weights and batches
    t0 = time.perf_counter()
    with torch.no_grad():
        loss0_cpu = float(ex.make_eval_fn(ex.make_loss_fn(cfg))(
            _tree_map(lambda t: t.cpu(), params),
            _tree_map(lambda t: t.cpu(), batch.data))["gap"])
    cpu_s = time.perf_counter() - t0
    loss0_rel = abs(gaps[0] - loss0_cpu) / abs(loss0_cpu)
    if not loss0_rel <= FED_LM_TOL:
        raise AssertionError(f"fed-lm lm-100m: round 0's loss {gaps[0]} on the card, "
                             f"{loss0_cpu} on the CPU")
    leaves = tree_leaves(params)
    factors = {}
    for p, uv in zip(leaves, basis.UV):
        if uv is not None and p.shape == (cfg.padded_vocab, cfg.d_model):
            factors["embed"] = uv
        elif uv is not None and p.shape == (cfg.d_model, cfg.padded_vocab):
            factors["unembed"] = uv
    del params, batch, hist
    res = {"config": cfg.name, "params": n_params,
           "sizes": [ex.n_fed_clients(), Bsz, S + 1], "rounds": FED_LM_ROUNDS,
           "init_s": init_s, "setup_s": setup_s,
           "run_s": secs, "run_1_round_s": one_s,
           "s_per_round": (secs - one_s) / (FED_LM_ROUNDS - 1),
           "s_per_round_full_run": secs / FED_LM_ROUNDS, "max_memory_allocated": peak,
           "losses": gaps, "loss0_cpu": loss0_cpu, "loss0_rel": loss0_rel,
           "cpu_forward_s": cpu_s, "bits": bits, "launches": counts,
           "launches_1_round": counts1, "profile": prof}
    return res, factors


def fed_lm_kernels(torch, k, factors: dict) -> dict:
    """Kernels 1, 2, 4, 5 and 5b at the shapes lm-100m's path gives them,
    against their plain versions (kernels 1 and 2 bitwise, and kernel 1 to
    `torch.topk`; kernel 4 within BT_TOL_F64·max|f64| of float64, with the
    path's own factors; kernel 5 in float32 within ATTN_TOL·max|plain|; 5b
    within BWD_TOL·max|f64| of float64 autograd through the plain version),
    each timed beside its plain version, its bound and the library call.

    Kernel 4 is held to float64 alone here: at K = 32768 cuBLAS's float32
    sums (the plain version on the card) read ~1.02e-5·max|f64| from
    float64 themselves (the unembedding's factors), so the distances from
    the plain version and the plain version's own from float64 are
    readings, not gates."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(35)
    out = {}
    for T, kk, leaf in FED_LM_TOPK:
        x = torch.randn((2, T), device="cuda", generator=gen)
        a32 = x.abs()
        got = k.tk.topk_row_threshold(a32, kk)
        plain = k.tk.topk_row_threshold_plain(a32, kk)
        lib = torch.topk(a32, kk, dim=1).values[:, -1:]
        if not (torch.equal(got, plain) and torch.equal(got, lib)):
            raise AssertionError(f"topk_row_threshold at (2, {T}) k {kk}: kernel "
                                 f"{got.tolist()}, plain {plain.tolist()}, torch.topk "
                                 f"{lib.tolist()}")
        bound, by = threshold_bound_ms(2, T)
        reps = 3 if T > 1 << 20 else 20
        out[f"topk_row_threshold/{leaf}"] = {
            "shape": [2, T], "k": kk, "stage": k.tk.row_stage(T, k.tk._SMEM_LIMIT)[0],
            "max_abs_err": 0.0,
            "kernel_ms": cuda_ms(torch, lambda: k.tk.topk_row_threshold(a32, kk), reps, 1),
            "plain_ms": cuda_ms(torch, lambda: k.tk.topk_row_threshold_plain(a32, kk), 1, 1),
            "library_ms": cuda_ms(torch, lambda: torch.topk(a32, kk, dim=1), reps, 1),
            "bound_ms": bound, "bound_by": by}
        made = k.tk.compress_sum_cuda_launches
        dense, col = k.tk.topk_compress_sum(x, kk)
        made = k.tk.compress_sum_cuda_launches - made
        pd, pc = k.tk.topk_compress_sum_plain(x, kk)
        plan = k.tk.compress_sum_plan(2, T)
        if not (torch.equal(dense, pd) and torch.equal(col, pc)) or made != plan.launches:
            raise AssertionError(f"topk_compress_sum at (2, {T}) k {kk}: differs from its plain "
                                 f"version, or {made} CUDA launches for {plan}")
        bound, by = compress_sum_bound_ms(2, T)
        out[f"topk_compress_sum/{leaf}"] = {
            "shape": [2, T], "k": kk, "form": "cluster" if plan.cluster else "two-launch",
            "cuda_launches_per_call": made, "max_abs_err": 0.0,
            "kernel_ms": cuda_ms(torch, lambda: k.tk.topk_compress_sum(x, kk), reps, 1),
            "plain_ms": cuda_ms(torch, lambda: k.tk.topk_compress_sum_plain(x, kk), 1, 1),
            "library_ms": None, "bound_ms": bound, "bound_by": by}
        del x, a32, dense, col, pd, pc
        torch.cuda.empty_cache()
    # kernel 4 with the path's factors: A = U.mT read in place, B = V as
    # `_two_sided` passes it (contiguous)
    for leaf, (U, V) in factors.items():
        A, B = U.mT, V.contiguous()
        n, da, d1, d2, db = 2, A.shape[0], A.shape[1], B.shape[0], B.shape[1]
        g = torch.randn((n, d1, d2), device="cuda", generator=gen)
        made = k.bt.cuda_launches
        got = k.bt.basis_transform(A, g, B)
        made = k.bt.cuda_launches - made
        plain = k.bt.basis_transform_plain(A, g, B)
        ref = torch.matmul(torch.matmul(A.double(), g.double()), B.double())
        scale = float(ref.abs().max())
        e_plain = float((got - plain).abs().max())
        e_f64 = float((got.double() - ref).abs().max())
        plain_f64 = float((plain.double() - ref).abs().max())
        del ref
        if not e_f64 <= BT_TOL_F64 * scale:
            raise AssertionError(f"basis_transform at {leaf}: |Δ f64| {e_f64}, max|f64| "
                                 f"{scale} (|Δ plain| {e_plain}; the plain version's |Δ f64| "
                                 f"{plain_f64})")
        p = k.bt.plan(n, da, d1, d2, db, k.bt._transposed(A), k.bt._aligned(A, g, B))
        bound, by = basis_transform_bound_tc_ms(n, da, d1, d2, db)
        f32_bound, _ = basis_transform_bound_ms(n, da, d1, d2, db)
        fn = lambda: k.bt.basis_transform(A, g, B)                 # noqa: E731
        out[f"basis_transform/{leaf}"] = {
            "shape": [n, da, d1, d2, db], "a_transposed": k.bt._transposed(A), "form": p.form,
            "loader": p.loader, "cuda_launches_per_call": made, "max_abs_err": e_plain,
            "rel_err": {"plain": e_plain / scale, "f64": e_f64 / scale,
                        "plain_vs_f64": plain_f64 / scale},
            "kernel_ms": cuda_ms(torch, fn, 5, 1),
            "device_ms": device_ms(torch, {"k": fn}, reps=3)["k"],
            "plain_ms": cuda_ms(torch, lambda: k.bt.basis_transform_plain(A, g, B), 3, 1),
            "library_ms": cuda_ms(torch, lambda: torch.matmul(torch.matmul(A, g), B), 3, 1),
            "bound_ms": bound, "bound_by": by, "bound_f32_ms": f32_bound}
        del A, B, g, got, plain
        torch.cuda.empty_cache()
    # kernels 5 and 5b in float32 at the folded fleet's shape
    Bf, S, H, KVH, hd = FED_LM_ATTN
    q, do = (torch.randn((Bf, S, H, hd), device="cuda", generator=gen) for _ in range(2))
    kk_, v = (torch.randn((Bf, S, KVH, hd), device="cuda", generator=gen) for _ in range(2))
    got = k.fa._kernel(q, kk_, v, True, None)
    plain = k.fa.flash_attention_plain(q, kk_, v, causal=True)
    e, scale = float((got - plain).abs().max()), float(plain.abs().max())
    if not e <= ATTN_TOL * scale:
        raise AssertionError(f"flash_attention at {FED_LM_ATTN} (float32): |Δ| {e}, "
                             f"max|plain| {scale}")
    qt, kt, vt = (x.transpose(1, 2) for x in (q, kk_, v))
    bound, by = attention_bound_ms(q, kk_, True, None)
    out["flash_attention"] = {
        "shape": list(FED_LM_ATTN), "causal": True, "dtype": "float32", "max_abs_err": e,
        "rel_err": e / scale, "kernel_ms": cuda_ms(torch, lambda: k.fa._kernel(
            q, kk_, v, True, None), 20, 2),
        "plain_ms": cuda_ms(torch, lambda: k.fa.flash_attention_plain(q, kk_, v), 20, 2),
        "library_ms": cuda_ms(torch, lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 20, 2),
        "bound_ms": bound, "bound_by": by}
    got = dict(zip(("dq", "dk", "dv"), k.fa._kernel_bwd(q, kk_, v, do, True, None)))
    ins = [x.double().requires_grad_(True) for x in (q, kk_, v)]
    truth = dict(zip(("dq", "dk", "dv"), torch.autograd.grad(
        k.fa.flash_attention_plain(*ins, causal=True), ins, do.double())))
    err = _bwd_err(f"flash_attention backward at {FED_LM_ATTN} (float32)", got, truth, False)
    ins = [x.detach().requires_grad_(True) for x in (q, kk_, v)]
    out_plain = k.fa.flash_attention_plain(*ins, causal=True)
    ts = [x.detach().transpose(1, 2).requires_grad_(True) for x in (q, kk_, v)]
    out_sdpa = F.scaled_dot_product_attention(*ts, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    bound, by = attention_bwd_bound_ms(q, kk_, True, None)
    out["flash_attention_bwd"] = {
        "shape": list(FED_LM_ATTN), "causal": True, "dtype": "float32",
        "max_abs_err": max(e["abs"] for e in err.values()),
        "rel_err": max(e["rel"] for e in err.values()), "errors": err,
        "kernel_ms": cuda_ms(torch, lambda: k.fa._kernel_bwd(q, kk_, v, do, True, None), 10, 2),
        "plain_ms": cuda_ms(torch, lambda: torch.autograd.grad(
            out_plain, ins, do, retain_graph=True), 10, 2),
        "library_ms": cuda_ms(torch, lambda: torch.autograd.grad(
            out_sdpa, ts, dot, retain_graph=True), 10, 2),
        "bound_ms": bound, "bound_by": by}
    return out


def finetune_head_check(torch, k) -> dict:
    """`examples/torch_bl_finetune_head.py` on the card against the CPU: the
    reduced stablelm-12b backbone's features (kernel 5 in float32, one
    launch a layer a client) within FINETUNE_FEATURE_TOL·max|cpu|, then the
    script's three GLM runs from the CPU's features on both (BL1's Top-K
    through kernel 1): gaps in the GLM gate, bits exact."""
    import numpy as np

    ex = load_example("torch_bl_finetune_head")
    cfg, params = ex.backbone("cuda")
    cpu = _tree_map(lambda t: t.cpu(), params)
    feats, secs, fcounts = drive(torch, k, lambda: ex.features(
        params, cfg, np.random.default_rng(0), "cuda"))
    n_attn = sum(1 for sp in cfg.layer_specs() if sp.mixer == "attn")
    need_exact("finetune-head features", fcounts, {
        "flash_attention": n_attn * ex.N_CLIENTS, "flash_attention_bwd": 0,
        "topk_row_threshold": 0})
    rng = np.random.default_rng(0)
    feats_cpu = ex.features(cpu, cfg, rng, "cpu")
    rel = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in zip(feats, feats_cpu))
    if not rel <= FINETUNE_FEATURE_TOL:
        raise AssertionError(f"finetune-head: features off the CPU's by {rel} of max|cpu|")
    state = rng.bit_generator.state          # past the tokens' draws

    def runs(device):
        rng.bit_generator.state = state
        return ex.run_all(ex.make_clients(feats_cpu, rng, device), device)

    card, run_s, counts = drive(torch, k, lambda: runs("cuda"))
    host = runs("cpu")
    res = {}
    for name, h in card.items():
        r = check_history(f"finetune-head/{name}", h, history_dict(host[name]))
        res[name] = {key: r[key] for key in ("max_gap_abs_err", "max_gap_rel_err_above_1e-9",
                                             "bit_streams_equal")}
    if counts["topk_row_threshold"] < 1:
        raise AssertionError(f"finetune-head: BL1's Top-K launched no kernel 1: {counts}")
    return {"features_max_rel": rel, "features_s": secs, "runs_s": run_s,
            "launches_features": {kn: n for kn, n in fcounts.items() if n},
            "launches_runs": {kn: n for kn, n in counts.items() if n},
            "gaps_end": {name: float(h.gaps[-1]) for name, h in card.items()}, "runs": res}


def fed_lm_phase(torch, k) -> tuple:
    """Phase fed-lm: the reduced check, lm-100m at full width, the kernels
    at the path's new shapes, then the BL1 head fine-tune on the card."""
    ex = load_example("torch_train_lm")
    reduced = fed_lm_reduced_check(torch, k, ex)
    torch.cuda.empty_cache()
    full, factors = fed_lm_full(torch, k, ex)
    torch.cuda.empty_cache()
    kernels = fed_lm_kernels(torch, k, factors)
    del factors
    torch.cuda.empty_cache()
    head = finetune_head_check(torch, k)
    torch.cuda.empty_cache()
    return {"reduced": reduced, "full": full, "kernels": kernels, "finetune_head": head}


def main(argv) -> int:
    if argv[:1] == ["--sharded-worker"]:
        return sharded_worker(argv[1])
    if argv[:1] == ["--dryrun-worker"]:
        sys.path.insert(0, str(ROOT / "src"))
        return dryrun_worker(*argv[1:4])
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
    from repro_torch.core.pytree import tree_leaves
    from repro_torch.exp import problems
    from repro_torch.kernels import SOURCES, _build, ops
    from repro_torch.kernels import basis_transform as bt
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ssd_scan as ss
    from repro_torch.kernels import threefry_normal as tn
    from repro_torch.kernels import tiled_matmul as tm
    from repro_torch.kernels import topk_threshold as tk

    k = SimpleNamespace(tk=tk, tm=tm, bt=bt, fa=fa, ss=ss, tn=tn)
    _device.resolve("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": smi, "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    _build.build_all(SOURCES)
    emit({"phase": "build", "sources": list(SOURCES),
          "seconds": time.perf_counter() - t0})
    import tempfile

    dryrun_tmp = pathlib.Path(tempfile.mkdtemp(prefix="dryrun_"))
    dryrun_started = time.perf_counter()
    dryrun_procs = start_dryrun(dryrun_tmp)

    kern = kernel_phase(torch, tk, "--profile" in argv)
    emit({"phase": "kernels", "kernel": "topk_row_threshold", **kern})
    km = matmul_kernel_phase(torch, tm, ops)
    emit({"phase": "kernels_matmul", "kernel": "tiled_matmul", **km})
    ep = entry_points_phase(torch, k)
    emit({"phase": "kernels_entry_points", **ep})
    pr = prng_phase(torch, prng, rounds, tn, eager_init="--profile" in argv)
    emit({"phase": "prng", **pr})

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
    need("fig1r1", counts, {"topk_row_threshold": cell.steps, "tiled_matmul": 0,
                            "threefry_bits": 0})
    emit({"phase": "fig1r1", "setup_s": setup_s, "run_s": secs, "launches": counts, **res})
    for cell in (problems.FIG1R1_CELLS["FedNL"], problems.FIG1R1_CELLS["Newton"]):
        hist, secs, counts = drive(torch, k, lambda: problems.run_cell(cell, prob))
        res = check_history(f"fig1r1/{cell.name}", hist,
                            json.loads(cell.artifact.read_text())["history"])
        need(f"fig1r1/{cell.name}", counts, {"tiled_matmul": 0, "threefry_bits": 0})
        per_cell[f"fig1r1/{cell.name}"] = counts
        emit({"phase": "fig1r1", "cell": cell.name, "run_s": secs, "launches": counts, **res})

    emit({"phase": "fig1r1-reference", **fig1r1_reference_phase(torch, k, problems, prob)})

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
    bits_cells = {}                              # kernel 7's bits path by cell
    stochastic = glm_cells_phase(torch, k, problems, problems.STOCHASTIC_CELLS, prob,
                                 s_per_round=cell_s, bits=bits_cells)
    per_cell["fig1r1/NL1"] = {**dict.fromkeys(counts, 0),
                              "topk_row_threshold": stochastic["fig1r1/NL1"],
                              "threefry_bits": bits_per_round(problems.FIG1R1_CELLS["NL1"])
                              * problems.FIG1R1_CELLS["NL1"].steps}

    # ---- fig1r2, fig5 (FedNL-BC, DORE), fig1-bag; then the basis grid and a1a
    baseline = glm_cells_phase(torch, k, problems, problems.BASELINE_CELLS, prob,
                               s_per_round=cell_s, bits=bits_cells)
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
    need("fig1-xl", counts, {"topk_row_threshold": cell.steps, "tiled_matmul": 0,
                             "threefry_bits": 0})
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
    launches["bl2-xl"], launches["bl2-xl_bits"] = bl2_xl_phase(torch, k, problems, prng,
                                                               rounds, prob)
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
    dnn_leaves = len(tree_leaves(prob.params0))
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
            want["threefry_bits"] = bits_per_round(cell, dnn_leaves) * cell.steps
            need_exact(f"{cell.experiment}/{cell.name}", counts, want)
        else:
            want = {"tiled_matmul": 0, "threefry_bits": bits_per_round(cell, dnn_leaves) * cell.steps}
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

    # ---- dnn-drawn: a BL-DNN problem the port draws, card against CPU ------
    drawn = dnn_drawn_phase(torch, k, problems)
    emit({"phase": "dnn-drawn", **drawn})
    for name, res in drawn["cells"].items():
        dnn_launches[f"dnn-drawn/{name}"] = res["launches"]

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
    emit({"phase": "serve", "seconds": sv["seconds"], "launches": sv["launches"],
          "bits_launches": sv["bits_launches"]})
    problems.build_problem.cache_clear()
    torch.cuda.empty_cache()

    # ---- sharded: the client-sharded reducer, W ranks on the one card ------
    sh = sharded_phase(torch, k, problems, smi, {
        "fig1-xxl/BL2": co["run_cell_s"]["fig1-xxl/BL2"] / problems.FIG1_XXL["BL2"].steps})
    emit({"phase": "sharded", "seconds": sh["seconds"], "spawn_seconds": sh["spawn_seconds"]})
    problems.build_problem.cache_clear()
    torch.cuda.empty_cache()

    # ---- LM serving: kernels 5 and 6, then the ten configs -----------------
    ka, ks, serve_res = lm_serve_phases(torch, k, fa, ss, "--profile" in argv)

    # ---- LM training: the backward kernels, then gemma3-4b and mamba2-370m
    kab = attention_bwd_phase(torch, fa)
    emit({"phase": "kernels_attn_bwd", "kernel": "flash_attention_bwd", **kab})
    ksb = ssd_bwd_phase(torch, ss)
    emit({"phase": "kernels_ssd_bwd", "kernel": "ssd_scan_bwd", **ksb})
    tr = train_phase(torch, k)
    emit({"phase": "train", "cells": {arch: {key: r.get(key) for key in (
        "shape", "layers", "s_per_step", "tokens_per_s", "max_memory_allocated", "setup_s",
        "init_s", "plain_loss_rel", "plain_max_memory_allocated")} for arch, r in tr.items()},
        "reduced_grad_max_rel": {arch: r["reduced"]["grad_max_rel"] for arch, r in tr.items()}})
    emit({"phase": "train-bf16-witness", **bf16_witness(torch, k)})
    torch.cuda.empty_cache()

    # ---- LM sharding: the sharded cells, ranks sharing the card ------------
    lms = lm_sharded_phase(torch, smi)
    emit({"phase": "lm_sharded", "launches": lms["launches"], "ranks_s": lms["ranks_s"]})

    # ---- the dry run: its processes started after the build ----------------
    dr = dryrun_phase(torch, smi, lms, dryrun_procs, dryrun_started)
    emit({"phase": "dryrun", "wall_s_since_start": dr["wall_s"],
          "longest_case_s": dr["seconds"],
          "ratios": {name: c["ratio"] for name, c in dr["cells"].items()},
          "cases": len(dr["cases"])})
    import shutil

    shutil.rmtree(dryrun_tmp, ignore_errors=True)

    # ---- fed-lm: BL-DNN on a language model, vmap(grad) over the clients --
    fl = fed_lm_phase(torch, k)
    emit({"phase": "fed-lm", **fl})
    flk = fl["kernels"]
    fl_launches = fl["full"]["launches"]

    xl = kern["timings"]["fig1-xl"]
    cs = kb["compress_sum_timings"]["8x3072"]
    bt_path = kb["basis_transform_timings"]["8x96x96x32x32"]
    bt_large = kb["basis_transform_timings"]["x".join(map(str, LARGE_ROTATION))]
    mm, mg = km["timings"]["newton-xl/T"], km["timings"]["newton-xl/G"]
    fg, fw = ka["timings"]["global"], ka["timings"]["window1024"]
    sd = ks["timing"]
    fbg, fbw = kab["timings"]["global"], kab["timings"]["window1024"]
    sbd = ksb["timing"]
    tnl = pr["threefry_normal"]["embedding"]
    btm = pr["bits_timings"]["bernoulli_f32_8x3072"]
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
        "launches_dnn-drawn": {name: c["topk_row_threshold"] for name, c in
                               dnn_launches.items() if name.startswith("dnn-drawn/")},
        "entry_points": {key: v for key, v in ep.items() if key.startswith("topk_")},
        "launches_baseline_cells": baseline, "launches_basis_grid": grid,
        "launches_cohort": co["launches"], "launches_serve": sv["launches"],
        "launches_sharded": _sharded_launches(sh, "topk_row_threshold"),
        "launches_fed_lm": fl_launches["topk_row_threshold"],
        "fed_lm": {key: v for key, v in flk.items() if key.startswith("topk_row_threshold/")},
        "path_shapes": {tag: {key: kern["timings"][tag][key] for key in (
            "shape", "k", "kernel_ms", "plain_ms", "library_ms", "bound_ms", "bound_by")}
            for *_, tag in STOCHASTIC_THRESHOLD_SHAPES},
        "cohort_shapes": {tag: {key: kern["timings"][tag][key] for key in (
            "shape", "k", "kernel_ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")} for *_, tag in COHORT_THRESHOLD_SHAPES},
        "sharded_shapes": {tag: {key: kern["timings"][tag][key] for key in (
            "shape", "k", "kernel_ms", "device_ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")} for *_, tag in SHARDED_THRESHOLD_SHAPES}}, {
        "name": "topk_compress_sum", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/topk_compress_sum.cu",
        "replaces": "src/repro/kernels/topk_threshold.py:123",
        "launches": main["topk_compress_sum"], "max_abs_err": kb["compress_sum_max_abs_err"],
        "ms": cs["kernel_ms"], "plain_ms": cs["plain_ms"], "bound_ms": cs["bound_ms"],
        "bound_by": cs["bound_by"], "library_ms": None,
        "two_pass_ms": cs["two_pass_ms"], "shape": cs["shape"],
        "cuda_launches": main["topk_compress_sum_cuda"],
        "cuda_launches_per_call": cs["cuda_launches_per_call"],
        "launches_dnn-drawn": {name: c["topk_compress_sum"] for name, c in
                               dnn_launches.items() if name.startswith("dnn-drawn/")},
        "launches_sharded": _sharded_launches(sh, "topk_compress_sum"),
        "launches_fed_lm": fl_launches["topk_compress_sum"],
        "fed_lm": {key: v for key, v in flk.items() if key.startswith("topk_compress_sum/")}}, {
        "name": "tiled_matmul", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/tiled_matmul.cu",
        "replaces": "src/repro/kernels/tiled_matmul.py:70",
        "launches": launches["newton-xl"], "max_abs_err": km["max_abs_err"]["plain"],
        "ms": mm["kernel_ms"], "plain_ms": mm["plain_ms"], "bound_ms": mm["bound_ms"],
        "bound_by": mm["bound_by"], "library_ms": mm["library_ms"],
        "library_cast_f32_ms": mm["library_cast_f32_ms"],
        "library_f32_copies_ms": mm["library_f32_copies_ms"],
        "shape": [mm["a"], mm["b"]], "launches_fig2": fig2_launches["newton_basis/kernel"],
        "entry_points": {key: v for key, v in ep.items() if key.startswith("matmul/")},
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
        "launches_dnn-drawn": dnn_launches["dnn-drawn/BLDNN"]["basis_transform"],
        "entry_points": {key: v for key, v in ep.items() if key.startswith("basis_transform/")},
        "launches_sharded": _sharded_launches(sh, "basis_transform"),
        "launches_fed_lm": fl_launches["basis_transform"],
        "fed_lm": {key: v for key, v in flk.items() if key.startswith("basis_transform/")},
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
                                     "library_ms")},
        "config_shapes": ka["config_timings"],
        "launches_serve": {arch: {"prefill": r["launches_prefill"]["flash_attention"],
                                  "decode": r["launches_decode"]["flash_attention"]}
                           for arch, r in serve_res.items() if "launches_prefill" in r},
        "launches_train": {arch: r["launches"]["flash_attention"] for arch, r in tr.items()
                           if "launches" in r},
        "offset_shapes": {key: v for key, v in ka["timings"].items()
                          if key.startswith("offset")},
        "launches_lm_sharded": _lm_sharded_launches(lms, "flash_attention"),
        "launches_fed_lm": fl_launches["flash_attention"], "fed_lm": flk["flash_attention"]}, {
        "name": "ssd_scan", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "replaces": "src/repro/kernels/ssd_scan.py:73",
        "launches": serve_res["mamba2_370m"]["launches_prefill"]["ssd_scan"],
        "max_abs_err": max(ks["max_abs_err"]["y"], ks["max_abs_err"]["state"]),
        "ms": sd["kernel_ms"], "plain_ms": sd["plain_ms"], "bound_ms": sd["bound_ms"],
        "bound_by": sd["bound_by"], "library_ms": None, "shape": sd["shape"],
        "bound_f32_ms": sd["bound_f32_ms"],
        "cuda_launches": serve_res["mamba2_370m"]["ssd_scan_cuda_launches_prefill"],
        "cuda_launches_per_call": ks["cuda_launches_per_call"],
        "config_shapes": ks["config_timings"],
        "launches_jamba_reduced": serve_res["jamba_15_large_398b"]["reduced"]["launches"][
            "ssd_scan"],
        "launches_serve": {arch: r["launches_prefill"]["ssd_scan"]
                           for arch, r in serve_res.items()
                           if r.get("launches_prefill", {}).get("ssd_scan")},
        "launches_train": {arch: r["launches"]["ssd_scan"] for arch, r in tr.items()
                           if "launches" in r and r["launches"]["ssd_scan"]},
        "launches_lm_sharded": _lm_sharded_launches(lms, "ssd_scan")}, {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/models/layers.py:129",
        "replaces_note": "no TPU kernel: jax.grad of _blocked_attn, the function of "
                         "src/repro/kernels/flash_attention.py:86",
        "launches": tr["gemma3_4b"]["launches"]["flash_attention_bwd"],
        "max_abs_err": kab["max_abs_err"], "max_rel_err": kab["max_rel_err"],
        "ms": fbg["kernel_ms"], "device_ms": fbg["device_ms"], "plain_ms": fbg["plain_ms"],
        "bound_ms": fbg["bound_ms"], "bound_by": fbg["bound_by"],
        "library_ms": fbg["library_ms"], "shape": fbg["shape"] + ["global"],
        "window1024": {key: fbw[key] for key in ("kernel_ms", "device_ms", "plain_ms",
                                                 "bound_ms", "bound_by", "library_ms")},
        "cuda_launches_per_call": fbg["cuda_launches_per_call"],
        "config_shapes": {name: kab["timings"][name] for name, *_ in ATTN_BWD_PATH
                          if name not in ("global", "window1024")},
        "offset_shapes": {key: v for key, v in kab["timings"].items()
                          if key.startswith("offset")},
        "launches_lm_sharded": _lm_sharded_launches(lms, "flash_attention_bwd"),
        "launches_train": {arch: r["launches"]["flash_attention_bwd"]
                           for arch, r in tr.items() if "launches" in r},
        "launches_fed_lm": fl_launches["flash_attention_bwd"],
        "fed_lm": flk["flash_attention_bwd"],
        "spills": kab["spills"]}, {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/models/layers.py:554",
        "replaces_note": "no TPU kernel: jax.grad of _ssd_chunked, the function of "
                         "src/repro/kernels/ssd_scan.py:73",
        "launches": tr["mamba2_370m"]["launches"]["ssd_scan_bwd"],
        "max_abs_err": ksb["max_abs_err"], "max_rel_err": ksb["max_rel_err"],
        "ms": sbd["kernel_ms"], "device_ms": sbd["device_ms"], "plain_ms": sbd["plain_ms"],
        "bound_ms": sbd["bound_ms"], "bound_by": sbd["bound_by"], "library_ms": None,
        "shape": sbd["shape"], "cuda_launches_per_call": sbd["cuda_launches_per_call"],
        "bound_f32_ms": sbd["bound_f32_ms"], "spills": ksb["spills"],
        "config_shapes": ksb["config_timings"],
        "launches_train": {arch: r["launches"]["ssd_scan_bwd"] for arch, r in tr.items()
                           if "launches" in r and r["launches"]["ssd_scan_bwd"]},
        "launches_lm_sharded": _lm_sharded_launches(lms, "ssd_scan_bwd")}, {
        "name": "threefry_normal", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/threefry_normal.cu",
        "replaces": "src/repro/models/layers.py:33",
        "replaces_note": "no TPU kernel: the reference's jax.random.normal draw in "
                         "layers._init, which XLA lowers on its CPU",
        "launches": tr["gemma3_4b"]["launches"]["threefry_normal"],
        "max_abs_err": 0.0, "ms": tnl["kernel_ms"], "device_ms": tnl["device_ms"],
        "plain_ms": tnl["plain_ms"], "bound_ms": tnl["bound_ms"], "bound_by": tnl["bound_by"],
        "library_ms": None, "torch_randn_fill_ms": tnl["torch_randn_fill_ms"],
        "shape": tnl["shape"], "dtype": tnl["dtype"], "ns_per_draw": tnl["ns_per_draw"],
        "init": pr["threefry_normal"]["init"],
        "launches_train": {arch: r["launches"]["threefry_normal"] for arch, r in tr.items()
                           if "launches" in r},
        "launches_serve_init": {arch: r["init_launches"] for arch, r in serve_res.items()
                                if "init_launches" in r},
        "launches_lm_sharded": _lm_sharded_launches(lms, "threefry_normal"),
        "bound_f32_rate_ms": tnl["bound_f32_rate_ms"], "sass": tnl["sass"]}, {
        "name": "threefry_bits", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/threefry_normal.cu",
        "replaces": "src/repro/core/rounds.py:742",
        "replaces_note": "no TPU kernel: the reference's per-round jax.random draws (here "
                         "BL2's participation mask), which XLA lowers; kernel 7's bits path",
        "launches": dnn_launches["fig-dnn/RTopK"]["threefry_bits"],
        "max_abs_err": 0.0, "ms": btm["kernel_ms"], "device_ms": btm["device_ms"],
        "plain_ms": btm["plain_ms"], "bound_ms": btm["bound_ms"], "bound_by": btm["bound_by"],
        "library_ms": None, "shape": btm["shape"], "timings": pr["bits_timings"],
        "draw_cost": pr["draw_cost"], "launches_glm_cells": bits_cells,
        "launches_bl2-xl": launches["bl2-xl_bits"],
        "launches_cohort": co["bits_launches"], "launches_serve": sv["bits_launches"],
        "launches_sharded": _sharded_launches(sh, "threefry_bits")}]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
