#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Run from the repo root. It builds the hand-written CUDA kernels from
`garment4d_tpu_torch/ops/csrc/` (nvcc, sm_90a, one process per source),
then:

1. card: prints the GPU's name and power limit (nvidia-smi) and the build
   time;
2. kernels: calls each kernel's wrapper at the shapes of the posed forward
   (80 frames: B=8 sequences x T=10) and holds it against its plain torch
   version on the same inputs on the card. Canonical-stage kernels: FPS,
   ball-query and 3-NN indices and gathered rows bitwise equal, 3-NN squared
   distances equal, the fused SA chain within rtol 1e-4 / atol 1e-5.
   Posed-stage kernels, on inputs captured from one posed forward: every
   FPS, coverage, flat and grouped ball-query and 3-NN launch of the
   forward recorded with its inputs, each launch's bound and the summed
   bounds printed, each coverage launch (3), each grouped launch (3) and
   each distinct FPS, flat (8) and 3-NN (3) case bitwise its plain version
   (3-NN: indices and squared distances) and timed (FPS, flat and 3-NN
   with their launches queued behind a sleeping kernel, `kernel_ms`; FPS
   beside the time a step; FPS, coverage, flat and 3-NN beside the bound
   of the work their culls leave on this data, `fps_work`,
   `coverage_work`, `query_work` and `three_nn_work`, and the earlier
   kernels' scan bound: every point each step, each point's centers up to
   its first hit, each center's points up to its S-th hit, every (query,
   known point) pair; 3-NN beside `torch.cdist` and a top-3, a time
   yardstick only); the PE blocks on the chain
   kernel (body S=32, garment pe2) within rtol 1e-4 / atol 1e-5; the K-NN
   transfer's 1-NN indices equal, its own selections (read back through
   one-hot weights, `knn_selection`) those of the plain version wherever
   1/d^2 is finite, its weights within rtol 1e-4 / atol 1e-6 of the plain
   version and of the float64 transfer over its selections
   (`knn_float64`); the GCN stack (195- and 323-wide iterations)
   within rtol 1e-4 / atol 1e-5 on `out` and `hidden`. Then every chain
   and GCN-stack launch of one posed forward is recorded with its inputs
   (28 chain launches, 3 stacks of 4 layer launches): each launch's bound
   and the summed bounds printed; each of the 15 row-gather launches held
   bitwise (int32 views, NaN rows included) to the plain version as it
   runs, each distinct case timed beside its bound and the flattened
   `index_select` (`record_gathers`), the summed bounds beside the
   profiler's device ms in phase 4; and at each distinct shape the kernel
   within rtol 1e-4 / atol 1e-5 of its plain version and of the plain
   version in float64, two launches bitwise equal. Each is timed with
   CUDA events beside its plain version, its bound (the larger of the bytes
   it must move over 3.35 TB/s and its operations, counted for this run's
   data where the work depends on it, over 67 TFLOP/s of fp32) and, where
   one PyTorch call computes the same function (`index_select` on the
   flattened table for the row gather), that call's time;
3. canonical path: builds the batch with the port's `make_batch` (ring
   garment Vg=2000, 6890-vertex synthetic body, B=8, T=10, N=6890), loads
   the whole `ckpt_synth/posed_synth.npz`, zeroes the launch counters, runs
   `GarmentReconstructor.canonical` once and requires each of its five
   kernels to have launched; times it (median of 3 after a warm-up),
   profiles it (torch.profiler: device ms per kernel, idle share; a
   session whose kernel events fall short of the launch counters is
   profiled again, and a third short one fails) and times
   its plain path on the card (inside `ops.plain_ops()`);
4. posed path: zeroes the counters, runs `GarmentReconstructor.posed` once
   and requires all ten kernels to have launched (the flat query 14 times,
   the 3-NN 3); prints the counts and
   whether a body query took the overflow branch; times it (median of 5
   after a warm-up) and profiles it (the chain, GCN, K-NN, grouped and flat
   query, 3-NN, FPS and coverage kernels' device ms per forward beside
   their summed bounds); times the plain path on the card and
   compares one sequence (B=1, T=10) of both paths with the port's plain
   path on the CPU: labels agree on >= 99.9% of points, `tpose_garment`
   within 1e-3, the LBS result within 1e-4, every iteration's vertices no
   further from the CPU than the card's plain path's are (fp32 rounding
   flips radius-boundary memberships, which the refinement iterations
   amplify), and, fed the card's own inputs of each iteration, the CPU's
   vertex offsets and hidden features within 1e-5 of the card's, every
   element;
5. posed train step (B=4, T=10, the seed-1 batch, a train state from the
   whole `posed_synth.npz`, Adam at lr 1e-3, canonical stage frozen):
   zeroes the counters and runs `train_step` once, recording the inputs of
   the three train kernels; requires all thirteen kernels to have launched
   (pe_bwd 18, nn1 3 and banded 30 times), every loss term finite, every
   trainable parameter with a finite gradient and moved, every canonical
   parameter and buffer bitwise unchanged. On the recorded inputs: each
   distinct 1-NN case (the loss's 3 launches) bitwise its plain version in
   indices and squared distances and timed (`kernel_ms`) beside its bound
   (the work its culls leave on this data, `nn1_work`), the earlier
   kernel's scan bound and `cdist_min` (exact `torch.cdist` and a min, a
   time yardstick only); the banded product (the GCN recompute's C=128
   band, its transpose, the loss Laplacian's C=3 band) bitwise equal to
   its plain version; the PE backward at each of its
   six shapes (body 6 wide at S=8/16/32, garment unsplit 67/99/387 wide at
   S=32/16/8), with a zero cotangent at the (center, channel) pairs whose
   max another fp32 summation order may put on another slot (`pe_near_ties`,
   at most 5% of them): dcenters within rtol 1e-4 / atol 1e-5 and weight
   gradients within 1e-4 of their largest magnitude, both of the plain
   version and of the float64 version given the plain version's routing
   (`pe_bwd_float64`), two launches bitwise equal; the step's FPS cases
   bitwise their plain versions and timed as in phase 2; the unmasked
   difference
   and the share of the pairs that fp32 routes otherwise than float64
   printed; each timed beside its plain version, its bound (the work this
   run's routing needs) and a library yardstick (a dense
   `torch.matmul(adj, x)`). The profiler's device ms of the step's 3 1-NN
   and 30 banded launches beside their summed bounds. The same step on the plain
   path from the same weights, which must launch no kernel, its backward
   included: every loss term within 1e-3 relative; each
   refinement iteration fed its recorded inputs and one random cotangent,
   its forward run once on the kernel path and its backward twice, through
   the kernels and through their plain versions: every parameter's and
   `cur`'s gradient within 1e-4 relative L2, the same pairs masked in every
   PE backward of both, and printed beside it the unmasked reading and the
   kernel path against the plain path each run forward and backward. Train
   frames/s (40 / median of 5 steps after 2 warm-ups), the plain path's (2
   steps) and a profile of one step. Beside them, two op-level checks: the
   PE backward's dtable half (table_grad=True: the slots' row gradients
   summed by the scatter-add) at garment pe0 unsplit, 67-32-32 at S=32, all
   six gradients against the plain version and the float64 witness with the
   near-tie mask, two launches bitwise equal, and its scatter-add of the
   won slots' row gradients checked and timed as phase 6's scatter-adds;
   and (in phase 2) the valid-count chain call at the body PE shape,
   bitwise the chain kernel without the count; the step's K-NN transfer
   (B=4) held as in phase 2, and its flat and 3-NN cases as in phase 2;
6. canonical train step at the recipe's shape (B=20, T=10, N=6890, the
   seed-1 batch, the canonical subtree of `posed_synth.npz`, Adam at lr 1e-3
   over every parameter, dropout 0.5 from a seeded generator): zeroes the
   counters and runs `train_step` once, requiring fps, ball_query,
   gather_rows, three_nn, nn1 and scatter_add to have launched (counts
   printed), every loss term finite, every parameter with a finite gradient
   and moved, every BatchNorm running statistic changed. On the inputs
   recorded from the step, each of the scatter-add's shapes: within rtol
   1e-5 / atol 1e-6 of its plain version on the card (`index_add_`),
   bitwise the ascending-order sum on the CPU, two launches bitwise equal;
   timed beside its bound (bytes), its plain version and one `index_add_`;
   the step's FPS, flat (its 10 single-radius queries), 3-NN (200 frames)
   and 1-NN cases bitwise their plain versions and timed as in phase 2 and
   5; its 25 row-gather launches each held bitwise to the plain version
   and each case timed as the posed forward's (the posed train step's 22
   too); the profiler's device ms of its 1-NN and its 25 row gathers beside
   their summed bounds. The eval step (fused SA path, the eval-tail mask)
   once, its 1-NN held and timed as the train step's;
   the same train
   step on the plain path from the same weights and dropout seed, which
   must launch no kernel, run twice: every loss term within 1e-3
   relative; the two paths' gradients, and the plain path's against
   itself, printed (its atomics and the train-mode BatchNorms move them by
   up to ~1e-3). Then one kernel-path forward and its backward through the
   scatter-add kernel and, three times, through its plain version: every
   parameter's gradient, kernel vs plain, within 1e-4 relative L2 or within
   3x the plain version's own run-to-run difference. Train frames/s (200 /
   median of 5 steps after 2 warm-ups), the plain path's (1 step), a
   profile of one step and the peak memory;
7. the training entry point, `garment4d_tpu_torch.train_temporal.main`, as
   the recipe runs it (`scripts/train/train_skirt_{canonical,posed}.sh`) on
   a mini-CLOTH3D tree (`data/fixture.py`: 14 sequences of 20 frames, 8192
   garment points a frame, the Vg=2000 ring template and its PCA pickle,
   6890-vertex synthetic bodies as SMPL npz files, a config over
   `cfgs/skirt.yaml` at NPOINTS 6890, LBSK 256, ITERATION 3, PCADIM 64):
   the canonical stage (B=20, T=10, 2 epochs, --lr_sche), the posed stage
   from its checkpoint (B=4, --fix_PCA 1, --GarmentPCA_pretrain, 2
   epochs), the posed run again for one more epoch (an auto-resume, which
   continues at the epoch after its checkpoint's), --only_eval of the
   posed checkpoint, and the MGN variant (B=4, --MGN 1 --fix_PCA 1, 1
   epoch) bootstrapped by --GarmentPCA_pretrain from a file in the
   reference's checkpoint layout (`tests/torch_ref_mirror.py`'s
   PCAGarmentEncoderSeg, seeded weights). Each run with the launch
   counters at 0 before it: the canonical run launches fps, ball_query,
   gather_rows, three_nn, nn1, scatter_add and (eval) fused_chain, each
   posed run the thirteen kernels of phase 5, --only_eval the ten forward
   kernels and nn1, the MGN run fps, ball_query, fused_chain, three_nn,
   gather_rows, nn1 (and its pre-pass) and banded. Every loss finite; the
   canonical stage bitwise its checkpoint in both posed checkpoints and
   bitwise the reference file's (after the key map) in the MGN one; the
   auto-resume's restored state bitwise the file (weights, statistics,
   Adam's moments and steps, step, lr_scale, the dropout generator and the
   plateau), its one epoch the one after the checkpoint's, its `Train/*`
   scalars at the restored step count onwards; the --only_eval means within 1e-5 relative of the
   eval logged for the epoch the checkpoint holds; one `finalize_batch` of
   four windows on the card within 1e-5 (relative beyond 1) of the same raw
   batch on the CPU, indices and labels equal. Prints each stage's train
   frames/s over its epochs' wall time beside phases 5-6's step alone,
   the data path alone (loader, collate, `finalize_batch`, no step) at
   `--num_workers` 0, 1 and 8, and the loader alone (`raw_item` and
   `collate`) at the same widths;
8. the MGN variant (`--MGN 1`: the canonical stage, a displacement MLP,
   single-nearest-neighbour LBS) and the reference's checkpoint files.
   The MGN forward at B=8, T=10 (the canonical stage from
   `posed_synth.npz`, the displacement MLP at torch's init from seed 0):
   the launch counters (fps, ball_query, fused_chain, three_nn,
   gather_rows, nn1 once and its pre-pass), every 1-NN launch ((80, 2000)
   vs 6890) and every row gather (both 16-float gathers of (80, 6890, 16)
   tables among them) bitwise their plain versions, each new case timed
   beside its bound (`nn1_work`, `gather_bytes`) and `cdist_min` or the
   flattened `index_select`; the LBS teacher-forced: the CPU's plain LBS of
   sequence 0 fed the card's garments and body, indices equal, vertices
   within 1e-5; frames/s (median of 5 after a warm-up), the profiler's
   device ms by kernel and the idle share. One MGN train step at B=4,
   T=10 (the canonical stage trainable, reached by no gradient): nn1
   twice, banded launched, every 1-NN and row gather bitwise plain and the
   new cases timed; finite losses, every displacement tensor moved, the
   canonical stage bitwise unchanged; the plain step launching no kernel,
   its losses within 1e-3; the kernel and plain backwards of one shared
   forward within 1e-4 relative L2; train frames/s and a profile. The
   reference's posed (lbs_k 256) and MGN networks
   (`tests/torch_ref_mirror.py`, built with seeded weights at full width,
   never run) saved in the reference's
   layout with `module.` prefixes and loaded on the card through
   `GarmentReconstructor.from_assets(checkpoint=)` and `load_pretrained`:
   every key but `num_batches_tracked` loaded, none skipped, each of the
   port's tensors bitwise the file's after the map's reshape, one finite
   forward of each; the whole run's seconds printed;
9. data parallelism (`garment4d_tpu_torch.parallel`) on the one card:
   9a: phase 6's canonical (B=20) and phase 5's posed (B=4) train steps
   each once without a process group, and then both in one group of one
   rank over NCCL in this process, whose presence alone switches the
   data-parallel path on (global-batch BatchNorm moments by all-reduce,
   the gradient and loss all-reduces), from the same weights, batch and
   dropout generator, with the launch counters at 0 before each: the
   posed step bitwise (losses, gradients, parameters and buffers; both
   runs, and a second run without the group, with torch's deterministic
   algorithms off: the losses' mesh sums repeat bitwise), the
   canonical one within DP1_TOL (losses 1e-5 relative,
   running statistics 1e-6 of each tensor's largest, gradients 1e-2
   relative L2; those zero in exact arithmetic, `record_errors`, below
   1e-4 of the largest gradient), the same launches on both paths; each
   path's train frames/s (median of 5 after 2 warm-ups), device ms and
   NCCL kernels (launches, ms) a step by the profiler; the data-parallel
   step's all-reduces counted (two a BatchNorm in training, one of the
   gradients, one of the losses; none without the group). 9b, two ranks on the
   one card over gloo (NCCL refuses two ranks of one GPU), each its own
   process (`chip_smoke.py --dp-rank`, torchrun's variables, the library
   the parent built) with its half of each global batch: the two replicas
   bitwise equal after each step, the loss scalars, running statistics
   and gradients within DP2_TOL (1e-4, 1e-5, 2e-2: the JAX package's
   sharded step test) of 9a's single-process steps; the posed step's
   per-sample `lbs_garment_msre_list` (`per_sample_errors`) within 1e-6 of
   one process's on the same rows and within 2e-3 of one process's at B=4,
   a limit between the control (one process at B=2 on each half against
   B=4) and the rank blocks swapped, both printed and both checked to fall
   on their side of it; each rank's FPS launches over
   half the frames (canonical sa1 over 100, not 200) and every kernel of
   the step launched; each rank's step wall time ("two ranks sharing one
   card", not a scaling number). 9c, the entry point under `--launcher
   pytorch` with WORLD_SIZE=1 (NCCL) on phase 7's tree: one canonical
   epoch at B=20, then one posed epoch (`--fix_PCA 1`) from its
   checkpoint: finite losses, each checkpoint written once by rank 0, the
   launch counters nonzero, no group left behind, train frames/s beside
   phase 7's;
10. the posed model's opt-in levers (`spatial_sample`, candidate reuse
   at `candidate_reuse_margin`), from phase 4's weights and batch: phase
   4's per-center displacements between iterations printed, and two
   margins from them (LEVER_BELOW x the largest step, LEVER_ABOVE x the
   largest drift from the iteration-0 centers). The posed forward under
   spatial sampling, reuse at each margin and both (the smaller margin,
   whose tables fit their cap), each with the launch counters at 0 before
   it: the candidate builds and overflows a forward; every coverage
   launch (the radius widened by the margin) and grouped ball-query launch
   (the Morton-compacted body tables) bitwise its plain version, and under
   the spatial lever every flat query of the Morton-sorted garment levels
   (queried whole: the JAX package's group window is a TPU device) bitwise
   as it ran, each distinct case timed; every row gather (the center
   and table permutations, the inverse gathers) bitwise as it runs, each
   case timed; every Morton code and permutation bitwise the CPU's; each
   iteration teacher-forced on the CPU plain path (sequence 0, the same
   center order) within 1e-5, for the spatial forwards and a reuse
   forward that is not bitwise the default (phase 4 holds the default's);
   a reuse forward against the forward without reuse bitwise, else within
   REUSE_TOL, where neither overflowed, and each of its iterations fed to
   the model without reuse on the card bitwise, else within REUSE_TOL.
   Under the spatial lever an overflowed query samples the full set in
   index order (as the JAX package's does), so a comparison whose two
   sides' tables overflowed otherwise is printed, not gated. Frames/s,
   the profiler's device ms and idle share. The body query's reuse at the
   op level on the iteration-0 body query's inputs, in index order and
   under the spatial lever (the forwards' per-center steps exceed any
   margin that fits the cap, so no forward reuses): built at
   REUSE_OP_MARGIN (halved until it fits), centers moved by half the
   margin reuse the table (no coverage launch) bitwise a fresh call,
   moved by twice the margin rebuild it bitwise; a reusing and a fresh
   call's ms. The posed train step (B=4) under both levers (the smaller
   margin; at least one body query on a compacted table): the kernels
   launched (the scatter-add among them), finite losses and gradients, every trainable tensor moved, the
   canonical stage unchanged, the plain step's losses within 1e-3 and
   each iteration's backward within 1e-4 of the plain versions'
   (`teacher_forced_grads`); frames/s and a profile. The entry point under both flags (the
   smaller margin) on phase 7's tree: one posed epoch from phase 7's canonical checkpoint, and
   `--only_eval 1 --vis` of its posed checkpoint writing its 2 x 4 x 10 x
   4 files;
11. determinism, with torch's deterministic algorithms off: the default
   posed forward (phase 4's shapes) twice, every output tensor bitwise
   equal, and the posed train step (phase 5's, B=4) twice from fresh
   states, every loss, gradient, parameter and buffer bitwise equal (the
   mesh sums run over fixed incidence tables, `ops/meshmath.py`); the
   vertex normals' ms at the body's shape beside the `index_add_` form
   they replaced;
12. post-processing and body fitting (`data/postprocess.py`,
   `tools/transfer.py`, `tools/fit_body.py`) on phase 4's posed output
   (80 frames of the Vg=2000 ring against the 6890-vertex body):
   `laplacian_smooth` (100 steps) and `detect_penetration` over the 80
   frames with the launch counters at 0 before them (nn1 and gather_rows
   launched), each 1-NN launch ((80, 2000) vs 6890) bitwise its plain
   version in indices and squared distances and timed beside its bound
   and `cdist_min`, each row gather held bitwise as it runs and each case
   timed; `process_frame` with the garment faces on frame 0 of each
   sequence (the synthetic body's faces are a random soup with no inside
   or outside, where the removal stalls at 5 rounds as the JAX package's
   does: no more inside vertices after than before, the JAX test's gate)
   and on a closed pair (a 2000-vertex garment sphere inside a 6890-vertex
   body sphere: no inside vertex left after the last round, fewer rounds
   than 5): rounds, inside counts, ms split into the float64 projection on
   the card and the host's sparse solve; 512 points of a frame projected
   by the same function in float64 on the CPU (faces bitwise,
   barycentrics, points and normals within 1e-12); the LBFGS fit (200
   iterations) and the staged fit (60/120/120) at B=8 to targets of known
   parameters (seed 0), and the fit through a K=3 correspondence to a
   jittered 3000-vertex subset, each mean vertex residual within 0.02;
   wall ms of each;
13. the Trousers and Tshirt classes (`GarmentAssets.synthetic(name=...)`,
   the Vg=2000 ring) from `posed_synth.npz` at phase 4's shape: the
   parameter tree the Skirt model's; one counted posed forward each
   (every forward kernel launched, finite) and how many points the
   garment selection finds a frame; Trousers, whose garment samples are
   (32, 8, 4): every chain launch at S=4 held as phase 4 holds its cases
   (the kernel pads S to its 8-row tile), each refinement iteration
   teacher-forced against the CPU plain path within 1e-5, then its posed
   train step at phase 5's shape: counted, losses within 1e-3 of the plain
   path's, each iteration's backward within 1e-4 relative L2
   (`teacher_forced_grads`), every PE backward at S=4 held as phase 5
   holds its cases with its unmasked gradient differences printed, and
   the S=4 dtable half on a tie of slot 0 with an equal row
   (`check_padded_tie`);
14. the tracing tool: `tools/profile_posed.py` for `posed`, `canonical`
   and `train` at `--iters 2` (its step time and its per-kernel device ms,
   held against the launch counters by `utils/profiling.profile_device`);
15. the demos at their defaults, each through its gate: the GCN node
   demo (accuracy > 0.9), the PointNet++ segmentation demo (accuracy > 0.8;
   FPS, ball query, row gather, scatter-add and 3-NN launched; ms a step)
   and the SMPL demo (its OBJ, PNG and PLY written);
16. the flags the JAX package serves, `--bf16`, `--remat` and
   `--debug_nans`, at phases 4-6's shapes from `posed_synth.npz`: the
   canonical forward (B=8) at compute_dtype bf16, counted (FPS, flat
   query, row gather and 3-NN launched, the chain kernel not: its SA stages
   run unfused, as the JAX package's do under bf16), every FPS, flat-query,
   gather and 3-NN launch held bitwise to its plain version and each case
   timed, the outputs against the card's plain bf16 path teacher-forced on
   the same labels (within 2 bf16 ulps + 1e-3), 99% of the labels fp32's,
   and, fed fp32's labels, within the JAX package's `TestBf16Mode` bounds
   of the fp32 forward (garment summary rtol 0.15 / atol 0.3, T-pose
   garment 0.2; on its own labels printed), both forwards' frames/s,
   device ms and idle share; the canonical train step (B=20) in bf16,
   counted, its losses finite and within 1e-2 of the card's plain bf16
   step, and beside the fp32 step: frames/s, device ms, idle share and the
   train-mode BatchNorms' device ms replayed alone on the step's inputs;
   the posed forward (B=8) and train step (B=4) with a bf16 stage 1 beside
   fp32's; the posed train step's peak device memory and device ms at B=4
   and B=8 (the JAX package's `--remat` is for a B=8 step that does not
   fit; on the port `--remat 1` is a logged no-op); one posed
   train step with the NaN tripwire bitwise one without, its overhead in
   ms, then a parameter set to NaN, which must raise FloatingPointError
   naming it; each flag through `train_temporal.main` on phase 7's tree
   for one epoch (`--bf16` canonical, `--remat` and `--debug_nans` posed):
   finite losses, the kernels launched;
17. the JAX package's own shapes: the FPS kernel at more centers than
   points ((80, 512) -> 1024, (80, 128) -> 512, (80, 384) -> 512, (4, 5)
   -> 12, an all-equal (2, 300) -> 1024, a frame of pairwise duplicates)
   and past shared memory ((10, 20000) and (10, 65536) -> 1024, the wide
   kernel), each raising the `fps` counter by one, bitwise its plain
   version and timed beside its bound; `canonical` / `segment` on one
   sequence (B=1, T=10) of 512, 1536 and 20000 points, counted, every
   FPS, flat-query and 3-NN case bitwise and timed, every gather bitwise,
   every chain within rtol 1e-4 / atol 1e-5, the labels bitwise the
   card's plain path's (a near tie, within twice the paths' largest logit
   difference, is counted and printed), the outputs fed the kernel path's
   labels within 1e-5 of each tensor's scale; the posed forward at 512
   points, each refinement iteration teacher-forced on the card's plain
   path within 1e-5; the entry point `--synthetic_data 1 --npoints 512`,
   two epochs of the canonical stage, then of the posed stage from its
   checkpoint: counted, FPS launched past N, losses finite and moved;
18. prints a JSON line of the kernels (each row read from the costliest
   case, by plain ms, of the kernel's own main path: FPS from sa1 of the
   80-frame forward, not from the train steps' or phase 17's cases; the
   scatter-add from the canonical train step, not from the op-level dtable
   check), then the card line,
   then as the last line `{"ok": true, "device": {...}}`.

Any failure raises, so the script exits non-zero without the last line; so
it does when no CUDA device is visible or when the repo is not beside it.

    python3 chip_smoke.py --time-kernels [ROOT]
    python3 chip_smoke.py --ab PARENT

`--time-kernels` times, for the package in the checkout at ROOT (default:
this one), the posed forward (phase 4's shape and weights; frames/s,
device ms, the device ms per forward of the chain, GCN, K-NN, grouped and
flat ball-query, 3-NN, FPS and coverage kernels) and the canonical forward's
device ms;
the chain at each of its 16 shapes in the posed forward and the GCN stack
at its 195- and 323-wide shapes, on the inputs recorded from it (ms, the
largest difference to float64, the summed bounds; for the chain also one
4-wide linear layer on the same gathers, mostly the gather's time; for
the stack its plain version); the K-NN transfer at the forward's B=8 and
the posed train step's B=4 calls (ms, the largest difference to the
float64 transfer over its own selections), each of the forward's three
grouped ball-query launches (ms, bounds and their sums); the posed and
canonical train steps (frames/s, device ms, the same kernels' device ms
per step, the PE backward's and the scatter-add's), the PE backward at
each of its six shapes and its dtable half, and the scatter-add at each of
its 12 shapes beside one `index_add_`, on inputs recorded from the steps;
each coverage launch of the posed forward and each distinct FPS, flat
ball-query and 3-NN case of the posed forward and both train steps (FPS
also at phase 17's frames past shared memory; 3-NN
beside `torch.cdist` and a top-3), their sums over the posed forward;
each distinct 1-NN case of the posed train step and the canonical train
and eval steps beside `cdist_min`, their sum over the
posed train step (`nn1_ms_sum`, `nn1_bound_ms_sum`) and the 1-NN
pre-pass's device ms a posed train step; the device ms a call of each
path of the row gather and the banded product too; every row-gather case
of the posed forward and both train steps (`time_gathers`: ms, bound,
`index_select`) and their sums per path;
each path's profiled launches a call; the ptxas lines of the chain, GCN,
K-NN, ball-query, 3-NN, FPS and coverage kernels; one JSON line. The FPS,
coverage, flat, 3-NN and 1-NN bounds come from this checkout's launch
plans, so another checkout's run leaves them out.
`--ab` runs it for the checkout at PARENT (unpacked under `_archive/`) and
this one in turns, parent, change, change, parent, so that two checkouts
are compared in one run on one card, and prints the means (per shape: ms
and the float64 difference of both, and this checkout's bounds) and both
builds' ptxas lines.
"""

from __future__ import annotations

import contextlib
import json
import logging
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parent
B, T, N = 8, 10, 6890
RINGS, RING_SIZE = 125, 16  # the ring garment template, Vg = 2000
VG = RINGS * RING_SIZE
F = B * T
CHAIN_TOL = dict(rtol=1e-4, atol=1e-5)
KNN_TOL = dict(rtol=1e-4, atol=1e-6)
FORCED_TOL = 1e-5  # teacher-forced refinement, card vs CPU, every element
PEAK_FP32 = 67e12   # FLOP/s, H100 SXM fp32 outside the tensor cores
PEAK_HBM = 3.35e12  # bytes/s
CSRC = "garment4d_tpu_torch/ops/csrc/"
PALLAS = "garment4d_tpu/ops/pallas/"
# kernel: (source, the TPU kernel it replaces, main path it serves)
KERNELS = {
    "fps": ("fps.cu", "fps.py:65", "canonical"),
    "ball_query": ("ball_query.cu", "ball_query.py:466", "canonical"),
    "fused_chain": ("fused_chain.cu", "fusedpe.py:128", "canonical"),
    "three_nn": ("three_nn.cu", "three_nn.py:67", "canonical"),
    "gather_rows": ("gather.cu", "gather.py:70", "canonical"),
    "coverage": ("coverage.cu", "coverage.py:45", "posed"),
    "ball_query_grouped": ("ball_query.cu", "ball_query.py:401", "posed"),
    "group_pe_max": ("fused_chain.cu", "fusedpe.py:198", "posed"),
    "knn_transfer": ("knn_transfer.cu", "knn_transfer.py:142", "posed"),
    "gcn_stack": ("gcn_stack.cu", "gcnstack.py:111", "posed"),
    "pe_bwd": ("pe_bwd.cu", "fusedpe.py:559", "train"),
    "banded": ("banded.cu", "banded.py:56", "train"),
    "nn1": ("nn1.cu", "nn1.py:57", "train"),
    "scatter_add": ("scatter_add.cu", "scatter.py:79", "canonical_train"),
    # held against their plain versions at the op level; no main path calls them
    "pe_bwd_dtable": ("pe_bwd.cu", "fusedpe.py:559", None),
    "group_pe_max_nv": ("fused_chain.cu", "fusedpe.py:289", None),
}
CANONICAL_KERNELS = [k for k, v in KERNELS.items() if v[2] == "canonical"]
FORWARD_KERNELS = [k for k, v in KERNELS.items() if v[2] in ("canonical", "posed")]
POSED_TRAIN_KERNELS = FORWARD_KERNELS + [k for k, v in KERNELS.items() if v[2] == "train"]
# the canonical train step: the recipe's shape (scripts/train/train_skirt_canonical.sh)
CANON_B = 20
CANON_F = CANON_B * T
CANON_TRAIN_KERNELS = ["fps", "ball_query", "gather_rows", "three_nn", "nn1", "scatter_add"]
# a canonical-step gradient, kernel vs plain path, may differ by this many
# times the plain path's own run-to-run difference where that exceeds GRAD_TOL
SPREAD_FACTOR = 3
TRAIN_B = 4  # sequences per train step (the JAX package's train bench)
TRAIN_F = TRAIN_B * T
TRAIN_LR = 1e-3
GRAD_TOL = 1e-4  # teacher-forced gradients, kernel vs plain path, relative L2
LOSS_TOL = 1e-3  # loss terms of one train step, kernel vs plain path, relative
NEAR_TIE_CAP = 0.05  # most (center, channel) pairs of a PE backward masked as near-ties
# launches per train step at this shape: 3 iterations x (3 body + 3 garment)
# PE backwards; 3 loss 1-NN queries; 3 loss Laplacians forward and back plus
# 3 GCN recomputes x 4 layers forward and back
TRAIN_LAUNCHES = {"pe_bwd": 18, "nn1": 3, "banded": 30}
# launches per posed forward at this shape: the flat query's 5 SA stages and
# 3 iterations x 3 garment PE blocks, the 3-NN's 3 FP stages
POSED_LAUNCHES = {"ball_query": 14, "three_nn": 3}
# the MGN variant (`--MGN 1`): its eval-mode canonical stage and the
# single-NN LBS (one 1-NN and two 16-float row gathers a forward); its train
# step adds the loss's 1-NN and banded Laplacian
MGN_KERNELS = ["fps", "ball_query", "fused_chain", "three_nn", "gather_rows", "nn1", "nn1_sort"]
MGN_TRAIN_KERNELS = MGN_KERNELS + ["banded"]
MGN_LAUNCHES = {"nn1": 1}
MGN_TRAIN_LAUNCHES = {"nn1": 2}
# repeats of an exact `cdist` yardstick (0.3-1.4 s a call at the main
# paths' 3-NN and 1-NN shapes), after one warm-up
CDIST_REPS = 3
MGN_RUNS = 5  # timed forwards (median) of the MGN phase, after one warm-up
MGN_TRAIN_RUNS = 3  # timed train steps of the MGN phase, after one warm-up


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of `fn` over `reps` back-to-back calls, after one
    warm-up call, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(fn, runs: int = 5, warmup: int = 1) -> float:
    """Median wall time of `fn` (synchronised) over `runs` after `warmup`
    calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def load_profiling():
    """The package's profiler (`garment4d_tpu_torch/utils/profiling.py`:
    `profile_device`, `print_profile`) loaded from this checkout's file
    under a name of its own: an `--ab` run's `--time-kernels` process
    imports the package of a parent checkout, which may predate the module,
    and the profiler reads the launch counters of whichever package is
    imported."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "g4d_profiling", REPO / "garment4d_tpu_torch" / "utils" / "profiling.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


PROFILING = load_profiling()
profile_device, print_profile = PROFILING.profile_device, PROFILING.print_profile


def kernel_ms(fn, reps: int = 10) -> float:
    """Mean device time of `fn` over `reps` calls whose launches queue up
    behind a sleeping kernel, by CUDA events: the host's work between
    launches does not show, as it does in `cuda_ms` for kernels shorter
    than it (the profiler was seen to drop the events of short sessions)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)  # ~25 ms of the card, longer than enqueueing reps calls
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def capture_inputs(model, names):
    """Forward pre-hooks that record the positional inputs of submodules."""
    got, handles = {}, []
    for name in names:
        def hook(_mod, args, name=name):
            got[name] = args
        handles.append(model.get_submodule(name).register_forward_pre_hook(hook))
    return got, handles


@contextlib.contextmanager
def recording(owner, name, keep=None):
    """Record the arguments and result of every call of `owner.name` (a
    module's function or an object's method), or what `keep(args, kwargs,
    result)` makes of them (where holding the tensors would cost memory)."""
    calls = []
    fn = getattr(owner, name)
    own = name in vars(owner)

    def wrapper(*args, **kwargs):
        result = fn(*args, **kwargs)
        calls.append((args, kwargs, result) if keep is None else keep(args, kwargs, result))
        return result

    setattr(owner, name, wrapper)
    try:
        yield calls
    finally:
        if own:
            setattr(owner, name, fn)
        else:
            delattr(owner, name)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(n_bytes: float, n_ops: float):
    """The least time the card could take: (ms, "bytes" or "operations")."""
    t_bytes, t_ops = n_bytes / PEAK_HBM, n_ops / PEAK_FP32
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def gather_bytes(table, idx) -> int:
    """The bytes a row gather must move on this run's data: each 32-byte
    sector of the table that the rows it reads touch (indices in [-N, N),
    wrapped as the kernel wraps them; a NaN row reads nothing), read once;
    the indices read; the rows written."""
    Bt, Nt, C = table.shape
    i = idx.long()
    i = torch.where(i < 0, i + Nt, i)
    rows = (i + Nt * torch.arange(Bt, device=i.device)[:, None])[(i >= 0) & (i < Nt)].unique()
    start = table.data_ptr() % 32 + rows * (C * table.element_size())
    first, last = start // 32, (start + C * table.element_size() - 1) // 32
    # rows sorted: a row's sectors past those of the rows before it
    prev = torch.cat([last.new_full((1,), -1), last[:-1]])
    sectors = int((last - torch.maximum(first - 1, prev)).clamp_min(0).sum()) if C else 0
    return 32 * sectors + nbytes(idx) + idx.numel() * C * table.element_size()


def gather_bound(args, _kwargs, out) -> float:
    """A row gather's bound (ms): `bound` of its `gather_bytes` (a
    recording's `keep`)."""
    return bound(gather_bytes(*args), 0)[0]


def same_bits(a, b) -> bool:
    """Two tensors of one dtype and shape bitwise equal, NaN patterns
    included."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        ints = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.contiguous().view(ints), b.contiguous().view(ints))
    return torch.equal(a, b)


def gather_keep(args, kwargs, out) -> dict:
    """`gather_args`, after holding the launch bitwise to the plain version
    on its own inputs as it runs."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    row = gather_args(args, kwargs, out)
    require(same_bits(out, pc._gather_rows_plain(*args)),
            f"gather {row['case']}: differs from the plain version")
    return row


def gather_args(args, kwargs, out) -> dict:
    """A recording's `keep` for the row gather: the launch's case (table
    shape x rows a frame), bound (`gather_bound`) and inputs (detached: a
    train step's tables require grad, which the kernel refuses outside its
    autograd Function)."""
    table, idx = args
    return dict(case=f"{tuple(table.shape)} x {idx.shape[1]}",
                bound_ms=gather_bound(args, kwargs, out), args=(table.detach(), idx))


def index_select_of(table, idx):
    """The row gather's library yardstick: one `index_select` on the
    flattened (B*N, C) table (indices clamped into range), as a call."""
    Bt, Nt, C = table.shape
    flat = table.reshape(Bt * Nt, C)
    flat_idx = (idx.long().clamp(0, max(Nt - 1, 0))
                + Nt * torch.arange(Bt, device=idx.device)[:, None]).reshape(-1)
    return lambda: flat.index_select(0, flat_idx)


def gather_record(res, case, table, idx, **extra):
    """A row gather timed on its inputs: kernel ms (queued, `kernel_ms`),
    plain ms, bound (`gather_bytes`) and `index_select_of`'s ms."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    res.record("gather_rows", case, 0, lambda: pc._gather_rows_kernel(table, idx),
               lambda: pc._gather_rows_plain(table, idx), gather_bytes(table, idx), 0,
               library=index_select_of(table, idx), queued=True, **extra)


def record_gathers(label, rows, res, path):
    """The row-gather launches of one call of a path (`gather_keep` rows,
    each already held bitwise): each distinct case timed (`gather_record`)
    with its launch count; prints the bounds and returns their sum (ms)."""
    for case, (row, count) in by_case(rows).items():
        gather_record(res, f"{label} {case} x{count}", *row["args"], path=path,
                      launches=count)
    return print_launch_bounds("gather_rows", rows, per=label)


def banded_bound(args, _kwargs, out) -> float:
    """A banded product's bound (ms): the larger of its bytes (the
    diagonals and x read, the product written) and 2 operations a diagonal
    and element of x (a recording's `keep`)."""
    vals, x, offsets = args
    return bound(nbytes(vals, x, out), 2.0 * len(offsets) * x.numel())[0]


def scan_tests(outs, n_scan) -> int:
    """Distance tests that an early-exit ball query needs on this data: a
    center scans up to its S-th hit of every radius (slots strictly rising
    at S-1 mean S hits were found), else the whole scanned prefix."""
    need = None
    for out in outs:
        S = out.shape[-1]
        full = n_scan.to(torch.int64)[:, None].expand(out.shape[:2])
        if S >= 2:
            found = out[..., S - 1] > out[..., S - 2]
            n = torch.where(found, out[..., S - 1].to(torch.int64) + 1, full)
        else:
            n = full
        need = n if need is None else torch.maximum(need, n)
    return int(need.sum())


def coverage_tests(xyz, centers, radius) -> int:
    """Distance tests the coverage scan needs: each point up to its first
    center within `radius`, else all centers."""
    from garment4d_tpu_torch.ops.pointcloud import _f32, _sqdist

    r2, M, total = _f32(radius * radius), centers.shape[1], 0
    for p0 in range(0, xyz.shape[1], 256):
        hit = _sqdist(xyz[:, p0:p0 + 256, None, :], centers[:, None, :, :]) < r2
        first = torch.where(hit.any(-1), hit.to(torch.int8).argmax(-1) + 1,
                            torch.full(hit.shape[:2], M, device=hit.device))
        total += int(first.sum())
    return total


def nan_box(q):
    """The box (lo, hi) of each frame's points q (B, n, 3), NaN values left
    out, as the kernels' `block_bbox` forms it."""
    lo = torch.where(q.isnan(), torch.inf, q).amin(1, keepdim=True)
    hi = torch.where(q.isnan(), -torch.inf, q).amax(1, keepdim=True)
    return lo, hi


def curve_order(q, bits=None, box=None):
    """The order of each frame's points q (B, n, 3) along the Morton curve
    of 2^bits cells an axis (the coverage and FPS kernels' 8 by default)
    over their bounding box, or over `box` (lo, hi), as the kernels sort
    them (`common.cuh: morton_code`, `morton_cell`), up to the order within
    a cell."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    cells = pc._MORTON_CELLS if bits is None else 1 << bits
    bits = cells.bit_length() - 1
    qlo, qhi = nan_box(q) if box is None else box
    ext = qhi - qlo
    scale = torch.where(ext > 0, cells / ext, torch.zeros_like(ext))
    c = ((q - qlo) * scale).trunc().nan_to_num(0.0).clamp(0, cells - 1).to(torch.int64)
    code = torch.zeros(q.shape[:2], dtype=torch.int64, device=q.device)
    for bit in range(bits):
        for a in range(3):
            code |= ((c[..., a] >> bit) & 1) << (3 * bit + a)
    return code.argsort(dim=1, stable=True)


def sorted_tiles(p, tile, bits, box=None):
    """Each frame's points p (B, n, 3) in curve order (`curve_order`), NaN-
    padded to whole tiles: the order (B, n), the tiles (B, tiles, tile, 3)
    and their boxes (lo, hi; (B, tiles, 3) each, NaN values left out, +inf /
    -inf for none)."""
    Bp, n, _ = p.shape
    order = curve_order(p, bits, box)
    q = torch.gather(p, 1, order[..., None].expand_as(p))
    nt = -(-n // tile)
    q = torch.nn.functional.pad(q, (0, 0, 0, nt * tile - n), value=float("nan"))
    q = q.reshape(Bp, nt, tile, 3)
    lo = torch.where(q.isnan(), torch.inf, q).amin(2)
    hi = torch.where(q.isnan(), -torch.inf, q).amax(2)
    return order, q, lo, hi


def coverage_work(xyz, centers, radius) -> tuple:
    """(exact tests, box tests) that the coverage kernel needs on this data,
    under its launch plan (`_coverage_plan`: points a block, centers a tile,
    `dense`): each block's points in curve order (`curve_order`), each warp
    of 32 visiting the tiles in order while it has an open point; per tile a
    box test for each open point, and the tile's centers for each point
    whose box bound is below r^2 (for each open point where more than
    `dense` need the tile). A point closes at its first tile with a hit."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    Bc, Nc, _ = xyz.shape
    M = centers.shape[1]
    if M == 0 or Nc == 0:
        return 0, 0
    r2 = pc._f32(radius * radius)
    plan = pc._coverage_plan(Bc, Nc, M)
    tile, threads = plan["tile"], plan["threads"]
    nt = -(-M // tile)
    pad = torch.full((Bc, nt * tile - M, 3), float("nan"), device=xyz.device)
    tiles = torch.cat([centers, pad], 1).reshape(Bc, nt, tile, 3)
    lo = torch.where(tiles.isnan(), torch.inf, tiles).amin(2)
    hi = torch.where(tiles.isnan(), -torch.inf, tiles).amax(2)
    sizes = torch.full((nt,), tile, device=xyz.device)
    sizes[-1] = M - (nt - 1) * tile
    exact = box = 0
    for n0 in range(0, Nc, threads):
        q = xyz[:, n0:n0 + threads]
        q = torch.gather(q, 1, curve_order(q)[..., None].expand_as(q))
        d2 = pc._sqdist(q[:, :, None, None, :], tiles[:, None])  # (B, n, tiles, tile)
        hit = (d2 < r2).any(-1)
        lb = pc._box_lower_bound(q[:, :, None, :], lo[:, None], hi[:, None])
        need = ~(lb >= r2)
        first = torch.where(hit.any(-1), hit.to(torch.int8).argmax(-1), nt)
        w = -(-q.shape[1] // 32) * 32
        first = torch.nn.functional.pad(first, (0, w - q.shape[1]), value=-1)
        need = torch.nn.functional.pad(need, (0, 0, 0, w - q.shape[1]))
        t = torch.arange(nt, device=q.device)
        opened = first.reshape(Bc, -1, 32)[..., None] >= t  # (B, warps, 32, tiles)
        active = opened.any(2)
        n_open = opened.sum(2)
        n_need = (opened & need.reshape(Bc, -1, 32, nt)).sum(2)
        box += int((n_open * active).sum())
        # a center a lane for the needing points, else a point a lane
        exact += int((torch.where(n_need > plan["dense"], n_open, n_need) * sizes).sum())
    return exact, box


def coverage_launches(calls):
    """One row per recorded coverage launch of a forward: its case and
    bounds. `bound_ms`: the bytes (xyz and centers read, the mask written)
    or the work the culled kernel needs on this data (`coverage_work`: 9
    operations an exact test, 18 a box test), whichever is larger; beside
    it `scan_bound_ms`, the first-hit linear scan's tests (9 operations
    each, `coverage_tests`), the parent kernel's bound."""
    rows = []
    for (xyz, centers, radius), _, out in calls:
        Bc, Nc = xyz.shape[:2]
        nb = nbytes(xyz, centers, out)
        exact, boxes = coverage_work(xyz, centers, radius)
        ops = 9.0 * exact + 18.0 * boxes
        b_ms, b_by = bound(nb, ops)
        rows.append(dict(case=f"body ({Bc}, {Nc}) x {centers.shape[1]} centers, r {radius}",
                         args=(xyz, centers, radius), bound_ms=b_ms, bound_by=b_by, ops=ops,
                         scan_bound_ms=bound(nb, 9.0 * coverage_tests(xyz, centers, radius))[0],
                         bytes_ms=bound(nb, 0)[0], exact_tests=exact, box_tests=boxes,
                         nbytes=nb, launches=1))
    return rows


def fps_work(xyz, npoint, idx) -> tuple:
    """(distance updates, box tests) that the FPS kernel needs on this data,
    given its output `idx` (B, npoint), npoint above N included: every
    point each step (the register, staged and wide instances), but in the
    kernel that skips far warps (`_fps_plan`'s `far`), where each warp's run
    of 32 x ppt points along the frame's curve (`curve_order`) takes a box
    test a step after the first and is updated only where the bound from
    the step's new point to its box is below the run's largest running
    distance (a NaN bound never skips)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    Bf, Nf, _ = xyz.shape
    steps = npoint - 1
    plan = pc._fps_plan(Bf, Nf, npoint)
    if not plan["far"] or steps == 0:
        return Bf * Nf * steps, 0
    run = 32 * plan["ppt"]
    nr = -(-Nf // run)
    q = torch.gather(xyz, 1, curve_order(xyz)[..., None].expand_as(xyz))
    real = torch.nn.functional.pad(torch.ones(Bf, Nf, dtype=torch.bool, device=xyz.device),
                                   (0, nr * run - Nf)).reshape(Bf, nr, run)
    q = torch.nn.functional.pad(q, (0, 0, 0, nr * run - Nf)).reshape(Bf, nr, run, 3)
    lo = torch.where(real[..., None], q, torch.inf).amin(2)
    hi = torch.where(real[..., None], q, -torch.inf).amax(2)
    sizes = real.sum(-1)
    mind = torch.full((Bf, nr, run), 1e10, device=xyz.device)
    rows = torch.arange(Bf, device=xyz.device)
    updates = torch.zeros((), dtype=torch.int64, device=xyz.device)
    for j in range(1, npoint):
        p = xyz[rows, idx[:, j - 1].long()]  # (B, 3): the step's new point
        d2 = pc._sqdist(q, p[:, None, None, :])
        if j > 1:
            top = torch.where(real, mind, -torch.inf).amax(-1)
            active = ~(pc._box_lower_bound(p[:, None, :], lo, hi) >= top)
            updates += (active * sizes).sum()
        else:
            updates += sizes.sum()
        # a skipped run's distances cannot drop: the update leaves it as is
        mind = torch.minimum(mind, d2)
    return int(updates), Bf * nr * (steps - 1)


def query_kept(xyz, centers, r2max, tiled=None):
    """The tiles of the flat query's sorted frames (its points along the
    curve of 16 cells an axis in tiles of 32, `sorted_tiles`, or `tiled`)
    that a warp per center tests: (order (B, N), super boxes kept (B, M,
    supers), tiles kept (B, M, tiles)). A super box (32 tiles) or tile box is
    kept unless its bound is >= r2max (a NaN bound never skips); a tile only
    where its super box is too."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    Bq, Nq, _ = xyz.shape
    order, _, lo, hi = tiled or sorted_tiles(xyz, pc._FLAT_TILE, 4)
    tiles = lo.shape[1]
    supers = -(-tiles // 32)
    pad = supers * 32 - tiles
    slo = torch.nn.functional.pad(lo, (0, 0, 0, pad), value=float("inf"))
    shi = torch.nn.functional.pad(hi, (0, 0, 0, pad), value=float("-inf"))
    slo, shi = slo.reshape(Bq, supers, 32, 3).amin(2), shi.reshape(Bq, supers, 32, 3).amax(2)
    c = centers[:, :, None, :]
    need_s = ~(pc._box_lower_bound(c, slo[:, None], shi[:, None]) >= r2max)
    need_t = ~(pc._box_lower_bound(c, lo[:, None], hi[:, None]) >= r2max)
    return order, need_s, need_t & need_s.repeat_interleave(32, dim=-1)[..., :tiles]


def query_work(xyz, new_xyz, radii, outs) -> tuple:
    """(exact tests, box tests, bitmap words walked) that the flat query
    needs on this data (its outputs `outs`, one per radius) under its
    launch plan (`_flat_plan`), up to three radii a launch. A lane per
    center (frames of at most _FLAT_UNSORTED points) tests points in index
    order up to the S-th hit of every radius (`scan_tests`), with no box. A
    warp per center over a sorted frame tests every super box (one per 32
    tiles), the tile boxes of each super box it keeps and the 32 points of
    each tile it keeps (`query_kept`), then walks its R bitmaps: every hit
    lies in a kept tile, since a box bound never exceeds a distance."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    Bq, Nq, _ = xyz.shape
    M = new_xyz.shape[1]
    exact = boxes = words = 0
    tiled = None
    for i in range(0, len(radii), pc._FLAT_MAX_RADII):
        rs, os_ = radii[i:i + pc._FLAT_MAX_RADII], outs[i:i + pc._FLAT_MAX_RADII]
        plan = pc._flat_plan(Bq, Nq, M, len(rs), 1)
        if not plan["sort"]:
            exact += scan_tests(os_, torch.full((Bq,), Nq, device=xyz.device))
            continue
        r2max = max(pc._r2(r) for r in rs)
        tiles, supers = plan["tiles"], plan["supers"]
        tiled = tiled or sorted_tiles(xyz, pc._FLAT_TILE, 4)
        per_super = torch.full((supers,), 32, device=xyz.device)
        per_super[-1] = tiles - 32 * (supers - 1)
        windows = -(-Nq // (32 * plan["words"]))
        for m0 in range(0, M, 256):
            _, need_s, need_t = query_kept(xyz, new_xyz[:, m0:m0 + 256], r2max, tiled)
            boxes += windows * int(supers * need_s.shape[0] * need_s.shape[1]
                                   + (need_s * per_super).sum())
            exact += 32 * int(need_t.sum())
        words += windows * len(rs) * plan["words"] * Bq * M
    return exact, boxes, words


def query_ops(xyz, new_xyz, radii, outs) -> float:
    """Operations the flat query needs on this data (`query_work`): 8 a
    distance and one a radius an exact test, 18 a box test, 4 a bitmap word
    walked."""
    exact, boxes, words = query_work(xyz, new_xyz, radii, outs)
    return (8.0 + min(len(radii), 3)) * exact + 18.0 * boxes + 4.0 * words


def nearest_kept(unknown, known, d2, tile):
    """The known tiles that each query of a nearest-neighbour search's sorted
    path (3-NN, 1-NN) needs, given the squared distances `d2` (B, n, K) of
    its result: along the curve of 16 cells an axis over the known points'
    box, the known points in tiles (`sorted_tiles`) and the queries in
    order; a query needs a tile whose box bound is not above its final K-th
    distance (a NaN bound never skips). Returns (known order (B, m), query
    order (B, n), needed tiles (B, n, tiles) of the queries in their
    order)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    order_k, _, lo, hi = sorted_tiles(known, tile, 4)
    order_q = curve_order(unknown, 4, nan_box(known))
    q = torch.gather(unknown, 1, order_q[..., None].expand_as(unknown))
    bk = torch.gather(d2[..., -1], 1, order_q)
    need = torch.cat([~(pc._box_lower_bound(q[b0:b0 + 8, :, None, :], lo[b0:b0 + 8, None],
                                            hi[b0:b0 + 8, None]) > bk[b0:b0 + 8, :, None])
                      for b0 in range(0, q.shape[0], 8)])
    return order_k, order_q, need


def nearest_work(unknown, known, d2, plan) -> tuple:
    """(lane tests, box tests) that a nearest-neighbour search (three_nn.cu,
    nn1.cu: common.cuh's `nearest_query`) needs on this data under its
    launch plan, given the squared distances `d2` (B, n, K) of its result. A
    small known set is scanned whole by every query. Else a warp of 32
    queries in curve order visits, a known point a test for each of its
    lanes, every tile one of its queries needs (`nearest_kept`: the least
    its walk can visit, since a lane's bound only shrinks to its final K-th
    distance), and tests each tile's box against its queries' box (a lane a
    tile) and each visited tile's against each lane."""
    Bk, n, _ = unknown.shape
    kt, tiles = plan["tile"], plan["tiles"]
    if not plan["sort"] or n == 0:
        return Bk * n * tiles * kt, 0
    w = -(-n // 32)
    lanes = torch.full((w,), 32, device=unknown.device)
    lanes[-1] = n - 32 * (w - 1)
    tests = fine = 0
    for b0 in range(0, Bk, 8):
        need = nearest_kept(unknown[b0:b0 + 8], known[b0:b0 + 8], d2[b0:b0 + 8], kt)[2]
        need = torch.nn.functional.pad(need, (0, 0, 0, 32 * w - n)).reshape(-1, w, 32, tiles)
        kept = need.any(2).sum(-1)  # (b, warps)
        tests += int((kept * lanes * kt).sum())
        fine += int((kept * lanes).sum())
    return tests, Bk * w * tiles + fine


def three_nn_work(unknown, known, d2) -> tuple:
    """`nearest_work` of the 3-NN kernel (`_three_nn_plan`), given its
    squared distances `d2` (B, n, 3)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    plan = pc._three_nn_plan(unknown.shape[0], unknown.shape[1], known.shape[1])
    return nearest_work(unknown, known, d2, plan)


def nn1_work(query, points, d2) -> tuple:
    """`nearest_work` of the 1-NN kernel (`_nn1_plan`), given its squared
    distances `d2` (B, M)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    plan = pc._nn1_plan(query.shape[0], query.shape[1], points.shape[1], 1)
    return nearest_work(query, points, d2[..., None], plan)


def three_nn_ops(unknown, known, d2) -> float:
    """Operations the 3-NN kernel needs on this data (`three_nn_work`): 12 a
    lane test (8 for the distance, the compare with the third distance and
    its share of the insertions), 18 a box test."""
    tests, boxes = three_nn_work(unknown, known, d2)
    return 12.0 * tests + 18.0 * boxes


def nn1_ops(query, points, d2) -> float:
    """Operations the 1-NN kernel needs on this data (`nn1_work`): 10 a lane
    test (8 for the distance, the compare and its share of the insertion),
    18 a box test."""
    tests, boxes = nn1_work(query, points, d2)
    return 10.0 * tests + 18.0 * boxes


def chain_plain(table, idx, centers, weights, biases, relus, n_valid=None):
    """The chain's plain version (every gather plain too), with the
    valid-count check when `n_valid` is given."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.ops import pemax

    with ops.plain_ops():
        return pemax._chain(table, idx, centers, weights, biases, relus, "plain", n_valid)


def chain_ops(idx, table, weights) -> float:
    Bc, M, S = idx.shape
    widths = [table.shape[-1]] + [w.shape[1] for w in weights]
    return 2.0 * Bc * M * S * sum(a * b for a, b in zip(widths, widths[1:]))


def gcn_layer_ops(frames, V, K, F, D) -> float:
    """Operations of one GCN layer: the product (2KF per vertex) and the
    banded sum on its narrower side (2D min(K, F)), the lesser of the two
    orders (adj @ h) @ W and adj @ (h @ W)."""
    return 2.0 * frames * V * (K * F + D * min(K, F))


@torch.no_grad()
def chain_float64(table, idx, centers, weights, biases, relus):
    """The chain's plain version in float64 from the fp32 inputs."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.ops import pemax

    with ops.plain_ops():
        return pemax._chain_reference(table.double(), idx, centers.double(),
                                      [w.double() for w in weights],
                                      [b.double() for b in biases], relus)


def band_matrix(vals, offsets):
    """The dense (V, V) matrix whose cyclic diagonal offsets[d] holds vals[d]."""
    V = vals.shape[1]
    adj = torch.zeros(V, V, dtype=vals.dtype, device=vals.device)
    rows = torch.arange(V, device=vals.device)
    for d, o in enumerate(offsets):
        adj[rows, (rows + int(o)) % V] = vals[d]
    return adj


@torch.no_grad()
def gcn_float64(xs, weights, biases, vals, offsets, relus, hidden_layer):
    """The GCN stack's plain version, adj @ (h @ W) + b per layer, in
    float64 from the fp32 inputs: (out, hidden)."""
    h = torch.cat([x.double() for x in xs], -1)
    hidden = None
    for i, (w, b, r) in enumerate(zip(weights, biases, relus)):
        s = torch.matmul(h, w.double())
        h = sum(vals[d].double()[:, None] * torch.roll(s, -int(o), dims=-2)
                for d, o in enumerate(offsets)) + b.double()
        if r:
            h = torch.relu(h)
        if i == hidden_layer:
            hidden = h
    return h, hidden


@torch.inference_mode()
def record_chain_gcn(recon, pcd, body_in):
    """The chain-kernel and GCN-stack launches of one posed forward, with
    their arguments: (chain calls, GCN-stack calls) as `recording` keeps
    them (a stack call launches one kernel per layer)."""
    from garment4d_tpu_torch.ops import graph, pemax

    with recording(pemax, "_chain_kernel") as ccalls, \
            recording(graph, "_gcn_stack_kernel") as gcalls:
        recon.posed(pcd, body_in)
    torch.cuda.synchronize()
    return ccalls, gcalls


def chain_launches(ccalls):
    """One row per recorded chain launch: its case, arguments and bound;
    the launches of one shape share a case."""
    rows = []
    for args, kwargs, out in ccalls:
        table, idx, centers, ws, bs, relus, name = args[:7]
        widths = [table.shape[-1]] + [w.shape[1] for w in ws]
        case = f"{name} {tuple(idx.shape)} widths {widths}"
        b_ms, b_by = bound(nbytes(table, idx, centers, out, *ws, *bs),
                           chain_ops(idx, table, ws))
        rows.append(dict(case=case, name=name, args=args, kwargs=kwargs,
                         bound_ms=b_ms, bound_by=b_by))
    return rows


def gcn_launches(gcalls):
    """One row per recorded GCN stack: its case, arguments and the bound
    of each of its layer launches (inputs read, output written once)."""
    rows = []
    for args, _, _ in gcalls:
        xs, ws, bs, vals, offsets, relus, hidden_layer = args
        frames, V = xs[0].shape[:2]
        D = len(offsets)
        widths = [sum(x.shape[-1] for x in xs)] + [w.shape[1] for w in ws]
        layer_bounds = [bound(4.0 * (frames * V * (K + Fo) + K * Fo + Fo + D * V),
                              gcn_layer_ops(frames, V, K, Fo, D))[0]
                        for K, Fo in (w.shape for w in ws)]
        rows.append(dict(case=f"({frames}, {V}) widths {widths}, {D} diagonals",
                         args=args, layer_bounds=layer_bounds, bound_ms=sum(layer_bounds)))
    return rows


def by_case(rows):
    """{case: (first row of the case, number of rows)} in first-seen order."""
    cases = {}
    for row in rows:
        first, n = cases.get(row["case"], (row, 0))
        cases[row["case"]] = (first, n + 1)
    return cases


def print_launch_bounds(label, rows, launches_per_row=1, per="posed forward"):
    """Print each case's count and bound and the summed bound of the
    launches of one call of a path (a row's `launches`, else
    `launches_per_row`, each); returns the sum (ms)."""
    total = sum(r["bound_ms"] for r in rows)
    for case, (row, count) in by_case(rows).items():
        print(f"{label} {case}: x{count}, bound {row['bound_ms']:.4f} ms each", flush=True)
    launches = sum(r.get("launches", launches_per_row) for r in rows)
    print(f"{label}: {launches} launches per {per}, summed bound {total:.4f} ms", flush=True)
    return total


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


@torch.inference_mode()
def check_chain_case(case, row, count, res: Results, label="posed forward", path=None):
    """One recorded chain launch (`chain_launches`), standing for the
    `count` launches of its shape: the kernel within CHAIN_TOL of its plain
    version and of its float64 version, two launches bitwise equal, timed
    beside its bound (on the call's own slots: S before the kernel's
    padding to its 8-row tile) and its plain version."""
    from garment4d_tpu_torch.ops import pemax

    args, kwargs = row["args"], row["kwargs"]
    table, idx, centers, ws, bs, relus, name = args[:7]
    out_k = pemax._chain_kernel(*args, **kwargs)
    require(torch.equal(out_k, pemax._chain_kernel(*args, **kwargs)),
            f"chain {case}: two launches differ")
    out_p = chain_plain(table, idx, centers, ws, bs, relus)
    ref = chain_float64(table, idx, centers, ws, bs, relus)
    err, err64 = max_abs(out_k, out_p), max_abs(out_k, ref)
    require(torch.allclose(out_k, out_p, **CHAIN_TOL),
            f"chain {case}: max abs err {err} beyond {CHAIN_TOL}")
    require(torch.allclose(out_k.double(), ref, **CHAIN_TOL),
            f"chain {case}: max abs err {err64} to float64 beyond {CHAIN_TOL}")
    del ref
    res.record(name, f"{label} {case} x{count}", err,
               lambda: pemax._chain_kernel(*args, **kwargs),
               lambda: chain_plain(table, idx, centers, ws, bs, relus),
               nbytes(table, idx, centers, out_k, *ws, *bs), chain_ops(idx, table, ws),
               err_float64=err64, launches_per_forward=count, path=path)


@torch.inference_mode()
def check_chain_gcn(recon, pcd, body_in, res: Results):
    """Every chain and GCN-stack launch of one posed forward, recorded with
    its inputs: the summed bounds printed, and at each distinct shape the
    kernel within CHAIN_TOL of its plain version and of its float64
    version, two launches bitwise equal, timed beside its bound and its
    plain version. Returns the two summed bounds (ms)."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.ops import graph

    ccalls, gcalls = record_chain_gcn(recon, pcd, body_in)
    chains, stacks = chain_launches(ccalls), gcn_launches(gcalls)
    del ccalls, gcalls
    sums = dict(chain=print_launch_bounds("chain", chains),
                gcn=print_launch_bounds("gcn_stack", stacks, 4))
    for case, (row, count) in by_case(chains).items():
        check_chain_case(case, row, count, res)
    for case, (row, count) in by_case(stacks).items():
        xs, ws, bs, vals, offsets, relus, hidden_layer = args = row["args"]
        adj = band_matrix(vals, offsets)
        ko, kh = graph._gcn_stack_kernel(*args)
        require(all(torch.equal(a, b) for a, b in zip((ko, kh), graph._gcn_stack_kernel(*args))),
                f"gcn stack {case}: two launches differ")

        def plain():
            with ops.plain_ops():
                return graph._gcn_stack_ref(xs, ws, bs, adj, offsets, relus, hidden_layer)

        po, ph = plain()
        ro, rh = gcn_float64(*args)
        err = max(max_abs(ko, po), max_abs(kh, ph))
        err64 = max(max_abs(ko, ro), max_abs(kh, rh))
        require(torch.allclose(ko, po, **CHAIN_TOL) and torch.allclose(kh, ph, **CHAIN_TOL),
                f"gcn stack {case}: max abs err {err} beyond {CHAIN_TOL}")
        require(torch.allclose(ko.double(), ro, **CHAIN_TOL)
                and torch.allclose(kh.double(), rh, **CHAIN_TOL),
                f"gcn stack {case}: max abs err {err64} to float64 beyond {CHAIN_TOL}")
        del po, ph, ro, rh
        frames, V = xs[0].shape[:2]
        res.record("gcn_stack", f"posed forward {case} x{count}", err,
                   lambda: graph._gcn_stack_kernel(*args), plain,
                   nbytes(*xs, *ws, *bs, vals, ko, kh),
                   sum(gcn_layer_ops(frames, V, *w.shape, len(offsets)) for w in ws),
                   err_float64=err64, launches_per_forward=4 * count)
    return sums


class Results:
    def __init__(self):
        self.cases = {k: [] for k in KERNELS}

    def record(self, kernel, case, err, fn_k, fn_p, n_bytes, n_ops,
               reps_k=20, reps_p=3, library=None, queued=False, path=None, reps_l=None,
               **extra):
        """`queued`: the kernel's ms by `kernel_ms` (for launches shorter
        than their host work), else by `cuda_ms`. `path`: the main path
        whose inputs the case takes, where it is not the kernel's own
        (`KERNELS`); the kernels line reads a case of the kernel's own.
        `reps_l`: the library call's repeats (default `reps_k`; fewer for
        an exact `cdist` yardstick of a second or more)."""
        b_ms, b_by = bound(n_bytes, n_ops)
        ms = kernel_ms(fn_k, reps_k) if queued else cuda_ms(fn_k, reps_k)
        row = dict(case=case, max_abs_err=float(err), ms=ms,
                   plain_ms=cuda_ms(fn_p, reps_p), bound_ms=b_ms, bound_by=b_by,
                   library_ms=None if library is None else cuda_ms(library, reps_l or reps_k),
                   **extra)
        if path is not None:
            row["path"] = path
        self.cases[kernel].append(row)
        lib = "" if library is None else f" library_ms={row['library_ms']:.4f}"
        print(f"kernel {kernel:18s} {case:52s} max_abs_err={err:.3e} "
              f"ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} "
              f"bound_ms={b_ms:.4f} ({b_by}){lib}", flush=True)


@torch.inference_mode()
def check_kernels(recon, pcd, res: Results):
    """The canonical stage's kernels against their plain versions."""
    from garment4d_tpu_torch.ops import pemax, pointcloud as pc

    model = recon.canonical_model
    got, handles = capture_inputs(
        model, ["pointnet.sa3", "pointnet.fp1", "garment_sa2"])
    recon.run(pcd)
    for h in handles:
        h.remove()
    torch.cuda.synchronize()
    xyz0 = pcd.reshape(F, N, 3).contiguous()

    # FPS, sa1: 80 x 6890 -> 1024 (the distance updates and box tests of
    # this data, `fps_ops`)
    k = pc._fps_kernel(xyz0, 1024)
    require(torch.equal(k, pc._fps_plain(xyz0, 1024)), "fps indices differ from the plain version")
    res.record("fps", f"sa1 ({F}, {N}) -> 1024", 0,
               lambda: pc._fps_kernel(xyz0, 1024), lambda: pc._fps_plain(xyz0, 1024),
               nbytes(xyz0, k), fps_ops(xyz0, 1024, k), reps_k=5, reps_p=1,
               scan_bound_ms=bound(nbytes(xyz0, k), 10.0 * F * N * 1023)[0])

    def gather_case(case, table, idx):
        out = pc._gather_rows_kernel(table, idx)
        require(same_bits(out, pc._gather_rows_plain(table, idx)),
                f"gather {case} differs from the plain version")
        gather_record(res, case, table, idx)
        return out

    centers = gather_case(f"sa1 centers ({F}, {N}, 3) x 1024", xyz0, k)

    # ball query, sa1: radii 0.05 / 0.1, S 16 / 32, 1024 centers, 6890 points
    radii, ns = (0.05, 0.1), (16, 32)
    qk = pc._ball_query_kernel(radii, ns, xyz0, centers)
    for a, r, s in zip(qk, radii, ns):
        require(torch.equal(a, pc._ball_query_plain(r, s, xyz0, centers)),
                "ball query indices differ from the plain version")
    full = torch.full((F,), N, device=xyz0.device)
    res.record("ball_query", f"sa1 ({F}, {N}) x 1024, r .05/.1, S 16/32", 0,
               lambda: pc._ball_query_kernel(radii, ns, xyz0, centers),
               lambda: [pc._ball_query_plain(r, s, xyz0, centers) for r, s in zip(radii, ns)],
               nbytes(xyz0, centers, *qk), query_ops(xyz0, centers, radii, qk), queued=True,
               scan_bound_ms=bound(nbytes(xyz0, centers, *qk), 10.0 * scan_tests(qk, full))[0])

    # 3-NN, fp1: 6890 unknown vs 1024 known
    unknown, known, _, known_feats = got["pointnet.fp1"]
    dk, ik = pc._three_nn_kernel(unknown, known)
    dp, ip = pc._three_nn_plain(unknown, known)
    require(torch.equal(ik, ip), "3-NN indices differ from the plain version")
    require(torch.equal(dk, dp), "3-NN squared distances differ from the plain version")
    res.record("three_nn", f"fp1 ({F}, {N}) vs 1024", 0,
               lambda: pc._three_nn_kernel(unknown, known),
               lambda: pc._three_nn_plain(unknown, known),
               nbytes(unknown, known, dk, ik), three_nn_ops(unknown, known, dk), queued=True,
               library=lambda: cdist_top3(unknown, known), reps_l=CDIST_REPS,
               scan_bound_ms=bound(nbytes(unknown, known, dk, ik),
                                   9.0 * F * N * known.shape[1])[0])

    feats = known_feats.contiguous()
    gather_case(f"fp1 interp {tuple(feats.shape)} x {N * 3}", feats,
                ik.reshape(F, -1).contiguous())

    # fused chain: sa1 mlp1, sa3 mlp1, garment_sa2 mlp1 with folded weights
    def chain_case(name, sa, xyz, features, scale):
        xyz = xyz.contiguous()
        ctr = pc._gather_rows_kernel(xyz, pc._fps_kernel(xyz, sa.npoint))
        idx = pc._ball_query_kernel((sa.radii[scale],), (sa.nsamples[scale],), xyz, ctr)[0]
        table = (torch.cat([xyz, features], -1) if features is not None else xyz).contiguous()
        ws, bs = getattr(sa, f"mlp{scale}").folded()
        relus = (True,) * len(ws)
        out_k = pemax._chain_kernel(table, idx, ctr, ws, bs, relus)
        out_p = chain_plain(table, idx, ctr, ws, bs, relus)
        err = (out_k - out_p).abs().max().item()
        require(torch.allclose(out_k, out_p, **CHAIN_TOL),
                f"fused chain {name}: max abs err {err} beyond {CHAIN_TOL}")
        widths = [table.shape[-1]] + [w.shape[1] for w in ws]
        res.record("fused_chain", f"{name} {tuple(idx.shape)} widths {widths}", err,
                   lambda: pemax._chain_kernel(table, idx, ctr, ws, bs, relus),
                   lambda: chain_plain(table, idx, ctr, ws, bs, relus),
                   nbytes(table, idx, ctr, out_k, *ws, *bs), chain_ops(idx, table, ws))

    chain_case("sa1.mlp1", model.pointnet.sa1, xyz0, None, 1)
    sa3_xyz, sa3_feat = got["pointnet.sa3"][:2]
    chain_case("sa3.mlp1", model.pointnet.sa3, sa3_xyz, sa3_feat, 1)
    g_xyz, g_feat = got["garment_sa2"][:2]
    chain_case("garment_sa2.mlp1", model.garment_sa2, g_xyz, g_feat, 1)


def knn_plain_selection(d2, k):
    """The plain version's fp32 selection of each row's k nearest (every
    entry below the k-th smallest bit pattern, then ties in index order):
    (B, Vg, N) bool."""
    from garment4d_tpu_torch.models import skinning

    bits = d2.clamp_min(0.0).view(torch.int32)
    t = skinning._kth_smallest_bits(bits, k)
    below, tie = bits < t, bits == t
    extra = k - below.sum(-1, keepdim=True)
    return below | (tie & (torch.cumsum(tie, -1) <= extra))


@torch.inference_mode()
def knn_selection(garment, body, k, k64):
    """The K-NN kernel's own selections of k and k64 neighbours, read back
    through its output: on one-hot w0 blocks of 32 body points it returns
    each point's normalised weight, nonzero where the point is selected
    and its 1/d^2 finite (a row whose selected points all lie at distance
    0 is NaN, and reads as none): (2, B, Vg, N) bool."""
    from garment4d_tpu_torch.models import skinning

    (B, Vg, _), N, dev = garment.shape, body.shape[1], garment.device
    sel = torch.zeros(2, B, Vg, N, dtype=torch.bool, device=dev)
    eye = torch.eye(32, device=dev)
    for n0 in range(0, N, 32):
        J = min(32, N - n0)
        onehot = torch.zeros(B, N, J, device=dev)
        onehot[:, n0:n0 + J] = eye[:J, :J]
        for i, q in enumerate(skinning._knn_transfer_kernel(garment, body, onehot, k, k64)[:2]):
            sel[i, :, :, n0:n0 + J] = (q != 0) & ~torch.isnan(q)
    return sel


@torch.inference_mode()
def knn_float64(garment, body, w0, sel):
    """The transfer over the selection `sel` (B, Vg, N) in float64: 1/d^2
    from the fp32 coordinates, infs zeroed, normalised, infs zeroed again,
    contracted with w0."""
    from garment4d_tpu_torch.models import skinning
    from garment4d_tpu_torch.ops.pointcloud import pairwise_sqdist

    p, w64 = body.double(), w0.double()
    outs = []
    for v0 in range(0, garment.shape[1], 500):
        d2 = pairwise_sqdist(garment[:, v0:v0 + 500].double(), p)
        w = torch.where(sel[:, v0:v0 + 500], 1.0 / d2, torch.zeros_like(d2))
        outs.append(torch.einsum("bvn,bnj->bvj", skinning._normalize_inf_zeroed(w), w64))
    return torch.cat(outs, 1)


@torch.inference_mode()
def knn_float64_err(garment, body, w0, k, k64, outs):
    """The kernel's (outk, out64) against the float64 transfer given the
    kernel's own selections: (largest difference, whether both are within
    KNN_TOL of it, the selections). A row whose selected points all lie at
    distance 0 is NaN in both."""
    sel = knn_selection(garment, body, k, k64)
    refs = [knn_float64(garment, body, w0, s) for s in sel]
    err = max(float((o.double() - r).abs().nan_to_num(0.0).max()) for o, r in zip(outs, refs))
    ok = all(torch.allclose(o.double(), r, **KNN_TOL, equal_nan=True)
             for o, r in zip(outs, refs))
    return err, ok, sel


@torch.inference_mode()
def check_knn(label, args, res: Results, path=None):
    """The K-NN transfer on one recorded call's inputs: the 1-NN bitwise
    the plain version's; the kernel's selections those of the plain
    version wherever 1/d^2 is finite (elsewhere a point weighs 0 either
    way); the weights within KNN_TOL of the plain version and of the
    float64 transfer over the kernel's selections; timed. `path`: the main
    path the call comes from, where it is not the kernel's own."""
    from garment4d_tpu_torch.models import skinning
    from garment4d_tpu_torch.ops.pointcloud import pairwise_sqdist

    garment, body, w0, k, k64 = (a.contiguous() if torch.is_tensor(a) else a for a in args)
    kk, k6, ki = skinning._knn_transfer_kernel(garment, body, w0, k, k64)
    pk, p6, pi = skinning._knn_transfer_plain(garment, body, w0, k, k64)
    require(torch.equal(ki, pi), f"K-NN {label}: 1-NN indices differ from the plain version")
    err64, ok64, sel = knn_float64_err(garment, body, w0, k, k64, (kk, k6))
    d2 = pairwise_sqdist(garment, body)
    finite = torch.isfinite(1.0 / d2)
    for s, kn in zip(sel, (k, k64)):
        differ = int(((s ^ knn_plain_selection(d2, kn)) & finite).sum())
        require(differ == 0, f"K-NN {label}: {differ} selections of k={kn} differ from the "
                f"plain version's")
    del sel, d2, finite
    err = max(max_abs(kk, pk), max_abs(k6, p6))
    print(f"K-NN {label}: selections equal the plain version's; max abs err {err:.3e} to "
          f"plain, {err64:.3e} to float64", flush=True)
    require(torch.allclose(kk, pk, **KNN_TOL) and torch.allclose(k6, p6, **KNN_TOL),
            f"K-NN {label}: max abs err {err} beyond {KNN_TOL}")
    require(ok64, f"K-NN {label}: max abs err {err64} to float64 beyond {KNN_TOL}")
    Bk, Vg, _ = garment.shape
    J = w0.shape[-1]
    res.record("knn_transfer", f"{label} ({Bk}, {Vg}) vs {body.shape[1]}, K={k}, K64={k64}, "
               f"J={J}", err,
               lambda: skinning._knn_transfer_kernel(garment, body, w0, k, k64),
               lambda: skinning._knn_transfer_plain(garment, body, w0, k, k64),
               nbytes(garment, body, w0, kk, k6, ki),
               10.0 * Bk * Vg * body.shape[1] + 2.0 * Bk * Vg * (k + k64) * J,
               err_float64=err64, path=path)


def query_case(args, grouped=False) -> str:
    """A ball query's case; a grouped one's table `compacted` (valid rows
    fewer than its rows in a frame) or `all valid`."""
    radii, nsamples, xyz, new_xyz = args[:4]
    Bq, Nq = xyz.shape[:2]
    table = ""
    if grouped:
        table = " compacted" if int(args[4].min()) < Nq else " all valid"
    return (f"({Bq}, {Nq}{table}) x {new_xyz.shape[1]}, r "
            f"{'/'.join(f'{r:g}' for r in radii)}, S {'/'.join(map(str, nsamples))}")


def query_launches(calls, grouped):
    """One row per recorded ball-query wrapper call of a path (flat: one
    launch per three radii; grouped: one launch for up to three): its case,
    arguments, launches and bound. `scan_bound_ms`: the distance tests that
    an index-order scan's early exits need on this run (8 operations each
    and one per radius of its pass: three radii a pass in the grouped
    kernel, two in the earlier flat kernel), the grouped kernel's bound and
    the earlier flat kernel's; the flat query's `bound_ms` counts the work
    its culls leave (`query_ops`)."""
    rows = []
    step = 3 if grouped else 2
    for args, _, outs in calls:
        radii, nsamples, xyz, new_xyz = args[:4]
        Bq, Nq = xyz.shape[:2]
        n_scan = args[4] if grouped else torch.full((Bq,), Nq, device=xyz.device)
        scan_ops = sum((8.0 + len(outs[i:i + step])) * scan_tests(outs[i:i + step], n_scan)
                       for i in range(0, len(outs), step))
        ops = scan_ops if grouped else query_ops(xyz, new_xyz, radii, outs)
        nb = nbytes(xyz, new_xyz, *outs) + (nbytes(n_scan) if grouped else 0)
        b_ms, b_by = bound(nb, ops)
        rows.append(dict(case=query_case(args, grouped), args=args, nbytes=nb, ops=ops,
                         bound_ms=b_ms, bound_by=b_by, scan_bound_ms=bound(nb, scan_ops)[0],
                         launches=-(-len(radii) // 3)))
    return rows


def three_nn_launches(calls):
    """One row per recorded 3-NN launch of a path: its case, arguments and
    bounds. `bound_ms`: the bytes (both sets read, the distances and
    indices written) or the work its culls leave on this data
    (`three_nn_ops`), whichever is larger; `scan_bound_ms`: every (query,
    known point) pair at 9 operations, the earlier kernel's bound."""
    rows = []
    for (unknown, known), _, (d2, idx) in calls:
        Bk, n = unknown.shape[:2]
        m = known.shape[1]
        nb = nbytes(unknown, known, d2, idx)
        ops = three_nn_ops(unknown, known, d2)
        b_ms, b_by = bound(nb, ops)
        rows.append(dict(case=f"({Bk}, {n}) vs {m}", args=(unknown, known), nbytes=nb, ops=ops,
                         bound_ms=b_ms, bound_by=b_by, launches=1,
                         scan_bound_ms=bound(nb, 9.0 * Bk * n * m)[0]))
    return rows


def cdist_top3(unknown, known):
    """The 3-NN's time yardstick: one exact-distance `torch.cdist` and a
    top-3 (its tie order is not fixed, so it is no oracle)."""
    return torch.cdist(unknown, known, compute_mode="donot_use_mm_for_euclid_dist").topk(
        3, largest=False)


def nn1_launches(calls):
    """One row per recorded 1-NN launch of a path: its case, arguments and
    bounds. `bound_ms`: the bytes (both sets read, the distances and
    indices written) or the work its culls leave on this data (`nn1_ops`),
    whichever is larger; `scan_bound_ms`: every (query, point) pair at 9
    operations, the earlier kernel's bound."""
    rows = []
    for (query, points), _, (d2, idx) in calls:
        Bq, M = query.shape[:2]
        N = points.shape[1]
        nb = nbytes(query, points, d2, idx)
        ops = nn1_ops(query, points, d2)
        b_ms, b_by = bound(nb, ops)
        rows.append(dict(case=f"({Bq}, {M}) vs {N}", args=(query, points), out=(d2, idx),
                         nbytes=nb, ops=ops,
                         bound_ms=b_ms, bound_by=b_by, launches=1,
                         scan_bound_ms=bound(nb, 9.0 * Bq * M * N)[0]))
    return rows


def cdist_min(query, points):
    """The 1-NN's time yardstick: one exact-distance `torch.cdist` and its
    min (the same function up to the square root and the tie order)."""
    return torch.cdist(query, points, compute_mode="donot_use_mm_for_euclid_dist").min(-1)


@torch.inference_mode()
def check_flat(label, bcalls, res: Results, path=None):
    """Each distinct flat ball-query case of a path's recorded launches
    bitwise its plain version, timed (`kernel_ms`) beside its bound (the
    work its culls leave, `query_ops`) and the earlier kernel's scan bound;
    returns the rows (`query_launches`). `path`: the main path the launches
    come from, where it is not the kernel's own (`KERNELS`)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    rows = query_launches(bcalls, False)
    for case, (row, count) in by_case(rows).items():
        radii, nsamples, xyz, new_xyz = args = row["args"][:4]

        def plain():
            return [pc._ball_query_plain(r, s, xyz, new_xyz) for r, s in zip(radii, nsamples)]

        require(all(torch.equal(a, b) for a, b in zip(pc._ball_query_kernel(*args), plain())),
                f"ball_query {label} {case}: indices differ from the plain version")
        res.record("ball_query", f"{label} {case} x{count}", 0,
                   lambda: pc._ball_query_kernel(*args), plain, row["nbytes"], row["ops"],
                   reps_p=1, queued=True, path=path, launches_per_call=count * row["launches"],
                   scan_bound_ms=row["scan_bound_ms"])
    return rows


@torch.inference_mode()
def check_three_nn(label, tcalls, res: Results, path=None):
    """Each distinct 3-NN case of a path's recorded launches bitwise its
    plain version (indices and squared distances), timed (`kernel_ms`)
    beside its bound (the work its culls leave, `three_nn_ops`), the
    earlier kernel's scan bound and `cdist_top3`; returns the rows
    (`three_nn_launches`)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    rows = three_nn_launches(tcalls)
    for case, (row, count) in by_case(rows).items():
        unknown, known = row["args"]
        dk, ik = pc._three_nn_kernel(unknown, known)
        dp, ip = pc._three_nn_plain(unknown, known)
        require(torch.equal(ik, ip) and torch.equal(dk, dp),
                f"three_nn {label} {case}: indices or squared distances differ from plain")
        res.record("three_nn", f"{label} {case} x{count}", 0,
                   lambda: pc._three_nn_kernel(unknown, known),
                   lambda: pc._three_nn_plain(unknown, known), row["nbytes"], row["ops"],
                   reps_p=1, queued=True, path=path, library=lambda: cdist_top3(unknown, known),
                   reps_l=CDIST_REPS,
                   launches_per_call=count, scan_bound_ms=row["scan_bound_ms"])
    return rows


@torch.inference_mode()
def check_nn1(label, calls, res: Results, path=None):
    """Every 1-NN launch of a path (its recorded result) bitwise its plain
    version on the same inputs (squared distances and indices); each
    distinct case timed (`kernel_ms`) beside its bound (the work its culls
    leave, `nn1_ops`), the earlier kernel's scan bound and `cdist_min`;
    returns the rows (`nn1_launches`). `path`: the main path the launches
    come from, where it is not the kernel's own (`KERNELS`)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    rows = nn1_launches(calls)
    for i, row in enumerate(rows):
        dk, ik = row["out"]
        dp, ip = pc._nn1_plain(*row["args"])
        require(torch.equal(ik, ip) and torch.equal(dk, dp),
                f"nn1 {label} launch {i} {row['case']}: indices or squared distances differ "
                f"from plain")
    for case, (row, count) in by_case(rows).items():
        query, points = row["args"]
        res.record("nn1", f"{label} {case} x{count}", 0,
                   lambda: pc._nn1_kernel(query, points), lambda: pc._nn1_plain(query, points),
                   row["nbytes"], row["ops"], reps_p=1, queued=True, path=path,
                   library=lambda: cdist_min(query, points), reps_l=CDIST_REPS,
                   launches_per_call=count,
                   scan_bound_ms=row["scan_bound_ms"])
    return rows


def fps_ops(xyz, npoint, idx) -> float:
    """Operations the FPS kernel needs on this data (`fps_work`): 10 a
    distance update (8 for the distance, the min, the compare), 18 a box
    test."""
    updates, boxes = fps_work(xyz, npoint, idx)
    return 10.0 * updates + 18.0 * boxes


def fps_launches(calls):
    """One row per recorded FPS launch of a forward: its case and bounds.
    `bound_ms`: the bytes (xyz read, the indices written) or the work the
    kernel needs on this data (`fps_ops`), whichever is larger; beside it
    `scan_bound_ms`, every point updated every step (the parent kernel's
    bound)."""
    rows = []
    for (xyz, npoint), _, out in calls:
        Bf, Nf = xyz.shape[:2]
        nb = nbytes(xyz, out)
        ops = fps_ops(xyz, npoint, out)
        b_ms, b_by = bound(nb, ops)
        rows.append(dict(case=f"({Bf}, {Nf}) -> {npoint}", args=(xyz, npoint), bound_ms=b_ms,
                         bound_by=b_by, launches=1, ops=ops, nbytes=nb,
                         scan_bound_ms=bound(nb, 10.0 * Bf * Nf * (npoint - 1))[0]))
    return rows


@torch.inference_mode()
def check_fps(label, fcalls, res: Results, path=None):
    """Each distinct FPS case of a path's recorded launches bitwise its
    plain version, timed beside its bounds and the per-step time; returns
    the rows (`fps_launches`). `path`: the main path the launches come
    from, where it is not the kernel's own (`KERNELS`)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    rows = fps_launches(fcalls)
    for case, (row, count) in by_case(rows).items():
        xyz, npoint = row["args"]
        k = pc._fps_kernel(xyz, npoint)
        require(torch.equal(k, pc._fps_plain(xyz, npoint)),
                f"fps {label} {case} differs from plain")
        res.record("fps", f"{label} {case} x{count}", 0,
                   lambda: pc._fps_kernel(xyz, npoint), lambda: pc._fps_plain(xyz, npoint),
                   row["nbytes"], row["ops"], reps_k=10, reps_p=1, queued=True, path=path,
                   launches_per_call=count, scan_bound_ms=row["scan_bound_ms"])
        ms = res.cases["fps"][-1]["ms"]
        print(f"fps {label} {case}: {1e3 * ms / max(npoint - 1, 1):.3f} us a step "
              f"({npoint - 1} steps), bound {row['bound_ms']:.4f} ms, scan bound "
              f"{row['scan_bound_ms']:.4f}", flush=True)
    return rows


@torch.inference_mode()
def check_coverage(ccalls, res: Results):
    """Every coverage launch of one posed forward, recorded with its
    inputs: bitwise its plain version, its bounds printed (the culled
    kernel's work or the bytes, the bytes alone, the linear scan's) and
    their sums, timed; returns the rows (`coverage_launches`)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    rows = coverage_launches(ccalls)
    for i, row in enumerate(rows):
        xyz, centers, r = row["args"]
        require(torch.equal(pc._covered_mask_kernel(xyz, centers, r),
                            pc._covered_mask_plain(xyz, centers, r)),
                f"coverage launch {i} differs from the plain version")
        res.record("coverage", f"posed forward launch {i}: {row['case']}", 0,
                   lambda: pc._covered_mask_kernel(xyz, centers, r),
                   lambda: pc._covered_mask_plain(xyz, centers, r), row["nbytes"],
                   row["ops"], reps_p=1, launches_per_forward=1,
                   bytes_ms=row["bytes_ms"], scan_bound_ms=row["scan_bound_ms"],
                   exact_tests=row["exact_tests"], box_tests=row["box_tests"])
        print(f"coverage launch {i}: bound {row['bound_ms']:.4f} ms ({row['bound_by']}: "
              f"{row['exact_tests']} exact and {row['box_tests']} box tests), byte bound "
              f"{row['bytes_ms']:.4f}, scan bound {row['scan_bound_ms']:.4f}", flush=True)
    sums = {k: sum(r[k] for r in rows) for k in ("bound_ms", "bytes_ms", "scan_bound_ms")}
    print(f"coverage: {len(rows)} launches per posed forward, summed bounds "
          f"{sums['bound_ms']:.4f} ms, bytes {sums['bytes_ms']:.4f}, scan "
          f"{sums['scan_bound_ms']:.4f}", flush=True)
    return rows


@torch.inference_mode()
def check_forward_queries(fcalls, bcalls, gcalls, tcalls, ccalls, res: Results):
    """The FPS, coverage, flat and grouped ball-query and 3-NN launches of
    one posed forward, recorded with their inputs: summed bounds printed;
    each coverage and grouped launch, and each distinct FPS, flat-query and
    3-NN case, bitwise its plain version and timed. Returns the summed
    bounds (ms)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    grouped = query_launches(gcalls, True)
    sums = dict(fps=print_launch_bounds("fps", check_fps("posed forward", fcalls, res)),
                ball_query=print_launch_bounds("ball_query",
                                               check_flat("posed forward", bcalls, res)),
                ball_query_grouped=print_launch_bounds("ball_query_grouped", grouped),
                three_nn=print_launch_bounds("three_nn",
                                             check_three_nn("posed forward", tcalls, res)),
                coverage=sum(r["bound_ms"] for r in check_coverage(ccalls, res)))
    for i, row in enumerate(grouped):
        args = row["args"]
        radii, nsamples, xyz, new_xyz, n_valid = args[:5]

        def plain():
            return [pc._ball_query_plain(r, s, xyz, new_xyz, n_valid)
                    for r, s in zip(radii, nsamples)]

        require(all(torch.equal(a, b)
                    for a, b in zip(pc._ball_query_grouped_kernel(*args), plain())),
                f"ball_query_grouped launch {i}: indices differ from the plain version")
        res.record("ball_query_grouped", f"posed forward launch {i}: {row['case']}", 0,
                   lambda: pc._ball_query_grouped_kernel(*args), plain, row["nbytes"],
                   row["ops"], reps_p=1, launches_per_forward=1)
    return sums


@torch.inference_mode()
def check_posed_kernels(recon, pcd, body_in, res: Results):
    """The posed stage's kernels against their plain versions, on inputs
    captured from one posed forward."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.models import skinning
    from garment4d_tpu_torch.ops import pemax, pointcloud as pc

    with recording(ops, "query_group_pe_multi") as qcalls, \
            recording(skinning, "knn_transfer") as kcalls, \
            recording(pc, "_fps_kernel") as fcalls, \
            recording(pc, "_covered_mask_kernel") as ccalls, \
            recording(pc, "_ball_query_kernel") as bcalls, \
            recording(pc, "_ball_query_grouped_kernel") as gcalls, \
            recording(pc, "_three_nn_kernel") as tcalls, \
            recording(pc, "_gather_rows_kernel", keep=gather_keep) as gather_calls:
        got, handles = capture_inputs(recon.model, ["garment_pe2"])
        recon.posed(pcd, body_in)
        for h in handles:
            h.remove()
    torch.cuda.synchronize()
    sums = check_forward_queries(fcalls, bcalls, gcalls, tcalls, ccalls, res)
    sums["gather_rows"] = record_gathers("posed forward", gather_calls, res, path="posed")
    del fcalls[:], bcalls[:], gcalls[:], tcalls[:], ccalls[:], gather_calls[:]

    # grouped ball query over the compacted table of iteration 0 (the body
    # (80, 6890) x the 2000 garment vertices, coverage at r = 0.4)
    radii, nsamples, xyz, centers, feats, pe_params = qcalls[0][0]
    xyz, centers = xyz.contiguous(), centers.contiguous()
    r = max(radii)
    cap = pemax.candidate_cap(xyz.shape[1])
    counts, overflow, cidx = pemax._compact_candidates(xyz, centers, r, cap)
    packed = torch.cat([xyz, feats], -1)
    if overflow:
        table, cpacked = xyz, packed
        counts = torch.full((F,), N, dtype=torch.int32, device=xyz.device)
    else:
        table, cpacked = pemax._gather_candidates(xyz, packed, cidx)
    print(f"iteration-0 body query: cap {cap}, covered points per frame "
          f"min {int(counts.min())} max {int(counts.max())}, overflow {overflow}")
    qk = pc._ball_query_grouped_kernel(radii, nsamples, table, centers, counts)

    # PE blocks on the chain kernel: body pe2 (S=32), garment pe2 (split)
    def pe_case(case, tbl, idx, ctr, k0, b0, k1, b1):
        ws, bs, relus = [k0.contiguous(), k1.contiguous()], [b0, b1], (True, False)
        out_k = pemax._chain_kernel(tbl, idx, ctr, ws, bs, relus, name="group_pe_max")
        out_p = chain_plain(tbl, idx, ctr, ws, bs, relus)
        err = (out_k - out_p).abs().max().item()
        require(torch.allclose(out_k, out_p, **CHAIN_TOL),
                f"group_pe_max {case}: max abs err {err} beyond {CHAIN_TOL}")
        res.record("group_pe_max", f"{case} {tuple(idx.shape)} widths "
                   f"{[tbl.shape[-1], k0.shape[1], k1.shape[1]]}", err,
                   lambda: pemax._chain_kernel(tbl, idx, ctr, ws, bs, relus, name="group_pe_max"),
                   lambda: chain_plain(tbl, idx, ctr, ws, bs, relus),
                   nbytes(tbl, idx, ctr, out_k, *ws, *bs), chain_ops(idx, tbl, ws))

    pe_case("body pe2", cpacked.contiguous(), qk[2], centers, *pe_params[2])

    # the valid-count variant at the body PE shape: bitwise the chain kernel
    # without the count (the same gathers), its flag read once per call
    tbl, k0, b0, k1, b1 = cpacked.contiguous(), *pe_params[2]
    ws, bs, relus = [k0.contiguous(), k1.contiguous()], [b0, b1], (True, False)
    out_nv = pemax._chain_kernel(tbl, qk[2], centers, ws, bs, relus, name="group_pe_max_nv",
                                 n_valid=counts)
    out_k = pemax._chain_kernel(tbl, qk[2], centers, ws, bs, relus, name="group_pe_max")
    require(torch.equal(out_nv, out_k), "group_pe_max_nv differs from the chain kernel")
    res.record("group_pe_max_nv", f"body pe2 {tuple(qk[2].shape)} over {tbl.shape[1]} rows, "
               f"counts {int(counts.min())}..{int(counts.max())}", 0,
               lambda: pemax._chain_kernel(tbl, qk[2], centers, ws, bs, relus,
                                           name="group_pe_max_nv", n_valid=counts),
               lambda: chain_plain(tbl, qk[2], centers, ws, bs, relus, counts),
               nbytes(tbl, qk[2], centers, counts, out_nv, *ws, *bs), chain_ops(qk[2], tbl, ws))
    g_xyz, g_ctr, g_feat = got["garment_pe2"]
    gpe = recon.model.garment_pe2
    g_idx = pc.ball_query(gpe.radius, gpe.nsample, g_xyz, g_ctr)
    k0, b0, k1, b1 = gpe.kb()
    g_tbl = torch.cat([g_xyz, g_feat @ k0[3:]], -1).contiguous()
    kfull = torch.cat([k0[:3], torch.eye(k0.shape[1], device=k0.device)], 0)
    pe_case("garment pe2 (split)", g_tbl, g_idx, g_ctr.contiguous(), kfull, b0, k1, b1)

    # K-NN transfer: 8 x 2000 garment vertices vs 6890 T-pose body points
    check_knn("posed forward", kcalls[0][0], res)
    sums["knn_transfer"] = res.cases["knn_transfer"][-1]["bound_ms"]
    return sums


def rel_l2(a, b) -> float:
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _pe_rows(table, idx, centers) -> torch.Tensor:
    """A PE block's gathered rows less their centers on xyz, (B, M, S, C),
    as every implementation forms them: one fp32 rounding."""
    from garment4d_tpu_torch.ops.pointcloud import _gather_rows_plain

    B, M, S = idx.shape
    C = table.shape[-1]
    qg = _gather_rows_plain(table, idx.reshape(B, M * S)).reshape(B, M, S, C)
    return qg - torch.nn.functional.pad(centers, (0, C - 3))[:, :, None, :]


@torch.no_grad()
def pe_routing(table, idx, centers, k0, b0, k1):
    """The discrete decisions of a PE backward, from the plain recompute in
    the inputs' dtype: (tie (B, M, S, G), the slots at each output channel's
    max; active (B, M, S, F), hpre > 0)."""
    hpre = torch.matmul(_pe_rows(table, idx, centers), k0) + b0
    h2 = torch.matmul(torch.relu(hpre), k1)
    return h2 == h2.amax(dim=2, keepdim=True), hpre > 0


@torch.no_grad()
def pe_bwd_float64(table, idx, centers, k0, b0, k1, cot, routing, table_grad=False):
    """The PE backward in float64 with its routing and ReLU masks given
    (`pe_routing`): exact values for an fp32 implementation that decides as
    the plain fp32 version does; led by dtable with `table_grad`."""
    from garment4d_tpu_torch.ops.pointcloud import _scatter_add_rows_plain

    tie, active = routing
    qg = _pe_rows(table, idx, centers).double()
    k0, b0, k1, cot = (t.double() for t in (k0, b0, k1, cot))
    h = torch.where(active, torch.matmul(qg, k0) + b0, 0.0)
    dh2 = torch.where(tie, (cot / tie.sum(dim=2, dtype=cot.dtype))[:, :, None, :], 0.0)
    dh1 = torch.where(active, torch.matmul(dh2, k1.t()), 0.0)
    grads = (-torch.matmul(dh1, k0[:3].t()).sum(dim=2),
             torch.einsum("bmsc,bmsf->cf", qg, dh1), dh1.sum(dim=(0, 1, 2)),
             torch.einsum("bmsf,bmsg->fg", h, dh2), cot.sum(dim=(0, 1)))
    if not table_grad:
        return grads
    B, M, S = idx.shape
    dqg = torch.matmul(dh1, k0.t()).reshape(B, M * S, -1)
    return (_scatter_add_rows_plain(dqg, idx.reshape(B, M * S), table.shape[1]),) + grads


@torch.no_grad()
def pe_near_ties(table, idx, centers, k0, b0, k1) -> torch.Tensor:
    """(B, M, G) bool: the (center, output channel) pairs of a PE block
    whose max over S two fp32 implementations that sum in different orders
    may put on different slots. The plain version's order is cuBLAS's
    choice, which can change from process to process.

    In float64 from the fp32 centred rows: hpre = qg @ k0 + b0 and
    h2 = relu(hpre) @ k1, with e1 = sqrt(C + 1) u (|qg| @ |k0| + |b0|) and
    e2 = e1 @ |k1| + sqrt(F) u (h + e1) @ |k1| (u = 2^-24; a sum of n terms
    rounds by about u sqrt(n) times its partial sums, and sum |terms|
    bounds those). A pair is flagged where a slot comes within
    e2(max slot) + e2(slot) of the max without equalling it, or where a slot
    at the max has a unit with |hpre| <= e1 (its ReLU mask may differ). An
    exact tie (a repeated slot, two equal rows) is a tie in every order."""
    C, F = k0.shape
    u = 2.0 ** -24
    qg = _pe_rows(table, idx, centers).double()
    k0d, b0d, k1d = k0.double(), b0.double(), k1.double()
    hpre = torch.matmul(qg, k0d) + b0d
    e1 = (C + 1) ** 0.5 * u * (torch.matmul(qg.abs(), k0d.abs()) + b0d.abs())
    del qg
    h = torch.relu(hpre)
    h2 = torch.matmul(h, k1d)
    e2 = torch.matmul(e1, k1d.abs()) + F ** 0.5 * u * torch.matmul(h + e1, k1d.abs())
    top = h2.amax(dim=2, keepdim=True)
    at_max = h2 == top
    e2_top = torch.where(at_max, e2, 0.0).amax(dim=2, keepdim=True)
    gap = top - h2
    near = ((gap > 0) & (gap <= e2_top + e2)).any(dim=2)
    relu_edge = (hpre.abs() <= e1).any(dim=-1)  # (B, M, S)
    return near | (at_max & relu_edge[..., None]).any(dim=2)


@contextlib.contextmanager
def tie_free_pe_backward():
    """Every PE backward inside the block gets a zero cotangent at the
    pairs of `pe_near_ties`, at most NEAR_TIE_CAP of them. Yields the
    masked shares, one per backward."""
    from garment4d_tpu_torch.ops import pemax

    backward, shares = pemax._pe_bwd, []

    def tie_free(table, idx, centers, k0, b0, k1, cot, table_grad=False):
        near = pe_near_ties(table, idx, centers, k0, b0, k1)
        shares.append(near.float().mean().item())
        require(shares[-1] <= NEAR_TIE_CAP, f"PE backward of a {tuple(table.shape)} "
                f"table: near-tie share {shares[-1]} > {NEAR_TIE_CAP}")
        return backward(table, idx, centers, k0, b0, k1, cot * ~near, table_grad)

    pemax._pe_bwd = tie_free
    try:
        yield shares
    finally:
        pemax._pe_bwd = backward


def pe_bwd_ops(idx, k0, k1, tie) -> float:
    """Operations a PE block's backward needs on this data, `tie` its
    routing (`pe_routing`). Per sample row: the recompute of both layers
    (2CF + 2FG), the ReLU, the max and the tie count (F + 2G). The routing
    leaves dh2 sparse: per non-zero (a channel's max slot and its exact
    ties), its share of dh1 = dh2 @ k1^T and of dk1 = h^T dh2 (2F each); per
    slot that won any channel, its rows of dk0 (2CF), db0 and the ReLU mask
    of dh1 (2F) and the xyz rows of dqg (6F); db1, one add per cotangent
    entry."""
    Bc, M, S = idx.shape
    C, F = k0.shape
    G = k1.shape[1]
    routed, won = int(tie.sum()), int(tie.any(dim=-1).sum())
    return (Bc * M * S * (2.0 * C * F + 2 * F * G + F + 2 * G) + routed * 4.0 * F
            + won * (2.0 * C * F + 8 * F) + Bc * M * G)


PE_GRADS = ("dcenters", "dk0", "db0", "dk1", "db1")


def pe_grad_errors(got, want) -> dict:
    """max |got - want| / max |want| of each PE-backward output."""
    return {n: float((g.double() - w.double()).abs().max()
                     / w.double().abs().max().clamp_min(1e-30))
            for n, g, w in zip(PE_GRADS, got, want)}


def pe_grads_agree(got, want) -> bool:
    """dcenters within rtol 1e-4 / atol 1e-5, each weight gradient within
    1e-4 of its largest magnitude in `want` (sums of up to 2.56 M terms in
    another order)."""
    want = [w.to(g.dtype) for g, w in zip(got, want)]
    return (torch.allclose(got[0], want[0], **CHAIN_TOL)
            and all(float((g - w).abs().max()) <= 1e-4 * float(w.abs().max())
                    for g, w in zip(got[1:], want[1:])))


@torch.no_grad()
def check_train_kernels(calls, res: Results):
    """The train step's banded product and PE backward against their plain
    versions, on the inputs recorded from one train step (the 1-NN:
    `check_nn1`)."""
    from garment4d_tpu_torch.ops import graph

    # banded: the GCN recompute (C=128) and its transpose, the loss (C=3)
    fwd = [a for a, _, _ in calls["banded"]]
    gcn_vals, gcn_x, gcn_offs = next(a for a in fwd if a[1].shape[-1] == 128)
    t_vals, t_offs = graph.transposed_band(gcn_vals, gcn_offs)
    cases = [("GCN recompute", gcn_vals, gcn_x, gcn_offs),
             ("GCN transpose", t_vals.contiguous(), gcn_x, t_offs),
             ("loss Laplacian", *next(a for a in fwd if a[1].shape[-1] == 3))]
    for case, vals, x, offs in cases:
        out = graph._banded_kernel(vals, x, offs)
        require(torch.equal(out, graph._banded_plain(vals, x, offs)),
                f"banded {case} differs from the plain version")
        V = x.shape[1]
        rows = torch.arange(V, device=x.device)
        dense = torch.zeros(V, V, device=x.device)
        for d, o in enumerate(offs):
            dense[rows, (rows + o) % V] = vals[d]
        res.record("banded", f"{case} {tuple(x.shape)}, {len(offs)} diagonals", 0,
                   lambda: graph._banded_kernel(vals, x, offs),
                   lambda: graph._banded_plain(vals, x, offs), nbytes(vals, x, out),
                   2.0 * len(offs) * x.numel(), library=lambda: torch.matmul(dense, x))

    # PE backward at each of its shapes in the step: body 6 wide at S=8/16/32,
    # garment unsplit 67/99/387 wide at S=32/16/8
    shapes = {}
    for a, _, _ in calls["pe_bwd"]:
        shapes.setdefault((a[0].shape[2], a[1].shape[2]), a[:7])
    failed = []
    for (C, S), args in sorted(shapes.items()):
        failed += check_pe_case(args, res)
    failed += check_pe_dtable(shapes[(67, 32)], res)
    return failed


@torch.no_grad()
def check_pe_case(args, res: Results, label="", path=None):
    """One recorded PE backward (the table, idx, centers, k0, b0, k1 and
    cotangent of a `_pe_bwd_kernel` call): with a zero cotangent at the
    near-tie pairs (`pe_near_ties`), the kernel against its plain version
    and the float64 witness (`pe_grads_agree`), two launches bitwise;
    unmasked, each gradient's difference printed; timed beside its bound
    (on the call's own slots) and its plain version. -> failures."""
    from garment4d_tpu_torch.ops import pemax

    table, idx, centers, k0, b0, k1, cot = args
    C = table.shape[-1]
    case = (f"{label}{'body' if C == 6 else 'garment'} {tuple(idx.shape)} widths "
            f"{[C, k0.shape[1], k1.shape[1]]}")
    # a zero cotangent where the max may fall on another slot in another
    # summation order; the unmasked difference is printed beside
    near = pe_near_ties(*args[:6])
    share = near.float().mean().item()
    masked = (*args[:6], cot * ~near)
    got = pemax._pe_bwd_kernel(*masked)
    again = pemax._pe_bwd_kernel(*masked)
    want = pemax._pe_bwd_plain(*masked)
    routing = pe_routing(*args[:6])
    exact = pe_bwd_float64(*masked, routing)
    bits = all(torch.equal(g, a) for g, a in zip(got, again))
    vs_plain, vs_f64 = pe_grad_errors(got, want), pe_grad_errors(got, exact)
    plain_vs_f64 = pe_grad_errors(want, exact)
    checks = ((share <= NEAR_TIE_CAP, f"near-tie share {share} > {NEAR_TIE_CAP}"),
              (bits, "two launches differ"),
              (pe_grads_agree(got, want), f"beyond tolerance of plain: {vs_plain}"),
              (pe_grads_agree(got, exact), f"beyond tolerance of float64: {vs_f64}"))
    failed = [f"pe_bwd {case}: {what}" for ok, what in checks if not ok]
    del exact
    unmasked = pe_grad_errors(pemax._pe_bwd_kernel(*args), pemax._pe_bwd_plain(*args))
    # how often fp32 itself routes otherwise than exact arithmetic would
    tie64 = pe_routing(*[t.double() if t.is_floating_point() else t for t in args[:6]])[0]
    flips = (tie64 != routing[0]).any(dim=2).float().mean().item()
    del tie64
    print(f"pe_bwd {case}: near-tie share {share:.2e}; max err / max, kernel vs plain "
          f"{max(vs_plain.values()):.2e} (unmasked {max(unmasked.values()):.2e}), vs "
          f"float64 with the plain routing {max(vs_f64.values()):.2e} (plain "
          f"{max(plain_vs_f64.values()):.2e}); fp32 routes {flips:.2e} of the (center, "
          f"channel) pairs otherwise than float64; two launches bitwise {bits}; unmasked "
          f"by gradient {', '.join(f'{k} {v:.2e}' for k, v in unmasked.items())}", flush=True)
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    res.record("pe_bwd", case, err,
               lambda: pemax._pe_bwd_kernel(*args), lambda: pemax._pe_bwd_plain(*args),
               nbytes(*args, *got), pe_bwd_ops(idx, k0, k1, routing[0]),
               near_tie_share=share, err_vs_plain=vs_plain, err_vs_float64=vs_f64,
               unmasked_err_vs_plain=unmasked, fp32_routing_differs_from_float64=flips,
               path=path)
    return failed


def check_pe_dtable(args, res: Results, label="garment pe0 unsplit"):
    """The PE backward's dtable half (`table_grad=True`: the slots' row
    gradients, summed by the scatter-add kernel) of a recorded PE backward
    (phase 5: garment pe0 unsplit, 67-32-32 at S=32), with the table
    treated as trainable: all six gradients against the plain version and
    the float64 witness with the near-tie mask (dtable, like the weight
    gradients, within 1e-4 of its largest magnitude), two launches bitwise
    equal. -> failures."""
    from garment4d_tpu_torch.ops import pemax

    table, idx, centers, k0, b0, k1, cot = args
    near = pe_near_ties(*args[:6])
    masked = (*args[:6], cot * ~near)
    with recording(pemax, "_scatter_add_rows_kernel") as scatters:
        got = pemax._pe_bwd_kernel(*masked, table_grad=True)
    again = pemax._pe_bwd_kernel(*masked, table_grad=True)
    want = pemax._pe_bwd_plain(*masked, table_grad=True)
    routing = pe_routing(*args[:6])
    exact = pe_bwd_float64(*masked, routing, table_grad=True)
    bits = all(torch.equal(g, a) for g, a in zip(got, again))

    def agree(a, b):
        return (float((a[0] - b[0].to(a[0].dtype)).abs().max())
                <= 1e-4 * float(b[0].abs().max()) and pe_grads_agree(a[1:], b[1:]))

    def errs(a, b):
        return dict(dtable=float((a[0].double() - b[0].double()).abs().max()
                                 / b[0].double().abs().max().clamp_min(1e-30)),
                    **pe_grad_errors(a[1:], b[1:]))

    vs_plain, vs_f64 = errs(got, want), errs(got, exact)
    failed = [f"pe_bwd dtable half, {label}: {what}" for ok, what in (
        (bits, "two launches differ"),
        (agree(got, want), f"beyond tolerance of plain: {vs_plain}"),
        (agree(got, exact), f"beyond tolerance of float64: {vs_f64}")) if not ok]
    del exact
    print(f"pe_bwd dtable half, {label} {tuple(idx.shape)} widths "
          f"{[table.shape[-1], k0.shape[1], k1.shape[1]]}: max err / max, kernel vs plain "
          f"{max(vs_plain.values()):.2e} (dtable {vs_plain['dtable']:.2e}), vs float64 "
          f"{max(vs_f64.values()):.2e}; two launches bitwise {bits}", flush=True)
    Bt, M, S = idx.shape
    C, F = k0.shape
    won = int(routing[0].any(dim=-1).sum())
    res.record("pe_bwd_dtable", f"{label} {tuple(idx.shape)} widths "
               f"{[C, F, k1.shape[1]]}, table_grad=True",
               max(float((g - w).abs().max()) for g, w in zip(got, want)),
               lambda: pemax._pe_bwd_kernel(*args, table_grad=True),
               lambda: pemax._pe_bwd_plain(*args, table_grad=True),
               nbytes(*args, *got),
               pe_bwd_ops(idx, k0, k1, routing[0]) + won * 2.0 * C * F + Bt * M * S * C,
               err_vs_plain=vs_plain, err_vs_float64=vs_f64)
    # its scatter-add: the won slots' row gradients (the others indexed -1)
    (dqg, idx_w, n), _, out = scatters[0]
    scatter_case(f"dtable ({dqg.shape[0]}, {dqg.shape[1]}, {dqg.shape[2]}) into {n} rows, "
                 f"{int((idx_w >= 0).sum())} won", dqg, idx_w, n, out, res, path="op-level")
    return failed


@contextlib.contextmanager
def plain_backward():
    """The PE-backward and banded kernels swapped for their plain versions
    (module functions, which autograd's worker thread looks up too)."""
    from garment4d_tpu_torch.ops import graph, pemax

    saved = pemax._pe_bwd_kernel, graph._banded_kernel
    pemax._pe_bwd_kernel, graph._banded_kernel = pemax._pe_bwd_plain, graph._banded_plain
    try:
        yield
    finally:
        pemax._pe_bwd_kernel, graph._banded_kernel = saved


def teacher_forced_grads(model, steps, seed=0):
    """Each refinement iteration of the recorded train step, fed its own
    inputs and one fixed random cotangent of (offsets, hidden): relative L2
    of every parameter's and `cur`'s gradient between the kernel path's
    backward and the plain versions' backward of the same kernel-path
    forward, with the PE backwards tie-free on both (the gate) and
    unmasked; and between the kernel path and the plain path each run
    forward and backward (not gated: fp32 rounding flips discrete choices
    of the forward, ReLU masks among them, and a flip at one vertex moves a
    gradient summed against a random cotangent by up to ~1e-3).
    -> (rows, failures)."""
    from garment4d_tpu_torch import ops

    params = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    names = ["cur"] + [n for n, _ in params]
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows, failed = [], []

    def rel(a, b):
        errs = {n: rel_l2(x, y) for n, x, y in zip(names, a, b) if y is not None}
        worst = max(errs, key=errs.get)
        return worst, errs[worst], len(errs)

    for args, _, (h, hid) in steps:
        it, cur, hidden, *rest = args
        cots = [torch.randn(t.shape, generator=g, device="cuda") for t in (h, hid)]
        cur = cur.detach().requires_grad_(True)
        hidden = None if hidden is None else hidden.detach()
        wrt = [cur] + [p for _, p in params]
        paths = []
        for plain in (False, True):
            with ops.plain_ops() if plain else contextlib.nullcontext():
                outs = model.refine(it, cur, hidden, *rest)
                paths.append(torch.autograd.grad(outs, wrt, cots, allow_unused=True))
        outs = model.refine(it, cur, hidden, *rest)
        grads, shares = {}, []
        for masked in (True, False):
            for plain in (False, True):
                with plain_backward() if plain else contextlib.nullcontext(), \
                        tie_free_pe_backward() if masked else contextlib.nullcontext([]) \
                        as got:
                    grads[masked, plain] = torch.autograd.grad(
                        outs, wrt, cots, retain_graph=True, allow_unused=True)
                shares += got
        worst, err, n = rel(grads[True, False], grads[True, True])
        raw, raw_err, _ = rel(grads[False, False], grads[False, True])
        full, full_err, _ = rel(*paths)
        rows.append(dict(iteration=it, tensors=n, worst=worst, max_rel_l2=err,
                         unmasked_worst=raw, unmasked_max_rel_l2=raw_err,
                         paths_worst=full, paths_max_rel_l2=full_err,
                         near_tie_shares=shares))
        print(f"teacher-forced backward, iteration {it}: {n} gradients, kernels vs plain "
              f"versions on one forward: largest relative L2 {err:.3e} ({worst}) with "
              f"near-tie routing masked (largest share {max(shares):.2e}), {raw_err:.3e} "
              f"({raw}) unmasked; kernel vs plain path, each forward and backward: "
              f"{full_err:.3e} ({full})", flush=True)
        if err > GRAD_TOL:
            failed.append(f"teacher-forced backward, iteration {it}: {worst} relative "
                          f"L2 {err} > {GRAD_TOL}")
    return rows, failed


def train_phase(assets, body, weights, res: Results):
    """The posed train step at B=4, T=10 from `posed_synth.npz`, Adam at
    lr 1e-3 with the canonical stage frozen: the three new kernels against
    their plain versions on the step's own inputs, one counted step and its
    gates, the plain path beside it, teacher-forced gradients, speed and a
    profile."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.models import skinning
    from garment4d_tpu_torch.ops import graph, pemax, pointcloud as pc
    from garment4d_tpu_torch.train import make_posed_steps, make_state_for

    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    batch = make_batch(assets, body, batch_size=TRAIN_B, T=T, npoints=N, seed=1, device=dev)

    def new_state():
        model = GarmentReconstructor.from_npz(assets, body, weights, device=dev).model
        return make_state_for(model, lr=TRAIN_LR, freeze_canonical=True)

    state, state_plain = new_state(), new_state()
    model = state.model
    train_step, _ = make_posed_steps(model, assets, body.faces)
    train_plain, _ = make_posed_steps(state_plain.model, assets, body.faces)
    trainable = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    canonical = {k: v.clone() for k, v in model.canonical.state_dict().items()}
    require(not any(p.requires_grad for p in model.canonical.parameters()),
            "canonical parameters still require grad")

    with recording(pc, "_nn1_kernel") as nn1_calls, \
            recording(graph, "_banded_kernel") as banded_calls, \
            recording(pemax, "_pe_bwd_kernel") as pe_calls, \
            recording(skinning, "knn_transfer") as knn_calls, \
            recording(pc, "_fps_kernel") as fps_calls, \
            recording(pc, "_ball_query_kernel") as bq_calls, \
            recording(pc, "_three_nn_kernel") as tn_calls, \
            recording(pc, "_gather_rows_kernel", keep=gather_keep) as gather_calls, \
            recording(model, "refine") as steps:
        losses, launches = counted("train", lambda: train_step(state, batch), POSED_TRAIN_KERNELS)
    for name, n in TRAIN_LAUNCHES.items():
        require(launches[name] == n, f"{name}: {launches[name]} launches in a train "
                f"step, {n} expected")
    for k, v in losses.items():
        require(bool(torch.isfinite(v).all()), f"loss {k} is not finite")
    print("train step losses: " + ", ".join(
        f"{k} {v.item():.6g}" for k, v in losses.items() if v.dim() == 0), flush=True)
    params = dict(model.named_parameters())
    for name, before in trainable.items():
        p = params[name]
        require(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                f"{name}: no finite gradient")
        require(not torch.equal(p.detach(), before), f"{name}: not changed by the step")
    for k, v in model.canonical.state_dict().items():
        require(torch.equal(v, canonical[k]), f"canonical {k} changed by the step")
    print(f"{len(trainable)} trainable tensors, all with finite gradients and moved; "
          f"{len(canonical)} canonical tensors bitwise unchanged", flush=True)

    failed = check_train_kernels(dict(banded=banded_calls, pe_bwd=pe_calls), res)
    bounds = dict(nn1=print_launch_bounds("nn1", check_nn1("posed train step", nn1_calls, res),
                                          per="posed train step"),
                  banded=sum(banded_bound(*c) for c in banded_calls),
                  gather_rows=record_gathers("posed train step", gather_calls, res,
                                             path="train"))
    check_knn("posed train step", knn_calls[0][0], res, path="train")
    check_fps("posed train step", fps_calls, res, path="train")
    check_flat("posed train step", bq_calls, res, path="train")
    check_three_nn("posed train step", tn_calls, res, path="train")
    del nn1_calls[:], banded_calls[:], pe_calls[:], knn_calls[:], fps_calls[:], bq_calls[:]
    del tn_calls[:], gather_calls[:]

    # the plain path from the same weights and batch, its backward included
    ops.reset_counts()
    with ops.plain_ops():
        losses_plain = train_plain(state_plain, batch)
    torch.cuda.synchronize()
    require(not any(ops.launch_counts.values()),
            f"the plain train step launched kernels: {dict(ops.launch_counts)}")
    loss_err = {}
    for k, v in losses_plain.items():
        loss_err[k] = float(((losses[k] - v).abs() / v.abs().clamp_min(1e-12)).max())
        require(loss_err[k] <= LOSS_TOL, f"loss {k}: kernel {losses[k].tolist()} vs "
                f"plain {v.tolist()}, relative {loss_err[k]} > {LOSS_TOL}")
    print(f"train step losses, kernel vs plain path: largest relative difference "
          f"{max(loss_err.values()):.3e} ({max(loss_err, key=loss_err.get)})", flush=True)
    forced, forced_failed = teacher_forced_grads(model, steps)
    require(not failed + forced_failed, "; ".join(failed + forced_failed))
    del steps[:]

    step_s = wall_s(lambda: train_step(state, batch), runs=5, warmup=2)
    print(f"posed train step, kernel path: {TRAIN_F / step_s:.2f} frames/s "
          f"({step_s * 1e3:.2f} ms per step of {TRAIN_F} frames)", flush=True)
    with ops.plain_ops():
        plain_s = wall_s(lambda: train_plain(state_plain, batch), runs=2, warmup=0)
    print(f"posed train step, plain path on the card: {TRAIN_F / plain_s:.2f} frames/s "
          f"({plain_s * 1e3:.2f} ms)", flush=True)
    rows, dev_ms = profile_device(lambda: train_step(state, batch), runs=1)
    idle = print_profile("train", rows, dev_ms, step_s * 1e3, top=20)
    kernel_ms_ = {k: device_ms_of(rows, AB_KERNEL_NAMES[k]) for k in bounds}
    for k, b in bounds.items():
        print(f"posed train step device ms per step: {k} {kernel_ms_[k]:.4f} in "
              f"{launches.get(k, 0)} launches (summed bound {b:.4f})", flush=True)
    torch.cuda.synchronize()
    return dict(launches=launches, frames_per_sec=TRAIN_F / step_s,
                kernel_device_ms=kernel_ms_, summed_bound_ms=bounds,
                plain_frames_per_sec=TRAIN_F / plain_s, device_ms_per_step=dev_ms,
                idle_share=idle, loss_rel_err=loss_err, forced=forced,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30)


@torch.no_grad()
def scatter_case(case, grads, idx, n, out, res: Results, path=None, wrap=False):
    """One scatter-add call (`wrap` as the call had it) and its result
    `out`: against its plain version on the card (`index_add_`, atomics:
    rtol 1e-5 / atol 1e-6), bitwise against the ascending-order sum on the
    CPU (the plain version there), two launches bitwise equal; timed beside
    its bound (bytes), its plain version and one `index_add_` call on the
    flattened rows. `path`: where the call comes from, if not the kernel's
    main path."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    Bs, R, C = grads.shape
    plain = pc._scatter_add_rows_plain(grads, idx, n, wrap)
    err = float((out - plain).abs().max())
    require(torch.allclose(out, plain, rtol=1e-5, atol=1e-6),
            f"scatter_add {case}: max abs err {err} against index_add_")
    require(torch.equal(out, pc._scatter_add_rows_kernel(grads, idx, n, wrap)),
            f"scatter_add {case}: two launches differ")
    cpu = pc._scatter_add_rows_plain(grads.cpu(), idx.cpu(), n, wrap)
    require(torch.equal(out.cpu(), cpu),
            f"scatter_add {case}: not bitwise the CPU's ascending-order sum")
    del plain, cpu
    valid = scatter_valid(idx, n, wrap)
    into = torch.where(idx < 0, idx + n, idx) if wrap else idx
    flat = torch.where(valid, into.long() + n * torch.arange(Bs, device=idx.device)[:, None],
                       Bs * n).reshape(-1)
    rows, lib_out = grads.reshape(-1, C), torch.zeros(Bs * n + 1, C, device=grads.device)
    res.record("scatter_add", case, err, lambda: pc._scatter_add_rows_kernel(grads, idx, n, wrap),
               lambda: pc._scatter_add_rows_plain(grads, idx, n, wrap),
               int(valid.sum()) * C * 4 + nbytes(idx, out), float(valid.sum()) * C, reps_k=10,
               library=lambda: lib_out.index_add_(0, flat, rows), path=path,
               bitwise_cpu=True, bitwise_repeat=True)


def scatter_valid(idx, n, wrap=False):
    """The rows a scatter-add reads: those of indices in [0, n), after the
    wrap."""
    into = torch.where(idx < 0, idx + n, idx) if wrap else idx
    return (into >= 0) & (into < n)


def scatter_bound(args, _kwargs, out) -> float:
    """A scatter-add's bound (ms), as `scatter_case` reckons it: the rows
    it reads, its indices and its output (a recording's `keep`)."""
    grads, idx, n, *wrap = args
    valid = scatter_valid(idx, n, *wrap)
    return bound(int(valid.sum()) * grads.shape[-1] * 4 + nbytes(idx, out),
                 float(valid.sum()) * grads.shape[-1])[0]


def check_scatter_add(calls, res: Results):
    """The scatter-add at each of its shapes in the canonical train step, on
    the inputs recorded from the step (`scatter_case`)."""
    for (grads, idx, n, wrap), _, out in calls:
        scatter_case(f"({grads.shape[0]}, {grads.shape[1]}, {grads.shape[2]}) into {n} rows",
                     grads, idx, n, out, res, wrap=wrap)


@contextlib.contextmanager
def plain_scatter():
    """The scatter-add kernel swapped for its plain version (a module
    function, which autograd's worker thread looks up too)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    saved = pc._scatter_add_rows_kernel
    pc._scatter_add_rows_kernel = pc._scatter_add_rows_plain
    try:
        yield
    finally:
        pc._scatter_add_rows_kernel = saved


def forced_scatter_backward(model, assets, body, batch, generator):
    """One canonical train-mode forward on the kernel path, its loss's
    backward run four times: through the scatter-add kernel, and three times
    through its plain version (`index_add_`, atomics) swapped in. Every
    parameter's gradient, kernel vs plain, within 1e-4 relative L2, or
    within 3x the larger of two readings of the plain version against
    itself where its atomics and the train-mode BatchNorms make those wider
    (the gate); the readings per parameter are returned."""
    import numpy as np
    from garment4d_tpu_torch import losses as L

    dev = torch.device("cuda")
    model.train()
    faces_tri = torch.as_tensor(np.asarray(assets.faces_tri), dtype=torch.long, device=dev)
    faces = torch.as_tensor(np.asarray(body.faces), dtype=torch.long, device=dev)
    out = model(batch["pcd"], generator())
    total = L.canonical_stage_loss(out, batch, faces_tri, faces, L.LossWeights())["total_loss"]
    names, params = zip(*model.named_parameters())
    kernel = torch.autograd.grad(total, params, retain_graph=True)
    with plain_scatter():
        plain = [torch.autograd.grad(total, params, retain_graph=i < 2) for i in range(3)]
    del out, total
    err = {n: rel_l2(k, p) for n, k, p in zip(names, kernel, plain[0])}
    spread = {n: max(rel_l2(a, p), rel_l2(b, p)) for n, a, b, p in
              zip(names, plain[1], plain[2], plain[0])}
    worst = max(err, key=err.get)
    print(f"canonical train step, one kernel-path forward, its backward through the "
          f"scatter-add kernel vs through its plain version: largest relative L2 "
          f"{err[worst]:.3e} ({worst}; the plain version against itself there "
          f"{spread[worst]:.3e}, at most {max(spread.values()):.3e})", flush=True)
    failed = [f"{n}: relative L2 {e} > {GRAD_TOL} and > {SPREAD_FACTOR}x the plain "
              f"version's own {spread[n]}" for n, e in err.items()
              if e > max(GRAD_TOL, SPREAD_FACTOR * spread[n])]
    require(not failed, "canonical train, scatter-add kernel vs plain backward: "
            + "; ".join(failed[:8]))
    return dict(worst=worst, max_rel_l2=err[worst], max_plain_spread=max(spread.values()),
                rel_l2=err, plain_spread=spread)


def canonical_train_phase(assets, body, weights, res: Results):
    """The canonical-stage train step at the recipe's shape (B=20, T=10,
    N=6890, the seed-1 batch, the canonical subtree of `posed_synth.npz`,
    Adam at lr 1e-3 over every parameter, dropout from a seeded generator):
    one counted step and its gates, the scatter-add against its plain
    version and the CPU on the step's own inputs, the same step on the
    plain path, speed, a profile and the peak memory."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.models import CanonicalGarmentModel
    from garment4d_tpu_torch.ops import pointcloud as pc
    from garment4d_tpu_torch.train import load_npz_subtree, make_canonical_steps, make_state_for

    dev = torch.device("cuda")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch = make_batch(assets, body, batch_size=CANON_B, T=T, npoints=N, seed=1, device=dev)
    state_dict = load_npz_subtree(weights, "canonical")

    def new_state():
        model = CanonicalGarmentModel(assets).to(dev)
        model.load_state_dict(state_dict, strict=True)
        state = make_state_for(model, lr=TRAIN_LR)
        return state, make_canonical_steps(model, assets, body.faces)

    def generator():
        return torch.Generator(device=dev).manual_seed(1)

    state, (train_step, eval_step) = new_state()
    model = state.model
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    stats = {n: b.clone() for n, b in model.named_buffers() if "running" in n}
    with recording(pc, "_scatter_add_rows_kernel") as scatter_calls, \
            recording(pc, "_fps_kernel") as fps_calls, \
            recording(pc, "_ball_query_kernel") as bq_calls, \
            recording(pc, "_three_nn_kernel") as tn_calls, \
            recording(pc, "_nn1_kernel") as nn1_calls, \
            recording(pc, "_gather_rows_kernel", keep=gather_keep) as gather_calls:
        losses, launches = counted("canonical train", lambda: train_step(state, batch, generator()),
                                   CANON_TRAIN_KERNELS)
    peak_step = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"canonical train step: peak device memory {peak_step:.2f} GiB (scatter-add inputs "
          f"held for the checks)", flush=True)
    for k, v in losses.items():
        require(bool(torch.isfinite(v).all()), f"canonical loss {k} is not finite")
    print("canonical train step losses: " + ", ".join(
        f"{k} {v.item():.6g}" for k, v in losses.items()), flush=True)
    grads = {}
    for name, p in model.named_parameters():
        require(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                f"{name}: no finite gradient")
        require(not torch.equal(p.detach(), before[name]), f"{name}: not changed by the step")
        grads[name] = p.grad.detach().clone()
    buffers = dict(model.named_buffers())
    for name, b in stats.items():
        require(not torch.equal(buffers[name], b), f"{name}: running statistic unchanged")
    print(f"{len(grads)} parameters, all with finite gradients and moved; {len(stats)} "
          f"running statistics changed", flush=True)
    check_scatter_add(scatter_calls, res)
    check_fps("canonical train step", fps_calls, res, path="canonical_train")
    check_flat("canonical train step", bq_calls, res, path="canonical_train")
    check_three_nn("canonical train step", tn_calls, res, path="canonical_train")
    bounds = dict(nn1=print_launch_bounds("nn1", check_nn1("canonical train step", nn1_calls, res,
                                                           path="canonical_train"),
                                          per="canonical train step"),
                  gather_rows=record_gathers("canonical train step", gather_calls, res,
                                             path="canonical_train"))
    del scatter_calls[:], fps_calls[:], bq_calls[:], tn_calls[:], nn1_calls[:], before
    del gather_calls[:]

    # the eval step: inference mode, the fused eval-mode SA path, the mask
    valid = (torch.arange(CANON_B, device=dev) < CANON_B - 2).float()
    with recording(pc, "_nn1_kernel") as nn1_calls:
        eval_losses, eval_launches = counted(
            "canonical eval", lambda: eval_step(state, dict(batch, valid_mask=valid)),
            ["fused_chain", "nn1"])
    for k, v in eval_losses.items():
        require(bool(torch.isfinite(v).all()), f"canonical eval loss {k} is not finite")
    check_nn1("canonical eval step", nn1_calls, res, path="canonical_train")
    del nn1_calls[:]

    # the same step on the plain path from the same weights and dropout
    # seed, twice: it must launch no kernel and give the same losses. Its
    # gradients are printed beside the kernel path's, not gated: the plain
    # scatter and the losses' index_add_ use atomics, so the plain path
    # does not repeat itself, and the train-mode BatchNorms amplify that
    # rounding (up to ~1e-3 relative L2 between two plain runs)
    plain_grads = []
    for _ in range(2):
        state_plain, (train_plain, _) = new_state()
        ops.reset_counts()
        with ops.plain_ops():
            losses_plain = train_plain(state_plain, batch, generator())
        torch.cuda.synchronize()
        require(not any(ops.launch_counts.values()),
                f"the plain canonical train step launched kernels: {dict(ops.launch_counts)}")
        plain_grads.append({n: p.grad.detach().clone()
                            for n, p in state_plain.model.named_parameters()})
    loss_err = {k: float(((losses[k] - v).abs() / v.abs().clamp_min(1e-12)).max())
                for k, v in losses_plain.items()}
    path_err = {n: rel_l2(grads[n], g) for n, g in plain_grads[0].items()}
    path_spread = {n: rel_l2(plain_grads[1][n], g) for n, g in plain_grads[0].items()}
    worst, widest = max(path_err, key=path_err.get), max(path_spread, key=path_spread.get)
    print(f"canonical train step, kernel vs plain path, each forward and backward: losses "
          f"within {max(loss_err.values()):.3e} relative ({max(loss_err, key=loss_err.get)}); "
          f"gradients within {path_err[worst]:.3e} relative L2 ({worst}), the plain path "
          f"against itself within {path_spread[widest]:.3e} ({widest})", flush=True)
    require(max(loss_err.values()) <= LOSS_TOL,
            f"canonical train losses, kernel vs plain path: {loss_err}")
    del grads, plain_grads
    forced = forced_scatter_backward(new_state()[0].model, assets, body, batch, generator)

    step_s = wall_s(lambda: train_step(state, batch, generator()), runs=5, warmup=2)
    print(f"canonical train step, kernel path: {CANON_F / step_s:.2f} frames/s "
          f"({step_s * 1e3:.2f} ms per step of {CANON_F} frames)", flush=True)
    with ops.plain_ops():
        plain_s = wall_s(lambda: train_plain(state_plain, batch, generator()), runs=1, warmup=0)
    print(f"canonical train step, plain path on the card: {CANON_F / plain_s:.2f} frames/s "
          f"({plain_s * 1e3:.2f} ms)", flush=True)
    del state_plain, train_plain
    rows, dev_ms = profile_device(lambda: train_step(state, batch, generator()), runs=1)
    idle = print_profile("canonical train", rows, dev_ms, step_s * 1e3, top=20)
    kernel_ms_ = {k: device_ms_of(rows, AB_KERNEL_NAMES[k]) for k in bounds}
    for k, b in bounds.items():
        print(f"canonical train step device ms per step: {k} {kernel_ms_[k]:.4f} in "
              f"{launches.get(k, 0)} launches (summed bound {b:.4f})", flush=True)
    torch.cuda.synchronize()
    return dict(launches=launches, eval_launches=eval_launches, forced=forced,
                kernel_device_ms=kernel_ms_, summed_bound_ms=bounds,
                path_grad_rel_l2=path_err, path_grad_plain_spread=path_spread,
                frames_per_sec=CANON_F / step_s,
                plain_frames_per_sec=CANON_F / plain_s, device_ms_per_step=dev_ms,
                idle_share=idle, loss_rel_err=loss_err,
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30, peak_step_gib=peak_step)


# the entry point's phase: a mini-CLOTH3D tree at the recipe's widths
ENTRY_SEQS, ENTRY_FRAMES, ENTRY_POINTS = 14, 20, 8192  # 8192 garment points > N: subsampled
ENTRY_EPOCHS = 2
ENTRY_TOL = 1e-5  # finalize_batch card vs CPU; --only_eval vs the logged eval, relative
ENTRY_WORKERS = (0, 1, 8)  # loader widths of the data path's own passes (8: the default)


def write_entry_tree(root: Path, assets) -> dict:
    """The CLOTH3D tree (`write_fixture`), the registered template and PCA
    pickle (as tests/test_cli.py writes them), SMPL_{MALE,FEMALE}.npz of two
    6890-vertex synthetic bodies, and a config at full widths over them."""
    import pickle

    import numpy as np

    from garment4d_tpu_torch.data.fixture import write_fixture
    from garment4d_tpu_torch.data.obj_io import write_obj
    from garment4d_tpu_torch.smpl import synthetic_smpl

    lists = write_fixture(str(root), assets, num_seqs=ENTRY_SEQS, frames_per_seq=ENTRY_FRAMES,
                          garment_points=ENTRY_POINTS)
    reg = root / "Skirt_reg"
    write_obj(str(reg / "Skirt_template.obj"), assets.template_v, [list(f) for f in assets.faces])
    with open(reg / "PCABase_SS.pkl", "wb") as f:
        pickle.dump({"components": assets.pca_components, "mean": assets.pca_mean,
                     "explained": assets.pca_explained, "ss_scale": assets.pca_scale}, f)
    smpl_dir = root / "smpl_models"
    smpl_dir.mkdir()
    for s, gender in enumerate(("male", "female")):
        m = synthetic_smpl(num_verts=N, seed=s, device="cpu")
        np.savez(smpl_dir / f"SMPL_{gender.upper()}.npz", parents=m.parents, faces=m.faces,
                 **{k: getattr(m, k).numpy() for k in ("v_template", "shapedirs", "posedirs",
                                                       "J_regressor", "lbs_weights")})
    cfg = root / "entry.yaml"
    cfg.write_text(f"""_BASE_CONFIG_: {REPO / "cfgs" / "skirt.yaml"}
GARMENT:
  PCADIM: 64
NETWORK:
  LBSK: 256
  ITERATION: 3
  NPOINTS: {N}
DATASET:
  ROOT_FOLDER: {root}
  TRAIN_F_LIST: {lists["train"]}
  EVAL_F_LIST: {lists["eval"]}
  EXCLUDE_SEQ_LIST: ""
""")
    return dict(cfg=str(cfg), smpl_dir=str(smpl_dir), lists=lists)


@contextlib.contextmanager
def timed_epochs():
    """Time every train and eval epoch of `fit` (`train/loop.py`; its last
    step reads its losses back, so the epoch ends synchronised) and count
    its frames: {"train": [(frames, s)], "eval": [...]}."""
    from garment4d_tpu_torch.train import loop

    got = {"train": [], "eval": []}
    originals = {"train": loop.train_one_epoch, "eval": loop.eval_one_epoch}

    def timed(split):
        def wrapper(state, batches, *args, **kwargs):
            frames = [0]

            def counting():
                for batch in batches:
                    frames[0] += batch["pcd"].shape[0] * batch["pcd"].shape[1]
                    yield batch

            t0 = time.perf_counter()
            out = originals[split](state, counting(), *args, **kwargs)
            torch.cuda.synchronize()
            got[split].append((frames[0], time.perf_counter() - t0))
            return out
        return wrapper

    loop.train_one_epoch, loop.eval_one_epoch = timed("train"), timed("eval")
    try:
        yield got
    finally:
        loop.train_one_epoch, loop.eval_one_epoch = originals["train"], originals["eval"]


def restored_matches_file(args, _kwargs, result) -> bool:
    """`restore_checkpoint`'s state against its file, bitwise: weights,
    BatchNorm statistics, Adam's moments and steps, `step`, `lr_scale`, the
    dropout generator's state and the plateau's."""
    path = args[0]
    state, _, _ = result
    saved = torch.load(path, map_location="cpu", weights_only=True)
    model = state.model.state_dict()
    ok = list(model) == list(saved["model_state"]) and all(
        same_bits(model[k].cpu(), v) for k, v in saved["model_state"].items())
    opt, want = state.optimizer.state_dict()["state"], saved["optimizer_state"]["state"]
    ok = ok and sorted(opt) == sorted(want) and all(
        same_bits(opt[i][k].cpu(), v) for i, s in want.items() for k, v in s.items())
    other = saved["other_state"]
    return (ok and state.step == other["step"] and state.lr_scale == other["lr_scale"]
            and torch.equal(state.generator_state, other["generator_state"])
            and state.plateau == other["plateau"])


def entry_point_phase(step_fps: dict, root: Path) -> dict:
    """The port's training entry point (`garment4d_tpu_torch.train_temporal`)
    at the recipe (`scripts/train/train_skirt_{canonical,posed}.sh`) on a
    mini-CLOTH3D tree written under `root`: the canonical stage, then the
    posed stage from its checkpoint with the canonical stage frozen, the
    posed run again for one more epoch (an auto-resume), then one
    evaluation of the posed checkpoint. The tree stays for phase 9."""
    from garment4d_tpu_torch import ops, train_temporal
    from garment4d_tpu_torch.data.cloth3d import Cloth3dDataset, Cloth3dPaths, finalize_batch
    from garment4d_tpu_torch.models import GarmentAssets
    from garment4d_tpu_torch.smpl import load_smpl
    from garment4d_tpu_torch.train import checkpoint

    t_phase = time.perf_counter()
    assets = GarmentAssets.synthetic(num_rings=RINGS, ring_size=RING_SIZE)
    tree = write_entry_tree(root, assets)
    # the reference's canonical stage (seeded weights) in its own
    # checkpoint layout, for the MGN run's --GarmentPCA_pretrain
    reference_canon = str(root / "reference_canonical.ckpt")
    reference_sd = save_reference(reference_canon, seeded_reference(
        reference_mirror().PCAGarmentEncoderSeg(
            "Skirt", assets.pca_components, assets.pca_mean, assets.pca_scale), seed=3))
    setup_s = time.perf_counter() - t_phase

    def args(out, *extra):
        return ["--config", tree["cfg"], "--smpl_model_dir", tree["smpl_dir"], "--T", str(T),
                "--lr", str(TRAIN_LR), "--output_dir", str(root / out), *extra]

    canon_ckpt = str(root / "canonical" / "ckpt" / "model.ckpt")
    posed_ckpt = str(root / "posed" / "ckpt" / "model.ckpt")
    posed_args = args("posed", "--GarmentPCALBS", "1", "--fix_PCA", "1",
                      "--GarmentPCA_pretrain", canon_ckpt, "--batch_size", str(TRAIN_B),
                      "--epoch_num", str(ENTRY_EPOCHS), "--lr_sche")
    runs = {
        "canonical": (args("canonical", "--GarmentPCA", "1", "--batch_size", str(CANON_B),
                           "--epoch_num", str(ENTRY_EPOCHS), "--lr_sche"),
                      CANON_TRAIN_KERNELS + ["fused_chain"]),
        "posed": (posed_args, POSED_TRAIN_KERNELS),
        "posed_resumed": (posed_args, POSED_TRAIN_KERNELS),
        "only_eval": (args("eval", "--GarmentPCALBS", "1", "--only_eval", "1",
                           "--batch_size", str(TRAIN_B), "--pretrained_model", posed_ckpt),
                      FORWARD_KERNELS + ["nn1"]),
        "mgn": (args("mgn", "--GarmentPCALBS", "1", "--MGN", "1", "--fix_PCA", "1",
                     "--GarmentPCA_pretrain", reference_canon, "--batch_size", str(TRAIN_B),
                     "--epoch_num", "1"), MGN_TRAIN_KERNELS),
    }
    saved = {"canonical": canon_ckpt, "posed": posed_ckpt, "posed_resumed": posed_ckpt,
             "mgn": str(root / "mgn" / "ckpt" / "model.ckpt")}
    out, launches, epochs, snapshots, restores = {}, {}, {}, {}, []
    for label, (argv, names) in runs.items():
        if label == "posed_resumed":  # one epoch past the checkpoint's
            argv = argv + ["--epoch_num", str(snapshots["posed"]["epoch"] + 2)]
        with timed_epochs() as times, \
                recording(checkpoint, "restore_checkpoint", keep=restored_matches_file) as rs:
            t0 = time.perf_counter()
            out[label], launches[label] = counted(
                f"entry point {label}", lambda: train_temporal.main(argv), names)
            wall = time.perf_counter() - t0
        restores.extend((label, ok) for ok in rs)
        epochs[label] = times
        snapshots[label] = torch.load(saved[label], map_location="cpu",
                                      weights_only=True) if label in saved else None
        print(f"entry point {label}: {wall:.2f} s, train epochs (frames, s) {times['train']}, "
              f"eval epochs {times['eval']}", flush=True)

    # every loss finite
    for label, result in out.items():
        for row in ([result] if label == "only_eval" else
                    [r[s] for r in result for s in ("train", "eval")]):
            require(row and all(math.isfinite(v) for v in row.values()),
                    f"entry point {label}: non-finite or missing losses {row}")
    # the canonical stage bitwise its bootstrap through both posed runs
    canon = snapshots["canonical"]["model_state"]
    for label in ("posed", "posed_resumed"):
        state = snapshots[label]["model_state"]
        require(all(same_bits(state[f"canonical.{k}"], v) for k, v in canon.items()),
                f"entry point {label}: the frozen canonical stage changed")
    # the MGN run's frozen canonical stage bitwise the reference file's
    from garment4d_tpu_torch.train.torch_import import map_reference_state_dict

    state = snapshots["mgn"]["model_state"]
    want = map_reference_state_dict(reference_sd)
    require(sorted(f"canonical.{k}" for k in want) == sorted(
        k for k in state if k.startswith("canonical.")
        and not k.endswith("num_batches_tracked")) and all(
        same_bits(state[f"canonical.{k}"], v) for k, v in want.items()),
        "entry point mgn: the canonical stage differs from the reference file")
    print(f"entry point mgn: the canonical stage ({len(want)} tensors) bitwise the "
          f"reference file's after its epoch", flush=True)
    # the auto-resume restored exactly the saved state, once, and ran the
    # epoch after the checkpoint's, its scalars from the restored step on
    require(restores == [("posed_resumed", True)],
            f"entry point: restores {restores}, one bitwise restore expected")
    saved_epoch, saved_step = snapshots["posed"]["epoch"], snapshots["posed"]["other_state"]["step"]
    require([h["epoch"] for h in out["posed_resumed"]] == [saved_epoch + 1],
            f"entry point: the resumed run's epochs {[h['epoch'] for h in out['posed_resumed']]}, "
            f"{saved_epoch + 1} expected")
    per_epoch = epochs["posed_resumed"]["train"][0][0] // (TRAIN_B * T)
    with open(root / "posed" / "metrics.jsonl") as f:  # both runs' lines, in order
        train = [row for row in map(json.loads, f) if row["tag"].startswith("Train/")]
    tail = train[-per_epoch * len({row["tag"] for row in train}):]  # the resumed epoch's
    steps = sorted({row["step"] for row in tail})
    require(steps == list(range(saved_step, saved_step + per_epoch)),
            f"entry point: the resumed epoch's Train/* steps {steps}, "
            f"{saved_step}..{saved_step + per_epoch - 1} expected")
    resumed = snapshots["posed_resumed"]
    require((resumed["epoch"], resumed["other_state"]["step"])
            in ((saved_epoch, saved_step), (saved_epoch + 1, saved_step + per_epoch)),
            "entry point: the resumed run did not continue the saved step count")
    # --only_eval against the eval logged for the epoch the checkpoint holds
    logged = {h["epoch"]: h for h in out["posed"] + out["posed_resumed"]}
    held = logged[resumed["epoch"]]["eval"]
    only = out["only_eval"]
    eval_err = max(abs(only[k] - v) / max(abs(v), 1e-12) for k, v in held.items())
    print(f"entry point --only_eval vs the logged eval of epoch "
          f"{resumed['epoch']}: largest relative difference "
          f"{eval_err:.3e}", flush=True)
    require(sorted(only) == sorted(held) and eval_err <= ENTRY_TOL,
            f"entry point --only_eval: relative difference {eval_err} > {ENTRY_TOL}")

    # one finalize_batch on the card against the same raw batch on the CPU
    from garment4d_tpu_torch.utils.config import load_config

    cfg = load_config(tree["cfg"])
    ds = Cloth3dDataset(Cloth3dPaths(root=str(root), template_prefix=str(
        root / "CLOTH3D_template")), tree["lists"]["eval"], "Skirt", T=T,
        npoints=cfg.NETWORK.NPOINTS, is_train=False, body_verts=N)
    raw = ds.collate([ds.raw_item(i) for i in (0, 4, 8, 12)])
    smpl_paths = {g: str(Path(tree["smpl_dir"]) / f"SMPL_{g.upper()}.npz")
                  for g in ("male", "female")}
    got = finalize_batch(raw, {g: load_smpl(p, "cuda") for g, p in smpl_paths.items()})
    want = finalize_batch(raw, {g: load_smpl(p, "cpu") for g, p in smpl_paths.items()})
    fin_err = 0.0
    for k, w in want.items():
        g = got[k].cpu()
        if w.dtype.is_floating_point:
            fin_err = max(fin_err, ((g - w).abs() / (1 + w.abs())).max().item())
        else:
            require(torch.equal(g, w), f"finalize_batch {k}: card and CPU differ")
    print(f"finalize_batch (B={raw['pose'].shape[0]}, T={T}, N={cfg.NETWORK.NPOINTS}) card "
          f"vs CPU: largest difference {fin_err:.3e} (relative beyond 1); indices and "
          f"labels equal", flush=True)
    require(fin_err <= ENTRY_TOL, f"finalize_batch card vs CPU {fin_err} > {ENTRY_TOL}")

    # the data path alone, per stage and loader width (`--num_workers`
    # 0, 1 and 8): one train epoch's batches read by the loader and
    # completed on the card with no step between them (two passes; the
    # first reads each sequence's files cold), and one batch's
    # `finalize_batch` by itself
    from garment4d_tpu_torch.data.pipeline import ParallelItemLoader
    from garment4d_tpu_torch.utils.config import parse_args

    data_path = {}
    bodies = {g: load_smpl(p, "cuda") for g, p in smpl_paths.items()}
    for label, argv in (("canonical", runs["canonical"][0]), ("posed", posed_args)):
        widths = {}
        for workers in ENTRY_WORKERS:
            run_args, run_cfg = parse_args([*argv, "--num_workers", str(workers)])
            loaders = []
            try:
                train_batches, _ = train_temporal.cloth3d_batches(
                    run_args, run_cfg, run_cfg.NETWORK.NPOINTS, bodies,
                    torch.device("cuda"), logging.getLogger("chip_smoke"), loaders)
                passes = []
                for _ in range(2):
                    t0, frames = time.perf_counter(), 0
                    for batch in train_batches(1):
                        frames += batch["pcd"].shape[0] * batch["pcd"].shape[1]
                    torch.cuda.synchronize()
                    passes.append(frames / (time.perf_counter() - t0))
            finally:
                for loader in loaders:
                    loader.close()
            widths[workers] = dict(cold_frames_per_sec=passes[0], frames_per_sec=passes[1])
            print(f"entry point {label} data path alone (B={run_args.batch_size}, "
                  f"--num_workers {workers}): {passes[1]:.2f} frames/s (cold pass "
                  f"{passes[0]:.2f})", flush=True)
        raw = ds.collate([ds.raw_item(i % len(ds)) for i in range(run_args.batch_size)])
        fin_ms = wall_s(lambda: finalize_batch(raw, bodies)) * 1e3
        data_path[label] = dict(by_workers=widths, finalize_ms=fin_ms,
                                batch=run_args.batch_size)
        print(f"entry point {label} finalize_batch (B={run_args.batch_size}): {fin_ms:.2f} "
              f"ms a batch", flush=True)

    # the loader alone (`raw_item` and `collate` on the host, nothing on
    # the card) over the canonical stage's train windows, their
    # sequences' files read once before
    train_ds = Cloth3dDataset(Cloth3dPaths(root=str(root), template_prefix=str(
        root / "CLOTH3D_template")), tree["lists"]["train"], "Skirt", T=T,
        npoints=cfg.NETWORK.NPOINTS, is_train=True, body_verts=N)
    index_batches = [list(range(i, i + CANON_B))
                     for i in range(0, len(train_ds) - CANON_B + 1, CANON_B)]
    for idxs in index_batches:
        train_ds.collate([train_ds.raw_item(i) for i in idxs])
    loader_alone = {}
    for workers in ENTRY_WORKERS:
        loader = ParallelItemLoader(train_ds.raw_item, num_workers=workers)
        try:
            t0 = time.perf_counter()
            for items in loader.map_batches(index_batches):
                train_ds.collate(items)
            secs = time.perf_counter() - t0
        finally:
            loader.close()
        windows = sum(len(b) for b in index_batches)
        loader_alone[workers] = dict(frames_per_sec=windows * T / secs,
                                     ms_per_window=secs / windows * 1e3)
        print(f"entry point loader alone (--num_workers {workers}, {windows} windows of "
              f"{T} frames): {windows * T / secs:.2f} frames/s, "
              f"{secs / windows * 1e3:.2f} ms a window", flush=True)
    torch.cuda.synchronize()

    fps = {}
    for label, key in (("canonical", "canonical_train"), ("posed", "posed_train")):
        frames = sum(f for f, _ in epochs[label]["train"])
        secs = sum(s for _, s in epochs[label]["train"])
        last = epochs[label]["train"][-1]
        fps[label] = dict(frames_per_sec=frames / secs, last_epoch_frames_per_sec=last[0] / last[1],
                          step_alone_frames_per_sec=step_fps[key],
                          eval_frames_per_sec=sum(f for f, _ in epochs[label]["eval"])
                          / sum(s for _, s in epochs[label]["eval"]),
                          data_path_alone=data_path[label])
        print(f"entry point {label} stage: {fps[label]['frames_per_sec']:.2f} train frames/s over "
              f"{len(epochs[label]['train'])} epochs ({frames} frames, {secs:.2f} s; last epoch "
              f"{fps[label]['last_epoch_frames_per_sec']:.2f}); the train step alone "
              f"{step_fps[key]:.2f} frames/s; eval {fps[label]['eval_frames_per_sec']:.2f} "
              f"frames/s", flush=True)
    phase_s = time.perf_counter() - t_phase
    print(f"entry point phase: {phase_s:.1f} s (tree written in {setup_s:.1f} s)", flush=True)
    return dict(launches=launches, frames_per_sec=fps, loader_alone=loader_alone,
                only_eval_rel_err=eval_err, finalize_err=fin_err, phase_s=phase_s, tree=tree)


# ---- phase 8: the MGN variant and the reference's checkpoint files --------


def reference_mirror():
    """`tests/torch_ref_mirror.py` of this checkout: the reference's networks
    class for class, with the key names of its released checkpoints (only
    constructed here; nothing of it runs)."""
    tests = str(REPO / "tests")
    sys.path.insert(0, tests)
    try:
        import torch_ref_mirror
    finally:
        sys.path.remove(tests)
    return torch_ref_mirror


def seeded_reference(model, seed: int):
    """Every parameter 0.1 N(0, 1) and every BatchNorm's running statistics
    off their init (mean 0.05 N(0, 1), var 0.5 + U(0, 1)), from a seeded
    CPU generator."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g) * 0.1)
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm1d, torch.nn.BatchNorm2d)):
                m.running_mean.copy_(torch.randn(m.running_mean.shape, generator=g) * 0.05)
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
    return model.eval()


def save_reference(path, model) -> dict:
    """`model`'s state_dict in the reference's checkpoint layout
    (`utils/train_utils.py:100-112`), keys with DDP's `module.` prefix;
    returns the file's state_dict."""
    sd = {f"module.{k}": v for k, v in model.state_dict().items()}
    torch.save({"epoch": 0, "model_state": sd, "optimizer_state": {}, "other_state": {}}, path)
    return sd


def reference_loaded(label, model, sd, report) -> int:
    """A reference file's load: every key of the file but
    `num_batches_tracked` loaded and none skipped, each of the port's
    tensors (but `num_batches_tracked`) bitwise the file's after the map's
    reshape; returns the count."""
    from garment4d_tpu_torch.train.torch_import import map_reference_state_dict

    mappable = [k for k in sd if not k.endswith("num_batches_tracked")]
    require(report["loaded"] == mappable and report["skipped"] == [],
            f"{label}: loaded {len(report['loaded'])} of {len(mappable)} tensors, skipped "
            f"{report['skipped'][:5]}")
    own = model.state_dict()
    want = map_reference_state_dict(sd)
    require(set(want) == {k for k in own if not k.endswith("num_batches_tracked")},
            f"{label}: the file fills {len(want)} tensors of the model's {len(own)}")
    for k, v in want.items():
        require(same_bits(own[k].cpu(), v), f"{label}: {k} differs from the file")
    print(f"{label}: {len(mappable)} tensors loaded, none skipped, each bitwise the file's",
          flush=True)
    return len(mappable)


def mgn_model(assets, body, canonical_sd, device):
    """The MGN model: the canonical stage from `canonical_sd`, the
    displacement MLP at torch's init from seed 0 (no trained MGN weights
    are in the repo), in eval mode on `device`."""
    from garment4d_tpu_torch.models import MgnGarmentModel

    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        model = MgnGarmentModel(assets, body.faces)
    model.canonical.load_state_dict(canonical_sd, strict=True)
    return model.to(device).eval()


def mgn_forward_phase(assets, body, pcd, body_in, canonical_sd, res: Results) -> dict:
    """The MGN forward at B=8, T=10 (80 frames of 2000 garment vertices
    against the 6890-vertex body): the launch counters, every 1-NN launch
    and both 16-float row gathers bitwise their plain versions, each new
    case timed; the LBS teacher-forced against the CPU's plain LBS on one
    sequence; frames/s and a profile."""
    from garment4d_tpu_torch.models import mgn, skinning
    from garment4d_tpu_torch.ops import pointcloud as pc

    model = mgn_model(assets, body, canonical_sd, torch.device("cuda"))

    def forward():
        with torch.inference_mode():
            return model(pcd, body_in)

    with recording(pc, "_nn1_kernel") as nn1_calls, \
            recording(pc, "_gather_rows_kernel", keep=gather_keep) as gather_calls, \
            recording(mgn, "lbs_garment_single_nn") as lbs_calls:
        out, launches = counted("mgn", forward, MGN_KERNELS)
    for name, n in MGN_LAUNCHES.items():
        require(launches.get(name, 0) == n, f"{name}: {launches.get(name, 0)} launches in an "
                f"MGN forward, {n} expected")
    posed = out.iter_garment_v[-1]
    require(len(out.iter_garment_v) == 1 and tuple(posed.shape) == (B, T, VG, 3),
            f"MGN output {[tuple(v.shape) for v in out.iter_garment_v]}")
    require(bool(torch.isfinite(posed).all()), "non-finite MGN garment")
    nn1_rows = check_nn1("mgn forward", nn1_calls, res, path="mgn")
    lbs_gathers = [r for r in gather_calls if r["args"][0].shape[-1] == 16]
    require(len(lbs_gathers) == 2 and all(r["args"][0].shape == (F, N, 16) and
                                          r["args"][1].shape == (F, VG) for r in lbs_gathers),
            f"MGN forward: 16-float row gathers {[r['case'] for r in lbs_gathers]}, two of "
            f"({F}, {N}, 16) x {VG} expected")
    bounds = dict(nn1=print_launch_bounds("nn1", nn1_rows, per="MGN forward"),
                  gather_rows=print_launch_bounds("gather_rows", gather_calls, per="MGN forward"))
    for case, (row, count) in by_case(lbs_gathers).items():
        gather_record(res, f"mgn forward {case} x{count}", *row["args"], path="mgn",
                      launches=count)
    print(f"MGN forward: {len(gather_calls)} row gathers ({len(lbs_gathers)} of 16-float "
          f"rows) and {len(nn1_rows)} 1-NN launch bitwise their plain versions", flush=True)

    # teacher-forced: the CPU's plain LBS of sequence 0 fed the card's inputs
    args, kwargs, got = lbs_calls[0]
    want = skinning.lbs_garment_single_nn(*[a[:1].cpu() for a in args], **kwargs)
    require(torch.equal(want.nn_idx, got.nn_idx[:T].cpu()),
            "MGN LBS: nearest body vertices differ between the card and the CPU")
    forced = dict(posed_max_abs=max_abs(want.posed_garment, got.posed_garment[:1].cpu()),
                  unposed_max_abs=max_abs(want.unposed_garment, got.unposed_garment[:1].cpu()))
    print(f"MGN LBS teacher-forced, card vs CPU plain, seq 0: indices equal, posed max abs diff "
          f"{forced['posed_max_abs']:.3e}, unposed {forced['unposed_max_abs']:.3e}", flush=True)
    for key, err in forced.items():
        require(err <= FORCED_TOL, f"MGN LBS teacher-forced: {key} {err} > {FORCED_TOL}")
    del nn1_calls[:], gather_calls[:], lbs_calls[:], out

    secs = wall_s(forward, runs=MGN_RUNS)
    print(f"MGN forward, kernel path: {F / secs:.2f} frames/s ({secs * 1e3:.2f} ms per {F} "
          f"frames)", flush=True)
    rows, dev_ms = profile_device(forward, runs=2)
    idle = print_profile("mgn", rows, dev_ms, secs * 1e3, top=12)
    kernel_ms_ = {k: device_ms_of(rows, AB_KERNEL_NAMES[k]) for k in TIMED_KERNELS
                  if launches.get(k, 0)}
    for k, b in bounds.items():
        print(f"MGN forward device ms per forward: {k} {kernel_ms_[k]:.4f} in "
              f"{launches.get(k, 0)} launches (summed bound {b:.4f})", flush=True)
    return dict(launches=launches, frames_per_sec=F / secs, device_ms_per_forward=dev_ms,
                idle_share=idle, kernel_device_ms=kernel_ms_, summed_bound_ms=bounds,
                forced=forced)


def mgn_train_phase(assets, body, canonical_sd, res: Results) -> dict:
    """One MGN train step at B=4, T=10 (the canonical stage trainable but
    reached by no gradient): the launch counters, every 1-NN and row-gather
    launch bitwise its plain version, finite losses, every displacement
    tensor moved, the canonical stage bitwise unchanged; the plain step
    launching no kernel and its losses within 1e-3; the kernel and plain
    backwards of one shared forward within 1e-4 relative L2; frames/s."""
    from garment4d_tpu_torch import losses as L
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.ops import pointcloud as pc
    from garment4d_tpu_torch.train import make_posed_steps, make_state_for
    from garment4d_tpu_torch.train.step import body_inputs_from_batch

    dev = torch.device("cuda")
    batch = make_batch(assets, body, batch_size=TRAIN_B, T=T, npoints=N, seed=1, device=dev)
    state, state_plain = (make_state_for(mgn_model(assets, body, canonical_sd, dev), lr=TRAIN_LR)
                          for _ in range(2))
    model = state.model
    train_step, _ = make_posed_steps(model, assets, body.faces)
    train_plain, _ = make_posed_steps(state_plain.model, assets, body.faces)
    canonical = {k: v.clone() for k, v in model.canonical.state_dict().items()}
    before = {k: p.detach().clone() for k, p in model.displacement.named_parameters()}

    with recording(pc, "_nn1_kernel") as nn1_calls, \
            recording(pc, "_gather_rows_kernel", keep=gather_keep) as gather_calls, \
            recording(L, "posed_stage_loss", keep=lambda a, kw, r: (a[2:], kw)) as loss_calls:
        losses, launches = counted("mgn train", lambda: train_step(state, batch),
                                   MGN_TRAIN_KERNELS)
    for name, n in MGN_TRAIN_LAUNCHES.items():
        require(launches.get(name, 0) == n, f"{name}: {launches.get(name, 0)} launches in an "
                f"MGN train step, {n} expected")
    for k, v in losses.items():
        require(bool(torch.isfinite(v).all()), f"MGN train step: loss {k} is not finite")
    for k, p in model.displacement.named_parameters():
        require(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                f"MGN displacement.{k}: no finite gradient")
        require(not torch.equal(p.detach(), before[k]), f"MGN displacement.{k}: not moved")
    require(all(p.grad is None for p in model.canonical.parameters()),
            "MGN train step: a gradient reached the canonical stage")
    for k, v in model.canonical.state_dict().items():
        require(torch.equal(v, canonical[k]), f"MGN train step: canonical {k} changed")
    print(f"MGN train step: losses finite ({losses['total_loss'].item():.6g} total), "
          f"{len(before)} displacement tensors moved, {len(canonical)} canonical tensors "
          f"bitwise unchanged; {len(gather_calls)} row gathers bitwise plain", flush=True)
    check_nn1("mgn train step", nn1_calls, res, path="mgn_train")
    lbs_gathers = [r for r in gather_calls if r["args"][0].shape[-1] == 16]
    for case, (row, count) in by_case(lbs_gathers).items():
        gather_record(res, f"mgn train step {case} x{count}", *row["args"], path="mgn_train",
                      launches=count)
    del nn1_calls[:], gather_calls[:]

    ops.reset_counts()
    with ops.plain_ops():
        losses_plain = train_plain(state_plain, batch)
    torch.cuda.synchronize()
    require(not any(ops.launch_counts.values()),
            f"the plain MGN train step launched kernels: {dict(ops.launch_counts)}")
    loss_err = {k: float(((losses[k] - v).abs() / v.abs().clamp_min(1e-12)).max())
                for k, v in losses_plain.items()}
    worst = max(loss_err, key=loss_err.get)
    print(f"MGN train step losses, kernel vs plain path: largest relative difference "
          f"{loss_err[worst]:.3e} ({worst})", flush=True)
    require(loss_err[worst] <= LOSS_TOL, f"MGN loss {worst}: relative {loss_err[worst]} > "
            f"{LOSS_TOL}")

    # the kernel and the plain backwards of one kernel-path forward
    loss_args, loss_kwargs = loss_calls[0]
    model.train()
    out = model(batch["pcd"], body_inputs_from_batch(batch))
    total = L.posed_stage_loss(out, batch, *loss_args, **loss_kwargs)["total_loss"]
    names, params = zip(*model.displacement.named_parameters())
    g_kernel = torch.autograd.grad(total, params, retain_graph=True)
    with plain_backward():
        g_plain = torch.autograd.grad(total, params)
    grad_err = {n: rel_l2(a, b) for n, a, b in zip(names, g_kernel, g_plain)}
    worst = max(grad_err, key=grad_err.get)
    print(f"MGN backward on one forward, kernels vs plain versions: largest relative L2 "
          f"{grad_err[worst]:.3e} ({worst})", flush=True)
    require(grad_err[worst] <= GRAD_TOL, f"MGN backward {worst}: relative L2 "
            f"{grad_err[worst]} > {GRAD_TOL}")
    del out, total, loss_calls[:]

    secs = wall_s(lambda: train_step(state, batch), runs=MGN_TRAIN_RUNS)
    print(f"MGN train step, kernel path: {TRAIN_F / secs:.2f} frames/s ({secs * 1e3:.2f} ms "
          f"per step of {TRAIN_F} frames)", flush=True)
    rows, dev_ms = profile_device(lambda: train_step(state, batch), runs=1)
    idle = print_profile("mgn train", rows, dev_ms, secs * 1e3, top=12)
    return dict(launches=launches, frames_per_sec=TRAIN_F / secs, loss_rel_err=loss_err,
                grad_rel_l2=grad_err, device_ms_per_step=dev_ms, idle_share=idle)


def reference_files_phase(assets, body, pcd, body_in) -> dict:
    """The reference's posed (lbs_k 256) and MGN networks at full width with
    seeded weights, saved in the reference's checkpoint layout, loaded on
    the card through `GarmentReconstructor.from_assets(checkpoint=)` and
    `load_pretrained`: every tensor loaded and bitwise, one finite forward
    of each."""
    from garment4d_tpu_torch import api
    from garment4d_tpu_torch.models import MgnGarmentModel
    from garment4d_tpu_torch.train.checkpoint import load_pretrained

    dev = torch.device("cuda")
    mirror = reference_mirror()
    pca = (assets.pca_components, assets.pca_mean, assets.pca_scale)
    counts = {}
    with tempfile.TemporaryDirectory(prefix="g4d_reference_") as tmp:
        posed_path, mgn_path = f"{tmp}/posed.ckpt", f"{tmp}/mgn.ckpt"
        posed_sd = save_reference(posed_path, seeded_reference(
            mirror.PCALBSGarmentUseSegEncoderSeg(
                "Skirt", *pca, garment_faces=assets.faces, body_faces_tri=body.faces,
                parents=body.parents, lbs_k=256), seed=1))
        mgn_sd = save_reference(mgn_path, seeded_reference(
            mirror.PCALBSGarmentUseSegEncoderSegMGN(
                "Skirt", *pca, garment_faces=assets.faces, parents=body.parents), seed=2))
        with recording(api, "load_pretrained") as reports:
            recon = api.GarmentReconstructor.from_assets(assets, body, device=dev,
                                                         checkpoint=posed_path)
        counts["posed"] = reference_loaded("reference posed file", recon.model, posed_sd,
                                           reports[0][2])
        model = MgnGarmentModel(assets, body.faces).to(dev).eval()
        counts["mgn"] = reference_loaded("reference MGN file", model, mgn_sd,
                                         load_pretrained(mgn_path, model))
    posed = recon.posed(pcd, body_in)
    with torch.inference_mode():
        mgn_out = model(pcd, body_in).iter_garment_v[-1]
    for label, v in (("posed", posed), ("MGN", mgn_out)):
        require(tuple(v.shape) == (B, T, VG, 3) and bool(torch.isfinite(v).all()),
                f"reference {label} file: forward not finite")
    print("reference files: the posed and MGN forwards of the loaded weights finite",
          flush=True)
    return counts


# ---- phase 9: data parallelism on torch.distributed --------------------------

DP_WORLD = 2  # the ranks of phase 9b, all on the one card
DP_RANK_TIMEOUT = 600  # seconds a rank of phase 9b may take, its start included
DP1_TOL = dict(loss=1e-5, stats=1e-6, grad=1e-2)  # 9a: one rank over NCCL vs no group
DP2_TOL = dict(loss=1e-4, stats=1e-5, grad=2e-2)  # 9b: two ranks vs one process
ZERO_GRAD = 1e-5  # of the largest gradient norm: a gradient zero in exact arithmetic
# 9b, the posed step's per-sample loss entries: against one process on the same rows
# (the same forward at B=2), and against one process at B=4 (fp32 rounding of another
# batch size, 2.07e-4 in one frame on the card, amplified by the refinement)
PER_SAMPLE_EXACT, PER_SAMPLE_TOL = 1e-6, 2e-3


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def torchrun_env(rank: int, world: int, port: int) -> dict:
    """The variables torchrun gives a process of one host's group."""
    return dict(RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK="0",
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


@contextlib.contextmanager
def torchrun_vars(rank: int, world: int):
    """This process's environment as torchrun's rank `rank` of `world`, for
    `--launcher pytorch`; the previous values come back after."""
    env = torchrun_env(rank, world, free_port())
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def dp_state(stage: str, assets, body, weights, dev):
    """(train state, train step) of phase 5's posed or phase 6's canonical
    train step from `posed_synth.npz`; in a process group, a replica of a
    data-parallel run."""
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.models import CanonicalGarmentModel
    from garment4d_tpu_torch.train import (load_npz_subtree, make_canonical_steps,
                                           make_posed_steps, make_state_for)

    if stage == "posed":
        model = GarmentReconstructor.from_npz(assets, body, weights, device=dev).model
        state = make_state_for(model, lr=TRAIN_LR, freeze_canonical=True)
        return state, make_posed_steps(model, assets, body.faces)[0]
    model = CanonicalGarmentModel(assets).to(dev)
    model.load_state_dict(load_npz_subtree(weights, "canonical"), strict=True)
    state = make_state_for(model, lr=TRAIN_LR)
    return state, make_canonical_steps(model, assets, body.faces)[0]


DP_STAGES = {"canonical": (CANON_B, CANON_TRAIN_KERNELS), "posed": (TRAIN_B, POSED_TRAIN_KERNELS)}


def dp_step_args(stage: str, batch, dev):
    """The step's arguments after the state: the batch, and for the
    canonical stage a fresh dropout generator seeded 1 (phase 6's)."""
    if stage == "posed":
        return (batch,)
    return batch, torch.Generator(device=dev).manual_seed(1)


def step_record(state, losses) -> dict:
    """A copy on the CPU of one step's loss dict, gradients, parameters and
    buffers."""
    def host(t):
        return t.detach().to("cpu", copy=True)

    model = state.model
    return dict(losses={k: host(v) for k, v in losses.items()},
                grads={n: host(p.grad) for n, p in model.named_parameters()
                       if p.grad is not None},
                params={n: host(p) for n, p in model.named_parameters()},
                buffers={n: host(b) for n, b in model.named_buffers()})


def record_errors(got: dict, want: dict) -> dict:
    """`got` against `want` (the key sets must agree): the largest relative
    difference of a loss scalar (the 0-d entries; the per-sample entries'
    largest elementwise one beside it, `per_sample`, gated in 9b by
    `per_sample_errors`), the largest running-statistic difference
    relative to its tensor's largest magnitude, and the largest relative L2
    difference of a gradient. A gradient whose norm is below ZERO_GRAD of
    the largest in `want` is zero in exact arithmetic (the canonical PCA
    head's conv biases and the garment summary's last BatchNorm bias, each
    followed by a train-mode BatchNorm that cancels a shift), so fp32 leaves
    rounding noise there: it is held below ten times ZERO_GRAD of the
    largest on both sides instead (`zero`: its largest norm on either side
    over ZERO_GRAD of the largest)."""
    require(sorted(got["losses"]) == sorted(want["losses"]), "loss keys differ")
    require(sorted(got["grads"]) == sorted(want["grads"]), "the tensors with a gradient differ")
    rel = {k: float(((got["losses"][k] - v).abs() / v.abs().clamp_min(1e-12)).max())
           for k, v in want["losses"].items()}
    loss = {k: e for k, e in rel.items() if want["losses"][k].ndim == 0}
    per_sample = {k: e for k, e in rel.items() if k not in loss}
    stats = {n: float((got["buffers"][n] - v).abs().max() / v.abs().max().clamp_min(1e-30))
             for n, v in want["buffers"].items() if "running" in n}
    largest = max(float(g.norm()) for g in want["grads"].values())
    zero = {n for n, g in want["grads"].items() if float(g.norm()) < ZERO_GRAD * largest}
    grads = {n: rel_l2(got["grads"][n], g) for n, g in want["grads"].items() if n not in zero}
    zero_scale = max((max(float(got["grads"][n].norm()), float(want["grads"][n].norm()))
                      / (ZERO_GRAD * largest) for n in zero), default=0.0)
    return dict(loss=max(loss.values()), loss_key=max(loss, key=loss.get),
                per_sample=max(per_sample.values(), default=0.0),
                per_sample_key=max(per_sample, key=per_sample.get, default=None),
                stats=max(stats.values(), default=0.0),
                stats_key=max(stats, key=stats.get, default=None),
                grad=max(grads.values()), grad_key=max(grads, key=grads.get),
                zero=zero_scale, zero_keys=sorted(zero))


def records_equal(a: dict, b: dict) -> list:
    """The (part, name) pairs where two step records differ in any bit."""
    return [(part, name) for part in ("losses", "grads", "params", "buffers")
            for name in sorted(set(a[part]) | set(b[part]))
            if name not in a[part] or name not in b[part]
            or not same_bits(a[part][name], b[part][name])]


def check_errors(label: str, err: dict, tol: dict) -> None:
    print(f"{label}: losses within {err['loss']:.3e} relative ({err['loss_key']}; per sample "
          f"{err['per_sample']:.3e}, {err['per_sample_key']}), running "
          f"statistics within {err['stats']:.3e} ({err['stats_key']}), gradients within "
          f"{err['grad']:.3e} relative L2 ({err['grad_key']}); zero in exact arithmetic "
          f"{err['zero_keys']}: within {err['zero']:.3f} x {ZERO_GRAD} of the largest",
          flush=True)
    for key in ("loss", "stats", "grad"):
        require(err[key] <= tol[key], f"{label}: {key} difference {err[key]} > {tol[key]}")
    require(err["zero"] < 10.0, f"{label}: a gradient zero in exact arithmetic is not: {err}")


def per_sample_errors(got: dict, want: dict, halves: dict) -> dict:
    """9b's gate on the posed step's per-sample loss entries (B, T): the
    two ranks' entries, gathered in rank order, against one process's on
    the same rows (`halves`: a step on each rank's two sequences alone,
    9a) within PER_SAMPLE_EXACT relative, and against one process's step
    at B=4 within PER_SAMPLE_TOL. Beside them two readings that place
    PER_SAMPLE_TOL: the control, `halves` against the B=4 step (the same
    rows, another batch size; the trained part has no BatchNorm, so they
    differ by fp32 rounding alone, which the refinement amplifies), which
    must fall below it, and the rank blocks in the wrong order against the
    B=4 step, which must fall above it, or the gate could not see that
    fault."""
    def worst(entries, ref):
        return max(float(((entries[k] - v).abs() / v.abs().clamp_min(1e-12)).max())
                   for k, v in ref.items())

    per_sample = {k: v for k, v in want.items() if v.ndim}
    require(per_sample and sorted(halves) == sorted(per_sample),
            f"per-sample entries {sorted(per_sample)}, halves {sorted(halves)}")
    swapped = {k: torch.cat(v.chunk(DP_WORLD)[::-1]) for k, v in halves.items()}
    err = dict(per_sample_ranks_vs_halves=worst(got, halves),
               per_sample_ranks_vs_single=worst(got, per_sample),
               per_sample_control=worst(halves, per_sample),
               per_sample_wrong_order=worst(swapped, per_sample))
    print(f"posed per-sample entries {sorted(per_sample)}: two ranks vs one process on the "
          f"same rows {err['per_sample_ranks_vs_halves']:.3e}, two ranks vs one process at "
          f"B={TRAIN_B} {err['per_sample_ranks_vs_single']:.3e}; control (one process at "
          f"B={TRAIN_B // DP_WORLD} on each half vs B={TRAIN_B}) "
          f"{err['per_sample_control']:.3e}, rank blocks swapped "
          f"{err['per_sample_wrong_order']:.3e}; gate {PER_SAMPLE_TOL}", flush=True)
    require(err["per_sample_ranks_vs_halves"] <= PER_SAMPLE_EXACT,
            f"9b posed per-sample entries vs one process on the same rows: {err}")
    require(err["per_sample_control"] <= PER_SAMPLE_TOL,
            f"9b control above the per-sample gate: {err}")
    require(err["per_sample_ranks_vs_single"] <= PER_SAMPLE_TOL,
            f"9b posed per-sample entries vs one process at B={TRAIN_B}: {err}")
    require(err["per_sample_wrong_order"] > PER_SAMPLE_TOL,
            f"9b: the per-sample gate would not see the rank blocks swapped: {err}")
    return err


@contextlib.contextmanager
def world_of_one():
    """A process group of this one process over NCCL (torchrun's variables
    for rank 0 of 1), ended after: the switch of the data-parallel path."""
    from garment4d_tpu_torch import parallel

    with torchrun_vars(0, 1):
        info = parallel.initialize_distributed("pytorch", device="cuda")
    try:
        require(info["backend"] == "nccl" and info["process_count"] == 1,
                f"world-1 group: {info}")
        yield info
    finally:
        parallel.shutdown()
    require(not torch.distributed.is_initialized(), "9a left its group behind")


def dp_path(stage: str, label: str, assets, body, weights) -> dict:
    """One 9a run of a train step at its phase's shape (phase 5's posed at
    B=4, phase 6's canonical at B=20, seed 1), from `posed_synth.npz`: the
    step once with the launch counters at 0 before it, its FPS frames and
    all-reduce calls recorded; then, but for `plain again`, frames/s
    (median of 5 after 2 warm-ups) and the device ms and NCCL kernels of a
    step by the profiler."""
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.nn import BatchNorm
    from garment4d_tpu_torch.ops import pointcloud as pc

    dev = torch.device("cuda")
    batch_size, names = DP_STAGES[stage]
    batch = make_batch(assets, body, batch_size=batch_size, T=T, npoints=N, seed=1, device=dev)
    state, step = dp_state(stage, assets, body, weights, dev)
    with recording(pc, "_fps_kernel", keep=lambda a, k, r: int(a[0].shape[0])) as fps_calls, \
            recording(torch.distributed, "all_reduce",
                      keep=lambda a, k, r: a[0].numel()) as reduce_calls:
        losses, launches = counted(f"{stage} train step, {label}",
                                   lambda: step(state, *dp_step_args(stage, batch, dev)), names)
    out = dict(record=step_record(state, losses), launches=launches,
               fps_frames=list(fps_calls), reduces=list(reduce_calls),
               batchnorms=sum(isinstance(m, BatchNorm) and m.training
                              for m in state.model.modules()))
    if label != "plain again":
        secs = wall_s(lambda: step(state, *dp_step_args(stage, batch, dev)), runs=5, warmup=2)
        rows, dev_ms = profile_device(lambda: step(state, *dp_step_args(stage, batch, dev)),
                                      runs=1)
        nccl = [r for r in rows if "nccl" in r[2].lower()]
        out.update(frames_per_sec=batch_size * T / secs, profile=dict(
            device_ms=dev_ms, nccl_launches=sum(r[1] for r in nccl),
            nccl_ms=sum(r[0] for r in nccl), nccl_kernels=sorted({r[2] for r in nccl})))
        print(f"{stage} train step, {label}: {out['frames_per_sec']:.2f} frames/s "
              f"({secs * 1e3:.2f} ms a step), device {dev_ms:.3f} ms a step, "
              f"NCCL {out['profile']['nccl_launches']:.0f} launches "
              f"{out['profile']['nccl_ms']:.4f} ms a step {out['profile']['nccl_kernels']}",
              flush=True)
    del state, step, losses, batch
    torch.cuda.empty_cache()
    return out


def posed_halves(assets, body, weights) -> dict:
    """For 9b's per-sample gate: the posed step's per-sample loss entries of
    one process on each rank's rows of 9a's batch alone (B=2 each), in rank
    order."""
    from garment4d_tpu_torch import parallel
    from garment4d_tpu_torch.data.synthetic import make_batch

    dev = torch.device("cuda")
    batch = make_batch(assets, body, batch_size=TRAIN_B, T=T, npoints=N, seed=1, device=dev)
    parts = []
    for r in range(DP_WORLD):
        state, step = dp_state("posed", assets, body, weights, dev)
        losses = step(state, parallel.shard_batch(batch, r, DP_WORLD))
        parts.append({k: v.to("cpu", copy=True) for k, v in losses.items() if v.ndim})
        del state, step, losses
    torch.cuda.empty_cache()
    return {k: torch.cat([part[k] for part in parts]) for k in parts[0]}


def dp_world_one(assets, body, weights) -> dict:
    """9a: each train step (`dp_path`) without a process group, the posed
    one twice, and then, in one group of one rank over NCCL, through the
    data-parallel path, from the same weights, batch and generator. The
    posed step bitwise (its trained part has no BatchNorm, and its losses'
    mesh sums repeat bitwise, as its second run without the group shows;
    torch's deterministic algorithms off); the canonical one
    within DP1_TOL (its BatchNorm moments summed in another order); the
    same launches on both paths; the all-reduce calls counted. Also 9b's
    `posed_halves`."""
    runs = {stage: {"plain": dp_path(stage, "plain", assets, body, weights)}
            for stage in DP_STAGES}
    runs["posed"]["plain again"] = dp_path("posed", "plain again", assets, body, weights)
    halves = posed_halves(assets, body, weights)
    with world_of_one():
        for stage in DP_STAGES:
            runs[stage]["data parallel"] = dp_path(stage, "data parallel", assets, body, weights)
    out = {}
    for stage, run in runs.items():
        plain, dp = run["plain"], run["data parallel"]
        if stage == "posed":
            control = records_equal(plain["record"], run["plain again"]["record"])
            differ = records_equal(plain["record"], dp["record"])
            print(f"posed train step: plain vs plain again "
                  f"{len(control)} tensors differ, data parallel vs plain {len(differ)} "
                  f"{differ[:5]}", flush=True)
            require(not control, f"the posed step does not repeat itself: {control[:5]}")
            require(not differ, f"posed step, data parallel vs plain: {differ[:5]}")
            err = dict(loss=0.0, stats=0.0, grad=0.0, differ=0)
        else:
            err = record_errors(dp["record"], plain["record"])
            check_errors("canonical train step, world of one over NCCL vs no group", err,
                         DP1_TOL)
        # a BatchNorm in training: one all-reduce of its moments forward and one
        # of their gradient backward; then the gradients' and the losses'
        want = 2 * dp["batchnorms"] + 2
        print(f"{stage} train step, data parallel: {len(dp['reduces'])} all-reduces a step "
              f"({want} expected: {dp['batchnorms']} BatchNorms in training), "
              f"{sum(dp['reduces'])} floats", flush=True)
        require(len(dp["reduces"]) == want and not plain["reduces"],
                f"{stage}: all-reduces {len(dp['reduces'])} on the data-parallel path "
                f"({want} expected), {len(plain['reduces'])} without")
        require(dp["launches"] == plain["launches"],
                f"{stage}: launches {dp['launches']} vs {plain['launches']}")
        out[stage] = dict(
            frames_per_sec={k: run[k]["frames_per_sec"] for k in ("plain", "data parallel")},
            profile={k: run[k]["profile"] for k in ("plain", "data parallel")}, errors=err,
            all_reduces=len(dp["reduces"]), all_reduce_floats=sum(dp["reduces"]),
            launches=dp["launches"], single=plain["record"],
            halves=halves if stage == "posed" else None, fps_frames=plain["fps_frames"])
    return out


def dp_rank_main(outdir: Path) -> int:
    """One rank of 9b (`chip_smoke.py --dp-rank OUTDIR`, torchrun's
    variables in the environment): joins the gloo group on the card, runs
    each train step on its share of the global batch with the launch
    counters at 0 before it and the FPS launches' frame counts recorded,
    and writes what it saw to OUTDIR/rank<r>.pt."""
    from garment4d_tpu_torch import parallel
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.models import GarmentAssets
    from garment4d_tpu_torch.ops import _build, pointcloud as pc
    from garment4d_tpu_torch.smpl import synthetic_smpl

    info = parallel.initialize_distributed("pytorch", backend="gloo", device="cuda")
    try:
        _build.library()
        dev = info["device"]
        assets = GarmentAssets.synthetic(num_rings=RINGS, ring_size=RING_SIZE)
        body = synthetic_smpl(num_verts=N, device=dev)
        weights = str(REPO / "ckpt_synth" / "posed_synth.npz")
        out = dict(info={k: str(v) for k, v in info.items()})
        for stage, (batch_size, names) in DP_STAGES.items():
            state, step = dp_state(stage, assets, body, weights, dev)
            batch = parallel.shard_batch(make_batch(assets, body, batch_size=batch_size, T=T,
                                                    npoints=N, seed=1, device=dev))
            args = dp_step_args(stage, batch, dev)
            parallel.barrier()
            t0 = time.perf_counter()
            with recording(pc, "_fps_kernel", keep=lambda a, k, r: int(a[0].shape[0])) \
                    as fps_calls:
                losses, launches = counted(f"rank {info['process_index']} {stage} train step",
                                           lambda: step(state, *args), names)
            wall = time.perf_counter() - t0
            out[stage] = dict(step_record(state, losses), launches=launches,
                              fps_frames=list(fps_calls), wall_s=wall)
            del state, step, batch, args, losses
            torch.cuda.empty_cache()
        torch.save(out, outdir / f"rank{info['process_index']}.pt")
        parallel.barrier()
    finally:
        parallel.shutdown()
    return 0


def dp_two_ranks(single: dict, root: Path) -> dict:
    """9b: two ranks on the one card over gloo (NCCL refuses two ranks of
    one GPU), each a process of its own with its half of phase 5's and
    phase 6's global batches; against 9a's single-process steps (moved to
    the CPU, the card freed before): replicas bitwise, losses, statistics
    and gradients within DP2_TOL, the posed step's per-sample entries by
    `per_sample_errors`, each rank's kernels launched at its share of the
    frames."""
    outdir = root / "dp_ranks"
    outdir.mkdir()
    port = free_port()
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(REPO / "chip_smoke.py"), "--dp-rank",
                               str(outdir)], env={**os.environ, **torchrun_env(r, DP_WORLD, port)},
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(DP_WORLD)]
    try:
        outs = [p.communicate(timeout=DP_RANK_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        print("\n".join(f"[rank {r}] {line}" for line in text.splitlines()[-12:]), flush=True)
        require(p.returncode == 0, f"9b: rank {r} exited with {p.returncode}")
    ranks = [torch.load(outdir / f"rank{r}.pt", map_location="cpu", weights_only=False)
             for r in range(DP_WORLD)]
    out = {}
    for stage in DP_STAGES:
        a, b = ranks[0][stage], ranks[1][stage]
        differ = records_equal(a, b)
        require(not differ, f"9b {stage}: the two ranks differ in {differ[:5]}")
        err = record_errors(a, single[stage]["single"])
        check_errors(f"{stage} train step, two ranks on one card vs one process", err, DP2_TOL)
        if single[stage]["halves"] is not None:
            err.update(per_sample_errors(a["losses"], single[stage]["single"]["losses"],
                                         single[stage]["halves"]))
        want = [f // DP_WORLD for f in single[stage]["fps_frames"]]
        for r, rank in enumerate(ranks):
            require(rank[stage]["fps_frames"] == want,
                    f"9b {stage} rank {r}: FPS over {rank[stage]['fps_frames']} frames, "
                    f"{want} expected")
        print(f"{stage} train step, two ranks sharing one card: replicas bitwise, FPS launches "
              f"over {want} frames a rank (one process: {single[stage]['fps_frames']}); "
              f"rank steps {[round(r[stage]['wall_s'], 3) for r in ranks]} s (two ranks "
              f"sharing one card, not a scaling number)", flush=True)
        out[stage] = dict(errors=err, launches=[r[stage]["launches"] for r in ranks],
                          fps_frames=want, step_wall_s=[r[stage]["wall_s"] for r in ranks])
    out["ranks_wall_s"] = wall
    print(f"9b: both ranks, their start and build load included, {wall:.1f} s", flush=True)
    return out


def dp_entry_point(root: Path, tree: dict, phase7_fps) -> dict:
    """9c: the entry point under `--launcher pytorch` with WORLD_SIZE=1
    (NCCL) on phase 7's tree: one canonical epoch at B=20, then one posed
    epoch (`--fix_PCA 1`) from its checkpoint. Losses finite, each
    checkpoint written once by rank 0, the launch counters nonzero, no
    group left behind; train frames/s beside phase 7's."""
    from garment4d_tpu_torch import train_temporal
    from garment4d_tpu_torch.train import checkpoint

    def args(out, *extra):
        return ["--config", tree["cfg"], "--smpl_model_dir", tree["smpl_dir"], "--T", str(T),
                "--lr", str(TRAIN_LR), "--epoch_num", "1", "--launcher", "pytorch",
                "--output_dir", str(root / out), *extra]

    canon_ckpt = str(root / "dp_canonical" / "ckpt" / "model.ckpt")
    runs = {
        "canonical": (args("dp_canonical", "--GarmentPCA", "1", "--batch_size", str(CANON_B)),
                      CANON_TRAIN_KERNELS + ["fused_chain"], canon_ckpt),
        "posed": (args("dp_posed", "--GarmentPCALBS", "1", "--fix_PCA", "1",
                       "--GarmentPCA_pretrain", canon_ckpt, "--batch_size", str(TRAIN_B)),
                  POSED_TRAIN_KERNELS, str(root / "dp_posed" / "ckpt" / "model.ckpt")),
    }
    out = {}
    for label, (argv, names, ckpt) in runs.items():
        with torchrun_vars(0, 1), timed_epochs() as times, \
                recording(checkpoint, "save_checkpoint", keep=lambda a, k, r: a[0]) as saves:
            history, launches = counted(f"entry point --launcher pytorch {label}",
                                        lambda: train_temporal.main(argv), names)
        require(not torch.distributed.is_initialized(), f"9c {label}: a group left behind")
        require(saves == [ckpt] and os.path.isfile(ckpt),
                f"9c {label}: checkpoints written {saves}, one at {ckpt} expected")
        for row in [h[s] for h in history for s in ("train", "eval")]:
            require(row and all(math.isfinite(v) for v in row.values()),
                    f"9c {label}: non-finite or missing losses {row}")
        frames = sum(f for f, _ in times["train"])
        fps = frames / sum(s for _, s in times["train"])
        before = phase7_fps[label]["frames_per_sec"]
        print(f"entry point --launcher pytorch (WORLD_SIZE=1, NCCL) {label}: {fps:.2f} train "
              f"frames/s over one epoch of {frames} frames; phase 7 without --launcher "
              f"{before:.2f} over two epochs",
              flush=True)
        out[label] = dict(frames_per_sec=fps, phase7_frames_per_sec=before, launches=launches,
                          saves=len(saves))
    return out


def data_parallel_phase(assets, body, weights, root: Path, tree: dict, phase7_fps) -> dict:
    """Phase 9: 9a, 9b, 9c, and their seconds."""
    t0 = time.perf_counter()
    world_one = dp_world_one(assets, body, weights)
    torch.cuda.empty_cache()
    two_ranks = dp_two_ranks(world_one, root)
    entry = dp_entry_point(root, tree, phase7_fps)
    phase_s = time.perf_counter() - t0
    print(f"data-parallel phase: {phase_s:.1f} s", flush=True)
    for stage in DP_STAGES:
        world_one[stage].pop("single")
        world_one[stage].pop("halves")
    return dict(world_one=world_one, two_ranks=two_ranks, entry_point=entry, phase_s=phase_s)


# ---- phase 10: the posed model's opt-in levers --------------------------------

LEVER_BELOW = 0.02  # the margin below: this share of phase 4's largest per-center step
LEVER_ABOVE = 1.25  # the margin above: this multiple of the largest drift from iteration 0
REUSE_TOL = dict(rtol=1e-5, atol=1e-6)  # reuse vs no reuse where not bitwise (the JAX test's)
REUSE_OP_MARGIN = 0.05  # the op-level reuse case's margin, halved until its table fits the cap
VIS_BATCHES = 2  # eval batches `--vis` exports


def center_steps(out) -> dict:
    """A posed forward's per-center displacements (norms, the largest over
    every frame and vertex): between consecutive iterations' centers (the
    LBS garment, then each iteration's output) and from the iteration-0
    centers, which the candidate reuse compares against."""
    cur = [out.lbs.posed_garment] + list(out.iter_garment_v[:-1])
    steps = [float((b - a).norm(dim=-1).max()) for a, b in zip(cur, cur[1:])]
    from_first = [float((c - cur[0]).norm(dim=-1).max()) for c in cur[1:]]
    return dict(steps=steps, from_first=from_first)


def lever_model(recon, **levers):
    """`recon`'s posed model (its weights, device and mode) with the levers."""
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.models import PosedGarmentModel

    model = PosedGarmentModel(recon.assets, recon.model.body_faces.cpu().numpy(),
                              lbs_k=recon.model.lbs_k, **levers)
    model.load_state_dict(recon.model.state_dict(), strict=True)
    return GarmentReconstructor(assets=recon.assets, model=model.to(recon.device).eval(),
                                device=recon.device)


def fresh_levers(args):
    """Recorded `refine` arguments with its LeverState replaced by a fresh
    one of the same center order (no candidate state: built anew)."""
    from garment4d_tpu_torch.models import LeverState

    return [LeverState(a.cperm, a.cinv) if isinstance(a, LeverState) else a for a in args]


@torch.inference_mode()
def refine_with_build(model, args):
    """`model.refine(*args)` (with `fresh_levers`) -> ((offsets, hidden),
    whether the candidate table its body query built overflowed)."""
    from garment4d_tpu_torch.ops import pemax

    with recording(pemax, "_compact_candidates") as builds:
        out = model.refine(*fresh_levers(args))
    return out, bool(builds) and builds[-1][2][1]


@torch.inference_mode()
def check_lever_kernels(label, calls, res: Results) -> dict:
    """The new kernel cases of a lever forward, recorded with their inputs:
    every coverage and grouped ball-query launch bitwise its plain version
    (the widened coverage radius, the Morton-compacted body tables), every
    flat ball-query launch on the garment levels (Morton-sorted under the
    spatial lever) bitwise as it ran, every Morton code and permutation
    bitwise the CPU's, each distinct case timed; the row gathers were held
    bitwise as they ran (`gather_keep`), each distinct case timed here.
    -> counts."""
    from garment4d_tpu_torch.ops import morton, pointcloud as pc

    for i, row in enumerate(coverage_launches(calls["coverage"])):
        xyz, centers, r = row["args"]
        require(torch.equal(pc._covered_mask_kernel(xyz, centers, r),
                            pc._covered_mask_plain(xyz, centers, r)),
                f"{label}: coverage launch {i} (r {r:g}) differs from the plain version")
        res.record("coverage", f"{label} launch {i}: {row['case']}", 0,
                   lambda: pc._covered_mask_kernel(xyz, centers, r),
                   lambda: pc._covered_mask_plain(xyz, centers, r), row["nbytes"], row["ops"],
                   reps_p=1, path="levers", bytes_ms=row["bytes_ms"])
    grouped = query_launches(calls["grouped"], True)
    print_launch_bounds(f"{label} ball_query_grouped", grouped, per=f"{label} forward")
    for case, (row, count) in by_case(grouped).items():
        for other in (r for r in grouped if r["case"] == case):
            radii, nsamples, xyz, new_xyz, n_valid = args = other["args"][:5]
            want = [pc._ball_query_plain(r, s, xyz, new_xyz, n_valid)
                    for r, s in zip(radii, nsamples)]
            require(all(torch.equal(a, b) for a, b in
                        zip(pc._ball_query_grouped_kernel(*args), want)),
                    f"{label}: ball_query_grouped {case} differs from the plain version")
        radii, nsamples, xyz, new_xyz, n_valid = args = row["args"][:5]
        res.record("ball_query_grouped", f"{label} {case} x{count}", 0,
                   lambda: pc._ball_query_grouped_kernel(*args),
                   lambda: [pc._ball_query_plain(r, s, xyz, new_xyz, n_valid)
                            for r, s in zip(radii, nsamples)],
                   row["nbytes"], row["ops"], reps_p=1, path="levers", launches=count)
    if "flat" in calls:
        # the spatial lever's Morton-sorted garment levels, each queried
        # whole by the flat kernel (VG centers: the refinement iterations')
        garment = [c for c in calls["flat"] if c[0][3].shape[1] == VG]
        require(len(garment) >= 3 * 3, f"{label}: {len(garment)} garment-level flat queries")
        for (radii, nsamples, xyz, new_xyz), _, outs in garment:
            require(all(torch.equal(o, pc._ball_query_plain(r, s, xyz, new_xyz))
                        for o, r, s in zip(outs, radii, nsamples)),
                    f"{label}: ball_query {query_case((radii, nsamples, xyz, new_xyz))} "
                    f"differs from the plain version")
        for case, (row, count) in by_case(query_launches(garment, False)).items():
            radii, nsamples, xyz, new_xyz = args = row["args"][:4]
            res.record("ball_query", f"{label} sorted garment level {case} x{count}", 0,
                       lambda: pc._ball_query_kernel(*args),
                       lambda: [pc._ball_query_plain(r, s, xyz, new_xyz)
                                for r, s in zip(radii, nsamples)],
                       row["nbytes"], row["ops"], reps_p=1, queued=True, path="levers",
                       launches=count, scan_bound_ms=row["scan_bound_ms"])
    for name in ("morton_codes", "spatial_order"):
        for (xyz,), _, got in calls[name]:
            require(torch.equal(got.cpu(), getattr(morton, name)(xyz.cpu())),
                    f"{label}: {name} {tuple(xyz.shape)} differs from the CPU's")
    record_gathers(label, calls["gather"], res, path="levers")
    return {k: len(v) for k, v in calls.items()}


def lever_forward(label, recon, pcd, body_in, res: Results):
    """One counted posed forward of a lever model with every launch of the
    levers' new cases recorded
    (`check_lever_kernels`), its candidate builds and the refinement
    iterations. -> (output, launches, the
    builds' overflow flags, refine calls, per iteration whether the table
    its body query used had overflowed (a reused table never has: an
    overflow forces a rebuild), case counts)."""
    from garment4d_tpu_torch.ops import morton, pemax, pointcloud as pc

    with recording(pemax, "_compact_candidates") as builds, \
            recording(pc, "_covered_mask_kernel") as ccalls, \
            recording(pc, "_ball_query_grouped_kernel") as gcalls, \
            recording(pc, "_ball_query_kernel") as bcalls, \
            recording(morton, "morton_codes") as mcalls, \
            recording(morton, "spatial_order") as scalls, \
            recording(pc, "_gather_rows_kernel", keep=gather_keep) as gathers, \
            recording(recon.model, "refine",
                      keep=lambda a, k, r: (a, k, r, len(builds))) as steps:
        out, launches = counted(f"levers {label}",
                                lambda: recon.posed(pcd, body_in, return_all=True),
                                FORWARD_KERNELS)
    overflows = [b[2][1] for b in builds]
    decisions, seen = [], 0
    for *_, n in steps:
        decisions.append(overflows[n - 1] if n > seen else False)
        seen = n
    print(f"levers {label}: {len(overflows)} candidate builds in 3 body queries, overflows "
          f"{overflows}; the tables used overflowed {decisions}", flush=True)
    calls = dict(coverage=ccalls, grouped=gcalls, morton_codes=mcalls, spatial_order=scalls,
                 gather=gathers)
    if recon.model.spatial_sample:
        calls["flat"] = bcalls
    cases = check_lever_kernels(label, calls, res)
    return out, launches, overflows, [s[:3] for s in steps], decisions, cases


def forced_lever_iterations(label, steps, decisions, recon_cpu, spatial: bool) -> list:
    """Each recorded refinement iteration of a lever forward fed to the
    CPU plain path (sequence 0, the same center order, a fresh candidate
    table): offsets and hidden features within FORCED_TOL everywhere. Under
    the spatial lever an iteration whose table overflowed on one side only
    sampled otherwise (the full set in index order, as the JAX package's
    overflow branch, against the Morton-ordered table; the CPU decides on
    its 10 frames alone): printed, not gated."""
    rows = []
    for (args, _, (h_gpu, hid_gpu)), overflowed in zip(steps, decisions):
        def seq0(t):
            return None if t is None else t[:T].cpu()

        it, cur, hidden, g_xyz, g_feat, b_v, b_vn, _, _, levers = fresh_levers(args)
        levers.cperm, levers.cinv = seq0(levers.cperm), seq0(levers.cinv)
        (h_cpu, hid_cpu), cpu_overflowed = refine_with_build(recon_cpu.model, (
            it, seq0(cur), seq0(hidden), [seq0(t) for t in g_xyz], [seq0(t) for t in g_feat],
            seq0(b_v), seq0(b_vn), 1, T, levers))
        gated = not spatial or cpu_overflowed == overflowed
        row = dict(iteration=it, max_abs=max_abs(h_cpu, h_gpu[:T].cpu()),
                   hidden_max_abs=max_abs(hid_cpu, hid_gpu[:T].cpu()), overflowed=overflowed,
                   cpu_overflowed=cpu_overflowed, gated=gated)
        rows.append(row)
        print(f"levers {label}: teacher-forced iteration {it} on the CPU: max abs diff "
              f"{row['max_abs']:.3e}, hidden {row['hidden_max_abs']:.3e} (table overflowed: "
              f"card {overflowed}, CPU {cpu_overflowed}; gated {gated})", flush=True)
        for key in ("max_abs", "hidden_max_abs"):
            require(not gated or row[key] <= FORCED_TOL, f"levers {label}: teacher-forced "
                    f"iteration {it}: {key} {row[key]} > {FORCED_TOL}")
    return rows


def reuse_against(label, got, want, steps, decisions, want_decisions, ref, spatial) -> dict:
    """A reuse forward against the forward without reuse (`want`, of the
    model `ref`). Whole forwards: bitwise expected where neither
    overflowed (the same kernels on the same rows), else within REUSE_TOL;
    where one did, printed only (an overflowed query takes the full-set
    branch, whose no-hit centers come from the chain kernel and not from
    the fix-up's matmul: ~1e-7 apart, which later iterations' boundary
    flips amplify). Each iteration teacher-forced on the card, its inputs
    fed to `ref`: bitwise, else within REUSE_TOL; under the spatial lever
    where only one side's table overflowed (another sample), printed only."""
    diffs = [max_abs(a, b) for a, b in zip(got.iter_garment_v, want.iter_garment_v)]
    bitwise = all(same_bits(a, b) for a, b in zip(got.iter_garment_v, want.iter_garment_v))
    clean = not any(decisions) and not any(want_decisions)
    print(f"levers {label} vs the forward without reuse: bitwise {bitwise}, largest "
          f"difference per iteration {diffs} (overflow on either side: {not clean})", flush=True)
    if clean and not bitwise:
        for i, (a, b) in enumerate(zip(got.iter_garment_v, want.iter_garment_v)):
            require(torch.allclose(a, b, **REUSE_TOL),
                    f"levers {label}: iteration {i} differs by {diffs[i]} beyond {REUSE_TOL}")
    forced = []
    for (args, _, (h, hid)), overflowed in zip(steps, decisions):
        (h_ref, hid_ref), ref_overflowed = refine_with_build(ref.model, args)
        gated = not spatial or ref_overflowed == overflowed
        row = dict(iteration=args[0], bitwise=same_bits(h, h_ref) and same_bits(hid, hid_ref),
                   max_abs=max_abs(h, h_ref), hidden_max_abs=max_abs(hid, hid_ref),
                   overflowed=overflowed, ref_overflowed=ref_overflowed, gated=gated)
        forced.append(row)
        print(f"levers {label}: iteration {row['iteration']} fed to the model without reuse on "
              f"the card: bitwise {row['bitwise']}, max abs diff {row['max_abs']:.3e}, hidden "
              f"{row['hidden_max_abs']:.3e} (overflowed {overflowed} / {ref_overflowed}; gated "
              f"{gated})", flush=True)
        require(not gated or row["bitwise"] or (torch.allclose(h, h_ref, **REUSE_TOL) and
                                                torch.allclose(hid, hid_ref, **REUSE_TOL)),
                f"levers {label}: teacher-forced iteration {row['iteration']} against the "
                f"model without reuse beyond {REUSE_TOL}")
    return dict(bitwise=bitwise, max_abs=diffs, overflow=not clean, forced=forced)


@torch.inference_mode()
def body_query_reuse(recon, pcd, body_in) -> dict:
    """The body query's candidate reuse at the bench shape, op level, on the
    inputs of `recon`'s iteration-0 body query (the body (B*T, 6890) x the
    VG garment vertices), in index order and under the spatial lever: a
    build at REUSE_OP_MARGIN (halved until the widened table fits its cap),
    then the centers each moved by half the margin (the state reused: no
    coverage launch, the same state object; the outputs bitwise a fresh
    call's), then by twice the margin (rebuilt at the moved centers,
    bitwise a fresh call's); a reusing call's and a fresh call's ms by
    CUDA events (host reads included)."""
    from garment4d_tpu_torch import ops

    with recording(ops, "query_group_pe_multi") as qcalls:
        recon.posed(pcd, body_in)
    radii, nsamples, xyz, centers, feats, pe_params = qcalls[0][0][:6]
    del qcalls
    gen = torch.Generator(device=centers.device).manual_seed(0)
    step = torch.randn(centers.shape, generator=gen, device=centers.device)
    step = step / step.norm(dim=-1, keepdim=True).clamp_min(1e-12)
    rows = {}
    for spatial in (False, True):
        label = "spatial" if spatial else "index order"

        def call(c, state=None, margin=0.0):
            return ops.query_group_pe_multi(radii, nsamples, xyz, c, feats, pe_params,
                                            spatial=spatial, candidates=state,
                                            reuse_margin=margin)

        def same(got, c):
            return all(same_bits(a, b) for a, b in zip(got, call(c)[0]))

        margin = REUSE_OP_MARGIN
        outs0, state0 = call(centers, margin=margin)
        while state0["overflow"]:
            margin /= 2
            require(margin > 1e-4, f"body query reuse ({label}): every margin overflows")
            outs0, state0 = call(centers, margin=margin)
        require(same(outs0, centers), f"body query reuse ({label}): the build differs from "
                f"a fresh call")
        near, far = centers + 0.5 * margin * step, centers + 2.0 * margin * step
        ops.reset_counts()
        outs1, state1 = call(near, state0, margin)
        torch.cuda.synchronize()
        coverage = ops.launch_counts["coverage"]
        require(state1 is state0 and coverage == 0,
                f"body query reuse ({label}): a drift of half the margin rebuilt the table")
        require(same(outs1, near), f"body query reuse ({label}): the reusing call differs "
                f"from a fresh call")
        outs2, state2 = call(far, state1, margin)
        require(state2 is not state1 and torch.equal(state2["centers0"], far),
                f"body query reuse ({label}): a drift of twice the margin reused the table")
        require(same(outs2, far), f"body query reuse ({label}): the rebuilt call differs "
                f"from a fresh call")
        row = dict(margin=margin, counts_min=int(state0["counts"].min()),
                   counts_max=int(state0["counts"].max()),
                   reuse_ms=cuda_ms(lambda: call(near, state0, margin), 10),
                   fresh_ms=cuda_ms(lambda: call(near), 10))
        rows[label] = row
        print(f"body query reuse ({label}, {tuple(xyz.shape)} x {centers.shape[1]}): margin "
              f"{margin:g}, {row['counts_min']}-{row['counts_max']} candidates a frame; "
              f"half a margin reused (0 coverage launches), bitwise a fresh call; twice "
              f"rebuilt, bitwise; {row['reuse_ms']:.4f} ms reusing vs {row['fresh_ms']:.4f} "
              f"ms fresh", flush=True)
    return rows


def lever_train_step(assets, body, weights, margin, res: Results) -> dict:
    """The posed train step (B=4) with both levers from `posed_synth.npz`:
    the kernels launched (the gathers' backward, the scatter-add, among
    them), at least one body query on a Morton-compacted table (so its
    backward runs through the compacted rows), finite losses and gradients, every trainable tensor moved, the
    canonical stage bitwise unchanged; the plain step's losses within
    LOSS_TOL; per iteration the backward through the kernels against the
    plain versions' within GRAD_TOL (`teacher_forced_grads`); frames/s and
    a profile (the row gathers' and the scatter-add's device ms)."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.ops import pemax, pointcloud as pc
    from garment4d_tpu_torch.train import make_posed_steps, make_state_for

    dev = torch.device("cuda")
    batch = make_batch(assets, body, batch_size=TRAIN_B, T=T, npoints=N, seed=1, device=dev)
    base = GarmentReconstructor.from_npz(assets, body, weights, device=dev)

    def new_state():
        model = lever_model(base, spatial_sample=True, candidate_reuse_margin=margin).model
        return make_state_for(model, lr=TRAIN_LR, freeze_canonical=True)

    state, state_plain = new_state(), new_state()
    model = state.model
    train_step, _ = make_posed_steps(model, assets, body.faces)
    train_plain, _ = make_posed_steps(state_plain.model, assets, body.faces)
    trainable = {n: p.detach().clone() for n, p in model.named_parameters() if p.requires_grad}
    canonical = {k: v.clone() for k, v in model.canonical.state_dict().items()}
    with recording(model, "refine") as steps, \
            recording(pemax, "_compact_candidates", keep=lambda a, k, r: r[1]) as builds, \
            recording(pc, "_scatter_add_rows_kernel", keep=scatter_bound) as scatters:
        losses, launches = counted("levers train", lambda: train_step(state, batch),
                                   POSED_TRAIN_KERNELS + ["scatter_add"])
    print(f"levers train step: {len(builds)} candidate builds, overflows {builds}", flush=True)
    require(not all(builds), "levers train: no body query ran on a compacted table")
    for k, v in losses.items():
        require(bool(torch.isfinite(v).all()), f"levers train: loss {k} is not finite")
    params = dict(model.named_parameters())
    for name, before in trainable.items():
        p = params[name]
        require(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                f"levers train: {name}: no finite gradient")
        require(not torch.equal(p.detach(), before), f"levers train: {name}: not moved")
    for k, v in model.canonical.state_dict().items():
        require(torch.equal(v, canonical[k]), f"levers train: canonical {k} changed")
    ops.reset_counts()
    with ops.plain_ops():
        losses_plain = train_plain(state_plain, batch)
    torch.cuda.synchronize()
    require(not any(ops.launch_counts.values()), "levers train: the plain step launched kernels")
    loss_err = {k: float(((losses[k] - v).abs() / v.abs().clamp_min(1e-12)).max())
                for k, v in losses_plain.items()}
    worst = max(loss_err, key=loss_err.get)
    print(f"levers train step: {len(trainable)} tensors moved, losses vs the plain path "
          f"largest relative {loss_err[worst]:.3e} ({worst})", flush=True)
    require(loss_err[worst] <= LOSS_TOL, f"levers train: loss {worst} relative "
            f"{loss_err[worst]} > {LOSS_TOL}")
    forced, failed = teacher_forced_grads(model, [(fresh_levers(a), k, r) for a, k, r in steps])
    require(not failed, "; ".join(failed))
    step_s = wall_s(lambda: train_step(state, batch), runs=3, warmup=1)
    prof, dev_ms = profile_device(lambda: train_step(state, batch), runs=1)
    idle = print_profile("levers train", prof, dev_ms, step_s * 1e3, top=8)
    kernel_ms_ = {k: device_ms_of(prof, AB_KERNEL_NAMES[k]) for k in ("gather_rows",
                                                                       "scatter_add")}
    print(f"levers posed train step: {TRAIN_F / step_s:.2f} frames/s; device ms a step: "
          + ", ".join(f"{k} {ms:.4f} in {launches.get(k, 0)} launches"
                      for k, ms in kernel_ms_.items())
          + f" (the scatter-adds' summed bound {sum(scatters):.4f})", flush=True)
    return dict(launches=launches, builds=len(builds), overflows=sum(builds),
                loss_rel_err=loss_err, forced=forced,
                frames_per_sec=TRAIN_F / step_s, device_ms_per_step=dev_ms, idle_share=idle,
                kernel_device_ms=kernel_ms_, scatter_add_summed_bound_ms=sum(scatters))


def lever_entry_point(root: Path, tree: dict, margin: float) -> dict:
    """The entry point with both levers on phase 7's tree: one posed epoch
    (`--fix_PCA 1` from phase 7's canonical checkpoint), then `--only_eval 1
    --vis` of phase 7's posed checkpoint: finite losses, the kernels
    launched, and the export's files (VIS_BATCHES eval batches x TRAIN_B
    sequences x T frames x 4) with finite vertices."""
    import numpy as np

    from garment4d_tpu_torch import train_temporal
    from garment4d_tpu_torch.data.obj_io import read_obj

    levers = ["--spatial_sample", "1", "--candidate_reuse_margin", repr(margin)]
    common = ["--config", tree["cfg"], "--smpl_model_dir", tree["smpl_dir"], "--T", str(T),
              "--batch_size", str(TRAIN_B), "--GarmentPCALBS", "1", *levers]
    t0 = time.perf_counter()
    hist, train_launches = counted("levers entry point epoch", lambda: train_temporal.main(
        common + ["--fix_PCA", "1", "--GarmentPCA_pretrain",
                  str(root / "canonical" / "ckpt" / "model.ckpt"), "--epoch_num", "1",
                  "--lr", str(TRAIN_LR), "--output_dir", str(root / "posed_levers")]),
        POSED_TRAIN_KERNELS + ["scatter_add"])
    epoch_s = time.perf_counter() - t0
    for split in ("train", "eval"):
        require(all(math.isfinite(v) for v in hist[0][split].values()),
                f"levers entry point: non-finite {split} losses {hist[0][split]}")
    vis_out = root / "eval_vis"
    means, eval_launches = counted("levers entry point --only_eval --vis", lambda: train_temporal.main(
        common + ["--only_eval", "1", "--vis", "--pretrained_model",
                  str(root / "posed" / "ckpt" / "model.ckpt"), "--output_dir", str(vis_out)]),
        FORWARD_KERNELS + ["nn1"])
    require(all(math.isfinite(v) for v in means.values()), f"levers --only_eval: {means}")
    files = sorted(os.listdir(vis_out / "vis"))
    want = sorted(f"b{bi}_s{b}_f{t}_{kind}" for bi in range(VIS_BATCHES) for b in range(TRAIN_B)
                  for t in range(T) for kind in ("pcd.ply", "pred_garment.obj",
                                                 "gt_garment.obj", "body.obj"))
    require(files == want, f"levers --vis: {len(files)} files, {len(want)} expected")
    v, faces, _, _ = read_obj(str(vis_out / "vis" / f"b{VIS_BATCHES - 1}_s{TRAIN_B - 1}_f{T - 1}"
                                               f"_pred_garment.obj"))
    require(v.shape == (VG, 3) and bool(np.isfinite(v).all()) and len(faces) > 0,
            "levers --vis: the predicted garment OBJ")
    print(f"levers entry point: one posed epoch {epoch_s:.2f} s, {hist[0]['train']}; "
          f"--only_eval --vis wrote {len(files)} files", flush=True)
    return dict(epoch_s=epoch_s, train_launches=train_launches,
                eval_launches=eval_launches, vis_files=len(files))


def levers_phase(recon, recon_cpu, pcd, body_in, steps4: dict, assets, body, weights,
                 root: Path, tree: dict, res: Results) -> dict:
    """Phase 10: the posed forward under `spatial_sample`, under candidate
    reuse at a margin below and one above phase 4's per-center steps, and
    under both (the margin below, whose tables fit their cap); the body
    query's reuse at the op level; the posed train step and the entry
    point under both (the margin below)."""
    from garment4d_tpu_torch.ops import pemax

    t0 = time.perf_counter()
    step = max(steps4["steps"])
    margins = dict(below=LEVER_BELOW * step,
                   above=LEVER_ABOVE * max(step, max(steps4["from_first"])))
    print(f"levers: phase 4's largest per-center step between iterations {steps4['steps']}, "
          f"from the iteration-0 centers {steps4['from_first']}; margins {margins}", flush=True)
    configs = {"spatial": dict(spatial_sample=True),
               "reuse_below": dict(candidate_reuse_margin=margins["below"]),
               "reuse_above": dict(candidate_reuse_margin=margins["above"]),
               "both": dict(spatial_sample=True, candidate_reuse_margin=margins["below"])}
    out, rows, models, decided = {}, {}, {}, {}
    models["default"] = recon
    # torch's deterministic algorithms off: every sum of the forward repeats
    # bitwise (the body's vertex normals over their incidence table, phase 11)
    with recording(pemax, "_compact_candidates") as builds:
        out["default"] = recon.posed(pcd, body_in, return_all=True)
    decided["default"] = [b[2][1] for b in builds]  # a build an iteration
    for label, levers in configs.items():
        lever = models[label] = lever_model(recon, **levers)
        out[label], launches, overflows, steps, decided[label], cases = lever_forward(
            label, lever, pcd, body_in, res)
        row = dict(levers=levers, launches=launches, builds=len(overflows),
                   overflows=sum(overflows), tables_overflowed=decided[label], cases=cases)
        spatial = levers.get("spatial_sample", False)
        if "candidate_reuse_margin" in levers:
            ref = "spatial" if spatial else "default"
            row["vs_without_reuse"] = reuse_against(
                label, out[label], out[ref], steps, decided[label], decided[ref], models[ref],
                spatial)
        if spatial or not row["vs_without_reuse"]["bitwise"]:
            cpu = lever_model(recon_cpu, **levers)
            row["forced"] = forced_lever_iterations(label, steps, decided[label], cpu, spatial)
        else:  # the default forward's iterations, which phase 4 teacher-forces
            print(f"levers {label}: bitwise the default forward, whose iterations phase 4 "
                  f"holds teacher-forced", flush=True)
        del steps
        fwd_s = wall_s(lambda: lever.posed(pcd, body_in))
        prof, dev_ms = profile_device(lambda: lever.posed(pcd, body_in), runs=2)
        row.update(frames_per_sec=F / fwd_s, device_ms=dev_ms,
                   idle_share=print_profile(f"levers {label}", prof, dev_ms, fwd_s * 1e3, top=8),
                   kernel_device_ms={k: device_ms_of(prof, AB_KERNEL_NAMES[k])
                                     for k in TIMED_KERNELS})
        print(f"levers {label}: {row['frames_per_sec']:.2f} frames/s, {row['builds']} builds "
              f"and {row['overflows']} overflows a forward", flush=True)
        rows[label] = row
    del out, models
    torch.cuda.empty_cache()
    reuse_op = body_query_reuse(recon, pcd, body_in)
    torch.cuda.empty_cache()
    train = lever_train_step(assets, body, weights, margins["below"], res)
    torch.cuda.empty_cache()
    entry = lever_entry_point(root, tree, margins["below"])
    phase_s = time.perf_counter() - t0
    print(f"levers phase: {phase_s:.1f} s", flush=True)
    return dict(steps=steps4, margins=margins, forwards=rows, body_query_reuse=reuse_op,
                train=train, entry_point=entry, phase_s=phase_s)


def tensors_of(x, prefix: str) -> dict:
    """Every tensor of a (nested) output: {dotted name: tensor}."""
    if torch.is_tensor(x):
        return {prefix: x}
    if isinstance(x, (tuple, list)):
        names = getattr(x, "_fields", None) or range(len(x))
        out = {}
        for name, v in zip(names, x):
            out.update(tensors_of(v, f"{prefix}.{name}"))
        return out
    return {}


def index_add_normals(verts, faces):
    """The vertex normals as the port summed them before its incidence
    tables: three `index_add_` scatters (atomics on the card), a time
    yardstick only."""
    from garment4d_tpu_torch.ops import meshmath

    f = torch.as_tensor(faces, dtype=torch.long, device=verts.device)
    fn = meshmath.face_normals(verts, f)
    vn = torch.zeros_like(verts)
    for k in range(3):
        vn.index_add_(-2, f[:, k], fn)
    return vn / torch.linalg.norm(vn, dim=-1, keepdim=True).clamp_min(1e-6)


def determinism_phase(recon, pcd, body_in, assets, body, weights) -> dict:
    """Phase 11: the default posed forward (phase 4's shapes) twice and the
    posed train step (phase 5's, B=4, seed 1) twice from fresh states, with
    torch's deterministic algorithms off: every output tensor, loss,
    gradient, parameter and buffer bitwise equal. Prints each forward's
    launches and the vertex normals' ms at the body's shape, the incidence
    tables' gather and ordered sum beside the three `index_add_` scatters
    they replaced (a yardstick, not run-to-run bitwise)."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.data.synthetic import make_batch

    t0 = time.perf_counter()
    require(not torch.are_deterministic_algorithms_enabled(),
            "torch's deterministic algorithms are on")
    forwards, launches = [], []
    for i in range(2):
        out, n = counted(f"determinism: posed forward {i}",
                         lambda: recon.posed(pcd, body_in, return_all=True), FORWARD_KERNELS)
        forwards.append({k: v.to("cpu", copy=True) for k, v in tensors_of(out, "out").items()})
        launches.append(n)
        del out
    differ = [k for k in forwards[0] if not same_bits(forwards[0][k], forwards[1][k])]
    print(f"determinism: two posed forwards, {len(forwards[0])} output tensors, "
          f"{len(differ)} differ {differ[:5]}", flush=True)
    require(not differ, f"two posed forwards differ: {differ[:5]}")
    require(launches[0] == launches[1], f"launches differ: {launches}")

    dev = pcd.device
    batch = make_batch(assets, body, batch_size=TRAIN_B, T=T, npoints=N, seed=1, device=dev)
    records = []
    for i in range(2):
        state, step = dp_state("posed", assets, body, weights, dev)
        losses, _ = counted(f"determinism: posed train step {i}", lambda: step(state, batch),
                            POSED_TRAIN_KERNELS)
        records.append(step_record(state, losses))
        del state, step, losses
    differ = records_equal(*records)
    print(f"determinism: two posed train steps, {len(records[0]['losses'])} losses, "
          f"{len(records[0]['grads'])} gradients, {len(differ)} tensors differ {differ[:5]}",
          flush=True)
    require(not differ, f"two posed train steps differ: {differ[:5]}")

    body_v = body_in.smpl_vertices.reshape(F, N, 3)
    normals_ms = cuda_ms(lambda: ops.vertex_normals(body_v, body.faces), 20)
    scatter_ms = cuda_ms(lambda: index_add_normals(body_v, body.faces), 20)
    print(f"determinism: vertex normals ({F}, {N}) over {len(body.faces)} faces, incidence "
          f"tables {normals_ms:.4f} ms, index_add_ {scatter_ms:.4f} ms", flush=True)
    del batch
    torch.cuda.empty_cache()
    phase_s = time.perf_counter() - t0
    print(f"determinism phase: {phase_s:.1f} s", flush=True)
    return dict(forward_launches=launches[0], forward_tensors=len(forwards[0]),
                step_tensors=sum(len(records[0][k]) for k in records[0]),
                normals_ms=normals_ms, index_add_normals_ms=scatter_ms, phase_s=phase_s)


POST_FRAMES = 8  # process_frame: frame 0 of each of the 8 sequences
POST_CPU_POINTS = 512  # smoothed vertices of frame 0 projected on the CPU too, float64
POST_TOL = 1e-12  # the projection, card vs CPU, float64
FIT_SEED = 0  # the known parameters the fits recover
FIT_ITERS = 200  # LBFGS iterations of `fit_smpl_to_vertices`
STAGED_ITERS = (60, 120, 120)
FIT_BOUND = 0.02  # mean vertex residual of a fit, body units
CORR_VERTS, CORR_JITTER = 3000, 0.002  # the second topology: a jittered seeded subset


@contextlib.contextmanager
def timed_calls(owner, name):
    """Synchronised wall seconds of every call of `owner.name` in the block."""
    seconds = []
    fn = getattr(owner, name)

    def wrapper(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(*args, **kwargs)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return result

    setattr(owner, name, wrapper)
    try:
        yield seconds
    finally:
        setattr(owner, name, fn)


def fibonacci_sphere(n: int, radius: float):
    """n points on a sphere (a Fibonacci lattice) and the faces of their
    convex hull (2n - 4), each oriented outward: a closed surface."""
    import numpy as np
    from scipy.spatial import ConvexHull

    i = np.arange(n) + 0.5
    phi, theta = np.arccos(1 - 2 * i / n), np.pi * (1 + 5 ** 0.5) * i
    pts = radius * np.stack([np.cos(theta) * np.sin(phi), np.sin(theta) * np.sin(phi),
                             np.cos(phi)], axis=-1)
    faces = ConvexHull(pts).simplices.astype(np.int32)
    tri = pts[faces]
    inward = np.sum(np.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]) * tri.mean(1),
                    axis=-1) < 0
    faces[inward] = faces[inward][:, ::-1]
    return pts.astype(np.float32), faces


def fit_targets(body, rng, batch: int):
    """(betas, pose, transl) known parameters and the body's vertices for
    them: shape 0.3 sd, root orientation 0.4 sd, body pose 0.1 sd,
    translation 0.1 sd."""
    import numpy as np

    betas = (rng.randn(batch, 10) * 0.3).astype(np.float32)
    pose = (rng.randn(batch, 72) * 0.1).astype(np.float32)
    pose[:, :3] = (rng.randn(batch, 3) * 0.4).astype(np.float32)
    transl = (rng.randn(batch, 3) * 0.1).astype(np.float32)
    dev = body.v_template.device
    verts, _ = body.forward_axis_angle(torch.from_numpy(betas).to(dev),
                                       torch.from_numpy(pose).to(dev))
    return verts + torch.from_numpy(transl).to(dev)[:, None, :]


def residual(fitted, target) -> float:
    """Mean vertex distance between two (B, V, 3) sets."""
    fitted = torch.as_tensor(fitted).to(target.device)
    return float(torch.linalg.vector_norm(fitted - target, dim=-1).mean())


def postprocess_phase(recon, pcd, body_in, assets, body, res: Results) -> dict:
    """Phase 12: post-processing and body fitting on the card. The posed
    forward's last iteration (phase 4's batch: 80 frames of the Vg=2000
    ring against the 6890-vertex synthetic body): `laplacian_smooth` (100
    steps) and `detect_penetration` over all 80 frames with the launch
    counters at 0 before them (nn1 and gather_rows launched), every 1-NN
    and row-gather launch bitwise its plain version and each case timed;
    `process_frame` with the garment faces on frame 0 of each sequence
    (the body's faces a random soup: no more inside vertices after than
    before, its JAX test's gate) and on a closed pair, a 2000-vertex
    garment sphere inside a 6890-vertex body sphere (none inside after the
    last round, fewer rounds than 5); each frame's rounds, inside counts and
    ms split into the projection and the host solve; the projection of
    POST_CPU_POINTS points against the same function in float64 on the CPU
    (faces bitwise, barycentrics, points and normals within POST_TOL);
    `fit_smpl_to_vertices` (LBFGS, FIT_ITERS) and `fit_smpl_staged`
    (STAGED_ITERS) at B=8 to targets of known parameters (FIT_SEED), and
    the fit through `nearest_vertex_correspondence` to a jittered subset of
    the body's vertices, each mean vertex residual within FIT_BOUND."""
    import numpy as np
    import scipy.sparse.linalg

    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.data import postprocess
    from garment4d_tpu_torch.ops import pointcloud as pc
    from garment4d_tpu_torch.tools import fit_body, transfer

    t_phase = time.perf_counter()
    dev = pcd.device
    garment = recon.posed(pcd, body_in).reshape(F, VG, 3)
    body_v = body_in.smpl_vertices.reshape(F, N, 3).to(dev)
    adj = ops.build_mesh_adjacency(assets.faces, VG)
    norm_adj = torch.from_numpy(ops.row_normalize(adj)).to(dev)
    faces_tri = assets.faces_tri

    def smooth_and_detect():
        smoothed = postprocess.laplacian_smooth(garment, norm_adj)
        body_vn = ops.vertex_normals(body_v, body.faces)
        return smoothed, postprocess.detect_penetration(smoothed, body_v, body_vn)

    with recording(pc, "_nn1_kernel") as ncalls, \
            recording(pc, "_gather_rows_kernel", keep=gather_keep) as gcalls:
        (smoothed, (inside, nearest, normal)), launches = counted(
            "post-processing (smooth, detect)", smooth_and_detect, ["nn1", "gather_rows"])
    require(all(bool(torch.isfinite(t).all()) for t in (smoothed, nearest, normal)),
            "post-processing: non-finite output")
    check_nn1("post-processing detect", ncalls, res, path="postprocess")
    record_gathers("post-processing", gcalls, res, path="postprocess")
    smooth_s = wall_s(lambda: postprocess.laplacian_smooth(garment, norm_adj), runs=3)
    body_vn = ops.vertex_normals(body_v, body.faces)
    detect_s = wall_s(lambda: postprocess.detect_penetration(smoothed, body_v, body_vn), runs=3)
    print(f"post-processing, {F} frames: laplacian_smooth (100 steps) {smooth_s * 1e3:.3f} ms, "
          f"detect_penetration {detect_s * 1e3:.3f} ms; {float(inside.float().mean()):.4f} of "
          f"the smoothed vertices inside by the nearest-vertex screen", flush=True)
    del ncalls, gcalls

    def inside_count(v, bv, faces) -> int:
        """Garment vertices inside by the removal's own criterion."""
        near, nrm = postprocess.nearest_surface_points(v, bv, faces, device=dev)
        return int((np.sign(np.sum((np.asarray(v, np.float64) - near) * nrm, axis=-1))
                    <= -1e-6).sum())

    def one_frame(label, garment_v, bv, faces, g_adj, g_norm, g_faces):
        """`process_frame` with the launch counters at 0 before it, timed
        and split into the projection and the solve; the inside vertices of
        its removal's input (the smoothed garment) and of its output."""
        with timed_calls(postprocess, "_nearest_on") as proj_s, \
                timed_calls(scipy.sparse.linalg, "spsolve") as solve_s, \
                recording(postprocess, "remove_interpenetration") as removals:
            ops.reset_counts()
            t0 = time.perf_counter()
            out, rounds = postprocess.process_frame(garment_v, bv, faces, g_adj, g_norm,
                                                    garment_faces=g_faces,
                                                    return_rounds=True, device=dev)
            wall = time.perf_counter() - t0
        n = dict(ops.launch_counts)
        require(n.get("gather_rows", 0) > 0, f"process_frame {label}: no row gather launched")
        require(np.isfinite(out).all() and out.shape == garment_v.shape,
                f"process_frame {label}: output {out.shape}")
        row = dict(frame=label, rounds=rounds, ms=wall * 1e3, projection_ms=sum(proj_s) * 1e3,
                   solve_ms=sum(solve_s) * 1e3, launches=n,
                   inside_before=inside_count(removals[0][0][0], bv, faces),
                   inside_after=inside_count(out, bv, faces))
        print(f"process_frame {label}: {rounds} rounds, inside {row['inside_before']} -> "
              f"{row['inside_after']} of {len(out)}, {wall * 1e3:.2f} ms (projection "
              f"{row['projection_ms']:.2f} in {len(proj_s)} calls, solve {row['solve_ms']:.2f} "
              f"in {len(solve_s)}), launches {n}", flush=True)
        return row

    # the synthetic body's faces are a random triangle soup, with no inside
    # or outside: the removal flips its push by the sign of <garment normal,
    # body normal>, random here, so it stalls at 5 rounds (as the JAX
    # package's, tests/test_torch_port_postprocess.py); held to its JAX test's
    # gate, no more inside vertices after than before
    frames = []
    for b in range(POST_FRAMES):
        f = b * T
        row = one_frame(f"frame {f}", garment[f].cpu().numpy(), body_v[f].cpu().numpy(),
                        body.faces, adj, norm_adj.cpu().numpy(), faces_tri)
        require(row["rounds"] <= 5 and row["inside_after"] <= row["inside_before"],
                f"process_frame frame {f}: {row}")
        frames.append(row)
    # a closed, outward-oriented body surface (a 6890-vertex sphere) and a
    # 2000-vertex garment sphere inside it: every vertex pushed out, none
    # left inside after the last round
    sphere_v, sphere_f = fibonacci_sphere(N, 1.0)
    shell_v, shell_f = fibonacci_sphere(VG, 0.97)
    shell_adj = ops.build_mesh_adjacency(shell_f, VG)
    closed = one_frame("closed sphere pair", shell_v, sphere_v, sphere_f, shell_adj,
                       ops.row_normalize(shell_adj), shell_f)
    require(closed["rounds"] < 5 and closed["inside_after"] == 0,
            f"process_frame, closed sphere pair: {closed}")

    proj = []
    for f in (0,):
        pts, bv = smoothed[f, :POST_CPU_POINTS].double(), body_v[f].double()
        with recording(postprocess, "_surface_correspondence") as corr_calls:
            near, nrm = postprocess.nearest_surface_points(pts, bv, body.faces, device=dev)
            wnear, wnrm = postprocess.nearest_surface_points(pts.cpu(), bv.cpu(), body.faces,
                                                             device="cpu")
        (got, want) = [c[2] for c in corr_calls]  # (face_idx, bary, vidx) of each device
        err = dict(frame=f, faces_equal=torch.equal(got[0].cpu(), want[0]),
                   bary=max_abs(got[1].cpu(), want[1]),
                   points=float(np.abs(near - wnear).max()),
                   normals=float(np.abs(nrm - wnrm).max()))
        print(f"projection of {len(pts)} points of frame {f} onto {len(body.faces)} faces, "
              f"card vs CPU float64: faces equal {err['faces_equal']}, "
              f"barycentrics {err['bary']:.3e}, points {err['points']:.3e}, normals "
              f"{err['normals']:.3e}", flush=True)
        require(err["faces_equal"] and max(err["bary"], err["points"], err["normals"])
                <= POST_TOL, f"projection frame {f}: card vs CPU {err}")
        proj.append(err)

    rng = np.random.RandomState(FIT_SEED)
    target = fit_targets(body, rng, B)
    fits = {}
    for label, run in (
            ("lbfgs", lambda: fit_body.fit_smpl_to_vertices(body, target, iters=FIT_ITERS)),
            ("staged", lambda: transfer.fit_smpl_staged(body, target, iters=STAGED_ITERS))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fit = run()
        secs = time.perf_counter() - t0
        fits[label] = dict(ms=secs * 1e3, final_loss=fit.final_loss,
                           residual=residual(fit.vertices, target))
        print(f"fit {label} (B={B}, {N} vertices): {secs * 1e3:.1f} ms, final loss "
              f"{fit.final_loss:.3e}, mean vertex residual {fits[label]['residual']:.3e} "
              f"(bound {FIT_BOUND})", flush=True)
        require(fits[label]["residual"] <= FIT_BOUND, f"fit {label}: {fits[label]}")
    rest = body.v_template.cpu().numpy()
    sel = rng.permutation(N)[:CORR_VERTS]
    dst_rest = rest[sel] + CORR_JITTER * rng.randn(CORR_VERTS, 3).astype(np.float32)
    t0 = time.perf_counter()
    corr = fit_body.nearest_vertex_correspondence(rest, dst_rest, K=3, device=dev)
    corr_s = time.perf_counter() - t0
    fit = fit_body.fit_smpl_to_vertices(body, target[:, sel], correspondence=corr,
                                        iters=FIT_ITERS)
    fits["correspondence"] = dict(ms=corr_s * 1e3, final_loss=fit.final_loss,
                                  residual=residual(fit.vertices[:, sel], target[:, sel]))
    print(f"fit through nearest_vertex_correspondence ({CORR_VERTS} jittered vertices, K=3, "
          f"{corr_s * 1e3:.1f} ms): final loss {fit.final_loss:.3e}, mean vertex residual "
          f"{fits['correspondence']['residual']:.3e} (bound {FIT_BOUND})", flush=True)
    require(fits["correspondence"]["residual"] <= FIT_BOUND, f"fit correspondence: {fits}")
    phase_s = time.perf_counter() - t_phase
    print(f"post-processing phase: {phase_s:.1f} s", flush=True)
    return dict(launches=launches, smooth_ms=smooth_s * 1e3, detect_ms=detect_s * 1e3,
                inside_share=float(inside.float().mean()), frames=frames, closed=closed,
                projection=proj, fits=fits, phase_s=phase_s)


# ---- phase 13: the Trousers and Tshirt classes ---------------------------------

CLASSES = ("Trousers", "Tshirt")


def garment_selection(out, label: int, n: int) -> dict:
    """How many points of each frame the canonical stage labels as the
    class's garment (argmax of its segmentation logits), of which its
    selection keeps the first `n` and zero-pads the rest."""
    found = (out.canonical.backbone.sem_logits.argmax(-1) == label).sum(-1)
    return dict(min=int(found.min()), median=float(found.float().median()),
                max=int(found.max()), n=n, frames=found.numel(),
                frames_padded=int((found < n).sum()), frames_none=int((found == 0).sum()))


@torch.no_grad()
def slot0_foreign_ties(args) -> float:
    """The share of a PE backward's (center, channel) pairs whose max slot
    0 ties exactly with a slot that reads another table row: the ties in
    which the kernel's padding copies of slot 0 would take a share."""
    table, idx, centers, k0, b0, k1 = args[:6]
    tie, _ = pe_routing(table, idx, centers, k0, b0, k1)
    other = (idx[:, :, 1:] != idx[:, :, :1])[..., None]
    return float((tie[:, :, 0] & (tie[:, :, 1:] & other).any(dim=2)).float().mean())


PADDED_TIE_CASES = ((387, 4), (6, 4), (67, 12))  # (C, S): S off the kernel's 8-row tile
PE_NAMES = ("dtable",) + PE_GRADS


def padded_tie_case(C: int, S: int, seed: int = 28, device="cuda"):
    """PE-backward inputs (B=2, N=700, M=300, F=G=32; half the slots
    repeat slot 0, as the ball query's first-hit replication does) in which
    slot 0 ties exactly with another row of equal content: row j + 350 is
    row j, slot 0 reads j < 350 and slot 2 reads its copy. -> [table, idx,
    centers, k0, b0, k1, cot]."""
    B, N, M, F, G = 2, 700, 300, 32, 32
    g = torch.Generator().manual_seed(seed)
    table = torch.randn(B, N, C, generator=g)
    idx = torch.randint(0, N, (B, M, S), generator=g, dtype=torch.int32)
    idx[:, :, S // 2:] = idx[:, :, :1]
    centers = torch.randn(B, M, 3, generator=g)
    k0 = 0.3 * torch.randn(C, F, generator=g)
    b0 = 0.1 * torch.randn(F, generator=g)
    k1 = 0.3 * torch.randn(F, G, generator=g)
    cot = torch.randn(B, M, G, generator=g)
    half = N // 2
    table[:, half:] = table[:, :half]
    idx[:, :, 0] %= half
    idx[:, :, 2] = idx[:, :, 0] + half
    return [t.to(device) for t in (table, idx, centers, k0, b0, k1, cot)]


@torch.no_grad()
def padded_tie_errors(pemax) -> dict:
    """The package's PE backward with its dtable half on each
    `padded_tie_case`, unmasked: each output's max |kernel - plain| over
    max |plain|."""
    out = {}
    for C, S in PADDED_TIE_CASES:
        args = padded_tie_case(C, S)
        got = pemax._pe_bwd_kernel(*args, table_grad=True)
        want = pemax._pe_bwd_plain(*args, table_grad=True)
        out[f"C={C} S={S}"] = {n: float((a - b).abs().max() / b.abs().max())
                               for n, a, b in zip(PE_NAMES, got, want)}
    return out


@torch.no_grad()
def check_padded_tie(args, res: Results) -> list:
    """The S=4 PE backward (padded with slot 0 to the kernel's 8-row tile)
    on a tie of slot 0 with another row of equal content: the recorded
    call's table doubled (row j + N equal to row j) and slot 2 moved to the
    copy of slot 0's row, so that a center's max ties exactly between two
    rows wherever slot 0 or slot 2 holds it; then `check_pe_dtable` (all
    six gradients, dtable with the table trainable). JAX splits such a tie
    evenly between the two rows; a kernel that counted the pads among the
    tied slots would give slot 0's row 5/6 of the share. -> failures."""
    table, idx, centers, k0, b0, k1, cot = args
    tied = idx.clone()
    tied[:, :, 2] = idx[:, :, 0] + table.shape[1]
    case = (torch.cat([table, table], dim=1), tied, centers, k0, b0, k1, cot)
    print(f"padded tie: slot 0 ties another row in {slot0_foreign_ties(case):.3e} of the "
          f"(center, channel) pairs", flush=True)
    return check_pe_dtable(case, res, label="S=4, slot 0 tied to an equal row")


def class_train_step(assets, body, weights, res: Results) -> dict:
    """The Trousers posed train step at phase 5's shape (B=4, seed 1, Adam
    at 1e-3, the canonical stage frozen, `posed_synth.npz`): one counted
    step, finite losses, the plain path's losses within LOSS_TOL, each
    iteration's backward within GRAD_TOL of the plain versions'
    (`teacher_forced_grads`); every PE backward at S=4 held as phase 5
    holds its cases (`check_pe_case`), its unmasked gradients printed, and
    the padded tie (`check_padded_tie`); the step's wall frames/s and a
    profile."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.ops import pemax
    from garment4d_tpu_torch.train import make_posed_steps, make_state_for

    dev = torch.device("cuda")
    batch = make_batch(assets, body, batch_size=TRAIN_B, T=T, npoints=N, seed=1, device=dev)

    def new_state():
        model = GarmentReconstructor.from_npz(assets, body, weights, device=dev).model
        return make_state_for(model, lr=TRAIN_LR, freeze_canonical=True)

    state, state_plain = new_state(), new_state()
    train_step, _ = make_posed_steps(state.model, assets, body.faces)
    train_plain, _ = make_posed_steps(state_plain.model, assets, body.faces)
    with recording(pemax, "_pe_bwd_kernel") as pe_calls, \
            recording(state.model, "refine") as steps:
        losses, launches = counted(f"{assets.name} train", lambda: train_step(state, batch),
                                   POSED_TRAIN_KERNELS)
    require(launches["pe_bwd"] == TRAIN_LAUNCHES["pe_bwd"],
            f"{assets.name}: {launches['pe_bwd']} PE backwards in a train step")
    for k, v in losses.items():
        require(bool(torch.isfinite(v).all()), f"{assets.name} loss {k} is not finite")
    ops.reset_counts()
    with ops.plain_ops():
        losses_plain = train_plain(state_plain, batch)
    torch.cuda.synchronize()
    require(not any(ops.launch_counts.values()), "the plain train step launched kernels")
    loss_err = {k: float(((losses[k] - v).abs() / v.abs().clamp_min(1e-12)).max())
                for k, v in losses_plain.items()}
    worst = max(loss_err, key=loss_err.get)
    print(f"{assets.name} train step losses, kernel vs plain path: largest relative "
          f"difference {loss_err[worst]:.3e} ({worst})", flush=True)
    require(loss_err[worst] <= LOSS_TOL, f"{assets.name} loss {worst}: relative "
            f"{loss_err[worst]} > {LOSS_TOL}")
    cases = {}
    for a, _, _ in pe_calls:
        if a[1].shape[2] == 4:
            cases.setdefault((a[0].shape[2], a[1].shape[1]), a[:7])
    del pe_calls[:]
    require(cases, f"{assets.name}: no PE backward at S=4")
    failed, foreign = [], {}
    for args in cases.values():
        failed += check_pe_case(args, res, label=f"{assets.name} ", path="trousers")
        foreign[f"{tuple(args[1].shape)}"] = slot0_foreign_ties(args)
        print(f"{assets.name} PE backward {tuple(args[1].shape)}: slot 0 ties another row in "
              f"{foreign[f'{tuple(args[1].shape)}']:.3e} of the (center, channel) pairs",
              flush=True)
        failed += check_padded_tie(args, res)
    forced, forced_failed = teacher_forced_grads(state.model, steps)
    del steps[:]
    require(not failed + forced_failed, "; ".join(failed + forced_failed))
    step_s = wall_s(lambda: train_step(state, batch), runs=3, warmup=1)
    print(f"{assets.name} posed train step, kernel path: {TRAIN_F / step_s:.2f} frames/s "
          f"({step_s * 1e3:.2f} ms)", flush=True)
    rows, dev_ms = profile_device(lambda: train_step(state, batch), runs=1)
    idle = print_profile(f"{assets.name} train", rows, dev_ms, step_s * 1e3, top=6)
    return dict(launches=launches, loss_rel_err=loss_err, forced=forced,
                slot0_foreign_ties=foreign, frames_per_sec=TRAIN_F / step_s,
                device_ms=dev_ms, idle_share=idle)


def classes_phase(recon, pcd, body_in, body, weights, res: Results) -> dict:
    """Phase 13: the Trousers and Tshirt classes from `posed_synth.npz` at
    phase 4's shape (the Vg=2000 ring under the class's name). Each: the
    parameter tree the Skirt model's, one counted posed forward (every
    forward kernel launched), finite, and how many points its garment
    selection finds a frame. Trousers (garment samples (32, 8, 4)): every
    chain launch at S=4 held as phase 4 holds its cases
    (`check_chain_case`), each refinement iteration teacher-forced against
    the CPU plain path within FORCED_TOL, its wall frames/s and a profile;
    then its train step (`class_train_step`)."""
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.models import GarmentAssets

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    skirt_tree = {k: tuple(v.shape) for k, v in recon.model.state_dict().items()}
    out = {}
    for name in CLASSES:
        assets = GarmentAssets.synthetic(name=name, num_rings=RINGS, ring_size=RING_SIZE)
        crecon = GarmentReconstructor.from_npz(assets, body, weights, device=dev)
        tree = {k: tuple(v.shape) for k, v in crecon.model.state_dict().items()}
        require(tree == skirt_tree, f"{name}: the parameter tree is not the Skirt model's")
        radii = crecon.model.radii
        print(f"{name}: label {assets.label}, {radii}; the Skirt model's parameter tree "
              f"({len(tree)} tensors)", flush=True)
        with recording(crecon.model, "refine") as steps:
            fwd, launches = counted(name, lambda: crecon.posed(pcd, body_in, return_all=True),
                                    FORWARD_KERNELS)
        require(tuple(fwd.iter_garment_v[-1].shape) == (B, T, VG, 3), f"{name} posed shape")
        require(all(bool(torch.isfinite(v).all()) for v in fwd.iter_garment_v),
                f"non-finite {name} posed garment")
        sel = garment_selection(fwd, assets.label, N // 4)
        print(f"{name}: the garment selection finds {sel['min']}-{sel['max']} points a frame "
              f"(median {sel['median']:.0f}) and keeps up to {sel['n']}; "
              f"{sel['frames_padded']} of {sel['frames']} frames zero-padded, "
              f"{sel['frames_none']} with none", flush=True)
        row = dict(label=assets.label, radii=radii, launches=launches, selection=sel)
        del fwd
        if name == "Trousers":
            recon_cpu = GarmentReconstructor.from_npz(assets, body, weights, device="cpu")
            row["forced"] = teacher_forced_forward(steps, recon_cpu, label=f"{name} ")
            del recon_cpu
            chains = [r for r in chain_launches(record_chain_gcn(crecon, pcd, body_in)[0])
                      if r["args"][1].shape[2] == 4]
            require(chains, f"{name}: no chain launch at S=4")
            for case, (r, count) in by_case(chains).items():
                check_chain_case(case, r, count, res, label=f"{name} forward", path="trousers")
            del chains
            posed_s = wall_s(lambda: crecon.posed(pcd, body_in), runs=3)
            print(f"{name} posed forward, kernel path: {F / posed_s:.2f} frames/s", flush=True)
            rows, dev_ms = profile_device(lambda: crecon.posed(pcd, body_in), runs=2)
            row.update(frames_per_sec=F / posed_s, device_ms=dev_ms,
                       idle_share=print_profile(f"{name} posed", rows, dev_ms, posed_s * 1e3,
                                                top=6))
        del steps, crecon
        torch.cuda.empty_cache()
        if name == "Trousers":
            row["train"] = class_train_step(assets, body, weights, res)
        out[name] = row
    out["phase_s"] = time.perf_counter() - t0
    print(f"classes phase: {out['phase_s']:.1f} s", flush=True)
    return out


# ---- phase 14: the tracing tool ----------------------------------------------


def tools_phase() -> dict:
    """Phase 14: `python -m garment4d_tpu_torch.tools.profile_posed` for
    each of its paths on the card at `--iters 2`, through its `main`: the
    step time and frames/s, then the device ms a step by kernel, which
    `profile_device` holds against the launch counters (it raises after
    PROFILE_TRIES short sessions); the port's kernels must be in it."""
    from garment4d_tpu_torch.tools import profile_posed

    t0 = time.perf_counter()
    names = sum((v[0] for v in PROFILING.PROFILED.values()), ())
    out = {}
    for which in profile_posed.WHICH:
        print(f"profile_posed {which} --iters 2:", flush=True)
        r = profile_posed.main([which, "--iters", "2", "--top", "12"])
        port_ms = device_ms_of(r["rows"], names)
        require(port_ms > 0, f"profile_posed {which}: no kernel of the port in its table")
        out[which] = dict(frames_per_sec=r["frames_per_sec"], step_ms=r["step_ms"],
                          device_ms=r["total_ms"], idle_share=r["idle_share"],
                          launches=r["launches"], port_kernels_ms=port_ms)
    out["phase_s"] = time.perf_counter() - t0
    print(f"tools phase: {out['phase_s']:.1f} s", flush=True)
    return out


# ---- phase 15: the demos --------------------------------------------------------

SEG_DEMO_KERNELS = ["fps", "ball_query", "gather_rows", "three_nn", "scatter_add"]


def demos_phase() -> dict:
    """Phase 15: the three demos on the card at their defaults, through
    their `main`s, each passing its own gate (GCN accuracy > 0.9,
    segmentation accuracy > 0.8, the SMPL files written): the segmentation
    demo with the launch counters at 0 before it, each of its kernels
    launched, its median ms a step after the first."""
    import numpy as np

    from garment4d_tpu_torch.demos import gcn_node_demo, pointcloud_seg_demo, smpl_demo

    def gated(label, fn):
        try:
            return fn()
        except SystemExit as e:
            raise RuntimeError(f"chip_smoke: {label}: {e}") from None

    t0 = time.perf_counter()
    gcn = gated("gcn_node_demo", lambda: gcn_node_demo.main([]))
    times = []
    seg, launches = counted("pointcloud_seg_demo", lambda: gated(
        "pointcloud_seg_demo", lambda: pointcloud_seg_demo.main([], step_times=times)),
        SEG_DEMO_KERNELS)
    seg_ms = statistics.median(times[1:]) * 1e3
    print(f"pointcloud_seg_demo: {seg_ms:.2f} ms a step (median of {len(times) - 1} after "
          f"the first)", flush=True)
    out_dir = tempfile.mkdtemp(prefix="g4d_smpl_demo_")
    try:
        verts, joints = gated("smpl_demo", lambda: smpl_demo.main(
            ["--plot-joints", "--pose", "random", "--out", out_dir]))
        for f in ("body.obj", "body_preview.png", "joints.ply"):
            require(os.path.getsize(os.path.join(out_dir, f)) > 0, f"smpl_demo: no {f}")
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    require(bool(np.isfinite(verts).all() and np.isfinite(joints).all()),
            "smpl_demo: non-finite output")
    out = dict(gcn_accuracy=gcn[-1][1], seg_accuracy=seg[-1][1], seg_loss=(seg[0][0], seg[-1][0]),
               seg_ms_per_step=seg_ms, seg_launches=launches,
               phase_s=time.perf_counter() - t0)
    print(f"demos phase: {out['phase_s']:.1f} s", flush=True)
    return out


# ---- phase 16: --bf16, --remat, --debug_nans ---------------------------------
# TestBf16Mode's bounds (tests/test_models.py), bf16 against fp32
BF16_SUMMARY_TOL = dict(rtol=0.15, atol=0.3)
BF16_TPOSE_TOL = 0.2
BF16_LABELS = 0.99  # least share of the points labelled alike in bf16 and fp32
BF16_LOSS_TOL = 1e-2  # the bf16 canonical train step's losses, kernel vs plain path, relative
BF16_ULPS = 2  # the bf16 canonical forward, kernel vs plain path: ulps, + 1e-3
NAN_PARAMETER = "garment_pe1.linear0.weight"  # the --debug_nans phase's injection


def bf16_ulp(x):
    """The spacing of bf16 numbers at |x|."""
    return torch.exp2(torch.floor(torch.log2(x.abs().clamp_min(2.0 ** -126))) - 7)


def bf16_ulps_apart(got, want) -> float:
    """The largest difference of two fp32 tensors of bf16 results beyond
    1e-3, in ulps of bf16 at the larger magnitude."""
    excess = ((got - want).abs() - 1e-3).clamp_min(0)
    return float((excess / torch.maximum(bf16_ulp(got), bf16_ulp(want))).max())


@contextlib.contextmanager
def forced_labels(labels):
    """The canonical forward's garment selection fed `labels` (B*T, N)
    instead of its own argmax: the teacher-forced comparison of two paths
    whose labels could differ at a near tie."""
    from garment4d_tpu_torch.models import canonical

    select = canonical.select_garment_points

    def forced(xyz, features, _labels, garment_label, n):
        return select(xyz, features, labels, garment_label, n)

    canonical.select_garment_points = forced
    try:
        yield
    finally:
        canonical.select_garment_points = select


def canonical_outputs(o) -> dict:
    """The canonical forward's outputs that phases 16 and 17 compare."""
    return {"sem_logits": o.backbone.sem_logits, "features0": o.backbone.features[0],
            "garment_summary": o.garment_summary, "pca_coeff": o.pca_coeff,
            "tpose_garment": o.tpose_garment}


def canonical_of(assets, state_dict, dtype, dev):
    from garment4d_tpu_torch.models import CanonicalGarmentModel

    model = CanonicalGarmentModel(assets, compute_dtype=dtype).to(dev)
    model.load_state_dict(state_dict, strict=True)
    return model


def timed_path(label, fn, frames, runs=3):
    """frames/s (median of `runs` after a warm-up), the profiler's device
    ms a call and the idle share, printed."""
    wall = wall_s(fn, runs=runs)
    rows, dev_ms = profile_device(fn, runs=1)
    idle = print_profile(label, rows, dev_ms, wall * 1e3, top=6)
    print(f"{label}: {frames / wall:.2f} frames/s ({wall * 1e3:.2f} ms per {frames} frames), "
          f"device {dev_ms:.3f} ms", flush=True)
    return dict(frames_per_sec=frames / wall, wall_ms=wall * 1e3, device_ms=dev_ms, idle_share=idle)


@torch.inference_mode()
def bf16_canonical_forward(assets, pcd, state_dict, res: Results) -> dict:
    """The canonical forward (B=8, T=10) at compute_dtype bf16: counted
    (FPS, flat query, row gather and 3-NN launched, the chain kernel not:
    the SA stages run unfused, as the JAX package's do under bf16); every
    FPS, flat-query, gather and 3-NN launch held bitwise to its plain
    version and each case timed; the outputs against the card's plain bf16
    path teacher-forced on the same labels (within BF16_ULPS ulps + 1e-3);
    the labels against fp32's (BF16_LABELS agree at least) and the outputs
    on fp32's labels within TestBf16Mode's bounds of the fp32 forward's
    (on their own labels printed: at these trained weights a few flipped
    labels move the garment selection past those bounds); both forwards'
    frames/s, device ms and idle share."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.ops import pointcloud as pc

    dev = pcd.device
    model16 = canonical_of(assets, state_dict, torch.bfloat16, dev).eval()
    model32 = canonical_of(assets, state_dict, None, dev).eval()
    with recording(pc, "_fps_kernel") as fcalls, recording(pc, "_ball_query_kernel") as bcalls, \
            recording(pc, "_three_nn_kernel") as tcalls, \
            recording(pc, "_gather_rows_kernel", keep=gather_keep) as gcalls:
        out16, launches = counted("bf16 canonical forward", lambda: model16(pcd),
                                  ["fps", "ball_query", "gather_rows", "three_nn"])
    require(launches.get("fused_chain", 0) == 0, "the bf16 SA stages launched the chain kernel")
    check_fps("bf16 canonical forward", fcalls, res, path="bf16")
    check_flat("bf16 canonical forward", bcalls, res, path="bf16")
    check_three_nn("bf16 canonical forward", tcalls, res, path="bf16")
    gather_bound_ms = record_gathers("bf16 canonical forward", gcalls, res, path="bf16")
    del fcalls[:], bcalls[:], tcalls[:], gcalls[:]

    labels = out16.backbone.sem_logits.argmax(-1)
    with ops.plain_ops(), forced_labels(labels):
        out_plain = model16(pcd)
    out32 = model32(pcd)
    # a label that bf16 flips moves the garment selection, and with it the
    # encoder's neighbourhoods: the bounds hold on fp32's labels
    with forced_labels(out32.backbone.sem_logits.argmax(-1)):
        out16_forced = model16(pcd)

    got, plain = canonical_outputs(out16), canonical_outputs(out_plain)
    ulps = {k: bf16_ulps_apart(got[k], plain[k]) for k in got}
    bitwise = {k: torch.equal(got[k], plain[k]) for k in got}
    labels_plain = float((out_plain.backbone.sem_logits.argmax(-1) == labels).float().mean())
    labels_fp32 = float((out32.backbone.sem_logits.argmax(-1) == labels).float().mean())

    def vs_fp32(o):
        return dict(summary=float((o.garment_summary - out32.garment_summary).abs().max()),
                    summary_within=torch.allclose(o.garment_summary, out32.garment_summary,
                                                  **BF16_SUMMARY_TOL),
                    tpose=float((o.tpose_garment - out32.tpose_garment).abs().max()))

    forced, own = vs_fp32(out16_forced), vs_fp32(out16)
    print(f"bf16 canonical forward vs its plain path (teacher-forced labels; plain's own "
          f"agree {labels_plain:.6f}): ulps beyond 1e-3 {ulps}, bitwise {bitwise}", flush=True)
    print(f"bf16 canonical forward vs fp32: labels agree {labels_fp32:.6f}; on fp32's labels "
          f"{forced}, on its own {own}", flush=True)
    for k, u in ulps.items():
        require(u <= BF16_ULPS, f"bf16 canonical forward {k}: {u} ulps from the plain path")
    require(labels_fp32 >= BF16_LABELS, f"bf16 labels agree with fp32's on {labels_fp32}")
    require(forced["summary_within"], f"bf16 garment_summary beyond {BF16_SUMMARY_TOL} of fp32")
    require(forced["tpose"] < BF16_TPOSE_TOL, f"bf16 tpose_garment {forced['tpose']} from fp32")
    require(all(t.dtype == torch.float32 for t in got.values()), "bf16 outputs not fp32")
    del out16, out_plain, out32, out16_forced, got, plain
    timing = {label: timed_path(f"{label} canonical forward (B={B})", lambda m=m: m(pcd), F)
              for label, m in (("fp32", model32), ("bf16", model16))}
    return dict(launches=launches, ulps_vs_plain=ulps, bitwise_vs_plain=bitwise,
                labels_vs_fp32=labels_fp32, vs_fp32_forced=forced, vs_fp32_own_labels=own,
                gather_summed_bound_ms=gather_bound_ms, **timing)


def batchnorm_inputs(model, run):
    """The inputs of every BatchNorm of `model` in training during `run()`
    (a forward without autograd), each beside a copy of its module."""
    import copy

    from garment4d_tpu_torch.nn import BatchNorm

    got, handles = [], []
    for m in model.modules():
        if isinstance(m, BatchNorm):
            handles.append(m.register_forward_hook(
                lambda mod, args, _out: got.append((mod, args[0].detach()))))
    try:
        with torch.no_grad():
            run()
    finally:
        for h in handles:
            h.remove()
    # copied once their hooks are gone (a copy would copy the hook's list)
    return [(copy.deepcopy(m), x) for m, x in got]


def batchnorm_device_ms(model, run) -> tuple:
    """The train-mode BatchNorms of one step replayed alone, forward and
    backward (a cotangent of ones), on the inputs they had: (their count,
    the profiler's device ms)."""
    inputs = batchnorm_inputs(model, run)

    def replay():
        for bn, x in inputs:
            x = x.requires_grad_(True)
            y = bn(x)
            y.backward(torch.ones_like(y))
            x.grad = None

    _, dev_ms = profile_device(replay, runs=1)
    n = len(inputs)
    del inputs
    return n, dev_ms


def bf16_canonical_train_step(assets, body, state_dict) -> dict:
    """The canonical train step at B=20 in bf16 and fp32 from the same
    weights and dropout seed: the bf16 step counted (its kernels launched),
    every loss finite and within BF16_LOSS_TOL of the card's plain bf16
    step, every gradient finite; both steps' frames/s, device ms and idle
    share, and the BatchNorms' device ms replayed alone on each step's
    inputs (`batchnorm_device_ms`)."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.train import make_canonical_steps, make_state_for

    dev = torch.device("cuda")
    batch = make_batch(assets, body, batch_size=CANON_B, T=T, npoints=N, seed=1, device=dev)

    def new_state(dtype):
        model = canonical_of(assets, state_dict, dtype, dev)
        return make_state_for(model, lr=TRAIN_LR), make_canonical_steps(model, assets,
                                                                       body.faces)[0]

    def generator():
        return torch.Generator(device=dev).manual_seed(1)

    state16, step16 = new_state(torch.bfloat16)
    losses, launches = counted("bf16 canonical train",
                               lambda: step16(state16, batch, generator()), CANON_TRAIN_KERNELS)
    for k, v in losses.items():
        require(bool(torch.isfinite(v).all()), f"bf16 canonical loss {k} is not finite")
    for n, p in state16.model.named_parameters():
        require(p.grad is not None and bool(torch.isfinite(p.grad).all()),
                f"bf16 canonical {n}: no finite gradient")
    plain_state, plain_step = new_state(torch.bfloat16)
    ops.reset_counts()
    with ops.plain_ops():
        losses_plain = plain_step(plain_state, batch, generator())
    torch.cuda.synchronize()
    require(not any(ops.launch_counts.values()), "the plain bf16 step launched kernels")
    loss_err = {k: float(((losses[k] - v).abs() / v.abs().clamp_min(1e-12)).max())
                for k, v in losses_plain.items()}
    print(f"bf16 canonical train step losses: " + ", ".join(
        f"{k} {v.item():.6g}" for k, v in losses.items()) + f"; vs the plain bf16 step "
        f"within {max(loss_err.values()):.3e} relative", flush=True)
    require(max(loss_err.values()) <= BF16_LOSS_TOL,
            f"bf16 canonical train losses, kernel vs plain path: {loss_err}")
    del plain_state, plain_step, losses_plain
    torch.cuda.empty_cache()
    out = dict(launches=launches, loss_rel_err_vs_plain=loss_err)
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        state, step = (state16, step16) if dtype else new_state(None)
        out[label] = timed_path(f"{label} canonical train step (B={CANON_B})",
                                lambda: step(state, batch, generator()), CANON_F)
        state.model.train()
        n_bn, bn_ms = batchnorm_device_ms(state.model, lambda: state.model(batch["pcd"],
                                                                           generator()))
        out[label].update(batchnorms=n_bn, batchnorm_device_ms=bn_ms,
                          batchnorm_share=bn_ms / out[label]["device_ms"])
        print(f"{label} canonical train step: {n_bn} train-mode BatchNorms, forward and "
              f"backward replayed alone {bn_ms:.3f} device ms "
              f"({bn_ms / out[label]['device_ms']:.3f} of the step's)", flush=True)
        del state, step
        torch.cuda.empty_cache()
    return out


def posed_model(assets, body, weights, dev, compute_dtype=None):
    """The posed model from `posed_synth.npz` at `compute_dtype`."""
    from garment4d_tpu_torch.models import PosedGarmentModel
    from garment4d_tpu_torch.train.convert import load_npz

    model = PosedGarmentModel(assets, body.faces, compute_dtype=compute_dtype)
    model.load_state_dict(load_npz(weights), strict=True)
    return model.to(dev)


def posed_state(assets, body, weights, dev, compute_dtype=None, tripwire=False):
    """A posed train state from `posed_synth.npz` (canonical stage frozen),
    the model at `compute_dtype`, and its train step, with the
    NaN tripwire on it under `tripwire`: (state, train step, tripwire or
    None)."""
    from garment4d_tpu_torch.train import make_posed_steps, make_state_for
    from garment4d_tpu_torch.utils.debug_nans import NanTripwire

    model = posed_model(assets, body, weights, dev, compute_dtype)
    state = make_state_for(model, lr=TRAIN_LR, freeze_canonical=True)
    wire = NanTripwire(model) if tripwire else None
    return state, make_posed_steps(model, assets, body.faces, tripwire=wire)[0], wire


def bf16_posed(assets, body, weights, pcd, body_in) -> dict:
    """The posed forward (B=8) and train step (B=4) with a bf16 stage 1,
    beside the fp32 ones: finite outputs and losses, the kernels launched,
    frames/s, device ms and idle share."""
    from garment4d_tpu_torch.data.synthetic import make_batch

    dev = pcd.device
    out = {}
    batch = make_batch(assets, body, batch_size=TRAIN_B, T=T, npoints=N, seed=1, device=dev)
    for label, dtype in (("fp32", None), ("bf16", torch.bfloat16)):
        model = posed_model(assets, body, weights, dev, dtype).eval()

        @torch.inference_mode()
        def forward():
            return model(pcd, body_in).iter_garment_v[-1]

        posed, launches = counted(f"{label} posed forward", forward,
                                  ["fps", "ball_query", "gather_rows", "three_nn", "coverage",
                                   "ball_query_grouped", "group_pe_max", "knn_transfer",
                                   "gcn_stack"])
        require(bool(torch.isfinite(posed).all()), f"{label} posed forward: not finite")
        fwd = timed_path(f"{label} stage 1, posed forward (B={B})", forward, F)
        del model, posed
        state, step, _ = posed_state(assets, body, weights, dev, compute_dtype=dtype)
        # a bf16 stage 1 runs its SA stages unfused: no chain launch but the PE blocks'
        names = [k for k in POSED_TRAIN_KERNELS if not (dtype and k == "fused_chain")]
        losses, train_launches = counted(f"{label} stage 1, posed train step",
                                         lambda: step(state, batch), names)
        require(all(bool(torch.isfinite(v).all()) for v in losses.values()),
                f"{label} posed train step: non-finite losses")
        train = timed_path(f"{label} stage 1, posed train step (B={TRAIN_B})",
                           lambda: step(state, batch), TRAIN_F)
        out[label] = dict(forward=fwd, forward_launches=launches, train=train,
                          train_launches=train_launches)
        del state, step
        torch.cuda.empty_cache()
    return out


def posed_memory_phase(assets, body, weights) -> dict:
    """The posed train step at B=4 and B=8 from a fresh state: the peak
    device memory of its first step, in all and above the state and batch,
    and its device ms."""
    from garment4d_tpu_torch.data.synthetic import make_batch

    dev = torch.device("cuda")
    out = {}
    for batch_size in (TRAIN_B, B):
        batch = make_batch(assets, body, batch_size=batch_size, T=T, npoints=N, seed=1,
                           device=dev)
        state, step, _ = posed_state(assets, body, weights, dev)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        losses = step(state, batch)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        require(all(bool(torch.isfinite(v).all()) for v in losses.values()),
                f"posed train step B={batch_size}: non-finite losses")
        label = f"posed train step B={batch_size}"
        out[f"B{batch_size}"] = dict(
            peak_gib=peak / 2 ** 30, step_peak_gib=(peak - base) / 2 ** 30,
            **timed_path(label, lambda: step(state, batch), batch_size * T))
        print(f"{label}: peak device memory {peak / 2 ** 30:.3f} GiB "
              f"({(peak - base) / 2 ** 30:.3f} GiB above the state and batch)", flush=True)
        del state, step, losses, batch
        torch.cuda.empty_cache()
    return out


def debug_nans_phase(assets, body, weights) -> dict:
    """One posed train step (B=4) with the NaN tripwire and one without,
    from fresh states of the same weights: losses and gradients bitwise
    equal, the tripwire's overhead (wall ms a step, median); then one step
    with NAN_PARAMETER's first element set to NaN, which must raise
    FloatingPointError naming it."""
    from garment4d_tpu_torch.data.synthetic import make_batch

    dev = torch.device("cuda")
    batch = make_batch(assets, body, batch_size=TRAIN_B, T=T, npoints=N, seed=1, device=dev)
    runs = {}
    for wired in (False, True):
        state, step, wire = posed_state(assets, body, weights, dev, tripwire=wired)
        losses = step(state, batch)
        runs[wired] = dict(record=step_record(state, losses),
                           wall_ms=wall_s(lambda: step(state, batch), runs=3) * 1e3,
                           state=state, step=step, wire=wire)
    differ = records_equal(runs[False]["record"], runs[True]["record"])
    require(not differ, f"--debug_nans changed the step: {differ[:5]}")
    overhead = runs[True]["wall_ms"] - runs[False]["wall_ms"]
    print(f"--debug_nans: a clean posed train step bitwise the step without it; "
          f"{runs[True]['wall_ms']:.2f} ms against {runs[False]['wall_ms']:.2f} ms a step "
          f"(+{overhead:.2f} ms, {runs[True]['wire'].modules} modules watched)", flush=True)
    state, step = runs[True]["state"], runs[True]["step"]
    with torch.no_grad():
        dict(state.model.named_parameters())[NAN_PARAMETER].view(-1)[0] = float("nan")
    try:
        step(state, batch)
    except FloatingPointError as e:
        message = str(e)
    else:
        raise RuntimeError(f"chip_smoke: --debug_nans: no FloatingPointError with "
                           f"{NAN_PARAMETER} set to NaN")
    require(NAN_PARAMETER in message, f"--debug_nans raised without naming {NAN_PARAMETER}: "
            f"{message}")
    print(f"--debug_nans: {NAN_PARAMETER} set to NaN raised FloatingPointError: {message}",
          flush=True)
    runs[True]["wire"].close()
    return dict(wall_ms=runs[True]["wall_ms"], wall_ms_without=runs[False]["wall_ms"],
                overhead_ms=overhead, modules=runs[True]["wire"].modules, raised=message)


def flags_entry_point(root: Path, tree: dict) -> dict:
    """Each flag once through `train_temporal.main` on phase 7's tree, one
    epoch: --bf16 1 on the canonical stage (B=20), --remat 1 and
    --debug_nans 1 on the posed stage (B=4, --fix_PCA 1 from phase 7's
    canonical checkpoint); finite losses, the kernels of the path launched."""
    from garment4d_tpu_torch import train_temporal

    common = ["--config", tree["cfg"], "--smpl_model_dir", tree["smpl_dir"], "--T", str(T),
              "--lr", str(TRAIN_LR), "--epoch_num", "1"]
    posed = ["--GarmentPCALBS", "1", "--fix_PCA", "1", "--GarmentPCA_pretrain",
             str(root / "canonical" / "ckpt" / "model.ckpt"), "--batch_size", str(TRAIN_B)]
    runs = {"bf16": (["--GarmentPCA", "1", "--batch_size", str(CANON_B), "--bf16", "1"],
                     CANON_TRAIN_KERNELS),
            "remat": (posed + ["--remat", "1"], POSED_TRAIN_KERNELS),
            "debug_nans": (posed + ["--debug_nans", "1"], POSED_TRAIN_KERNELS)}
    out = {}
    for flag, (argv, names) in runs.items():
        t0 = time.perf_counter()
        hist, launches = counted(f"entry point --{flag} 1", lambda: train_temporal.main(
            common + argv + ["--output_dir", str(root / f"flag_{flag}")]), names)
        for split in ("train", "eval"):
            require(all(math.isfinite(v) for v in hist[0][split].values()),
                    f"entry point --{flag} 1: non-finite {split} losses {hist[0][split]}")
        out[flag] = dict(seconds=time.perf_counter() - t0, train=hist[0]["train"],
                         launches=launches)
        print(f"entry point --{flag} 1: one epoch {out[flag]['seconds']:.2f} s, "
              f"{hist[0]['train']}", flush=True)
    return out


def flags_phase(assets, body, weights, pcd, body_in, root: Path, tree: dict,
                res: Results) -> dict:
    """Phase 16: --bf16 (canonical forward and train step, posed paths
    with a bf16 stage 1), the posed train step's peak memory (what --remat
    is for in the JAX package), --debug_nans, and each flag through the
    entry point."""
    from garment4d_tpu_torch.train.convert import load_npz_subtree

    t0 = time.perf_counter()
    canonical_sd = load_npz_subtree(weights, "canonical")
    out = dict(bf16_canonical_forward=bf16_canonical_forward(assets, pcd, canonical_sd, res))
    torch.cuda.empty_cache()
    out["bf16_canonical_train"] = bf16_canonical_train_step(assets, body, canonical_sd)
    torch.cuda.empty_cache()
    out["bf16_posed"] = bf16_posed(assets, body, weights, pcd, body_in)
    torch.cuda.empty_cache()
    out["posed_memory"] = posed_memory_phase(assets, body, weights)
    torch.cuda.empty_cache()
    out["debug_nans"] = debug_nans_phase(assets, body, weights)
    torch.cuda.empty_cache()
    out["entry_point"] = flags_entry_point(root, tree)
    out["phase_s"] = time.perf_counter() - t0
    print(f"flags phase: {out['phase_s']:.1f} s", flush=True)
    return out


# ---- phase 17: the JAX package's shapes ------------------------------------------

# FPS cases (kind, frames, points, centers): more centers than points (SA1 at
# npoints 512; the garment encoder's 512 from the 128 and 384 points its
# selection keeps at npoints 512 and 1536), few points, every point equal,
# each point twice (the copies at i + N // 2), and frames past shared memory
# (the wide kernel)
JAX_FPS_CASES = (("random", 80, 512, 1024), ("random", 80, 128, 512), ("random", 80, 384, 512),
                 ("random", 4, 5, 12), ("all_equal", 2, 300, 1024), ("pairs", 80, 512, 1024),
                 ("random", 10, 20000, 1024), ("random", 10, 65536, 1024))
# points a frame of the canonical calls (B=1, T=10): SA1 and the garment
# encoder past N, only the garment encoder past N, past shared memory; the
# posed forward at the first
JAX_POINTS = (512, 1536, 20000)
# the entry point as the JAX package's synthetic run takes it
# (train_temporal.py's `--synthetic_data 1 --npoints 512`), two epochs of two
# steps a stage
JAX_ENTRY = ["--config", "cfgs/skirt.yaml", "--synthetic_data", "1", "--npoints", "512",
             "--batch_size", "2", "--T", "4", "--epoch_num", "2", "--lr", str(TRAIN_LR)]
# its posed stage's kernels: the synthetic 400-vertex body is under the
# 1024 rows from which the body query compacts its table, so the flat query
# serves it (as in the JAX package) and coverage and the grouped query stay idle
JAX_ENTRY_POSED_KERNELS = [k for k in POSED_TRAIN_KERNELS
                           if k not in ("coverage", "ball_query_grouped")]


def fps_instance(plan: dict) -> str:
    """The FPS kernel instance that `_fps_plan`'s plan launches."""
    if plan["wide"]:
        return "wide, distances in device memory"
    if plan["far"]:
        return "far-skipping, 8 a thread"
    return f"{'staged' if plan['staged'] else 'registers'}, {plan['ppt']} a thread"


@torch.inference_mode()
def jax_fps_cases(res: Results) -> list:
    """Each of JAX_FPS_CASES on a seeded cloud on the card: one call of
    `furthest_point_sample`, which must raise the `fps` counter by one (no
    shape goes to the plain version), bitwise `_fps_plain` on the same
    input, then timed (`kernel_ms`) beside its bound (`fps_ops`: every
    point each step) and the plain version. -> the rows."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.ops import pointcloud as pc

    gen = torch.Generator(device="cuda").manual_seed(17)
    rows = []
    for kind, Bf, Nf, npoint in JAX_FPS_CASES:
        xyz = torch.rand(Bf, Nf, 3, generator=gen, device="cuda")
        if kind == "all_equal":
            xyz.fill_(0.5)
        elif kind == "pairs":
            xyz[:, Nf // 2:] = xyz[:, :Nf // 2]
        case = f"{kind} ({Bf}, {Nf}) -> {npoint}"
        before = ops.launch_counts["fps"]
        got = ops.furthest_point_sample(xyz, npoint)
        launched = ops.launch_counts["fps"] - before
        require(launched == 1, f"fps {case}: {launched} kernel launches, 1 expected")
        require(torch.equal(got, pc._fps_plain(xyz, npoint)), f"fps {case}: differs from plain")
        instance = fps_instance(pc._fps_plan(Bf, Nf, npoint))
        res.record("fps", f"jax shapes {case}", 0, lambda: pc._fps_kernel(xyz, npoint),
                   lambda: pc._fps_plain(xyz, npoint), nbytes(xyz, got),
                   fps_ops(xyz, npoint, got), reps_k=10, reps_p=1, queued=True,
                   path="jax_shapes", launches=launched, instance=instance)
        rows.append(res.cases["fps"][-1])
        print(f"fps jax shapes {case} ({instance}): "
              f"{1e3 * rows[-1]['ms'] / max(npoint - 1, 1):.3f} us a step", flush=True)
    return rows


def check_chains(label: str, ccalls) -> int:
    """Each recorded chain launch (`recording(pemax, "_chain_kernel")`)
    within CHAIN_TOL of its plain version on its inputs; -> the count."""
    for i, (args, kwargs, out) in enumerate(ccalls):
        table, idx, centers, ws, bs, relus = args[:6]
        want = chain_plain(table, idx, centers, ws, bs, relus, kwargs.get("n_valid"))
        require(torch.allclose(out, want, **CHAIN_TOL),
                f"chain {label} launch {i} {args[6]} {tuple(idx.shape)}: max abs err "
                f"{max_abs(out, want)} beyond {CHAIN_TOL}")
    return len(ccalls)


def scaled_err(got, want) -> float:
    """The largest difference of two tensors over the larger of 1 and the
    reference's largest magnitude."""
    return float((got - want).abs().max()) / max(1.0, float(want.abs().max()))


def label_flips(label: str, logits, plain_logits) -> int:
    """The kernel path's labels against the card's plain path's: bitwise,
    but for points whose plain top-two logits lie within twice the paths'
    largest logit difference of each other (a near tie that fp32 order may
    flip), which are counted and printed; -> their count."""
    differ = logits.argmax(-1) != plain_logits.argmax(-1)
    if not bool(differ.any()):
        return 0
    top2 = plain_logits.topk(2, -1).values
    gap = (top2[..., 0] - top2[..., 1])[differ]
    slack = 2 * max_abs(logits, plain_logits)
    n = int(differ.sum())
    print(f"{label}: {n} labels differ from the plain path, top-two gaps "
          f"{gap.tolist()[:10]} (slack {slack:.3e})", flush=True)
    require(bool((gap <= slack).all()), f"{label}: {n} labels differ from the plain path, "
            f"not all at near ties (gaps {gap.tolist()[:10]}, slack {slack})")
    return n


@torch.inference_mode()
def jax_canonical(recon, assets, body, N: int, res: Results) -> dict:
    """`canonical` and `segment` on one sequence of T frames of N points
    (`make_batch`, seed N), counted (CANONICAL_KERNELS launched; every
    FPS launch counted, none sent to the plain version): each FPS, flat
    query and 3-NN case bitwise its plain version and timed, each row
    gather bitwise as it runs (`gather_keep`), each chain launch within
    CHAIN_TOL; the labels against the card's plain path (`label_flips`),
    and its outputs, fed the kernel path's labels, within FORCED_TOL of
    each tensor's scale (`scaled_err`; beside it each tensor's absolute
    error and scale, its largest magnitude, are printed and returned)."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.ops import pemax, pointcloud as pc

    label = f"jax shapes canonical N={N}"
    pcd = make_batch(assets, body, batch_size=1, T=T, npoints=N, seed=N, device="cuda")["pcd"]
    with recording(pc, "_fps_kernel") as fcalls, recording(pc, "_ball_query_kernel") as bcalls, \
            recording(pc, "_three_nn_kernel") as tcalls, \
            recording(pc, "_gather_rows_kernel", keep=gather_keep) as gcalls, \
            recording(pemax, "_chain_kernel") as ccalls:
        out, launches = counted(label, lambda: recon.run(pcd), CANONICAL_KERNELS)
    fps_shapes = [(a[0].shape[1], a[1]) for a, _, _ in fcalls]
    require(launches["fps"] == len(fcalls), f"{label}: FPS launches {launches['fps']} against "
            f"{len(fcalls)} calls of the kernel wrapper")
    past_n = [s for s in fps_shapes if s[1] > s[0]]
    require(bool(past_n) == (N < 2048), f"{label}: FPS calls past N {past_n}")
    check_fps(label, fcalls, res, path="jax_shapes")
    check_flat(label, bcalls, res, path="jax_shapes")
    check_three_nn(label, tcalls, res, path="jax_shapes")
    chains = check_chains(label, ccalls)
    gathers = len(gcalls)
    del fcalls[:], bcalls[:], tcalls[:], gcalls[:], ccalls[:]

    labels = out.backbone.sem_logits.argmax(-1)
    require(torch.equal(recon.segment(pcd), labels.reshape(1, T, N)),
            f"{label}: segment differs from the forward's labels")
    require(torch.equal(recon.canonical(pcd), out.tpose_garment),
            f"{label}: canonical differs from the forward's T-pose garment")
    with ops.plain_ops(), forced_labels(labels):
        plain = recon.run(pcd)
    flips = label_flips(label, out.backbone.sem_logits, plain.backbone.sem_logits)
    got, want = canonical_outputs(out), canonical_outputs(plain)
    errs = {k: scaled_err(got[k], want[k]) for k in got}
    abs_errs = {k: max_abs(got[k], want[k]) for k in got}
    scales = {k: float(want[k].abs().max()) for k in got}
    garment = float((labels == assets.label).float().mean())
    print(f"{label}: FPS {fps_shapes}, {chains} chain and {gathers} gather launches held; "
          f"garment label share {garment:.4f}; against the card's plain path on the same "
          f"labels (error over max(1, scale)): {errs}; absolute: {abs_errs}; scale: {scales}",
          flush=True)
    for k, e in errs.items():
        require(e <= FORCED_TOL, f"{label} {k}: {e} beyond {FORCED_TOL} of its scale")
        require(bool(torch.isfinite(got[k]).all()), f"{label} {k}: not finite")
    return dict(launches=launches, fps=fps_shapes, label_flips=flips, scaled_err=errs,
                abs_err=abs_errs, scale=scales, garment_share=garment, chain_launches=chains,
                gather_launches=gathers)


@torch.inference_mode()
def jax_posed(recon, assets, body, res: Results) -> dict:
    """The posed forward on one sequence of T frames of JAX_POINTS[0]
    points: counted (FORWARD_KERNELS launched), its flat queries bitwise
    their plain versions and timed, its row gathers bitwise as they run;
    each refinement iteration run again by the card's plain path on the
    kernel path's own inputs, offsets and hidden features within
    FORCED_TOL (phase 4's teacher-forced gate)."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.ops import pointcloud as pc
    from garment4d_tpu_torch.train.step import body_inputs_from_batch

    N0 = JAX_POINTS[0]
    label = f"jax shapes posed N={N0}"
    batch = make_batch(assets, body, batch_size=1, T=T, npoints=N0, seed=N0, device="cuda")
    body_in = body_inputs_from_batch(batch)
    with recording(recon.model, "refine") as steps, \
            recording(pc, "_ball_query_kernel") as bcalls, \
            recording(pc, "_gather_rows_kernel", keep=gather_keep) as gcalls:
        out, launches = counted(label, lambda: recon.posed(batch["pcd"], body_in,
                                                           return_all=True), FORWARD_KERNELS)
    check_flat(label, bcalls, res, path="jax_shapes")
    gathers = len(gcalls)
    del bcalls[:], gcalls[:]
    forced = []
    for args, _, (h, hid) in steps:
        with ops.plain_ops():
            h_p, hid_p = recon.model.refine(*args[:9])
        forced.append(dict(iteration=args[0], max_abs=max_abs(h, h_p),
                           hidden_max_abs=max_abs(hid, hid_p)))
        print(f"{label} teacher-forced iteration {args[0]} on the card's plain path: "
              f"offsets max abs diff {forced[-1]['max_abs']:.3e}, hidden "
              f"{forced[-1]['hidden_max_abs']:.3e}", flush=True)
        for key in ("max_abs", "hidden_max_abs"):
            require(forced[-1][key] <= FORCED_TOL,
                    f"{label} iteration {args[0]}: {key} {forced[-1][key]} > {FORCED_TOL}")
    require(len(forced) == 3, f"{label}: {len(forced)} refinement iterations")
    require(all(bool(torch.isfinite(v).all()) for v in out.iter_garment_v),
            f"{label}: non-finite posed garment")
    return dict(launches=launches, forced=forced, gather_launches=gathers)


def jax_entry_point(root: Path) -> dict:
    """`train_temporal.main` with JAX_ENTRY, the canonical stage, then the
    posed stage from its checkpoint, on the card: counted (the kernels of
    phases 6 and 5's steps launched, JAX_ENTRY_POSED_KERNELS of the posed
    stage's), FPS launched past N (SA1's 1024 centers
    of 512 points; none sent to the plain version), losses finite in every
    epoch and moved between the two."""
    from garment4d_tpu_torch import train_temporal
    from garment4d_tpu_torch.ops import pointcloud as pc

    runs = {"canonical": (["--GarmentPCA", "1"], CANON_TRAIN_KERNELS),
            "posed": (["--GarmentPCALBS", "1", "--GarmentPCA_pretrain",
                       str(root / "canonical" / "ckpt" / "model.ckpt")],
                      JAX_ENTRY_POSED_KERNELS)}
    out = {}
    for stage, (argv, names) in runs.items():
        label = f"jax shapes entry point --npoints 512 {stage}"
        t0 = time.perf_counter()
        with recording(pc, "_fps_kernel", keep=lambda a, _kw, _r: (a[0].shape[1], a[1])) as fc:
            hist, launches = counted(label, lambda: train_temporal.main(
                JAX_ENTRY + argv + ["--output_dir", str(root / stage)]), names)
        past_n = sum(npoint > n for n, npoint in fc)
        require(past_n > 0 and launches["fps"] == len(fc),
                f"{label}: {past_n} FPS launches past N of {launches['fps']} ({len(fc)} calls)")
        for epoch in hist:
            for split in ("train", "eval"):
                require(all(math.isfinite(v) for v in epoch[split].values()),
                        f"{label}: non-finite {split} losses {epoch[split]}")
        train = [epoch["train"] for epoch in hist]
        require(len(train) == 2 and train[1] != train[0], f"{label}: losses {train}")
        out[stage] = dict(seconds=time.perf_counter() - t0, train=train, launches=launches,
                          fps_past_n=past_n)
        print(f"{label}: {out[stage]['seconds']:.2f} s, train losses {train}", flush=True)
    return out


def jax_shapes_phase(recon, assets, body, root: Path, res: Results) -> dict:
    """Phase 17: the FPS kernel at JAX_FPS_CASES, `canonical` / `segment`
    at JAX_POINTS, the posed forward at JAX_POINTS[0] and the entry point
    at `--npoints 512` (`jax_fps_cases`, `jax_canonical`, `jax_posed`,
    `jax_entry_point`)."""
    t0 = time.perf_counter()
    out = dict(fps=jax_fps_cases(res))
    for N in JAX_POINTS:
        torch.cuda.empty_cache()
        out[f"canonical_{N}"] = jax_canonical(recon, assets, body, N, res)
    out["posed"] = jax_posed(recon, assets, body, res)
    torch.cuda.empty_cache()
    out["entry_point"] = jax_entry_point(root / "jax_shapes")
    out["phase_s"] = time.perf_counter() - t0
    print(f"jax shapes phase: {out['phase_s']:.1f} s", flush=True)
    return out


@torch.inference_mode()
def teacher_forced_forward(steps, recon_cpu, label=""):
    """Each recorded refinement iteration of a posed forward on the card
    (`recording(model, "refine")`), run by the CPU plain path on the card's
    own inputs for sequence 0 (same centers: no boundary flips): its vertex
    offsets and hidden features held to FORCED_TOL everywhere. -> rows."""
    forced = []
    for args, _, (h_gpu, hid_gpu) in steps:
        it, cur, hidden, g_xyz, g_feat, b_v, b_vn = args[:7]

        def seq0(t):
            return None if t is None else t[:T].cpu()

        h_cpu, hid_cpu = recon_cpu.model.refine(
            it, seq0(cur), seq0(hidden), [seq0(t) for t in g_xyz],
            [seq0(t) for t in g_feat], seq0(b_v), seq0(b_vn), 1, T)
        diff = (h_cpu - h_gpu[:T].cpu()).abs().amax(-1)
        forced.append(dict(iteration=it, within_1e3=(diff <= 1e-3).float().mean().item(),
                           max_abs=diff.max().item(),
                           hidden_max_abs=(hid_cpu - hid_gpu[:T].cpu()).abs().max().item()))
        print(f"{label}teacher-forced iteration {it}: offsets within 1e-3 "
              f"{forced[-1]['within_1e3']:.6f}, max abs diff {forced[-1]['max_abs']:.3e}, "
              f"hidden max abs diff {forced[-1]['hidden_max_abs']:.3e}", flush=True)
        for key in ("max_abs", "hidden_max_abs"):
            require(forced[-1][key] <= FORCED_TOL,
                    f"{label}teacher-forced iteration {it}: {key} {forced[-1][key]} "
                    f"> {FORCED_TOL}")
    return forced


def counted(label, fn, names):
    """Run the main path `fn` once with the launch counters at 0 before it;
    require each kernel in `names` to have launched."""
    from garment4d_tpu_torch import ops

    ops.reset_counts()
    out = fn()
    torch.cuda.synchronize()
    launches = dict(ops.launch_counts)
    print(f"{label} main-path launches: {launches}", flush=True)
    for name in names:
        require(launches.get(name, 0) > 0, f"kernel {name} did not launch on the {label} path")
    return out, launches


# device kernel names (torch.profiler) of the redesigned kernels in either
# checkout of an A/B run: the PE backward's per-block pass and ordered sum,
# the scatter-add's single tiled kernel (the earlier design) or its sort and
# segmented sum, the chain kernel, the GCN layer kernels, the K-NN transfer,
# the grouped ball query (the flat query's 3-radius instance in the earlier
# design, its own kernel since), the flat ball query, FPS (one kernel in
# the earlier design; the register kernel and the kernel that skips far
# warps since), the coverage mask, the 1-NN (one scan kernel in the earlier
# design; its pre-pass and query kernel since), the row gather, the banded
# product
AB_KERNEL_NAMES = {"pe_bwd": ("pe_bwd",),
                   "scatter_add": ("scatter_add_kernel", "scatter_sort_kernel",
                                   "segment_sum_kernel"),
                   "fused_chain": ("fused_chain",),
                   "gcn_stack": ("gcn_",),
                   "knn_transfer": ("knn_transfer",),
                   "ball_query_grouped": ("ball_query_kernel<3>", "ball_query_grouped"),
                   "ball_query": ("ball_query_kernel<1>", "ball_query_kernel<2>",
                                  "ball_query_flat_kernel", "ball_query_lane_kernel",
                                  "flat_sort_kernel"),
                   "three_nn": ("three_nn_kernel", "three_nn_sort_kernel"),
                   "fps": ("fps_kernel", "fps_far_kernel"),
                   "coverage": ("coverage_kernel",),
                   "nn1": ("nn1_kernel", "nn1_nearest_kernel", "nn1_sort_kernel"),
                   "gather_rows": ("gather_rows_kernel",),
                   "banded": ("banded_kernel",)}


# the kernels whose device ms per posed forward and per posed train step
# `--time-kernels` reports
TIMED_KERNELS = ("fused_chain", "gcn_stack", "knn_transfer", "ball_query_grouped", "ball_query",
                 "three_nn", "fps", "coverage", "nn1", "gather_rows", "banded")


def device_ms_of(rows, names) -> float:
    """Device ms per call of the profiler rows whose kernel name holds one
    of `names`."""
    return sum(ms for ms, _, name in rows if any(n in name for n in names))


def ptxas_lines(names) -> list:
    """The build log's ptxas lines (entry, registers, spills) of the kernels
    whose mangled names hold one of `names`."""
    from garment4d_tpu_torch.ops import _build

    lines, keep = [], False
    for line in _build.build_log().splitlines():
        if "Compiling entry" in line:
            keep = any(n in line for n in names)
        if keep and ("Compiling entry" in line or "registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


@torch.inference_mode()
def time_chain_gcn(recon, pcd, body_in) -> dict:
    """The chain and GCN-stack launches of one posed forward at each
    distinct shape, on their recorded inputs: ms (CUDA events, mean of 20)
    and the largest difference to the float64 version; for the chain also
    one 4-wide linear layer on the same gathers (mostly the gather's time),
    for the stack its plain version (mean of 5); the summed bounds and the
    kernels' ms summed over the forward's launches."""
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.ops import graph, pemax

    ccalls, gcalls = record_chain_gcn(recon, pcd, body_in)
    chains, stacks = chain_launches(ccalls), gcn_launches(gcalls)
    del ccalls, gcalls
    out = dict(chain=[], gcn=[], chain_bound_ms_sum=sum(r["bound_ms"] for r in chains),
               gcn_bound_ms_sum=sum(r["bound_ms"] for r in stacks))
    for case, (row, count) in by_case(chains).items():
        args, kwargs = row["args"], row["kwargs"]
        table, idx, centers, ws, bs, relus, name = args[:7]
        w4 = torch.zeros(table.shape[-1], 4, device=table.device)
        b4 = torch.zeros(4, device=table.device)
        err64 = max_abs(pemax._chain_kernel(*args, **kwargs),
                        chain_float64(table, idx, centers, ws, bs, relus))
        out["chain"].append(dict(
            case=case, launches=count, bound_ms=row["bound_ms"], err_float64=err64,
            ms=cuda_ms(lambda: pemax._chain_kernel(*args, **kwargs), 20),
            gather_ms=cuda_ms(lambda: pemax._chain_kernel(table, idx, centers, [w4], [b4],
                                                           (False,), name), 20)))
    for case, (row, count) in by_case(stacks).items():
        xs, ws, bs, vals, offsets, relus, hidden_layer = args = row["args"]
        adj = band_matrix(vals, offsets)

        def plain():
            with ops.plain_ops():
                return graph._gcn_stack_ref(xs, ws, bs, adj, offsets, relus, hidden_layer)

        err64 = max(max_abs(a, b) for a, b in zip(graph._gcn_stack_kernel(*args),
                                                  gcn_float64(*args)))
        out["gcn"].append(dict(
            case=case, stacks=count, launches=4 * count, bound_ms=row["bound_ms"],
            err_float64=err64, ms=cuda_ms(lambda: graph._gcn_stack_kernel(*args), 20),
            plain_ms=cuda_ms(plain, 5)))
    out["chain_ms_sum"] = sum(c["ms"] * c["launches"] for c in out["chain"])
    out["gcn_ms_sum"] = sum(c["ms"] * c["stacks"] for c in out["gcn"])
    return out


@torch.inference_mode()
def time_knn(label, args) -> dict:
    """The K-NN transfer on one recorded call's inputs: ms (CUDA events,
    mean of 20), the largest difference to the float64 transfer over the
    kernel's own selections, the bound."""
    from garment4d_tpu_torch.models import skinning

    garment, body, w0, k, k64 = (a.contiguous() if torch.is_tensor(a) else a for a in args)
    outs = skinning._knn_transfer_kernel(garment, body, w0, k, k64)
    err64 = knn_float64_err(garment, body, w0, k, k64, outs[:2])[0]
    (Bk, Vg, _), Nb, J = garment.shape, body.shape[1], w0.shape[-1]
    return dict(case=f"{label} ({Bk}, {Vg}) vs {Nb}, K={k}, K64={k64}, J={J}", err_float64=err64,
                ms=cuda_ms(lambda: skinning._knn_transfer_kernel(garment, body, w0, k, k64), 20),
                bound_ms=bound(nbytes(garment, body, w0, *outs),
                               10.0 * Bk * Vg * Nb + 2.0 * Bk * Vg * (k + k64) * J)[0])


@torch.inference_mode()
def time_grouped(gcalls) -> dict:
    """The grouped ball-query launches of one posed forward on their
    recorded inputs (CUDA events, mean of 20), their sum and summed
    bounds."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    grouped = query_launches(gcalls, True)
    out = dict(ball_query_grouped=[dict(
        case=f"launch {i}: {row['case']}", bound_ms=row["bound_ms"],
        ms=cuda_ms(lambda: pc._ball_query_grouped_kernel(*row["args"]), 20))
        for i, row in enumerate(grouped)])
    out["ball_query_grouped_bound_ms_sum"] = sum(r["bound_ms"] for r in grouped)
    out["ball_query_grouped_ms_sum"] = sum(c["ms"] for c in out["ball_query_grouped"])
    return out


@torch.inference_mode()
def time_flat(label, bcalls, bounds: bool) -> list:
    """Each distinct flat ball-query case of a path's recorded launches: ms
    (mean of 20 launches queued behind a sleeping kernel, `kernel_ms`), the
    wrapper calls of the case and, with `bounds` (this checkout's launch
    plans), its bounds (`query_launches`)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    out = []
    calls = [dict(case=query_case(a), call=(a, kw, r)) for a, kw, r in bcalls]
    for case, (first, count) in by_case(calls).items():
        args = first["call"][0]
        row = dict(case=f"{label} {case}", calls=count,
                   ms=kernel_ms(lambda: pc._ball_query_kernel(*args), 20))
        if bounds:
            b = query_launches([first["call"]], False)[0]
            row.update(bound_ms=b["bound_ms"], scan_bound_ms=b["scan_bound_ms"])
        out.append(row)
    return out


@torch.inference_mode()
def time_three_nn(label, tcalls, bounds: bool) -> list:
    """Each distinct 3-NN case of a path's recorded launches: ms (as
    `time_flat`), its launches, `cdist_top3`'s ms (CUDA events, mean of 5)
    and, with `bounds`, its bounds (`three_nn_launches`)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    out = []
    calls = [dict(case=f"({a[0].shape[0]}, {a[0].shape[1]}) vs {a[1].shape[1]}", call=(a, kw, r))
             for a, kw, r in tcalls]
    for case, (first, count) in by_case(calls).items():
        unknown, known = first["call"][0]
        row = dict(case=f"{label} {case}", calls=count,
                   ms=kernel_ms(lambda: pc._three_nn_kernel(unknown, known), 20),
                   library_ms=cuda_ms(lambda: cdist_top3(unknown, known), 5))
        if bounds:
            b = three_nn_launches([first["call"]])[0]
            row.update(bound_ms=b["bound_ms"], scan_bound_ms=b["scan_bound_ms"])
        out.append(row)
    return out


@torch.inference_mode()
def time_nn1(label, calls, bounds: bool) -> list:
    """Each distinct 1-NN case of a path's recorded launches: ms (as
    `time_flat`), its launches, `cdist_min`'s ms (CUDA events, mean of 5)
    and, with `bounds` (this checkout's plans), its bounds
    (`nn1_launches`)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    out = []
    rows = [dict(case=f"({a[0].shape[0]}, {a[0].shape[1]}) vs {a[1].shape[1]}", call=(a, kw, r))
            for a, kw, r in calls]
    for case, (first, count) in by_case(rows).items():
        query, points = first["call"][0]
        row = dict(case=f"{label} {case}", calls=count,
                   ms=kernel_ms(lambda: pc._nn1_kernel(query, points), 20),
                   library_ms=cuda_ms(lambda: cdist_min(query, points), 5))
        if bounds:
            b = nn1_launches([first["call"]])[0]
            row.update(bound_ms=b["bound_ms"], scan_bound_ms=b["scan_bound_ms"])
        out.append(row)
    return out


@torch.inference_mode()
def time_gathers(label, calls) -> list:
    """Each distinct row-gather case of a path's recorded launches
    (`gather_args` rows): ms (as `time_flat`), its launches, its bound
    (bytes) and one `index_select` on the flattened table (CUDA events,
    mean of 5)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    out = []
    for case, (first, count) in by_case(calls).items():
        table, idx = first["args"]
        out.append(dict(case=f"{label} {case}", calls=count, bound_ms=first["bound_ms"],
                        ms=kernel_ms(lambda: pc._gather_rows_kernel(table, idx), 20),
                        library_ms=cuda_ms(index_select_of(table, idx), 5)))
    return out


def case_sums(rows, prefix, key) -> dict:
    """The sums over a path's launches (a row's `calls` each) of the rows'
    ms and, where present, their bounds: {f"{key}_ms_sum": ...}."""
    mine = [r for r in rows if r["case"].startswith(prefix)]
    out = {f"{key}_ms_sum": sum(r["ms"] * r["calls"] for r in mine)}
    for b in ("bound_ms", "scan_bound_ms"):
        if mine and b in mine[0]:
            out[f"{key}_{b}_sum"] = sum(r[b] * r["calls"] for r in mine)
    return out


@torch.inference_mode()
def time_fps(label, fcalls, bounds: bool) -> list:
    """Each distinct FPS case of a path's recorded launches: ms (mean of 10
    calls queued behind a sleeping kernel, `kernel_ms`), the launches of the
    case and, with `bounds` (this checkout's launch plan), the bounds
    (`fps_launches`)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    out = []
    calls = [dict(case=f"({a[0].shape[0]}, {a[0].shape[1]}) -> {a[1]}", call=(a, kw, r))
             for a, kw, r in fcalls]
    for case, (first, count) in by_case(calls).items():
        args = first["call"][0]
        row = dict(case=f"{label} {case}", launches=count,
                   ms=kernel_ms(lambda: pc._fps_kernel(*args), 10))
        if bounds:
            b = fps_launches([first["call"]])[0]
            row.update(bound_ms=b["bound_ms"], scan_bound_ms=b["scan_bound_ms"])
        out.append(row)
    return out


@torch.inference_mode()
def time_coverage(ccalls, bounds: bool) -> list:
    """Each coverage launch of one posed forward on its recorded inputs: ms
    (CUDA events, mean of 20) and, with `bounds` (this checkout's launch
    plan), its bounds (`coverage_launches`)."""
    from garment4d_tpu_torch.ops import pointcloud as pc

    out = []
    for i, call in enumerate(ccalls):
        xyz, centers, r = call[0]
        row = dict(case=f"launch {i}: body ({xyz.shape[0]}, {xyz.shape[1]}) x "
                   f"{centers.shape[1]} centers, r {r}",
                   ms=cuda_ms(lambda: pc._covered_mask_kernel(xyz, centers, r), 20))
        if bounds:
            b = coverage_launches([call])[0]
            row.update(bound_ms=b["bound_ms"], scan_bound_ms=b["scan_bound_ms"])
        out.append(row)
    return out


def time_kernels(root: Path) -> int:
    """The redesigned kernels and the paths that run them, for the package
    in the checkout at `root`: the posed forward (median of 10 after 2
    warm-ups, profiled: device ms, the chain's and the GCN's share), the
    canonical forward's device ms, the chain and GCN launches of the posed
    forward (`time_chain_gcn`); the posed train step (B=4) and the canonical train step
    (B=20) at phases 5 and 6's shapes, each median of 5 steps after 2
    warm-ups and profiled once (device ms, and the kernel's share); the PE
    backward at each of its shapes in the posed step and its dtable half
    with that half's scatter-add, and the scatter-add at each of its shapes
    in the canonical step beside one `index_add_`, on inputs recorded from
    the steps (CUDA events); each coverage launch of the posed forward
    (CUDA events) and each distinct FPS case of the posed forward and both
    train steps and phase 17's frames past shared memory (`time_fps`), and
    the canonical train step's FPS device ms;
    each distinct 1-NN case of the posed train step and the canonical train
    and eval steps (`time_nn1`). One JSON line."""
    root = root.resolve()
    sys.path.insert(0, str(root))
    import garment4d_tpu_torch
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.models import CanonicalGarmentModel, GarmentAssets, skinning
    from garment4d_tpu_torch.ops import _build, pemax, pointcloud as pc
    from garment4d_tpu_torch.smpl import synthetic_smpl
    from garment4d_tpu_torch.train import (load_npz_subtree, make_canonical_steps,
                                           make_posed_steps, make_state_for)
    from garment4d_tpu_torch.train.step import body_inputs_from_batch

    require(Path(garment4d_tpu_torch.__file__).resolve().is_relative_to(root),
            f"the package was not imported from {root}")
    own = root == REPO  # this checkout: its launch plans give the data's bounds
    dev = torch.device("cuda")
    weights = str(root / "ckpt_synth" / "posed_synth.npz")
    assets = GarmentAssets.synthetic(num_rings=RINGS, ring_size=RING_SIZE)
    body = synthetic_smpl(num_verts=N, device=dev)
    out = {"root": str(root)}

    batch = make_batch(assets, body, batch_size=B, T=T, npoints=N, device=dev)
    pcd, body_in = batch["pcd"], body_inputs_from_batch(batch)
    recon = GarmentReconstructor.from_npz(assets, body, weights, device=dev)
    step_s = wall_s(lambda: recon.posed(pcd, body_in), runs=10, warmup=2)
    rows, dev_ms = profile_device(lambda: recon.posed(pcd, body_in), runs=2)
    names = sum((AB_KERNEL_NAMES[k] for k in TIMED_KERNELS), ())
    out.update(posed_frames_per_sec=F / step_s, posed_device_ms=dev_ms,
               posed_launches=sum(r[1] for r in rows),
               chain_device_ms_per_forward=device_ms_of(rows, AB_KERNEL_NAMES["fused_chain"]),
               gcn_device_ms_per_forward=device_ms_of(rows, AB_KERNEL_NAMES["gcn_stack"]),
               posed_device_ms_by_kernel={k: device_ms_of(rows, AB_KERNEL_NAMES[k])
                                          for k in TIMED_KERNELS},
               posed_kernel_rows=[(ms, n, name[:90]) for ms, n, name in rows
                                  if any(k in name for k in names)])
    rows, out["canonical_device_ms"] = profile_device(lambda: recon.canonical(pcd), runs=2)
    out["canonical_launches"] = sum(r[1] for r in rows)
    out.update(time_chain_gcn(recon, pcd, body_in))
    with recording(skinning, "knn_transfer") as kcalls, \
            recording(pc, "_ball_query_kernel") as bcalls, \
            recording(pc, "_ball_query_grouped_kernel") as gcalls, \
            recording(pc, "_three_nn_kernel") as tcalls, \
            recording(pc, "_fps_kernel") as fcalls, \
            recording(pc, "_covered_mask_kernel") as ccalls, \
            recording(pc, "_gather_rows_kernel", keep=gather_args) as rcalls:
        recon.posed(pcd, body_in)
    torch.cuda.synchronize()
    out["gather_rows"] = time_gathers("posed forward", rcalls)
    out.update(case_sums(out["gather_rows"], "posed forward", "gather_posed"))
    out.update(time_grouped(gcalls))
    out["ball_query"] = time_flat("posed forward", bcalls, own)
    out["three_nn"] = time_three_nn("posed forward", tcalls, own)
    out.update(case_sums(out["ball_query"], "posed forward", "ball_query"))
    out.update(case_sums(out["three_nn"], "posed forward", "three_nn"))
    out["knn"] = [time_knn("posed forward", kcalls[0][0])]
    out["fps"] = time_fps("posed forward", fcalls, own)
    # phase 17's frames past shared memory (the wide instance), on seeded clouds
    gen = torch.Generator(device="cuda").manual_seed(17)
    wide = []
    for _, Bf, Nf, npoint in JAX_FPS_CASES:
        if 16 * Nf > _build.SMEM_LIMIT:
            xyz = torch.rand(Bf, Nf, 3, generator=gen, device="cuda")
            wide.append(((xyz, npoint), {}, pc._fps_kernel(xyz, npoint)))
    out["fps"] += time_fps("jax shapes", wide, own)
    del wide
    out["coverage"] = time_coverage(ccalls, own)
    out["coverage_ms_sum"] = sum(c["ms"] for c in out["coverage"])
    if own:
        out["coverage_bound_ms_sum"] = sum(c["bound_ms"] for c in out["coverage"])
        out["coverage_scan_bound_ms_sum"] = sum(c["scan_bound_ms"] for c in out["coverage"])
    del kcalls, bcalls, gcalls, tcalls, fcalls, ccalls, rcalls
    out["ptxas"] = ptxas_lines(("fused_chain", "gcn_", "knn_transfer", "ball_query", "fps_",
                                "coverage_kernel", "three_nn", "flat_sort"))
    del recon, batch, pcd, body_in
    torch.cuda.empty_cache()

    batch = make_batch(assets, body, batch_size=TRAIN_B, T=T, npoints=N, seed=1, device=dev)
    model = GarmentReconstructor.from_npz(assets, body, weights, device=dev).model
    state = make_state_for(model, lr=TRAIN_LR, freeze_canonical=True)
    train_step, _ = make_posed_steps(model, assets, body.faces)
    with recording(pemax, "_pe_bwd_kernel") as calls, \
            recording(skinning, "knn_transfer") as kcalls, \
            recording(pc, "_fps_kernel") as fcalls, \
            recording(pc, "_ball_query_kernel") as bcalls, \
            recording(pc, "_three_nn_kernel") as tcalls, \
            recording(pc, "_nn1_kernel") as ncalls, \
            recording(pc, "_gather_rows_kernel", keep=gather_args) as rcalls:
        train_step(state, batch)
    step_s = wall_s(lambda: train_step(state, batch), runs=5, warmup=2)
    rows, dev_ms = profile_device(lambda: train_step(state, batch), runs=1)
    out.update(posed_train_frames_per_sec=TRAIN_F / step_s, posed_train_device_ms=dev_ms,
               posed_train_launches=sum(r[1] for r in rows),
               pe_bwd_device_ms_per_step=device_ms_of(rows, AB_KERNEL_NAMES["pe_bwd"]),
               nn1_sort_device_ms_per_step=device_ms_of(rows, ("nn1_sort_kernel",)),
               posed_train_device_ms_by_kernel={k: device_ms_of(rows, AB_KERNEL_NAMES[k])
                                                for k in TIMED_KERNELS})
    out["knn"].append(time_knn("posed train step", kcalls[0][0]))
    out["fps"] += time_fps("posed train step", fcalls, own)
    out["ball_query"] += time_flat("posed train step", bcalls, own)
    out["three_nn"] += time_three_nn("posed train step", tcalls, own)
    out["nn1"] = time_nn1("posed train step", ncalls, own)
    out.update(case_sums(out["nn1"], "posed train step", "nn1"))
    out["gather_rows"] += time_gathers("posed train step", rcalls)
    out.update(case_sums(out["gather_rows"], "posed train step", "gather_posed_train"))
    del kcalls, fcalls, bcalls, tcalls, ncalls, rcalls
    shapes = {}
    for a, _, _ in calls:
        shapes.setdefault((a[0].shape[2], a[1].shape[2]), a[:7])
    del calls[:], state, model, batch
    with torch.no_grad():
        out["pe_bwd"] = [dict(case=f"C={C} S={S}",
                              ms=cuda_ms(lambda: pemax._pe_bwd_kernel(*args), 20))
                         for (C, S), args in sorted(shapes.items())]
        args = shapes[(67, 32)]
        out["pe_bwd_dtable_ms"] = cuda_ms(
            lambda: pemax._pe_bwd_kernel(*args, table_grad=True), 10)
        with recording(pemax, "_scatter_add_rows_kernel") as calls:
            pemax._pe_bwd_kernel(*args, table_grad=True)
        (dqg, idx, n), _, _ = calls[0]
        out["dtable_scatter_ms"] = cuda_ms(lambda: pc._scatter_add_rows_kernel(dqg, idx, n), 10)
    out["padded_tie"] = padded_tie_errors(pemax)
    del shapes, args, calls, dqg, idx
    torch.cuda.empty_cache()

    batch = make_batch(assets, body, batch_size=CANON_B, T=T, npoints=N, seed=1, device=dev)
    model = CanonicalGarmentModel(assets).to(dev)
    model.load_state_dict(load_npz_subtree(weights, "canonical"), strict=True)
    state = make_state_for(model, lr=TRAIN_LR)
    train_step, eval_step = make_canonical_steps(model, assets, body.faces)

    def step():
        return train_step(state, batch, torch.Generator(device=dev).manual_seed(1))

    with recording(pc, "_scatter_add_rows_kernel") as calls, \
            recording(pc, "_fps_kernel") as fcalls, \
            recording(pc, "_ball_query_kernel") as bcalls, \
            recording(pc, "_three_nn_kernel") as tcalls, \
            recording(pc, "_nn1_kernel") as ncalls, \
            recording(pc, "_gather_rows_kernel", keep=gather_args) as rcalls:
        step()
    valid = (torch.arange(CANON_B, device=dev) < CANON_B - 2).float()
    with recording(pc, "_nn1_kernel") as ecalls:
        eval_step(state, dict(batch, valid_mask=valid))
    step_s = wall_s(step, runs=5, warmup=2)
    rows, dev_ms = profile_device(step, runs=1)
    out.update(canonical_train_frames_per_sec=CANON_F / step_s,
               canonical_train_device_ms=dev_ms,
               canonical_train_launches=sum(r[1] for r in rows),
               scatter_add_device_ms_per_step=device_ms_of(
                   rows, AB_KERNEL_NAMES["scatter_add"]),
               canonical_train_fps_device_ms=device_ms_of(rows, AB_KERNEL_NAMES["fps"]),
               canonical_train_device_ms_by_kernel={k: device_ms_of(rows, AB_KERNEL_NAMES[k])
                                                    for k in TIMED_KERNELS})
    out["fps"] += time_fps("canonical train step", fcalls, own)
    out["ball_query"] += time_flat("canonical train step", bcalls, own)
    out["three_nn"] += time_three_nn("canonical train step", tcalls, own)
    out["nn1"] += time_nn1("canonical train step", ncalls, own)
    out["nn1"] += time_nn1("canonical eval step", ecalls, own)
    out["gather_rows"] += time_gathers("canonical train step", rcalls)
    out.update(case_sums(out["gather_rows"], "canonical train step", "gather_canonical_train"))
    del fcalls, bcalls, tcalls, ncalls, ecalls, rcalls
    out["scatter_add"] = []
    torch.set_grad_enabled(False)
    for (grads, idx, n, *wrap), _, _ in calls:
        Bs, R, C = grads.shape
        flat = (idx.long() + n * torch.arange(Bs, device=dev)[:, None]).reshape(-1)
        lib_out = torch.zeros(Bs * n, C, device=dev)
        out["scatter_add"].append(dict(
            case=f"({Bs}, {R}, {C}) into {n} rows",
            ms=cuda_ms(lambda: pc._scatter_add_rows_kernel(grads, idx, n, *wrap), 10),
            library_ms=cuda_ms(lambda: lib_out.index_add_(0, flat, grads.reshape(-1, C)), 10)))
        del lib_out, flat
    print(json.dumps(out), flush=True)
    return 0


def ab(parent: Path) -> int:
    """The parent checkout at `parent` against this one on one card, in
    turns (parent, change, change, parent), each a `--time-kernels` process;
    every reading of both, then the means per case and path, one JSON line,
    then the card line."""
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    runs = []
    for label, root in (("parent", parent), ("change", REPO), ("change", REPO),
                        ("parent", parent)):
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--time-kernels", str(root)],
                              capture_output=True, text=True, timeout=900)
        require(proc.returncode == 0, f"--time-kernels {root} failed:\n"
                + proc.stdout[-3000:] + proc.stderr[-3000:])
        runs.append((label, json.loads(proc.stdout.strip().splitlines()[-1])))
        print(f"{label}: {json.dumps(runs[-1][1])}", flush=True)

    def mean(label, get):
        vals = [get(r) for lab, r in runs if lab == label]
        return sum(vals) / len(vals)

    summary = {}
    for key in ("posed_frames_per_sec", "posed_device_ms", "chain_device_ms_per_forward",
                "gcn_device_ms_per_forward", "chain_ms_sum", "gcn_ms_sum",
                "canonical_device_ms", "posed_train_frames_per_sec",
                "posed_train_device_ms", "pe_bwd_device_ms_per_step",
                "nn1_sort_device_ms_per_step",
                "canonical_train_frames_per_sec", "canonical_train_device_ms",
                "scatter_add_device_ms_per_step", "pe_bwd_dtable_ms", "dtable_scatter_ms",
                "posed_launches", "canonical_launches", "posed_train_launches",
                "canonical_train_launches"):
        summary[key] = {lab: mean(lab, lambda r: r[key]) for lab in ("parent", "change")}
    for path in ("posed", "posed_train", "canonical_train"):
        for k in TIMED_KERNELS:
            summary[f"{path} {k} device_ms"] = {
                lab: mean(lab, lambda r: r[f"{path}_device_ms_by_kernel"][k])
                for lab in ("parent", "change")}
    for key in ("ball_query_grouped_ms_sum", "ball_query_ms_sum", "three_nn_ms_sum",
                "coverage_ms_sum", "canonical_train_fps_device_ms", "nn1_ms_sum",
                "gather_posed_ms_sum", "gather_posed_train_ms_sum",
                "gather_canonical_train_ms_sum"):
        summary[key] = {lab: mean(lab, lambda r: r[key]) for lab in ("parent", "change")}
    for key in ("chain_bound_ms_sum", "gcn_bound_ms_sum", "ball_query_grouped_bound_ms_sum",
                "ball_query_bound_ms_sum", "ball_query_scan_bound_ms_sum",
                "three_nn_bound_ms_sum", "three_nn_scan_bound_ms_sum", "coverage_bound_ms_sum",
                "coverage_scan_bound_ms_sum", "nn1_bound_ms_sum", "nn1_scan_bound_ms_sum",
                "gather_posed_bound_ms_sum", "gather_posed_train_bound_ms_sum",
                "gather_canonical_train_bound_ms_sum"):
        summary[key] = {"bound": runs[1][1][key]}
    for kernel in ("chain", "gcn", "pe_bwd", "scatter_add", "knn", "ball_query_grouped",
                   "ball_query", "three_nn", "fps", "coverage", "nn1", "gather_rows"):
        # cases paired by name: a checkout may launch a case the other does not
        for case in dict.fromkeys(c["case"] for _, r in runs for c in r[kernel]):
            row = {}
            for field in ("ms", "err_float64", "gather_ms", "plain_ms", "library_ms"):
                for lab in ("parent", "change"):
                    vals = [c[field] for lb, r in runs if lb == lab for c in r[kernel]
                            if c["case"] == case and field in c]
                    if vals:
                        row[f"{lab} {field}"] = sum(vals) / len(vals)
            # the bounds of this checkout's plans, from a run of the change
            row.update({k: v for c in runs[1][1][kernel] if c["case"] == case
                        for k, v in c.items() if k in ("bound_ms", "scan_bound_ms")})
            summary[f"{kernel} {case}"] = row
    # the PE backward's padded tie, each output unmasked against its plain
    # version (a checkout whose run has none leaves it out)
    for case, errs in runs[1][1].get("padded_tie", {}).items():
        for name in errs:
            summary[f"padded_tie {case} {name} err"] = {
                lab: mean(lab, lambda r: r["padded_tie"][case][name])
                for lab in ("parent", "change")}
    for label in ("parent", "change"):
        for line in next(r for lab, r in runs if lab == label)["ptxas"]:
            print(f"{label} ptxas: {line}", flush=True)
    for key, row in summary.items():
        print(f"A/B {key}: " + ", ".join(f"{k} {v:.3e}" if "err" in k or "err" in key
                                          else f"{k} {v:.4f}"
                                          for k, v in row.items()), flush=True)
    print(json.dumps({"ab": summary, "card": card}))
    print(card)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    if sys.argv[1:2] == ["--time-kernels"]:
        return time_kernels(Path(sys.argv[2]) if len(sys.argv) > 2 else REPO)
    if sys.argv[1:2] == ["--ab"] and len(sys.argv) > 2:
        return ab(Path(sys.argv[2]).resolve())
    if sys.argv[1:2] == ["--dp-rank"] and len(sys.argv) > 2:
        return dp_rank_main(Path(sys.argv[2]))
    from garment4d_tpu_torch import ops
    from garment4d_tpu_torch.api import GarmentReconstructor
    from garment4d_tpu_torch.data.synthetic import make_batch
    from garment4d_tpu_torch.models import BodyInputs, GarmentAssets
    from garment4d_tpu_torch.ops import _build, pemax
    from garment4d_tpu_torch.smpl import synthetic_smpl
    from garment4d_tpu_torch.train.step import body_inputs_from_batch

    t_start = time.perf_counter()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    kind = torch.cuda.get_device_name(0)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}; {card}", flush=True)

    # ---- 1. build -----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    print(f"kernel build: {build_s:.1f} s (nvcc {_build.build_seconds})", flush=True)
    for line in _build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("ptxas:", line.strip())

    # ---- the batch and the weights ---------------------------------------
    dev = torch.device("cuda")
    assets = GarmentAssets.synthetic(num_rings=RINGS, ring_size=RING_SIZE)
    body = synthetic_smpl(num_verts=N, device=dev)
    batch = make_batch(assets, body, batch_size=B, T=T, npoints=N, device=dev)
    pcd = batch["pcd"]
    body_in = body_inputs_from_batch(batch)
    weights = str(REPO / "ckpt_synth" / "posed_synth.npz")
    recon = GarmentReconstructor.from_npz(assets, body, weights, device=dev)

    # ---- 2. per kernel -----------------------------------------------------
    res = Results()
    check_kernels(recon, pcd, res)
    bound_sums = check_posed_kernels(recon, pcd, body_in, res)
    bound_sums.update(check_chain_gcn(recon, pcd, body_in, res))

    # ---- 3. canonical path -------------------------------------------------
    out_c, canon_launches = counted("canonical", lambda: recon.run(pcd), CANONICAL_KERNELS)
    require(tuple(out_c.tpose_garment.shape) == (B, VG, 3), "tpose shape")
    require(bool(torch.isfinite(out_c.tpose_garment).all()), "non-finite tpose_garment")
    canon_s = wall_s(lambda: recon.canonical(pcd), runs=3)
    print(f"canonical forward, kernel path: {F / canon_s:.2f} frames/s "
          f"({canon_s * 1e3:.2f} ms per {F} frames)", flush=True)
    rows, canon_dev_ms = profile_device(lambda: recon.canonical(pcd), runs=2)
    canon_idle = print_profile("canonical", rows, canon_dev_ms, canon_s * 1e3, top=8)
    with ops.plain_ops():
        canon_plain_s = wall_s(lambda: recon.canonical(pcd), runs=2)
    print(f"canonical forward, plain path on the card: {F / canon_plain_s:.2f} "
          f"frames/s ({canon_plain_s * 1e3:.2f} ms)", flush=True)

    # ---- 4. posed path -----------------------------------------------------
    with recording(pemax, "_compact_candidates") as compactions, \
            recording(recon.model, "refine") as steps:
        out, launches = counted("posed", lambda: recon.posed(pcd, body_in, return_all=True),
                                FORWARD_KERNELS)
    for name, n in POSED_LAUNCHES.items():
        require(launches.get(name, 0) == n, f"{name}: {launches.get(name, 0)} launches in a "
                f"posed forward, {n} expected")
    overflows = [c[2][1] for c in compactions]
    print(f"body queries: {len(overflows)}, overflow branch taken: {overflows} "
          f"(one host read each)", flush=True)
    last = out.iter_garment_v[-1]
    require(len(out.iter_garment_v) == 3, "three refinement iterations")
    steps4 = center_steps(out)
    require(tuple(last.shape) == (B, T, VG, 3), f"posed shape {tuple(last.shape)}")
    require(all(bool(torch.isfinite(v).all()) for v in out.iter_garment_v),
            "non-finite posed garment")

    posed_s = wall_s(lambda: recon.posed(pcd, body_in))
    print(f"posed forward, kernel path: {F / posed_s:.2f} frames/s "
          f"({posed_s * 1e3:.2f} ms per {F} frames)", flush=True)
    rows, posed_dev_ms = profile_device(lambda: recon.posed(pcd, body_in), runs=2)
    posed_idle = print_profile("posed", rows, posed_dev_ms, posed_s * 1e3, top=20)
    posed_kernel_ms = {k: device_ms_of(rows, AB_KERNEL_NAMES[k]) for k in TIMED_KERNELS}
    print(f"posed forward device ms per forward: chain kernel {posed_kernel_ms['fused_chain']:.4f} "
          f"(summed bound {bound_sums['chain']:.4f}), GCN layer kernels "
          f"{posed_kernel_ms['gcn_stack']:.4f} (summed bound {bound_sums['gcn']:.4f})",
          flush=True)
    for k in ("knn_transfer", "ball_query_grouped", "ball_query", "three_nn", "fps", "coverage",
              "gather_rows"):
        print(f"posed forward device ms per forward: {k} {posed_kernel_ms[k]:.4f} in "
              f"{launches.get(k, 0)} launches (summed bound {bound_sums[k]:.4f})", flush=True)

    # one sequence against the plain path on the CPU; the plain path on the
    # card beside it shows how far fp32 rounding alone moves the result
    with ops.plain_ops():
        out_plain = recon.posed(pcd, body_in, return_all=True)
        posed_plain_s = wall_s(lambda: recon.posed(pcd, body_in), runs=3)
    print(f"posed forward, plain path on the card: {F / posed_plain_s:.2f} frames/s "
          f"({posed_plain_s * 1e3:.2f} ms); kernel path {F / posed_s:.2f} frames/s",
          flush=True)
    recon_cpu = GarmentReconstructor.from_npz(assets, body, weights, device="cpu")
    body_1 = BodyInputs(**{k: getattr(body_in, k)[:1].cpu() for k in body_in.__dataclass_fields__})
    t0 = time.perf_counter()
    out_cpu = recon_cpu.posed(pcd[:1].cpu(), body_1, return_all=True)
    cpu_s = time.perf_counter() - t0
    agreement = {}
    for label, gpu in (("kernel", out), ("plain", out_plain)):
        rows = []
        for it, (c, g) in enumerate(zip(out_cpu.iter_garment_v, gpu.iter_garment_v)):
            diff = (c[0] - g[0].cpu()).abs().amax(-1)  # (T, Vg) per-vertex max
            rows.append(dict(iteration=it, within_1e3=(diff <= 1e-3).float().mean().item(),
                             within_1e4=(diff <= 1e-4).float().mean().item(),
                             max_abs=diff.max().item()))
            print(f"GPU {label} path vs CPU plain path, seq 0, iteration {it}: vertices "
                  f"within 1e-3 {rows[-1]['within_1e3']:.6f}, within 1e-4 "
                  f"{rows[-1]['within_1e4']:.6f}, max abs diff {rows[-1]['max_abs']:.3e}")
        agreement[label] = rows
    lbs_err = (out_cpu.lbs.posed_garment[0] - out.lbs.posed_garment[0].cpu()).abs().max().item()
    labels_gpu = out.canonical.backbone.sem_logits.argmax(-1)[:T].cpu()
    agree = (out_cpu.canonical.backbone.sem_logits.argmax(-1) == labels_gpu).float().mean().item()
    tpose_err = (out_cpu.canonical.tpose_garment[0] - out.canonical.tpose_garment[0].cpu()
                 ).abs().max().item()
    print(f"CPU plain path {cpu_s:.1f} s; label agreement {agree:.6f}, tpose_garment max "
          f"abs diff {tpose_err:.3e}, LBS posed garment max abs diff {lbs_err:.3e}",
          flush=True)
    forced = teacher_forced_forward(steps, recon_cpu)
    require(agree >= 0.999, f"label agreement {agree} < 0.999")
    require(tpose_err <= 1e-3, f"tpose_garment diff {tpose_err} > 1e-3")
    require(lbs_err <= 1e-4, f"LBS posed garment diff {lbs_err} > 1e-4")
    # The refinement loop moves the query centers, so fp32 rounding flips a
    # few radius-boundary memberships and the iterations amplify them: the
    # plain path on the card, which launches no kernel of ours, differs from
    # the CPU as much, and by how much moves from host to host (98.7-99.2% of
    # the last iteration's vertices within 1e-3 on H100 hosts). Each
    # iteration of the kernel path is held to the plain path's agreement less
    # 0.2% of the vertices (and 97% at least), and to twice its largest
    # difference plus 1e-3.
    for k_row, p_row in zip(agreement["kernel"], agreement["plain"]):
        it = k_row["iteration"]
        require(k_row["within_1e3"] >= max(0.97, p_row["within_1e3"] - 0.002),
                f"iteration {it}: {k_row['within_1e3']} of the vertices within 1e-3 "
                f"against {p_row['within_1e3']} on the plain path")
        require(k_row["max_abs"] <= 2 * p_row["max_abs"] + 1e-3,
                f"iteration {it}: max abs diff {k_row['max_abs']} against "
                f"{p_row['max_abs']} on the plain path")

    # ---- 5. posed train step -------------------------------------------------
    del out, out_plain, out_cpu, steps, compactions
    torch.cuda.empty_cache()
    train = train_phase(assets, body, weights, res)

    # ---- 6. canonical train step ---------------------------------------------
    torch.cuda.empty_cache()
    canon_train = canonical_train_phase(assets, body, weights, res)

    entry_root = Path(tempfile.mkdtemp(prefix="g4d_entry_"))
    try:
        # ---- 7. the training entry point -------------------------------------
        torch.cuda.empty_cache()
        entry = entry_point_phase({"canonical_train": canon_train["frames_per_sec"],
                                   "posed_train": train["frames_per_sec"]}, entry_root)

        # ---- 8. the MGN variant and the reference's checkpoint files --------
        from garment4d_tpu_torch.train.convert import load_npz_subtree

        torch.cuda.empty_cache()
        canonical_sd = load_npz_subtree(weights, "canonical")
        mgn = mgn_forward_phase(assets, body, pcd, body_in, canonical_sd, res)
        torch.cuda.empty_cache()
        mgn_train = mgn_train_phase(assets, body, canonical_sd, res)
        torch.cuda.empty_cache()
        reference = reference_files_phase(assets, body, pcd, body_in)

        # ---- 9. data parallelism ---------------------------------------------
        torch.cuda.empty_cache()
        tree = entry.pop("tree")
        dp = data_parallel_phase(assets, body, weights, entry_root, tree,
                                 entry["frames_per_sec"])

        # ---- 10. the posed model's opt-in levers -----------------------------
        torch.cuda.empty_cache()
        levers = levers_phase(recon, recon_cpu, pcd, body_in, steps4, assets, body, weights,
                              entry_root, tree, res)

        # ---- 11. determinism ---------------------------------------------------
        torch.cuda.empty_cache()
        determinism = determinism_phase(recon, pcd, body_in, assets, body, weights)

        # ---- 12. post-processing and body fitting -------------------------------
        torch.cuda.empty_cache()
        post = postprocess_phase(recon, pcd, body_in, assets, body, res)

        # ---- 13. the Trousers and Tshirt classes ---------------------------------
        torch.cuda.empty_cache()
        classes = classes_phase(recon, pcd, body_in, body, weights, res)

        # ---- 14. the tracing tool ------------------------------------------------
        torch.cuda.empty_cache()
        tools = tools_phase()

        # ---- 15. the demos -----------------------------------------------------------
        torch.cuda.empty_cache()
        demos = demos_phase()

        # ---- 16. --bf16, --remat, --debug_nans (the entry point on phase 7's tree)
        torch.cuda.empty_cache()
        flags = flags_phase(assets, body, weights, pcd, body_in, entry_root, tree, res)

        # ---- 17. the JAX package's shapes ------------------------------------------
        torch.cuda.empty_cache()
        jax_shapes = jax_shapes_phase(recon, assets, body, entry_root, res)
    finally:
        shutil.rmtree(entry_root, ignore_errors=True)
    total_s = time.perf_counter() - t_start
    print(f"chip_smoke: all phases in {total_s:.1f} s (build {build_s:.1f} s)", flush=True)

    # ---- 18. results -------------------------------------------------------
    path_launches = {"canonical": launches, "posed": launches, "train": train["launches"],
                     "canonical_train": canon_train["launches"], None: {}}
    kernels = []
    for name, cases in res.cases.items():
        source, replaces, path = KERNELS[name]
        # the row reads the costliest case of the kernel's own main path
        own = [c for c in cases if c.get("path", path) == path]
        main_case = max(own, key=lambda c: c["plain_ms"])
        kernels.append(dict(
            name=name, route="cuda", source=CSRC + source, replaces=PALLAS + replaces,
            launches=path_launches[path].get(name, 0), main_path=path,
            launches_canonical=canon_launches.get(name, 0),
            launches_train_step=train["launches"].get(name, 0),
            launches_canonical_train_step=canon_train["launches"].get(name, 0),
            launches_mgn=mgn["launches"].get(name, 0),
            launches_mgn_train_step=mgn_train["launches"].get(name, 0),
            launches_spatial=levers["forwards"]["spatial"]["launches"].get(name, 0),
            launches_both_levers=levers["forwards"]["both"]["launches"].get(name, 0),
            launches_postprocess=post["launches"].get(name, 0),
            launches_trousers=classes["Trousers"]["launches"].get(name, 0),
            launches_trousers_train_step=classes["Trousers"]["train"]["launches"].get(name, 0),
            launches_seg_demo=demos["seg_launches"].get(name, 0),
            launches_bf16_canonical=flags["bf16_canonical_forward"]["launches"].get(name, 0),
            launches_jax_shapes_canonical_512=jax_shapes["canonical_512"]["launches"].get(name, 0),
            launches_jax_shapes_posed_512=jax_shapes["posed"]["launches"].get(name, 0),
            max_abs_err=max(c["max_abs_err"] for c in cases),
            ms=main_case["ms"], plain_ms=main_case["plain_ms"],
            bound_ms=main_case["bound_ms"], bound_by=main_case["bound_by"],
            **{k: main_case[k] for k in ("scan_bound_ms",) if k in main_case},
            library_ms=main_case["library_ms"], case=main_case["case"], cases=cases))
    print(json.dumps({
        "kernels": kernels,
        "posed_frames_per_sec": F / posed_s,
        "posed_plain_frames_per_sec": F / posed_plain_s,
        "posed_device_ms_per_forward": posed_dev_ms, "posed_idle_share": posed_idle,
        "posed_chain_device_ms": posed_kernel_ms["fused_chain"],
        "posed_chain_summed_bound_ms": bound_sums["chain"],
        "posed_gcn_device_ms": posed_kernel_ms["gcn_stack"],
        "posed_gcn_summed_bound_ms": bound_sums["gcn"],
        "posed_kernel_device_ms": posed_kernel_ms, "posed_summed_bound_ms": bound_sums,
        "canonical_frames_per_sec": F / canon_s,
        "canonical_plain_frames_per_sec": F / canon_plain_s,
        "canonical_device_ms_per_forward": canon_dev_ms, "canonical_idle_share": canon_idle,
        "body_query_overflows": overflows, "gpu_vs_cpu": agreement, "gpu_vs_cpu_forced": forced,
        "posed_train_frames_per_sec": train["frames_per_sec"],
        "posed_train_plain_frames_per_sec": train["plain_frames_per_sec"],
        "posed_train_device_ms_per_step": train["device_ms_per_step"],
        "posed_train_idle_share": train["idle_share"],
        "posed_train_kernel_device_ms": train["kernel_device_ms"],
        "posed_train_summed_bound_ms": train["summed_bound_ms"],
        "posed_train_peak_gib": train["peak_gib"],
        "train_loss_rel_err_kernel_vs_plain": train["loss_rel_err"],
        "train_forced_grads": train["forced"],
        "canonical_train_frames_per_sec": canon_train["frames_per_sec"],
        "canonical_train_plain_frames_per_sec": canon_train["plain_frames_per_sec"],
        "canonical_train_device_ms_per_step": canon_train["device_ms_per_step"],
        "canonical_train_idle_share": canon_train["idle_share"],
        "canonical_train_kernel_device_ms": canon_train["kernel_device_ms"],
        "canonical_train_summed_bound_ms": canon_train["summed_bound_ms"],
        "canonical_train_peak_gib": canon_train["peak_gib"],
        "canonical_train_step_peak_gib": canon_train["peak_step_gib"],
        "canonical_train_loss_rel_err_kernel_vs_plain": canon_train["loss_rel_err"],
        "canonical_train_forced_grads": canon_train["forced"],
        "canonical_train_path_grad_rel_l2": canon_train["path_grad_rel_l2"],
        "canonical_train_path_grad_plain_spread": canon_train["path_grad_plain_spread"],
        "entry_point_launches": entry["launches"],
        "entry_point_frames_per_sec": entry["frames_per_sec"],
        "entry_point_loader_alone": entry["loader_alone"],
        "entry_point_only_eval_rel_err": entry["only_eval_rel_err"],
        "entry_point_finalize_err": entry["finalize_err"],
        "entry_point_phase_s": entry["phase_s"],
        "mgn_frames_per_sec": mgn["frames_per_sec"],
        "mgn_device_ms_per_forward": mgn["device_ms_per_forward"],
        "mgn_idle_share": mgn["idle_share"],
        "mgn_kernel_device_ms": mgn["kernel_device_ms"],
        "mgn_summed_bound_ms": mgn["summed_bound_ms"],
        "mgn_launches": mgn["launches"], "mgn_lbs_forced": mgn["forced"],
        "mgn_train_frames_per_sec": mgn_train["frames_per_sec"],
        "mgn_train_device_ms_per_step": mgn_train["device_ms_per_step"],
        "mgn_train_idle_share": mgn_train["idle_share"],
        "mgn_train_launches": mgn_train["launches"],
        "mgn_train_loss_rel_err_kernel_vs_plain": mgn_train["loss_rel_err"],
        "mgn_train_grad_rel_l2": mgn_train["grad_rel_l2"],
        "reference_files_tensors_loaded": reference,
        "data_parallel": dp,
        "levers": levers,
        "determinism": determinism,
        "postprocess": post,
        "classes": classes,
        "tools": tools,
        "demos": demos,
        "flags": flags,
        "jax_shapes": jax_shapes,
        "build_s": build_s,
        "total_s": total_s}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
