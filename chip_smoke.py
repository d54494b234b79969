#!/usr/bin/env python3
"""Run the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which fails the run on any fault or mismatch:

1. identity: the card (nvidia-smi name and power limit) and the builds,
   side by side, of the CUDA kernels and their backward from
   diffndm_tpu_torch/csrc (nvcc) and of the native reward scorer (g++);
2. kernels: each EGNN edge-chain kernel against its plain PyTorch version
   on the card, on the inputs the main path gives it (captured from one
   denoiser forward), at the flagship shapes of
   configs/crossdock_fullatom_cond.yml (B=20, N=344, H=256, 5 A cutoff)
   and over a sweep of small ragged shapes and options; kernel time,
   plain time and the card's bound for the same work; every kernel output
   is computed twice and must come out bit-identical; then the backward
   kernels (through the wrappers' autograd Functions) against the plain
   backward, per gradient tensor, on the calls of one v3b training
   forward at each training shape [16, 72/80/88/96, 192] (the first call
   of each also against autograd through the plain forward) and at the
   flagship shapes, bit-identical on repeat, timed beside their bound
   and with the compiler's register and spill report; and over the
   forward's sweep of small ragged shapes and options;
3. path check: a 10-step fixed-noise trajectory through the kernels on
   the card against the plain path on the CPU;
4. main path: 2 test pockets x 16 samples at T=500 from the committed
   v3b EMA weights, molecules built and written as SDF, with the kernel
   launch counts of that run;
5. guided: the same 2 pockets x 16 samples at T=500 with SPSA + ATP
   guidance at its defaults, every reward from the native scorer; the
   launch counts that follow from the config; seconds per pocket batch,
   the oracle's share of the wall time; and a 12-step fixed-noise guided
   trajectory on the card against the plain path on the CPU;
6. fan-out and oracle: the kernels against their plain versions on the
   inputs of one fused SPSA forward captured from the guided run
   ([k*2B, N, H] = [320, 80, 192]); the native scorer against the Python
   scorer on one 320-molecule population of that run, each with one
   worker and with min(8, cores) (threads for the native scorer, spawned
   processes for the Python one), rewards bit-equal (one guided pocket
   batch with the oracle on that many workers and one with a single
   worker, in turn, seconds and the oracle's share: ``--only workers``);
7. quality: 8 test pockets x 16 samples, unguided and guided, scored by
   the evaluation protocol of the JAX package's guided-lift script
   (largest fragment, sizes floored at 4) beside that script's committed
   rows, with floors on validity, QED, SA and the guided lift;
8. step: a 50-step stretch of the unguided sampler with CUDA events
   around every kernel wrapper call and a profiler trace: ms per step,
   kernel ms per step inside the loop, the device's idle share;
9. cli: the port's generate CLI (diffndm_tpu_torch.cli.generate, run in
   this process) on a PDB file and a reference-ligand SDF written from
   test pocket 220: the pocket read from the PDB against the dataset's,
   then 16 ligands at T=500 with SPSA + ATP, the RL AdjustNet adjusting
   every step and trained by REINFORCE over two loops, sanitized into an
   SDF; the launch counts of each loop, the AdjustNet changed by the
   updates and its checkpoint reloaded bit for bit; the kernels against
   their plain versions on the calls of the run's first main-step forward
   and first fused SPSA forward (the PDB pocket's shapes); and a 12-step
   fixed-noise guided trajectory with the AdjustNet on the card against
   the plain path on the CPU;
10. inpaint: a short fixed-noise guided inpainting (SPSA and two ATP
   prunes fire) on the card against the plain path on the CPU; then the
   port's inpaint CLI in-process on the same PDB and a fragment SDF made
   by its fix_ligand CLI (T=60 x 10 resamplings, 10 added atoms, 16
   samples, ATP): launch counts that follow from the config, the kernels
   against their plain versions on the calls of the run's first forward,
   the fixed atoms' geometry kept, seconds per batch and the host time of
   the RePaint combine;
11. inpaint-quality (``--only quality`` only, to keep the full run near
   800 s): the protocol of the JAX package's
   scripts/inpaint_lift_eval.py (8 test pockets x 16, the first quarter of
   each test ligand fixed, 10 atoms added, T=60 x 10, unguided then ATP,
   whole molecules) beside that script's committed rows, with floors;
12. optimize: the port's optimize CLI in-process (population 100, 100
   noising steps, 2 generations, QED): launch counts, the kernels on the
   calls of the first diversify forward, best and mean QED and seconds
   per generation; and a 10-step fixed-noise diversify on the card
   against the CPU;
13. sweep: the port's sweep CLI in-process over four test pockets
   written as PDB + SDF pairs: (a) the four in one batch of 64 rows at
   T=500, (b) per pocket with oversampling and --sanitize (two pockets),
   (c) inpainting with ATP at T=60 x 10 (two pockets); no retry and no
   skipped pocket, launch counts that follow from the generations run,
   the kernels against their plain versions on the calls of (a)'s first
   forward ([64, N, 192]), the evaluate CLI's AGGREGATE line of each
   output, (a) again with --resume skipping every pocket, and the step
   phase's measurement on (a)'s 64-row batch;
14. train: a fixed-noise training update from v3b's raw state on the
   card against the CPU (loss, gradients, the optimizer); the port's
   train CLI in-process resuming v3b for 40 micro-steps on a 40-batch
   cut of virtual_v3's training split, so that one epoch, the val loss
   and the chemistry dashboard run once: launch counts per micro-step,
   val batch and dashboard sampling, the loss beside the JAX run's, the
   best and last checkpoints read back; then one micro-step profiled (ms,
   device busy, idle share) and its peak memory beside the plain
   chain's;
15. vina: the generate CLI in-process with the affinity reward
   (--SPSA 1 --SVDD 1 --w_vina 0.1) on pocket 220 as PDB + SDF, 8 rows at
   T=500 with 8 oracle workers configured: launch counts, every affinity
   batch scored in this process, the first reward batch rescored on the
   CPU bit for bit, the kernels on the calls of the first main-step and
   fused SPSA forwards, seconds and the oracle's share;
16. optimize-vina: the optimize CLI with --objective vina (population
   100, 2 generations): launch counts, the kernels on the first diversify
   forward, the best score against its molecule rescored;
17. dock: the evaluate CLI with --receptor --dock on [vina]'s molecules
   on the card; then dock_molecules of them against a seeded synthetic
   receptor (~4,100 heavy atoms of standard residues, a 7 A cavity): the
   card against the CPU on the same draws in a short search (the same
   best restart, poses and affinities within 1e-3), and the default
   search (64 restarts, 200 + 100 Adam steps) timed, profiled (device
   busy, idle share, the kernels that take it) with its peak memory and
   the receptor crop's size;
18. joint: configs/crossdock_fullatom_joint.yml at its published width
   (hidden 128, 5 layers) on seeded random weights, every row's
   coordinates moving: JointSampler.sample (16 rows, sizes from the
   default joint size prior, T=500) and JointSampler.inpaint (the whole
   pocket of [dock]'s synthetic receptor, cropped around test pocket
   220's ligand, fixed and 16 ligands free, T=500 x 2 resamplings, jumps
   of 10): seconds, ms per forward, launch counts, the kernels against
   their plain versions on the calls of each run's first forward, the
   joint centre of mass and the fixed pocket's geometry; and fixed-noise
   runs of both (T=50) on the card against the CPU;
19. joint-train: one joint loss value and its gradient at B=8 through the
   backward kernels: launch counts, the loss against the plain forward,
   each backward call against the plain backward per gradient tensor;
20. configs: every configs/*.yml at its full width on seeded random
   weights, one forward on its own kind of pocket (the synthetic
   receptor's CA or full-atom crop): each kernel call against its plain
   version and the output against the plain chain's; for each joint
   config also the joint sampler's first forward (t = T, 16 rows at sizes
   of the size prior, every row moving), each kernel call against its
   plain version; then
   generate_ligands of configs/crossdock_ca_cond.yml (16 rows, T=500)
   with its launch counts;
21. variants: the JAX package's model variants at v3b's published width
   on test pocket 220 (16 rows, N = 80): (a) the sinusoid distance
   embedding, (b) mean aggregation, (c) the edge-type embedding (dim 8),
   (d) the GNN denoiser, all four on seeded random weights and on the
   dense edge chain (no kernel launch), (e) pocket_conditioning_simple
   and (f) the learned noise schedule (VLB), both on v3b's EMA weights
   and on the kernels (5 launches per wrapper per forward): one forward
   on the card against the CPU, one sampling at T=500 (s per batch, ms
   per forward, launch counts); for (f) also the train CLI for 8
   micro-steps (launch counts forward and backward, ms per micro-step,
   peak memory, the gamma network moved) and the first micro-step's
   gradients of both trees, card against CPU;
22. etl: every virtual_v3 pair (5,657 train, 314 val, 314 test) written
   as a CrossDocked tree (crossdocked_pocket10/<dir>/<rec>.pdb +
   <lig>.sdf, split_by_name.json), processed by the port's
   process_crossdock CLI, its test export flattened by
   prepare_crossdocked for the sweep CLI: seconds, no pair dropped,
   ligands and pockets (the 8 A rule recomputed here) equal to the source
   within the files' rounding; the train CLI on the
   processed split at v3b's width from v3b's raw state for 8 micro-steps
   with its eval and the dashboard's renders on (launch counts per
   micro-step, val batch and dashboard sampling; the dashboard's SDF and
   its render line), the micro-steps under utils.profiling.trace (the
   forward / backward / optimizer spans and the kernels in the trace);
   egnn_flops_analytic of the micro-step's forward and its rate on the
   card against the card's peaks; one unguided batch (16, T=500) from the
   trained weights on a processed test pocket;
23. modes: the denoiser's precision and sparsity modes. (a) the bf16
   variants of both kernels against their bf16 plain versions (gate
   BF16_GATE of the largest plain element) on the calls of a bf16 v3b
   forward [16, 80, 192], of the joint sampler's first forward [16, 584,
   128] and at the flagship shapes, timed beside the fp32 kernels on the
   same calls and the dense bf16 bound;
   (b) v3b in bf16: one unguided batch (16, T=500) with its launch
   counts, a 10-step fixed-noise run on the card against the CPU's plain
   bf16 run, beside two runs with a fault that the gate must fail (the
   fp32 kernels; no rounding outside the kernels), the quality protocol's unguided row for one seed beside the
   fp32 row of phase 7 (recorded, not gated); (c) K-nearest-neighbour
   edges (K = 16, 32) on the main path's first state, card against CPU,
   the share of rows with more edges than K, ms per forward; (d) the
   sorted band on configs/crossdock_fullatom_cond.yml at its published
   width (seeded weights) on phase 18's crop of the synthetic receptor:
   the exact window's forward equal to the dense one, the pocket order
   the same on the card as on the CPU, the approximate window (128) card
   against CPU, ms per forward of each; (e) generate_ligands on that crop
   with its "[banding] window=" line and launch counts, beside the same
   call under DIFFNDM_AUTO_BAND=0, whose result it must equal to the bit
   (the exact window runs the denoiser dense);
24. dp: data parallelism at v3b's full width. (a) the train CLI with
   --device cuda on every visible card (one process per card over NCCL;
   on one card this process) for 8 micro-steps from v3b's raw state,
   whose losses equal a Trainer's in this process on the same batches (to
   the bit on one card); (b) two ranks sharing card 0 over gloo
   (parallel.mesh.spawn): 4 micro-steps at [16, 96, 192], then 15 rows
   padded to 16, against one process on the padded batches with the same
   draws (losses, parameters and EMA, the ranks equal to the bit, each
   rank holding the weights it loaded after rank 0's broadcast, launch
   counts per rank); (c) those ranks sampling pocket 220 (B = 16) with
   SPSA + ATP at the guided phase's config for T = 60 under fixed noise,
   ATP's selection across the ranks, against one process (rows,
   coordinates, atom types, forwards and launches per rank).  With more
   than one card visible, (b) and (c) run again over NCCL, a card per
   rank;
25. bf16train: training under EGNNConfig.compute_dtype = "bfloat16".
   (a) both bf16 backward kernels (csrc/egnn_edge_bwd.cu,
   edge_chain_bwd_wgmma<H, VEC>) against the plain bf16 backward in
   float64 on the card (gate BF16_BWD_L2 in relative L2 norm per
   gradient, or twice the distance of the plain bf16 backward in fp32
   where that is further; the weights' gradients bf16 values), on the
   calls of a bf16 v3b training forward at each training shape [16,
   72/80/88/96, 192], of [joint-train]'s joint loss in bf16 [8, 416, 128]
   and at the flagship shapes; repeat launches bit-identical; the fp32 backward kernel on the
   same calls fails the gate; on the first call of each, each rounding
   point of the backward held apart against float64 references with and
   without it (the plain backward without it fails), and at [16, 88,
   192] the gate under 8 output gradients; ms per call beside the fp32
   backward, the plain bf16 backward and the bound (the recompute at the
   bf16 peak, the rest at TF32's); (b) a bf16 fixed-noise micro-step
   pair from v3b's raw state, card against CPU (loss, gradient norm, the
   whole clipped gradient; the card's fp32 pair fails the gates; the
   optimizer fed the CPU's gradients), then 8 micro-steps of a bf16 and an
   fp32 Trainer on [dp] (a)'s 128 training pairs: losses side by side, ms
   per micro-step, peak memory, launches per micro-step (5 + 5 forward,
   10 + 10 backward, all in the run's compute dtype);
26. fanout-tap: v3b's EMA weights on phase 18's crop of the synthetic
   receptor, the facade's band at row tile 8 capped at 128
   (DIFFNDM_BAND_APPROX): (a) a fixed-noise guided trajectory with
   SampleConfig.fanout_row_tile = 16 (SPSA, ATP and the hybrid firing) on
   the card against the plain path on the CPU, under the guided path
   gate; SPSA + ATP at their defaults, 16 rows, T = 40, the field at 16
   and unset: (b) launches equal to count_forwards' and the fan-out
   forwards run with their own band, (c) under the capped band the two
   score other populations, (d) under the exact band they are bit-equal;
   ms per forward of the trajectory and of a 320-row fan-out at tile 8
   and 16; (e) the SDF frame tap every 100 steps of an unguided T = 500
   batch: its files (try_0 .. try_400), launches, its host time per
   written frame and per step without one; (f) the guided-phase profile's
   report (DIFFNDM_GUIDED_PROFILE=1) of the capped run with the field.

27. optimizer: the trainer's fused multi-tensor kernels
   (csrc/fused_optimizer.cu) against the plain per-leaf path, both on the
   card, at configs/crossdock_fullatom_cond.yml's 176 leaves (seeded
   init), from the same state and gradients: 6 micro-steps at
   accumulate_grad_batches 2, with the clip engaged (gradients x 1e4) and
   not, EMA decay 0 and 0.999, with and without a learned schedule's
   gamma network; the norm, threshold and norm buffer within 2 ulps; the
   clipped gradients, weights, moments, accumulator and EMA to the bit
   where the clip does not engage; where it does, the clipped gradients
   within 4 ulps (the state reported in ulps of each leaf's largest
   entry); always the state to the bit against the plain path fed the
   fused side's clipped gradients; launches per micro-step, no
   plain-path call and no host sync in a fused micro-step (sync debug
   mode "error"); ms per launch of each kernel against its bytes bound,
   and the optimizer span's host and card ms per micro-step, fused and
   plain.

``--only kernels`` stops after phase 2, ``--only vina`` runs phases 1,
2 and 15-17, ``--only joint`` phases 1, 2 and 18-20, ``--only variants``
phases 1 and 21, ``--only etl`` phases 1 and 22, ``--only modes``
phases 1 and 23, ``--only dp`` phases 1 and 24, ``--only bf16train``
phases 1 and 25, ``--only fanout`` phases 1 and 26, ``--only workers``
phase 1 and phase 6's oracle-worker batches, ``--only optimizer`` phase
27 alone (building only its library), and ``--only phases``
prints, from a build of the
kernels with cycle counters, where a block's time goes in the forward
kernels (fp32 and bf16) and in both backward epilogues, with the device
time of each kernel a backward call launches (both for work on the
kernels).
``--only quality`` runs phase 7 alone over five seeds and prints how far
each metric moves with the random stream (what a change to the kernels'
arithmetic has to exceed), then phase 11 with its floors and the same
spread for it.  ``--only
train`` runs phases 1, 2, 14 and 27.
None of the fourteen prints a result line.

The last lines are the kernel table as one JSON object, the card's name
and power limit, and {"ok": true, "device": {...}}.  Without a CUDA
device, or outside a checkout of the repository, it exits non-zero
before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import time
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
RUN = os.path.join(REPO, "examples", "checkpoints", "virtual_cond_v3b")
WEIGHTS = os.path.join(REPO, "diffndm_tpu_torch", "assets",
                       "virtual_cond_v3b_ema.npz")
DATA = os.path.join(REPO, "data", "processed", "virtual_v3")
POCKETS = (220, 48)          # the 40- and 36-atom test pockets
N_SAMPLES, T_MAIN, T_CHECK, T_STEP = 16, 500, 10, 50
SEED = 0
# quality phase: the protocol and the committed rows of the JAX package's
# scripts/guided_lift_eval.py (a TPU run of the JAX package; quality, not
# speed): examples/checkpoints/virtual_cond_v3b/guided_lift_tpu.json
N_QUALITY_POCKETS, MIN_LIGAND_ATOMS = 8, 4
JAX_ROWS = {
    "unguided": dict(valid=0.906, connectivity=0.868, connected=0.508,
                     qed=0.460, sa=0.486),
    "guided": dict(valid=1.0, connectivity=0.710, connected=0.055,
                   qed=0.565, sa=0.730)}
# floors: those of the JAX package's tests/test_guided_lift.py, lowered by
# about three standard errors at n = 128 (another random stream)
QUALITY_FLOORS = {"unguided": dict(valid=0.85, qed=0.42),
                  "guided": dict(valid=0.93, qed=0.52, sa=0.66)}
LIFT_FLOORS = dict(qed=0.05, sa=0.10)
QUALITY_SPREAD_SEEDS = 5     # --only quality
# guided path check: T, and windows scaled so that every event fires
T_GUIDED_CHECK = 12
GUIDED_CHECK = dict(spsa=dict(num_probes=2, start_step=6, every=2, zeta0=5.0),
                    atp=dict(num_groups=4, start_step=10, every=5))
# cli phase: generation + REINFORCE rounds; the adjusted path check scales
# the fresh AdjustNet's output layer to the size of a policy that has
# learned something (a fresh one adds O(1) to eps at every step)
CLI_POCKET, CLI_LOOPS, ADJUST_SCALE = 220, 2, 0.1
# inpaint phases: the reference sweep's configuration (my_test_inpaint.py)
# and the protocol and committed rows of the JAX package's
# scripts/inpaint_lift_eval.py (a TPU run of the JAX package; quality, not
# speed): examples/checkpoints/virtual_cond_v3b/inpaint_lift_tpu.json
T_INPAINT, R_INPAINT, ADD_NODES, FRAG_FRACTION = 60, 10, 10, 0.25
JAX_INPAINT_ROWS = {
    "unguided": dict(valid=1.0, connectivity=0.644, qed=0.552, sa=0.669,
                     logp=1.761),
    "ATP": dict(valid=1.0, connectivity=0.553, qed=0.669, sa=0.792,
                logp=2.928)}
# floors: the JAX rows less about three standard errors at n = 128
INPAINT_FLOORS = {"unguided": dict(valid=0.95, qed=0.50),
                  "ATP": dict(valid=0.95, qed=0.60)}
INPAINT_LIFT_FLOOR = 0.06
# the fixed atoms' pairwise distances against the fragment's (the JAX
# package's tests/test_inpaint.py::test_inpaint_basic)
FIXED_GEOMETRY_ATOL = 1.5    # Angstrom
# inpaint path check: T x R, and windows scaled so that one SPSA update
# and two prunes fire
T_INPAINT_CHECK, R_INPAINT_CHECK = 6, 3
INPAINT_CHECK = dict(spsa=dict(num_probes=2, zeta0=5.0),
                     atp=dict(num_groups=4),
                     inpaint=dict(spsa_low=3, spsa_high=3,
                                  spsa_zeta_denom=300.0, atp_start_step=2,
                                  atp_every=2))
# optimize phase (the JAX CLI's defaults but 2 generations) and the
# diversify path check
OPT_POPULATION, OPT_STEPS, OPT_GENERATIONS, T_DIVERSIFY_CHECK = 100, 100, 2, 10
# sweep phase: four test pockets (40, 36, 36 and 26 atoms; ligands of 28,
# 21, 24 and 17), one batch of 4 x N_SAMPLES rows in mode (a)
SWEEP_POCKETS = (220, 48, 300, 5)
# vina phases: the affinity weight, the rows of the guided batch (every
# reward row is scored by the Python pipeline in this process: 470 rows
# per sample at T=500), the pose search's defaults (evaluate --dock)
# and its card-vs-CPU check (a short search on the same draws; atol as in
# tests/test_torch_dock.py)
W_VINA, VINA_SAMPLES = 0.1, 8
DOCK_RESTARTS, DOCK_STEPS = 64, 200
DOCK_CHECK_RESTARTS, DOCK_CHECK_STEPS, DOCK_CHECK_ATOL = 8, 8, 1e-3
# the synthetic receptor of [dock]: SYNTH_SITES^3 residues about 5.5 A
# apart, a SYNTH_CAVITY A cavity; the heavy atoms of the standard residues
SYNTH_SITES, SYNTH_CAVITY = 8, 7.0
RESIDUE_ATOMS = {
    "ALA": "N CA C O CB", "ARG": "N CA C O CB CG CD NE CZ NH1 NH2",
    "ASN": "N CA C O CB CG OD1 ND2", "ASP": "N CA C O CB CG OD1 OD2",
    "CYS": "N CA C O CB SG", "GLN": "N CA C O CB CG CD OE1 NE2",
    "GLU": "N CA C O CB CG CD OE1 OE2", "GLY": "N CA C O",
    "HIS": "N CA C O CB CG ND1 CD2 CE1 NE2",
    "ILE": "N CA C O CB CG1 CG2 CD1", "LEU": "N CA C O CB CG CD1 CD2",
    "LYS": "N CA C O CB CG CD CE NZ", "MET": "N CA C O CB CG SD CE",
    "PHE": "N CA C O CB CG CD1 CD2 CE1 CE2 CZ", "PRO": "N CA C O CB CG CD",
    "SER": "N CA C O CB OG", "THR": "N CA C O CB OG1 CG2",
    "TRP": "N CA C O CB CG CD1 CD2 NE1 CE2 CE3 CZ2 CZ3 CH2",
    "TYR": "N CA C O CB CG CD1 CD2 CE1 CE2 CZ OH",
    "VAL": "N CA C O CB CG1 CG2"}

# published H100 SXM peaks (dense TF32 on the tensor cores, HBM3).  The
# kernels split each product into three TF32 products; the bound counts
# the product once.
PEAK_TF32_FLOPS = 495e12
PEAK_BYTES = 3.35e12
# kernel vs plain on the card: fp32 against a three-term TF32 split with
# fp32 accumulation, sums in another order
KERNEL_RTOL, KERNEL_ATOL = 1e-4, 1e-5
# path check: ten steps of fp32 forwards on two devices
PATH_COORD_ATOL = 1e-3       # Angstrom
PATH_LP_RTOL = 1e-4          # the adjusted trajectory's avg log-prob

KERNELS = {
    "gcl_messages": "diffndm_tpu/ops/pallas_egnn.py:151",
    "edge_vector_reduce": "diffndm_tpu/ops/pallas_egnn.py:269",
}
# wrapper -> the kernel it launches (the pair launches the vector kernel
# once for both weight sets)
WRAPPERS = {"gcl_messages": "gcl_messages",
            "edge_vector_reduce": "edge_vector_reduce",
            "edge_vector_reduce_pair": "edge_vector_reduce"}
SOURCE = "diffndm_tpu_torch/csrc/egnn_edge.cu"
# the backward kernels (csrc/egnn_edge_bwd.cu), the forward each
# differentiates, and the gate against the plain backward: per gradient
# tensor, max |kernel - plain| <= BWD_RTOL * max |plain| + BWD_ATOL (sums
# over up to B * N^2 edges, taken in another order)
BWD_KERNELS = {"gcl_messages_bwd": "gcl_messages",
               "edge_vector_reduce_bwd": "edge_vector_reduce"}
BWD_SOURCE = "diffndm_tpu_torch/csrc/egnn_edge_bwd.cu"
OPT_SOURCE = "diffndm_tpu_torch/csrc/fused_optimizer.cu"
BWD_RTOL, BWD_ATOL = 1e-4, 1e-6
# train phase: v3b's training set and raw state, the batch shapes of its
# padding (ligands to 8, pockets to 64 rows), the CLI run's length and cut
TRAIN_STATE = os.path.join(REPO, "diffndm_tpu_torch", "assets",
                           "virtual_cond_v3b_last.npz")
TRAIN_N = (72, 80, 88, 96)
TRAIN_STEPS, TRAIN_EPOCH_BATCHES = 40, 40
TRAIN_CHECK_B = 4             # the card-vs-CPU step: rows of the N=80 batch
TRAIN_RTOL = 1e-5
TRAIN_LOSS_MAX = 0.15         # the CLI run's mean loss (JAX: 0.099-0.100)
# [optimizer]: the fused optimizer kernels against the plain per-leaf path
# on the card, at DiffSBDD's CrossDocked model's 176 leaves: micro-steps
# per case, the gradients' scale (ten-thousandfold with the clip engaged),
# and the gate on what comes from sums in another order (the norm and the
# threshold, so the clip's scale and, where it engages, the gradients and
# the state)
OPT_CONFIG = os.path.join(REPO, "configs", "crossdock_fullatom_cond.yml")
OPT_STEPS = 6
OPT_CLIP_SCALE = 1e4
OPT_ULPS = 2
# where the clip engages: its scale, from a norm OPT_ULPS apart, rounded
# twice more (the division, the product), on each clipped gradient
OPT_GRAD_ULPS = OPT_ULPS + 2
OPT_MAX_LAUNCHES = 10
# joint phases: configs/crossdock_fullatom_joint.yml at its published width
# on seeded random weights: (a) sampling at sizes of the default joint size
# prior, (b) RePaint with the whole pocket fixed (the synthetic receptor's
# full-atom crop) and the ligand free; their fixed-noise checks against the
# CPU at small sizes (the plain chain on the CPU is dense over N^2 pairs:
# ~11 s per forward at N = 576 on a CPU); the joint loss's batch; the
# tolerances: the joint centre of mass of the output, the fixed pocket's
# internal distances (the JAX package's tests/test_joint.py), the loss
# through the kernels against the plain forward (sums in another order)
JOINT_CONFIG = os.path.join(REPO, "configs", "crossdock_fullatom_joint.yml")
JOINT_B, JOINT_T, JOINT_R, JOINT_J = 16, 500, 2, 10
T_JOINT_CHECK, JOINT_CHECK_SIZES = 50, ((14, 48), (20, 60))
JOINT_TRAIN_B = 8
JOINT_COM_ATOL, JOINT_GEOMETRY_ATOL, JOINT_LOSS_RTOL = 1e-3, 1.0, 1e-4
# configs phase: rows of each config's forward, and its gate against the
# plain chain (five or six layers of fp32 sums in another order, in
# normalised units, as the path checks' 1e-3 A); the CA generation
CONFIGS_B, CONFIG_EPS_ATOL = 4, 1e-3
CA_CONFIG = os.path.join(REPO, "configs", "crossdock_ca_cond.yml")
# variants phase: the JAX package's model variants at v3b's published
# width on test pocket VARIANT_POCKET (N = 80 at B = N_SAMPLES).  Per
# variant: its YAML changes, its EGNNConfig changes (the GNN's mode is not
# a YAML key) and whether v3b's EMA weights fit it (else seeded weights);
# the labels' letters, and those that run on the kernels (the rest on the
# dense chain, as the JAX package dispatches them); (f)'s CLI training
VARIANT_CONFIG = os.path.join(REPO, "configs", "virtual_cond_v3b.yml")
VARIANT_POCKET, VARIANT_TRAIN_STEPS, VARIANT_EDGE_DIM = 220, 8, 8
VARIANTS = {
    "a_sin": (dict(egnn_params=dict(sin_embedding=True)), {}, False),
    "b_mean": (dict(egnn_params=dict(aggregation_method="mean")), {}, False),
    "c_edge_embedding": (dict(egnn_params=dict(
        edge_embedding_dim=VARIANT_EDGE_DIM)), {}, False),
    "d_gnn": ({}, dict(mode="gnn_dynamics"), False),
    "e_simple": (dict(mode="pocket_conditioning_simple"), {}, True),
    "f_learned": (dict(diffusion_params=dict(
        diffusion_noise_schedule="learned", diffusion_loss_type="vlb")), {},
        True),
}
VARIANT_KERNEL_LABELS = "ef"
L3_BIAS = "l3.bias"           # the gamma network's cancelling bias
# (f)'s gradient check: the gamma network alone in float64, card against
# CPU
GAMMA_F64_RTOL = 1e-7
# etl phase: every virtual_v3 pair written as a CrossDocked tree and
# processed; the train CLI on the processed split (v3b's config and raw
# state) for ETL_TRAIN_STEPS micro-steps with the eval and the
# dashboard's renders on; the forward timed for its FLOP rate; one
# unguided batch from the trained weights on processed test pocket
# ETL_POCKET
ETL_TRAIN_STEPS, ETL_VISUALIZE, ETL_POCKET = 8, 2, 220
ETL_CUTOFF = 8.0              # the pocket rule, Angstrom, strict
# coordinates through the files: SDF 4 decimals, PDB 3, then float32
SDF_ATOL, PDB_ATOL = 5e-5 + 1e-5, 5e-4 + 1e-5
ETL_SPANS = ("forward", "backward", "optimizer")
ETL_FORWARD_REPS = 20
# modes phase: the denoiser's precision and sparsity modes.  The bf16
# kernel of the two forward wrappers (csrc/egnn_edge.cu, edge_chain_wgmma)
# ports the Pallas kernels' mxu_dtype = bfloat16 mode.  Their
# gate against the bf16 plain version on the card, per output: max
# |kernel - plain| <= BF16_GATE * max |plain| + BF16_ATOL.  Both round the
# same operands to bf16, so what is left is an fp32 sum in another order
# (the tensor cores, cuBLAS), which can move an m that sits at a bf16
# rounding midpoint by one bf16 ulp (2^-8) in the gate or phi dot: on the
# CPU, a product summed in float64 moved the pair's output at [16, 80,
# 192] by 2e-4 of its largest element and gcl_messages' by 1e-5, where
# the fp32 kernel lies 8e-3 and 2e-3 away.  The bound counts the product
# once at the dense bf16 peak.
BF16_KERNELS = {
    "gcl_messages_bf16": "diffndm_tpu/ops/pallas_egnn.py:151",
    "edge_vector_reduce_bf16": "diffndm_tpu/ops/pallas_egnn.py:269",
}
BF16_WRAPPERS = {"gcl_messages": "gcl_messages_bf16",
                 "edge_vector_reduce_pair": "edge_vector_reduce_bf16"}
PEAK_BF16_FLOPS = 989e12
BF16_GATE, BF16_ATOL = 1e-3, 1e-6
# the bf16 fixed-noise trajectory, card against CPU.  In bf16 a flipped
# rounding (of h before the projections, of m in the gate and phi dots)
# moves an operand by 2^-8 of itself, and ten steps amplify it: on the
# CPU alone, summing the W2 product in float64 instead of float32 moved
# this check's coordinates by 0.40 A in bf16 (1.8e-5 A in fp32).  On the
# card (NVIDIA H100 80GB HBM3, 700 W) the first bf16 kernels read 0.267 A
# and the wgmma ones (fast silu, the sum over k carried in the tensor
# cores) 0.238 A, with the atom types equal; the controls, the same run
# with a fault, read 0.592 A (the fp32 kernels) and 0.406 A (no rounding
# outside the kernels), both with atom types changed.  The gate lies between; the
# types separate the faults more clearly than the distance.
BF16_PATH_ATOL = 0.34        # Angstrom
BF16_PATH_SIZES = (12, 18, 9, 24)
# K-nearest-neighbour edges at v3b's width on the main path's first state
KNN_K = (16, 32)
# the band: crossdock_fullatom_cond at its published width on seeded
# weights, on [joint] (b)'s crop of [dock]'s receptor; the approximate
# window; rows of the card-vs-CPU forwards (the CPU's plain chain is dense
# over N^2 pairs) and of the timed ones; forwards per timing
BAND_CONFIG = os.path.join(REPO, "configs", "crossdock_fullatom_cond.yml")
BAND_APPROX_W, BAND_CHECK_B, MODES_REPS = 128, 2, 10
# dp phase: (a) the train CLI on every visible card for DP_CLI_STEPS
# micro-steps from v3b's raw state on a cut of virtual_v3's training split
# (DP_CLI_STEPS batches, no val split); (b) DP_RANKS ranks sharing one card
# over gloo: DP_TRAIN_STEPS micro-steps of the N=96 training batch, then
# its first DP_PAD_ROWS rows (padded to 16), against one process on the
# padded batches with the same draws; (c) those ranks sampling test pocket
# DP_POCKET (B = N_SAMPLES) with SPSA + ATP at the guided phase's config
# for DP_T steps under fixed noise (ATP at s = 50, 40, .., 0; SPSA at
# s = 30, 28, .., 0; the hybrid at 30), against one process.  Gates: the
# losses within TRAIN_RTOL; parameters and EMA within DP_PARAM_RTOL of each
# tensor's largest entry (the gradient sums run in another order); the
# coordinates within PATH_COORD_ATOL.  A rank that hangs fails the phase
# after DP_JOIN_TIMEOUT seconds.
DP_CLI_STEPS, DP_TRAIN_STEPS, DP_PAD_ROWS, DP_RANKS = 8, 4, 15, 2
DP_POCKET, DP_T = 220, 60
DP_PARAM_RTOL = 1e-4
DP_JOIN_TIMEOUT = 300.0
# bf16train phase: training under EGNNConfig.compute_dtype = "bfloat16".
# (a) The bf16 backward kernels (edge_chain_bwd_wgmma<H, VEC>) against
# the plain bf16 backward in float64 on the card.  Both round the same
# values to bf16, but two programs' fp32 sums and transcendentals (the
# kernel's fast silu, its recomputed u summed in another order than the
# bf16 forward's) differ in their last bits, and a value at a bf16
# midpoint then rounds to the other side, by 2^-8 of itself, moving every
# gradient downstream of it.  On the card (NVIDIA H100 80GB HBM3, 700 W)
# at [16, 80-96, 192] the plain bf16 backward in fp32 lies up to 3.9e-3
# from the same in float64 in relative L2 norm (dwatt, dbatt: sums over
# every edge), the kernel up to 1.2e-3 from the float64 one, which is the
# reference, and the fp32 backward kernel 5.2e-3 or more on some gradient
# of every call.  So the gate (bf16_bwd_gate) is, per gradient tensor: the
# relative L2 norm of the difference within BF16_BWD_L2, or within
# BF16_BWD_NOISE times the distance of the plain bf16 backward in fp32
# where that is further (a sum that cancels: under some output gradients
# dbatt of v3b's first layer at [16, 88, 192], the plain in fp32 read 6.84
# times the L2 bound and the kernel 6.34); the gradients the backward
# rounds once per call (BF16_ROUNDED) bf16 values, an element one bf16
# step off taken as agreeing.  The fp32 backward kernel on the same calls
# must fail it on the gradients it does not round.  That gate does
# not pin the rounding points the backward adds (BF16_POINTS: "ds" the
# rounding of ds' = du W2'^T, "dm" that of the gradient of bf16(m), coef
# w', "mw" bf16(m), not m, in dwatt / dwout): the plain backward without
# the one of ds' read 0.63-0.99 of it.  So on the first call of each
# group each point is held apart (rounding_share): of the elements where
# the float64 references with and without the point differ, the kernel
# lies nearer the one with it on at least BF16_POINT_MIN; the plain bf16
# backward in fp32 without the point must not (the control), the one with
# it is recorded.  On the card kernels built without one point read
# 0.002-0.075, the kernel 0.974 or more, the plain in fp32 0.849 or more.
# The first call at [16, 88, 192] is also held to the gate under
# BF16_BWD_SEEDS output gradients.  (b) A fixed-noise
# micro-step pair in bf16, card against CPU
# (fixed_step_pair): the loss within BF16_TRAIN_RTOL, the gradient norm
# within BF16_TRAIN_NORM, the whole clipped gradient within BF16_TRAIN_L2
# in relative L2 norm, the card's fp32 pair against the CPU's bf16 one as
# the control that must fail (on the card: the bf16 pair 2.2e-4, 7.8e-3,
# 5.7e-2; the control 3.0e-3, 1.3e-1, 7.2e-1: a flipped rounding in the
# forward moves a bf16 step's gradient far more than its loss); then
# BF16_TRAIN_STEPS micro-steps of a bf16 and an fp32 Trainer on [dp] (a)'s
# training cut.
BF16_BWD_KERNELS = {"gcl_messages_bwd_bf16": "gcl_messages",
                    "edge_vector_reduce_bwd_bf16": "edge_vector_reduce"}
BF16_ROUNDED = ("w2", "watt", "wout")
BF16_BWD_L2, BF16_BWD_NOISE = 2.5e-3, 2.0
BF16_POINTS = ("ds", "dm", "mw")
BF16_POINT_MIN, BF16_BWD_SEEDS = 0.75, 8
BF16_BWD_MAIN = "88"          # the training shape the kernels line reads
BF16_TRAIN_RTOL, BF16_TRAIN_NORM, BF16_TRAIN_L2 = 1e-3, 3e-2, 0.2
BF16_TRAIN_STEPS = 8
# fanout-tap phase: the guidance fan-out's own row tile
# (SampleConfig.fanout_row_tile) and the trajectory frame tap on v3b's EMA
# weights at full width, on [modes] (d)'s crop of the synthetic receptor,
# with the facade's band at row tile FANOUT_TILE, capped at BAND_APPROX_W
# (DIFFNDM_BAND_APPROX, as the JAX bench's guided section runs it).  (a) a
# fixed-noise guided trajectory card vs CPU under the guided path gate, at
# FANOUT_CHECK_SIZES on the crop's FANOUT_CHECK_ATOMS atoms nearest its
# centre (the CPU's plain chain is dense over N^2 pairs: 2.3 s per
# row-forward at N = 372 on the card's host), T = FANOUT_CHECK_T with every
# event firing; (b)-(d) SPSA + ATP at B = N_SAMPLES, T = FANOUT_T, SPSA
# from FANOUT_SPSA_START (ATP's defaults), the field FANOUT_ROW against
# unset; (e) the SDF tap every TAP_EVERY steps of an unguided T_MAIN batch;
# the forwards timed per call over MODES_REPS calls
FANOUT_TILE, FANOUT_ROW, FANOUT_T, FANOUT_SPSA_START = 8, 16, 12, 10
FANOUT_CHECK_SIZES, FANOUT_CHECK_T, FANOUT_CHECK_ATOMS = (20,), 3, 192
FANOUT_CHECK = dict(spsa=dict(num_probes=2, start_step=1, every=1,
                              zeta0=5.0),
                    atp=dict(num_groups=3, start_step=0, every=1))
TAP_EVERY = 100
GCL_ARGS = ("a", "b", "d2c", "d2i", "adj", "we", "w2", "b2", "watt", "batt")
VEC_ARGS = ("a", "b", "d2c", "d2i", "adj", "x", "center", "we", "w2", "b2",
            "wout")
# what the kernel table keeps of a path's call check
CALL_KEYS = ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
# [B, N, H] of the edge-shape sweep; the last is large enough for blocks
# of several rows with a ragged last block
SWEEP_SHAPES = ((1, 7, 128), (3, 37, 192), (2, 50, 256), (24, 37, 128))


def log(*args):
    print(*args, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# work and bound of one kernel call
# ---------------------------------------------------------------------------

def call_cost(name, args, kw):
    """(operations, bytes) that the call's data needs: the matrix
    products and per-edge dot products of the edges with a nonzero
    adjacency among the rows computed, once per weight set; each input
    read once, the output written once."""
    pair = name == "edge_vector_reduce_pair"
    a, adj = (args[0][0] if pair else args[0]), args[4]
    bsz, n, h = a.shape
    n_sets = 2 if pair else 1
    rows = kw.get("n_rows")
    rows = n if rows is None else max(0, min(n, rows))
    edges = int((adj[:, :rows] != 0).sum())
    per_edge = 2 * h * h + 2 * h + (2 * h if name == "gcl_messages" else 30)
    node = n_sets * (bsz * rows * h + bsz * n * h)
    planes = 3 * bsz * rows * n
    weights = n_sets * (h * h + 5 * h)
    if name == "gcl_messages":
        out = bsz * n * h
        extra = 0
    else:
        out = bsz * n * 3
        extra = bsz * n * 3 + bsz * 3
    return (n_sets * edges * per_edge,
            4 * (node + planes + weights + extra + out))


def fp32_launches(K):
    """The fp32 kernels' launch counts, forward and backward; a bf16
    kernel launched in an fp32 phase fails the run."""
    if any(K.LAUNCHES[k] for k in (*BF16_KERNELS, *BF16_BWD_KERNELS)):
        raise AssertionError(f"a bf16 kernel launched in an fp32 phase: "
                             f"{K.LAUNCHES}")
    return {k: K.LAUNCHES[k] for k in (*KERNELS, *BWD_KERNELS)}


def forward_launches(K):
    """The forward kernels' launch counts; a backward kernel launched
    while sampling (which runs under no_grad) fails the run."""
    if any(K.LAUNCHES[k] for k in (*BWD_KERNELS, *BF16_BWD_KERNELS)):
        raise AssertionError(f"a backward kernel launched while sampling: "
                             f"{K.LAUNCHES}")
    return {k: K.LAUNCHES[k] for k in KERNELS}


def bound_ms(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_TF32_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def time_ms(torch, fn, reps, warmup=3, rounds=5):
    """Device time of one call: CUDA events around ``reps`` calls queued
    behind a long matrix product, so that the host has enqueued them all
    before the first may start and its own cost per call stays out of the
    number.  Median over ``rounds``."""
    if not hasattr(time_ms, "blocker"):
        time_ms.blocker = torch.ones((8192, 8192), device="cuda")
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(rounds):
        torch.mm(time_ms.blocker, time_ms.blocker)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def host_us(torch, fn, reps=200):
    """Host time of one call while the device queue has room."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / reps


def compare(torch, name, out, ref):
    """(max abs error, largest share of its tolerance that an element
    uses); raises where an element is beyond atol + rtol * |ref|."""
    err = (out - ref).abs()
    share = float((err / (KERNEL_ATOL + KERNEL_RTOL * ref.abs())).max())
    max_abs = float(err.max())
    if not bool(torch.isfinite(out).all()) or not share <= 1.0:
        raise AssertionError(
            f"{name}: kernel disagrees with its plain version: max abs "
            f"{max_abs:.3e}, {share:.2f} of atol {KERNEL_ATOL} + rtol "
            f"{KERNEL_RTOL}")
    return max_abs, share


def check_kernel(torch, K, name, args, kw, reps):
    kernel = getattr(K, name)
    plain = getattr(K, name + "_plain")
    out = kernel(*args, **kw)
    again = kernel(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{name}: two launches on the same inputs "
                             f"differ in their bits")
    ref = plain(*args, **kw)
    max_abs, share = compare(torch, name, out, ref)
    ms = time_ms(torch, lambda: kernel(*args, **kw), reps)
    plain_ms = time_ms(torch, lambda: plain(*args, **kw), max(3, reps // 10),
                       warmup=1, rounds=3)
    b_ms, b_by = bound_ms(*call_cost(name, args, kw))
    shape = list((args[0][0] if name.endswith("_pair") else args[0]).shape)
    blocks, per_block = K.launch_grid(name, *shape, kw.get("n_rows"))
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return dict(max_abs_err=max_abs, tolerance_share=share, ms=ms,
                host_us=host_us(torch, lambda: kernel(*args, **kw)),
                plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                shape=shape, blocks=blocks, rows_per_block=per_block,
                blocks_per_sm=blocks / n_sm)


def check_calls(torch, K, wrapper, calls, reps):
    """Every captured call of ``wrapper`` against its plain version; the
    first one also timed.  The result carries the worst error of all."""
    errs = []
    for _, args, kw in calls:
        out = getattr(K, wrapper)(*args, **kw)
        torch.cuda.synchronize()
        errs.append(compare(torch, wrapper, out,
                            getattr(K, wrapper + "_plain")(*args, **kw)))
    _, args, kw = calls[0]
    res = check_kernel(torch, K, wrapper, args, kw, reps)
    res["max_abs_err"] = max(e[0] for e in errs)
    res["tolerance_share"] = max(e[1] for e in errs)
    return res


def describe(res):
    return (f"max abs {res['max_abs_err']:.3e}, at most "
            f"{res['tolerance_share']:.2f} of the tolerance; kernel "
            f"{res['ms']:.4f} ms (host {res['host_us']:.1f} us per call), "
            f"plain "
            f"{res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']}, TF32 {PEAK_TF32_FLOPS / 1e12:.0f} TFLOP/s "
            f"or {PEAK_BYTES / 1e12:.2f} TB/s); grid {res['blocks']} blocks "
            f"of {res['rows_per_block']} rows, "
            f"{res['blocks_per_sm']:.2f} per SM")


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def first_state(torch, model, pocket, sizes):
    """The denoiser's arguments at the main path's first state (t = 1)."""
    from diffndm_tpu_torch.diffusion.core import init_ligand_from_pocket

    core = model.core
    nx, nh = core.cfg.norm_values
    lig_mask = model.sampler.ligand_mask(sizes, model.device)
    p_x = pocket.x / nx * pocket.mask[..., None]
    p_h = (pocket.h - core.cfg.norm_biases[1]) / nh * pocket.mask[..., None]
    g = torch.Generator(device=model.device).manual_seed(SEED)
    z, xh_p = init_ligand_from_pocket(core, p_x, p_h, lig_mask, pocket.mask,
                                      generator=g)
    t = torch.ones(z.shape[0], device=model.device)
    return z, xh_p, t, lig_mask, pocket.mask


def capture_kernel_calls(torch, K, model, pocket, sizes):
    """The kernel calls of one denoiser forward on the main path's first
    state (t = 1): the wrappers' arguments, recorded as given."""
    calls = []
    originals = {n: getattr(K, n) for n in WRAPPERS}

    def recorder(name):
        def fn(*args, **kw):
            calls.append((name, args, kw))
            return originals[name](*args, **kw)
        return fn

    state = first_state(torch, model, pocket, sizes)
    for n in WRAPPERS:
        setattr(K, n, recorder(n))
    try:
        with torch.no_grad():
            model.dynamics(*state)
    finally:
        for n, f in originals.items():
            setattr(K, n, f)
    return calls


def _single_set(pair_call):
    """An edge_vector_reduce call made of a pair call's first weight set
    (difference direction)."""
    _, args, kw = pair_call
    single = [args[0][0], args[1][0], *args[2:7], *(w[0] for w in args[7:])]
    return "edge_vector_reduce", single, dict(kw, cross=False)


def flagship_inputs(torch, name, device):
    """Seeded inputs at the flagship shapes: 24 ligand atoms inside a
    320-atom pocket at protein density, 5 A cutoffs (ligand-ligand
    complete), hidden 256."""
    rng = np.random.default_rng(SEED)
    bsz, nl, npk, h = 20, 24, 320, 256
    radius = (3 * npk / (4 * np.pi * 0.05)) ** (1 / 3)
    pts = rng.normal(size=(bsz, npk, 3))
    pts *= (radius * rng.uniform(size=(bsz, npk, 1)) ** (1 / 3)
            / np.linalg.norm(pts, axis=-1, keepdims=True))
    lig = rng.normal(size=(bsz, nl, 3)) * 1.5
    x = np.concatenate([lig, pts], 1).astype(np.float32)
    x0 = (x + rng.normal(size=x.shape) * 0.5).astype(np.float32)
    d2 = ((x[:, :, None] - x[:, None]) ** 2).sum(-1)
    is_lig = np.arange(nl + npk) < nl
    ll = is_lig[:, None] & is_lig[None, :]
    adj = (ll | (d2 <= 25.0)).astype(np.float32)

    def t(arr):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            device)

    n = nl + npk
    f32 = np.float32
    common = [t(rng.normal(size=(bsz, n, h)) * 0.5),
              t(rng.normal(size=(bsz, n, h)) * 0.5), t(d2),
              t(((x0[:, :, None] - x0[:, None]) ** 2).sum(-1)), t(adj)]
    we = t(rng.normal(size=(2, h)) * 0.05)
    w2 = t(rng.normal(size=(h, h)) / np.sqrt(h))
    b2 = t(rng.normal(size=(h,)) * 0.1)
    wvec = t(rng.normal(size=(h, 1)) / np.sqrt(h))
    if name == "gcl_messages":
        return common + [we, w2, b2, wvec, t(np.array([0.1], f32))], {}
    center = x.mean(1, keepdims=True)
    if name == "edge_vector_reduce":
        return (common + [t(x), t(center), we, w2, b2, wvec],
                dict(cross=True, n_rows=nl))
    second = [t(rng.normal(size=(bsz, n, h)) * 0.5),
              t(rng.normal(size=(bsz, n, h)) * 0.5),
              t(rng.normal(size=(2, h)) * 0.05),
              t(rng.normal(size=(h, h)) / np.sqrt(h)),
              t(rng.normal(size=(h,)) * 0.1),
              t(rng.normal(size=(h, 1)) / np.sqrt(h))]
    pairs = [(first, other) for first, other in
             zip(common[:2] + [we, w2, b2, wvec], second)]
    return ([pairs[0], pairs[1]] + common[2:] + [t(x), t(center)]
            + pairs[2:], dict(n_rows=nl))


def sweep_inputs(torch, device, bsz, n, h, seed):
    """Small ragged inputs: a random ~15 % adjacency with values in
    {0, 0.5, 1}, all-zero rows and (where B > 1) an all-zero batch
    element."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz, n, 3)) * 2
    x0 = x + rng.normal(size=x.shape) * 0.5
    adj = (rng.uniform(size=(bsz, n, n)) < 0.15) * rng.choice(
        [0.5, 1.0], size=(bsz, n, n))
    adj[:, rng.choice(n, size=max(1, n // 5), replace=False)] = 0.0
    if bsz > 1:
        adj[bsz - 1] = 0.0

    def t(arr):
        return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(
            device)

    def weight_set():
        return dict(a=t(rng.normal(size=(bsz, n, h)) * 0.5),
                    b=t(rng.normal(size=(bsz, n, h)) * 0.5),
                    we=t(rng.normal(size=(2, h)) * 0.05),
                    w2=t(rng.normal(size=(h, h)) / np.sqrt(h)),
                    b2=t(rng.normal(size=(h,)) * 0.1),
                    wvec=t(rng.normal(size=(h, 1)) / np.sqrt(h)))

    planes = [t(((x[:, :, None] - x[:, None]) ** 2).sum(-1)),
              t(((x0[:, :, None] - x0[:, None]) ** 2).sum(-1)), t(adj)]
    return dict(sets=[weight_set(), weight_set()], planes=planes, x=t(x),
                center=t(x.mean(1, keepdims=True)),
                batt=t(np.array([0.1])))


def sweep_cases(d, n):
    """(wrapper, args, options) of every case of the edge-shape sweep on
    ``sweep_inputs`` ``d``: n_rows in {0, 5, N}, every option on and
    off, attention with and without its bias."""
    s0, s1 = d["sets"]
    keys = ("we", "w2", "b2", "wvec")
    cases = [("gcl_messages",
              [s0["a"], s0["b"], *d["planes"], *(s0[k] for k in keys),
               batt], dict(attention=att))
             for att, batt in ((True, d["batt"]), (False, d["batt"]),
                               (True, None))]
    for n_rows in (0, 5, n):
        for tanh in (True, False):
            cases += [("edge_vector_reduce",
                       [s0["a"], s0["b"], *d["planes"], d["x"],
                        d["center"], *(s0[k] for k in keys)],
                       dict(tanh=tanh, cross=cross, n_rows=n_rows))
                      for cross in (False, True)]
            cases.append(("edge_vector_reduce_pair",
                          [(s0["a"], s1["a"]), (s0["b"], s1["b"]),
                           *d["planes"], d["x"], d["center"],
                           *((s0[k], s1[k]) for k in keys)],
                          dict(tanh=tanh, n_rows=n_rows)))
    return cases


def edge_shape_sweep(torch, K, device):
    """Each wrapper against its plain version where compaction and ragged
    tiles can break: odd sizes, empty rows, n_rows in {0, 5, N}, every
    option on and off."""
    n_cases, worst = 0, 0.0
    for seed, (bsz, n, h) in enumerate(SWEEP_SHAPES):
        d = sweep_inputs(torch, device, bsz, n, h, SEED + 10 + seed)
        for name, args, kw in sweep_cases(d, n):
            out = getattr(K, name)(*args, **kw)
            again = getattr(K, name)(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(out, again):
                raise AssertionError(f"{name} {kw} [{bsz}, {n}, {h}]: two "
                                     f"launches differ in their bits")
            ref = getattr(K, name + "_plain")(*args, **kw)
            worst = max(worst, compare(
                torch, f"{name} {kw} [{bsz}, {n}, {h}]", out, ref)[0])
            n_cases += 1
    log(f"[kernels] edge-shape sweep: {n_cases} cases at "
        f"{[list(s) for s in SWEEP_SHAPES]} within atol {KERNEL_ATOL} + rtol "
        f"{KERNEL_RTOL} of the plain versions, max abs {worst:.3e}, "
        f"repeat launches bit-identical")


def kernel_phase(torch, K, model, pocket, sizes):
    calls = capture_kernel_calls(torch, K, model, pocket, sizes)
    counts = {n: sum(1 for c in calls if c[0] == n) for n in WRAPPERS}
    log(f"[kernels] captured one forward's calls: {counts}")
    results = {}
    for wrapper, kernel in WRAPPERS.items():
        mine = [c for c in calls if c[0] == wrapper]
        if not mine:
            continue
        _, args, kw = mine[0]
        res = check_calls(torch, K, wrapper, mine, reps=50)
        res["entry"] = wrapper
        results[kernel] = res
        log(f"[kernels] main path {wrapper} {res['shape']} ({len(mine)} "
            f"calls checked, atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}): "
            f"{describe(res)}")
        if wrapper == "edge_vector_reduce_pair":
            # one weight set alone, the launch an earlier design made twice
            _, single, single_kw = _single_set(mine[0])
            alone = check_kernel(torch, K, "edge_vector_reduce", single,
                                 single_kw, reps=50)
            log(f"[kernels] main path edge_vector_reduce, first set alone: "
                f"{describe(alone)}")
        if wrapper == "gcl_messages":
            # what a launch costs when no edge is there to compute
            empty = list(args)
            empty[4] = torch.zeros_like(args[4])
            empty_ms = time_ms(torch,
                               lambda: K.gcl_messages(*empty, **kw), 50)
            log(f"[kernels] main path gcl_messages with an all-zero "
                f"adjacency (launch, compaction and the write of zeros): "
                f"{empty_ms:.4f} ms")
    missing = set(KERNELS) - set(results)
    if missing:
        raise AssertionError(f"the forward launched no {sorted(missing)}")
    for name in WRAPPERS:
        args, kw = flagship_inputs(torch, name, model.device)
        res = check_kernel(torch, K, name, args, kw, reps=10)
        log(f"[kernels] flagship {name} {res['shape']} {kw}: "
            f"{describe(res)}")
    edge_shape_sweep(torch, K, model.device)
    return results


def describe_cycles(K, name, args, kw):
    """Where the blocks of one call of the profile build spend their
    cycles (the forward kernels' spans; the bf16 kernel waits once per
    block for W2 and asks for nothing)."""
    getattr(K, name)(*args, **kw)
    K.read_profile()                        # warm, and clear
    getattr(K, name)(*args, **kw)
    c = K.read_profile()
    blocks, passes = max(c["blocks"], 1), max(c["passes"], 1)
    rest = c["loop"] - c["wait"] - c["request"] - c["mma"]
    return (f"{c['blocks']} blocks, {c['passes']} passes of 128 edges; "
            f"cycles per block: set-up and compaction "
            f"{c['setup'] / blocks:.0f}, loop {c['loop'] / blocks:.0f}, of "
            f"it waiting for W2 or its chunks {c['wait'] / blocks:.0f}; "
            f"per pass: asking for chunks {c['request'] / passes:.0f}, z "
            f"and the product {c['mma'] / passes:.0f}, epilogue "
            f"{rest / passes:.0f}")


def phase_cycles(torch, K, model, pocket, sizes):
    """Where a block's cycles go, per kernel call of the main path and of
    the flagship shapes, for the forward kernels and both epilogues of the
    backward (the build with -DEGNN_PROFILE; thread 0 of each block counts,
    so a phase's figure is what warp 0 saw)."""
    K.PROFILE_BUILD = True
    calls = capture_kernel_calls(torch, K, model, pocket, sizes)
    cases = []
    for name in ("gcl_messages", "edge_vector_reduce_pair"):
        _, args, kw = next(c for c in calls if c[0] == name)
        cases.append(("main path", name, args, kw))
        cases.append(("flagship", name,
                      *flagship_inputs(torch, name, model.device)))
    for label, name, args, kw in cases:
        for dtype in K.COMPUTE_DTYPES:
            log(f"[phases] {label} {name} {dtype}: "
                + describe_cycles(K, name, args, dict(kw,
                                                      compute_dtype=dtype)))
    # both epilogues of the backward, on the first call of each wrapper on
    # the main path and at the flagship shapes, under an output gradient
    # drawn from the seed
    for name in ("gcl_messages", "edge_vector_reduce_pair"):
        pair = name.endswith("_pair")
        for label, args, kw in (
                ("main path", *next(c[1:] for c in calls if c[0] == name)),
                ("flagship", *flagship_inputs(torch, name, model.device))):
            a0 = args[0][0] if pair else args[0]
            bsz, n, h = a0.shape
            gout = torch.randn((bsz, n, 3 if pair else h),
                               device=model.device,
                               generator=torch.Generator(device=model.device)
                               .manual_seed(SEED)) * 1e-2
            for bf16 in (False, True):
                log(f"[phases] {label} {name} backward"
                    f"{' bf16' if bf16 else ''} {list(a0.shape)}: "
                    + describe_bwd_cycles(torch, K, bwd_call(
                        K, name, args, kw, gout, bf16), bf16))
    K.PROFILE_BUILD = False


def describe_bwd_cycles(torch, K, call, bf16):
    """Where the blocks of one backward call spend their cycles (the
    build with -DEGNN_PROFILE, thread 0 of each block counting), and the
    device us of each kernel the call launches.  fp32
    (edge_chain_bwd_mma): the chunk loops of products (3) and (6), (5),
    the rest; bf16 (edge_chain_bwd_wgmma): the s' chain, product (3) and
    its epilogue, products (6) and (5), (6)'s epilogue, the sums."""
    call()
    K.read_bwd_profile()
    call()
    c = K.read_bwd_profile()
    blocks, passes = max(c["blocks"], 1), max(c["passes"], 1)
    text = (f"{c['blocks']} blocks, {c['passes']} passes; cycles per block "
            f"outside the passes (set-up, list, last writes) "
            f"{(c['block'] - c['pass']) / blocks:.0f}; per pass: ")
    if bf16:
        rest = (c["pass"] - c["chain"] - c["loops"] - c["dw2"] - c["ds"]
                - c["epi3"] - c["epi6"])
        text += (f"the s' chain {c['chain'] / passes:.0f}, (3) "
                 f"{c['loops'] / passes:.0f}, its epilogue "
                 f"{c['epi3'] / passes:.0f}, (6) {c['ds'] / passes:.0f}, "
                 f"(5) dW2 {c['dw2'] / passes:.0f}, (6)'s epilogue "
                 f"{c['epi6'] / passes:.0f}, the sums (7) and the rest "
                 f"{rest / passes:.0f}")
    else:
        rest = c["pass"] - c["loops"] - c["dw2"]
        text += (f"the chunk loops of (3) and (6) together "
                 f"{c['loops'] / passes:.0f}, (5) dW2 "
                 f"{c['dw2'] / passes:.0f}, epilogues and sums "
                 f"{rest / passes:.0f}")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            call()
        torch.cuda.synchronize()
    times = sorted(((getattr(ev, "self_device_time_total", 0)
                     or getattr(ev, "self_cuda_time_total", 0), ev.key)
                    for ev in prof.key_averages()), reverse=True)
    return text + "; device us per call: " + "; ".join(
        f"{k[:60]} {us / 5:.1f}" for us, k in times if us > 0)


def fixed_noise(torch, model, sizes, steps):
    from diffndm_tpu_torch.diffusion.sampler import SamplerNoise
    from diffndm_tpu_torch.structs import pad_to

    rng = np.random.default_rng(SEED + 1)
    nl = pad_to(int(max(sizes)), model.sample_cfg.lig_pad_multiple)
    shape = (len(sizes), nl, 3 + model.cfg.atom_nf)

    def normal(*lead):
        return torch.from_numpy(rng.standard_normal(lead + shape)
                                .astype(np.float32))
    return SamplerNoise(normal(), normal(steps), normal())


def path_check(torch, make_model, pair):
    """The same fixed-noise trajectory on the card (kernels) and on the
    CPU (plain versions)."""
    sizes = np.array([12, 18, 9, 24])
    out = {}
    for device in ("cuda", "cpu"):
        model = make_model(device)
        pocket = model.pocket_from_dataset(pair, len(sizes))
        noise = fixed_noise(torch, model, sizes, T_CHECK)
        res = model.sample_given_pocket(pocket, sizes, timesteps=T_CHECK,
                                        noise=noise)
        out[device] = [v.cpu() for v in (res.ligand.x, res.ligand.h,
                                         res.ligand.mask)]
    (xg, hg, mg), (xc, hc, mc) = out["cuda"], out["cpu"]
    err = float((xg - xc).abs().max())
    m = mc > 0.5
    same_types = bool(torch.equal(hg.argmax(-1)[m], hc.argmax(-1)[m]))
    log(f"[path] T={T_CHECK} fixed noise, B={len(sizes)}: max |x_cuda - "
        f"x_cpu| = {err:.3e} A (atol {PATH_COORD_ATOL}); atom types "
        f"identical: {same_types}")
    if not (err <= PATH_COORD_ATOL and same_types
            and bool(torch.isfinite(xg).all())):
        raise AssertionError("the kernel path disagrees with the plain path")


def main_path(torch, K, model, pockets, sizes):
    from diffndm_tpu_torch.chem.io import write_sdf

    K.reset_launches()
    mols, seconds, finite = [], [], True
    for pocket, n_lig in zip(pockets, sizes):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        g = torch.Generator(device=model.device).manual_seed(SEED)
        res = model.sample_given_pocket(pocket, n_lig, timesteps=T_MAIN,
                                        generator=g)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        finite &= all(bool(torch.isfinite(v).all()) for v in
                      (res.ligand.x, res.ligand.h, res.pocket.x))
        expect = (N_SAMPLES, -(-int(max(n_lig)) // 8) * 8, 3)
        if tuple(res.ligand.x.shape) != expect:
            raise AssertionError(f"ligand shape {tuple(res.ligand.x.shape)}"
                                 f" != {expect}")
        mols += model.result_to_molecules(res)
    launches = forward_launches(K)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ligands.sdf")
        write_sdf(path, mols)
        n_records = open(path).read().count("$$$$")
    n_atoms = [m.n_atoms for m in mols]
    connected = np.mean([len(m.fragments()) == 1 for m in mols])
    n_lig = int(sum(len(s) for s in sizes))
    log(f"[main] {len(pockets)} pockets x {N_SAMPLES} samples, T={T_MAIN}: "
        f"seconds per pocket {[round(s, 3) for s in seconds]}, "
        f"{n_lig / sum(seconds):.3f} ligands/s; {len(mols)} molecules "
        f"built ({n_records} SDF records, atoms {min(n_atoms)}-"
        f"{max(n_atoms)}, single-fragment share {connected:.3f}); "
        f"outputs finite: {finite}; launches {launches}")
    # per forward and layer: one gcl_messages, and one edge_vector_reduce
    # launch that takes the difference and the cross weight set together
    per_batch = {"gcl_messages": (T_MAIN + 1) * model.cfg.egnn.n_layers,
                 "edge_vector_reduce":
                     (T_MAIN + 1) * model.cfg.egnn.n_layers}
    want = {k: v * len(pockets) for k, v in per_batch.items()}
    if launches != want:
        raise AssertionError(f"launch counts {launches} != {want}")
    if not finite or len(mols) != n_lig or n_records != n_lig:
        raise AssertionError("main path outputs are incomplete")
    return launches


def event_noise(torch, model, sizes, steps):
    """Fixed noise for a guided trajectory: that of ``fixed_noise`` plus
    the draws of every guidance event the config fires."""
    from diffndm_tpu_torch.diffusion.sampler import guidance_events

    cfg = model.sample_cfg
    base = fixed_noise(torch, model, sizes, steps)
    rng = np.random.default_rng(SEED + 2)
    shape = tuple(base.init.shape)
    g_extra, k = cfg.atp.num_groups - 1, cfg.spsa.num_probes

    def normal(*shp):
        return torch.from_numpy(rng.standard_normal(shp).astype(np.float32))

    events = guidance_events(cfg, steps)
    return base._replace(
        atp={s: normal(g_extra, *shape) for s in events["atp"]},
        spsa={s: normal(k, *shape[:2], 3) for s in events["spsa"]},
        hybrid=(normal(g_extra, *shape), normal(g_extra, k, *shape[:2], 3)))


def guided_path_check(torch, make_model, pair, adjust=False):
    """The same fixed-noise guided trajectory (prunes, SPSA updates and
    the hybrid all fire) on the card and on the CPU: the same rows must
    survive, with the same atom types, at the same coordinates.  With
    ``adjust`` the AdjustNet (the same seeded weights on both devices)
    adjusts every step, and the log-prob proxies must agree too."""
    from diffndm_tpu_torch.config import (ATPConfig, SampleConfig,
                                          SPSAConfig)

    cfg = SampleConfig(pocket_pad_multiple=16,
                       spsa=SPSAConfig(enabled=True, **GUIDED_CHECK["spsa"]),
                       atp=ATPConfig(enabled=True, **GUIDED_CHECK["atp"]))
    sizes = np.array([12, 18, 9, 24])
    out = {}
    for device in ("cuda", "cpu"):
        model = make_model(device, cfg)
        if adjust:
            fc2 = model.ensure_adjust().module.fc2
            with torch.no_grad():
                fc2.weight.mul_(ADJUST_SCALE)
                fc2.bias.mul_(ADJUST_SCALE)
        pocket = model.pocket_from_dataset(pair, len(sizes))
        noise = event_noise(torch, model, sizes, T_GUIDED_CHECK)
        res = model.sample_given_pocket(pocket, sizes,
                                        timesteps=T_GUIDED_CHECK, noise=noise,
                                        optimize=adjust)
        out[device] = [v.cpu() for v in (res.ligand.x, res.ligand.h,
                                         res.ligand.mask, res.row_src,
                                         res.avg_log_prob)]
    (xg, hg, mg, rg, lg), (xc, hc, mc, rc, lc) = out["cuda"], out["cpu"]
    same_rows = bool(torch.equal(rg, rc) and torch.equal(mg, mc))
    err = float((xg - xc).abs().max()) if same_rows else float("inf")
    m = mc > 0.5
    same_types = same_rows and bool(
        torch.equal(hg.argmax(-1)[m], hc.argmax(-1)[m]))
    lp_rel = float((lg - lc).abs() / lc.abs().clamp_min(1e-30))
    label = "[cli] adjusted" if adjust else "[guided]"
    log(f"{label} path check, T={T_GUIDED_CHECK} fixed noise, "
        f"B={len(sizes)}: surviving rows cuda {rg.tolist()} cpu "
        f"{rc.tolist()}; max |x_cuda - x_cpu| = {err:.3e} A (atol "
        f"{PATH_COORD_ATOL}); atom types identical: {same_types}"
        + (f"; avg log-prob cuda {float(lg):.6f} cpu {float(lc):.6f} "
           f"(rel {lp_rel:.2e}, rtol {PATH_LP_RTOL})" if adjust else ""))
    if not (same_rows and same_types and err <= PATH_COORD_ATOL
            and bool(torch.isfinite(xg).all())):
        raise AssertionError(f"{label}: the kernel path disagrees with the "
                             "plain path")
    if adjust and not (lp_rel <= PATH_LP_RTOL and float(lc) < 0):
        raise AssertionError(f"{label}: the log-prob proxies disagree")


def guided_phase(torch, K, model, pockets, sizes):
    """The guided main path.  Returns its launch counts, the kernel calls
    of its first fused SPSA forward and the first population of that size
    it scored."""
    from diffndm_tpu_torch.diffusion.sampler import (count_forwards,
                                                     guidance_events)

    cfg, oracle = model.sample_cfg, model.oracle
    n_layers = model.cfg.egnn.n_layers
    fan_out = 2 * cfg.spsa.num_probes * N_SAMPLES
    calls, populations = [], []
    originals = {n: getattr(K, n) for n in WRAPPERS}

    def recorder(name):
        def fn(*args, **kw):
            a = args[0][0] if name.endswith("_pair") else args[0]
            if a.shape[0] == fan_out and \
                    sum(c[0] == name for c in calls) < n_layers:
                calls.append((name, args, kw))
            return originals[name](*args, **kw)
        return fn

    score = oracle.score_batch_types

    def recording_score(coords, types, mask, weights):
        if len(coords) == fan_out and not populations:
            populations.append((coords.copy(), types.copy(), mask.copy(),
                                weights))
        return score(coords, types, mask, weights)

    for n in WRAPPERS:
        setattr(K, n, recorder(n))
    oracle.score_batch_types = recording_score
    K.reset_launches()
    oracle.reset_counts()
    mols, seconds, finite = [], [], True
    try:
        for pocket, n_lig in zip(pockets, sizes):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = torch.Generator(device=model.device).manual_seed(SEED)
            res = model.sample_given_pocket(pocket, n_lig, timesteps=T_MAIN,
                                            generator=g)
            torch.cuda.synchronize()
            seconds.append(time.perf_counter() - t0)
            finite &= all(bool(torch.isfinite(v).all()) for v in
                          (res.ligand.x, res.ligand.h, res.pocket.x))
            expect = (N_SAMPLES, -(-int(max(n_lig)) // 8) * 8, 3)
            if tuple(res.ligand.x.shape) != expect:
                raise AssertionError(f"ligand shape "
                                     f"{tuple(res.ligand.x.shape)} != "
                                     f"{expect}")
            if not np.array_equal(
                    np.asarray(n_lig)[res.row_src.cpu().numpy()],
                    res.ligand.mask.sum(1).cpu().numpy()):
                raise AssertionError("a surviving row's mask is not its "
                                     "origin row's")
            mols += model.result_to_molecules(res)
    finally:
        del oracle.score_batch_types
        for n, f in originals.items():
            setattr(K, n, f)
    launches = forward_launches(K)

    events = guidance_events(cfg, T_MAIN)
    forwards = count_forwards(cfg, T_MAIN)
    g_extra = cfg.atp.num_groups - 1
    per_spsa = 1 if cfg.spsa.fuse_probes else cfg.spsa.num_probes
    scorings = (per_spsa * len(events["spsa"]) + 2 * len(events["atp"])
                + (2 + g_extra * per_spsa) * len(events["hybrid"]))
    n_lig = int(sum(len(s) for s in sizes))
    wall = sum(seconds)
    log(f"[guided] {len(pockets)} pockets x {N_SAMPLES} samples, T={T_MAIN}, "
        f"SPSA k={cfg.spsa.num_probes} + ATP G={cfg.atp.num_groups}: events "
        f"per pocket batch {dict((k, len(v)) for k, v in events.items())}, "
        f"{forwards} forwards; seconds per pocket batch "
        f"{[round(s, 3) for s in seconds]}, {n_lig / wall:.3f} ligands/s; "
        f"oracle: {oracle.n_calls} calls, {oracle.n_scored} molecules, "
        f"{oracle.seconds:.3f} s = {oracle.seconds / wall:.3f} of the wall "
        f"time, invalid rate {oracle.invalid_rate:.3f}, rows scored in "
        f"Python {oracle.n_python_rows}; {len(mols)} molecules built; "
        f"outputs finite: {finite}; launches {launches}")
    want = {k: forwards * n_layers * len(pockets) for k in launches}
    if launches != want:
        raise AssertionError(f"guided launch counts {launches} != {want}")
    if oracle.n_calls != scorings * len(pockets):
        raise AssertionError(f"{oracle.n_calls} reward calls, expected "
                             f"{scorings * len(pockets)}")
    if not finite or len(mols) != n_lig:
        raise AssertionError("guided path outputs are incomplete")
    if len(populations) != 1 or any(
            sum(c[0] == n for c in calls) != n_layers
            for n in ("gcl_messages", "edge_vector_reduce_pair")):
        raise AssertionError("no fused SPSA forward was captured")
    return launches, calls, populations[0], seconds


def fanout_phase(torch, K, calls):
    """Both kernels against their plain versions on the captured calls of
    one fused SPSA forward (every layer's call compared, the first timed)."""
    results = {}
    for wrapper in ("gcl_messages", "edge_vector_reduce_pair"):
        mine = [c for c in calls if c[0] == wrapper]
        res = check_calls(torch, K, wrapper, mine, reps=20)
        results[WRAPPERS[wrapper]] = res
        log(f"[kernels] fan-out {wrapper} {res['shape']} ({len(mine)} calls "
            f"of a fused SPSA forward checked, atol {KERNEL_ATOL} + rtol "
            f"{KERNEL_RTOL}): {describe(res)}")
    return results


def oracle_phase(model, population):
    """The native scorer against the Python scorer on one fan-out
    population of the guided run, each with one worker and with
    oracle_workers() of them."""
    from diffndm_tpu_torch.guidance.oracle import RewardOracle

    coords, types, mask, weights = population
    n_workers = oracle_workers()
    rewards, ms = {}, {}
    for scorer, workers, reps in (("native", 1, 5),
                                  ("native", n_workers, 5),
                                  ("python", 1, 1),
                                  ("python", n_workers, 1)):
        with RewardOracle(model.dataset_info, scorer=scorer,
                          num_workers=workers) as oracle:
            # warm: the pools start, and the first call fills caches
            oracle.score_batch_types(coords, types, mask, weights)
            times = []
            for _ in range(reps):
                t0 = time.perf_counter()
                r = oracle.score_batch_types(coords, types, mask, weights)
                times.append(1e3 * (time.perf_counter() - t0))
        rewards[scorer, workers] = r
        ms[scorer, workers] = float(np.median(times))
    ref = rewards["native", 1]
    equal = all(np.array_equal(r, ref) for r in rewards.values())
    log(f"[oracle] one fused SPSA population of {len(coords)} molecules "
        f"({int((ref > 0).sum())} valid): native and Python rewards, with 1 "
        f"and {n_workers} workers (os.cpu_count() {os.cpu_count()}), equal "
        f"bit for bit: {equal}; ms per {len(coords)} molecules (host): "
        + ", ".join(f"{scorer} x{w} {v:.2f}" for (scorer, w), v in
                    ms.items())
        + f"; native speed-up with {n_workers} threads "
        f"{ms['native', 1] / ms['native', n_workers]:.2f}x")
    if not equal:
        raise AssertionError("the rewards differ between scorers or worker "
                             "counts")


def oracle_workers() -> int:
    return min(8, os.cpu_count() or 1)


def guided_workers_phase(torch, make_model, guided_cfg, pocket, n_lig,
                         n_workers):
    """One guided pocket batch with the oracle on n_workers workers (as
    DIFFNDM_ORACLE_WORKERS sets it), then the same batch with one, in
    turn: seconds and oracle share of each."""
    rows = {}
    for workers in (n_workers, 1):
        os.environ["DIFFNDM_ORACLE_WORKERS"] = str(workers)
        try:
            model = make_model("cuda", guided_cfg)
        finally:
            del os.environ["DIFFNDM_ORACLE_WORKERS"]
        with model:
            oracle = model.oracle
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            g = torch.Generator(device=model.device).manual_seed(SEED)
            res = model.sample_given_pocket(pocket, n_lig, timesteps=T_MAIN,
                                            generator=g)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        rows[workers] = dict(seconds=wall, share=oracle.seconds / wall,
                             oracle_s=oracle.seconds, calls=oracle.n_calls,
                             scored=oracle.n_scored,
                             x=res.ligand.x.cpu(), finite=bool(
                                 torch.isfinite(res.ligand.x).all()))
    a, b = rows[n_workers], rows[1]
    same = bool(torch.equal(a["x"], b["x"]))
    log(f"[guided] workers: one pocket batch ({N_SAMPLES} samples, "
        + "; ".join(f"{w} worker{'s' * (w > 1)}: {r['seconds']:.3f} s, "
                    f"oracle {r['oracle_s']:.3f} s = {r['share']:.3f} of "
                    f"the wall, {r['calls']} calls, {r['scored']} molecules"
                    for w, r in rows.items())
        + f"); coordinates equal bit for bit: {same}")
    if not (a["finite"] and b["finite"] and a["calls"] == b["calls"]
            and a["scored"] == b["scored"]):
        raise AssertionError("[guided] the batch with oracle workers "
                             "differs from the one-worker batch")
    return rows


def quality_rows(torch, ds, models, seed):
    """One evaluation by the JAX package's guided-lift protocol: per model
    the summary row, and per pocket the single-fragment count and the
    number of distinct input rows its 16 ligands descend from (a global
    top-B prune replicates candidates, so a guided pocket batch can end as
    the offspring of a few rows)."""
    from diffndm_tpu_torch.chem.metrics import quality_summary

    picks = np.random.default_rng(0).choice(
        len(ds), size=N_QUALITY_POCKETS, replace=False)
    rows = {}
    for label, model in models.items():
        g_sizes = torch.Generator().manual_seed(seed)
        g = torch.Generator(device=model.device).manual_seed(seed)
        mols, connected, origins, t0 = [], [], [], time.perf_counter()
        for pi in picks:
            pocket = model.pocket_from_dataset(ds[int(pi)], N_SAMPLES)
            sizes = np.maximum(model.sample_ligand_sizes(pocket, g_sizes),
                               MIN_LIGAND_ATOMS)
            res = model.sample_given_pocket(pocket, sizes, timesteps=T_MAIN,
                                            generator=g)
            batch = model.result_to_molecules(res)
            connected.append(sum(len(m.fragments()) == 1 for m in batch))
            origins.append(len(set(res.row_src.tolist())))
            mols += batch
        torch.cuda.synchronize()
        rows[label] = dict(quality_summary(mols),
                           seconds=time.perf_counter() - t0)
        ref = JAX_ROWS[label.split()[0]]
        log(f"[quality] seed {seed} {label:8s} n={rows[label]['n']} in "
            f"{rows[label]['seconds']:.1f} s: "
            + ", ".join(f"{k} {rows[label][k]:.3f} (JAX {ref[k]:.3f})"
                        for k in ref)
            + f", logp {rows[label]['logp']:.3f}, lipinski "
            f"{rows[label]['lipinski']:.2f}; per pocket: single-fragment "
            f"ligands {connected}, distinct origin rows {origins}")
    return rows


def quality_spread(torch, ds, models):
    """The evaluation over QUALITY_SPREAD_SEEDS seeds: how far each metric
    moves with the random stream alone, which is what a difference between
    two builds of the kernels has to exceed."""
    runs = [quality_rows(torch, ds, models, SEED + 1 + i)
            for i in range(QUALITY_SPREAD_SEEDS)]
    for label in models:
        log(f"[quality] {label} over {len(runs)} seeds, min-max: "
            + ", ".join(f"{k} {min(r[label][k] for r in runs):.3f}-"
                        f"{max(r[label][k] for r in runs):.3f}"
                        for k in JAX_ROWS[label]))


def quality_phase(torch, ds, models):
    """The JAX package's guided-lift evaluation protocol on the card."""
    rows = quality_rows(torch, ds, models, SEED + 1)
    lifts = {k: rows["guided"][k] - rows["unguided"][k] for k in LIFT_FLOORS}
    log(f"[quality] guided lift: QED {lifts['qed']:+.3f} (JAX +0.105), SA "
        f"{lifts['sa']:+.3f} (JAX +0.244); floors {QUALITY_FLOORS}, lift "
        f"{LIFT_FLOORS}")
    missed = [f"{label} {k} {rows[label][k]:.3f} < {v}"
              for label, floors in QUALITY_FLOORS.items()
              for k, v in floors.items() if not rows[label][k] >= v]
    missed += [f"{k} lift {lifts[k]:.3f} < {v}"
               for k, v in LIFT_FLOORS.items() if not lifts[k] >= v]
    if missed:
        raise AssertionError(f"sample quality below its floors: {missed}")
    return rows


def step_phase(torch, K, model, pocket, sizes):
    """A T_STEP-step stretch of the sampler: CUDA events around every
    kernel wrapper call (the kernels on the loop's own, cold inputs), a
    host clock around the stretch, and a profiler trace of a second
    stretch for the device's busy time."""
    originals = {n: getattr(K, n) for n in WRAPPERS}
    events = {n: [] for n in WRAPPERS}

    def timed(name):
        def fn(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = originals[name](*args, **kw)
            end.record()
            events[name].append((start, end))
            return out
        return fn

    def stretch():
        g = torch.Generator(device=model.device).manual_seed(SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.sample_given_pocket(pocket, sizes, timesteps=T_STEP,
                                  generator=g)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    stretch()                                   # warm
    plain_wall = stretch()
    for n in WRAPPERS:
        setattr(K, n, timed(n))
    try:
        timed_wall = stretch()
    finally:
        for n, f in originals.items():
            setattr(K, n, f)
    forwards = T_STEP + 1
    per_step = {n: sum(a.elapsed_time(b) for a, b in ev) / forwards
                for n, ev in events.items() if ev}
    per_call = {n: per_step[n] * forwards / len(events[n]) for n in per_step}
    log(f"[step] {T_STEP} steps ({forwards} forwards), B={len(sizes)}: "
        f"{plain_wall / forwards:.4f} ms per step by the host clock "
        f"({timed_wall / forwards:.4f} with the events); kernel wrapper ms "
        f"per step inside the loop "
        f"{ {n: round(v, 4) for n, v in per_step.items()} }, sum "
        f"{sum(per_step.values()):.4f}; ms per call "
        f"{ {n: round(v, 4) for n, v in per_call.items()} } (events "
        f"around the wrapper: launch gaps included)")

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall = stretch()
    busy_us, ours_us, n_dev = 0.0, 0.0, 0
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            dur = ev.time_range.elapsed_us()
            busy_us += dur
            n_dev += 1
            if "edge_chain" in ev.name:
                ours_us += dur
    if n_dev == 0 or busy_us <= 0:
        log("[step] the profiler recorded no device activity: idle share "
            "not measured")
        return
    busy = busy_us / 1e3
    log(f"[step] profiler over {T_STEP} steps: {n_dev} device activities "
        f"({n_dev / forwards:.1f} per step), device busy "
        f"{busy / forwards:.4f} ms per step of which the edge-chain "
        f"kernels {ours_us / 1e3 / forwards:.4f}; wall "
        f"{prof_wall / forwards:.4f} ms per step while profiled; idle "
        f"share {1 - busy / prof_wall:.3f} (against the unprofiled wall: "
        f"{1 - busy / plain_wall:.3f})")


def write_pocket_files(pair, decoder, tmp, names=("pocket.pdb", "ref.sdf")):
    """A PDB file with one ALA residue per pocket atom (the element from
    the one-hot decoder, two-letter ones in capitals as PDB files write
    them) and the ligand as the reference SDF.  Returns their paths."""
    from diffndm_tpu_torch.chem.io import write_sdf
    from diffndm_tpu_torch.chem.mol import Molecule

    lines = []
    for i, (c, oh) in enumerate(zip(pair.pocket_coords,
                                    pair.pocket_one_hot)):
        el = decoder[int(oh.argmax())].upper()
        lines.append(f"ATOM  {i + 1:>5} {el:<4} ALA A{i + 1:>4}    "
                     f"{c[0]:8.3f}{c[1]:8.3f}{c[2]:8.3f}  1.00  0.00"
                     f"          {el:>2}")
    pdb, sdf = (os.path.join(tmp, n) for n in names)
    with open(pdb, "w") as f:
        f.write("\n".join(lines + ["END"]) + "\n")
    write_sdf(sdf, [Molecule([decoder[int(t)] for t in
                              pair.lig_one_hot.argmax(1)], [],
                             coords=pair.lig_coords.astype(np.float64))])
    return pdb, sdf


def pdb_pocket_check(torch, model, pair, pdb, sdf):
    """pocket_from_pdb against pocket_from_dataset on the atoms within
    the 8 A cutoff (the PDB holds coordinates to 1e-3 A)."""
    import dataclasses

    near = np.linalg.norm(pair.pocket_coords[:, None]
                          - pair.lig_coords[None], axis=-1).min(1) < 8.0
    kept = dataclasses.replace(pair, pocket_coords=pair.pocket_coords[near],
                               pocket_one_hot=pair.pocket_one_hot[near])
    out = model.pocket_from_pdb(pdb, sdf, N_SAMPLES)
    ref = model.pocket_from_dataset(kept, N_SAMPLES)
    same = (out.x.shape == ref.x.shape and torch.equal(out.h, ref.h)
            and torch.equal(out.mask, ref.mask))
    err = float((out.x - ref.x).abs().max()) if same else float("inf")
    log(f"[cli] pocket from the PDB file: {int(near.sum())} of "
        f"{len(near)} atoms within 8 A, [{out.x.shape[0]}, "
        f"{out.x.shape[1]}] rows on {out.x.device}; types and mask equal "
        f"to the dataset's: {same}; max coordinate difference {err:.1e} A")
    if not (same and err <= 5e-4 + 1e-6):
        raise AssertionError("pocket_from_pdb disagrees with "
                             "pocket_from_dataset")


def capture_forward_calls(K, row_counts, n_layers):
    """Wrapper replacements that record the first forward's calls for each
    row count: {rows: [(name, args, kw)]}.  Returns (calls, replacements,
    originals)."""
    calls = {r: [] for r in row_counts}
    originals = {n: getattr(K, n) for n in WRAPPERS}

    def recorder(name):
        def fn(*args, **kw):
            a = args[0][0] if name.endswith("_pair") else args[0]
            mine = calls.get(a.shape[0])
            if mine is not None and \
                    sum(c[0] == name for c in mine) < n_layers:
                mine.append((name, args, kw))
            return originals[name](*args, **kw)
        return fn

    return calls, {n: recorder(n) for n in WRAPPERS}, originals


def cli_phase(torch, K, ds, tmp):
    """The generate CLI in this process: SPSA + ATP, the AdjustNet
    adjusting and trained over CLI_LOOPS loops, sanitized SDF out.
    Returns the launch counts of the whole run and the kernels' checks
    against their plain versions on the calls of its first main-step
    forward and of its first fused SPSA forward."""
    from diffndm_tpu_torch.cli import generate
    from diffndm_tpu_torch.config import SPSAConfig
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.diffusion.sampler import count_forwards
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.models.adjust_net import AdjustNetState

    loops, updates = [], []
    originals = (DiffNDM.generate_ligands, AdjustNetState.reinforce)
    n_layers = v3b_layers()
    # forwards by their rows: the main step's B, the fused SPSA's 2kB (the
    # CLI runs SPSA at its defaults)
    rows = {N_SAMPLES: "main step",
            2 * SPSAConfig().num_probes * N_SAMPLES: "fused SPSA"}
    captured, recorders, wrappers = capture_forward_calls(K, rows, n_layers)

    def generate_ligands(self, *args, **kw):
        before = forward_launches(K)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mols, res = originals[0](self, *args, **kw)
        torch.cuda.synchronize()
        loops.append(dict(
            seconds=time.perf_counter() - t0, mols=mols, result=res,
            launches={k: v - before[k]
                      for k, v in forward_launches(K).items()},
            weights=[p.detach().clone() for p in
                     self.adjust_state.module.parameters()]))
        return mols, res

    def reinforce(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = originals[1](self, *args, **kw)
        torch.cuda.synchronize()
        updates.append(1e3 * (time.perf_counter() - t0))
        return out

    pdb, sdf = write_pocket_files(
        ds[CLI_POCKET], dataset_params["crossdock_full"]["atom_decoder"], tmp)
    out_sdf, ckpt = (os.path.join(tmp, n) for n in ("cli.sdf", "adjust.npz"))
    argv = [WEIGHTS, "--config", os.path.join(RUN, "hparams.yaml"),
            "--pdbfile", pdb, "--ref_ligand", sdf, "--outfile", out_sdf,
            "--n_samples", str(N_SAMPLES), "--SPSA", "1", "--SVDD", "1",
            "--optimize", "1", "--path_save", ckpt, "--rl_loops",
            str(CLI_LOOPS), "--sanitize", "--seed", str(SEED)]
    log(f"[cli] python -m diffndm_tpu_torch.cli.generate {' '.join(argv)}")
    DiffNDM.generate_ligands = generate_ligands
    AdjustNetState.reinforce = reinforce
    for n, f in recorders.items():
        setattr(K, n, f)
    K.reset_launches()
    try:
        model = generate.main(argv)
    finally:
        DiffNDM.generate_ligands, AdjustNetState.reinforce = originals
        for n, f in wrappers.items():
            setattr(K, n, f)
    launches = forward_launches(K)
    pdb_pocket_check(torch, model, ds[CLI_POCKET], pdb, sdf)

    cfg, oracle = model.sample_cfg, model.oracle
    timesteps = model.core.schedule.timesteps
    forwards = count_forwards(cfg, timesteps)
    want = {k: forwards * model.cfg.egnn.n_layers for k in KERNELS}
    history = model.adjust_state.history
    n_records = open(out_sdf).read().count("$$$$")
    n_kept = sum(m is not None for m in loops[-1]["mols"])
    changed = any(not torch.equal(a, b) for a, b in
                  zip(loops[0]["weights"], loops[1]["weights"]))
    reloaded = AdjustNetState(model.adjust_state.cfg, device=model.device)
    reloaded.load(ckpt)
    opt, opt2 = model.adjust_state.optimizer, reloaded.optimizer
    bit_exact = all(torch.equal(a, b) for a, b in zip(
        reloaded.module.parameters(), model.adjust_state.module.parameters()))
    bit_exact &= all(
        torch.equal(opt.state[p][k].cpu(), opt2.state[q][k].cpu())
        for p, q in zip(model.adjust_state.module.parameters(),
                        reloaded.module.parameters())
        for k in ("step", "exp_avg", "exp_avg_sq"))
    finite = all(np.isfinite(h).all() for h in history) and all(
        bool(torch.isfinite(lp["result"].ligand.x).all()) for lp in loops)
    seconds = [lp["seconds"] for lp in loops]
    log(f"[cli] {CLI_LOOPS} loops x {N_SAMPLES} ligands at T={timesteps}, "
        f"SPSA + ATP + AdjustNet: seconds per loop "
        f"{[round(x, 3) for x in seconds]}, "
        f"{N_SAMPLES * len(loops) / sum(seconds):.3f} ligands/s; RL update "
        f"ms {[round(x, 2) for x in updates]} (stacks "
        f"{list(loops[0]['result'].rl_traj[0].shape)}); (loss, grad norm, "
        f"reward) {[tuple(round(v, 5) for v in h) for h in history]}; "
        f"avg log-prob {[round(float(lp['result'].avg_log_prob), 5) for lp in loops]}; "
        f"oracle {oracle.n_calls} calls, {oracle.n_scored} molecules, "
        f"{oracle.seconds:.3f} s = {oracle.seconds / sum(seconds):.3f} of "
        f"the wall time, invalid rate {oracle.invalid_rate:.3f}; sizes of "
        f"the surviving rows "
        f"{sorted(int(v) for v in loops[0]['result'].ligand.mask.sum(1))}"
        f" (the built-in size prior); launches per loop "
        f"{[lp['launches'] for lp in loops]} (expected {want}: "
        f"{model.cfg.egnn.n_layers} x {forwards} forwards); {n_records} SDF records of {n_kept} "
        f"sanitized molecules; AdjustNet changed between loops: {changed}; "
        f"checkpoint reloads bit for bit: {bit_exact}")
    if any(lp["launches"] != want for lp in loops) or len(loops) != CLI_LOOPS:
        raise AssertionError(f"cli launch counts "
                             f"{[lp['launches'] for lp in loops]} != {want}")
    if not (finite and len(history) == CLI_LOOPS and len(updates) == CLI_LOOPS
            and n_records == n_kept > 0):
        raise AssertionError("cli outputs are incomplete or not finite")
    if not (changed and bit_exact):
        raise AssertionError("the AdjustNet was not trained or does not "
                             "reload from its checkpoint")

    checks = {}
    for r, label in rows.items():
        calls = captured[r]
        for wrapper in ("gcl_messages", "edge_vector_reduce_pair"):
            mine = [c for c in calls if c[0] == wrapper]
            if len(mine) != n_layers:
                raise AssertionError(f"[cli] {len(mine)} {wrapper} calls of "
                                     f"a {label} forward captured, expected "
                                     f"{n_layers}")
            res = check_calls(torch, K, wrapper, mine,
                              reps=100 if label == "main step" else 20)
            checks.setdefault(WRAPPERS[wrapper], {})[label] = res
            log(f"[kernels] cli {label} {wrapper} {res['shape']} "
                f"({len(mine)} calls checked, atol {KERNEL_ATOL} + rtol "
                f"{KERNEL_RTOL}): {describe(res)}")
    return launches, checks


def inpaint_batch(torch, model, pair, n_fixed, n_add, offsets):
    """Per row b: the first n_fixed[b] atoms of the pair's ligand fixed and
    n_add[b] atoms added, the whole input (ligand and pocket) translated
    by offsets[b] (A).  Returns (ligand, lig_fixed, pocket) on the model's
    device."""
    from diffndm_tpu_torch.structs import NodeBatch, pad_to

    b, nf = len(n_fixed), model.cfg.atom_nf
    nl = pad_to(max(f + a for f, a in zip(n_fixed, n_add)),
                model.sample_cfg.lig_pad_multiple)
    x = np.zeros((b, nl, 3), np.float32)
    h = np.zeros((b, nl, nf), np.float32)
    mask = np.zeros((b, nl), np.float32)
    fixed = np.zeros((b, nl), np.float32)
    off = np.asarray(offsets, np.float32)
    for i, (f, a) in enumerate(zip(n_fixed, n_add)):
        x[i, :f] = pair.lig_coords[:f] + off[i]
        h[i, :f] = pair.lig_one_hot[:f, :nf]
        mask[i, :f + a] = 1.0
        fixed[i, :f] = 1.0

    def t(arr):
        return torch.from_numpy(arr).to(model.device)

    pocket = model.pocket_from_dataset(pair, b)
    pocket = NodeBatch((pocket.x + t(off)[:, None]) * pocket.mask[..., None],
                       pocket.h, pocket.mask)
    return NodeBatch(t(x), t(h), t(mask)), t(fixed), pocket


def inpaint_path_check(torch, make_model, pair):
    """The same fixed-noise guided inpainting (an SPSA update and two
    prunes fire) on the card and on the CPU.  The rows differ (fixed and
    added atoms, a translation of the whole input per row), so that the
    surviving rows show in the masks and a per-row quantity gathered
    wrong shows in the coordinates."""
    from diffndm_tpu_torch.config import (ATPConfig, InpaintConfig,
                                          SampleConfig, SPSAConfig)
    from diffndm_tpu_torch.diffusion.inpaint import (InpaintNoise,
                                                     inpaint_events)

    cfg = SampleConfig(pocket_pad_multiple=16,
                       spsa=SPSAConfig(**INPAINT_CHECK["spsa"]),
                       atp=ATPConfig(**INPAINT_CHECK["atp"]),
                       inpaint=InpaintConfig(**INPAINT_CHECK["inpaint"]))
    steps, res_n = T_INPAINT_CHECK, R_INPAINT_CHECK
    events = inpaint_events(cfg, steps, True, True)
    if events != dict(spsa=[3], atp=[2, 0]):
        raise AssertionError(f"inpaint check events {events}")
    q = max(int(len(pair.lig_coords) * FRAG_FRACTION), 1)
    n_fixed = [q, max(q - 1, 1), q, max(q - 2, 1)]
    n_add = [q + 4 + b - f for b, f in enumerate(n_fixed)]
    offsets = [(0.0, 0.0, 0.0), (1.5, -0.5, 0.7), (-1.0, 2.0, 0.3),
               (0.4, 0.4, -1.2)]
    out = {}
    for device in ("cuda", "cpu"):
        model = make_model(device, cfg)
        ligand, fixed, pocket = inpaint_batch(torch, model, pair, n_fixed,
                                              n_add, offsets)
        shape = tuple(ligand.x.shape[:2]) + (3 + model.cfg.atom_nf,)
        rng = np.random.default_rng(SEED + 3)

        def normal(*shp):
            return torch.from_numpy(rng.standard_normal(shp)
                                    .astype(np.float32))

        noise = InpaintNoise(
            normal(*shape), normal(steps, res_n, *shape),
            normal(steps, res_n, *shape), normal(steps, res_n - 1, *shape),
            normal(*shape),
            spsa={s: normal(cfg.spsa.num_probes, *shape[:2], 3)
                  for s in events["spsa"]},
            atp={s: normal(cfg.atp.num_groups - 1, *shape)
                 for s in events["atp"]})
        res = model.inpaint(ligand, fixed, pocket, timesteps=steps,
                            resamplings=res_n, svdd=True, spsa=True,
                            noise=noise)
        out[device] = [v.cpu() for v in (res.ligand.x, res.ligand.h,
                                         res.ligand.mask, res.row_src,
                                         res.pocket.x)]
    (xg, hg, mg, rg, pg), (xc, hc, mc, rc, pc) = out["cuda"], out["cpu"]
    same_rows = bool(torch.equal(rg, rc) and torch.equal(mg, mc))
    err = (float(max((xg - xc).abs().max(), (pg - pc).abs().max()))
           if same_rows else float("inf"))
    m = mc > 0.5
    same_types = same_rows and bool(
        torch.equal(hg.argmax(-1)[m], hc.argmax(-1)[m]))
    log(f"[inpaint] path check, T={steps} x R={res_n} fixed noise, "
        f"B={len(n_fixed)}, SPSA at s {events['spsa']}, prunes at s "
        f"{events['atp']}: surviving rows cuda {rg.tolist()} cpu "
        f"{rc.tolist()}; max |x_cuda - x_cpu| = {err:.3e} A (ligand and "
        f"pocket, atol {PATH_COORD_ATOL}); atom types and masks identical: "
        f"{same_types}")
    if not (same_rows and same_types and err <= PATH_COORD_ATOL
            and bool(torch.isfinite(xg).all())):
        raise AssertionError("[inpaint]: the kernel path disagrees with the "
                             "plain path")


def v3b_layers():
    from diffndm_tpu_torch.config import load_yaml, model_config_from_yaml

    return model_config_from_yaml(load_yaml(os.path.join(
        RUN, "hparams.yaml"))).egnn.n_layers


def first_forward_recorder(K, n_layers):
    """Wrapper replacements that record the calls of the first forward:
    the first n_layers calls of each wrapper.  Returns (calls,
    replacements, originals)."""
    calls, originals = [], {n: getattr(K, n) for n in WRAPPERS}

    def recorder(name):
        def fn(*args, **kw):
            if sum(c[0] == name for c in calls) < n_layers:
                calls.append((name, args, kw))
            return originals[name](*args, **kw)
        return fn

    return calls, {n: recorder(n) for n in WRAPPERS}, originals


def check_first_forward(torch, K, label, calls, n_layers, reps):
    checks = {}
    for wrapper in ("gcl_messages", "edge_vector_reduce_pair"):
        mine = [c for c in calls if c[0] == wrapper]
        if len(mine) != n_layers:
            raise AssertionError(f"[{label}] {len(mine)} {wrapper} calls of "
                                 f"the first forward captured, expected "
                                 f"{n_layers}")
        res = check_calls(torch, K, wrapper, mine, reps=reps)
        checks[WRAPPERS[wrapper]] = res
        log(f"[kernels] {label} first forward {wrapper} {res['shape']} "
            f"({len(mine)} calls checked, atol {KERNEL_ATOL} + rtol "
            f"{KERNEL_RTOL}): {describe(res)}")
    return checks


def inpaint_cli_phase(torch, K, ds, tmp):
    """The inpaint CLI in this process on a PDB file and a fragment SDF
    made by the fix_ligand CLI.  Returns the launch counts of the run, the
    kernels' checks on the calls of its first forward, and the paths of
    the PDB file and of the ligand SDF."""
    from diffndm_tpu_torch.chem.bonds import build_molecule
    from diffndm_tpu_torch.chem.io import read_sdf, write_sdf
    from diffndm_tpu_torch.cli import fix_ligand, inpaint
    from diffndm_tpu_torch.config import SampleConfig
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.diffusion import inpaint as inpaint_module
    from diffndm_tpu_torch.diffusion.inpaint import count_inpaint_forwards
    from diffndm_tpu_torch.model import DiffNDM

    info = dataset_params["crossdock_full"]
    pair = ds[CLI_POCKET]
    pdb, sdf = write_pocket_files(pair, info["atom_decoder"], tmp)
    lig_dir = os.path.join(tmp, "ligands")
    os.makedirs(lig_dir)
    write_sdf(os.path.join(lig_dir, "ligand.sdf"), [build_molecule(
        pair.lig_coords, pair.lig_one_hot.argmax(1), info)])
    frag = fix_ligand.main([lig_dir, "--outdir", os.path.join(tmp, "frags"),
                            "--fraction", str(FRAG_FRACTION)])[0]
    frag_mol = read_sdf(frag)[0]
    n_layers = v3b_layers()
    calls, recorders, wrappers = first_forward_recorder(K, n_layers)
    runs, combine_s = [], []
    originals = (DiffNDM.inpaint, inpaint_module.repaint_combine)

    def timed_inpaint(self, *args, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = originals[0](self, *args, **kw)
        torch.cuda.synchronize()
        runs.append(dict(seconds=time.perf_counter() - t0, model=self))
        return res

    def timed_combine(*args, **kw):
        t0 = time.perf_counter()
        out = originals[1](*args, **kw)
        combine_s.append(time.perf_counter() - t0)
        return out

    out_sdf = os.path.join(tmp, "inpaint.sdf")
    argv = [WEIGHTS, "--config", os.path.join(RUN, "hparams.yaml"),
            "--pdbfile", pdb, "--outfile", out_sdf, "--fix_atoms", frag,
            "--add_n_nodes", str(ADD_NODES), "--n_samples", str(N_SAMPLES),
            "--timesteps", str(T_INPAINT), "--resamplings", str(R_INPAINT),
            "--svdd", "1", "--seed", str(SEED)]
    log(f"[inpaint] python -m diffndm_tpu_torch.cli.inpaint "
        f"{' '.join(argv)}")
    DiffNDM.inpaint, inpaint_module.repaint_combine = (timed_inpaint,
                                                       timed_combine)
    for n, f in recorders.items():
        setattr(K, n, f)
    K.reset_launches()
    try:
        res = inpaint.main(argv)
    finally:
        DiffNDM.inpaint, inpaint_module.repaint_combine = originals
        for n, f in wrappers.items():
            setattr(K, n, f)
    launches = forward_launches(K)
    model = runs[0]["model"]
    forwards = count_inpaint_forwards(SampleConfig(), T_INPAINT, R_INPAINT,
                                      True, False)
    want = {k: forwards * n_layers for k in KERNELS}

    nfix = frag_mol.n_atoms
    x = res.ligand.x.cpu().numpy()
    d_frag = np.linalg.norm(frag_mol.coords[:, None] - frag_mol.coords[None],
                            axis=-1)
    d_out = np.linalg.norm(x[:, :nfix, None] - x[:, None, :nfix], axis=-1)
    geometry = float(np.abs(d_out - d_frag[None]).max())
    sizes = res.ligand.mask.sum(1).cpu().numpy()
    n_records = open(out_sdf).read().count("$$$$")
    seconds = runs[0]["seconds"]
    iters = T_INPAINT * R_INPAINT
    oracle = model.oracle
    log(f"[inpaint] {N_SAMPLES} ligands, {nfix} fixed atoms of "
        f"{pair.lig_coords.shape[0]} + {ADD_NODES} added, T={T_INPAINT} x "
        f"R={R_INPAINT}, ATP G={model.sample_cfg.atp.num_groups}: "
        f"{seconds:.3f} s per {N_SAMPLES}-ligand batch, "
        f"{N_SAMPLES / seconds:.3f} ligands/s, "
        f"{1e3 * seconds / iters:.3f} ms per (s, u) iteration of which the "
        f"RePaint combine {1e3 * sum(combine_s) / iters:.3f} ms host time "
        f"({sum(combine_s) / seconds:.3f} of the wall); oracle "
        f"{oracle.n_calls} calls, {oracle.n_scored} molecules, "
        f"{oracle.seconds:.3f} s; surviving rows from "
        f"{len(set(res.row_src.tolist()))} input rows; max fixed-atom "
        f"distance change {geometry:.3f} A (atol {FIXED_GEOMETRY_ATOL}); "
        f"{n_records} SDF records; launches {launches} (expected {want}: "
        f"{n_layers} x {forwards} forwards)")
    if launches != want:
        raise AssertionError(f"inpaint launch counts {launches} != {want}")
    if not (bool(torch.isfinite(res.ligand.x).all()) and n_records ==
            N_SAMPLES and len(combine_s) == iters and
            np.all(sizes == nfix + ADD_NODES)):
        raise AssertionError("inpaint outputs are incomplete or not finite")
    if not geometry <= FIXED_GEOMETRY_ATOL:
        raise AssertionError("the fixed atoms did not keep their geometry")
    checks = check_first_forward(torch, K, "inpaint", calls, n_layers,
                                 reps=100)
    return launches, checks, (pdb, sdf)


def inpaint_quality_rows(torch, ds, model, seed):
    """One evaluation by the JAX package's inpaint-lift protocol: per mode
    the summary row over whole molecules (sanitized = valid)."""
    from diffndm_tpu_torch.chem.bonds import build_molecule
    from diffndm_tpu_torch.chem.metrics import MoleculeProperties
    from diffndm_tpu_torch.chem.sanitize import (SanitizeError,
                                                 connectivity_fraction,
                                                 sanitize)
    from diffndm_tpu_torch.structs import to_lists

    props = MoleculeProperties()
    model.ensure_oracle()
    picks = np.random.default_rng(0).choice(
        len(ds), size=N_QUALITY_POCKETS, replace=False)
    rows = {}
    for label, svdd in (("unguided", False), ("ATP", True)):
        g = torch.Generator(device=model.device).manual_seed(seed)
        vals, conn, origins, t0 = [], [], [], time.perf_counter()
        for pi in picks:
            pair = ds[int(pi)]
            q = max(int(len(pair.lig_coords) * FRAG_FRACTION), 1)
            ligand, fixed, pocket = inpaint_batch(
                torch, model, pair, [q] * N_SAMPLES, [ADD_NODES] * N_SAMPLES,
                [(0.0, 0.0, 0.0)] * N_SAMPLES)
            res = model.inpaint_sampler.inpaint(
                ligand, fixed, pocket, timesteps=T_INPAINT,
                resamplings=R_INPAINT, svdd=svdd, spsa=False, generator=g)
            origins.append(len(set(res.row_src.tolist())))
            for coords, types in to_lists(res.ligand):
                mol = build_molecule(coords, types, model.dataset_info)
                conn.append(connectivity_fraction(mol))
                try:
                    sanitize(mol)
                except SanitizeError:
                    continue
                vals.append((props.calculate_qed(mol),
                             props.calculate_sa(mol),
                             props.calculate_logp(mol)))
        torch.cuda.synchronize()
        arr = np.asarray(vals, float) if vals else np.zeros((1, 3))
        rows[label] = dict(n=len(conn), valid=len(vals) / max(len(conn), 1),
                           connectivity=float(np.mean(conn)),
                           qed=float(arr[:, 0].mean()),
                           sa=float(arr[:, 1].mean()),
                           logp=float(arr[:, 2].mean()),
                           seconds=time.perf_counter() - t0)
        ref = JAX_INPAINT_ROWS[label]
        log(f"[inpaint-quality] seed {seed} {label:8s} n={rows[label]['n']} "
            f"in {rows[label]['seconds']:.1f} s: "
            + ", ".join(f"{k} {rows[label][k]:.3f} (JAX {ref[k]:.3f})"
                        for k in ref)
            + f"; distinct origin rows per pocket {origins}")
    return rows


def inpaint_quality_phase(torch, ds, model):
    rows = inpaint_quality_rows(torch, ds, model, SEED + 1)
    lift = rows["ATP"]["qed"] - rows["unguided"]["qed"]
    log(f"[inpaint-quality] ATP lift: QED {lift:+.3f} (JAX +0.117); floors "
        f"{INPAINT_FLOORS}, lift {INPAINT_LIFT_FLOOR}")
    missed = [f"{label} {k} {rows[label][k]:.3f} < {v}"
              for label, floors in INPAINT_FLOORS.items()
              for k, v in floors.items() if not rows[label][k] >= v]
    if not lift >= INPAINT_LIFT_FLOOR:
        missed.append(f"QED lift {lift:.3f} < {INPAINT_LIFT_FLOOR}")
    if missed:
        raise AssertionError(f"inpainting quality below its floors: "
                             f"{missed}")
    return rows


def inpaint_quality_spread(torch, ds, model):
    runs = [inpaint_quality_rows(torch, ds, model, SEED + 1 + i)
            for i in range(QUALITY_SPREAD_SEEDS)]
    for label in JAX_INPAINT_ROWS:
        log(f"[inpaint-quality] {label} over {len(runs)} seeds, min-max: "
            + ", ".join(f"{k} {min(r[label][k] for r in runs):.3f}-"
                        f"{max(r[label][k] for r in runs):.3f}"
                        for k in JAX_INPAINT_ROWS[label]))
    lifts = [r["ATP"]["qed"] - r["unguided"]["qed"] for r in runs]
    log(f"[inpaint-quality] QED lift over {len(runs)} seeds: "
        f"{min(lifts):.3f}-{max(lifts):.3f}")


def optimize_phase(torch, K, tmp, pdb, sdf):
    """The optimize CLI in this process.  Returns its launch counts and
    the kernels' checks on the calls of its first diversify forward."""
    from diffndm_tpu_torch.chem.io import read_sdf
    from diffndm_tpu_torch.cli import optimize

    n_layers = v3b_layers()
    calls, recorders, wrappers = first_forward_recorder(K, n_layers)
    out_sdf = os.path.join(tmp, "optimized.sdf")
    argv = [WEIGHTS, "--config", os.path.join(RUN, "hparams.yaml"),
            "--pdbfile", pdb, "--ref_ligand", sdf, "--outfile", out_sdf,
            "--objective", "qed", "--population_size", str(OPT_POPULATION),
            "--timesteps", str(OPT_STEPS), "--evolution_steps",
            str(OPT_GENERATIONS), "--seed", str(SEED)]
    log(f"[optimize] python -m diffndm_tpu_torch.cli.optimize "
        f"{' '.join(argv)}")
    for n, f in recorders.items():
        setattr(K, n, f)
    K.reset_launches()
    try:
        history = optimize.main(argv)
    finally:
        for n, f in wrappers.items():
            setattr(K, n, f)
    launches = forward_launches(K)
    want = {k: OPT_GENERATIONS * (OPT_STEPS + 1) * n_layers for k in KERNELS}
    n_best = len(read_sdf(out_sdf))
    log(f"[optimize] population {OPT_POPULATION}, {OPT_STEPS} noising "
        f"steps: per generation best QED "
        f"{[round(h['best'], 4) for h in history]}, mean QED "
        f"{[round(h['mean'], 4) for h in history]}, seconds "
        f"{[round(h['seconds'], 3) for h in history]}; {n_best} molecules "
        f"written; launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"optimize launch counts {launches} != {want}")
    if not (len(history) == OPT_GENERATIONS and n_best > 0 and all(
            0.0 < h["mean"] <= h["best"] <= 1.0 for h in history)):
        raise AssertionError("optimize outputs are incomplete")
    checks = check_first_forward(torch, K, "optimize", calls, n_layers,
                                 reps=20)
    return launches, checks


def diversify_path_check(torch, make_model, pair):
    """The same fixed-noise diversification on the card and on the CPU."""
    from diffndm_tpu_torch.data.pocket import ligand_node_batch
    from diffndm_tpu_torch.diffusion.diversify import DiversifyNoise
    from diffndm_tpu_torch.structs import repeat_batch

    b, out = 4, {}
    for device in ("cuda", "cpu"):
        model = make_model(device)
        enc = {k: v for k, v in model.dataset_info["atom_encoder"].items()
               if v < model.cfg.atom_nf}
        ligand = repeat_batch(ligand_node_batch(
            pair.lig_coords, pair.lig_one_hot[:, :model.cfg.atom_nf]
            .argmax(1), enc, model.sample_cfg.lig_pad_multiple,
            device=model.device), b)
        pocket = model.pocket_from_dataset(pair, b)
        rng = np.random.default_rng(SEED + 4)
        shape = tuple(ligand.x.shape[:2]) + (3 + model.cfg.atom_nf,)

        def normal(*shp):
            return torch.from_numpy(rng.standard_normal(shp)
                                    .astype(np.float32))

        noise = DiversifyNoise(normal(*shape),
                               normal(T_DIVERSIFY_CHECK, *shape),
                               normal(*shape))
        res = model.diversify(ligand, pocket, T_DIVERSIFY_CHECK, noise=noise)
        out[device] = [v.cpu() for v in (res.ligand.x, res.ligand.h,
                                         res.ligand.mask)]
    (xg, hg, mg), (xc, hc, mc) = out["cuda"], out["cpu"]
    err = float((xg - xc).abs().max())
    m = mc > 0.5
    same = bool(torch.equal(mg, mc) and torch.equal(hg.argmax(-1)[m],
                                                    hc.argmax(-1)[m]))
    log(f"[optimize] diversify path check, {T_DIVERSIFY_CHECK} steps fixed "
        f"noise, B={b}: max |x_cuda - x_cpu| = {err:.3e} A (atol "
        f"{PATH_COORD_ATOL}); atom types identical: {same}")
    if not (same and err <= PATH_COORD_ATOL
            and bool(torch.isfinite(xg).all())):
        raise AssertionError("[optimize]: the kernel path disagrees with "
                             "the plain path")


def sweep_phase(torch, K, ds, tmp):
    """The sweep CLI in this process over SWEEP_POCKETS written as PDB +
    SDF pairs (the ligands with perceived bonds, which the inpainting
    fragments need): (a) --batch_pockets 4 at T=500, (b) per pocket with
    oversampling and --sanitize, (c) --inpaint with ATP at T=60 x 10;
    each output directory through the evaluate CLI; (a) again with
    --resume.  Returns the launch counts of (a) and the kernels' checks on
    the calls of its first forward."""
    from diffndm_tpu_torch.chem.bonds import build_molecule
    from diffndm_tpu_torch.chem.io import read_sdf, write_sdf
    from diffndm_tpu_torch.chem.sanitize import is_valid
    from diffndm_tpu_torch.cli import evaluate, sweep
    from diffndm_tpu_torch.config import SampleConfig
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.diffusion.inpaint import count_inpaint_forwards
    from diffndm_tpu_torch.diffusion.sampler import count_forwards
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.structs import concat_batches

    info = dataset_params["crossdock_full"]
    test_dir = os.path.join(tmp, "pockets")
    os.makedirs(test_dir)
    for idx in SWEEP_POCKETS:
        pair = ds[idx]
        _, sdf = write_pocket_files(pair, info["atom_decoder"], test_dir,
                                    (f"p{idx:03d}.pdb", f"p{idx:03d}.sdf"))
        write_sdf(sdf, [build_molecule(pair.lig_coords,
                                       pair.lig_one_hot.argmax(1), info)])
    n_layers = v3b_layers()
    per_gen = count_forwards(SampleConfig(), T_MAIN) * n_layers
    per_inpaint = count_inpaint_forwards(SampleConfig(), T_INPAINT,
                                         R_INPAINT, True, False) * n_layers
    modes = [("a", ["--batch_pockets", str(len(SWEEP_POCKETS))],
              len(SWEEP_POCKETS), per_gen),
             ("b", ["--max_pockets", "2", "--oversample_maxiter", "2",
                    "--sanitize"], 2, per_gen),
             ("c", ["--inpaint", "--SVDD", "1", "--max_pockets", "2",
                    "--timesteps", str(T_INPAINT), "--resamplings",
                    str(R_INPAINT)], 2, per_inpaint)]
    # host seconds of each generation call, the device work included, and
    # the model that made it
    gen_s, models = [], []
    originals = {m: getattr(DiffNDM, m) for m in
                 ("generate_ligands", "generate_ligands_multi", "inpaint")}

    def timed(method):
        def fn(self, *args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = originals[method](self, *args, **kw)
            torch.cuda.synchronize()
            gen_s.append(time.perf_counter() - t0)
            models.append(self)
            return out
        return fn

    checks, launches_a = None, None
    for label, flags, n_pockets, per_call in modes:
        outdir = os.path.join(tmp, f"sweep_{label}")
        argv = [WEIGHTS, "--config", os.path.join(RUN, "hparams.yaml"),
                "--test_dir", test_dir, "--outdir", outdir, "--n_samples",
                str(N_SAMPLES), "--seed", str(SEED), *flags]
        log(f"[sweep] ({label}) python -m diffndm_tpu_torch.cli.sweep "
            f"{' '.join(argv)}")
        calls, recorders, wrappers = first_forward_recorder(K, n_layers)
        if label == "a":
            for n, f in recorders.items():
                setattr(K, n, f)
        for m in originals:
            setattr(DiffNDM, m, timed(m))
        gen_s.clear()
        K.reset_launches()
        try:
            summary = sweep.main(argv)
        finally:
            for n, f in wrappers.items():
                setattr(K, n, f)
            for m, f in originals.items():
                setattr(DiffNDM, m, f)
        launches = forward_launches(K)
        want = {k: summary["generations"] * per_call for k in KERNELS}
        outputs = sorted(f for f in os.listdir(outdir) if f.endswith(".sdf"))
        mols = [read_sdf(os.path.join(outdir, f)) for f in outputs]
        n_valid = [sum(map(is_valid, m)) for m in mols]
        n_mols = sum(len(m) for m in mols)
        with open(os.path.join(outdir, "pocket_times.txt")) as f:
            times = f.read().splitlines()
        aggregate = evaluate.main([outdir, "--expected_per_file",
                                   str(N_SAMPLES)]).splitlines()[-1]
        wall = sum(gen_s)
        log(f"[sweep] ({label}) {summary}: {len(gen_s)} generation calls "
            f"{[round(t, 3) for t in gen_s]} s, {wall / len(outputs):.3f} s "
            f"per pocket, {n_mols / wall:.3f} ligands/s; molecules per "
            f"pocket {[len(m) for m in mols]}, valid per pocket {n_valid}; "
            f"pocket_times.txt {times}; launches {launches} (expected "
            f"{want})")
        log(f"[sweep] ({label}) evaluate: {aggregate}")
        if summary["retries"] or summary["skipped"] or \
                len(outputs) != n_pockets:
            raise AssertionError(f"[sweep] ({label}) retried, skipped or "
                                 f"missed a pocket: {summary}")
        if launches != want or (label == "a" and summary["generations"]
                                != 1):
            raise AssertionError(f"[sweep] ({label}) launch counts "
                                 f"{launches} != {want}")
        if not aggregate.startswith("AGGREGATE over "):
            raise AssertionError(f"[sweep] ({label}) no valid molecule")
        if label == "a":
            launches_a = launches
            checks = check_first_forward(torch, K, "sweep (a)", calls,
                                         n_layers, reps=20)
            del calls
            if any(c["shape"][0] != len(SWEEP_POCKETS) * N_SAMPLES
                   for c in checks.values()):
                raise AssertionError("[sweep] (a) ran in more than one "
                                     "batch")
            K.reset_launches()
            again = sweep.main(argv + ["--resume"])
            log(f"[sweep] (a) again with --resume: {again}; launches "
                f"{dict(K.LAUNCHES)}")
            if again["resumed"] != len(SWEEP_POCKETS) or again[
                    "generations"] or any(K.LAUNCHES.values()):
                raise AssertionError("[sweep] --resume did not skip every "
                                     "pocket")
            # where a step of the 64-row batch spends its time
            model = models[0]
            pocket = concat_batches([model.pocket_from_pdb(
                os.path.join(test_dir, f"p{i:03d}.pdb"),
                os.path.join(test_dir, f"p{i:03d}.sdf"), N_SAMPLES)
                for i in sorted(SWEEP_POCKETS)])
            step_phase(torch, K, model, pocket, model.sample_ligand_sizes(
                pocket, torch.Generator().manual_seed(SEED)))
        models.clear()
    return launches_a, checks


# ---------------------------------------------------------------------------
# structure-based scoring and docking
# ---------------------------------------------------------------------------

def write_synthetic_receptor(path, centre, seed=SEED):
    """A seeded synthetic receptor as PDB: standard residues (their PDB
    heavy-atom names, cycling through the 20 types), each a 1.5 A random
    walk from a site of a jittered 5.5 A lattice of SYNTH_SITES^3 sites
    centred on `centre`, without the residues that reach into a
    SYNTH_CAVITY A sphere there.  A size check for the pose search, not a
    protein.  Returns its heavy-atom count."""
    rng = np.random.default_rng(seed)
    names = sorted(RESIDUE_ATOMS)
    axis = (np.arange(SYNTH_SITES) - (SYNTH_SITES - 1) / 2) * 5.5
    sites = np.stack(np.meshgrid(axis, axis, axis, indexing="ij"),
                     -1).reshape(-1, 3) + np.asarray(centre)
    lines, resi = [], 0
    for k, site in enumerate(sites):
        resname = names[k % len(names)]
        pos = site + rng.normal(size=3) * 0.8
        atoms = []
        for name in RESIDUE_ATOMS[resname].split():
            atoms.append((name, pos))
            step = rng.normal(size=3)
            pos = pos + 1.5 * step / np.linalg.norm(step)
        if min(np.linalg.norm(p - centre) for _, p in atoms) < SYNTH_CAVITY:
            continue
        resi += 1
        for name, p in atoms:
            lines.append(f"ATOM  {len(lines) + 1:>5}  {name:<3} {resname} "
                         f"A{resi:>4}    {p[0]:8.3f}{p[1]:8.3f}{p[2]:8.3f}"
                         f"  1.00  0.00           {name[0]}")
    with open(path, "w") as f:
        f.write("\n".join(lines + ["END"]) + "\n")
    return len(lines)


def vina_phase(torch, K, ds, tmp):
    """The generate CLI in this process with the affinity term
    (--SPSA 1 --SVDD 1 --w_vina W_VINA) on pocket CLI_POCKET as PDB + SDF,
    VINA_SAMPLES rows at T=500, with DIFFNDM_ORACLE_WORKERS=8: every
    affinity batch must stay in this process.  Launch counts, the kernels
    on the calls of the first main-step and fused SPSA forwards, seconds
    per batch, the oracle's share, and one recorded reward batch rescored
    by a fresh oracle on the CPU.  Returns (launches, checks, pdb, sdf,
    written SDF)."""
    from diffndm_tpu_torch.cli import generate
    from diffndm_tpu_torch.config import SPSAConfig
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.diffusion.sampler import count_forwards
    from diffndm_tpu_torch.guidance.oracle import RewardOracle

    info = dataset_params["crossdock_full"]
    pdb, sdf = write_pocket_files(ds[CLI_POCKET], info["atom_decoder"], tmp,
                                  ("vina.pdb", "vina_ref.sdf"))
    out_sdf = os.path.join(tmp, "vina.sdf")
    n_layers = v3b_layers()
    rows = {VINA_SAMPLES: "main step",
            2 * SPSAConfig().num_probes * VINA_SAMPLES: "fused SPSA"}
    calls, recorders, wrappers = capture_forward_calls(K, rows, n_layers)
    recorded, score = [], RewardOracle.score_batch_types

    def recording(self, coords, types, mask, weights):
        out = score(self, coords, types, mask, weights)
        if not recorded:
            recorded.append((coords, types, mask, weights, out,
                             self._processes))
        return out

    argv = [WEIGHTS, "--config", os.path.join(RUN, "hparams.yaml"),
            "--pdbfile", pdb, "--ref_ligand", sdf, "--outfile", out_sdf,
            "--n_samples", str(VINA_SAMPLES), "--SPSA", "1", "--SVDD", "1",
            "--w_vina", str(W_VINA), "--seed", str(SEED)]
    log(f"[vina] python -m diffndm_tpu_torch.cli.generate {' '.join(argv)}")
    env = os.environ.get("DIFFNDM_ORACLE_WORKERS")
    os.environ["DIFFNDM_ORACLE_WORKERS"] = "8"
    for n, f in recorders.items():
        setattr(K, n, f)
    RewardOracle.score_batch_types = recording
    K.reset_launches()
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model = generate.main(argv)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    finally:
        RewardOracle.score_batch_types = score
        for n, f in wrappers.items():
            setattr(K, n, f)
        if env is None:
            del os.environ["DIFFNDM_ORACLE_WORKERS"]
        else:
            os.environ["DIFFNDM_ORACLE_WORKERS"] = env
    launches = forward_launches(K)
    oracle = model.oracle
    forwards = count_forwards(model.sample_cfg, model.core.schedule.timesteps)
    want = {k: forwards * n_layers for k in KERNELS}
    coords, types, mask, weights, rewards, pool = recorded[0]
    cpu = RewardOracle(info, scorer="python", num_workers=0)
    cpu.set_receptor(pdb)
    again = cpu.score_batch_types(coords, types, mask, weights)
    plain = cpu.score_batch_types(coords, types, mask, weights[:6])
    n_records = open(out_sdf).read().count("$$$$")
    log(f"[vina] {VINA_SAMPLES} ligands at T={model.core.schedule.timesteps}"
        f", SPSA + ATP, w_vina {W_VINA}: {seconds:.3f} s for the batch, "
        f"{VINA_SAMPLES / seconds:.3f} ligands/s; oracle {oracle.n_calls} "
        f"calls, {oracle.n_scored} rows scored row by row in this process "
        f"(worker pool: "
        f"{'none' if oracle._processes is None else 'made'}), "
        f"{oracle.seconds:.3f} s = {oracle.seconds / seconds:.3f} of the "
        f"wall time, invalid rate {oracle.invalid_rate:.3f}; first reward "
        f"batch of {len(rewards)} rows rescored on the CPU: equal "
        f"{bool(np.array_equal(again, rewards))}, "
        f"{int((again != plain).sum())} rows moved by the affinity term; "
        f"launches {launches} (expected {want}: {n_layers} x {forwards} "
        f"forwards); {n_records} SDF records")
    if launches != want:
        raise AssertionError(f"[vina] launch counts {launches} != {want}")
    if oracle.scorer is None or oracle._processes is not None or \
            pool is not None or oracle.n_python_rows:
        raise AssertionError("[vina] the affinity batches left this "
                             "process or had no receptor")
    if not (np.array_equal(again, rewards) and (again != plain).any()
            and weights[6] == W_VINA and n_records > 0):
        raise AssertionError("[vina] rewards differ from the CPU rescoring "
                             "or carry no affinity term")
    checks = {}
    for r, label in rows.items():
        for name, res in check_first_forward(
                torch, K, f"vina {label}", calls[r], n_layers,
                reps=100 if label == "main step" else 20).items():
            checks.setdefault(name, {})[label] = res
    return launches, checks, pdb, sdf, out_sdf


def optimize_vina_phase(torch, K, tmp, pdb, sdf):
    """The optimize CLI in this process with --objective vina against the
    pocket PDB: launch counts, the kernels on the first diversify
    forward's calls, the best score against a fresh rescoring of the best
    molecule written, seconds per generation."""
    from diffndm_tpu_torch.chem.io import read_sdf
    from diffndm_tpu_torch.chem.scoring import VinaScorer
    from diffndm_tpu_torch.cli import optimize

    n_layers = v3b_layers()
    calls, recorders, wrappers = first_forward_recorder(K, n_layers)
    out_sdf = os.path.join(tmp, "optimized_vina.sdf")
    argv = [WEIGHTS, "--config", os.path.join(RUN, "hparams.yaml"),
            "--pdbfile", pdb, "--ref_ligand", sdf, "--outfile", out_sdf,
            "--objective", "vina", "--population_size", str(OPT_POPULATION),
            "--timesteps", str(OPT_STEPS), "--evolution_steps",
            str(OPT_GENERATIONS), "--seed", str(SEED)]
    log(f"[optimize-vina] python -m diffndm_tpu_torch.cli.optimize "
        f"{' '.join(argv)}")
    for n, f in recorders.items():
        setattr(K, n, f)
    K.reset_launches()
    try:
        history = optimize.main(argv)
    finally:
        for n, f in wrappers.items():
            setattr(K, n, f)
    launches = forward_launches(K)
    want = {k: OPT_GENERATIONS * (OPT_STEPS + 1) * n_layers for k in KERNELS}
    best = read_sdf(out_sdf)
    rescored = -VinaScorer.from_pdb(pdb).score(best[0]) if best else None
    log(f"[optimize-vina] population {OPT_POPULATION}, {OPT_STEPS} noising "
        f"steps: per generation best -affinity "
        f"{[round(h['best'], 4) for h in history]} (the best written, "
        f"rescored: {rescored}), mean {[h['mean'] for h in history]} (-inf "
        f"where a molecule does not sanitize), seconds "
        f"{[round(h['seconds'], 3) for h in history]}; {len(best)} "
        f"molecules written; launches {launches} (expected {want})")
    if launches != want:
        raise AssertionError(f"optimize-vina launch counts {launches} != "
                             f"{want}")
    if not (len(history) == OPT_GENERATIONS and best
            and abs(rescored - history[-1]["best"]) < 1e-2):
        raise AssertionError("[optimize-vina] outputs are incomplete or "
                             "the best score is not its molecule's")
    checks = check_first_forward(torch, K, "optimize-vina", calls, n_layers,
                                 reps=20)
    return launches, checks


def dock_draws(mols, n_restarts, k_rounds, box_size, seed):
    """Per bucket, PoseDraws from a numpy generator (host arrays, the same
    on every device)."""
    from diffndm_tpu_torch.chem import dock

    rng = np.random.default_rng(seed)
    half = box_size / 2.0
    out = {}
    for key, items in sorted(dock.bucket_molecules(mols).items()):
        lead = (len(items), n_restarts)
        shapes = (lead + (3,), lead + (4,), lead + (key[1],))

        def f32(a):
            return a.astype(np.float32)

        out[key] = dock.PoseDraws(
            f32(rng.uniform(-half, half, shapes[0])),
            f32(rng.standard_normal(shapes[1])),
            f32(rng.uniform(-np.pi, np.pi, shapes[2])),
            [tuple(f32(rng.standard_normal(s)) for s in shapes)
             for _ in range(k_rounds)])
    return out


def dock_phase(torch, ds, tmp, pdb, vina_sdf):
    """The evaluate CLI with --receptor --dock on [vina]'s SDF on the card;
    then dock_molecules of those molecules against a synthetic receptor:
    the card against the CPU on the same draws in a short search, and the
    default search (DOCK_RESTARTS restarts, 200 steps, 1 MC round) timed,
    profiled and its peak memory read."""
    from diffndm_tpu_torch.chem import dock
    from diffndm_tpu_torch.chem.io import read_sdf
    from diffndm_tpu_torch.chem.scoring import VinaScorer
    from diffndm_tpu_torch.cli import evaluate

    t0 = time.perf_counter()
    report = evaluate.main([vina_sdf, "--receptor", pdb, "--dock",
                            "--dock_restarts", str(DOCK_RESTARTS)])
    torch.cuda.synchronize()
    line = report.splitlines()[0]
    log(f"[dock] evaluate --receptor --dock on the card, "
        f"{time.perf_counter() - t0:.3f} s: {line}")
    if " dock~=" not in line or not np.isfinite(
            float(line.split(" dock~=")[1])):
        raise AssertionError("[dock] evaluate --dock gave no affinity")

    centre = ds[CLI_POCKET].lig_coords.mean(0)
    rec_pdb = os.path.join(tmp, "synthetic_receptor.pdb")
    n_atoms = write_synthetic_receptor(rec_pdb, centre)
    scorer = VinaScorer.from_pdb(rec_pdb)
    mols = [m for m in read_sdf(vina_sdf) if m.n_atoms]
    buckets = dock.bucket_molecules(mols)
    crops, crop = [], dock.receptor_crop

    def recording_crop(*args, **kw):
        out = crop(*args, **kw)
        crops.append(len(out[0]))
        return out

    # card vs CPU: the same draws, a short search
    draws = dock_draws(mols, DOCK_CHECK_RESTARTS, 1, 20.0, SEED + 40)
    short = {device: dock.dock_molecules(
        mols, scorer, n_restarts=DOCK_CHECK_RESTARTS, steps=DOCK_CHECK_STEPS,
        mc_rounds=1, device=device, draws=draws) for device in ("cuda",
                                                                "cpu")}
    coord_err = max(float(np.abs(a.coords - b.coords).max())
                    for a, b in zip(short["cuda"], short["cpu"]))
    aff_err = max(float(np.abs(a.all_affinities - b.all_affinities).max())
                  for a, b in zip(short["cuda"], short["cpu"]))
    same_best = all(
        int(a.all_affinities.tolist().index(a.affinity))
        == int(b.all_affinities.tolist().index(b.affinity))
        for a, b in zip(short["cuda"], short["cpu"]))
    log(f"[dock] synthetic receptor: {n_atoms} heavy atoms, a "
        f"{SYNTH_CAVITY} A cavity at pocket {CLI_POCKET}'s ligand centre; "
        f"{len(mols)} molecules of [vina] in {len(buckets)} buckets "
        f"{sorted(buckets)}; card vs CPU, {DOCK_CHECK_RESTARTS} restarts, "
        f"{DOCK_CHECK_STEPS} + {DOCK_CHECK_STEPS // 2} steps, the same "
        f"draws: max |coords| difference {coord_err:.3e} A, max affinity "
        f"difference {aff_err:.3e} (atol {DOCK_CHECK_ATOL}); the same best "
        f"restart: {same_best}")
    if not (same_best and coord_err <= DOCK_CHECK_ATOL
            and aff_err <= DOCK_CHECK_ATOL):
        raise AssertionError("[dock] the card's search disagrees with the "
                             "CPU's")

    def search():
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = dock.dock_molecules(mols, scorer, n_restarts=DOCK_RESTARTS,
                                  steps=DOCK_STEPS, mc_rounds=1, seed=SEED)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    search()                                          # warm
    dock.receptor_crop = recording_crop
    try:
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        results, wall = search()
        peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    finally:
        dock.receptor_crop = crop
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        _, prof_wall = search()
    busy_us, n_dev, by_name = 0.0, 0, {}
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            dur = ev.time_range.elapsed_us()
            busy_us += dur
            n_dev += 1
            by_name[ev.name] = by_name.get(ev.name, 0.0) + dur
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    steps = DOCK_STEPS + DOCK_STEPS // 2
    restart_steps = len(mols) * DOCK_RESTARTS * steps
    affs = [r.affinity for r in results]
    busy = busy_us / 1e6
    log(f"[dock] dock_molecules, {len(mols)} molecules x {DOCK_RESTARTS} "
        f"restarts, {DOCK_STEPS} + {DOCK_STEPS // 2} steps (1 MC round): "
        f"{wall:.3f} s per call ({restart_steps / wall:.0f} restart-steps/"
        f"s), receptor crops {crops} atoms, peak device memory "
        f"{peak:.1f} MiB above its inputs; profiler: {n_dev} device "
        f"activities, device busy {busy:.3f} s of {prof_wall:.3f} s wall, "
        f"idle share {1 - busy / prof_wall:.3f} (against the unprofiled "
        f"wall: {1 - busy / wall:.3f}); best affinities "
        f"{[round(a, 3) for a in affs]} (synthetic receptor: a size check, "
        f"not a quality number)")
    log(f"[dock] the device time by kernel, largest first: "
        + "; ".join(f"{name[:60]} {us / 1e6:.3f} s "
                    f"({us / max(busy_us, 1e-9):.3f})" for name, us in top))
    if not (crops and min(crops) >= 1500 and np.isfinite(affs).all()
            and n_dev > 0):
        raise AssertionError("[dock] the crop is under 1500 atoms, an "
                             "affinity is not finite or nothing ran on "
                             "the device")
    return dict(seconds=wall, restart_steps_per_s=restart_steps / wall,
                busy_s=busy, idle=1 - busy / prof_wall, peak_mib=peak,
                crops=crops, buckets=len(buckets))


# ---------------------------------------------------------------------------
# joint mode and every committed configuration
# ---------------------------------------------------------------------------

def seeded_tree(torch, cfg):
    """Seeded random weights of a config's denoiser (its own init under
    torch.manual_seed(SEED)) as the JAX package's flat parameter tree,
    which params_from_jax carries into a model on any device."""
    from diffndm_tpu_torch.convert import params_to_jax
    from diffndm_tpu_torch.models.dynamics import EGNNDynamics

    torch.manual_seed(SEED)
    return params_to_jax(EGNNDynamics(cfg.egnn, cfg.atom_nf,
                                      cfg.residue_nf).state_dict())


def seeded_model(torch, path, device, **kw):
    """DiffNDM of a config on ``device`` with the config's seeded random
    weights."""
    from diffndm_tpu_torch.config import load_yaml, model_config_from_yaml
    from diffndm_tpu_torch.convert import params_from_jax
    from diffndm_tpu_torch.model import DiffNDM

    cfg = model_config_from_yaml(load_yaml(path))
    model = DiffNDM(cfg, device=device, scorer="python", **kw)
    model.dynamics.load_state_dict(params_from_jax(seeded_tree(torch, cfg)),
                                   strict=True)
    return model


def joint_receptor(ds, tmp):
    """The synthetic receptor of [dock] around test pocket CLI_POCKET's
    ligand as PDB, and that ligand as the reference SDF."""
    from diffndm_tpu_torch.constants import dataset_params

    pair = ds[CLI_POCKET]
    _, sdf = write_pocket_files(pair, dataset_params["crossdock_full"][
        "atom_decoder"], tmp, ("unused.pdb", "joint_ref.sdf"))
    pdb = os.path.join(tmp, "joint_receptor.pdb")
    n_atoms = write_synthetic_receptor(pdb, pair.lig_coords.mean(0))
    return pdb, sdf, n_atoms


def joint_ligand(torch, model, pair, b):
    """The pair's ligand as a padded batch of b equal rows."""
    from diffndm_tpu_torch.data.pocket import ligand_node_batch
    from diffndm_tpu_torch.structs import repeat_batch

    enc = model.dataset_info["atom_encoder"]
    types = pair.lig_one_hot.argmax(1)
    lig = ligand_node_batch(pair.lig_coords, types,
                            {k: v for k, v in enc.items()
                             if v < model.cfg.atom_nf},
                            model.sample_cfg.lig_pad_multiple,
                            device=model.device)
    return repeat_batch(lig, b)


def joint_draws(torch, lm, pm, model, count, seed):
    """``count`` seeded joint draws (raw standard normals) for the masks'
    shapes, on the CPU."""
    rng = np.random.default_rng(seed)
    b, nl = lm.shape
    npk = pm.shape[1]
    fl, fp = 3 + model.cfg.atom_nf, 3 + model.cfg.residue_nf

    def normal(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
    return [(normal(b, nl, fl), normal(b, npk, fp)) for _ in range(count)]


def joint_com(lig, poc):
    """Largest |joint centre of mass| over the batch, A."""
    ml, mp = lig.mask[..., None], poc.mask[..., None]
    total = (lig.x * ml).sum(1) + (poc.x * mp).sum(1)
    return float((total / (ml.sum(1) + mp.sum(1))).abs().max())


def fixed_geometry(pocket_in, pocket_out):
    """Largest change of a fixed pocket's internal distances, A."""
    m = pocket_in.mask[0] > 0.5
    a, b = pocket_in.x[0][m], pocket_out.x[0][m]
    return float(((a[:, None] - a[None]).norm(dim=-1)
                  - (b[:, None] - b[None]).norm(dim=-1)).abs().max())


def n_rows_of(calls):
    return sorted({str(c[2].get("n_rows")) for c in calls
                   if c[0] == "edge_vector_reduce_pair"})


def joint_first_calls(torch, K, model, b):
    """The kernel calls of the joint sampler's first forward (t = T, on the
    joint noise) at b rows, sizes from the model's size prior."""
    n_layers = model.cfg.egnn.n_layers
    n_lig, n_poc = model.size_distribution.sample(
        b, torch.Generator().manual_seed(SEED))
    n_lig, n_poc = np.maximum(n_lig, 2), np.maximum(n_poc, 1)
    calls, recorders, wrappers = first_forward_recorder(K, n_layers)
    for n, f in recorders.items():
        setattr(K, n, f)
    try:
        # one step: its forward is at t = T / T, as a run of any length
        # starts
        model.joint_sampler.sample(n_lig, n_poc, timesteps=1, generator=(
            torch.Generator(device=model.device).manual_seed(SEED)))
    finally:
        for n, f in wrappers.items():
            setattr(K, n, f)
    return calls


def joint_path_check(torch, ds):
    """Fixed-noise joint sampling (T_JOINT_CHECK steps) and joint RePaint
    (T_JOINT_CHECK x JOINT_R, jumps of JOINT_J) on the card (kernels)
    against the CPU (plain versions), B=2 at small sizes (the plain chain
    is dense over N^2 pairs)."""
    from diffndm_tpu_torch.diffusion.joint import count_joint_draws

    pair = ds[CLI_POCKET]
    n_lig, n_poc = np.array(JOINT_CHECK_SIZES).T
    out = {}
    for device in ("cuda", "cpu"):
        model = seeded_model(torch, JOINT_CONFIG, device)
        lm, pm = model.joint_sampler._masks(n_lig, n_poc, 8, 32,
                                            model.device)
        lig, poc = model.joint_sampler.sample(
            n_lig, n_poc, timesteps=T_JOINT_CHECK, noise=joint_draws(
                torch, lm, pm, model, count_joint_draws(T_JOINT_CHECK),
                SEED + 50))
        ligand = joint_ligand(torch, model, pair, 2)
        pocket = model.pocket_from_dataset(pair, 2)
        count = count_joint_draws(T_JOINT_CHECK, JOINT_R, JOINT_J,
                                  inpaint=True)
        ilig, ipoc = model.joint_sampler.inpaint(
            ligand, pocket, torch.zeros_like(ligand.mask), pocket.mask,
            resamplings=JOINT_R, jump_length=JOINT_J,
            timesteps=T_JOINT_CHECK, noise=joint_draws(
                torch, ligand.mask, pocket.mask, model, count, SEED + 51))
        out[device] = [[t.cpu() for t in nb] for nb in (lig, poc, ilig,
                                                        ipoc)]
    errs, same = [], True
    for g, c in zip(out["cuda"], out["cpu"]):
        errs.append(float((g[0] - c[0]).abs().max()))
        m = c[2] > 0.5
        same &= bool(torch.equal(g[1].argmax(-1)[m], c[1].argmax(-1)[m]))
        same &= bool(torch.isfinite(g[0]).all())
    log(f"[joint] fixed-noise path, B=2, sizes (ligand, pocket) "
        f"{JOINT_CHECK_SIZES}: sample T={T_JOINT_CHECK} max |x_cuda - x_cpu|"
        f" ligand {errs[0]:.3e} A, pocket {errs[1]:.3e} A; inpaint of test "
        f"pocket {CLI_POCKET} (pocket fixed, ligand free) T={T_JOINT_CHECK} "
        f"x R={JOINT_R}, jumps of {JOINT_J}: ligand {errs[2]:.3e} A, pocket "
        f"{errs[3]:.3e} A (atol {PATH_COORD_ATOL}); types identical and "
        f"finite: {same}")
    if not (max(errs) <= PATH_COORD_ATOL and same):
        raise AssertionError("[joint] the kernel path disagrees with the "
                             "plain path")


def joint_phase(torch, K, ds, tmp):
    """[joint]: configs/crossdock_fullatom_joint.yml at its published width
    on seeded random weights.  (a) JointSampler.sample, B=JOINT_B, sizes
    from the default joint size prior, T=JOINT_T; (b) JointSampler.inpaint
    with the whole pocket fixed (the synthetic receptor's full-atom crop
    around pocket CLI_POCKET's ligand) and the ligand free, T=JOINT_T x
    R=JOINT_R, jumps of JOINT_J.  Launch counts, seconds, the kernels on
    the calls of each run's first forward against their plain versions,
    the joint centre of mass and the fixed pocket's geometry; then the
    fixed-noise path check.  Returns (launches, checks) per run and the
    receptor files."""
    from diffndm_tpu_torch.diffusion.joint import count_joint_forwards

    model = seeded_model(torch, JOINT_CONFIG, "cuda")
    n_layers = model.cfg.egnn.n_layers
    pdb, sdf, n_rec = joint_receptor(ds, tmp)
    n_lig, n_poc = model.size_distribution.sample(
        JOINT_B, torch.Generator().manual_seed(SEED))
    n_lig, n_poc = np.maximum(n_lig, 2), np.maximum(n_poc, 1)
    pocket = model.pocket_from_pdb(pdb, sdf, JOINT_B)
    ligand = joint_ligand(torch, model, ds[CLI_POCKET], JOINT_B)
    runs = {
        "sample": (lambda g: model.joint_sampler.sample(
            n_lig, n_poc, timesteps=JOINT_T, generator=g),
                   count_joint_forwards(JOINT_T), JOINT_T),
        "inpaint": (lambda g: model.joint_sampler.inpaint(
            ligand, pocket, torch.zeros_like(ligand.mask), pocket.mask,
            resamplings=JOINT_R, jump_length=JOINT_J, timesteps=JOINT_T,
            generator=g),
                    count_joint_forwards(JOINT_T, JOINT_R, JOINT_J),
                    count_joint_forwards(JOINT_T, JOINT_R, JOINT_J) - 1)}
    results = {}
    for label, (run, forwards, steps) in runs.items():
        calls, recorders, wrappers = first_forward_recorder(K, n_layers)
        for n, f in recorders.items():
            setattr(K, n, f)
        K.reset_launches()
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lig, poc = run(torch.Generator(device="cuda").manual_seed(SEED))
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        finally:
            for n, f in wrappers.items():
                setattr(K, n, f)
        launches = forward_launches(K)
        want = {k: n_layers * forwards for k in KERNELS}
        com = joint_com(lig, poc)
        finite = all(bool(torch.isfinite(t).all()) for t in (*lig, *poc))
        onehot = bool(torch.equal(poc.h.sum(-1), poc.mask))
        shape = list(calls[0][1][0].shape)
        geometry = fixed_geometry(pocket, poc) if label == "inpaint" \
            else None
        log(f"[joint] ({label}) B={JOINT_B}, ligand sizes "
            f"{n_lig.tolist() if label == 'sample' else int(ligand.mask[0].sum())}"
            f", pocket sizes "
            f"{n_poc.tolist() if label == 'sample' else int(pocket.mask[0].sum())}"
            f" ({n_rec} receptor atoms), [B, N, H] = {shape}: {seconds:.3f} s "
            f"per batch, {1e3 * seconds / forwards:.3f} ms per denoiser "
            f"forward ({steps} steps + the decode); launches {launches} "
            f"(expected {want}: {n_layers} x {forwards} forwards); pair "
            f"n_rows {n_rows_of(calls)}; joint centre of mass {com:.2e} A "
            f"(atol {JOINT_COM_ATOL}); fixed pocket's largest distance "
            f"change {geometry} A (atol {JOINT_GEOMETRY_ATOL}); finite "
            f"{finite}, pocket types one-hot {onehot}")
        if launches != want:
            raise AssertionError(f"[joint] ({label}) launch counts "
                                 f"{launches} != {want}")
        if n_rows_of(calls) != ["None"]:
            raise AssertionError(f"[joint] ({label}) the pair kernel did not "
                                 f"take every row: {n_rows_of(calls)}")
        if not (finite and onehot and com <= JOINT_COM_ATOL):
            raise AssertionError(f"[joint] ({label}) outputs not finite, "
                                 f"types not one-hot or the centre of mass "
                                 f"off zero")
        if geometry is not None and not geometry <= JOINT_GEOMETRY_ATOL:
            raise AssertionError("[joint] (inpaint) the fixed pocket did not "
                                 "keep its geometry")
        checks = check_first_forward(torch, K, f"joint {label}", calls,
                                     n_layers, reps=10)
        del calls
        results[label] = dict(launches=launches, checks=checks,
                              seconds=seconds, forwards=forwards)
    joint_path_check(torch, ds)
    return results, (pdb, sdf)


def joint_train_loss(torch, model, ds, pdb, sdf):
    """[joint-train]'s joint loss at B=JOINT_TRAIN_B (the synthetic
    receptor's crop and pocket CLI_POCKET's ligand, seeded t and noise),
    as a function of no arguments."""
    from diffndm_tpu_torch.train.losses import joint_loss_terms

    core = model.joint_sampler.core
    lig = joint_ligand(torch, model, ds[CLI_POCKET], JOINT_TRAIN_B)
    poc = model.pocket_from_pdb(pdb, sdf, JOINT_TRAIN_B)
    # t >= 1: the error terms, not the t = 0 reconstruction, carry the
    # denoiser's gradient
    rng = np.random.default_rng(SEED + 60)
    t_int = torch.from_numpy(rng.integers(1, JOINT_T + 1, JOINT_TRAIN_B)
                             .astype(np.float32)).to(model.device)
    noise = joint_draws(torch, lig.mask, poc.mask, model, 1, SEED + 61)[0]
    keys = ("error_t_lig", "error_t_pocket", "loss_0_x", "loss_0_x_pocket",
            "kl_prior")

    def loss_value():
        terms = joint_loss_terms(core, model.dynamics, lig, poc, True,
                                 t_int, noise)
        return sum(terms[k].mean() for k in keys)
    return loss_value


def joint_train_phase(torch, K, ds, pdb, sdf):
    """[joint-train]: one joint loss value (``joint_train_loss``) and its
    gradient through the CUDA backward kernels: launch counts; the loss
    against the plain forward on the card; each backward call against the
    plain backward per gradient tensor (the first of each wrapper also
    against autograd through the plain forward, and timed)."""
    model = seeded_model(torch, JOINT_CONFIG, "cuda")
    n_layers = model.cfg.egnn.n_layers
    loss_value = joint_train_loss(torch, model, ds, pdb, sdf)
    calls, recorders, originals = first_forward_recorder(K, n_layers)
    params = list(model.dynamics.parameters())
    for n, f in recorders.items():
        setattr(K, n, f)
    K.reset_launches()
    try:
        with torch.enable_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss = loss_value()
            grads = torch.autograd.grad(loss, params)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
    finally:
        for n, f in originals.items():
            setattr(K, n, f)
    launches = fp32_launches(K)
    want = {"gcl_messages": n_layers, "edge_vector_reduce": n_layers,
            "gcl_messages_bwd": 2 * n_layers,
            "edge_vector_reduce_bwd": 2 * n_layers}
    for n in WRAPPERS:
        setattr(K, n, getattr(K, n + "_plain"))
    try:
        plain = float(loss_value())
    finally:
        for n, f in originals.items():
            setattr(K, n, f)
    finite = all(bool(torch.isfinite(g).all()) for g in grads)
    rel = abs(float(loss) - plain) / abs(plain)
    shape = list(calls[0][1][0].shape)
    log(f"[joint-train] joint loss at [B, N, H] = {shape} (pair n_rows "
        f"{n_rows_of(calls)}): {float(loss):.6f}, plain forward on the card "
        f"{plain:.6f} (relative difference {rel:.2e}, rtol {JOINT_LOSS_RTOL})"
        f"; value and gradient {seconds:.3f} s; gradients finite {finite}; "
        f"launches {launches} (expected {want})")
    if launches != want or not finite or not rel <= JOINT_LOSS_RTOL:
        raise AssertionError("[joint-train] launch counts, gradients or the "
                             "loss value are off")
    results = {}
    for wrapper, kernel in (("gcl_messages", "gcl_messages_bwd"),
                            ("edge_vector_reduce_pair",
                             "edge_vector_reduce_bwd")):
        mine = [c for c in calls if c[0] == wrapper]
        worst, first = 0.0, None
        for i, (_, args, kw) in enumerate(mine):
            args = [tuple(t.detach() for t in a)
                    if isinstance(a, (tuple, list))
                    else (a.detach() if a is not None else None)
                    for a in args]
            g = torch.Generator(device=model.device).manual_seed(SEED + i)
            pair = wrapper.endswith("_pair")
            a0 = args[0][0] if pair else args[0]
            gout = torch.randn((*a0.shape[:2], 3 if pair else a0.shape[2]),
                               generator=g, device=model.device) * 1e-2
            res = check_backward(torch, K, wrapper, args, kw, gout, i == 0,
                                 5 if i == 0 else 0)
            worst = max(worst, res["tolerance_share"])
            first = first or res
        first["tolerance_share"] = worst
        results[kernel] = first
        log(f"[joint-train] {wrapper} backward {first['shape']} ({len(mine)}"
            f" calls checked, gate {BWD_RTOL} x max|plain| + {BWD_ATOL}): "
            f"{describe_bwd(first)}")
    del calls
    return launches, results


def configs_phase(torch, K, ds, pdb, sdf):
    """[configs]: every configs/*.yml at its full width on seeded random
    weights, one forward (the conditional sampler's first state, B =
    CONFIGS_B, sizes from the config's size prior) on its own kind of
    pocket (the synthetic receptor's CA crop for the CA configs, its
    full-atom crop otherwise): each kernel call against its plain version,
    and the forward's output against the plain chain's on the card.  Then
    generate_ligands of CA_CONFIG (B=N_SAMPLES, T=500) with its launch
    counts.  A joint config also has the kernel calls of its joint
    sampler's first forward (t = T, B = JOINT_B, sizes from its size prior)
    held against their plain versions ("joint_first" in its checks).
    Returns ({config: checks}, the generation's launches)."""
    import glob

    from diffndm_tpu_torch.config import SampleConfig

    results = {}
    for path in sorted(glob.glob(os.path.join(REPO, "configs", "*.yml"))):
        name = os.path.basename(path)[:-4]
        model = seeded_model(torch, path, "cuda")
        cfg = model.cfg
        pocket = model.pocket_from_pdb(pdb, sdf, CONFIGS_B)
        sizes = model.sample_ligand_sizes(
            pocket, torch.Generator().manual_seed(SEED))
        calls = capture_kernel_calls(torch, K, model, pocket, sizes)
        checks = {WRAPPERS[w]: check_calls(
            torch, K, w, [c for c in calls if c[0] == w], reps=5)
            for w in ("gcl_messages", "edge_vector_reduce_pair")}
        state = first_state(torch, model, pocket, sizes)
        out = model.dynamics(*state)
        originals = {n: getattr(K, n) for n in WRAPPERS}
        for n in WRAPPERS:
            setattr(K, n, getattr(K, n + "_plain"))
        try:
            ref = model.dynamics(*state)
        finally:
            for n, f in originals.items():
                setattr(K, n, f)
        err = max(float((o - r).abs().max()) for o, r in zip(out, ref))
        rows = n_rows_of(calls)
        want_rows = ["None"] if cfg.mode == "joint" else [
            str(state[0].shape[1])]
        shape = checks["gcl_messages"]["shape"]
        log(f"[configs] {name}: {cfg.mode}, {cfg.pocket_representation} "
            f"({cfg.dataset}, residue_nf {cfg.residue_nf}), H "
            f"{cfg.egnn.hidden_nf}, {cfg.egnn.n_layers} layers, [B, N, H] = "
            f"{shape}, pair n_rows {rows}; kernels against plain per call: "
            f"gcl_messages {checks['gcl_messages']['max_abs_err']:.3e}, pair "
            f"{checks['edge_vector_reduce']['max_abs_err']:.3e} (atol "
            f"{KERNEL_ATOL} + rtol {KERNEL_RTOL}); forward against the plain "
            f"chain {err:.3e} (atol {CONFIG_EPS_ATOL}); kernel "
            f"{checks['gcl_messages']['ms']:.4f} / "
            f"{checks['edge_vector_reduce']['ms']:.4f} ms per launch")
        if len(calls) != 2 * cfg.egnn.n_layers or rows != want_rows:
            raise AssertionError(f"[configs] {name}: {len(calls)} wrapper "
                                 f"calls, pair n_rows {rows}")
        if not (err <= CONFIG_EPS_ATOL and all(
                bool(torch.isfinite(o).all()) for o in out)):
            raise AssertionError(f"[configs] {name}: the forward disagrees "
                                 f"with the plain chain")
        if cfg.mode == "joint":
            # the joint sampler's own first state: every row moves, dense
            # joint noise at the prior's sizes
            calls = joint_first_calls(torch, K, model, JOINT_B)
            joint_checks = check_first_forward(
                torch, K, f"configs {name} joint t=T", calls,
                cfg.egnn.n_layers, reps=5)
            if n_rows_of(calls) != ["None"]:
                raise AssertionError(f"[configs] {name}: the joint forward's "
                                     f"pair n_rows {n_rows_of(calls)}")
            for w, res in joint_checks.items():
                checks[w]["joint_first"] = {k: res[k] for k in CALL_KEYS}
        results[name] = checks
        del calls, model
    model = seeded_model(torch, CA_CONFIG, "cuda",
                         sample_cfg=SampleConfig(n_samples=N_SAMPLES,
                                                 timesteps=T_MAIN))
    n_layers = model.cfg.egnn.n_layers
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    mols, res = model.generate_ligands(pdb, sdf, seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = forward_launches(K)
    forwards = T_MAIN + 1
    want = {k: n_layers * forwards for k in KERNELS}
    n_poc = int(res.pocket.mask[0].sum())
    log(f"[configs] generate_ligands {os.path.basename(CA_CONFIG)} on the "
        f"synthetic receptor's CA crop ({n_poc} residues, residue_nf "
        f"{res.pocket.h.shape[-1]}), B={N_SAMPLES}, T={T_MAIN}: "
        f"{seconds:.3f} s per batch, {1e3 * seconds / forwards:.3f} ms per "
        f"forward; {sum(m is not None for m in mols)} molecules; launches "
        f"{launches} (expected {want}: {n_layers} x {forwards} forwards)")
    if launches != want or len(mols) != N_SAMPLES or not bool(
            torch.isfinite(res.ligand.x).all()) or res.pocket.h.shape[-1] \
            != 20:
        raise AssertionError("[configs] CA generation: launch counts or "
                             "outputs are off")
    return results, launches


# ---------------------------------------------------------------------------
# model variants
# ---------------------------------------------------------------------------

def seeded_gamma(torch):
    """Seeded random weights of a learned schedule's gamma network (its
    own init under torch.manual_seed(SEED))."""
    from diffndm_tpu_torch.diffusion.learned_gamma import GammaNetwork

    torch.manual_seed(SEED)
    return GammaNetwork().state_dict()


def variant_config(label, tmp):
    """(YAML path, ModelConfig) of a variant: VARIANT_CONFIG with the
    variant's YAML keys changed, written into ``tmp``; the GNN's mode is a
    config field that YAML does not carry."""
    import dataclasses

    from diffndm_tpu_torch.config import (dump_yaml, load_yaml,
                                          model_config_from_yaml)

    yaml_change, egnn_change, _ = VARIANTS[label]
    raw = load_yaml(VARIANT_CONFIG)
    for key, value in yaml_change.items():
        if isinstance(value, dict):
            raw[key] = dict(raw[key], **value)
        else:
            raw[key] = value
    path = os.path.join(tmp, f"variant_{label}.yml")
    with open(path, "w") as f:
        f.write(dump_yaml(raw))
    cfg = model_config_from_yaml(load_yaml(path))
    return path, dataclasses.replace(
        cfg, egnn=dataclasses.replace(cfg.egnn, **egnn_change))


def variant_model(torch, label, cfg, device, hist):
    """DiffNDM of a variant on ``device``: v3b's EMA weights where the
    architecture is v3b's, else the config's seeded random weights; a
    learned schedule's gamma network seeded."""
    from diffndm_tpu_torch.config import SampleConfig
    from diffndm_tpu_torch.convert import params_from_jax
    from diffndm_tpu_torch.model import DiffNDM

    model = DiffNDM(cfg, device=device, size_histogram=hist,
                    sample_cfg=SampleConfig(pocket_pad_multiple=16),
                    scorer="python")
    if VARIANTS[label][2]:
        with np.load(WEIGHTS) as f:
            tree = {k: f[k] for k in f.files}
    else:
        tree = seeded_tree(torch, cfg)
    model.dynamics.load_state_dict(params_from_jax(tree), strict=True)
    if model.gamma is not None:
        model.gamma.load_state_dict(seeded_gamma(torch), strict=True)
    return model


def variants_phase(torch, K, ds, train_ds, tmp):
    """[variants]: the JAX package's model variants at v3b's published
    width (VARIANT_CONFIG: hidden 192, 5 layers, joint_nf 64, 5 A
    cutoffs, fp32) on test pocket VARIANT_POCKET, B = N_SAMPLES: (a) the
    sinusoid distance embedding, (b) mean aggregation, (c) the edge-type
    embedding, (d) the GNN denoiser, (e) pocket_conditioning_simple, (f)
    the learned schedule (VLB).  Each: one forward on the card against the
    same forward on the CPU (CONFIG_EPS_ATOL) with its launch counts
    (n_layers per wrapper on the kernel path of (e) and (f), none on the
    dense chain of (a)-(d), as the JAX package dispatches), then one
    sampling at T = T_MAIN with its launch counts, s per batch and ms per
    forward.  (f) also trains through the train CLI (variant_train_phase).
    Returns ({label: result}, the train CLI's launches)."""
    hist = np.load(os.path.join(DATA, "size_distribution.npy"))
    results, learned_yaml = {}, None
    for label in VARIANTS:
        path, cfg = variant_config(label, tmp)
        if label.startswith("f"):
            learned_yaml = path
        model = variant_model(torch, label, cfg, "cuda", hist)
        kernels = label[0] in VARIANT_KERNEL_LABELS
        n_layers = cfg.egnn.n_layers
        pocket = model.pocket_from_dataset(ds[VARIANT_POCKET], N_SAMPLES)
        sizes = model.sample_ligand_sizes(
            pocket, torch.Generator().manual_seed(SEED))
        state = first_state(torch, model, pocket, sizes)
        K.reset_launches()
        out = model.dynamics(*state)
        torch.cuda.synchronize()
        fwd_launches = forward_launches(K)
        cpu = variant_model(torch, label, cfg, "cpu", hist)
        ref = cpu.dynamics(*(t.cpu() for t in state))
        err = max(float((o.cpu() - r).abs().max()) for o, r in zip(out, ref))
        del cpu
        K.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = model.sample_given_pocket(
            pocket, sizes, timesteps=T_MAIN,
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        launches = forward_launches(K)
        forwards = T_MAIN + 1
        per = n_layers if kernels else 0
        want_fwd = {k: per for k in KERNELS}
        want = {k: per * forwards for k in KERNELS}
        n = state[0].shape[1] + state[1].shape[1]
        log(f"[variants] ({label}) {cfg.mode}, egnn {cfg.egnn.mode}, sin "
            f"{cfg.egnn.sin_embedding}, aggregation "
            f"{cfg.egnn.aggregation_method}, edge embedding "
            f"{cfg.egnn.edge_embedding_dim}, schedule "
            f"{cfg.diffusion.noise_schedule} / {cfg.diffusion.loss_type}; "
            f"weights {'v3b EMA' if VARIANTS[label][2] else 'seeded'}; "
            f"[B, N, H] = [{N_SAMPLES}, {n}, {cfg.egnn.hidden_nf}]: forward "
            f"card vs CPU max abs {err:.3e} (atol {CONFIG_EPS_ATOL}), "
            f"launches {fwd_launches} (expected {want_fwd}); sampling at "
            f"T={T_MAIN}: {seconds:.3f} s per batch, "
            f"{1e3 * seconds / forwards:.3f} ms per forward, launches "
            f"{launches} (expected {want})")
        if fwd_launches != want_fwd or launches != want:
            raise AssertionError(f"[variants] ({label}): launch counts off")
        if not (err <= CONFIG_EPS_ATOL and all(
                bool(torch.isfinite(o).all()) for o in out)
                and bool(torch.isfinite(res.ligand.x).all())):
            raise AssertionError(f"[variants] ({label}): the card's forward "
                                 f"disagrees with the CPU's, or the sample "
                                 f"is not finite")
        results[label] = dict(forward_max_abs_err=err, shape=[
            N_SAMPLES, n, cfg.egnn.hidden_nf], forward_launches=fwd_launches,
            sample_launches=launches, sample_s=seconds,
            ms_per_forward=1e3 * seconds / forwards)
        del model, res, out
    train = variant_train_phase(torch, K, train_ds, tmp, learned_yaml)
    results["f_learned"]["train"] = {k: v for k, v in train.items()
                                     if k != "launches"}
    return results, train["launches"]


def variant_train_phase(torch, K, train_ds, tmp, yaml_path):
    """(f)'s training: the train CLI in this process on the first
    VARIANT_TRAIN_STEPS batches of virtual_v3's training split (no
    validation split: no eval), from a seeded state (torch.manual_seed),
    VLB with the learned schedule: launch counts per micro-step (both
    kernels forward and backward), ms per micro-step and peak memory, the
    gamma network moved.  Then the first micro-step's loss and gradients,
    both trees, on its batch's first TRAIN_CHECK_B rows under fixed draws
    from its starting state, card against CPU: each tensor within the
    backward gate (BWD_RTOL of the CPU's largest entry + BWD_ATOL), the
    loss within TRAIN_RTOL, but for the gamma network's layers (l1, l2,
    l3; gamma_0 and gamma_1 are gated).  The VLB weight 1 - exp(gamma_s -
    gamma_t) takes gammas one step of 500 apart, so those layers'
    gradients are differences of the network's derivatives at adjacent t,
    each ~500x the difference: what float32 leaves of them is rounding on
    any device, 1e-1 to 20x of their largest entry (the CPU's distance
    from a float64 evaluation is printed beside the card's, not gated).
    That the card computes the network's function and its gradient is
    held in float64 instead: values and the gradient of a weighted sum
    over t, card against CPU, within GAMMA_F64_RTOL.  l3's bias cancels in
    g(t) - g(0): gamma does not depend on it and it is not counted as a
    move of the network."""
    import shutil

    from diffndm_tpu_torch.cli import train as train_cli
    from diffndm_tpu_torch.config import (load_yaml, model_config_from_yaml,
                                          train_config_from_yaml)
    from diffndm_tpu_torch.data.dataset import save_npz_split
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.structs import NodeBatch
    from diffndm_tpu_torch.train.trainer import Trainer, load_train_state

    datadir = os.path.join(tmp, "variant_data")
    os.makedirs(datadir)
    save_npz_split(os.path.join(datadir, "train.npz"),
                   train_ds.pairs[:VARIANT_TRAIN_STEPS * N_SAMPLES])
    shutil.copy(os.path.join(DATA, "size_distribution.npy"), datadir)
    argv = ["--config", yaml_path, "--max_steps", str(VARIANT_TRAIN_STEPS),
            "--set", f"logdir={tmp}", "--set", f"datadir={datadir}",
            "--set", "run_name=variant_learned"]
    log(f"[variants] (f) python -m diffndm_tpu_torch.cli.train "
        f"{' '.join(argv)}")
    records, first = [], {}
    original = Trainer.train_step

    def counted(self, ligand, pocket, *args, **kw):
        if not first:
            first.update(
                batch=[nb.to("cpu") for nb in (ligand, pocket)],
                dynamics={k: v.detach().cpu().clone() for k, v in
                          self.module.state_dict().items()},
                gamma={k: v.detach().cpu().clone() for k, v in
                       self.gamma.state_dict().items()})
        before = fp32_launches(K)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = original(self, ligand, pocket, *args, **kw)
        torch.cuda.synchronize()
        records.append(dict(
            launches={k: v - before[k] for k, v in
                          fp32_launches(K).items()},
            ms=1e3 * (time.perf_counter() - t0),
            peak=torch.cuda.max_memory_allocated(), loss=out[0]))
        return out

    Trainer.train_step = counted
    K.reset_launches()
    torch.manual_seed(SEED)
    try:
        summary = train_cli.main(argv)
    finally:
        Trainer.train_step = original
    launches = fp32_launches(K)
    per_step = {"gcl_messages": 5, "edge_vector_reduce": 5,
                "gcl_messages_bwd": 10, "edge_vector_reduce_bwd": 10}
    bad = [r["launches"] for r in records if r["launches"] != per_step]
    params, _, step = load_train_state(os.path.join(summary["outdir"],
                                                    "last.npz"))
    moved = max(float(np.abs(params["gamma/params/" + k.replace(".", "/")]
                             - v.numpy()).max())
                for k, v in first["gamma"].items() if k != L3_BIAS)
    ms = [r["ms"] for r in records]
    peak = max(r["peak"] for r in records)

    # the first micro-step's gradients: card, CPU, CPU in float64
    raw = load_yaml(yaml_path)
    cfg, tcfg = model_config_from_yaml(raw), train_config_from_yaml(raw)
    rows = slice(0, TRAIN_CHECK_B)
    cut = [NodeBatch(*(a[rows] for a in nb)) for nb in first["batch"]]
    draws = step_draws(torch, cut[0], SEED + 40)
    grads, losses = {}, {}
    for key, device, dtype in (("cuda", "cuda", torch.float32),
                               ("cpu", "cpu", torch.float32),
                               ("f64", "cpu", torch.float64)):
        model = DiffNDM(cfg, device=device)
        model.set_params(first["dynamics"], first["gamma"])
        model.dynamics.to(dtype)
        model.gamma.to(dtype)
        trainer = Trainer(model.core, model.dynamics, tcfg,
                          gamma=model.gamma)
        with torch.enable_grad():
            loss, _ = trainer._loss(
                *(NodeBatch(*(a.to(device, dtype) for a in nb))
                  for nb in cut), True,
                *(d.to(device, dtype) for d in draws))
            g = torch.autograd.grad(loss, trainer.trained,
                                    allow_unused=True)
        names = ([f"dynamics.{n}" for n in trainer.names]
                 + [f"gamma.{n}" for n in trainer.gamma_names])
        grads[key] = {n: (torch.zeros_like(p) if gi is None else gi)
                      .detach().cpu().double() for n, p, gi in
                      zip(names, trainer.trained, g)}
        losses[key] = float(loss)
    # the backward gate against the CPU; the gamma network's layers
    # reported against float64 (their float32 floor, both devices)
    share, worst, layers = 0.0, None, {}
    for n, ref in grads["cpu"].items():
        exact, got = grads["f64"][n], grads["cuda"][n]
        if n.startswith("gamma.l"):
            top = float(exact.abs().max())
            layers[n] = [float((x - exact).abs().max()) / (top + BWD_ATOL)
                         for x in (got, ref)]
            continue
        sh = float((got - ref).abs().max()) / (
            BWD_RTOL * float(ref.abs().max()) + BWD_ATOL)
        if sh > share:
            share, worst = sh, n
    f64_rel = {k: abs(losses[k] - losses["f64"]) / abs(losses["f64"])
               for k in ("cuda", "cpu")}
    # the gamma network alone in float64, card against CPU: values and
    # the gradient of a seeded weighted sum over t = 0, 1/T, ..., 1
    from diffndm_tpu_torch.diffusion.learned_gamma import GammaNetwork

    t = torch.linspace(0.0, 1.0, cfg.diffusion.timesteps + 1,
                       dtype=torch.float64)
    w = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        t.shape[0]))
    net64 = {}
    for device in ("cuda", "cpu"):
        net = GammaNetwork().to(device, torch.float64)
        net.load_state_dict(first["gamma"])
        with torch.enable_grad():
            out = net(t.to(device))
            (out * w.to(device)).sum().backward()
        net64[device] = [out.detach().cpu()] + [
            torch.zeros_like(p).cpu() if p.grad is None else p.grad.cpu()
            for p in net.parameters()]
    net_rel = max(float((a - b).abs().max()) / float(b.abs().max().clamp_min(
        1e-300)) for a, b in zip(net64["cuda"], net64["cpu"]))
    loss_rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    log(f"[variants] (f) train CLI: {len(records)} micro-steps (VLB, "
        f"learned schedule, seeded state) at [{N_SAMPLES}, N, 192]: losses "
        f"{[round(r['loss'], 3) for r in records]}; ms per micro-step (host "
        f"clock, synchronised) median {float(np.median(ms)):.2f}, min "
        f"{min(ms):.2f}, max {max(ms):.2f}; peak device memory per "
        f"micro-step {peak / 2**20:.1f} MiB; launches {launches} (per "
        f"micro-step {per_step}; mismatches {bad[:3]}); checkpoint at step "
        f"{step}, the gamma network moved by up to {moved:.3e}")
    log(f"[variants] (f) first micro-step ({TRAIN_CHECK_B} rows, fixed "
        f"draws), card vs CPU: loss {losses['cuda']:.6f} / "
        f"{losses['cpu']:.6f} (rel {loss_rel:.2e}, gate {TRAIN_RTOL}; "
        f"float64 {losses['f64']:.6f}: card {f64_rel['cuda']:.2e}, CPU "
        f"{f64_rel['cpu']:.2e} from it); gradients at most {share:.3f} of "
        f"their gate (worst {worst}): the dynamics tree, gamma_0 and "
        f"gamma_1 against the CPU, {BWD_RTOL} x max|CPU| + {BWD_ATOL}; "
        f"the gamma network alone in float64, card vs CPU, values and "
        f"gradients max rel {net_rel:.2e} (gate {GAMMA_F64_RTOL}); not "
        f"gated, the float32 gradients of the gamma network's layers, "
        f"distance from float64 over its largest entry (card / CPU): "
        f"{ {n: [f'{e:.2e}' for e in v] for n, v in layers.items()} }")
    if bad or len(records) != VARIANT_TRAIN_STEPS or \
            step != VARIANT_TRAIN_STEPS:
        raise AssertionError("[variants] (f) launch counts or steps off")
    if not (moved > 0 and all(np.isfinite(r["loss"]) for r in records)):
        raise AssertionError("[variants] (f) the gamma network did not "
                             "train, or a loss is not finite")
    if not (share <= 1.0 and loss_rel <= TRAIN_RTOL
            and net_rel <= GAMMA_F64_RTOL):
        raise AssertionError("[variants] (f) the card's gradients disagree "
                             "with the CPU's")
    return dict(launches=launches, ms=ms, peak_mib=peak / 2**20,
                gamma_moved=moved, grad_gate_share=share,
                loss_rel=loss_rel, gamma_layers_from_f64=layers,
                gamma_f64_rel=net_rel)


# ---------------------------------------------------------------------------
# etl: structures -> processed split -> training -> sampling
# ---------------------------------------------------------------------------

def write_crossdock_tree(basedir, splits, decoder):
    """Every pair of ``splits`` ({split: pairs}) as
    crossdocked_pocket10/<split><i>/<split><i>_rec.pdb + ..._lig.sdf
    (write_pocket_files), and split_by_name.json naming them.  Returns the
    json's path."""
    root = os.path.join(basedir, "crossdocked_pocket10")
    names = {}
    for split, pairs in splits.items():
        names[split] = []
        for i, pair in enumerate(pairs):
            stem = f"{split}{i:05d}"
            os.makedirs(os.path.join(root, stem))
            write_pocket_files(pair, decoder, os.path.join(root, stem),
                               names=(f"{stem}_rec.pdb", f"{stem}_lig.sdf"))
            names[split].append([f"{stem}/{stem}_rec.pdb",
                                 f"{stem}/{stem}_lig.sdf"])
    path = os.path.join(basedir, "split_by_name.json")
    with open(path, "w") as f:
        json.dump(names, f)
    return path


def expected_pocket(pair):
    """The source pocket atoms that the 8 A rule keeps, recomputed from the
    coordinates as the files hold them (PDB 3 decimals; SDF 4, then
    float32), distances in float64."""
    lig = np.array([[float(f"{v:10.4f}") for v in c]
                    for c in pair.lig_coords]).astype(np.float32)
    poc = np.array([[float(f"{v:8.3f}") for v in c]
                    for c in pair.pocket_coords])
    near = np.linalg.norm(poc[:, None] - lig[None], axis=-1).min(1) \
        < ETL_CUTOFF
    return pair.pocket_coords[near], pair.pocket_one_hot[near]


def etl_check(source, processed):
    """(ligand max abs, pocket max abs, mismatched pairs) of processed
    pairs against their source pairs, in order."""
    lig_err, poc_err, bad = 0.0, 0.0, []
    for i, (src, out) in enumerate(zip(source, processed)):
        coords, one_hot = expected_pocket(src)
        same = (np.array_equal(src.lig_one_hot.argmax(1),
                               out.lig_one_hot.argmax(1))
                and src.lig_coords.shape == out.lig_coords.shape
                and coords.shape == out.pocket_coords.shape
                and np.array_equal(one_hot.argmax(1),
                                   out.pocket_one_hot.argmax(1)))
        if not same:
            bad.append(i)
            continue
        lig_err = max(lig_err, float(np.abs(out.lig_coords
                                            - src.lig_coords).max()))
        if len(coords):
            poc_err = max(poc_err, float(np.abs(out.pocket_coords
                                                - coords).max()))
    return lig_err, poc_err, bad


class Tee:
    """stdout that is also kept."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, s):
        self.lines.append(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def etl_phase(torch, K, tmp):
    """[etl]: (a) every virtual_v3 pair (train, val, test) written as a
    CrossDocked tree with split_by_name.json; (b) the port's
    process_crossdock CLI on it, then prepare_crossdocked on its test
    export (the sweep CLI's flat layout): no pair dropped, ligands and
    pockets (the 8 A rule recomputed here) equal to the source within the
    files' rounding; (c) the train CLI on the
    processed split at v3b's width from v3b's raw state for
    ETL_TRAIN_STEPS micro-steps, the eval and the dashboard (renders on)
    after them: launch counts per micro-step, val batch and dashboard
    sampling, the dashboard's SDF; (d) the micro-steps under
    utils.profiling.trace with their forward / backward / optimizer spans;
    (e) the analytic FLOPs of the micro-step's forward and its rate on the
    card; (f) one unguided batch of N_SAMPLES at T_MAIN from the trained
    weights on a processed test pocket.  Returns a dict of the results."""
    import contextlib
    import shutil

    from diffndm_tpu_torch.chem.sanitize import is_valid
    from diffndm_tpu_torch.cli import train as train_cli
    from diffndm_tpu_torch.config import SampleConfig
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.convert import params_from_jax
    from diffndm_tpu_torch.data import prepare_crossdocked, process_crossdock
    from diffndm_tpu_torch.data.dataset import ProcessedLigandPocketDataset
    from diffndm_tpu_torch.diffusion.sampler import count_forwards
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.train.eval_dashboard import ChemistryDashboard
    from diffndm_tpu_torch.train.trainer import Trainer, load_train_state
    from diffndm_tpu_torch.utils import flops, profiling

    decoder = dataset_params["crossdock_full"]["atom_decoder"]
    source = {s: ProcessedLigandPocketDataset(os.path.join(DATA, f"{s}.npz"),
                                              center=False).pairs
              for s in ("train", "val", "test")}
    n_pairs = sum(len(v) for v in source.values())
    basedir, outdir = os.path.join(tmp, "crossdock"), os.path.join(tmp, "out")
    t0 = time.perf_counter()
    split_file = write_crossdock_tree(basedir, source, decoder)
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    process_crossdock.main([basedir, "--outdir", outdir, "--split_file",
                            split_file])
    t_process = time.perf_counter() - t0
    t0 = time.perf_counter()
    n_flat = prepare_crossdocked.main([os.path.join(outdir, "test"),
                                       "--outdir", os.path.join(tmp, "flat")])
    t_prepare = time.perf_counter() - t0
    processed = {s: ProcessedLigandPocketDataset(
        os.path.join(outdir, f"{s}.npz"), center=False).pairs
        for s in source}
    dropped = {s: len(source[s]) - len(processed[s]) for s in source}
    checks = {s: etl_check(source[s], processed[s]) for s in source}
    lig_err = max(c[0] for c in checks.values())
    poc_err = max(c[1] for c in checks.values())
    bad = {s: c[2][:3] for s, c in checks.items() if c[2]}
    exported = len(os.listdir(os.path.join(outdir, "test")))
    flat_files = len(os.listdir(os.path.join(tmp, "flat", "test")))
    keys = np.load(os.path.join(outdir, "train_smiles.npy"))
    log(f"[etl] (a) {n_pairs} pairs "
        f"({', '.join(f'{s} {len(v)}' for s, v in source.items())}) "
        f"written as a CrossDocked tree in {t_write:.2f} s; (b) "
        f"process_crossdock in {t_process:.2f} s "
        f"({1e3 * t_process / n_pairs:.3f} ms per pair), dropped {dropped}; "
        f"prepare_crossdocked flattened the test export's {n_flat} "
        f"complexes in {t_prepare:.2f} s; against the source: ligand types "
        f"equal, "
        f"coordinates max abs {lig_err:.2e} A (atol {SDF_ATOL:.1e}), "
        f"pockets = the source atoms within {ETL_CUTOFF} A, coordinates max "
        f"abs {poc_err:.2e} A (atol {PDB_ATOL:.1e}), mismatched pairs "
        f"{bad}; {len(keys)} train identity keys; test export "
        f"{exported} files")
    if any(dropped.values()) or bad or lig_err > SDF_ATOL or \
            poc_err > PDB_ATOL or n_flat != len(source["test"]) or \
            flat_files != 2 * n_flat or \
            exported != 3 * len(source["test"]) or \
            len(keys) != len(source["train"]):
        raise AssertionError("[etl] the processed split disagrees with its "
                             "source")

    # (c) + (d): the train CLI on the processed split, its micro-steps
    # profiled
    argv = ["--config", VARIANT_CONFIG, "--resume", TRAIN_STATE,
            "--max_steps", str(ETL_TRAIN_STEPS), "--set", f"logdir={tmp}",
            "--set", f"datadir={outdir}", "--set", "eval_epochs=1",
            "--set", f"eval_params.n_visualize_samples={ETL_VISUALIZE}",
            "--set", "run_name=etl"]
    log(f"[etl] (c) python -m diffndm_tpu_torch.cli.train {' '.join(argv)}")
    trace_dir = os.path.join(tmp, "trace")
    records = {"train": [], "eval": [], "dashboard": []}
    originals = (Trainer.train_step, Trainer.eval_step,
                 ChemistryDashboard.sample_and_analyze)
    profiled = contextlib.ExitStack()
    batches = []

    def counted(kind, fn):
        def wrapper(*args, **kw):
            if kind == "train":
                batches.append([nb.to("cuda") for nb in args[1:3]])
            if kind == "train" and not records["train"]:
                profiled.enter_context(profiling.trace(trace_dir))
            before = fp32_launches(K)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            records[kind].append(dict(
                launches={k: v - before[k] for k, v in
                          fp32_launches(K).items()},
                ms=1e3 * (time.perf_counter() - t0), out=out))
            if kind == "train" and len(records["train"]) == ETL_TRAIN_STEPS:
                profiled.close()
            return out
        return wrapper

    Trainer.train_step = counted("train", originals[0])
    Trainer.eval_step = counted("eval", originals[1])
    ChemistryDashboard.sample_and_analyze = counted("dashboard",
                                                    originals[2])
    K.reset_launches()
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(tee):
            summary = train_cli.main(argv)
    finally:
        profiled.close()
        (Trainer.train_step, Trainer.eval_step,
         ChemistryDashboard.sample_and_analyze) = originals
    wall = time.perf_counter() - t0
    launches = fp32_launches(K)
    per_step = {"gcl_messages": 5, "edge_vector_reduce": 5,
                "gcl_messages_bwd": 10, "edge_vector_reduce_bwd": 10}
    per_eval = {"gcl_messages": 10, "edge_vector_reduce": 10,
                "gcl_messages_bwd": 0, "edge_vector_reduce_bwd": 0}
    sample_forwards = count_forwards(SampleConfig(), T_MAIN)
    per_dash = {"gcl_messages": 5 * sample_forwards,
                "edge_vector_reduce": 5 * sample_forwards,
                "gcl_messages_bwd": 0, "edge_vector_reduce_bwd": 0}
    mismatch = ([r["launches"] for r in records["train"]
                 if r["launches"] != per_step]
                + [r["launches"] for r in records["eval"]
                   if r["launches"] != per_eval]
                + [r["launches"] for r in records["dashboard"]
                   if r["launches"] != per_dash])
    losses = [r["out"][0] for r in records["train"]]
    ms = [r["ms"] for r in records["train"]]
    run_dir = summary["outdir"]
    sdf = os.path.join(run_dir, "eval", "eval_ep0.sdf")
    n_sdf = open(sdf).read().count("$$$$") if os.path.exists(sdf) else 0
    viz = os.path.join(run_dir, "eval", "viz_ep0")
    pngs = len(os.listdir(viz)) if os.path.isdir(viz) else 0
    failed = [s.strip() for s in "".join(tee.lines).splitlines()
              if s.startswith("[dashboard] visualization failed")]
    log(f"[etl] (c) {len(losses)} micro-steps at [{N_SAMPLES}, N, 192] on "
        f"the processed split, {wall:.1f} s with the eval and the "
        f"dashboard: loss per step {[round(v, 4) for v in losses]}; ms per "
        f"micro-step (host clock, synchronised, under the profiler) median "
        f"{float(np.median(ms)):.2f}; val loss {summary['val_losses']}; "
        f"launches {launches} (per micro-step {per_step}, per val batch "
        f"{per_eval}, per dashboard sampling {per_dash}; mismatches "
        f"{mismatch[:3]}); dashboard SDF {os.path.relpath(sdf, tmp)} with "
        f"{n_sdf} molecules; renders: {pngs} PNG files"
        + (f", {failed[0]!r}" if failed else ""))
    if mismatch or len(losses) != ETL_TRAIN_STEPS or \
            len(records["eval"]) == 0 or len(records["dashboard"]) != 1:
        raise AssertionError("[etl] launch counts or phases off")
    if not (all(np.isfinite(losses)) and np.mean(losses) <= TRAIN_LOSS_MAX
            and all(np.isfinite(summary["val_losses"]))):
        raise AssertionError("[etl] the loss is not finite or too high")
    if n_sdf == 0 or not (pngs or failed):
        raise AssertionError("[etl] the dashboard wrote no SDF, or neither "
                             "rendered nor said why not")

    # (d) the trace
    trace_file = os.path.join(trace_dir, profiling.TRACE_FILE)
    events = []
    if os.path.exists(trace_file):
        with open(trace_file) as f:
            events = json.load(f).get("traceEvents", [])
    names = [str(e.get("name", "")) for e in events]
    spans = {s: names.count(s) for s in ETL_SPANS}
    kernel_events = {k: sum(k in n for n in names)
                     for k in ("edge_chain_mma", "edge_chain_bwd_mma")}
    log(f"[etl] (d) profiler trace of the {ETL_TRAIN_STEPS} micro-steps: "
        f"{len(events)} events; spans {spans}; kernel events "
        f"{kernel_events}")
    if any(v < ETL_TRAIN_STEPS for v in spans.values()) or \
            not all(kernel_events.values()):
        raise AssertionError("[etl] the trace lacks the spans or the "
                             "kernels")

    # (e) the forward of each micro-step's batch: analytic FLOPs and the
    # rate on the card (CUDA events around ETL_FORWARD_REPS forwards)
    params, ema, step = load_train_state(os.path.join(run_dir, "last.npz"))
    model = DiffNDM.from_yaml(VARIANT_CONFIG, device="cuda",
                              size_histogram=np.load(os.path.join(
                                  outdir, "size_distribution.npy")),
                              sample_cfg=SampleConfig(pocket_pad_multiple=16))
    model.dynamics.load_state_dict(params_from_jax(ema), strict=True)
    nx, nh = model.core.cfg.norm_values
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    rows = []
    for lig, poc in batches:
        state = (torch.cat([lig.x / nx, lig.h / nh], -1)
                 * lig.mask[..., None],
                 torch.cat([poc.x / nx, poc.h / nh], -1)
                 * poc.mask[..., None],
                 torch.full((lig.x.shape[0],), 0.5, device="cuda"),
                 lig.mask, poc.mask)
        shape = (lig.x.shape[0], lig.x.shape[1], poc.x.shape[1])
        for _ in range(3):
            model.dynamics(*state)
        start.record()
        for _ in range(ETL_FORWARD_REPS):
            model.dynamics(*state)
        end.record()
        torch.cuda.synchronize()
        rows.append((shape, flops.egnn_flops_analytic(
            model.cfg.egnn, model.cfg.atom_nf, *shape),
            start.elapsed_time(end) / ETL_FORWARD_REPS))
    kind = torch.cuda.get_device_name(0)
    rate = sum(r[1] for r in rows) / (sum(r[2] for r in rows) / 1e3) / 1e12
    peaks = {d: flops.peak_tflops_for(kind, d) for d in ("bf16", "tf32")}
    shares = {d: (rate / p if p else None) for d, p in peaks.items()}
    per_forward = [(list(sh), round(f / 1e9, 3), round(t, 3),
                    round(f / t / 1e9, 3)) for sh, f, t in rows]
    log(f"[etl] (e) the {len(rows)} micro-steps' forwards, [B, NL, NP] "
        f"(H = {model.cfg.egnn.hidden_nf}): GFLOP (egnn_flops_analytic), "
        f"ms per forward (CUDA events, {ETL_FORWARD_REPS} forwards back to "
        f"back, the host's launches included), TFLOP/s: "
        f"{per_forward}; "
        f"all together {rate:.3f} TFLOP/s, share of the card's dense peaks "
        f"{ {d: round(v, 5) for d, v in shares.items() if v is not None} } "
        f"(peaks {peaks} TFLOP/s) on {nvidia_smi()}")

    # (f) one unguided batch from the trained weights
    test = ProcessedLigandPocketDataset(os.path.join(outdir, "test.npz"))
    pocket = model.pocket_from_dataset(test[ETL_POCKET], N_SAMPLES)
    sizes = model.sample_ligand_sizes(pocket,
                                      torch.Generator().manual_seed(SEED))
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.sample_given_pocket(
        pocket, sizes, timesteps=T_MAIN,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    sample_launches = forward_launches(K)
    want = {k: 5 * count_forwards(SampleConfig(), T_MAIN) for k in KERNELS}
    mols = model.result_to_molecules(res)
    n_valid = sum(is_valid(m) for m in mols)
    log(f"[etl] (f) {N_SAMPLES} ligands at T={T_MAIN} from the step-{step} "
        f"EMA weights on processed test pocket {ETL_POCKET} "
        f"({test[ETL_POCKET].name}): {seconds:.3f} s per batch, launches "
        f"{sample_launches} (expected {want}); {n_valid} of {len(mols)} "
        f"molecules valid")
    if sample_launches != want or not bool(torch.isfinite(
            res.ligand.x).all()) or step != 59988 + ETL_TRAIN_STEPS:
        raise AssertionError("[etl] the sampling from the trained weights "
                             "is off")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"[etl] a kernel was not launched: {launches}")
    shutil.rmtree(basedir)
    return dict(pairs=n_pairs, dropped=dropped, write_s=t_write,
                process_s=t_process, prepare_s=t_prepare, launches=launches,
                sample_launches=sample_launches, ms=ms, losses=losses,
                forwards=[dict(shape=list(sh), gflop=f / 1e9, ms=t)
                          for sh, f, t in rows], tflops=rate,
                peak_share=shares, sample_s=seconds)


# ---------------------------------------------------------------------------
# backward kernels
# ---------------------------------------------------------------------------

def bwd_cost(name, args, kw):
    """(operations, bytes) of one backward call: the three products and
    the O(H) work of every edge with a nonzero adjacency among the rows
    computed, per weight set; every input (the forward's and the output
    gradient) read once, every gradient written once."""
    pair = name == "edge_vector_reduce_pair"
    a, adj = (args[0][0] if pair else args[0]), args[4]
    bsz, n, h = a.shape
    n_sets = 2 if pair else 1
    rows = kw.get("n_rows")
    rows = n if rows is None else max(0, min(n, rows))
    edges = int((adj[:, :rows] != 0).sum())
    per_edge = 6 * h * h + 24 * h
    node = n_sets * 2 * (bsz * rows * h + bsz * n * h)    # a, b; da, db
    planes = 3 * bsz * rows * n + 2 * bsz * rows * n      # in; dd2c, dd2i
    weights = 2 * n_sets * (h * h + 5 * h)
    if name == "gcl_messages":
        extra = 2 * bsz * n * h                           # gout
    else:
        extra = 2 * (bsz * n * 3 + bsz * 3) + bsz * n * 3
    return (n_sets * edges * per_edge,
            4 * (node + planes + weights + extra))


def bwd_inputs(torch, name, args):
    """The differentiable inputs of a wrapper call, as fresh leaves that
    require grad, and a function that calls the wrapper (or its plain
    version) on them."""
    pair = name == "edge_vector_reduce_pair"
    leaves = []

    def leaf(t):
        t = t.detach().clone().requires_grad_()
        leaves.append(t)
        return t

    new = []
    for i, a in enumerate(args):
        if i == 4 or a is None:                 # adj, or a missing batt
            new.append(a)
        elif isinstance(a, (tuple, list)):
            new.append(tuple(leaf(t) for t in a))
        else:
            new.append(leaf(a))
    return new, leaves, pair


def flat_grads(grads):
    """A plain backward's gradients in the order of ``bwd_inputs``'
    leaves."""
    flat = []
    for i, g in enumerate(grads):
        if i == 4 or g is None:
            continue
        flat += list(g) if isinstance(g, tuple) else [g]
    return flat


def bwd_compare(torch, label, got, ref):
    """Largest share of the per-tensor gate used; raises past it."""
    worst = 0.0
    for i, (g, r) in enumerate(zip(got, ref)):
        err = float((g - r).abs().max())
        lim = BWD_RTOL * float(r.abs().max()) + BWD_ATOL
        if not bool(torch.isfinite(g).all()) or err > lim:
            raise AssertionError(
                f"{label}: gradient {i} disagrees with the plain backward: "
                f"max abs {err:.3e} > {lim:.3e}")
        worst = max(worst, err / lim)
    return worst


def bwd_call(K, name, args, kw, gout, bf16=False):
    """The backward kernels' two launches for one wrapper call, every
    gradient asked for, as a function of no arguments (``bf16``: the bf16
    backward)."""
    if name == "gcl_messages":
        opts = (kw.get("attention", True), kw.get("norm_factor", 100.0))
        return lambda: K._gcl_messages_backward_cuda(
            gout, *args[:10], *opts, [True] * 10, bf16)
    sets = ([tuple(a[s] for a in (args[0], args[1], *args[7:]))
             for s in (0, 1)] if name.endswith("_pair") else
            [tuple(args[i] for i in (0, 1, 7, 8, 9, 10))])
    return lambda: K._edge_vector_reduce_backward_cuda(
        gout, sets, *args[2:7], kw.get("tanh", True),
        kw.get("coords_range", 15.0), kw.get("norm_constant", 1.0),
        kw.get("cross", False), kw.get("norm_factor", 100.0),
        kw.get("n_rows"), (True, True), bf16)


def check_backward(torch, K, name, args, kw, gout, against_autograd, reps):
    """The kernel backward (through the wrapper's Function) against the
    plain backward, twice for bit identity, optionally against autograd
    through the plain forward; timed where ``reps``."""
    new, leaves, pair = bwd_inputs(torch, name, args)
    plain_fwd = getattr(K, name + "_plain")

    def kernel_grads():
        with torch.enable_grad():
            out = getattr(K, name)(*new, **kw)
            return torch.autograd.grad(out, leaves, gout)

    got, again = kernel_grads(), kernel_grads()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} backward: two launches differ in "
                             f"their bits")
    detached = [tuple(t.detach() for t in a) if isinstance(a, (tuple, list))
                else (a.detach() if a is not None else None) for a in args]
    bwd_plain = getattr(K, name.replace("_pair", "") + (
        "_pair" if pair else "") + "_backward_plain")
    flat = flat_grads(bwd_plain(gout, *detached, **kw))
    share = bwd_compare(torch, f"{name} backward", got, flat)
    auto_share = None
    if against_autograd:
        with torch.enable_grad():
            out = plain_fwd(*new, **kw)
            auto = torch.autograd.grad(out, leaves, gout)
        auto_share = bwd_compare(torch, f"{name} backward vs autograd", got,
                                 auto)
    res = dict(max_abs_err=max(float((g - r).abs().max())
                               for g, r in zip(got, flat)),
               tolerance_share=share, autograd_share=auto_share,
               shape=list((args[0][0] if pair else args[0]).shape))
    if reps:
        res["ms"] = time_ms(torch, bwd_call(K, name, args, kw, gout), reps)
        res["plain_ms"] = time_ms(torch, lambda: bwd_plain(
            gout, *detached, **kw), max(2, reps // 10), warmup=1, rounds=3)
        ops, nbytes = bwd_cost(name, args, kw)
        res["bound_ms"], res["bound_by"] = bound_ms(ops, nbytes)
        res["tflops"] = ops / res["ms"] / 1e9
        res["blocks"], res["rows_per_block"] = K.bwd_launch_grid(
            name, *res["shape"], kw.get("n_rows"))
    return res


def describe_bwd(res):
    text = (f"max abs {res['max_abs_err']:.3e}, at most "
            f"{res['tolerance_share']:.3f} of the gate")
    if res["autograd_share"] is not None:
        text += (f" ({res['autograd_share']:.3f} against autograd through "
                 f"the plain forward)")
    if "ms" in res:
        text += (f"; backward {res['ms']:.4f} ms per call (2 launches, "
                 f"{res['tflops']:.1f} TFLOP/s), plain {res['plain_ms']:.4f}"
                 f" ms, bound {res['bound_ms']:.4f} ms ({res['bound_by']}, "
                 f"TF32 tensor cores); grid {res['blocks']} blocks of "
                 f"{res['rows_per_block']} rows")
    return text


def backward_shape_sweep(torch, K, device):
    """Each backward kernel against the plain backward on the edge-shape
    sweep's cases (``sweep_cases``): H = 128, 192 and 256, one weight set
    and the pair, n_rows in {0, 5, N}, tanh, cross and attention on and
    off, empty rows and columns, and an all-zero batch element, whose
    blocks hold no edge; repeat launches bit-identical."""
    n_cases, worst = 0, 0.0
    for seed, (bsz, n, h) in enumerate(SWEEP_SHAPES):
        d = sweep_inputs(torch, device, bsz, n, h, SEED + 10 + seed)
        for name, args, kw in sweep_cases(d, n):
            g = torch.Generator(device=device).manual_seed(SEED + n_cases)
            gout = torch.randn((bsz, n, h if name == "gcl_messages" else 3),
                               generator=g, device=device) * 1e-2
            try:
                res = check_backward(torch, K, name, args, kw, gout, False,
                                     0)
            except AssertionError as err:
                raise AssertionError(f"{kw} [{bsz}, {n}, {h}]: {err}") \
                    from err
            worst = max(worst, res["tolerance_share"])
            n_cases += 1
    log(f"[backward] edge-shape sweep: {n_cases} cases at "
        f"{[list(s) for s in SWEEP_SHAPES]}, every gradient within "
        f"{BWD_RTOL} x max|plain| + {BWD_ATOL} (at most {worst:.3f} of the "
        f"gate), repeat launches bit-identical")


def train_batches(torch, device):
    """One v3b training batch (16 complexes of virtual_v3's training set,
    in the loader's first epoch) per N in TRAIN_N."""
    from diffndm_tpu_torch.data.dataset import (BucketedLoader,
                                                ProcessedLigandPocketDataset)

    ds = ProcessedLigandPocketDataset(os.path.join(DATA, "train.npz"))
    found = {}
    for lig, poc in BucketedLoader(ds, N_SAMPLES, drop_feature_cols=1):
        n = lig.x.shape[1] + poc.x.shape[1]
        if n in TRAIN_N and n not in found:
            found[n] = (lig.to(device), poc.to(device))
        if len(found) == len(TRAIN_N):
            break
    if sorted(found) != sorted(TRAIN_N):
        raise AssertionError(f"no training batch of N in {TRAIN_N}: "
                             f"{sorted(found)}")
    return ds, found


def make_trainer(torch, device, raw=None, group=None,
                 compute_dtype="float32", generator=None):
    """v3b's model and Trainer on ``device``, resumed from its raw
    training state (data-parallel over ``group`` when given), in the
    given compute dtype (an ``EGNNConfig`` field, as the JAX package
    takes it)."""
    import dataclasses

    from diffndm_tpu_torch.config import (load_yaml, model_config_from_yaml,
                                          train_config_from_yaml)
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.train.trainer import Trainer

    raw = raw or load_yaml(os.path.join(RUN, "hparams.yaml"))
    cfg = model_config_from_yaml(raw)
    cfg = dataclasses.replace(cfg, egnn=dataclasses.replace(
        cfg.egnn, compute_dtype=compute_dtype))
    model = DiffNDM(cfg, device=device)
    trainer = Trainer(model.core, model.dynamics,
                      train_config_from_yaml(raw),
                      lj_rm=dataset_params[model.cfg.dataset][
                          "lennard_jones_rm"], group=group,
                      generator=generator)
    trainer.load_checkpoint(TRAIN_STATE)
    return model, trainer


def step_draws(torch, lig, seed):
    rng = np.random.default_rng(seed)
    b, nl = lig.x.shape[:2]
    t_int = torch.from_numpy(rng.integers(0, 501, size=b).astype(np.float32))
    noise = torch.from_numpy(rng.standard_normal(
        (b, nl, 3 + lig.h.shape[-1])).astype(np.float32))
    return t_int, noise


def capture_train_calls(torch, K, trainer, lig, poc):
    """The wrapper calls of one training forward (the loss at a drawn t)."""
    calls = []
    originals = {n: getattr(K, n) for n in WRAPPERS}

    def recorder(name):
        def fn(*args, **kw):
            calls.append((name, args, kw))
            return originals[name](*args, **kw)
        return fn

    for n in WRAPPERS:
        setattr(K, n, recorder(n))
    try:
        with torch.no_grad():
            trainer._loss(lig, poc, True, *step_draws(torch, lig, SEED))
    finally:
        for n, f in originals.items():
            setattr(K, n, f)
    return calls


def backward_phase(torch, K, batches, trainer, device):
    """Each backward kernel against the plain backward on the calls of one
    training forward at each training shape (the first call of each kind
    also against autograd through the plain forward, and timed), at the
    flagship shapes and over the edge-shape sweep."""
    results = {}
    for n in TRAIN_N:
        lig, poc = batches[n]
        calls = capture_train_calls(torch, K, trainer, lig, poc)
        counts = {w: sum(1 for c in calls if c[0] == w) for w in WRAPPERS}
        if counts != {"gcl_messages": 5, "edge_vector_reduce": 0,
                      "edge_vector_reduce_pair": 5}:
            raise AssertionError(f"[backward] a training forward made "
                                 f"{counts} wrapper calls")
        for wrapper in ("gcl_messages", "edge_vector_reduce_pair"):
            mine = [c for c in calls if c[0] == wrapper]
            worst, first = 0.0, None
            for i, (_, args, kw) in enumerate(mine):
                g = torch.Generator(device=device).manual_seed(SEED + i)
                shape = (args[0][0] if wrapper.endswith("_pair")
                         else args[0]).shape
                gout = torch.randn(
                    (*shape[:2], 3 if wrapper.endswith("_pair")
                     else shape[2]), generator=g, device=device) * 1e-2
                res = check_backward(torch, K, wrapper, args, kw, gout,
                                     i == 0, 10 if i == 0 else 0)
                worst = max(worst, res["tolerance_share"])
                first = first or res
            first["tolerance_share"] = worst
            kernel = "gcl_messages_bwd" if wrapper == "gcl_messages" \
                else "edge_vector_reduce_bwd"
            results.setdefault(kernel, {})[n] = first
            log(f"[backward] training N={n} {wrapper} {first['shape']} "
                f"({len(mine)} calls checked, gate {BWD_RTOL} x max|plain| "
                f"+ {BWD_ATOL}): {describe_bwd(first)}")
        del calls
    for wrapper, kernel in (("gcl_messages", "gcl_messages_bwd"),
                            ("edge_vector_reduce_pair",
                             "edge_vector_reduce_bwd")):
        args, kw = flagship_inputs(torch, wrapper, device)
        pair = wrapper.endswith("_pair")
        shape = (args[0][0] if pair else args[0]).shape
        gout = torch.randn((*shape[:2], 3 if pair else shape[2]),
                           generator=torch.Generator(device=device)
                           .manual_seed(SEED), device=device) * 1e-2
        res = check_backward(torch, K, wrapper, args, kw, gout, True, 3)
        results[kernel]["flagship"] = res
        log(f"[backward] flagship {wrapper} {res['shape']} {kw}: "
            f"{describe_bwd(res)}")
    backward_shape_sweep(torch, K, device)
    return results


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def fixed_step_pair(torch, batches, device, compute_dtype="float32"):
    """Two fixed-noise micro-steps (one optimizer update at
    accumulate_grad_batches 2) from v3b's raw state on ``device``: the
    first TRAIN_CHECK_B rows of the N=80 batch, seeded t and noise.
    Returns the infos, the clipped gradients the optimizer took, the
    trainer, and its params, EMA and clip buffer on the CPU."""
    from diffndm_tpu_torch.structs import NodeBatch

    lig, poc = batches[80]
    rows = slice(0, TRAIN_CHECK_B)
    cut = [NodeBatch(*(a[rows].cpu() for a in nb)) for nb in (lig, poc)]
    draws = [step_draws(torch, cut[0], SEED + 20 + i) for i in range(2)]
    _, trainer = make_trainer(torch, device, compute_dtype=compute_dtype)
    grads, update = [], trainer.opt.update

    def recording(params, g):
        grads.append([t.detach().cpu().clone() for t in g])
        return update(params, g)

    trainer.opt.update = recording
    infos = [trainer.train_step(*cut, *d) for d in draws]
    if trainer.opt.count != 1:
        raise AssertionError("[train] the two micro-steps made no update")
    return dict(infos=infos, grads=grads, trainer=trainer,
                state=[t.detach().cpu() for t in trainer.params + trainer.ema]
                + [trainer.gradnorm_buf.cpu()])


def train_path_check(torch, batches):
    """One fixed-noise training micro-step pair (one optimizer update at
    accumulate_grad_batches 2) from v3b's raw state on the card and on the
    CPU: the same rows, t and noise.  Gated: the loss within TRAIN_RTOL;
    every clipped gradient tensor within the backward kernels' gate
    (BWD_RTOL of its largest entry + BWD_ATOL); the gradient norm within
    BWD_RTOL; and the optimizer on the card, fed the CPU's clipped
    gradients, giving the CPU's parameters, EMA and clip buffer within
    TRAIN_RTOL.  Reported, not gated: the card's parameters after its own
    update.  Adam's first update is about sign(g) * lr for every element,
    so an element whose gradient lies within the kernels' accepted error
    of zero moves by up to 2 * lr differently on the two devices."""
    g, c = (fixed_step_pair(torch, batches, device)
            for device in ("cuda", "cpu"))
    loss_rel = max(abs(a[0] - b[0]) / abs(b[0])
                   for a, b in zip(g["infos"], c["infos"]))
    norm_rel = max(abs(a[1]["grad_norm"] - b[1]["grad_norm"])
                   / b[1]["grad_norm"] for a, b in zip(g["infos"], c["infos"]))
    grad_share = max(
        float((a - b).abs().max()) / (BWD_RTOL * float(b.abs().max())
                                      + BWD_ATOL)
        for ga, gb in zip(g["grads"], c["grads"]) for a, b in zip(ga, gb))
    # the optimizer on the card, fed the CPU's clipped gradients
    _, replay = make_trainer(torch, "cuda")
    for grads in c["grads"]:
        replay.apply_gradients([t.cuda() for t in grads])
    replay_state = [t.detach().cpu() for t in replay.params + replay.ema]

    def rel(xs, ys):
        return max(float((a - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(xs, ys))

    replay_rel = rel(replay_state, c["state"][:-1])
    buf_rel = rel(g["state"][-1:], c["state"][-1:])
    own_rel = rel(g["state"][:-1], c["state"][:-1])
    # where the card's own update differs most, and that element's
    # gradient on both devices (the mean of the two micro-steps)
    names = c["trainer"].names
    worst = max(range(len(names)), key=lambda i: float(
        (g["state"][i] - c["state"][i]).abs().max()))
    k = int((g["state"][worst] - c["state"][worst]).abs().argmax())
    gm = [sum(gr[worst].flatten()[k] for gr in d["grads"]) / 2
          for d in (g, c)]
    scale = max(float(gr[worst].abs().max()) for gr in c["grads"])
    log(f"[train] fixed-noise step, card vs CPU ({TRAIN_CHECK_B} rows of the "
        f"N=80 batch, v3b's raw state, 2 micro-steps = 1 update): losses "
        f"{[round(a[0], 6) for a in g['infos']]} / "
        f"{[round(b[0], 6) for b in c['infos']]} (max rel {loss_rel:.2e}, "
        f"gate {TRAIN_RTOL}); grad norms "
        f"{[round(a[1]['grad_norm'], 6) for a in g['infos']]} / "
        f"{[round(b[1]['grad_norm'], 6) for b in c['infos']]} (max rel "
        f"{norm_rel:.2e}, gate {BWD_RTOL}; the clip buffers max rel "
        f"{buf_rel:.2e}); clipped gradients at most "
        f"{grad_share:.3f} of the gate {BWD_RTOL} x max|g| + {BWD_ATOL}; "
        f"the card's optimizer on the CPU's gradients: params and EMA max "
        f"rel {replay_rel:.2e} (gate {TRAIN_RTOL})")
    log(f"[train] not gated: the card's params and EMA after its own update "
        f"max rel {own_rel:.2e} of each tensor's largest entry; the worst "
        f"element, in {names[worst]}, has a mean gradient "
        f"{float(gm[0]):.3e} (card) / {float(gm[1]):.3e} (CPU) against "
        f"the tensor's largest {scale:.3e}")
    if not (loss_rel <= TRAIN_RTOL and norm_rel <= BWD_RTOL
            and buf_rel <= BWD_RTOL and grad_share <= 1.0
            and replay_rel <= TRAIN_RTOL):
        raise AssertionError("[train] the card's training step disagrees "
                             "with the CPU's")


def train_cli_phase(torch, K, ds, tmp):
    """The train CLI in this process, resuming v3b from its raw state on a
    training split cut to TRAIN_EPOCH_BATCHES batches, so that the epoch
    ends at step TRAIN_STEPS and the eval runs once.  Launch counts per
    micro-step, val batch and dashboard sampling; the loss; the
    checkpoints written and read back."""
    import shutil

    from diffndm_tpu_torch.cli import train as train_cli
    from diffndm_tpu_torch.convert import params_from_jax
    from diffndm_tpu_torch.data.dataset import save_npz_split
    from diffndm_tpu_torch.diffusion.sampler import count_forwards
    from diffndm_tpu_torch.config import SampleConfig
    from diffndm_tpu_torch.train.eval_dashboard import ChemistryDashboard
    from diffndm_tpu_torch.train.trainer import Trainer, load_train_state

    datadir = os.path.join(tmp, "data")
    os.makedirs(datadir)
    save_npz_split(os.path.join(datadir, "train.npz"),
                   ds.pairs[:TRAIN_EPOCH_BATCHES * N_SAMPLES])
    for name in ("val.npz", "size_distribution.npy"):
        shutil.copy(os.path.join(DATA, name), datadir)
    argv = ["--config", os.path.join(RUN, "hparams.yaml"), "--resume",
            TRAIN_STATE, "--max_steps", str(TRAIN_STEPS), "--set",
            f"logdir={tmp}", "--set", "eval_epochs=1", "--set",
            f"datadir={datadir}"]
    log(f"[train] python -m diffndm_tpu_torch.cli.train {' '.join(argv)}")
    records = {"train": [], "eval": [], "dashboard": []}
    originals = (Trainer.train_step, Trainer.eval_step,
                 ChemistryDashboard.sample_and_analyze)

    def counted(kind, fn):
        def wrapper(*args, **kw):
            before = fp32_launches(K)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            torch.cuda.synchronize()
            records[kind].append(dict(
                launches={k: v - before[k] for k, v in
                          fp32_launches(K).items()},
                ms=1e3 * (time.perf_counter() - t0),
                peak=torch.cuda.max_memory_allocated(), out=out))
            return out
        return wrapper

    Trainer.train_step = counted("train", originals[0])
    Trainer.eval_step = counted("eval", originals[1])
    ChemistryDashboard.sample_and_analyze = counted("dashboard",
                                                    originals[2])
    K.reset_launches()
    t0 = time.perf_counter()
    try:
        summary = train_cli.main(argv)
    finally:
        (Trainer.train_step, Trainer.eval_step,
         ChemistryDashboard.sample_and_analyze) = originals
    wall = time.perf_counter() - t0
    launches = fp32_launches(K)
    per_step = {"gcl_messages": 5, "edge_vector_reduce": 5,
                "gcl_messages_bwd": 10, "edge_vector_reduce_bwd": 10}
    per_eval = {"gcl_messages": 10, "edge_vector_reduce": 10,
                "gcl_messages_bwd": 0, "edge_vector_reduce_bwd": 0}
    sample_forwards = count_forwards(SampleConfig(), T_MAIN)
    per_dash = {"gcl_messages": 5 * sample_forwards,
                "edge_vector_reduce": 5 * sample_forwards,
                "gcl_messages_bwd": 0, "edge_vector_reduce_bwd": 0}
    bad = ([r["launches"] for r in records["train"]
            if r["launches"] != per_step]
           + [r["launches"] for r in records["eval"]
              if r["launches"] != per_eval]
           + [r["launches"] for r in records["dashboard"]
              if r["launches"] != per_dash])
    losses = [r["out"][0] for r in records["train"]]
    ms = [r["ms"] for r in records["train"]]
    peaks = [r["peak"] for r in records["train"]]
    val = summary["val_losses"]
    outdir = summary["outdir"]
    with open(os.path.join(RUN, "training_metrics.jsonl")) as f:
        jax_rows = [json.loads(line) for line in f]
    jax_last = [r["loss"] for r in jax_rows if r["split"] == "train"][-5:]
    with open(os.path.join(outdir, "metrics.jsonl")) as f:
        val_rec = [json.loads(line) for line in f
                   if '"split": "val"' in line][-1]
    log(f"[train] {len(losses)} micro-steps at [{N_SAMPLES}, N, 192] in "
        f"{wall:.1f} s (load, eval and checkpoints included); loss per "
        f"step {[round(v, 4) for v in losses]}; mean "
        f"{float(np.mean(losses)):.5f} (the JAX run's last five epochs: "
        f"{[round(v, 5) for v in jax_last]}; gate <= {TRAIN_LOSS_MAX}); "
        f"ms per micro-step (host clock, synchronised) median "
        f"{float(np.median(ms)):.2f}, min {min(ms):.2f}, max {max(ms):.2f} "
        f"(first {ms[0]:.2f}); peak device memory per micro-step "
        f"{max(peaks) / 2**20:.1f} MiB")
    log(f"[train] eval: {len(records['eval'])} val batches, val loss "
        f"{val}; dashboard ({len(records['dashboard'])} sampling of "
        f"{N_SAMPLES} pockets at T={T_MAIN}, "
        f"{[round(r['ms'] / 1e3, 2) for r in records['dashboard']]} s): "
        f"{ {k: round(v, 4) for k, v in val_rec.items() if k not in ('step', 'split', 'time', 'epoch')} }")
    log(f"[train] launches {launches}: per micro-step {per_step}, per val "
        f"batch {per_eval}, per dashboard sampling {per_dash}; mismatches "
        f"{bad[:3]}")
    if bad or len(records["train"]) != TRAIN_STEPS or not records["eval"] \
            or len(records["dashboard"]) != 1:
        raise AssertionError("[train] launch counts or phases off")
    if not all(np.isfinite(losses)) or np.mean(losses) > TRAIN_LOSS_MAX \
            or not all(np.isfinite(val)):
        raise AssertionError("[train] the loss is not finite or too high")
    for name in ("best.npz", "last.npz"):
        params, ema, step = load_train_state(os.path.join(outdir, name))
        model_cfg_state = params_from_jax(ema)
        if step != 59988 + TRAIN_STEPS or any(
                not bool(torch.isfinite(v).all())
                for v in model_cfg_state.values()):
            raise AssertionError(f"[train] {name} did not load back")
    log(f"[train] best.npz and last.npz written at step "
        f"{59988 + TRAIN_STEPS} and read back; the EMA weights load into "
        f"the model")
    if any(v == 0 for v in launches.values()):
        raise AssertionError(f"[train] a kernel was not launched: "
                             f"{launches}")
    return launches, dict(ms=ms, peaks=peaks, losses=losses)


def train_step_profile(torch, K, batches):
    """Where a micro-step's time goes at [16, 96, 192]: host ms per
    micro-step, the profiler's device busy time and the kernels' share;
    peak device memory per micro-step with the kernels and with the plain
    chain (autograd through the plain versions, which keeps the [B, N, N,
    H] planes)."""
    lig, poc = batches[96]
    _, trainer = make_trainer(torch, "cuda")
    draws = step_draws(torch, lig, SEED + 30)

    def steps(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            trainer.train_step(lig, poc, *draws)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / n

    steps(2)
    host = steps(10)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms = steps(5)
    busy_us, ours, n_dev = 0.0, {"fwd": 0.0, "bwd": 0.0}, 0
    for ev in prof.events():
        if str(ev.device_type).endswith("CUDA"):
            dur = ev.time_range.elapsed_us()
            busy_us += dur
            n_dev += 1
            if "edge_chain_bwd" in ev.name:
                ours["bwd"] += dur
            elif "edge_chain" in ev.name:
                ours["fwd"] += dur
    peaks = {}
    for label in ("kernels", "plain chain"):
        originals = {n: getattr(K, n) for n in WRAPPERS}
        if label == "plain chain":
            for n in WRAPPERS:
                setattr(K, n, getattr(K, n + "_plain"))
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            trainer.train_step(lig, poc, *draws)
            torch.cuda.synchronize()
            peaks[label] = (torch.cuda.max_memory_allocated() - base) / 2**20
        finally:
            for n, f in originals.items():
                setattr(K, n, f)
    if n_dev == 0:
        log("[train] the profiler recorded no device activity: idle share "
            "not measured")
        busy = None
    else:
        busy = busy_us / 1e3 / 5
        log(f"[train] micro-step at [{N_SAMPLES}, 96, 192]: {host:.3f} ms by "
            f"the host clock; profiler: {n_dev / 5:.0f} device activities "
            f"per micro-step, device busy {busy:.3f} ms of {prof_ms:.3f}, of "
            f"which the forward kernels {ours['fwd'] / 5e3:.3f} and the "
            f"backward kernels {ours['bwd'] / 5e3:.3f}; idle share "
            f"{1 - busy / prof_ms:.3f}")
    log(f"[train] peak device memory of a micro-step above its inputs: "
        f"{peaks['kernels']:.1f} MiB through the kernels (Functions that "
        f"save their inputs), {peaks['plain chain']:.1f} MiB through the "
        f"plain chain (a memory comparison only)")
    return dict(host_ms=host, busy_ms=busy, peaks=peaks)

# ---------------------------------------------------------------------------
# [optimizer]: the trainer's fused multi-tensor kernels
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def plain_optimizer(FO):
    """The trainer's optimizer calls routed to the plain per-leaf versions,
    on whatever device the tensors lie."""
    names = ("clip_by_history", "amsgrad", "ema")
    originals = {n: getattr(FO, n) for n in names}
    for n in names:
        setattr(FO, n, getattr(FO, n + "_plain"))
    try:
        yield
    finally:
        for n, f in originals.items():
            setattr(FO, n, f)


def optimizer_trainer(torch, model, gamma, ema_decay):
    """A Trainer on copies of ``model``'s dynamics (and ``gamma``) with
    the configuration's optimizer settings and this EMA decay."""
    import copy
    import dataclasses

    from diffndm_tpu_torch.config import load_yaml, train_config_from_yaml
    from diffndm_tpu_torch.train.trainer import Trainer

    cfg = dataclasses.replace(train_config_from_yaml(load_yaml(OPT_CONFIG)),
                              ema_decay=ema_decay)
    return Trainer(model.core, copy.deepcopy(model.dynamics), cfg,
                   gamma=copy.deepcopy(gamma) if gamma is not None else None)


def optimizer_state(trainer):
    """Every tensor the optimizer span writes, by name."""
    o = trainer.opt
    return dict(params=trainer.trained, mu=o.mu, nu=o.nu, nu_max=o.nu_max,
                acc=o.acc, ema=trainer.ema, norms=[trainer.gradnorm_buf])


def ulp_gap(torch, a, b, mag=None):
    """(elements that differ, the largest distance in ulps of ``mag``, by
    default |b| element by element); float32."""
    if not a.numel():
        return 0, 0.0
    mag = b.abs() if mag is None else mag
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    diff = (a.double() - b.double()).abs()
    return int((a != b).sum()), float((diff / ulp.double()).max())


def optimizer_launches(FO, numels, update, clip):
    """The launches one micro-step should make per kernel."""
    blocks = lambda depth: sum(1 for lc in FO.plan(numels, depth)
                               if lc.blocks)
    return {"optimizer_norm": blocks(1),
            "optimizer_clip": len(FO.clip_plan(numels)),
            "optimizer_scale": blocks(1) if clip else 0,
            "optimizer_update": blocks(6 if update else 2),
            "optimizer_ema": blocks(2)}


def optimizer_case(torch, FO, model, gamma, ema_decay, clipped, seed):
    """OPT_STEPS micro-steps of the optimizer span from the same state and
    gradients on three trainers: ``fused``; ``plain``, the per-leaf path;
    ``replay``, the per-leaf path fed the fused side's clipped gradients
    (its clip runs for its buffer, its output is dropped).  Returns per
    micro-step the (norm, threshold) of fused and plain, the clipped
    gradients' gap, the launches; over the run the gaps of fused against
    replay and against plain per state tensor, the latter also in ulps of
    each leaf's largest entry so far (a rescaled gradient moves an element
    whose sum cancelled by many of its own ulps)."""
    sides = {k: optimizer_trainer(torch, model, gamma, ema_decay)
             for k in ("fused", "plain", "replay")}
    fused = sides["fused"]
    numels = tuple(p.numel() for p in fused.trained)
    rng = np.random.default_rng(seed)
    scales = 10.0 ** rng.uniform(-4, -2, size=len(numels))
    scales[::17] = 0.0      # leaves the loss does not reach
    if clipped:
        scales *= OPT_CLIP_SCALE
    gen = torch.Generator(device="cuda").manual_seed(seed)
    keys = list(optimizer_state(fused))
    replay_gap = {k: (0, 0.0) for k in keys}
    plain_gap = {k: (0, 0.0) for k in keys}
    peak = {k: [torch.zeros((), device="cuda") for _ in ts]
            for k, ts in optimizer_state(fused).items()}
    norms, grad_gaps, launches = [], [], []
    for step in range(OPT_STEPS):
        grads = [torch.randn(p.shape, generator=gen, device="cuda") * s
                 for p, s in zip(fused.trained, scales)]
        update = (step + 1) % max(1, fused.cfg.accumulate_grad_batches) == 0
        clipped_grads, infos = {}, {}
        for name, trainer in sides.items():
            g, info = [t.clone() for t in grads], {}
            torch.cuda.synchronize()
            if name == "fused":
                FO.reset_counts()
                versions = [p._version for p in trainer.trained]
                torch.cuda.set_sync_debug_mode("error")
                try:
                    trainer._clip(g, info)
                    trainer.apply_gradients(g)
                finally:
                    torch.cuda.set_sync_debug_mode(0)
                if update and any(p._version == v for p, v in zip(
                        trainer.trained, versions)):
                    raise AssertionError("[optimizer] an updated weight "
                                         "kept its version counter")
                launches.append(dict(FO.LAUNCHES))
                if any(FO.PLAIN_CALLS.values()):
                    raise AssertionError(f"[optimizer] the fused micro-step "
                                         f"called the plain path: "
                                         f"{FO.PLAIN_CALLS}")
                want = optimizer_launches(FO, numels, update, True)
                if FO.LAUNCHES != want or sum(want.values()) > \
                        OPT_MAX_LAUNCHES:
                    raise AssertionError(f"[optimizer] launches "
                                         f"{FO.LAUNCHES}, expected {want}")
            else:
                with plain_optimizer(FO):
                    trainer._clip(g, info)
                    if name == "replay":
                        g = [t.clone() for t in clipped_grads["fused"]]
                    trainer.apply_gradients(g)
            clipped_grads[name] = g
            infos[name] = {k: v.reshape(1) for k, v in info.items()}
        norms.append({k: [ulp_gap(torch, infos["fused"][k], infos["plain"][k])
                          [1], float(infos["fused"][k]),
                          float(infos["plain"][k])]
                      for k in ("grad_norm", "clip_threshold")})
        grad_gaps.append(max(
            (ulp_gap(torch, a, b) for a, b in zip(clipped_grads["fused"],
                                                 clipped_grads["plain"])),
            key=lambda x: (x[1], x[0])))
        states = {k: optimizer_state(t) for k, t in sides.items()}
        for key in keys:
            trios = zip(states["fused"][key], states["replay"][key],
                        states["plain"][key], peak[key])
            for a, r, b, m in trios:
                a, r, b = a.detach(), r.detach(), b.detach()
                if key != "norms":      # a slot is overwritten, not summed
                    torch.maximum(m, b.abs().max() if b.numel() else m,
                                  out=m)
                d, u = ulp_gap(torch, a, r)
                replay_gap[key] = (replay_gap[key][0] + d,
                                   max(replay_gap[key][1], u))
                d, u = ulp_gap(torch, a, b, None if key == "norms"
                               else m.expand_as(b))
                plain_gap[key] = (plain_gap[key][0] + d,
                                  max(plain_gap[key][1], u))
    return dict(replay=replay_gap, plain=plain_gap, norms=norms,
                grads=grad_gaps, launches=launches, numels=numels)


def time_cold_ms(torch, fn, reps, rounds=3):
    """Device time of one call with the L2 cache flushed before it: per
    call, a write of twice the L2's 50 MB, then CUDA events around the
    call, all queued behind a long matrix product so that the host's own
    cost stays out; the median over ``rounds`` of the mean over ``reps``."""
    if not hasattr(time_ms, "blocker"):
        time_ms.blocker = torch.ones((8192, 8192), device="cuda")
    flush = torch.empty(25 << 20, device="cuda")
    fn()
    times = []
    for _ in range(rounds):
        torch.mm(time_ms.blocker, time_ms.blocker)
        pairs = []
        for _ in range(reps):
            flush.zero_()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            pairs.append((start, end))
        pairs[-1][1].synchronize()
        times.append(sum(a.elapsed_time(b) for a, b in pairs) / reps)
    return float(np.median(times))


def optimizer_timing(torch, FO, model):
    """Device ms of each fused kernel's launches per micro-step on the
    model's leaves, the L2 cache flushed before each, against its bytes at
    3.35 TB/s, and per micro-step the host ms of the optimizer span and
    the card's ms, fused and plain."""
    trainer = optimizer_trainer(torch, model, None, 0.999)
    params = trainer.trained
    o = trainer.opt
    n_el = sum(p.numel() for p in params)
    grads = [torch.randn_like(p) * 1e-3 for p in params]
    lib = FO._library()
    dev = params[0].device
    g_tab = FO._Tables("time", [grads], dev, 1)
    acc_tab = FO._Tables("time", [grads, o.acc], dev, 2)
    upd_tab = FO._Tables("time", [params, grads, o.acc, o.mu, o.nu,
                                  o.nu_max], dev, 6)
    ema_tab = FO._Tables("time", [params, trainer.ema], dev, 2)
    n_part = sum(lc.blocks for lc in g_tab.launches)
    partials = torch.zeros(n_part, dtype=torch.float64, device=dev)
    stats = torch.tensor([0.0, 0.0, 1.0, 0.0], device=dev)
    buf = trainer.gradnorm_buf
    (begin, ends), = FO.clip_plan(g_tab.numels)

    def each(name, tables, entry, *extra):
        def run():
            for lc in tables.launches:
                FO._launch(name, dev, entry, *tables.args(lc), *extra)
        return run

    def norm():
        for lc in g_tab.launches:
            FO._launch("optimizer_norm", dev, lib.fo_sum_squares,
                       *g_tab.args(lc),
                       partials.data_ptr() + 8 * lc.first_chunk)

    consts = (1.0, *(FO._f32(x) for x in (FO.B1, 1 - FO.B1, FO.B2,
                                          1 - FO.B2)),
              1.0, 1.0, FO._f32(FO.EPS), FO._f32(1e-12), FO._f32(-1e-3), 1)
    kernels = {
        "optimizer_norm": (norm, 4 * n_el),
        "optimizer_clip": (lambda: FO._launch(
            "optimizer_clip", dev, lib.fo_clip, ends.ctypes.data, begin,
            len(ends), partials.data_ptr(), 1, 1, buf.data_ptr(),
            buf.numel(), 5, FO._recip(5), 0, 1, stats.data_ptr()),
            8 * n_part + 4 * 2 * buf.numel()),
        "optimizer_scale": (each("optimizer_scale", g_tab, lib.fo_scale,
                                 stats.data_ptr()), 8 * n_el),
        "optimizer_update (accumulate)": (
            each("optimizer_update", acc_tab, lib.fo_accumulate, 0.5),
            12 * n_el),
        "optimizer_update (amsgrad)": (
            each("optimizer_update", upd_tab, lib.fo_amsgrad, *consts),
            44 * n_el),
        "optimizer_ema (copy)": (
            each("optimizer_ema", ema_tab, lib.fo_ema, 0.0, 0.0, 1),
            8 * n_el),
        "optimizer_ema (decay)": (
            each("optimizer_ema", ema_tab, lib.fo_ema, 0.999,
                 FO._f32(1 - 0.999), 0), 12 * n_el)}
    tables = {"optimizer_norm": g_tab, "optimizer_scale": g_tab,
              "optimizer_update (accumulate)": acc_tab,
              "optimizer_update (amsgrad)": upd_tab,
              "optimizer_ema (copy)": ema_tab,
              "optimizer_ema (decay)": ema_tab}
    rows = {}
    for name, (fn, nbytes) in kernels.items():
        ms = time_cold_ms(torch, fn, 20)
        n_launch = len(tables[name].launches) if name in tables else 1
        rows[name] = dict(ms=ms, launches=n_launch,
                          bound_ms=1e3 * nbytes / PEAK_BYTES, bytes=nbytes)
        log(f"[optimizer] {name}: {ms:.4f} ms for its {n_launch} launch(es) "
            f"over {len(params)} leaves, {n_el} elements; bytes bound "
            f"{rows[name]['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB at "
            f"3.35 TB/s), {100 * rows[name]['bound_ms'] / ms:.1f} % of it")

    def micro_steps(n):
        host, card = [], []
        for i in range(n):
            g = [t.clone() for t in grads]
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            t0 = time.perf_counter()
            trainer._clip(g, {})
            trainer.apply_gradients(g)
            host.append(1e3 * (time.perf_counter() - t0))
            end.record()
            end.synchronize()
            card.append(start.elapsed_time(end))
        return host, card

    out = {}
    for label in ("fused", "plain"):
        ctx = plain_optimizer(FO) if label == "plain" else \
            contextlib.nullcontext()
        with ctx:
            micro_steps(4)
            host, card = micro_steps(20)
        # even micro-steps accumulate, odd ones update (k = 2)
        out[label] = {kind: dict(host_ms=float(np.median(host[i::2])),
                                 card_ms=float(np.median(card[i::2])))
                      for i, kind in ((0, "accumulate"), (1, "update"))}
        log(f"[optimizer] {label} span per micro-step (median of 10 each, "
            f"EMA decay 0.999, clip on): accumulating "
            f"{out[label]['accumulate']['host_ms']:.3f} ms host, "
            f"{out[label]['accumulate']['card_ms']:.3f} ms to the card's "
            f"end; updating {out[label]['update']['host_ms']:.3f} / "
            f"{out[label]['update']['card_ms']:.3f} ms")
    return dict(kernels=rows, span=out)


def log_optimizer_ptxas(so) -> None:
    """The compiler's registers and spills per optimizer kernel."""
    kernel = None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function .*?(\w+_kernel)", line)
        if m:
            kernel = m[1]
        elif kernel and ("registers" in line or "spill" in line):
            log(f"[ptxas] {kernel}: {line.split(':')[-1].strip()}")


def optimizer_phase(torch):
    """[optimizer]: the fused optimizer kernels (csrc/fused_optimizer.cu)
    against the plain per-leaf path, both on the card, at DiffSBDD's
    CrossDocked model's leaves (seeded init), from the same state and
    gradients: OPT_STEPS micro-steps at accumulate_grad_batches 2 with
    and without the clip engaged, EMA decay 0 and 0.999, with and without
    a learned schedule's gamma network.  Gated: the norm, the threshold
    and the norm buffer's entries within OPT_ULPS of the plain path's
    (sums in another order); where the clip does not engage, the clipped
    gradients and the weights, moments, accumulator and EMA equal to the
    bit; where it engages, the clipped gradients within OPT_GRAD_ULPS
    element by element (the state, which a rescaled gradient moves
    further, is reported in ulps of each leaf's largest entry); in every
    case the
    state equal to the bit to the plain path's fed the fused side's
    clipped gradients; the clip engaged on every
    micro-step of the clipped cases and on none of the others; the fused
    launches per micro-step as the plan gives them (at most
    OPT_MAX_LAUNCHES), no plain-path call and no host sync in a fused
    micro-step.  Then ms per kernel launch against its bytes bound, and
    the span per micro-step fused and plain."""
    from diffndm_tpu_torch.diffusion.learned_gamma import GammaNetwork
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.ops import fused_optimizer as FO

    torch.manual_seed(SEED)
    model = DiffNDM.from_yaml(OPT_CONFIG, device="cuda")
    gamma = GammaNetwork().to("cuda")
    results = {}
    i = 0
    for with_gamma in (False, True):
        for ema_decay in (0.0, 0.999):
            for clipped in (False, True):
                i += 1
                label = (f"{'clip' if clipped else 'no clip'}, ema "
                         f"{ema_decay}{', gamma' if with_gamma else ''}")
                res = optimizer_case(torch, FO, model,
                                     gamma if with_gamma else None,
                                     ema_decay, clipped, SEED + 40 + i)
                results[label] = res
                engaged = [n["grad_norm"][1] > n["clip_threshold"][1]
                           and n["grad_norm"][2] > n["clip_threshold"][2]
                           for n in res["norms"]]
                quiet = [n["grad_norm"][1] < n["clip_threshold"][1]
                         and n["grad_norm"][2] < n["clip_threshold"][2]
                         for n in res["norms"]]
                norm_ulps = max(max(n["grad_norm"][0], n["clip_threshold"][0])
                                for n in res["norms"])
                fmt = lambda gaps: ", ".join(f"{k} {d} / {u:.1f}"
                                             for k, (d, u) in gaps.items())
                per_step = [sum(lc.values()) for lc in res["launches"]]
                log(f"[optimizer] {label}: {len(res['numels'])} leaves, "
                    f"{sum(res['numels'])} elements; clip engaged on "
                    f"{sum(engaged)} of {OPT_STEPS} micro-steps on both "
                    f"paths; norm and threshold, fused / plain: at most "
                    f"{norm_ulps:.1f} ulps apart; clipped gradients per "
                    f"micro-step (elements differing, ulps) "
                    f"{[(d, round(u, 1)) for d, u in res['grads']]}; "
                    f"state against the plain path fed the fused "
                    f"gradients (elements differing / ulps): "
                    f"{fmt(res['replay'])}; against the plain path (ulps "
                    f"of each leaf's largest entry; the norm buffer's of "
                    f"each entry): {fmt(res['plain'])}; fused launches per "
                    f"micro-step {per_step}, {res['launches'][-1]}")
                if not clipped:
                    log(f"[optimizer] {label}: (norm, threshold) fused / "
                        f"plain per micro-step {res['norms']}")
                replay_ok = all(d == 0 for k, (d, _) in
                                res["replay"].items() if k != "norms")
                # where the clip engages, a norm an ulp apart moves the
                # clipped gradients by a few ulps and the state, fed them
                # over the micro-steps, further: that state is reported,
                # its arithmetic gated by the replay
                plain_ok = all(
                    u <= OPT_ULPS if k == "norms" else (clipped or d == 0)
                    for k, (d, u) in res["plain"].items())
                grads_ok = all(u <= OPT_GRAD_ULPS if clipped else d == 0
                               for d, u in res["grads"])
                if not (replay_ok and plain_ok and grads_ok
                        and norm_ulps <= OPT_ULPS
                        and all(engaged if clipped else quiet)):
                    log(f"[optimizer] {label}: (norm, threshold) fused / "
                        f"plain per micro-step {res['norms']}")
                    raise AssertionError(f"[optimizer] {label}: the fused "
                                         f"path disagrees with the plain one")
    timing = optimizer_timing(torch, FO, model)
    return dict(cases=results, **timing)


# ---------------------------------------------------------------------------
# [modes]: bf16, K-nearest-neighbour edges, the sorted band
# ---------------------------------------------------------------------------

def with_egnn(model, **kw):
    """The model switched to another mode of its EGNN config."""
    import dataclasses

    model.set_egnn_config(dataclasses.replace(model.cfg.egnn, **kw))
    return model


def forward_ms(torch, fn, reps=MODES_REPS):
    """Host clock per call, synchronised: what a sampler's step sees of a
    forward (one that is bound by its launches and host syncs)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def eps_error(torch, got, want):
    return max(float((g.cpu() - w.cpu()).abs().max())
               for g, w in zip(got, want))


def check_bf16(torch, K, wrapper, args, kw, reps):
    """A bf16 kernel call against its bf16 plain version, with the fp32
    kernel on the same call beside it."""
    kernel = getattr(K, wrapper)
    plain = getattr(K, wrapper + "_plain")
    kw = dict(kw, compute_dtype="bfloat16")
    kw32 = dict(kw, compute_dtype="float32")
    out = kernel(*args, **kw)
    again = kernel(*args, **kw)
    torch.cuda.synchronize()
    if not torch.equal(out, again):
        raise AssertionError(f"{wrapper} bf16: two launches differ")
    ref = plain(*args, **kw)
    tol = BF16_GATE * float(ref.abs().max()) + BF16_ATOL
    err = float((out - ref).abs().max())
    fp32_err = float((kernel(*args, **kw32) - ref).abs().max())
    if not (bool(torch.isfinite(out).all()) and err <= tol):
        raise AssertionError(
            f"{wrapper} bf16: kernel disagrees with its plain version: max "
            f"abs {err:.3e} > {tol:.3e} ({BF16_GATE} max |plain| + "
            f"{BF16_ATOL})")
    ops, nbytes = call_cost(wrapper, args, kw)
    t_ops, t_bytes = ops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    shape = list((args[0][0] if wrapper.endswith("_pair") else args[0]).shape)
    blocks, per_block = K.launch_grid(wrapper, *shape, kw.get("n_rows"),
                                      "bfloat16")
    return dict(
        shape=shape, max_abs_err=err, gate_share=err / tol,
        fp32_gate_share=fp32_err / tol,
        ms=time_ms(torch, lambda: kernel(*args, **kw), reps),
        fp32_ms=time_ms(torch, lambda: kernel(*args, **kw32), reps),
        plain_ms=time_ms(torch, lambda: plain(*args, **kw), max(3, reps // 10),
                         warmup=1, rounds=3),
        bound_ms=1e3 * max(t_ops, t_bytes),
        bound_by="operations" if t_ops >= t_bytes else "bytes",
        blocks=blocks, rows_per_block=per_block)


def describe_bf16(res):
    return (f"max abs {res['max_abs_err']:.3e}, {res['gate_share']:.3f} of "
            f"the gate (the fp32 kernel on this call: "
            f"{res['fp32_gate_share']:.2f}); bf16 {res['ms']:.4f} ms, fp32 "
            f"{res['fp32_ms']:.4f} ms, plain {res['plain_ms']:.4f} ms, "
            f"bound {res['bound_ms']:.4f} ms ({res['bound_by']}, bf16 "
            f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s or "
            f"{PEAK_BYTES / 1e12:.2f} TB/s); grid {res['blocks']} blocks of "
            f"{res['rows_per_block']} rows")


def modes_kernels(torch, K, make_model, pocket, sizes):
    """(a) both bf16 kernels on the calls of a bf16 v3b forward [16, 80,
    192], at the flagship shapes [20, 344, 256] and on the first forward
    of the joint sampler [16, 584, 128]."""
    model = with_egnn(make_model("cuda"), compute_dtype="bfloat16")
    calls = {"v3b": capture_kernel_calls(torch, K, model, pocket, sizes)}
    joint = with_egnn(seeded_model(torch, JOINT_CONFIG, "cuda"),
                      compute_dtype="bfloat16")
    calls["joint"] = joint_first_calls(torch, K, joint, JOINT_B)
    calls["flagship"] = [(name, *flagship_inputs(torch, name, "cuda"))
                         for name in BF16_WRAPPERS]
    results = {}
    for label, recorded in calls.items():
        for wrapper, kernel in BF16_WRAPPERS.items():
            mine = [c for c in recorded if c[0] == wrapper]
            if not mine:
                raise AssertionError(f"[modes] no {wrapper} call ({label})")
            for _, args, kw in mine[1:]:
                check_bf16(torch, K, wrapper, args, kw, reps=2)
            res = check_bf16(torch, K, wrapper, *mine[0][1:], reps=20)
            results.setdefault(kernel, {})[label] = res
            log(f"[modes] (a) {label} {wrapper} bf16 {res['shape']} "
                f"({len(mine)} calls checked): {describe_bf16(res)}")
    return results


def fp32_kernel(wrapper):
    """The wrapper with its fp32 kernel, whatever compute dtype it is
    given."""
    return lambda *args, **kw: wrapper(*args,
                                       **dict(kw, compute_dtype="float32"))


def bf16_fixed_run(torch, make_model, pair, device):
    """v3b in bf16 on ``device``: T_CHECK steps from fixed noise on the
    pair's pocket, BF16_PATH_SIZES ligands; (x, h, mask) on the CPU."""
    sizes = np.array(BF16_PATH_SIZES)
    m = with_egnn(make_model(device), compute_dtype="bfloat16")
    r = m.sample_given_pocket(m.pocket_from_dataset(pair, len(sizes)), sizes,
                              timesteps=T_CHECK,
                              noise=fixed_noise(torch, m, sizes, T_CHECK))
    return [v.cpu() for v in (r.ligand.x, r.ligand.h, r.ligand.mask)]


def bf16_path_error(torch, run, ref):
    """(max |x - x_ref| in A, atom types equal) of two bf16_fixed_run."""
    (x, h, _), (xr, hr, mr) = run, ref
    return (float((x - xr).abs().max()),
            bool(torch.equal(h.argmax(-1)[mr > 0.5], hr.argmax(-1)[mr > 0.5])))


def modes_bf16_path(torch, K, make_model, pocket, sizes, ds, fp32_rows):
    """(b) v3b in bf16: one unguided batch at T=500 (s, launches), a
    fixed-noise run on the card against the CPU's plain bf16 run, beside
    the same run with a fault (the controls, which the gate must fail),
    and the [quality] protocol's unguided row for one seed (recorded)."""
    model = with_egnn(make_model("cuda"), compute_dtype="bfloat16")
    n_layers = model.cfg.egnn.n_layers
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = model.sample_given_pocket(
        pocket, sizes, timesteps=T_MAIN,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {k: K.LAUNCHES[k] for k in BF16_KERNELS}
    want = {k: (T_MAIN + 1) * n_layers for k in BF16_KERNELS}
    fp32 = forward_launches(K)
    finite = all(bool(torch.isfinite(v).all()) for v in
                 (res.ligand.x, res.ligand.h))
    log(f"[modes] (b) v3b bf16, pocket {POCKETS[0]}, B={N_SAMPLES}, "
        f"T={T_MAIN}: {seconds:.3f} s per batch; launches {launches} "
        f"(fp32 kernels {fp32}); finite {finite}")
    if launches != want or any(fp32.values()) or not finite:
        raise AssertionError(f"[modes] bf16 launches {launches} != {want}, "
                             f"or an fp32 launch, or non-finite output")
    cpu_run = bf16_fixed_run(torch, make_model, ds[POCKETS[0]], "cpu")

    def against_cpu(run):
        return bf16_path_error(torch, run, cpu_run)

    def fixed_run(device):
        return bf16_fixed_run(torch, make_model, ds[POCKETS[0]], device)

    err, same_types = against_cpu(fixed_run("cuda"))
    # controls, each with a fault the gate must see: the fp32 kernels in
    # place of the bf16 ones, and the rounding points outside the kernels
    # left out
    import diffndm_tpu_torch.models.egnn as egnn_mod
    faults = {
        "fp32 kernels": [(K, w, fp32_kernel(getattr(K, w)))
                         for w in BF16_WRAPPERS],
        "no rounding outside the kernels": [
            (egnn_mod, "rounding", lambda cfg: (lambda t: t))]}
    controls = {}
    for label, patches in faults.items():
        saved = [(mod, name, getattr(mod, name)) for mod, name, _ in patches]
        for mod, name, fn in patches:
            setattr(mod, name, fn)
        try:
            controls[label] = against_cpu(fixed_run("cuda"))
        finally:
            for mod, name, fn in saved:
                setattr(mod, name, fn)
    log(f"[modes] (b) bf16 T={T_CHECK} fixed noise, B={len(BF16_PATH_SIZES)}: max "
        f"|x_cuda - x_cpu| = {err:.3e} A (atol {BF16_PATH_ATOL}); atom "
        f"types identical: {same_types}; controls: " + "; ".join(
            f"{k} {e:.3e} A, types identical {t}"
            for k, (e, t) in controls.items()))
    if not (err <= BF16_PATH_ATOL and same_types):
        raise AssertionError("[modes] the bf16 kernel path disagrees with "
                             "the plain bf16 path")
    if any(e <= BF16_PATH_ATOL and t for e, t in controls.values()):
        raise AssertionError("[modes] a control with a fault passes the "
                             "bf16 path gate")
    rows = quality_rows(torch, ds, {"unguided bf16": model}, SEED + 1)
    row = rows["unguided bf16"]
    keys = ("valid", "connectivity", "connected", "qed", "sa", "logp")
    beside = (fp32_rows or {}).get("unguided")
    log("[modes] (b) quality, seed 1, unguided: bf16 "
        + ", ".join(f"{k} {row[k]:.3f}" for k in keys)
        + ("; fp32 " + ", ".join(f"{k} {beside[k]:.3f}" for k in keys)
           if beside else "; fp32 row: [quality] (not run with --only)")
        + " (recorded, not gated: JAX has no bf16 quality row)")
    return dict(seconds=seconds, launches=launches, path_err=err,
                controls={k: dict(max_abs_err=e, types_identical=t)
                          for k, (e, t) in controls.items()},
                quality={k: row[k] for k in keys})


def modes_knn(torch, make_model, pocket, sizes):
    """(c) K-nearest-neighbour edges at v3b's width on the main path's
    first state: the forward on the card against the CPU, the share of
    rows with more edges than K, ms per forward beside the dense one."""
    from diffndm_tpu_torch.models.dynamics import build_adjacency

    dense = make_model("cuda")
    state = first_state(torch, dense, pocket, sizes)
    z, xh_p, _, lm, pm = state
    adj = build_adjacency(z[..., :3], xh_p[..., :3], lm, pm,
                          dense.cfg.egnn)
    deg = adj.sum(-1)[torch.cat([lm, pm], 1) > 0.5]
    out = {"dense_ms": forward_ms(torch, lambda: dense.dynamics(*state))}
    for k in KNN_K:
        card = with_egnn(make_model("cuda"), neighbors=k)
        cpu = with_egnn(make_model("cpu"), neighbors=k)
        err = eps_error(torch, card.dynamics(*state),
                        cpu.dynamics(*(s.cpu() for s in state)))
        over = float((deg > k).float().mean())
        ms = forward_ms(torch, lambda: card.dynamics(*state))
        log(f"[modes] (c) K={k} at [{N_SAMPLES}, {adj.shape[-1]}, "
            f"{dense.cfg.egnn.hidden_nf}]: max |eps_cuda - eps_cpu| "
            f"{err:.3e} (atol {CONFIG_EPS_ATOL}); rows with more than K "
            f"edges {over:.3f}; {ms:.3f} ms per forward (dense "
            f"{out['dense_ms']:.3f})")
        if not err <= CONFIG_EPS_ATOL:
            raise AssertionError(f"[modes] K={k}: card and CPU disagree")
        out[k] = dict(max_abs_err=err, rows_over_k=over, ms=ms)
    return out


def modes_band(torch, K, ds, tmp):
    """(d) the sorted band on crossdock_fullatom_cond at its published
    width (seeded weights) on [joint] (b)'s crop: the exact window's
    forward equal to the dense one, the permutation the same on the card
    as on the CPU, the approximate window's forward card against CPU, ms
    per forward of each; (e) generate_ligands on that crop, its window
    line and launch counts, its result equal to the band-off call's."""
    import contextlib
    import dataclasses
    import io

    from diffndm_tpu_torch.config import SampleConfig
    from diffndm_tpu_torch.models import banding

    pdb, sdf, n_rec = joint_receptor(ds, tmp)
    model = seeded_model(torch, BAND_CONFIG, "cuda")
    pocket = model.pocket_from_pdb(pdb, sdf, N_SAMPLES)
    n_real = int(pocket.mask[0].sum())
    sizes = model.sample_ligand_sizes(pocket,
                                      torch.Generator().manual_seed(SEED))
    state = first_state(torch, model, pocket, sizes)
    order = [banding.principal_axis_order(pocket.x.to(d), pocket.mask.to(d))
             [0].cpu() for d in ("cuda", "cpu")]
    same_order = bool(torch.equal(*order))
    dense_eg = model.cfg.egnn
    w_exact = model.enable_banding(pocket)
    exact_eg = model.cfg.egnn
    approx_eg = dataclasses.replace(exact_eg, band_window=BAND_APPROX_W)
    out = {}
    for label, eg in (("dense", dense_eg), ("exact", exact_eg),
                      ("approx", approx_eg)):
        model.set_egnn_config(eg)
        out[label] = model.dynamics(*state)
        out[f"{label}_ms"] = forward_ms(torch,
                                        lambda: model.dynamics(*state))
    exact_err = eps_error(torch, out["exact"], out["dense"])
    approx_dist = eps_error(torch, out["approx"], out["dense"])
    cpu = seeded_model(torch, BAND_CONFIG, "cpu")
    cpu.set_egnn_config(approx_eg)
    small = [s[:BAND_CHECK_B] for s in state]
    model.set_egnn_config(approx_eg)
    approx_err = eps_error(torch, model.dynamics(*small),
                           cpu.dynamics(*(s.cpu() for s in small)))
    n = state[0].shape[1] + state[1].shape[1]
    log(f"[modes] (d) band, {os.path.basename(BAND_CONFIG)} (hidden "
        f"{dense_eg.hidden_nf}, {dense_eg.n_layers} layers, seeded), pocket "
        f"{n_real} atoms of the {n_rec}-atom receptor, [B, N] = "
        f"[{N_SAMPLES}, {n}]: exact window {w_exact} (row tile "
        f"{exact_eg.row_tile}), approximate {BAND_APPROX_W}; order the same "
        f"on the card as on the CPU: {same_order}; max |exact - dense| "
        f"{exact_err:.3e} (atol {CONFIG_EPS_ATOL}); approximate window "
        f"card vs CPU (B={BAND_CHECK_B}) {approx_err:.3e} (atol "
        f"{CONFIG_EPS_ATOL}), its distance from dense {approx_dist:.3e}; ms "
        f"per forward: dense {out['dense_ms']:.3f}, exact "
        f"{out['exact_ms']:.3f}, approximate {out['approx_ms']:.3f}")
    if not (same_order and 0 < w_exact < pocket.x.shape[1]
            and exact_err <= CONFIG_EPS_ATOL
            and approx_err <= CONFIG_EPS_ATOL):
        raise AssertionError("[modes] the band disagrees (see above)")
    gen = seeded_model(torch, BAND_CONFIG, "cuda",
                       sample_cfg=SampleConfig(n_samples=N_SAMPLES,
                                               timesteps=T_MAIN))
    saved = {k: os.environ.pop(k, None)
             for k in ("DIFFNDM_AUTO_BAND", "DIFFNDM_BAND_APPROX")}
    runs = {}
    try:
        # the band off first, then the facade's default (its exact window)
        for label, auto in (("off", "0"), ("auto", "1")):
            os.environ["DIFFNDM_AUTO_BAND"] = auto
            text = io.StringIO()
            K.reset_launches()
            with contextlib.redirect_stdout(text):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                mols, res = gen.generate_ligands(pdb, sdf, seed=SEED)
                torch.cuda.synchronize()
                runs[label] = (time.perf_counter() - t0, res,
                               forward_launches(K), text.getvalue())
    finally:
        os.environ.pop("DIFFNDM_AUTO_BAND")
        os.environ.update({k: v for k, v in saved.items() if v is not None})
    seconds, res, launches, text = runs["auto"]
    want = {k: gen.cfg.egnn.n_layers * (T_MAIN + 1) for k in KERNELS}
    line = [ln for ln in text.splitlines()
            if ln.startswith("[banding] window=")]
    same = bool(torch.equal(res.ligand.x, runs["off"][1].ligand.x))
    log(f"[modes] (e) generate_ligands on the crop, {N_SAMPLES} rows, "
        f"T={T_MAIN}: {seconds:.3f} s ({runs['off'][0]:.3f} s with "
        f"DIFFNDM_AUTO_BAND=0); {line}; band_window "
        f"{gen.cfg.egnn.band_window}, the denoiser's "
        f"{gen.dynamics.cfg.band_window} (an exact window runs dense); "
        f"result equal to the band-off run's: {same}; launches {launches}; "
        f"{sum(m is not None for m in mols)} molecules")
    if not (line and gen.cfg.egnn.band_window and launches == want
            and runs["off"][2] == want and same
            and bool(torch.isfinite(res.ligand.x).all())):
        raise AssertionError(f"[modes] generate_ligands: no window line, "
                             f"launches {launches} != {want}, or a result "
                             f"unlike the band-off run's")
    return dict(window=w_exact, exact_err=exact_err, approx_err=approx_err,
                approx_dist=approx_dist, same_order=same_order,
                ms={k: out[f"{k}_ms"] for k in ("dense", "exact", "approx")},
                generate_seconds=seconds, generate_launches=launches,
                generate_off_seconds=runs["off"][0])


def modes_phase(torch, K, make_model, pocket, sizes, ds, fp32_rows=None):
    """[modes]: (a)-(e); returns the bf16 kernels' rows of the table."""
    t0 = time.perf_counter()
    kernels = modes_kernels(torch, K, make_model, pocket, sizes)
    path = modes_bf16_path(torch, K, make_model, pocket, sizes, ds,
                           fp32_rows)
    knn = modes_knn(torch, make_model, pocket, sizes)
    with tempfile.TemporaryDirectory() as tmp:
        band = modes_band(torch, K, ds, tmp)
    log("[modes] " + json.dumps(dict(path=path, knn=knn, band=band)))
    log(f"[modes] done in {time.perf_counter() - t0:.1f} s")
    return dict(kernels=kernels, path=path, knn=knn, band=band)


# ---------------------------------------------------------------------------
# data parallelism
# ---------------------------------------------------------------------------

def dp_cli(torch, K, train_ds, tmp):
    """(a) The train CLI in this process with ``--device cuda``: one
    process per visible card (one card: this process), resuming v3b's raw
    state for DP_CLI_STEPS micro-steps; against a Trainer in this process
    on the same batches and draws (the CLI's generator, seeded alike)."""
    from diffndm_tpu_torch.cli import train as train_cli
    from diffndm_tpu_torch.config import (load_yaml, model_config_from_yaml,
                                          train_config_from_yaml)
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.data.dataset import (BucketedLoader,
                                                ProcessedLigandPocketDataset,
                                                save_npz_split)
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.train.trainer import Trainer

    datadir = os.path.join(tmp, "dp_data")
    os.makedirs(datadir)
    save_npz_split(os.path.join(datadir, "train.npz"),
                   train_ds.pairs[:DP_CLI_STEPS * N_SAMPLES])
    argv = ["--config", os.path.join(RUN, "hparams.yaml"), "--resume",
            TRAIN_STATE, "--max_steps", str(DP_CLI_STEPS), "--set",
            f"logdir={tmp}", "--set", f"datadir={datadir}", "--set",
            "run_name=dp"]
    world = torch.cuda.device_count()
    log(f"[dp] (a) python -m diffndm_tpu_torch.cli.train {' '.join(argv)} "
        f"on {world} visible card(s)")
    K.reset_launches()
    t0 = time.perf_counter()
    summary = train_cli.main(argv)
    wall = time.perf_counter() - t0
    launches = fp32_launches(K)
    raw = load_yaml(os.path.join(RUN, "hparams.yaml"))
    tcfg = train_config_from_yaml(raw)
    model = DiffNDM(model_config_from_yaml(raw), device="cuda")
    di = dataset_params[model.cfg.dataset]
    trainer = Trainer(model.core, model.dynamics, tcfg,
                      lj_rm=di["lennard_jones_rm"], generator=torch.Generator(
                          device="cuda").manual_seed(tcfg.seed),
                      gamma=model.gamma)
    trainer.load_checkpoint(TRAIN_STATE)
    loader = BucketedLoader(ProcessedLigandPocketDataset(
        os.path.join(datadir, "train.npz")), tcfg.batch_size,
        drop_feature_cols=di["_pad_types"])
    plain = [trainer.train_step(lig, poc)[0]
             for _, (lig, poc) in zip(range(DP_CLI_STEPS), loader)]
    losses = summary["train_losses"]
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses, plain))
    per_step = {"gcl_messages": 5, "edge_vector_reduce": 5,
                "gcl_messages_bwd": 10, "edge_vector_reduce_bwd": 10}
    want = {k: v * DP_CLI_STEPS for k, v in per_step.items()}
    log(f"[dp] (a) {len(losses)} micro-steps in {wall:.1f} s (load and "
        f"checkpoint included): CLI losses {[round(v, 6) for v in losses]}; "
        f"a Trainer in this process on the same batches: "
        f"{[round(v, 6) for v in plain]} (max rel {rel:.2e}; "
        + ("to the bit on one card" if world == 1 else
           f"gate {TRAIN_RTOL} over {world} cards") + ")"
        + (f"; launches {launches} (want {want})" if world == 1 else
           "; launches are counted in the card's own process"))
    if len(losses) != DP_CLI_STEPS or not all(np.isfinite(losses)):
        raise AssertionError("[dp] (a) the CLI run is short or not finite")
    if world == 1 and (losses != plain or launches != want):
        raise AssertionError("[dp] (a) the CLI on one card is not the "
                             "single-process trainer")
    if world > 1 and rel > TRAIN_RTOL:
        raise AssertionError("[dp] (a) the CLI over the cards disagrees "
                             "with one process")
    return dict(world=world, launches=launches if world == 1 else None,
                losses=losses, wall_s=wall)


def dp_guided_config():
    from diffndm_tpu_torch.config import ATPConfig, SampleConfig, SPSAConfig

    return SampleConfig(pocket_pad_multiple=16,
                        spsa=SPSAConfig(enabled=True),
                        atp=ATPConfig(enabled=True))


def dp_sample(torch, K, device, pocket, sizes, noise, group=None):
    """(c) One guided sampling of the whole pocket batch (this rank's rows
    of it under ``group``) under fixed noise, with its forwards and
    launches."""
    from diffndm_tpu_torch.diffusion.sampler import ConditionalSampler
    from diffndm_tpu_torch.model import DiffNDM

    model = DiffNDM.from_yaml(os.path.join(RUN, "hparams.yaml"),
                              device=device, sample_cfg=dp_guided_config(),
                              scorer="native")
    model.load_params_npz(WEIGHTS)
    sampler = ConditionalSampler(model.core, model.dynamics,
                                 model.sample_cfg, model.oracle, group=group)
    forwards = []
    model.dynamics.register_forward_hook(lambda *a: forwards.append(1))
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with torch.no_grad():
        out = sampler.sample_given_pocket(pocket.to(device), sizes,
                                          timesteps=DP_T, noise=noise)
    torch.cuda.synchronize()
    return dict(seconds=time.perf_counter() - t0,
                launches=forward_launches(K), forwards=len(forwards),
                scored=model.oracle.n_scored,
                **{k: v.cpu().numpy() for k, v in (
                    ("x", out.ligand.x), ("h", out.ligand.h),
                    ("mask", out.ligand.mask), ("row_src", out.row_src))})


def dp_train(torch, K, device, steps, group=None):
    """(b) The micro-steps on v3b's raw state; in one process on the
    padded batches.  Returns the losses, ms per micro-step, launches, the
    state and whether this process holds the weights it loaded."""
    from diffndm_tpu_torch.convert import params_from_jax
    from diffndm_tpu_torch.parallel.mesh import pad_rows
    from diffndm_tpu_torch.structs import NodeBatch
    from diffndm_tpu_torch.train.trainer import load_train_state

    _, trainer = make_trainer(torch, device, group=group)
    loaded = params_from_jax(load_train_state(TRAIN_STATE)[0])
    holds_loaded = all(torch.equal(p.cpu(), loaded[n]) for n, p in
                       zip(trainer.names, trainer.params))
    K.reset_launches()
    losses, ms = [], []
    for lig, poc, t_int, noise in steps:
        lig, poc = (NodeBatch(*(torch.from_numpy(a) for a in nb))
                    for nb in (lig, poc))
        if group is None:
            lig, poc = pad_rows(lig, poc, DP_RANKS)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses.append(trainer.train_step(lig, poc, torch.from_numpy(t_int),
                                         torch.from_numpy(noise))[0])
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
    return dict(losses=losses, ms=ms, launches=fp32_launches(K),
                holds_loaded=holds_loaded,
                state=[t.detach().cpu().numpy()
                       for t in trainer.params + trainer.ema])


def noise_arrays(torch, noise):
    """A SamplerNoise as numpy arrays (to send to a rank)."""
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else
                {s: a.numpy() for s, a in v.items()} if isinstance(v, dict)
                else tuple(a.numpy() for a in v))
            for k, v in noise._asdict().items()}


def noise_tensors(torch, arrays):
    from diffndm_tpu_torch.diffusion.sampler import SamplerNoise

    return SamplerNoise(**{
        k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else
            {s: torch.from_numpy(a) for s, a in v.items()}
            if isinstance(v, dict) else tuple(torch.from_numpy(a) for a in v))
        for k, v in arrays.items()})


def dp_rank(group, spec):
    """A rank of (b) and (c) (run by parallel.mesh.spawn)."""
    import torch

    from diffndm_tpu_torch.ops import egnn_kernels as K
    from diffndm_tpu_torch.structs import NodeBatch

    torch.set_grad_enabled(False)
    train = dp_train(torch, K, group.device, spec["train"], group)
    noise = noise_tensors(torch, spec["noise"])
    sample = dp_sample(torch, K, group.device, NodeBatch(
        *(torch.from_numpy(a) for a in spec["pocket"])), spec["sizes"],
        noise, group)
    return dict(train=train, sample=sample, device=str(group.device),
                backend=group.backend)


def dp_phase(torch, K, model, pocket, sizes, train_ds, batches, tmp):
    """(a) the train CLI on every visible card; (b) and (c) on DP_RANKS
    ranks sharing card 0 over gloo and, with more than one card visible,
    over NCCL on one card each, against one process.  ``pocket`` and
    ``sizes``: (c)'s batch (test pocket DP_POCKET)."""
    from diffndm_tpu_torch.diffusion.sampler import count_forwards
    from diffndm_tpu_torch.parallel import mesh
    from diffndm_tpu_torch.parallel.mesh import pad_rows
    from diffndm_tpu_torch.structs import NodeBatch

    t_phase = time.perf_counter()
    cli = dp_cli(torch, K, train_ds, tmp)

    lig, poc = (NodeBatch(*(t.cpu() for t in nb)) for nb in batches[96])
    steps = []
    for i in range(DP_TRAIN_STEPS + 1):
        rows = slice(0, DP_PAD_ROWS if i == DP_TRAIN_STEPS else N_SAMPLES)
        cut = [NodeBatch(*(t[rows] for t in nb)) for nb in (lig, poc)]
        t_int, noise = step_draws(torch, pad_rows(*cut, DP_RANKS)[0],
                                  SEED + 40 + i)
        steps.append((*(tuple(t.numpy() for t in nb) for nb in cut),
                      t_int.numpy(), noise.numpy()))
    single = dp_train(torch, K, "cuda", steps)

    cfg = dp_guided_config()
    noise = event_noise(torch, types.SimpleNamespace(
        sample_cfg=cfg, cfg=model.cfg), sizes, DP_T)
    single_sample = dp_sample(torch, K, "cuda", pocket, sizes, noise)
    forwards = count_forwards(cfg, DP_T)
    spec = dict(train=steps, pocket=tuple(t.cpu().numpy() for t in pocket),
                sizes=np.asarray(sizes), noise=noise_arrays(torch, noise))
    runs = [("gloo", ["cuda:0"] * DP_RANKS)]
    if torch.cuda.device_count() >= DP_RANKS:
        runs.append(("nccl", [f"cuda:{r}" for r in range(DP_RANKS)]))
    out = dict(cli=cli, single_train_ms=single["ms"],
               single_sample_s=single_sample["seconds"], runs={})
    for backend, devices in runs:
        t0 = time.perf_counter()
        ranks = mesh.spawn(dp_rank, DP_RANKS, backend, args=(spec,),
                           devices=devices, timeout=DP_JOIN_TIMEOUT)
        wall = time.perf_counter() - t0
        names = [f"{r['device']} ({torch.cuda.get_device_name(r['device'])})"
                 for r in ranks]
        log(f"[dp] backend {backend}, {DP_RANKS} ranks on {names}: "
            f"spawned, run and joined in {wall:.1f} s")
        # (b) training
        tr = [r["train"] for r in ranks]
        loss_rel = max(abs(a - b) / abs(b) for a, b in
                       zip(tr[0]["losses"], single["losses"]))
        param_share = max(
            float(np.abs(a - b).max()) / (DP_PARAM_RTOL * float(
                np.abs(b).max()) + 1e-30)
            for a, b in zip(tr[0]["state"], single["state"]))
        same_bits = all(
            t["losses"] == tr[0]["losses"] and all(
                np.array_equal(a, b) for a, b in zip(t["state"],
                                                     tr[0]["state"]))
            for t in tr[1:])
        log(f"[dp] (b) {len(single['losses'])} micro-steps of v3b (the N=96 "
            f"batch x {DP_TRAIN_STEPS}, then {DP_PAD_ROWS} rows padded to "
            f"{N_SAMPLES}): losses rank 0 {[round(v, 6) for v in tr[0]['losses']]}"
            f" / one process {[round(v, 6) for v in single['losses']]} (max "
            f"rel {loss_rel:.2e}, gate {TRAIN_RTOL}); params and EMA at most "
            f"{param_share:.3f} of the gate {DP_PARAM_RTOL} x max|p|; ranks "
            f"equal to the bit: {same_bits}; each rank held the weights it "
            f"loaded after the broadcast: "
            f"{[t['holds_loaded'] for t in tr]}; launches per rank "
            f"{[t['launches'] for t in tr]} (one process: "
            f"{single['launches']}); ms per micro-step per rank "
            f"{[[round(v, 1) for v in t['ms']] for t in tr]} (one process "
            f"{[round(v, 1) for v in single['ms']]})")
        if not (loss_rel <= TRAIN_RTOL and param_share <= 1.0 and same_bits
                and all(t["holds_loaded"] for t in tr) and single[
                    "holds_loaded"] and all(t["launches"] == single["launches"]
                                            for t in tr)):
            raise AssertionError(f"[dp] (b) the data-parallel trainer over "
                                 f"{backend} disagrees with one process")
        # (c) guided sampling
        sm = [r["sample"] for r in ranks]
        ref = single_sample
        same_rows = all(np.array_equal(x["row_src"], ref["row_src"]) and
                        np.array_equal(x["mask"], ref["mask"]) for x in sm)
        err = (max(float(np.abs(x["x"] - ref["x"]).max()) for x in sm)
               if same_rows else float("inf"))
        m = ref["mask"] > 0.5
        same_types = same_rows and all(np.array_equal(
            x["h"].argmax(-1)[m], ref["h"].argmax(-1)[m]) for x in sm)
        log(f"[dp] (c) guided SPSA + ATP, pocket {DP_POCKET}, B={N_SAMPLES}, "
            f"T={DP_T} fixed noise: surviving rows {sm[0]['row_src'].tolist()}"
            f" (one process {ref['row_src'].tolist()}); max |x_dp - x_one| "
            f"= {err:.3e} A (atol {PATH_COORD_ATOL}); atom types identical: "
            f"{same_types}; forwards per rank {[x['forwards'] for x in sm]} "
            f"(count_forwards {forwards}, one process {ref['forwards']}); "
            f"launches per rank {[x['launches'] for x in sm]}; rows scored "
            f"per rank {[x['scored'] for x in sm]} (one process "
            f"{ref['scored']}); seconds per rank "
            f"{[round(x['seconds'], 2) for x in sm]} (one process "
            f"{ref['seconds']:.2f})")
        want = {"gcl_messages": 5 * forwards,
                "edge_vector_reduce": 5 * forwards}
        if not (same_rows and same_types and err <= PATH_COORD_ATOL
                and all(np.isfinite(x["x"]).all() for x in sm)
                and all(x["forwards"] == forwards for x in sm)
                and ref["forwards"] == forwards
                and all(x["launches"] == want for x in sm)):
            raise AssertionError(f"[dp] (c) data-parallel guided sampling "
                                 f"over {backend} disagrees with one process")
        out["runs"][backend] = dict(
            wall_s=wall, devices=devices,
            train_launches=tr[0]["launches"], train_ms=[t["ms"] for t in tr],
            sample_launches=sm[0]["launches"],
            sample_s=[x["seconds"] for x in sm], loss_rel=loss_rel,
            param_share=param_share, coord_err=err)
    if any(v == 0 for r in out["runs"].values()
           for v in (*r["train_launches"].values(),
                     *r["sample_launches"].values())):
        raise AssertionError("[dp] a kernel was not launched on a rank")
    log(f"[dp] done in {time.perf_counter() - t_phase:.1f} s")
    return out



# ---------------------------------------------------------------------------
# bf16 training
# ---------------------------------------------------------------------------

def leaf_names(name, args):
    """The names of ``bwd_inputs``' leaves for these arguments (a pair's
    two sets as name0, name1)."""
    keys = GCL_ARGS if name == "gcl_messages" else VEC_ARGS
    out = []
    for i, a in enumerate(args):
        if i == 4 or a is None:
            continue
        out += ([f"{keys[i]}{s}" for s in range(len(a))]
                if isinstance(a, (tuple, list)) else [keys[i]])
    return out


def bf16_bwd_error(torch, g, r, name):
    """The L2 norm of g - r, where for a gradient rounded once per call
    (BF16_ROUNDED) an element one bf16 step from the reference's (the
    final rounding gone the other way) is taken as agreeing."""
    diff = g - r
    if name.rstrip("01") in BF16_ROUNDED:
        big = torch.maximum(g.abs(), r.abs()).clamp_min(1e-30)
        step = torch.exp2(torch.floor(torch.log2(big)) - 7)
        diff = torch.where(diff.abs() <= step, 0.0, diff)
    return float(diff.norm())


def bf16_bwd_gate(torch, K, got, ref, names, plain):
    """(worst share of the gate, passes) of bf16 gradients against a
    reference: each within BF16_BWD_L2 of it in relative L2 norm or, where
    ``plain`` (the plain bf16 backward in fp32, the same formula in fp32
    sums) lies further, within BF16_BWD_NOISE times its distance (errors
    by ``bf16_bwd_error``); those in BF16_ROUNDED bf16 values."""
    worst, ok = 0.0, True
    for name, g, r, q in zip(names, got, ref, plain):
        ok = ok and bool(torch.isfinite(g).all())
        if name.rstrip("01") in BF16_ROUNDED:
            ok = ok and torch.equal(K.bf16_round(g), g)
        bound = max(BF16_BWD_L2 * float(r.norm()),
                    BF16_BWD_NOISE * bf16_bwd_error(torch, q, r, name))
        share = (bf16_bwd_error(torch, g, r, name) / bound if bound
                 else 2.0 * float(g.abs().max() > 0))
        ok = ok and share <= 1.0
        worst = max(worst, share)
    return worst, ok


def bf16_bwd_bound(name, args, kw):
    """(bound ms, what binds) of one bf16 backward call: ``bwd_cost``'s
    work, of whose 6H^2 per edge the recompute s'.W2' (2H^2, both operands
    bf16) runs at the dense bf16 peak, and the two products with du in
    fp32 (4H^2) and the O(H) work at TF32's."""
    ops, nbytes = bwd_cost(name, args, kw)
    h = (args[0][0] if name == "edge_vector_reduce_pair" else args[0]).shape[2]
    bf16_ops = ops * 2 * h * h / (6 * h * h + 24 * h)
    t_ops = bf16_ops / PEAK_BF16_FLOPS + (ops - bf16_ops) / PEAK_TF32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def bwd_sfu_floor_ms(torch, name, args, kw):
    """The special-function floor of one bf16 backward call: two sigmoids
    per (edge, k), of u1 and of u, each an ex2 and a reciprocal on the
    special-function units (16 results per SM per clock), per weight set,
    over the edges with a nonzero adjacency among the rows computed, at
    the card's largest SM clock (the forward's ``sfu_floor_ms`` in
    scripts/forward_build_ab.py counts the same per edge)."""
    if not hasattr(bwd_sfu_floor_ms, "clock_hz"):
        bwd_sfu_floor_ms.clock_hz = 1e6 * float(subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.max.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, check=True).stdout.split()[0])
    pair = name == "edge_vector_reduce_pair"
    a, adj = (args[0][0] if pair else args[0]), args[4]
    n, h = a.shape[1], a.shape[2]
    rows = kw.get("n_rows")
    rows = n if rows is None else max(0, min(n, rows))
    edges = int((adj[:, :rows] != 0).sum())
    ops = edges * 2 * 2 * h * (2 if pair else 1)
    n_sm = torch.cuda.get_device_properties(0).multi_processor_count
    return 1e3 * ops / (16 * n_sm * bwd_sfu_floor_ms.clock_hz)


@contextlib.contextmanager
def dropped_rounding(K, point):
    """The plain bf16 backward with one of BF16_POINTS dropped."""
    chain, dot = K._chain_backward, K._dot_backward
    if point == "ds":                       # ds' = du W2'^T left unrounded
        K._chain_backward = lambda *a: chain(*a[:11])
    elif point == "dm":                     # the gradient of bf16(m)
        K._dot_backward = lambda c, m, w, rnd: (c * w[:, 0],
                                                dot(c, m, w, rnd)[1])
    else:                                   # m, not bf16(m), in dwatt, dwout
        K._dot_backward = lambda c, m, w, rnd: (
            dot(c, m, w, rnd)[0], (c * m).sum((0, 1, 2))[:, None])
    try:
        yield
    finally:
        K._chain_backward, K._dot_backward = chain, dot


def rounding_share(got, ref, fault, names):
    """Where the references with and without a rounding point differ, the
    share of the elements on which ``got`` lies nearer the one with it (a
    tie counts half); None where they agree.  An element of a gradient
    rounded once per call (BF16_ROUNDED) has one vote: the references lie
    one bf16 step of it apart, so a few large elements cannot outvote the
    rest.  The votes of any other gradient are shared out in proportion
    to how far apart the references lie there, so that elements the point
    barely moves, where another program's fp32 sums decide, count little.
    """
    near = total = 0.0
    for name, g, r, f in zip(names, got, ref, fault):
        differ = r != f
        if not bool(differ.any()):
            continue
        r, f, g = r[differ], f[differ], g.double()[differ]
        apart = (r - f).abs()
        weight = (apart.new_ones(apart.shape) if name.rstrip("01") in
                  BF16_ROUNDED else apart / apart.mean())
        dr, df = (g - r).abs(), (g - f).abs()
        near += float((weight * ((dr < df) + 0.5 * (dr == df))).sum())
        total += float(weight.sum())
    return near / total if total else None


def check_bf16_backward(torch, K, name, args, kw, gout, reps, points=False):
    """The bf16 backward kernel (through the wrapper's Function) against
    the plain bf16 backward in float64 on the card, twice for bit
    identity, gated by ``bf16_bwd_gate``; the fp32 backward kernel on the
    same call must fail the gate on the gradients it does not round.
    ``points``: each of BF16_POINTS held by ``rounding_share`` against the
    float64 references with and without it; the plain bf16 backward in
    fp32 without it must fail that, the one with it is recorded.  Timed
    beside the fp32 backward and the plain bf16 backward in fp32 where
    ``reps``."""
    kw = dict(kw, compute_dtype="bfloat16")
    new, leaves, pair = bwd_inputs(torch, name, args)
    names = leaf_names(name, args)

    def kernel_grads(dtype):
        with torch.enable_grad():
            out = getattr(K, name)(*new, **dict(kw, compute_dtype=dtype))
            return torch.autograd.grad(out, leaves, gout)

    got, again = kernel_grads("bfloat16"), kernel_grads("bfloat16")
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, again)):
        raise AssertionError(f"{name} bf16 backward: two launches differ in "
                             f"their bits")
    detached = [tuple(t.detach() for t in a) if isinstance(a, (tuple, list))
                else (a.detach() if a is not None else None) for a in args]
    bwd_plain = getattr(K, name.replace("_pair", "") + (
        "_pair" if pair else "") + "_backward_plain")

    def plain(dtype):
        cast = [tuple(t.to(dtype) for t in a) if isinstance(a, tuple)
                else (a.to(dtype) if a is not None else None)
                for a in detached]
        return flat_grads(bwd_plain(gout.to(dtype), *cast, **kw))

    # the reference: the plain bf16 backward in float64, whose sums and
    # transcendentals move no bf16 rounding as the fp32 ones do
    ref64 = plain(torch.float64)
    ref = [g.float() for g in ref64]
    sound = plain(torch.float32)
    share, ok = bf16_bwd_gate(torch, K, got, ref, names, sound)
    # the plain's own distance, in shares of the L2 bound: the call's
    # conditioning (recorded)
    plain_share = max(bf16_bwd_error(torch, q, r, n) / BF16_BWD_L2
                      / max(float(r.norm()), 1e-30)
                      for n, q, r in zip(names, sound, ref))
    # the control on the gradients that neither backward rounds once per
    # call: the fp32 backward's are never bf16 values
    keep = [i for i, n in enumerate(names) if n.rstrip("01") not in
            BF16_ROUNDED]
    got32 = kernel_grads("float32")
    share32, ok32 = bf16_bwd_gate(
        torch, K, *([x[i] for i in keep] for x in (got32, ref, names, sound)))
    shape = list((args[0][0] if pair else args[0]).shape)
    if not ok:
        raise AssertionError(
            f"{name} bf16 backward {shape}: the kernel disagrees with the "
            f"plain bf16 backward ({share:.3f} of the gate {BF16_BWD_L2})")
    if ok32:
        raise AssertionError(f"{name} bf16 backward {shape}: the fp32 "
                             f"backward passes the bf16 gate")
    res = dict(shape=shape, max_abs_err=max(float((g - r).abs().max())
                                            for g, r in zip(got, ref)),
               gate_share=share, fp32_gate_share=share32,
               plain_share=plain_share)
    if points:
        res["points"] = {}
        for point in BF16_POINTS:
            with dropped_rounding(K, point):
                fault, dropped = plain(torch.float64), plain(torch.float32)
            shares = [rounding_share(x, ref64, fault, names)
                      for x in (got, sound, dropped)]
            if shares[0] is None:
                if (name != "gcl_messages" or kw.get("attention", True)
                        or point == "ds"):
                    raise AssertionError(f"{name} bf16 backward {shape}: "
                                         f"rounding point {point} changes "
                                         f"nothing")
                continue
            if shares[0] < BF16_POINT_MIN:
                raise AssertionError(
                    f"{name} bf16 backward {shape}: the kernel misses "
                    f"rounding point {point} (share {shares[0]:.3f})")
            if shares[2] >= BF16_POINT_MIN:
                raise AssertionError(
                    f"{name} bf16 backward {shape}: the plain backward "
                    f"without rounding point {point} passes its check")
            res["points"][point] = dict(zip(("kernel", "plain", "dropped"),
                                            shares))
    if reps:
        res["ms"] = time_ms(torch, bwd_call(K, name, args, kw, gout, True),
                            reps)
        res["fp32_ms"] = time_ms(torch, bwd_call(K, name, args, kw, gout),
                                 reps)
        # the plain takes 0.1-0.5 s a call at the joint and flagship
        # shapes (fewer reps there): one round of two calls
        res["plain_ms"] = time_ms(torch, lambda: bwd_plain(
            gout, *detached, **kw), 2, warmup=1,
            rounds=3 if reps >= 10 else 1)
        res["bound_ms"], res["bound_by"] = bf16_bwd_bound(name, args, kw)
        res["sfu_floor_ms"] = bwd_sfu_floor_ms(torch, name, args, kw)
        res["blocks"], res["rows_per_block"] = K.bwd_launch_grid(
            name, *shape, kw.get("n_rows"), "bfloat16")
        rows = shape[1] if kw.get("n_rows") is None else min(
            shape[1], max(0, kw["n_rows"]))
        mirror = K.bwd_rows_per_block(shape[0], shape[1], shape[2], rows,
                                      2 if pair else 1, pair)
        if res["rows_per_block"] != mirror:
            raise AssertionError(
                f"{name} bf16 backward {shape}: the library takes "
                f"{res['rows_per_block']} rows per block, its mirror "
                f"bwd_rows_per_block {mirror}")
    return res


def describe_bf16_bwd(res):
    text = (f"max abs {res['max_abs_err']:.3e}, {res['gate_share']:.3f} of "
            f"the gate (the fp32 backward {res['fp32_gate_share']:.2f} on "
            f"the gradients it does not round; the plain in fp32 "
            f"{res['plain_share']:.2f} of the L2 bound)")
    if "points" in res:
        text += "; rounding points, kernel / plain / plain without: " + (
            ", ".join(f"{p} {v['kernel']:.3f} / {v['plain']:.3f} / "
                      f"{v['dropped']:.3f}" for p, v in res["points"].items()))
    if "seed_shares" in res:
        text += (f"; over {len(res['seed_shares'])} gout seeds "
                 f"{min(res['seed_shares']):.3f}-"
                 f"{max(res['seed_shares']):.3f} of the gate (the plain "
                 f"{min(res['seed_plain_shares']):.2f}-"
                 f"{max(res['seed_plain_shares']):.2f} of the L2 bound)")
    if "ms" in res:
        text += (f"; bf16 backward {res['ms']:.4f} ms per call (2 "
                 f"launches), fp32 {res['fp32_ms']:.4f} ms, plain bf16 "
                 f"{res['plain_ms']:.4f} ms, special-function floor "
                 f"{res['sfu_floor_ms']:.4f} ms, bound "
                 f"{res['bound_ms']:.4f} ms ({res['bound_by']}; the "
                 f"recompute at bf16's "
                 f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s, the rest at TF32's "
                 f"{PEAK_TF32_FLOPS / 1e12:.0f}); grid {res['blocks']} "
                 f"blocks of {res['rows_per_block']} rows")
    return text


def bf16train_kernels(torch, K, batches, ds, tmp):
    """(a) Both bf16 backward kernels on the calls of a bf16 v3b training
    forward at each training shape (the first call of each kind timed),
    of [joint-train]'s joint loss forward in bf16 and at the flagship
    shapes."""
    _, trainer = make_trainer(torch, "cuda", compute_dtype="bfloat16")
    groups = []
    for n in TRAIN_N:
        calls = capture_train_calls(torch, K, trainer, *batches[n])
        counts = {w: sum(1 for c in calls if c[0] == w) for w in WRAPPERS}
        if counts != {"gcl_messages": 5, "edge_vector_reduce": 0,
                      "edge_vector_reduce_pair": 5}:
            raise AssertionError(f"[bf16train] a training forward made "
                                 f"{counts} wrapper calls")
        groups.append((n, calls, 10))
    joint = with_egnn(seeded_model(torch, JOINT_CONFIG, "cuda"),
                      compute_dtype="bfloat16")
    pdb, sdf, _ = joint_receptor(ds, tmp)
    loss_value = joint_train_loss(torch, joint, ds, pdb, sdf)
    calls, recorders, originals = first_forward_recorder(
        K, joint.cfg.egnn.n_layers)
    for n, f in recorders.items():
        setattr(K, n, f)
    try:
        loss_value()
    finally:
        for n, f in originals.items():
            setattr(K, n, f)
    groups.append(("joint-train", calls, 5))
    groups.append(("flagship", [
        (w, *flagship_inputs(torch, w, "cuda"))
        for w in ("gcl_messages", "edge_vector_reduce_pair")], 3))
    results = {k: {} for k in BF16_BWD_KERNELS}
    for label, calls, reps in groups:
        for wrapper, kernel in (("gcl_messages", "gcl_messages_bwd_bf16"),
                                ("edge_vector_reduce_pair",
                                 "edge_vector_reduce_bwd_bf16")):
            t0 = time.perf_counter()
            mine = [c for c in calls if c[0] == wrapper]
            pair = wrapper.endswith("_pair")

            def gout(args, seed):
                shape = (args[0][0] if pair else args[0]).shape
                return torch.randn(
                    (*shape[:2], 3 if pair else shape[2]),
                    generator=torch.Generator(device="cuda").manual_seed(
                        seed), device="cuda") * 1e-2

            checks = [check_bf16_backward(
                torch, K, wrapper, args, kw, gout(args, SEED + i),
                reps if i == 0 else 0, points=i == 0)
                for i, (_, args, kw) in enumerate(mine)]
            # the first call's times and rounding points (and, at the
            # kernels line's shape, its gate share over BF16_BWD_SEEDS
            # output gradients); the worst share of the gate over the
            # calls, the least of the control's
            first = dict(checks[0], calls=len(checks))
            if str(label) == BF16_BWD_MAIN:
                _, args, kw = mine[0]
                seeds = [checks[0]] + [check_bf16_backward(
                    torch, K, wrapper, args, kw, gout(args, SEED + 100 + k),
                    0) for k in range(1, BF16_BWD_SEEDS)]
                first["seed_shares"] = [c["gate_share"] for c in seeds]
                first["seed_plain_shares"] = [c["plain_share"] for c in seeds]
            for key, pick in (("gate_share", max), ("max_abs_err", max),
                              ("fp32_gate_share", min),
                              ("plain_share", max)):
                first[key] = pick(c[key] for c in checks)
            results[kernel][str(label)] = first
            log(f"[bf16train] (a) {label} {wrapper} bf16 backward "
                f"{first['shape']} ({len(checks)} calls, gate {BF16_BWD_L2}"
                f", {time.perf_counter() - t0:.1f} s): "
                f"{describe_bf16_bwd(first)}")
    return results


def bf16_train_path_check(torch, K, batches):
    """(b) The fixed-noise micro-step pair of ``train_path_check`` in bf16,
    card against CPU, and the card's fp32 pair as the control that must
    fail the gate: the losses within BF16_TRAIN_RTOL, the gradient norms
    within BF16_TRAIN_NORM and the whole clipped gradient within
    BF16_TRAIN_L2 in relative L2 norm; beside them the plain bf16 chain on
    the card (recorded).  Then the card's optimizer fed the CPU's clipped
    gradients gives the CPU's parameters and EMA within TRAIN_RTOL."""
    card, cpu, control = (fixed_step_pair(torch, batches, d, dt) for d, dt
                          in (("cuda", "bfloat16"), ("cpu", "bfloat16"),
                              ("cuda", "float32")))
    # recorded: the plain bf16 chain on the card (autograd through the
    # plain versions), what two devices' sums alone give
    originals = {n: getattr(K, n) for n in WRAPPERS}
    for n in WRAPPERS:
        setattr(K, n, getattr(K, n + "_plain"))
    try:
        plain = fixed_step_pair(torch, batches, "cuda", "bfloat16")
    finally:
        for n, f in originals.items():
            setattr(K, n, f)

    names = cpu["trainer"].names

    def against_cpu(run):
        loss = max(abs(a[0] - b[0]) / abs(b[0])
                   for a, b in zip(run["infos"], cpu["infos"]))
        norm = max(abs(a[1]["grad_norm"] - b[1]["grad_norm"])
                   / b[1]["grad_norm"]
                   for a, b in zip(run["infos"], cpu["infos"]))
        # the whole clipped gradient (every tensor) in relative L2 norm
        grads = max(math.sqrt(sum(float((a - b).norm()) ** 2
                                  for a, b in zip(ga, gb))
                              / sum(float(b.norm()) ** 2 for b in gb))
                    for ga, gb in zip(run["grads"], cpu["grads"]))
        # recorded: the tensor that differs most in its own L2 norm
        per = [(float((a - b).norm() / b.norm().clamp_min(1e-30)), n)
               for ga, gb in zip(run["grads"], cpu["grads"])
               for n, a, b in zip(names, ga, gb)]
        ok = (loss <= BF16_TRAIN_RTOL and norm <= BF16_TRAIN_NORM
              and grads <= BF16_TRAIN_L2)
        return dict(loss_rel=loss, norm_rel=norm, grad_l2=grads,
                    worst_tensor=max(per), passes=ok)

    res, ctl, pln = (against_cpu(r) for r in (card, control, plain))
    _, replay = make_trainer(torch, "cuda", compute_dtype="bfloat16")
    for grads in cpu["grads"]:
        replay.apply_gradients([t.cuda() for t in grads])
    replay_rel = max(
        float((a.detach().cpu() - b).abs().max() / b.abs().max().clamp_min(
            1e-30)) for a, b in zip(replay.params + replay.ema,
                                    cpu["state"][:-1]))
    log(f"[bf16train] (b) fixed-noise step in bf16, card vs CPU "
        f"({TRAIN_CHECK_B} rows of the N=80 batch, v3b's raw state, 2 "
        f"micro-steps = 1 update): losses "
        f"{[round(a[0], 6) for a in card['infos']]} / "
        f"{[round(b[0], 6) for b in cpu['infos']]} (max rel "
        f"{res['loss_rel']:.2e}, gate {BF16_TRAIN_RTOL}); grad norms "
        f"{[round(a[1]['grad_norm'], 4) for a in card['infos']]} / "
        f"{[round(b[1]['grad_norm'], 4) for b in cpu['infos']]} (max rel "
        f"{res['norm_rel']:.2e}, gate {BF16_TRAIN_NORM}); the clipped "
        f"gradient relative L2 {res['grad_l2']:.2e} (gate {BF16_TRAIN_L2}; "
        f"recorded: the tensor furthest off in its own norm, "
        f"{res['worst_tensor'][1]}, {res['worst_tensor'][0]:.2e}); the "
        f"control, the card's fp32 step: loss {ctl['loss_rel']:.2e}, norm "
        f"{ctl['norm_rel']:.2e}, gradient {ctl['grad_l2']:.2e} "
        f"({ctl['worst_tensor'][1]}, {ctl['worst_tensor'][0]:.2e}); "
        f"recorded, the plain bf16 chain on the card: loss "
        f"{pln['loss_rel']:.2e}, norm {pln['norm_rel']:.2e}, gradient "
        f"{pln['grad_l2']:.2e}; the card's "
        f"optimizer on the CPU's gradients: params and EMA max rel "
        f"{replay_rel:.2e} (gate {TRAIN_RTOL})")
    if not (res["passes"] and replay_rel <= TRAIN_RTOL):
        raise AssertionError("[bf16train] the card's bf16 training step "
                             "disagrees with the CPU's")
    if ctl["passes"]:
        raise AssertionError("[bf16train] the fp32 control passes the bf16 "
                             "step gate")
    return dict(res, control=ctl, plain=pln, replay_rel=replay_rel,
                losses=[a[0] for a in card["infos"]],
                cpu_losses=[b[0] for b in cpu["infos"]])


def bf16_train_steps(torch, K, train_ds, tmp):
    """(b) BF16_TRAIN_STEPS micro-steps of v3b from its raw state on [dp]
    (a)'s cut of the training split (the train CLI's loader and
    generator), in bf16 and in fp32: the losses side by side, ms per
    micro-step, peak device memory, and the launches of each run
    (per micro-step 5 + 5 forward and 10 + 10 backward, all of the run's
    compute dtype)."""
    from diffndm_tpu_torch.config import load_yaml, train_config_from_yaml
    from diffndm_tpu_torch.constants import dataset_params
    from diffndm_tpu_torch.data.dataset import (BucketedLoader,
                                                ProcessedLigandPocketDataset,
                                                save_npz_split)

    path = os.path.join(tmp, "bf16_train.npz")
    save_npz_split(path, train_ds.pairs[:BF16_TRAIN_STEPS * N_SAMPLES])
    tcfg = train_config_from_yaml(load_yaml(os.path.join(RUN,
                                                         "hparams.yaml")))
    per_step = {"gcl_messages": 5, "edge_vector_reduce": 5,
                "gcl_messages_bwd": 10, "edge_vector_reduce_bwd": 10}
    out = {}
    for dtype in ("bfloat16", "float32"):
        model, trainer = make_trainer(
            torch, "cuda", compute_dtype=dtype, generator=torch.Generator(
                device="cuda").manual_seed(tcfg.seed))
        loader = BucketedLoader(
            ProcessedLigandPocketDataset(path), tcfg.batch_size,
            drop_feature_cols=dataset_params[model.cfg.dataset][
                "_pad_types"])
        losses, ms = [], []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K.reset_launches()
        for _, (lig, poc) in zip(range(BF16_TRAIN_STEPS), loader):
            t0 = time.perf_counter()
            losses.append(trainer.train_step(lig, poc)[0])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        launches = dict(K.LAUNCHES)
        peak = torch.cuda.max_memory_allocated() / 2**20
        suffix = "_bf16" if dtype == "bfloat16" else ""
        want = {k + suffix: v * BF16_TRAIN_STEPS for k, v in per_step.items()}
        if ({k: launches[k] for k in want} != want
                or sum(launches.values()) != sum(want.values())
                or len(losses) != BF16_TRAIN_STEPS
                or not all(np.isfinite(losses))):
            raise AssertionError(f"[bf16train] {dtype} micro-steps: "
                                 f"launches {launches} (want {want}) or "
                                 f"losses {losses}")
        out[dtype] = dict(losses=losses, ms=ms, peak_mib=peak,
                          launches={k: launches[k] for k in want})
    b, f = out["bfloat16"], out["float32"]
    rel = [abs(x - y) / abs(y) for x, y in zip(b["losses"], f["losses"])]
    log(f"[bf16train] (b) {BF16_TRAIN_STEPS} micro-steps of v3b on [dp] "
        f"(a)'s {BF16_TRAIN_STEPS * N_SAMPLES} training pairs: losses bf16 "
        f"{[round(v, 6) for v in b['losses']]} / fp32 "
        f"{[round(v, 6) for v in f['losses']]} (rel {max(rel):.2e} at "
        f"most); ms per micro-step bf16 {[round(v, 1) for v in b['ms']]} / "
        f"fp32 {[round(v, 1) for v in f['ms']]}; peak device memory "
        f"{b['peak_mib']:.1f} / {f['peak_mib']:.1f} MiB; launches "
        f"{b['launches']} / {f['launches']}")
    return dict(out, loss_rel=rel)


def bf16train_phase(torch, K, ds, train_ds, batches, tmp):
    """[bf16train]: (a) and (b); returns the bf16 backward kernels' checks
    and the runs."""
    t0 = time.perf_counter()
    kernels = bf16train_kernels(torch, K, batches, ds, tmp)
    path = bf16_train_path_check(torch, K, batches)
    steps = bf16_train_steps(torch, K, train_ds, tmp)
    log(f"[bf16train] done in {time.perf_counter() - t0:.1f} s")
    return dict(kernels=kernels, path=path, steps=steps)


# ---------------------------------------------------------------------------
# [fanout-tap]: the guidance fan-out's own row tile, the frame tap, the
# guided-phase profile
# ---------------------------------------------------------------------------

def fanout_model(make_model, cfg, pocket, approx):
    """v3b on the card (or the CPU) with the facade's band for the crop:
    capped at BAND_APPROX_W with ``approx`` (the denoiser runs the band),
    else its exact window (the denoiser runs dense)."""
    saved = os.environ.pop("DIFFNDM_BAND_APPROX", None)
    try:
        if approx:
            os.environ["DIFFNDM_BAND_APPROX"] = str(BAND_APPROX_W)
        model = make_model(pocket.x.device.type, cfg)
        window = model.enable_banding(pocket, row_tile=FANOUT_TILE)
    finally:
        os.environ.pop("DIFFNDM_BAND_APPROX", None)
        if saved is not None:
            os.environ["DIFFNDM_BAND_APPROX"] = saved
    return model, window


def fanout_path_check(torch, make_model, pocket_cuda):
    """(a) A fixed-noise guided trajectory with the fan-out at tile
    FANOUT_ROW under the capped band, on the card and on the CPU: the same
    rows survive, with the same atom types, at the same coordinates."""
    from diffndm_tpu_torch.config import (ATPConfig, SampleConfig,
                                          SPSAConfig)
    from diffndm_tpu_torch.diffusion.sampler import guidance_events

    cfg = SampleConfig(pocket_pad_multiple=16, fanout_row_tile=FANOUT_ROW,
                       spsa=SPSAConfig(enabled=True, **FANOUT_CHECK["spsa"]),
                       atp=ATPConfig(enabled=True, **FANOUT_CHECK["atp"]))
    events = guidance_events(cfg, FANOUT_CHECK_T)
    assert events == dict(atp=[0], spsa=[1, 0], hybrid=[1]), events
    sizes = np.array(FANOUT_CHECK_SIZES)
    b = len(sizes)
    out, seconds = {}, {}
    for device in ("cuda", "cpu"):
        pocket = pocket_ball(torch, pocket_cuda, b, FANOUT_CHECK_ATOMS,
                             device)
        model, _ = fanout_model(make_model, cfg, pocket, True)
        eg = model.dynamics.cfg
        noise = event_noise(torch, model, sizes, FANOUT_CHECK_T)
        t0 = time.perf_counter()
        res = model.sample_given_pocket(pocket, sizes,
                                        timesteps=FANOUT_CHECK_T, noise=noise)
        seconds[device] = time.perf_counter() - t0
        out[device] = [v.cpu() for v in (res.ligand.x, res.ligand.h,
                                         res.ligand.mask, res.row_src)]
    (xg, hg, mg, rg), (xc, hc, mc, rc) = out["cuda"], out["cpu"]
    same_rows = bool(torch.equal(rg, rc) and torch.equal(mg, mc))
    err = float((xg - xc).abs().max()) if same_rows else float("inf")
    m = mc > 0.5
    same_types = same_rows and bool(
        torch.equal(hg.argmax(-1)[m], hc.argmax(-1)[m]))
    log(f"[fanout-tap] (a) fixed noise, T={FANOUT_CHECK_T}, B={b}, "
        f"{FANOUT_CHECK_ATOMS} pocket atoms, events "
        f"{events}, band window {eg.band_window} at tile {eg.row_tile}, the "
        f"fan-out's {eg.band_window + FANOUT_ROW - eg.row_tile} at tile "
        f"{FANOUT_ROW}: surviving rows cuda {rg.tolist()} cpu "
        f"{rc.tolist()}; max |x_cuda - x_cpu| = {err:.3e} A (atol "
        f"{PATH_COORD_ATOL}); atom types identical: {same_types}; seconds "
        f"cuda {seconds['cuda']:.2f}, cpu {seconds['cpu']:.2f}")
    if not (eg.band_window == BAND_APPROX_W and same_rows and same_types
            and err <= PATH_COORD_ATOL and bool(torch.isfinite(xg).all())):
        raise AssertionError("[fanout-tap] (a): the kernel path disagrees "
                             "with the plain path")
    return dict(err=err, seconds=seconds)


def pocket_ball(torch, pocket, b, n, device):
    """b rows of a batch of one pocket, cut to its n real atoms nearest its
    centre (in their order), on a device."""
    from diffndm_tpu_torch.structs import NodeBatch

    x, m = pocket.x[0].cpu().numpy(), pocket.mask[0].cpu().numpy() > 0.5
    d = np.linalg.norm(x - x[m].mean(0), axis=1)
    keep = np.sort(np.argsort(np.where(m, d, np.inf), kind="stable")[:n])
    assert m[keep].all()
    idx = torch.from_numpy(keep).to(pocket.x.device)
    return NodeBatch(*(v[:1, idx].repeat_interleave(b, 0).to(device)
                       for v in pocket))


class ScoredPopulations:
    """The coordinates an oracle scores, in call order, while the block
    runs (the fan-out's x0 lookaheads and candidates)."""

    def __init__(self, oracle):
        self.oracle, self.seen = oracle, []

    def __enter__(self):
        score = self.oracle.score_batch_types

        def recording(coords, types, mask, weights):
            self.seen.append(np.array(coords, np.float32))
            return score(coords, types, mask, weights)

        self.oracle.score_batch_types = recording
        return self.seen

    def __exit__(self, *exc):
        del self.oracle.score_batch_types


def fanout_runs(torch, K, make_model, pocket, sizes, approx):
    """(b)-(d): SPSA + ATP at B = N_SAMPLES, T = FANOUT_T (SPSA from step
    FANOUT_SPSA_START) with the field at
    FANOUT_ROW and unset, on the capped band (``approx``) or the exact
    one; the first run profiled (DIFFNDM_GUIDED_PROFILE=1).  Returns per
    label the result, seconds, launches, fan-out forwards and the scored
    populations, and the profile's report."""
    import contextlib
    import io

    from diffndm_tpu_torch.config import (ATPConfig, SampleConfig,
                                          SPSAConfig)

    runs, report = {}, None
    for fanout in (FANOUT_ROW, None):
        cfg = SampleConfig(pocket_pad_multiple=16, fanout_row_tile=fanout,
                           spsa=SPSAConfig(enabled=True,
                                           start_step=FANOUT_SPSA_START),
                           atp=ATPConfig(enabled=True))
        model, window = fanout_model(make_model, cfg, pocket, approx)
        banded = []
        hook = model.dynamics.register_forward_pre_hook(
            lambda mod, args, kw: banded.append(kw.get("band") is not None),
            with_kwargs=True)
        profile = approx and fanout is not None
        text = io.StringIO()
        K.reset_launches()
        try:
            if profile:
                os.environ["DIFFNDM_GUIDED_PROFILE"] = "1"
            with ScoredPopulations(model.ensure_oracle()) as seen, \
                    contextlib.redirect_stdout(text):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                g = torch.Generator(device=model.device).manual_seed(SEED)
                res = model.sample_given_pocket(pocket, sizes,
                                                timesteps=FANOUT_T,
                                                generator=g)
                torch.cuda.synchronize()
                seconds = time.perf_counter() - t0
        finally:
            os.environ.pop("DIFFNDM_GUIDED_PROFILE", None)
            hook.remove()
        if profile:
            report = text.getvalue()
        runs[fanout] = dict(res=res, seconds=seconds, window=window,
                            launches=forward_launches(K), seen=seen,
                            forwards=len(banded), banded=sum(banded),
                            model=model, cfg=cfg)
    return runs, report


def fanout_forward_ms(torch, model, pocket, sizes, fan_rows):
    """ms per denoiser forward on the capped band: the trajectory's (B
    rows, tile FANOUT_TILE) and a fan-out of ``fan_rows`` rows at the
    denoiser's tile and at FANOUT_ROW (window widened alike)."""
    state = first_state(torch, model, pocket, sizes)
    reps = -(-fan_rows // state[0].shape[0])
    fan = [torch.cat([v] * reps)[:fan_rows] for v in state]
    eg = model.dynamics.cfg
    wide = (FANOUT_ROW, eg.band_window + FANOUT_ROW - eg.row_tile)
    return dict(
        trajectory=forward_ms(torch, lambda: model.dynamics(*state)),
        fanout_tile8=forward_ms(torch, lambda: model.dynamics(*fan)),
        fanout_tile16=forward_ms(torch, lambda: model.dynamics(
            *fan, band=wide)))


def tap_run(torch, K, make_model, pocket, sizes, tmp):
    """(e) The SDF frame tap every TAP_EVERY steps of an unguided T_MAIN
    batch: the files, the launches, the tap's host time per written frame
    and per step without one."""
    from diffndm_tpu_torch.chem.io import read_sdf
    from diffndm_tpu_torch.diffusion.sampler import make_sdf_frame_tap

    model = make_model("cuda")
    out_dir = os.path.join(tmp, "frames")
    tap = make_sdf_frame_tap(out_dir, model.dataset_info, model.core,
                             every=TAP_EVERY)
    cost = {True: [], False: []}

    def timed(s, *args):
        t0 = time.perf_counter()
        tap(s, *args)
        cost[s % TAP_EVERY == 0].append(time.perf_counter() - t0)

    model.sampler.set_frame_tap(timed)
    K.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    g = torch.Generator(device=model.device).manual_seed(SEED)
    model.sample_given_pocket(pocket, sizes, timesteps=T_MAIN, generator=g)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    model.sampler.set_frame_tap(None)
    names = sorted(os.listdir(out_dir), key=lambda n: int(n[4:-4]))
    want = [f"try_{s}.sdf" for s in range(0, T_MAIN, TAP_EVERY)]
    records = [len(read_sdf(os.path.join(out_dir, n))) for n in names]
    return dict(names=names, want=want, records=records, seconds=seconds,
                launches=forward_launches(K),
                frame_ms=1e3 * float(np.mean(cost[True])),
                step_us=1e6 * float(np.mean(cost[False])),
                frames=len(cost[True]), steps=len(cost[False]))


def fanout_tap_phase(torch, K, make_model, ds):
    """[fanout-tap]: (a)-(f) (see the module's docstring)."""
    from diffndm_tpu_torch.diffusion.sampler import (count_forwards,
                                                     guidance_events)

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        pdb, sdf, n_rec = joint_receptor(ds, tmp)
        base = make_model("cuda")
        pocket = base.pocket_from_pdb(pdb, sdf, N_SAMPLES)
        sizes = base.sample_ligand_sizes(pocket,
                                         torch.Generator().manual_seed(SEED))
        n_real = int(pocket.mask[0].sum())
        check = fanout_path_check(torch, make_model, pocket)
        capped, report = fanout_runs(torch, K, make_model, pocket, sizes,
                                     True)
        exact, _ = fanout_runs(torch, K, make_model, pocket, sizes, False)
        tap = tap_run(torch, K, make_model, pocket, sizes, tmp)
    run = capped[FANOUT_ROW]
    cfg, model = run["cfg"], run["model"]
    n_layers = model.cfg.egnn.n_layers
    forwards = count_forwards(cfg, FANOUT_T)
    events = guidance_events(cfg, FANOUT_T)
    want = {k: forwards * n_layers for k in KERNELS}
    fan_rows = 2 * cfg.spsa.num_probes * N_SAMPLES
    ms = fanout_forward_ms(torch, model, pocket, sizes, fan_rows)
    seen16, seen0 = run["seen"], capped[None]["seen"]
    moved = max(float(np.abs(a - b).max()) for a, b in zip(seen16, seen0))
    res16, res0 = run["res"].ligand.x, capped[None]["res"].ligand.x
    moved_x = float((res16 - res0).abs().max())
    exact_equal = all(bool(torch.equal(u, v)) for u, v in zip(
        exact[FANOUT_ROW]["res"].ligand, exact[None]["res"].ligand))
    log(f"[fanout-tap] v3b on the crop ({n_real} atoms of the {n_rec}-atom "
        f"receptor, [B, N] = [{N_SAMPLES}, {pocket.x.shape[1]} + ligand]), "
        f"SPSA k={cfg.spsa.num_probes} + ATP G={cfg.atp.num_groups}, "
        f"T={FANOUT_T}: events {dict((k, len(v)) for k, v in events.items())}"
        f", {forwards} forwards per run")
    for label, runs in (("capped", capped), ("exact", exact)):
        for fanout, r in runs.items():
            log(f"[fanout-tap] {label} band (facade window {r['window']}, the "
                f"denoiser's {r['model'].dynamics.cfg.band_window}), "
                f"fanout_row_tile={fanout}: {r['seconds']:.3f} s, "
                f"launches {r['launches']}, denoiser forwards {r['forwards']} "
                f"({r['banded']} with the fan-out's own band)")
    log(f"[fanout-tap] (b) launches per kernel {run['launches']} == "
        f"count_forwards {forwards} x {n_layers} layers: "
        f"{run['launches'] == want}")
    log(f"[fanout-tap] (c) capped band, fanout_row_tile={FANOUT_ROW} against "
        f"unset: the scored populations lie up to {moved:.3e} A apart, the "
        f"ligands {moved_x:.3e} A")
    log(f"[fanout-tap] (d) exact band: fanout_row_tile={FANOUT_ROW} and unset "
        f"bit-equal: {exact_equal}")
    log(f"[fanout-tap] ms per forward (capped band, host clock over "
        f"{MODES_REPS} calls): trajectory [{N_SAMPLES} rows] "
        f"{ms['trajectory']:.3f}, fan-out [{fan_rows} rows] at tile "
        f"{FANOUT_TILE} {ms['fanout_tile8']:.3f}, at tile {FANOUT_ROW} "
        f"{ms['fanout_tile16']:.3f}")
    log(f"[fanout-tap] (e) unguided T={T_MAIN}, tap every {TAP_EVERY}: files "
        f"{tap['names']} ({tap['records']} records), {tap['seconds']:.3f} s, "
        f"launches {tap['launches']}; the tap's host time "
        f"{tap['frame_ms']:.3f} ms per written frame ({tap['frames']}), "
        f"{tap['step_us']:.2f} us per step without one ({tap['steps']})")
    log("[fanout-tap] (f) " + report.strip().replace("\n", "\n[fanout-tap] "))
    want_tap = {k: (T_MAIN + 1) * n_layers for k in KERNELS}
    fan_forwards = forwards - FANOUT_T - 1
    if not (all(r["launches"] == want and r["forwards"] == forwards
                for runs in (capped, exact) for r in runs.values())
            and run["banded"] == fan_forwards
            and capped[None]["banded"] == 0
            and run["model"].dynamics.cfg.band_window == BAND_APPROX_W
            and exact[None]["model"].dynamics.cfg.band_window is None):
        raise AssertionError("[fanout-tap] (b): launches or forwards unlike "
                             "the config's count")
    if not moved > 10 * PATH_COORD_ATOL:
        raise AssertionError("[fanout-tap] (c): the fan-out's tile moved "
                             "nothing under the capped band")
    if not exact_equal:
        raise AssertionError("[fanout-tap] (d): the fan-out's tile changed "
                             "the result under the exact band")
    if not (tap["names"] == tap["want"] and tap["launches"] == want_tap
            and tap["records"] == [N_SAMPLES] * len(tap["want"])):
        raise AssertionError("[fanout-tap] (e): the tap's files or the "
                             "launches are wrong")
    phases = set(re.findall(r"^  (\S+)\s+[0-9.]+  x\d+$", report, re.M))
    need = {"segment", "decode", "spsa.probe", "spsa.fetch", "spsa.score",
            "spsa.apply", "atp.cand", "atp.fetch", "atp.score",
            "atp.select", "hyb.branch", "hyb.look", "hyb.fetch", "hyb.score",
            "hyb.select"}
    if report.count("guided-phase profile") != 1 or not need <= phases:
        raise AssertionError(f"[fanout-tap] (f): the profile's report "
                             f"lacks {sorted(need - phases)}")
    seconds = time.perf_counter() - t_phase
    log(f"[fanout-tap] done in {seconds:.1f} s")
    return dict(launches=run["launches"], forwards=forwards,
                fan_forwards=fan_forwards, path_err=check["err"],
                moved=moved, moved_x=moved_x, exact_equal=exact_equal,
                ms=ms, tap={k: tap[k] for k in ("frame_ms", "step_us",
                                                "seconds", "launches")},
                seconds={f"{label}_{f}": r["seconds"]
                         for label, runs in (("capped", capped),
                                             ("exact", exact))
                         for f, r in runs.items()})



def main() -> int:
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--only", choices=["kernels", "phases", "quality",
                                           "train", "vina", "joint",
                                           "variants", "etl", "modes",
                                           "dp", "workers", "bf16train",
                                           "fanout", "optimizer"],
                        default=None, help="stop after the kernel phase, "
                        "print the kernels' cycles per phase, run the "
                        "quality evaluation alone over several seeds, "
                        "run the backward checks and the train phase "
                        "alone, run the kernel checks and the vina, "
                        "optimize-vina and dock phases alone, run the "
                        "kernel checks and the joint, joint-train and "
                        "configs phases alone, run the variants phase "
                        "alone, run the etl phase alone, run the modes "
                        "phase alone, run the data-parallel phase alone, "
                        "time a guided batch with the oracle's workers and "
                        "with one, run the bf16 training phase alone, "
                        "run the fanout-tap phase alone, or run the fused "
                        "optimizer phase alone")
    opts = parser.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    torch.set_grad_enabled(False)
    sys.path.insert(0, REPO)
    from concurrent.futures import ThreadPoolExecutor

    from diffndm_tpu_torch.chem import native
    from diffndm_tpu_torch.config import (ATPConfig, SampleConfig,
                                          SPSAConfig)
    from diffndm_tpu_torch.data.dataset import ProcessedLigandPocketDataset
    from diffndm_tpu_torch.model import DiffNDM
    from diffndm_tpu_torch.ops import egnn_kernels as K
    from diffndm_tpu_torch.ops import fused_optimizer as FO

    smi = nvidia_smi()
    log(f"[identity] {smi}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}")
    if opts.only == "optimizer":
        t0 = time.perf_counter()
        opt_so = K.build_library(source=FO.SOURCE, flags=FO.FLAGS)
        log(f"[identity] optimizer kernels built in "
            f"{time.perf_counter() - t0:.1f} s: "
            f"{os.path.relpath(opt_so, REPO)}")
        log_optimizer_ptxas(opt_so)
        optimizer_phase(torch)
        log("[optimizer] done (--only optimizer: no result)")
        return 0
    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:     # the compilers side by side
        builds = [pool.submit(K.build_library),
                  pool.submit(K.build_library, source=K.BWD_SOURCE),
                  pool.submit(native.build_library),
                  pool.submit(K.build_library, source=FO.SOURCE,
                              flags=FO.FLAGS)]
        so, bwd_so, scorer_so, opt_so = (b.result() for b in builds)
    log(f"[identity] kernels, backward kernels, reward scorer and optimizer "
        f"kernels built in {time.perf_counter() - t0:.1f} s: "
        f"{os.path.relpath(so, REPO)}, {os.path.relpath(bwd_so, REPO)}, "
        f"{os.path.relpath(scorer_so, REPO)}, "
        f"{os.path.relpath(opt_so, REPO)}")
    log_optimizer_ptxas(opt_so)
    # the compiler's report, per instantiation edge_chain_mma<H, VEC> (fp32)
    # and edge_chain_wgmma<H, VEC> (bf16)
    kernel = None
    for line in so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function .*edge_chain_(w?gmma|mma)"
                      r"ILi(\d+)ELb([01])E", line)
        if m:
            name = "edge_vector_reduce" if m[3] == "1" else "gcl_messages"
            kernel = (f"{name}{'_bf16' if m[1] == 'wgmma' else ''} "
                      f"H={int(m[2])}")
        elif kernel and ("registers" in line or "spill" in line):
            log(f"[ptxas] {kernel}: {line.split(':')[-1].strip()}")
    # and per instantiation of the backward: edge_chain_bwd_mma<H, VEC>
    # (fp32) and edge_chain_bwd_wgmma<H, VEC> (bf16)
    kernel = None
    bwd_ptxas = {k: {} for k in (*BWD_KERNELS, *BF16_BWD_KERNELS)}
    for line in bwd_so.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function .*edge_chain_bwd_"
                      r"(w?gmma|mma|reduce)(?:ILi(\d+)ELb([01])E)?", line)
        if m:
            kernel = ("backward reduce" if m[1] == "reduce" else
                      f"{'edge_vector_reduce' if m[3] == '1' else 'gcl_messages'}"
                      f"_bwd{'_bf16' if m[1] == 'wgmma' else ''} H={int(m[2])}")
            continue
        if not kernel or not ("registers" in line or "spill" in line):
            continue
        log(f"[ptxas] {kernel}: {line.split(':')[-1].strip()}")
        if kernel != "backward reduce":
            name, h = kernel.split(" H=")
            nums = {k: int(v) for v, k in re.findall(
                r"(\d+) (?:bytes )?(registers|spill stores|spill loads)",
                line)}
            bwd_ptxas[name].setdefault(h, {}).update(
                {k.replace(" ", "_"): v for k, v in nums.items()})

    hist = np.load(os.path.join(DATA, "size_distribution.npy"))
    unguided_cfg = SampleConfig(pocket_pad_multiple=16)
    guided_cfg = SampleConfig(pocket_pad_multiple=16,
                              spsa=SPSAConfig(enabled=True),
                              atp=ATPConfig(enabled=True))

    def make_model(device, sample_cfg=unguided_cfg):
        model = DiffNDM.from_yaml(
            os.path.join(RUN, "hparams.yaml"), device=device,
            size_histogram=hist, sample_cfg=sample_cfg, scorer="native")
        model.load_params_npz(WEIGHTS)
        return model

    model = make_model("cuda")
    ds = ProcessedLigandPocketDataset(os.path.join(DATA, "test.npz"))
    pockets = [model.pocket_from_dataset(ds[i], N_SAMPLES) for i in POCKETS]
    g = torch.Generator().manual_seed(SEED)
    sizes = [model.sample_ligand_sizes(p, g) for p in pockets]

    if opts.only == "phases":
        phase_cycles(torch, K, model, pockets[0], sizes[0])
        return 0
    if opts.only == "quality":
        quality_spread(torch, ds, {"unguided": model, "guided": make_model(
            "cuda", guided_cfg)})
        inpaint_quality_phase(torch, ds, make_model("cuda"))
        inpaint_quality_spread(torch, ds, make_model("cuda"))
        return 0
    if opts.only == "variants":
        with tempfile.TemporaryDirectory() as tmp:
            variants_phase(torch, K, ds, ProcessedLigandPocketDataset(
                os.path.join(DATA, "train.npz")), tmp)
        log("[variants] done (--only variants: no result)")
        return 0
    if opts.only == "etl":
        with tempfile.TemporaryDirectory() as tmp:
            etl_phase(torch, K, tmp)
        log("[etl] done (--only etl: no result)")
        return 0
    if opts.only == "modes":
        modes_phase(torch, K, make_model, pockets[0], sizes[0], ds)
        log("[modes] done (--only modes: no result)")
        return 0
    if opts.only == "dp":
        train_ds, batches = train_batches(torch, model.device)
        with tempfile.TemporaryDirectory() as tmp:
            dp_phase(torch, K, model, pockets[0], sizes[0], train_ds,
                     batches, tmp)
        log("[dp] done (--only dp: no result)")
        return 0
    if opts.only == "bf16train":
        train_ds, batches = train_batches(torch, model.device)
        with tempfile.TemporaryDirectory() as tmp:
            bf16train_phase(torch, K, ds, train_ds, batches, tmp)
        log("[bf16train] done (--only bf16train: no result)")
        return 0
    if opts.only == "fanout":
        fanout_tap_phase(torch, K, make_model, ds)
        log("[fanout-tap] done (--only fanout: no result)")
        return 0
    if opts.only == "workers":
        guided_workers_phase(torch, make_model, guided_cfg, pockets[0],
                             sizes[0], oracle_workers())
        log("[guided] workers done (--only workers: no result)")
        return 0
    results = kernel_phase(torch, K, model, pockets[0], sizes[0])
    train_ds, batches = train_batches(torch, model.device)
    bwd_results = backward_phase(torch, K, batches,
                                 make_trainer(torch, "cuda")[1], model.device)
    if opts.only == "kernels":
        log("[kernels] done (--only kernels: no result)")
        return 0
    if opts.only == "vina":
        with tempfile.TemporaryDirectory() as tmp:
            _, _, pdb, sdf, vina_sdf = vina_phase(torch, K, ds, tmp)
            optimize_vina_phase(torch, K, tmp, pdb, sdf)
            dock_phase(torch, ds, tmp, pdb, vina_sdf)
        log("[dock] done (--only vina: no result)")
        return 0
    if opts.only == "joint":
        with tempfile.TemporaryDirectory() as tmp:
            _, (pdb, sdf) = joint_phase(torch, K, ds, tmp)
            joint_train_phase(torch, K, ds, pdb, sdf)
            configs_phase(torch, K, ds, pdb, sdf)
        log("[configs] done (--only joint: no result)")
        return 0
    if opts.only == "train":
        train_path_check(torch, batches)
        with tempfile.TemporaryDirectory() as tmp:
            train_cli_phase(torch, K, train_ds, tmp)
        train_step_profile(torch, K, batches)
        optimizer_phase(torch)
        log("[train] done (--only train: no result)")
        return 0
    path_check(torch, make_model, ds[POCKETS[0]])
    launches = main_path(torch, K, model, pockets, sizes)

    guided = make_model("cuda", guided_cfg)
    guided_path_check(torch, make_model, ds[POCKETS[0]])
    guided_launches, calls, population, _ = guided_phase(
        torch, K, guided, pockets, sizes)
    fanout = fanout_phase(torch, K, calls)
    del calls
    oracle_phase(guided, population)
    quality = quality_phase(torch, ds, {"unguided": model, "guided": guided})
    step_phase(torch, K, model, pockets[0], sizes[0])
    del guided
    with tempfile.TemporaryDirectory() as tmp:
        cli_launches, cli_checks = cli_phase(torch, K, ds, tmp)
    guided_path_check(torch, make_model, ds[POCKETS[0]], adjust=True)
    inpaint_path_check(torch, make_model, ds[CLI_POCKET])
    with tempfile.TemporaryDirectory() as tmp:
        inpaint_launches, inpaint_checks, (pdb, sdf) = inpaint_cli_phase(
            torch, K, ds, tmp)
        optimize_launches, optimize_checks = optimize_phase(torch, K, tmp,
                                                            pdb, sdf)
    diversify_path_check(torch, make_model, ds[CLI_POCKET])
    with tempfile.TemporaryDirectory() as tmp:
        sweep_launches, sweep_checks = sweep_phase(torch, K, ds, tmp)
    train_path_check(torch, batches)
    with tempfile.TemporaryDirectory() as tmp:
        train_launches, _ = train_cli_phase(torch, K, train_ds, tmp)
    train_step_profile(torch, K, batches)
    optimizer = optimizer_phase(torch)
    with tempfile.TemporaryDirectory() as tmp:
        vina_launches, vina_checks, pdb, sdf, vina_sdf = vina_phase(
            torch, K, ds, tmp)
        opt_vina_launches, opt_vina_checks = optimize_vina_phase(
            torch, K, tmp, pdb, sdf)
        dock_phase(torch, ds, tmp, pdb, vina_sdf)
    with tempfile.TemporaryDirectory() as tmp:
        joint, (pdb, sdf) = joint_phase(torch, K, ds, tmp)
        joint_train_launches, joint_train = joint_train_phase(
            torch, K, ds, pdb, sdf)
        config_checks, ca_launches = configs_phase(torch, K, ds, pdb, sdf)
    with tempfile.TemporaryDirectory() as tmp:
        variants, variant_train_launches = variants_phase(
            torch, K, ds, train_ds, tmp)
    with tempfile.TemporaryDirectory() as tmp:
        etl = etl_phase(torch, K, tmp)
    modes = modes_phase(torch, K, make_model, pockets[0], sizes[0], ds,
                        quality)
    with tempfile.TemporaryDirectory() as tmp:
        dp = dp_phase(torch, K, model, pockets[0], sizes[0], train_ds,
                      batches, tmp)
    dp_ranks = dp["runs"]["gloo"]
    with tempfile.TemporaryDirectory() as tmp:
        bf16train = bf16train_phase(torch, K, ds, train_ds, batches, tmp)
    fanout_tap = fanout_tap_phase(torch, K, make_model, ds)

    table = [dict(name=name, route="cuda", source=SOURCE, replaces=src,
                  launches=launches[name],
                  max_abs_err=results[name]["max_abs_err"],
                  ms=results[name]["ms"], plain_ms=results[name]["plain_ms"],
                  bound_ms=results[name]["bound_ms"],
                  bound_by=results[name]["bound_by"], library_ms=None,
                  bound_peak="tf32 495 TFLOP/s, 3.35 TB/s",
                  entry=results[name]["entry"],
                  shape=results[name]["shape"],
                  guided_launches=guided_launches[name],
                  cli_launches=cli_launches[name],
                  cli={label: {k: res[k] for k in CALL_KEYS}
                       for label, res in cli_checks[name].items()},
                  inpaint_launches=inpaint_launches[name],
                  optimize_launches=optimize_launches[name],
                  sweep_launches=sweep_launches[name],
                  sweep={k: sweep_checks[name][k] for k in CALL_KEYS},
                  inpaint={k: inpaint_checks[name][k] for k in CALL_KEYS},
                  optimize={k: optimize_checks[name][k] for k in CALL_KEYS},
                  vina_launches=vina_launches[name],
                  vina={label: {k: res[k] for k in CALL_KEYS}
                        for label, res in vina_checks[name].items()},
                  optimize_vina_launches=opt_vina_launches[name],
                  optimize_vina={k: opt_vina_checks[name][k]
                                 for k in CALL_KEYS},
                  fanout={k: fanout[name][k] for k in (
                      "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                      "bound_by", "blocks", "rows_per_block")},
                  joint_sample_launches=joint["sample"]["launches"][name],
                  joint_inpaint_launches=joint["inpaint"]["launches"][name],
                  joint={label: {k: run["checks"][name][k]
                                 for k in CALL_KEYS}
                         for label, run in joint.items()},
                  ca_generate_launches=ca_launches[name],
                  variants_launches={
                      label: {"forward": res["forward_launches"][name],
                              "sample": res["sample_launches"][name]}
                      for label, res in variants.items()},
                  variants={label: {k: v for k, v in res.items()
                                    if not k.endswith("launches")}
                            for label, res in variants.items()},
                  etl_train_launches=etl["launches"][name],
                  etl_sample_launches=etl["sample_launches"][name],
                  dp_cli_launches=(dp["cli"]["launches"] or {}).get(name),
                  dp_train_launches_per_rank=dp_ranks["train_launches"][name],
                  dp_sample_launches_per_rank=dp_ranks["sample_launches"][
                      name],
                  fanout_tap_launches=fanout_tap["launches"][name],
                  configs={cfg: {k: checks[name][k] for k in (
                      *CALL_KEYS, "joint_first") if k in checks[name]}
                           for cfg, checks in config_checks.items()})
             for name, src in KERNELS.items()]
    for name, forward in BWD_KERNELS.items():
        at = bwd_results[name]
        main_res = at[88]
        table.append(dict(
            name=name, route="cuda", source=BWD_SOURCE,
            kernel="edge_chain_bwd_mma", replaces=KERNELS[forward],
            launches=train_launches[name],
            note="the backward of the forward kernel's function; the TPU "
            "kernel has no VJP (JAX differentiates its dense path)",
            max_abs_err=max(r["max_abs_err"] for r in at.values()),
            ms=main_res["ms"], plain_ms=main_res["plain_ms"],
            bound_ms=main_res["bound_ms"], bound_by=main_res["bound_by"],
            library_ms=None, bound_peak="tf32 495 TFLOP/s, 3.35 TB/s",
            shape=main_res["shape"], launches_per_call=2,
            shapes={str(k): {c: r[c] for c in (
                "shape", "max_abs_err", "tolerance_share", "ms", "plain_ms",
                "bound_ms", "bound_by", "blocks")
                if c in r} for k, r in at.items()},
            ptxas=bwd_ptxas[name],
            joint_train_launches=joint_train_launches[name],
            variants_train_launches=variant_train_launches[name],
            etl_train_launches=etl["launches"][name],
            dp_cli_launches=(dp["cli"]["launches"] or {}).get(name),
            dp_train_launches_per_rank=dp_ranks["train_launches"][name],
            joint_train={c: joint_train[name][c] for c in (
                "shape", "max_abs_err", "tolerance_share", "ms", "plain_ms",
                "bound_ms", "bound_by", "blocks")}))
    for name, src in BF16_KERNELS.items():
        at = modes["kernels"][name]
        main_res = at["v3b"]
        table.append(dict(
            name=name, route="cuda", source=SOURCE, replaces=src,
            launches=modes["path"]["launches"][name],
            note="the bf16 variant (mxu_dtype = bfloat16) of the TPU "
            "kernel; EGNNConfig.compute_dtype = 'bfloat16'",
            max_abs_err=max(r["max_abs_err"] for r in at.values()),
            ms=main_res["ms"], plain_ms=main_res["plain_ms"],
            bound_ms=main_res["bound_ms"], bound_by=main_res["bound_by"],
            library_ms=None, bound_peak="bf16 989 TFLOP/s, 3.35 TB/s",
            shape=main_res["shape"], fp32_ms=main_res["fp32_ms"],
            shapes={label: {k: r[k] for k in (
                "shape", "max_abs_err", "gate_share", "fp32_gate_share",
                "ms", "fp32_ms", "plain_ms", "bound_ms", "bound_by",
                "blocks")} for label, r in at.items()}))
    for name, forward in BF16_BWD_KERNELS.items():
        at = bf16train["kernels"][name]
        main_res = at[BF16_BWD_MAIN]
        table.append(dict(
            name=name, route="cuda", source=BWD_SOURCE,
            kernel="edge_chain_bwd_wgmma", replaces=KERNELS[forward],
            launches=bf16train["steps"]["bfloat16"]["launches"][name],
            note="the backward of the bf16 forward (mxu_dtype = bfloat16): "
            "cotangents rounded where the forward rounds; the TPU kernel "
            "has no VJP",
            max_abs_err=max(r["max_abs_err"] for r in at.values()),
            ms=main_res["ms"], plain_ms=main_res["plain_ms"],
            bound_ms=main_res["bound_ms"], bound_by=main_res["bound_by"],
            library_ms=None, bound_peak="bf16 989 TFLOP/s for the "
            "recompute, tf32 495 TFLOP/s for the rest, 3.35 TB/s",
            shape=main_res["shape"], launches_per_call=2,
            fp32_ms=main_res["fp32_ms"], gate=BF16_BWD_L2,
            sfu_floor_ms=main_res["sfu_floor_ms"],
            seed_shares=main_res["seed_shares"],
            shapes={k: {c: r[c] for c in (
                "shape", "max_abs_err", "gate_share", "fp32_gate_share",
                "plain_share", "points", "ms", "fp32_ms", "plain_ms", "bound_ms",
                "bound_by", "sfu_floor_ms", "blocks")} for k, r in at.items()},
            ptxas=bwd_ptxas[name]))
    for name, res in optimizer["kernels"].items():
        table.append(dict(
            name=name, route="cuda", source=OPT_SOURCE, replaces=None,
            note="one phase of the trainer's optimizer span over every "
            "leaf (the JAX package's trainer runs optax under jit: no TPU "
            "kernel)", launches=res["launches"], ms=res["ms"],
            bound_ms=res["bound_ms"], bound_by="bytes",
            bound_peak="3.35 TB/s", library_ms=None,
            span_ms=optimizer["span"]))
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
