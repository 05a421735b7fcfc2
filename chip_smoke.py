#!/usr/bin/env python3
"""Smoke run of the qmps_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and nothing is caught):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the CUDA kernels of qmps_torch/csrc with nvcc for
     sm_90a and prints ptxas's registers and spills per kernel;
  3. represent (K1): 65,536 transfer matrices of seeded left-canonical D = 2
     tensors, and their first 1,024 (the layout of the represent step's
     batch); the kernel (complex64), with and without the left vector w,
     against its plain PyTorch version at complex128 on the card; timed
     raw at 65,536 and 1,024 and queued at 65,536, 4,096 and 1,024;
  4. energy (K2, K3): the sweep's own first-step batch (1024 points x 4
     restarts); forward and adjoint kernels against the plain versions at
     complex128, K3 timed by raw and by queued launches; K2 and K3 also at
     65,536 (the layouts the launchers pick there);
  5. main path, optimize: the config-4 phase-diagram sweep (1024 values of
     g, 300 steps, 4 restarts) on the card, then the represent step on the
     returned states; every returned tensor is read back in float64 against
     the exact TFIM energy, and the launch counters show that K1, K2 and K3
     carried it; K1 timed on the represent step's own 1,024 matrices;
  6. TDVP objective (K4, K5): quench-like inputs at 65,536 (a batched and a
     shared gate), forward and adjoint kernels against the plain versions
     at complex128, gated; bench.py's raw random inputs, reported only;
     K4 (with the left vector) and K5 timed at 65,536 (and, in phase 7,
     K4 on the quench's own batch of 64);
  7. main path, evolve: the ground state of tfim(1.5) (300 L-BFGS steps),
     read back in float64 against the exact energy; the K4/K5 check of
     phase 6 on the quench's own first inner-step inputs, and K4 and K5
     timed on them (64 elements, batched W, the left vector), beside an
     empty kernel launched on K5's grid the same way (the launch floor);
     then the quench
     family 1.5 -> 64 couplings in [0.1, 0.4] (dt 0.02, 30 outer steps of
     80 adam steps, engine="pallas"), timed, against the exact Loschmidt
     rate, and the launch counters show that K4 and K5 carried every inner
     step;
  8. brickwork overlap (K6): (a) bench.py's inputs at its size (65,536;
     seeded QR unitaries, Ml = M^dag, one random 16x16 W), (b) config 5's
     own inputs (16,384), the tensors phase 9 times, and (c) real brickwork
     TDVP inputs at 65,536 (candidate points near the brickwork ground
     state of tfim(1.5), each with the exact right environment of its pair,
     W the quench window gate); every element against the plain version at
     complex128 to 1e-5; kernel, plain version and one batched torch.einsum
     of the 13 operands timed at 65,536, the kernel and the einsum also at
     config 5's 16,384, by raw and by queued launches; each step of K6's
     wrapper timed alone on the host, and config 5's call under
     torch.profiler (device operations and busy time a call);
  9. main path, config 5: BrickworkConfig().run() (16,384 x 30), both rates,
     the launch counter showing that K6 carried the fused row; the fused
     row's time a call against K6's queued time (the difference is the
     host's: the wrapper, the launch and the workload's .abs()) and the
     device's idle share;
 10. the brickwork family in float32 (``brickwork_family``, which
     tests/test_torch_brickwork.py also runs in float32 on the CPU): the
     Loschmidt pipeline from the ground state of phase 8 (12 steps of 120
     inner steps) against the exact rate, and the warm start (the "suN"
     ground state, compiled into bricks, evolved 12 steps of 200 inner
     steps) against the exact rate, each path timed;
 11. K7 and K8 (the normalised power of N = D^2 > 4 matrices): random
     matrices scaled by 1/sqrt(N) at N = 9, 16 (K7), 25, 64 (K8 on the
     tensor cores in one block an element), 81, 144 (1,001 each) and 256
     (133; K8's tiles, ``matpow_tc_tiles_kernel``), one zero matrix in
     each set, and the real D = 4 and D = 8 TDVP transfer matrices of phase
     12's 4,096 pairs, E (4,096, the path's input) and [E, E^dag] (8,192,
     the input of earlier runs); every element's lam (2e-5) and v up to
     phase (1e-4) against the plain version at complex128, both through the
     same _extract_eigpair; the HMMA (tensor-core) instructions of K7's
     and K8's kernels in the library's SASS (cuobjdump); kernel timed on
     both inputs, plain version and torch.linalg.eig on E (one call after
     a warm-up call on one matrix), K7's bound with its products on the tensor cores
     and on the CUDA cores; K8's tiles on the 133 x 256 set timed against
     the plain bmm chain and one torch.linalg.eig + pick (against K8's
     first design above N = 64, in an earlier tree, by ``qmps_torch/kernel_ab.py
     --old``); ``matpow_small_kernel`` (K7 below kMatpowTcMinN, its own
     row, "K7s") checked and timed on the D = 3 objective's 4,096 N = 9
     matrices, raw and queued, against the plain version and eig;
 12. main path, the batched D >= 3 TDVP objective: tdvp_objective_pallas
     and its Bs-gradient on 4,096 pairs at D = 3 (matpow_small_kernel),
     D = 4 (K7) and D = 8 (K8) and on
     1,024 pairs at D = 16 (K8's tiles, N = 256; the point count of the
     large-D sweeps) with a per-pair gate, every element against the dense
     objective at complex128 on the card (values 2e-5, gradients 2e-4
     times max(1, the element's largest |grad|)), one K7 or K8 launch a
     value and gradient, on the matrices E (the left vector is read off
     the same power), and none in the backward, then 20 value-and-gradient
     calls timed;
 13. main path, evolve, one trajectory, in float32 (``evolve_pipeline``):
     loschmidt_echo_run 1.5 -> 0.2 at tests/test_evolve.py:50-60's size
     (20 steps to t = 0.8 of 100 adam steps, a 300-step L-BFGS ground
     state), timed, against the exact rate; its start read back in float64
     (host_energy_gauge_free) against the exact energy; a run killed after
     2 of 4 steps and resumed from its checkpoint, equal to the
     uninterrupted one; compile_state_to_ansatz to overlap > 1 - 1e-4; one
     step of 50 inner steps under torch.profiler (device idle share, the
     largest host operations).  The dense objective launches no hand
     kernel, and the counters show it;
 14. the large-D path in float32: first the environment unroll's two
     kernels alone (``stiefel_unroll_kernels``) at the Stiefel step's
     shape (1,024 rows, 96 iterations, D = 16 and 32) and the chart
     sweeps' (1,024 rows, 24 iterations, D = 2, 4 and 8), from an r0 that
     is an expand: r, lam and A's cotangent against the plain versions at
     complex128 (2e-5, 2e-5 and 1e-4 of the largest entry), one launch each
     way; each kernel timed in turns against plain autograd through the
     same iterations as CUDA graphs, and forward with backward eagerly as a
     sweep runs them; then ``large_d_path``, no hand kernel but the
     unroll's two (the counters show it): one complex64 bmm's error against
     complex128 at full float32 and at the "default" tier; ``StiefelSweepConfig`` at
     full width, 1,024 g in [0.1, 2.0] + 1e-3, D = 16 (300 steps, full
     float32) and D = 32 (180 steps, "default" tier, 60-step full tail),
     each timed after an untimed call of WARM_STEPS steps, read back in
     float64 on the host
     (``host_f64_sweep_energies`` in 8 processes, ``readout_f64``) against
     the exact energy: median < 5e-4,
     max < 5e-3, min > -1e-4; the variance certificates of all 1,024 D = 16
     points (finite, > -1e-6, one against a dense complex128 solve to 1e-4);
     ``right_fixed_point(dense=False)`` against the dense path at D = 16
     (lam 1e-5, r 1e-4); ``LargeDConfig`` (D = 64, 150 steps, the GMRES
     adjoint) within (-1e-4, 5e-3) of exact; one D = 16 descent step of the
     1,024 points under torch.profiler; for the sweep points whose float32
     energy lies below exact (``below_exact_record``): their g, the energy
     read again at final_iters 200 and 2,000, the environment's residual,
     and whether a complex64 product takes TF32 after the sweep;
 15. the classical uMPS path in float32 (``classical_umps``), no hand
     kernel (the counters show it): ``vumps_ground_state`` at D = 8 (250
     iterations, k 32) and ``vumps_ground_state_converged`` at D = 32 and
     64 (tol 3e-4, chunks of 150 to 600 at D = 32 and one chunk of 150 at
     D = 64, k 48, GMRES environments), each
     after an untimed run of WARM_STEPS iterations, timed from a seeded
     generator, read back in
     float64 (``host_energy_gauge_free``) against the exact energy (in
     [-1e-6, 1e-4] at D = 8, [-1e-6, 5e-5] at 32 and 64) with the
     variance certificate in float32 (bench.py's column) and, of the
     nearest exact isometry, in float64 by the dense solve (>= -1e-6);
     MPO-VUMPS at D = 8 against the
     two-site energy; the D = 8 classical TDVP quench 1.5 -> 0.2 (Euler,
     1,200 steps, in float32 from a float64 L-BFGS start) against the
     exact rate (1e-2); the g = 1.5 dispersion
     against the exact one; one ``vumps_step`` with the dense and the
     GMRES environments at D = 16, 24 and 32; one D = 64 iteration under
     torch.profiler;
 16. the chart sweeps and deep brickwork in float32
     (``sweeps_and_deep_brickwork``), no hand kernel but the environment
     unroll's two (the counters show it), each after an untimed call of WARM_STEPS steps and read back in
     float64 on the host from its returned parameters: (a) bench.py's
     `sweep` row, sweep_ground_states D = 2 "suN", 1,024 g in [0.1, 2.0] +
     1e-3, 300 steps, 4 restarts, 1 refine pass (median < 5e-4, max <
     5e-3, min > -1e-6); (b) its `sweep_deep_bw` row, SweepConfig D = 8
     "deep_bw", 1,024 points, 300 steps, 2 refine passes, recycled (the
     same gates, and the float32 minimum printed); (c)
     DeepBrickworkConfig(D = 32, 300 steps, seed 1), host_energy_gauge_free
     within (-1e-6, 5e-3) of exact, with its variance certificate (GMRES
     environments); (d) GrownSweepConfig, 256 points, D 2 -> 16, 300 steps
     (max < 5e-3, min > -1e-6); (e) one "deep_bw" descent step of the
     1,024 points at D = 8 and D = 16 under torch.profiler (step time,
     device operations, idle share);
 17. the noisy and sampled NISQ path in float32 (``noise_and_sampling``),
     no hand kernel (the counters show it): (a) the reference's production
     noise study, ``batched_noise_sweep`` 1.5 -> 0.2 at dt 0.02, 80 adam
     steps a step, the levels 0, 1e-4, 1e-3, 1e-2 and 3e-2 in one batch,
     cut to 30 of 300 outer steps (t_max 0.6) as phase 6's quench, timed
     (its ground state and the sweep it runs, the final states kept)
     after an untimed call of 2 outer steps through the entry point; the
     start read back in float64 within (-1e-9, 5e-4) of exact, every rate
     finite, the p = 0 row within 0.02 of the exact rate, the 3e-2 row's
     last rate below it (the stall), and at the start the float32
     objective and gradient of all five levels against complex128 on the
     card (2e-5, 2e-4 max(1, |grad|)); (b) 4,096 trajectories a level on
     (a)'s final states, within 4 standard errors of the density matrix's
     P0 (equal to 1e-5 at p = 0), timed; (c)
     NoisyNonSparseFullEnergyOptimizer(tfim(1), 1e-3), 300 adam steps, its
     energy in (exact, exact + 0.25), and its trajectory mode (256) within
     0.2 of the density matrix at the start; (d)
     NoisySparseSampledEnergyOptimizer(tfim(1), 200,000 shots, depth 2): 20
     evaluations, each within 5e-2 of the exact energy, their spread
     within (0.5, 2) of the shot noise the exact probabilities predict
     (fresh shots each time), timed, and a Nelder-Mead run of 200
     iterations that ends finite; (e)
     one inner step of (a) under torch.profiler;
 18. the scars Poincare ensembles (``scars_path``), no hand kernel (the
     counters show it, (f)): (a) 100 starts on the <H(0.325)> shell of p0 =
     [0.6, 0.9, 1.1, 0.4] (300 adam steps, float32), the largest residual
     printed; (b) the classical ensemble from them on the example's grid
     (2,000 times on [0, 60], float64, one batched Dormand-Prince run),
     timed, its Poincare sections counted, 8 rows against the port's eager
     odeint on the CPU at the same tolerances (1e-9) and against scipy's
     DOP853 (rtol = atol = 1e-12) on the host: odeint at 1e-12 on t <= 5
     within 1e-6, the default-tolerance rows over the whole horizon within
     1e-2 (the host's references in spawned processes while the card runs);
     (c) ScarsEvolver(0.325, 0.05, 200 inner steps, lr 1e-2) from p0, 12
     steps in float32, within 0.05 of the classical trajectory; (d) the
     quantum ensemble from the 100 starts, 12 steps of 120 inner steps in
     float32, timed, its first 4 rows against the port's float64 run on
     the CPU (1e-3 in wrapped angle), each row's gap to the classical
     ensemble printed, also up to the bond gauges that map (th1, ph2) to
     (-th1, ph2 + pi) and (th2, ph1) to (-th2, ph1 + pi); (e) one inner
     step's time and MFU (``utils/flops.program_costs``), one outer step
     under torch.profiler; and the native planner's plan of K6's network
     beside ``cheapest_contraction``;
 19. sharded sweeps (``sharded_sweeps``, ``parallel/mesh``): (a) phase 5's
     config-4 sweep and its represent step (K1-K3) run three ways, on
     ``make_mesh()`` (every card), on a mesh of the card twice and
     unsharded: every energy within 1e-6 of the unsharded run, both
     sharded runs through phase 5's float64 readout gates, K1-K3 launched
     by every shard; (b) phase 7's quench family cut to 5 outer steps (K4,
     K5) on the card twice against unsharded, its rates within 1e-6; (c)
     the Stiefel sweep at phase 14's D = 32 schedule (120 steps at the
     "default" tier, a 60-step full-float32 tail) on 128 points, on the
     card twice and unsharded: phase 14's float64 readout gates, the
     full-float32 pin (precision "highest", allow_tf32 False) after each
     call, and every shard's first steps under the tier and its polish
     steps at full float32 (each retraction's precision recorded with its
     thread; unsharded, each phase's warm-ups and capture); (d) the wall
     times of each, not gated, with the card count.
Each kernel's entry in the JSON line has its bound: the larger of its
operations over the card's peak for their type and its bytes (each input
read once, each output written once) over 3.35 TB/s, the published H100
SXM peaks (``kernel_work``, ``bound``).  K1-K5's and K7-K8's operations
are those of their functions, every squaring of a complex matrix counted
in its three-product form (``csquare_flops``, also above N = 64: the
bound of K8's tiles is their products on the tensor cores, with the
CUDA-core figure beside it), K4 with one squaring chain
for both eigenvectors; K6's those of the cheapest pairwise contraction
order of its network (``cheapest_contraction``); the unroll's the products
of its iterations (``unroll_work``).  All run on the float32
CUDA cores (67 TFLOP/s) but K7's products from kMatpowTcMinN on, K8's and
K6's W product, which run on the tensor cores in 3xTF32: three TF32
products each, over 495 TFLOP/s.
Prints one JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}.  Without a card, or run outside a checkout
(no qmps_torch beside it), it exits 1 and prints no result.
"""
import contextlib
import dataclasses
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

N_POINTS, STEPS, RESTARTS, LR, MOMENTUM = 1024, 300, 4, 0.1, 0.9
K1_BATCH, K1_ITERS = 65536, 40
# the quench family of docs/TUTORIAL.md:150 on the production time grid
# (dt 0.02, bench.py:545-556), cut to 30 of 300 outer steps (t_max 0.6)
G0, N_G1, G1_MIN, G1_MAX, DT, QUENCH_STEPS, INNER, QUENCH_LR = 1.5, 64, 0.1, 0.4, 0.02, 30, 80, 3e-2
GS_STEPS, TDVP_ITERS, TDVP_BATCH = 300, 48, 65536
# the batched D >= 3 TDVP objective at the size the JAX package measured it
# (qmps_tpu/kernels/pallas_power.py:514-516, scripts/tpu_pallas_grad_bench.py:
# 27-28): 4,096 pairs, 48 squarings; D = 4 runs K7 (N = 16), D = 8 K8 (N = 64)
BIG_BATCH, BIG_CALLS = 4096, 20
# D -> (the kernel, its counter, the pairs); D = 3 runs K7 below
# kMatpowTcMinN (matpow_small_kernel, N = 9); D = 16 runs K8's tiles
# (N = 256) on 1,024 pairs, the point count of the large-D sweeps
# (StiefelSweepConfig)
BIG_DS = {3: ("K7s", "matpow_small", BIG_BATCH), 4: ("K7", "matpow_small", BIG_BATCH),
          8: ("K8", "matpow_large", BIG_BATCH), 16: ("K8t", "matpow_large", 1024)}
# phase 11: K8's tiles on random sets (N = 81, 144 and the timed 133 x 256)
TILE_SETS, K8T_N = ((81, 1001), (144, 1001), (256, 133)), 256
# phase 19: the quench family of phase 7 cut to 5 outer steps; the Stiefel
# sweep at phase 14's D = 32 schedule ("default" tier, 60-step full-float32
# tail) on 128 of its 1,024 points, read back on 4 host processes
SHARD_QUENCH_STEPS = 5
SHARD_STF_D, SHARD_STF_POINTS, SHARD_STF_WORKERS = 32, 128, 4
# the brickwork family (tests/test_brickwork.py:109-129, 171-205)
BW_BATCH, BW_G0, BW_G1 = 65536, 1.5, 0.2
# the single-trajectory evolve pipeline at the JAX test's own size
# (tests/test_evolve.py:50-60): 20 steps to t = 0.8 of 100 adam steps
ECHO_G0, ECHO_G1, ECHO_T, ECHO_STEPS, ECHO_INNER, ECHO_GS = 1.5, 0.2, 0.8, 20, 100, 300
# the large-D path: StiefelSweepConfig at full width (qmps_tpu/workloads.py:218-262)
# with bench.py's schedules (bench.py:765-770): D = 16 300 steps in full
# float32, D = 32 180 steps at the "default" tier with a 60-step full tail;
# LargeDConfig (workloads.py:348-380): D = 64, 150 steps
STF_POINTS, STF_G = 1024, (0.1, 2.0)
STF_RUNS = {16: {"steps": 300}, 32: {"steps": 180, "precision": "default", "polish_steps": 60}}
WARM_STEPS = 10  # the untimed warm-up of the phase-14 sweeps and the phase-15 VUMPS runs
# phase 14's first part: the environment unroll's two kernels at the shapes
# of their callers, D -> (rows, iterations): the Stiefel step's (D = 16 and
# 32: 1,024 rows, 96 iterations) and the chart sweeps' recycled loss (D = 2,
# 4 and 8: a 1,024-point batch, 24 iterations); D = 16's figures are the
# kernels' entries of the JSON line
UNROLL_SHAPES = {16: (1024, 96), 32: (1024, 96), 2: (1024, 24), 4: (1024, 24), 8: (1024, 24)}
UNROLL_REPS = 20
LARGE_D, LARGE_D_STEPS = 64, 150
# the classical uMPS path at bench.py's VUMPS rows (bench.py:589-675,
# :779-786): D = 8 250 iterations (k 32), D = 32 and 64 run to the knee
# with the GMRES environments; the MPO, trajectory and dispersion checks
# of tests/test_mpo.py:209-220, tests/test_tdvp_classical.py:62-77 and
# tests/test_excitations.py:47-57; the dense/GMRES crossover of one
# vumps_step (k 48)
VUMPS_DS, VUMPS_D8 = (8, 32, 64), {"iters": 250, "k": 32}
VUMPS_CONV = {"tol": 3e-4, "chunk_iters": 150, "max_iters": 600, "k": 48, "env_solver": "gmres"}
# D = 64 runs one chunk: its knee is at 8 iterations and its gradient never
# reaches tol (5.8e-4 after 600), so iterations 151-600 moved no gate and
# took ~110-145 s of the script's 1,200 on an H100
VUMPS_D64_ITERS = 150
TRAJ_G0, TRAJ_G1, TRAJ_T, TRAJ_STEPS, TRAJ_D, TRAJ_GS = 1.5, 0.2, 1.2, 1200, 8, 400
DISP_G, DISP_D, DISP_ITERS, CROSS_DS = 1.5, 8, 200, (16, 24, 32)
# phase 16: bench.py's `sweep` row (bench.py:229-270: D = 2 "suN", 4
# restarts, 1 refine pass) and `sweep_deep_bw` row (:348-378: D = 8
# "deep_bw", 2 refine passes) at 1,024 g in [0.1, 2.0] + 1e-3, 300 steps;
# DeepBrickworkConfig(D = 32, 300 steps, seed 1; workloads.py:388-414);
# GrownSweepConfig (workloads.py:174-215: 256 points, D 2 -> 16, 300 steps)
SW_POINTS, SW_STEPS, SW_RESTARTS, SW_DBW_D, DBW_D, GROWN_POINTS = 1024, 300, 4, 8, 32, 256
# gates set from a float32 run of classical_umps on the CPU:
# MPO-VUMPS's float64 readout 4.1e-10 off the two-site state's; the
# float32 H_X build 1.5e-4 off the exact dispersion, where a float64 build
# of the same state reads 2.5e-10 (the float32 mixed gauge's Cholesky
# jitter, 32 eps)
MPO_GATE, DISP_GATE = 1e-7, 1e-3
# phase 17: the reference's production noise study (scripts/loschmidt.py:
# 335-407): TFIM 1.5 -> 0.2 at dt 0.02 under depolarizing noise 1e-4 to
# 1e-2 a qubit a moment, with the noiseless row and the strong level of
# tests/test_capabilities.py:159-183; 80 adam steps at 3e-2 a step, a
# 300-step L-BFGS ground state; cut to 30 of 300 outer steps (t_max 0.6),
# as the quench of phase 6; tests/test_capabilities.py:35-72's noisy and
# sampled optimizers (300 adam steps; 200,000 shots) and
# tests/test_trajectories.py:86-98's trajectory mode (256)
NOISE_LEVELS, NOISE_STEPS, NOISE_TRAJ = (0.0, 1e-4, 1e-3, 1e-2, 3e-2), 30, 4096
NOISY_ADAM, NOISY_TRAJ, SAMPLED_SHOTS, SAMPLED_EVALS, SAMPLED_NM_ITERS = 300, 256, 200000, 20, 200
NOISE_TRAJ_CALLS = 50  # (b)'s timed calls
# phase 18: the scars Poincare ensembles at the README's width (100
# trajectories of the 2-site cell, the 16 x 16 gate, 4 x 4 transfer
# matrices; mu 0.325 and p0 of tests/test_scars.py:44-57), the classical
# one on examples/scars_poincare.py:41-42's grid (2,000 times on [0, 60]);
# the quantum ensemble cut to 12 steps of 120 inner steps at dt 0.05
SCARS_MU, SCARS_P0, SCARS_N, SCARS_T, SCARS_TIMES = 0.325, (0.6, 0.9, 1.1, 0.4), 100, 60.0, 2000
SCARS_DT, SCARS_STEPS, SCARS_INNER, SCARS_SHELL_STEPS = 0.05, 12, 120, 300
SCARS_ORACLE_ROWS, SCARS_ORACLE_T = 8, 5.0  # (b)'s rows against DOP853, and the tight run's horizon
SCARS_F32_GATE = 1e-3  # (d): float32 against float64, wrapped angle
# (b): the timed ensemble's rows against the port's eager odeint on the CPU
# at the same default tolerances; a 1-ulp noise on every right-hand side
# moves a row up to 3.3e-11 by t = 60 (a CPU rehearsal)
SCARS_CPU_GATE = 1e-9

# published H100 SXM peaks (NVIDIA's data sheet): float32 outside the
# tensor cores, TF32 on the tensor cores (dense), device memory
PEAK_F32, PEAK_TF32, PEAK_BYTES = 67e12, 495e12, 3.35e12
CMAC, CMUL = 8, 6  # real flops of a complex multiply-add (4 FMAs) and of a product


def csquare_flops(N):
    """Real flops of the square of an N x N complex matrix R + iI in its
    three-product form, the form the TPU's K8 squares in: R R, I I and
    (R + I)(R + I) (6 N^3), N^2 adds before them and 3 N^2 after (re = RR -
    II, im = (R + I)^2 - RR - II).  The kernels do 8 N^3, as four products."""
    return 6 * N ** 3 + 4 * N * N


def matpow_flops(N, iters):
    """csrc/matpow.cu (K7, K8): the first normalisation and, per squaring,
    the square and the normalisation of its N^2 entries (6 flops each: the
    square, the sum, the scaling)."""
    return iters * (csquare_flops(N) + N * N * 6) + N * N * 6


def matpow_tc_flops(N, iters):
    """K7 and K8 on the tensor cores: (TF32 flops, float32 flops).  The
    three real products of each squaring (6 N^3) in 3xTF32, three TF32
    products each; the rest of ``matpow_flops`` (the N^2 work) on the CUDA
    cores."""
    products = iters * 6 * N ** 3
    return 3 * products, matpow_flops(N, iters) - products


def solve_flops(iters):
    """planes.cuh::solve4 by squaring: per squaring the square of a 4x4
    complex matrix and the normalisation of its 16 entries (6 flops each);
    then three matvecs, the Rayleigh quotient and two norms."""
    return iters * (csquare_flops(4) + 16 * 6) + 52 * CMAC + 56


# K6's network per element: 13 operands over 2-dim indices, the U2 columns
# (c2) and U2'^dag rows (r2) already read at |00> (circuits/brickwork.
# manifold_overlap), listed in an order that keeps every intermediate at 64
# entries an element if torch.einsum contracts them left to right
K6_NETWORK = (("c2", (12, 13)), ("U1", (18, 19, 13, 14)), ("c2", (14, 15)), ("U1", (20, 21, 15, 16)),
              ("c2", (16, 17)), ("Ml", (26, 12)), ("Mr", (31, 17)), ("W", (22, 23, 24, 25, 18, 19, 20, 21)),
              ("U1d", (27, 28, 22, 23)), ("r2", (26, 27)), ("U1d", (29, 30, 24, 25)), ("r2", (28, 29)),
              ("r2", (30, 31)))


@functools.lru_cache(maxsize=None)
def cheapest_contraction(network):
    """(complex multiply-adds, complex products) of the cheapest pairwise
    contraction order of a closed network whose indices are all 2-dim and
    each on two operands: dynamic programming over subsets of operands.  A
    pair that shares an index costs one multiply-add per term of the union
    of their open indices, an outer product one product per entry."""
    ids = sorted({i for _, idx in network for i in idx})
    masks = [sum(1 << ids.index(i) for i in idx) for _, idx in network]
    n = len(masks)
    full = (1 << n) - 1
    inside = [0] * (full + 1)
    for S in range(1, full + 1):
        low = S & -S
        inside[S] = inside[S ^ low] | masks[low.bit_length() - 1]
    best = {1 << i: (0, 0, 0) for i in range(n)}  # (flops, multiply-adds, products)
    for S in sorted(range(1, full + 1), key=lambda x: bin(x).count("1")):
        if S in best:
            continue
        cands, A = [], (S - 1) & S
        while A:
            B = S ^ A
            if A < B:
                oa, ob = inside[A] & inside[full ^ A], inside[B] & inside[full ^ B]
                terms, mac = 1 << bin(oa | ob).count("1"), bool(oa & ob)
                (fa, ma, pa), (fb, mb, pb) = best[A], best[B]
                cands.append((fa + fb + (CMAC if mac else CMUL) * terms, ma + mb + mac * terms,
                              pa + pb + (not mac) * terms))
            A = (A - 1) & S
        best[S] = min(cands)
    return best[full][1:]


def k6_flops(tensor_cores=True):
    """K6's work an element, (float32 flops, TF32 flops): the cheapest
    contraction of its network (1,444 multiply-adds: Ml and Mr fold into
    the outer c2 and r2 first, and W's 1,024 dominate), not the 1,808 of
    the kernel as written.  On the tensor cores W's product over the four
    sectors is three real 16 x 16 by 16 x 4 products (Karatsuba) in
    3xTF32, three TF32 products each; the rest, and Karatsuba's adds (V's
    sum before, three after: 4 x 64), on the CUDA cores."""
    mac, mul = cheapest_contraction(K6_NETWORK)
    if not tensor_cores:
        return CMAC * mac + CMUL * mul, 0
    products = 3 * 2 * 16 * 16 * 4
    return CMAC * (mac - 1024) + CMUL * mul + 4 * 64, 3 * products


def kernel_work(name, B, w_bytes=0):
    """(float32 flops, bytes, TF32 flops) of one launch over B elements: a
    complex multiply-add is 8 flops, a product 6; each input byte read once
    and each output byte written once (``w_bytes``: a W read once per launch
    or per element).  K1-K5 and K7-K8 count their functions, each squaring
    in its three-product form (``csquare_flops``); K4 one squaring chain and
    the left vector read off its power; K7's and K8's products on the
    tensor cores (``matpow_tc_flops``) but K7's below kMatpowTcMinN
    ("K7s", N = 9: ``matpow_flops`` on the CUDA cores); K6 the cheapest
    contraction of its
    network with W's product on the tensor cores (``k6_flops``), and U2's
    and U2''s whole rows, which its column reads touch."""
    aa, e = 16 * (CMUL + CMAC), 64 * CMAC  # build_AA, build_E
    flops, nbytes = {
        "K1": (solve_flops(K1_ITERS), 128 + 8 + 32),
        "K2": (2 * aa + e + solve_flops(48) + 64 * CMAC + 124, 64 + 128 + 4 + 8 + 32),
        # before the series ~3,660, the series 24 x 80 multiply-adds, after it ~4,730
        "K3": (3656 + 24 * 80 * CMAC + 4732, 64 + 128 + 32 + 8 + 4 + 64 + 128),
        # the two AA builds, WAA, E, one solve, and u off the power: two
        # chirp matvecs (32 multiply-adds), their norms and the scaling
        "K4": (2 * aa + 2 * e + solve_flops(TDVP_ITERS) + 32 * CMAC + 32, 64 + 64 + 8 + 32 + 32),
        # the two AA builds, WAA, P and C (96 multiply-adds each), Wbar and
        # Q (64 each), the two AA-build adjoints (64 each), the coefficient
        "K5": (2 * aa + e + 2 * 96 * CMAC + 4 * 64 * CMAC + 60,
               64 + 64 + 32 + 32 + 8 + 4 + 64 + 64 + 128),
        "K6": (k6_flops()[0], 4 * 128 + 32 + 32 + 8),
        # the main path's N: D = 3, 4 and 8 transfer matrices, read and
        # written once; at D = 3 (matpow_small_kernel) the products on the
        # CUDA cores, at D = 4 and 8 on the tensor cores
        "K7s": (matpow_flops(9, TDVP_ITERS), 2 * 8 * 9 ** 2),
        "K7": (matpow_tc_flops(16, TDVP_ITERS)[1], 2 * 8 * 16 ** 2),
        "K8": (matpow_tc_flops(64, TDVP_ITERS)[1], 2 * 8 * 64 ** 2),
        # K8's tiles at N = 256 (phase 11's set, phase 12's D = 16)
        "K8t": (matpow_tc_flops(K8T_N, TDVP_ITERS)[1], 2 * 8 * K8T_N ** 2),
    }[name]
    tc = {"K7": lambda: matpow_tc_flops(16, TDVP_ITERS)[0], "K8": lambda: matpow_tc_flops(64, TDVP_ITERS)[0],
          "K8t": lambda: matpow_tc_flops(K8T_N, TDVP_ITERS)[0], "K6": lambda: k6_flops()[1]}.get(name, lambda: 0)()
    return flops * B, nbytes * B + w_bytes, tc * B


def bound(flops, nbytes, tc_flops=0):
    """(bound_ms, what sets it): the larger of the operations (float32 over
    its peak plus TF32 over the tensor cores') and the bytes over the
    memory rate."""
    t_ops = (flops / PEAK_F32 + tc_flops / PEAK_TF32) * 1e3
    t_mem = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def cuda_ms(fn, reps, warm_up=True, queued=False):
    """Mean time of fn over reps calls on the card's timeline, by CUDA
    events after one warm-up call (for a plain version made of many small
    launches this includes the gaps the host leaves between them; so does
    a kernel shorter than the host's launch).  ``queued``: the calls wait
    behind a ~10 ms spin kernel (torch.cuda._sleep) until the host has
    queued them all, so the events time the card's work alone."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown(fn, reps, host_ops=0):
    """torch.profiler over reps calls of fn: (host ms a call, device-busy ms
    a call, the four kernels of most device time as (name, ms a call),
    device operations a call).  Busy is the union of the kernels'
    intervals; None where the profiler recorded no kernel.  ``host_ops``:
    print that many host operations of most self time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        host = (time.perf_counter() - t0) * 1e3 / reps
    if host_ops:
        print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=host_ops))
    spans = sorted((e.time_range.start, e.time_range.end, e.name) for e in prof.events()
                   if e.device_type == DeviceType.CUDA)
    if not spans:
        return host, None, [], 0.0
    busy, end, by_name = 0.0, float("-inf"), {}
    for a, b, name in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
        by_name[name] = by_name.get(name, 0.0) + (b - a) / 1e3 / reps
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return host, busy / 1e3 / reps, top, len(spans) / reps


def host_steps(steps, reps=200):
    """{step: host microseconds a call}: each step alone, reps times in a
    loop, timed on the host's clock up to the last call's return (reps stay
    under the card's launch queue, so a step that launches never waits for
    the card), then synchronised outside the timing."""
    out = {}
    for name, fn in steps.items():
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) * 1e6 / reps
        torch.cuda.synchronize()
    return out


def require(ok, what):
    """Fail the run (not an assert: -O would strip it)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def left_canonical(rng, B, D=2):
    """(B, 2, D, D) left-canonical tensors A[s, i, j] from numpy QR."""
    x = rng.standard_normal((B, 2 * D, D)) + 1j * rng.standard_normal((B, 2 * D, D))
    V, _ = np.linalg.qr(x)
    return V.reshape(B, D, 2, D).transpose(0, 2, 1, 3)


def transfer(A):
    """One-site transfer matrices E[(i j), (k l)] = sum_s A[s,i,k] conj(A[s,j,l])."""
    return torch.einsum("bsik,bsjl->bijkl", A, A.conj()).reshape(-1, 4, 4)


def phase_aligned(v, ref):
    """v rotated by the global phase that best matches ref (a zero row as it is)."""
    ph = (v.conj() * ref).sum(-1)
    return v * torch.where(ph.abs() > 0, ph / ph.abs(), torch.ones_like(ph))[:, None]


def isometry_f64(A):
    """The nearest exact isometry, in float64, to each returned f32 tensor
    (n, 2, D, D): host_energy_d2 assumes left-canonical input, and f32
    leaves a ~1e-7 defect that would bias the readout by as much."""
    n, D = A.shape[0], A.shape[-1]
    V = A.transpose(0, 2, 1, 3).reshape(n, 2 * D, D)
    U, _, Wh = np.linalg.svd(V, full_matrices=False)
    return (U @ Wh).reshape(n, D, 2, D).transpose(0, 2, 1, 3)


def near_isometry(rng, A, eps):
    """The nearest left-canonical tensors, in float64, to A + eps * complex
    normal noise (n, 2, D, D): a TDVP candidate B close to its A."""
    noise = rng.standard_normal(A.shape) + 1j * rng.standard_normal(A.shape)
    return isometry_f64(A + eps * noise)


def tdvp_check(tdf, tag, A, B, W, gate):
    """K4 (with the left vector) and K5 (cotangent 1) against their plain
    versions at complex128 on the same inputs: the value -|lam| and lam to
    2e-5 (bench.py:212), v and w up to phase to 1e-4, and Abar, Bbar and
    the per-element Wbar to 2e-4 times max(1, the element's largest |bar|)
    (tests/test_tdvp_fused.py:63, scaled as K3's bound is).  Returns
    (largest |dlam|, largest absolute |dbar|)."""
    c128 = torch.complex128
    n = A.shape[0]
    lam, v, w = tdf._fwd_cuda(A, B, W, TDVP_ITERS, True)
    ct = torch.ones(n, device=A.device)
    bars = tdf._bwd_cuda(A, B, W, lam, v, w, ct)
    A2, B2, W2 = A.to(c128), B.to(c128), W.to(c128).expand(n, 4, 4)
    lam_p, v_p, w_p = tdf._fwd_plain(A2, B2, W2, TDVP_ITERS, True)
    bars_p = tdf._bwd_plain(A2, B2, W2, lam_p, v_p, w_p, ct.double())
    err_obj = (lam.abs().double() - lam_p.abs()).abs().max().item()
    err_lam = (lam.to(c128) - lam_p).abs().max().item()
    err_v = (phase_aligned(v.to(c128), v_p) - v_p).abs().max().item()
    err_w = (phase_aligned(w.to(c128), w_p) - w_p).abs().max().item()
    scaled, over, absmax = [], 0, 0.0
    for k, p in zip(bars, bars_p):
        d = (k.to(c128) - p).abs().reshape(n, -1).max(1).values
        sc = p.abs().reshape(n, -1).max(1).values.clamp(min=1.0)
        scaled.append((d / sc).max().item())
        over += int((d > 2e-4 * sc).sum())
        absmax = max(absmax, d.max().item())
    print(f"{tag} ({n}): K4 |d(-|lam|)| {err_obj:.3g}, |dlam| {err_lam:.3g} (tol 2e-5), |dv| {err_v:.3g}, "
          f"|dw| {err_w:.3g} up to phase (tol 1e-4); K5 |dbar|/max(1,|bar|) Abar {scaled[0]:.3g}, "
          f"Bbar {scaled[1]:.3g}, Wbar {scaled[2]:.3g} (tol 2e-4), |dbar| {absmax:.3g}, "
          f"elements over the bound: {over} of {3 * n}" + ("" if gate else " (reported, not gated)"))
    if gate:
        require(err_obj < 2e-5 and err_lam < 2e-5 and err_v < 1e-4 and err_w < 1e-4,
                f"K4 against its plain version ({tag})")
        require(max(scaled) < 2e-4, f"K5 against its plain version ({tag})")
    return err_lam, absmax


def eig_dominant(E):
    """The library yardstick of K1: torch.linalg.eig of every matrix and
    the eigenpair of largest |lam|."""
    w, V = torch.linalg.eig(E)
    i = w.abs().argmax(-1)
    return w.gather(-1, i[:, None])[:, 0], V.gather(-1, i[:, None, None].expand(-1, V.shape[1], 1))[..., 0]


def eig_library_ms(E):
    """The time of one ``eig_dominant`` call on E, after a warm-up call on
    one matrix: eig on CUDA tensors computes on the host, 5-30 s a call at
    the kernels' batches, so a full warm-up call would double that."""
    eig_dominant(E[:1])
    return cuda_ms(lambda: eig_dominant(E), 1, warm_up=False)


def overlap_einsum(U1, U2, U1p, U2p, Mr, Ml, W):
    """The library yardstick of K6: one batched torch.einsum of the 13
    operands of ``K6_NETWORK``."""
    t = lambda U: U.reshape(-1, 2, 2, 2, 2)
    ops = {"c2": t(U2)[..., 0, 0], "r2": t(U2p).conj()[..., 0, 0],  # row 0 of U2'^dag: [in1, in2]
           "U1": t(U1), "U1d": t(U1p.mH), "Ml": Ml, "Mr": Mr, "W": W.reshape((2,) * 8)}
    b, args = 40, []
    for name, idx in K6_NETWORK:
        args += [ops[name], list(idx) if name == "W" else [b, *idx]]
    return torch.einsum(*args, [b])


def tdvp_overlap_inputs(rng, p_gs, W, dev):
    """65,536 brickwork TDVP candidates: current points p = p_gs + 0.02 noise
    near the ground state, candidates p' = p + 0.05 noise; their bricks, the
    exact right environment Mr of each pair (U, U'^dag) and Ml = Mr^dag,
    built in float64 on the card and rounded to complex64, and W."""
    from qmps_torch.circuits import brickwork as bw

    p_gs = p_gs.double().cpu().numpy()
    p = p_gs + 0.02 * rng.standard_normal((BW_BATCH, 22))
    pn = p + 0.05 * rng.standard_normal((BW_BATCH, 22))
    with torch.no_grad():
        U1, U2 = bw.param_bricks(torch.from_numpy(p).to(dev))
        U1p, U2p = bw.param_bricks(torch.from_numpy(pn).to(dev))
        _, Mr = bw.exact_right_env(U1, U2, U1p.mH, U2p.mH)
    c64 = torch.complex64
    out = [t.to(c64).contiguous() for t in (U1, U2, U1p, U2p, Mr, Mr.mH.resolve_conj())]
    return (*out, torch.from_numpy(W).to(dev, c64))


def brickwork_family(p_gs):
    """Phase 10, where p_gs is and in its precision: the brickwork
    Loschmidt pipeline from the brickwork ground state p_gs (22,) of
    tfim(1.5), quenched to tfim(0.2) (12 steps of dt 0.05, 120 inner
    steps), within 0.05 of the exact rate (tests/test_brickwork.py:109-129);
    the warm start, the "suN" ground state from find_ground_state's default
    start (400 L-BFGS steps) compiled into bricks (overlap > 0.99) and
    evolved 12 steps of dt 0.025 (200 inner steps at lr 5e-2), within 1e-2
    of the exact rate (:171-205).  Each path timed; returns the figures."""
    from qmps_torch.algorithms import brickwork_tdvp as bwt
    from qmps_torch.algorithms.ground_state import find_ground_state
    from qmps_torch.ham.exact import loschmidt_rate, tfim_gs_energy_f64
    from qmps_torch.ham.hamiltonian import tfim
    from qmps_torch.mps.imps import iMPS

    sync = torch.cuda.synchronize if p_gs.is_cuda else (lambda: None)

    def rates(les):
        return -np.log(les.double().cpu().numpy()) / 2, les.dtype  # per site (cell = 2 sites)

    t0 = time.perf_counter()
    les, _, _ = bwt.loschmidt_echo_brickwork(p_gs, bwt.quench_window_gate(tfim(BW_G1).to_matrix(), 0.05), 12, 120)
    sync()
    t_los = time.perf_counter() - t0
    rates_l, dtype_l = rates(les)
    err_l = np.abs(rates_l - loschmidt_rate(np.arange(1, 13) * 0.05, BW_G0, BW_G1)).max()
    print(f"brickwork Loschmidt ({BW_G0} -> {BW_G1}, dt 0.05, 12 x 120 inner, {dtype_l}, {t_los:.3f} s): "
          f"max |rate - exact| {err_l:.4g} (< 0.05)")
    require(dtype_l == p_gs.real.dtype and np.all(np.isfinite(rates_l)) and rates_l[-1] > rates_l[0]
            and err_l < 0.05, "brickwork Loschmidt rate against exact")

    t0 = time.perf_counter()
    start = torch.randn(15, generator=torch.Generator().manual_seed(0), dtype=torch.float64) * 0.5
    gs = find_ground_state(tfim(BW_G0), D=2, steps=400, initial_guess=start.to(p_gs))  # "suN"
    p_ws, ov_ws = bwt.compile_tensor_to_bricks(gs.A)
    sync()
    t_compile = time.perf_counter() - t0
    err_gs = gs.energy - float(tfim_gs_energy_f64(BW_G0))
    t0 = time.perf_counter()
    traj, _ = bwt.BrickworkEvolver(bwt.quench_window_gate(tfim(BW_G1).to_matrix(), 0.025), inner_steps=200,
                                   lr=5e-2).time_evolve(p_ws, 12)
    sync()
    t_ws = time.perf_counter() - t0
    with torch.no_grad():
        psi0 = iMPS([bwt._blocked(traj[0])])
        rates_w, dtype_w = rates(torch.stack([iMPS([bwt._blocked(q)]).overlap(psi0) for q in traj[1:]]))
    err_w = np.abs(rates_w - loschmidt_rate(np.arange(1, 13) * 0.025, BW_G0, BW_G1)).max()
    print(f"warm start: suN ground state (error {err_gs:.4g}) + compile in {t_compile:.3f} s, overlap "
          f"{float(ov_ws):.6f} (> 0.99); evolver 12 x 200 inner ({dtype_w}) in {t_ws:.3f} s, "
          f"max |rate - exact| {err_w:.4g} (< 1e-2)")
    require(float(ov_ws) > 0.99, "warm-start compile overlap")
    require(dtype_w == p_gs.real.dtype and np.all(np.isfinite(rates_w)) and rates_w[-1] > rates_w[0]
            and err_w < 1e-2, "warm-start rate against exact")
    return {"loschmidt_max_rate_error": float(err_l), "loschmidt_seconds": t_los,
            "suN_ground_state_error": err_gs, "warm_start_overlap": float(ov_ws),
            "warm_start_max_rate_error": float(err_w), "warm_start_seconds": t_compile + t_ws}


def evolve_pipeline(dev):
    """Phase 13 on ``dev`` (float32 on the card, float64 on the CPU):
    ``loschmidt_echo_run`` at ECHO_* (the ground state of tfim(1.5), 300
    L-BFGS steps, evolved under tfim(0.2)) against the exact rate (every
    step within 0.02, the last above 0.1); the start's float64 readout
    (``host_energy_gauge_free`` with the device's energy as f32_ref)
    against the exact energy, inside (-1e-9, 5e-4); an
    MPSTimeEvolve(tfim(0.5), dt 0.05, 8 inner steps) run of 4 steps killed
    after 2 and resumed from its checkpoint, equal to the uninterrupted
    run; ``compile_state_to_ansatz`` of a seeded left-canonical D = 2 tensor
    to overlap > 1 - 1e-4.  The pipeline launches no hand kernel (the
    dense objective), and the counters must show it.  Returns (the
    figures, the pipeline's last parameters)."""
    import tempfile

    from qmps_torch.algorithms.evolve import MPSTimeEvolve, compile_state_to_ansatz, loschmidt_echo_run
    from qmps_torch.circuits.ansatze import shallow_full_state
    from qmps_torch.embed.unitaries import unitary_to_tensor
    from qmps_torch.ham.exact import loschmidt_rate, tfim_gs_energy_f64
    from qmps_torch.ham.hamiltonian import tfim
    from qmps_torch.kernels import _lib
    from qmps_torch.mps.imps import iMPS
    from qmps_torch.objectives.energy import energy_exact_env
    from qmps_torch.utils.host_eval import host_energy_gauge_free, tfim_h64_batch

    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    _lib.reset_launches()
    sync()
    t0 = time.perf_counter()
    times, rates, rec = loschmidt_echo_run(ECHO_G0, ECHO_G1, ECHO_T, ECHO_STEPS, inner_steps=ECHO_INNER,
                                           gs_steps=ECHO_GS, device=dev)
    sync()
    t_echo = time.perf_counter() - t0
    launches = dict(_lib.launches)
    n_inner = ECHO_STEPS * ECHO_INNER
    t = np.arange(1, ECHO_STEPS + 1) * (ECHO_T / ECHO_STEPS)
    got = rates.double().cpu().numpy()
    err = np.abs(got - loschmidt_rate(t, ECHO_G0, ECHO_G1))
    print(f"evolve pipeline loschmidt_echo_run({ECHO_G0} -> {ECHO_G1}, t {ECHO_T}, {ECHO_STEPS} steps x "
          f"{ECHO_INNER} inner, ground state {ECHO_GS} L-BFGS steps; {rates.dtype} on {rates.device}): "
          f"{t_echo:.4f} s, {n_inner / t_echo:.1f} inner steps/s with the ground state; max |rate - exact| "
          f"{err.max():.4g} (< 0.02), last rate {got[-1]:.4f} (> 0.1); hand-kernel launches {launches}")
    require(rates.device.type == dev.type and rec.params.shape == (ECHO_STEPS + 1, 15)
            and np.all(np.isfinite(got)), "the pipeline's rates finite, of the expected shape, on the device")
    require(np.abs(times.double().cpu().numpy() - t).max() < 1e-6, "the pipeline's time grid")
    require(err.max() < 0.02 and got[-1] > 0.1, "the evolve pipeline against the exact rate")
    require(not any(launches.values()), "the evolve pipeline launches no hand kernel")

    # the start, read back in float64 with the device's own energy as reference
    p_gs = rec.params[0]
    with torch.no_grad():
        e_dev = float(energy_exact_env(shallow_full_state(p_gs), torch.from_numpy(tfim(ECHO_G0).to_matrix())))
        A_gs = unitary_to_tensor(shallow_full_state(p_gs))
    e64 = host_energy_gauge_free(A_gs, tfim_h64_batch([ECHO_G0])[0], f32_ref=e_dev)
    err_gs = e64 - float(tfim_gs_energy_f64(ECHO_G0))
    print(f"evolve pipeline start: float64 readout error {err_gs:.4g} (in (-1e-9, 5e-4)); device energy "
          f"{e_dev:.8f}, readout {e64:.10f}")
    require(-1e-9 < err_gs < 5e-4, "the start's float64 readout against the exact energy")

    # kill and resume (tests/test_checkpoint_resume.py:13-34)
    p0 = torch.from_numpy(np.random.default_rng(0).standard_normal(15) * 0.1).to(dev, p_gs.dtype)

    def stepper():
        return MPSTimeEvolve(tfim(0.5), dt=0.05, inner_steps=8)

    ref = stepper().evolve(p0, 4)
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = str(Path(tmp) / "traj.npz")
        stepper().evolve(p0, 2, checkpoint_path=ckpt, checkpoint_every=1)
        res = stepper().evolve(p0, 4, checkpoint_path=ckpt, checkpoint_every=2)
    d_resume = max((getattr(res, f) - getattr(ref, f)).abs().max().item()
                   for f in ("params", "loschmidt", "evs", "errors"))
    print(f"evolve resume: 4 steps killed after 2 and resumed, largest difference from the uninterrupted "
          f"run {d_resume:.3g} (== 0)")
    require(d_resume == 0.0, "the resumed trajectory equals the uninterrupted one")

    # compile a seeded left-canonical D = 2 tensor into the full15 gate
    A = torch.from_numpy(left_canonical(np.random.default_rng(1), 1)[0]).to(dev, rec.params.dtype.to_complex())
    sync()
    t0 = time.perf_counter()
    p = compile_state_to_ansatz(A)
    sync()
    t_compile = time.perf_counter() - t0
    with torch.no_grad():
        B = unitary_to_tensor(shallow_full_state(p))
        ov = float(iMPS([B.cpu().to(torch.complex128)]).overlap(iMPS([A.cpu().to(torch.complex128)])))
    print(f"compile_state_to_ansatz (800 adam steps, {p.dtype}, {t_compile:.3f} s): overlap {ov:.9f} "
          f"(> 1 - 1e-4)")
    require(p.device.type == dev.type and ov > 1 - 1e-4, "the compiled state's overlap")
    return {"evolve_seconds": t_echo, "evolve_inner_steps_per_second": n_inner / t_echo,
            "evolve_max_rate_error": float(err.max()), "evolve_last_rate": float(got[-1]),
            "evolve_gs_energy_error_f64": err_gs, "evolve_resume_max_difference": d_resume,
            "evolve_compile_overlap": ov}, rec.params[-1]


def _readout_part(As, rs, hs):
    from qmps_torch.utils.host_eval import host_f64_sweep_energies

    return host_f64_sweep_energies(As, rs, hs)[0]


def _import_readout():
    import qmps_torch.utils.host_eval  # noqa: F401


@contextlib.contextmanager
def host_pool(workers=8):
    """``workers`` spawned processes for the float64 readouts, one BLAS
    thread each (read at their numpy import); each starts importing the
    readout at once, so a readout later in the phase pays no start-up."""
    import multiprocessing
    import os
    from concurrent.futures import ProcessPoolExecutor

    threads = {k: os.environ.get(k) for k in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")}
    os.environ.update(dict.fromkeys(threads, "1"))
    try:
        with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn")) as pool:
            warm = [pool.submit(_import_readout) for _ in range(workers)]
            yield pool
            for f in warm:
                f.result()
    finally:
        for k, v in threads.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def readout_f64(As, rs, gvals, pool, parts=8):
    """Float64 energies of a sweep's returned states on the host:
    ``host_f64_sweep_energies`` over ``pool``'s processes (a
    ``host_pool``), point i to part i mod parts (near-critical points,
    whose ARPACK tail is the cost, lie together on the grid)."""
    from qmps_torch.utils.host_eval import device_to_host_c128, tfim_h64_batch

    A, r, h = device_to_host_c128(As), device_to_host_c128(rs), tfim_h64_batch(gvals)
    futures = [pool.submit(_readout_part, A[k::parts], r[k::parts], h[k::parts]) for k in range(parts)]
    e64 = np.empty(len(gvals))
    for k, f in enumerate(futures):
        e64[k::parts] = f.result()
    return e64


def below_exact_record(D, gvals, g_dev, exact, As, rs, err32, err64, dev):
    """For the sweep points whose float32 energy lies below exact: their
    g, the float32 energy read again from the returned state and
    environment with the sweep's couplings at ``final_iters`` 200 and
    2,000 (``isometry_energy_warm``, as ``finish`` reads it, at the matmul
    precision the sweep left behind), the relative residual |E r - lam r|
    / |r| of the returned environment, and whether a complex64 product
    still takes TF32 after the sweep.  Returns the summary line's figures."""
    from qmps_torch.mps.transfer import right_matvec, transfer_dense
    from qmps_torch.optim.riemann import isometry_energy_warm
    from qmps_torch.parallel.sweep import tfim_matrix

    neg = np.nonzero(err32 < 0)[0]
    g = torch.Generator().manual_seed(0)
    X, Y = (torch.randn(256, D, D, dtype=torch.complex128, generator=g).to(dev) for _ in range(2))
    bmm_err = ((X.to(torch.complex64) @ Y.to(torch.complex64)).to(torch.complex128) - X @ Y).abs().max().item()
    tier = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
    print(f"D = {D} after the sweep: float32 matmul precision {tier[0]!r}, allow_tf32 {tier[1]}, a complex64 "
          f"bmm (256 x {D}x{D}) off complex128 by {bmm_err:.3g}; {neg.size} of {len(gvals)} points below "
          f"exact in float32")
    out = {f"stiefel_d{D}_points_below_exact_f32": int(neg.size), f"stiefel_d{D}_bmm_error_after": bmm_err}
    if not neg.size:
        return out
    idx = torch.from_numpy(neg).to(dev)
    A, r = As[idx], rs[idx]
    V = A.transpose(1, 2).reshape(-1, 2 * D, D)
    hs = tfim_matrix(g_dev[idx])  # the sweep's own couplings
    with torch.no_grad():
        e200 = isometry_energy_warm(V, hs, D, r, 200, "unroll")[0].double().cpu().numpy() - exact[neg]
        e2000 = isometry_energy_warm(V, hs, D, r, 2000, "unroll")[0].double().cpu().numpy() - exact[neg]
        Er = right_matvec(A, A, r)
        lam = (r.conj() * Er).sum((-2, -1)) / (r.conj() * r).sum((-2, -1))
        res = (torch.linalg.matrix_norm(Er - lam[:, None, None] * r)
               / torch.linalg.matrix_norm(r)).double().cpu().numpy()
    worst = np.argsort(err32[neg])[:8]
    for i in worst:
        # the transfer spectrum's top two moduli, in float64 on the host:
        # how fast a power iteration can converge at all
        Ai = A[i].cpu().to(torch.complex128)
        mods = np.sort(np.abs(np.linalg.eigvals(transfer_dense(Ai, Ai).numpy())))
        print(f"  g {gvals[neg][i]:.6f}: float32 error {err32[neg][i]:.4g} (sweep), {e200[i]:.4g} (200 more "
              f"iterations), {e2000[i]:.4g} (2,000); float64 readout {err64[neg][i]:.4g}; environment "
              f"residual {res[i]:.3g}; |lam_2 / lam_1| {mods[-2] / mods[-1]:.6f}")
    print(f"  all {neg.size}: min float32 error {err32[neg].min():.4g} (sweep), {e200.min():.4g} (200), "
          f"{e2000.min():.4g} (2,000); median residual {np.median(res):.3g}, max {res.max():.3g}")
    out.update({f"stiefel_d{D}_below_exact_min_f32": float(err32[neg].min()),
                f"stiefel_d{D}_below_exact_min_f32_200": float(e200.min()),
                f"stiefel_d{D}_below_exact_min_f32_2000": float(e2000.min()),
                f"stiefel_d{D}_below_exact_max_residual": float(res.max())})
    return out


def unroll_work(D, rows, iters):
    """((flops, bytes) of the forward, (flops, bytes) of the backward) of
    the unroll's kernels on ``rows`` rows, as they run the algorithm: the
    forward per iteration, and once for the Rayleigh quotient, 2 d D^3
    complex multiply-adds (X_s = A_s r, sum_s X_s A_s^dag; d = 2) with the
    norm and scaling (6 D^2); the backward per iteration 5 d D^3 (G_W A_s,
    its product with r_k^dag, A_s r_k, G_W^dag times that, A_s^dag G_W
    A_s).  Bytes: the forward reads V and r0 and writes r, lam and the saved
    r_k and ||W_k||; the backward reads V, the saved states, r and r's
    cotangent and writes A's cotangent."""
    c, n2 = 8, D * D  # bytes of a complex64, entries of a D x D matrix
    saved = iters * (n2 * c + 4)
    fwd = ((iters + 1) * (CMAC * 4 * D ** 3 + 6 * n2), 4 * n2 * c + c + saved)
    bwd = (iters * CMAC * 10 * D ** 3, 6 * n2 * c + saved)
    return tuple((flops * rows, nbytes * rows) for flops, nbytes in (fwd, bwd))


def graph_of(fn):
    """fn captured as a CUDA graph after two calls on a side stream."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        fn()
    return g


def stiefel_unroll_kernels(dev, card, shapes=UNROLL_SHAPES, reps=UNROLL_REPS):
    """Phase 14's first part: the environment unroll's two kernels
    (``kernels/stiefel_unroll``) at each of ``shapes`` (D -> rows,
    iterations): seeded isometries, r0 = I / sqrt(D) as an expand over the
    rows (a descent's first step), a seeded cotangent of r.  Through
    ``right_eigpair_warm_unroll`` and autograd, one launch each way: r, lam
    and A's cotangent against the plain versions at complex128 from the same
    complex64 inputs, each error over the largest entry (2e-5 for r and lam,
    1e-4 for the cotangent), and the wrappers' own calls reproduce them.
    Timed in turns (plain, kernel, kernel, plain): the kernels alone,
    queued behind a spin kernel, against plain autograd through
    ``_power_forward`` as CUDA graphs (the forward under no_grad, forward and
    backward), both the card's time; and the path as a sweep runs it,
    eagerly through autograd, host and card, against the same plain path.
    Returns (the two kernels' entries of the JSON line, their launches in
    this part)."""
    from qmps_torch.kernels import _lib
    from qmps_torch.kernels import stiefel_unroll as su
    from qmps_torch.mps.transfer import _power_forward, right_eigpair_warm_unroll

    c64, c128 = torch.complex64, torch.complex128
    entries = {"unroll_fwd": {}, "unroll_bwd": {}}
    _lib.reset_launches()
    for D, (rows, iters) in shapes.items():
        rng = np.random.default_rng(D)
        X = rng.normal(size=(rows, 2 * D, D)) + 1j * rng.normal(size=(rows, 2 * D, D))
        V = torch.from_numpy(np.linalg.qr(X)[0].astype(np.complex64)).to(dev).reshape(rows, D, 2, D)
        A = V.transpose(1, 2)
        r0 = (torch.eye(D, dtype=c64, device=dev) / D ** 0.5).expand(rows, D, D)
        g = torch.from_numpy((rng.normal(size=(rows, D, D)) + 1j * rng.normal(size=(rows, D, D)))
                             .astype(np.complex64)).to(dev)

        def through_autograd(run):
            Ag = A.detach().requires_grad_()
            lam, r = run(Ag, Ag, r0, iters)
            (gA,) = torch.autograd.grad((r.conj() * g).real.sum(), Ag)
            return lam.detach(), r.detach(), gA

        before = dict(_lib.launches)
        lam, r, gA = through_autograd(right_eigpair_warm_unroll)
        torch.cuda.synchronize()
        once = {k: v - before[k] for k, v in _lib.launches.items()}
        require(once == {**dict.fromkeys(once, 0), "stiefel_unroll_fwd": 1, "stiefel_unroll_bwd": 1},
                f"the unroll at D = {D}: one launch each way {once}")
        V64 = V.to(c128)
        lam_p, r_p, rs_p, ns_p = su._fwd_plain(V64, r0.to(c128), iters, True)
        gV_p = su._bwd_plain(V64, rs_p, ns_p, r_p, g.to(c128))
        errs = {}
        for name, x, ref in (("r", r, r_p), ("lam", lam, lam_p), ("gA", gA.transpose(1, 2), gV_p)):
            d = (x.to(c128) - ref).abs().max().item()
            errs[name] = (d, d / ref.abs().max().item())
        print(f"unroll kernels at D = {D} ({rows} rows, {iters} iterations) against the plain versions at "
              f"complex128: r {errs['r'][1]:.3g} (tol 2e-5), lam {errs['lam'][1]:.3g} (tol 2e-5), A's cotangent "
              f"{errs['gA'][1]:.3g} (tol 1e-4), each over the largest entry", flush=True)
        require(errs["r"][1] < 2e-5 and errs["lam"][1] < 2e-5 and errs["gA"][1] < 1e-4,
                f"the unroll's kernels against their plain versions at D = {D}")

        # the wrappers alone, as timed below, reproduce the checked outputs
        r0c = r0.contiguous()
        lam_k, r_k, rs_k, ns_k = su._fwd_cuda(V, r0c, iters, True)
        gV_k = su._bwd_cuda(V, rs_k, ns_k, r_k, g)
        require(torch.equal(lam_k, lam) and torch.equal(r_k, r) and torch.equal(gV_k, gA.transpose(1, 2)),
                f"the unroll's timed calls reproduce its outputs at D = {D}")
        Ag = A.detach().requires_grad_()

        def plain_fwd():
            with torch.no_grad():
                _power_forward(A, A, r0, iters)

        def plain_both():
            with torch.enable_grad():
                _, rr = _power_forward(Ag, Ag, r0, iters)
                torch.autograd.grad((rr.conj() * g).real.sum(), Ag)

        g_fwd, g_both = graph_of(plain_fwd), graph_of(plain_both)
        t = {k: [] for k in ("fwd", "bwd", "plain_fwd", "plain_bwd", "eager", "plain_eager")}
        for turn in ("plain", "kernel", "kernel", "plain"):
            if turn == "plain":
                f = cuda_ms(g_fwd.replay, reps, queued=True)
                t["plain_fwd"].append(f)
                t["plain_bwd"].append(cuda_ms(g_both.replay, reps, queued=True) - f)
                t["plain_eager"].append(cuda_ms(lambda: through_autograd(_power_forward), 5))
            else:
                t["fwd"].append(cuda_ms(lambda: su._fwd_cuda(V, r0c, iters, True), reps, queued=True))
                t["bwd"].append(cuda_ms(lambda: su._bwd_cuda(V, rs_k, ns_k, r_k, g), reps, queued=True))
                t["eager"].append(cuda_ms(lambda: through_autograd(right_eigpair_warm_unroll), 5))
        del g_fwd, g_both, rs_k, ns_k
        (ff, fb), (bf, bb) = unroll_work(D, rows, iters)
        bounds = {"fwd": bound(ff, fb), "bwd": bound(bf, bb)}
        ms = {k: sum(v) / len(v) for k, v in t.items()}
        print(f"  times, a mean of 2 turns (plain, kernel, kernel, plain): forward {ms['fwd']:.4f} ms "
              f"(bound {bounds['fwd'][0]:.4f}, {100 * bounds['fwd'][0] / ms['fwd']:.1f}%), backward "
              f"{ms['bwd']:.4f} ms (bound {bounds['bwd'][0]:.4f}, {100 * bounds['bwd'][0] / ms['bwd']:.1f}%); plain "
              f"autograd as CUDA graphs: forward {ms['plain_fwd']:.4f}, backward {ms['plain_bwd']:.4f} ms; eager "
              f"forward and backward as a sweep runs them (host and card): kernels {ms['eager']:.4f}, plain "
              f"{ms['plain_eager']:.4f} ms (on {card})", flush=True)
        for part, err in (("fwd", max(errs["r"][0], errs["lam"][0])), ("bwd", errs["gA"][0])):
            row = entries[f"unroll_{part}"]
            if D == 16:  # the Stiefel step's shape: the entry's own figures
                row.update(batch=rows, D=D, iters=iters, ms=ms[part], plain_ms=ms[f"plain_{part}"],
                           library_ms=None, bound_ms=bounds[part][0], bound_by=bounds[part][1])
            row.update({f"ms_d{D}": ms[part], f"plain_ms_d{D}": ms[f"plain_{part}"],
                        f"bound_ms_d{D}": bounds[part][0], f"eager_ms_d{D}": ms["eager"],
                        f"plain_eager_ms_d{D}": ms["plain_eager"],
                        "max_abs_err": max(row.get("max_abs_err", 0.0), err)})
    launched = {k: _lib.launches[k] for k in ("stiefel_unroll_fwd", "stiefel_unroll_bwd")}
    require(not any(v for k, v in _lib.launches.items() if k not in launched),
            f"the unroll's part launches no other hand kernel {dict(_lib.launches)}")
    return entries, launched


def large_d_path(dev, card, pool):
    """Phase 14: the large-D path on the card, float32, no hand kernel but
    the environment unroll's two;
    the sweeps read back in float64 on ``pool`` (a ``host_pool``).
    Returns the figures of the summary line."""
    from qmps_torch.ham.exact import tfim_gs_energy_f64
    from qmps_torch.kernels import _lib
    from qmps_torch.mps.tdvp import energy_variance_density
    from qmps_torch.mps.transfer import right_fixed_point
    from qmps_torch.parallel.sweep import (_matmul_tier, _stiefel_sweep_programs, stiefel_point_chunk,
                                           sweep_variance_certificates, tfim_matrix)
    from qmps_torch.workloads import LargeDConfig, StiefelSweepConfig

    out = {}
    _lib.reset_launches()

    # does a complex64 bmm take TF32 under the "default" tier?
    g = torch.Generator().manual_seed(0)
    X, Y = (torch.randn(1024, 32, 32, dtype=torch.complex128, generator=g).to(dev) for _ in range(2))
    ref = X @ Y
    tf32_err = {}
    for tier in ("highest", "default"):
        with _matmul_tier(tier):
            tf32_err[tier] = ((X.to(torch.complex64) @ Y.to(torch.complex64)).to(torch.complex128) - ref).abs().max().item()
    print(f"complex64 bmm (1024 x 32x32) against complex128: max |error| {tf32_err['highest']:.3g} at full float32, "
          f"{tf32_err['default']:.3g} at the 'default' tier (one-pass TF32 where cuBLAS takes it)")
    out["tf32_bmm_error_fp32"], out["tf32_bmm_error_default"] = tf32_err["highest"], tf32_err["default"]

    gvals = np.linspace(*STF_G, STF_POINTS) + 1e-3
    exact = tfim_gs_energy_f64(gvals)
    keep = {}
    for D, kw in STF_RUNS.items():
        cfg = StiefelSweepConfig(n_points=STF_POINTS, D=D, device=str(dev), **kw)
        gs = cfg.grid()
        ri = 24 if D < 16 else 96  # the sweep's default recycle_iters
        chunk = stiefel_point_chunk(STF_POINTS, D, 1, ri, torch.complex64, dev)
        t0 = time.perf_counter()
        # the untimed call, cut to WARM_STEPS: PyTorch compiles nothing, so
        # a short run warms the allocator and the libraries as a whole one
        dataclasses.replace(cfg, steps=WARM_STEPS, polish_steps=min(cfg.polish_steps, WARM_STEPS // 2)).sweep(gs)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        es, As, rs = cfg.sweep(gs + 1e-3)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        err32 = es.double().cpu().numpy() - exact
        t0 = time.perf_counter()
        err = readout_f64(As, rs, gvals, pool) - exact
        t_read = time.perf_counter() - t0
        tag = f"stiefel_d{D}"
        print(f"Stiefel sweep D = {D} ({STF_POINTS} points, {cfg.steps} steps, precision {cfg.precision}, polish "
              f"{cfg.polish_steps}, recycle_iters {ri}, point_chunk {chunk} of {STF_POINTS}; {As.dtype}): "
              f"{dt:.4f} s ({STF_POINTS / dt:.2f} points/s; the untimed {WARM_STEPS} steps {t_first:.4f} s), peak "
              f"{peak:.3f} GiB; float64 readout ({t_read:.2f} s, 8 host processes): median {np.median(err):.4g} "
              f"(< 5e-4), max {err.max():.4g} (< 5e-3), min {err.min():.4g} (> -1e-4); float32 energies: "
              f"median {np.median(err32):.4g}, max {err32.max():.4g}, min {err32.min():.4g} (on {card})")
        require(es.shape == (STF_POINTS,) and As.shape == (STF_POINTS, 2, D, D) and rs.shape == (STF_POINTS, D, D)
                and np.all(np.isfinite(err)) and np.all(np.isfinite(err32)),
                f"D = {D}: finite energies of the expected shapes")
        require(np.median(err) < 5e-4 and err.max() < 5e-3 and err.min() > -1e-4,
                f"D = {D} sweep's float64 readout against the exact energy")
        out.update({f"{tag}_seconds": dt, f"{tag}_points_per_second": STF_POINTS / dt,
                    f"{tag}_warm_up_seconds": t_first, f"{tag}_peak_gib": peak, f"{tag}_point_chunk": chunk,
                    f"{tag}_median_error": float(np.median(err)), f"{tag}_max_error": float(err.max()),
                    f"{tag}_min_error": float(err.min()), f"{tag}_median_error_f32": float(np.median(err32)),
                    f"{tag}_max_error_f32": float(err32.max()), f"{tag}_readout_seconds": t_read})
        keep[D] = (gs + 1e-3, As, rs)
        out.update(below_exact_record(D, gvals, gs + 1e-3, exact, As, rs, err32, err, dev))

    # certificates on every point of the smaller D (16)
    D0 = min(STF_RUNS)
    gs16, As16, rs16 = keep[D0]
    sweep_variance_certificates(gs16[:16], As16[:16], rs16[:16])  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    var = sweep_variance_certificates(gs16, As16, rs16)
    torch.cuda.synchronize()
    t_cert = time.perf_counter() - t0
    v = var.double().cpu().numpy()
    i = STF_POINTS // 2
    A = As16[i].to(torch.complex128)
    r = rs16[i].to(torch.complex128)
    for _ in range(60):
        r = torch.einsum("sai,ij,sbj->ab", A, r, A.conj())
        r = (r + r.mH) / 2
        r = r / torch.linalg.matrix_norm(r)
    dense = energy_variance_density(A, r / torch.trace(r), tfim_matrix(gs16[i].double()).to(A.dtype)).item()
    d_cert = abs(dense - v[i])
    print(f"variance certificates ({STF_POINTS} D = {D0} points, GMRES k 48 x 4, {var.dtype}): {t_cert:.4f} s; "
          f"median {np.median(v):.4g}, max {v.max():.4g}, min {v.min():.4g} (> -1e-6); point {i}: {v[i]:.6g} "
          f"against the dense complex128 solve {dense:.6g} (|d| {d_cert:.3g} < 1e-4 max(1, |dense|))")
    require(v.shape == (STF_POINTS,) and np.all(np.isfinite(v)) and v.min() > -1e-6,
            "the certificates finite and > -1e-6")
    require(d_cert < 1e-4 * max(1.0, abs(dense)), "one GMRES certificate against the dense one")
    out.update({"certificate_seconds": t_cert, "certificate_median": float(np.median(v)),
                "certificate_max": float(v.max()), "certificate_dense_difference": float(d_cert)})

    # the matvec fixed point against the dense one on a seeded left-canonical D = 16 state
    A = torch.from_numpy(left_canonical(np.random.default_rng(3), 1, D=16)[0]).to(dev, torch.complex64)
    lam_m, r_m = right_fixed_point(A, A, dense=False)
    lam_d, r_d = right_fixed_point(A, A)
    d_lam, d_r = abs(complex(lam_m) - complex(lam_d)), (r_m - r_d).abs().max().item()
    print(f"right_fixed_point(dense=False) at D = 16 (complex64): |dlam| {d_lam:.3g} (< 1e-5), |dr| {d_r:.3g} "
          f"(< 1e-4) against the dense path")
    require(d_lam < 1e-5 and d_r < 1e-4, "the matvec fixed point against the dense one")
    out.update({"matvec_fixed_point_lam_difference": d_lam, "matvec_fixed_point_r_difference": d_r})

    # LargeDConfig: D = 64 runs the GMRES branch of the warm adjoint
    m = LargeDConfig(D=LARGE_D, steps=LARGE_D_STEPS, device=str(dev)).run()
    print(f"LargeDConfig(D = {LARGE_D}, {LARGE_D_STEPS} steps, GMRES adjoint): {m['seconds']:.4f} s "
          f"({m['steps_per_sec']:.2f} steps/s), energy {m['energy']:.8f}, error {m['error']:.4g} "
          f"(in (-1e-4, 5e-3)), best seen {m['best_seen']:.8f}")
    require(math.isfinite(m["error"]) and -1e-4 < m["error"] < 5e-3, "LargeDConfig's error")
    out.update({f"large_d{LARGE_D}_{k}": m[k] for k in ("seconds", "steps_per_sec", "error")})

    # one D = 16 step at the sweep's batch, unprofiled and profiled
    init, advance, _ = _stiefel_sweep_programs(D0, 0.08, 0.9, 1, 24 if D0 < 16 else 96, 200)
    x = torch.randn(2, STF_POINTS, 2 * D0, D0, generator=torch.Generator().manual_seed(5)).to(dev, gs16.dtype)
    hs, V, M, r = init(gs16, x[0], x[1])
    V, M, r = advance(V, M, r, hs, 2)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    advance(V, M, r, hs, 1)
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) * 1e3
    host, busy, top, ops = device_breakdown(lambda: advance(V, M, r, hs, 1), 1, host_ops=10)
    idle = None if busy is None else 1 - busy / step_ms
    print(f"D = {D0} descent step ({STF_POINTS} points) under torch.profiler: {step_ms:.4f} ms unprofiled, "
          f"{host:.4f} profiled; {ops:.0f} device operations a step; device busy "
          + ("not measured (no kernel recorded)" if busy is None else
             f"{busy:.4f} ms, idle share {idle:.4f}; largest: " + "; ".join(f"{n[:60]} {t:.4f} ms" for n, t in top))
          + f" (on {card})")
    out.update({f"stiefel_d{D0}_step_ms": step_ms, f"stiefel_d{D0}_step_device_ops": ops,
                f"stiefel_d{D0}_step_idle_share": idle})

    launched = dict(_lib.launches)
    print(f"phase 14 hand-kernel launches: {launched}")
    require(not any(v for k, v in launched.items() if not k.startswith("stiefel_unroll_"))
            and (dev.type != "cuda" or launched["stiefel_unroll_fwd"] and launched["stiefel_unroll_bwd"]),
            "the large-D path launches the unroll's two kernels and no other hand kernel")
    return out


def big_tdvp_inputs(rng, D, dev, n=BIG_BATCH):
    """n quench-like TDVP pairs at bond dimension D, complex64 on the
    card: left-canonical A, B the nearest isometry to A + 0.03 noise
    (tests/test_pallas.py:143-161), W = expm(-i h(g1) 0.04) for g1 in
    [0.1, 0.4], one a pair."""
    from qmps_torch.parallel.sweep import tfim_matrix

    A = left_canonical(rng, n, D)
    B = near_isometry(rng, A, 0.03)
    g1 = torch.from_numpy(rng.uniform(G1_MIN, G1_MAX, n)).to(dev)
    W = torch.linalg.matrix_exp(-1j * tfim_matrix(g1).to(torch.complex128) * (2 * DT))
    return [torch.as_tensor(t).to(dev, torch.complex64).contiguous() for t in (A, B, W)]


def random_matrices(rng, N, B, dev):
    """B complex normal N x N matrices scaled by 1/sqrt(N)
    (tests/test_pallas.py:110-113), complex64 on the card, element 5 zero."""
    E = (rng.standard_normal((B, N, N)) + 1j * rng.standard_normal((B, N, N))) / np.sqrt(N)
    E[5] = 0
    return torch.from_numpy(E).to(dev, torch.complex64)


def matpow_check(tpp, tag, E):
    """The K7/K8 path (complex64) against the plain version at complex128 on
    the same inputs, both through _extract_eigpair: lam to 2e-5 and v up to
    its phase to 1e-4 on every element, zero matrices finite.  Returns the
    larger error."""
    lam, v = tpp.dominant_eig_batched(E, TDVP_ITERS)
    E64 = E.to(torch.complex128)
    lam_p, v_p = tpp._extract_eigpair(E64, tpp._matrix_power_plain(E64, TDVP_ITERS))
    err_lam = (lam.to(torch.complex128) - lam_p).abs().max().item()
    err_v = (phase_aligned(v.to(torch.complex128), v_p) - v_p).abs().max().item()
    n, N = E.shape[:2]
    zero = (E.abs().amax((1, 2)) == 0)
    print(f"{'K7' if N <= 16 else 'K8'} {tag} ({n} x {N}x{N}): |dlam| {err_lam:.3g} (tol 2e-5), |dv| up to phase "
          f"{err_v:.3g} (tol 1e-4); |lam| in [{lam_p.abs().min().item():.4f}, {lam_p.abs().max().item():.4f}], "
          f"{int(zero.sum())} zero matrices")
    require(bool(torch.isfinite(torch.view_as_real(lam)).all() and torch.isfinite(torch.view_as_real(v)).all())
            and not lam[zero].any() and not v[zero].any(), f"finite output, zero matrices zero ({tag})")
    require(err_lam < 2e-5 and err_v < 1e-4, f"{'K7' if N <= 16 else 'K8'} against its plain version ({tag})")
    return err_lam, err_v


def sass_hmma(lib_path):
    """{symbol: HMMA instructions} of every K7 and K8 tensor-core kernel
    (``matpow_tc_kernel``, ``matpow_tc_tiles_kernel``) in the library's
    SASS, by cuobjdump beside nvcc."""
    from qmps_torch.kernels import _lib

    cuobjdump = str(Path(_lib._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            if "matpow_tc" in name:
                counts[name] = 0
        elif name in counts and "HMMA" in line:
            counts[name] += 1
    return counts


def classical_umps(dev, card, Ds=VUMPS_DS):
    """Phase 15 on ``dev`` in float32: VUMPS at bench.py's sizes (TFIM g =
    1), each after an untimed warm-up, read back in float64 on the host;
    MPO-VUMPS against the two-site energy; the D = 8 Euler trajectory
    against the exact rate; the dispersion against the exact one; one
    vumps_step with the dense and the GMRES environments at CROSS_DS; one
    profiled D = 64 iteration.  No hand kernel, and the counters show it.
    Returns the figures of the summary line (``Ds`` cuts the VUMPS sizes
    for a float32 run on the CPU)."""
    from qmps_torch.algorithms.ground_state import find_ground_state, n_params
    from qmps_torch.ham.exact import loschmidt_rate, tfim_gs_energy_f64
    from qmps_torch.ham.hamiltonian import tfim
    from qmps_torch.kernels import _lib
    from qmps_torch.mps.excitations import dispersion
    from qmps_torch.mps.imps import random_tensor
    from qmps_torch.mps.mpo import mpo_tfim, vumps_ground_state_mpo
    from qmps_torch.mps.tdvp import (Trajectory, mixed_gauge, variance_certificate, vumps_ground_state,
                                     vumps_ground_state_converged, vumps_step)
    from qmps_torch.utils.host_eval import host_energy_gauge_free

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out, states = {}, {}
    _lib.reset_launches()
    h32 = np.asarray(tfim(1.0).to_matrix().real, np.float32)  # bench.py's h: complex64 work
    exact = float(tfim_gs_energy_f64(1.0))

    for D in Ds:
        if D == 8:
            def run(gen):
                AL, _, e, info = vumps_ground_state(h32, D, generator=gen, device=dev, **VUMPS_D8)
                return AL, e, info, VUMPS_D8["iters"], -1
        else:
            def run(gen):
                AL, _, e, info = vumps_ground_state_converged(h32, D, generator=gen, device=dev,
                                                              **{**VUMPS_CONV, "max_iters": VUMPS_D64_ITERS}
                                                              if D == 64 else VUMPS_CONV)
                return AL, e, info, info["total_iters"], info["iters_to_knee"]
        t0 = time.perf_counter()
        # the untimed chunk, cut to WARM_STEPS iterations: bench.py's
        # compiles its program there, PyTorch only warms its libraries
        vumps_ground_state(h32, D, iters=WARM_STEPS, k=VUMPS_D8["k"] if D == 8 else VUMPS_CONV["k"],
                           env_solver="auto" if D == 8 else VUMPS_CONV["env_solver"], device=dev)
        sync()
        t_first = time.perf_counter() - t0
        t0 = time.perf_counter()
        AL, e, info, total, knee = run(torch.Generator().manual_seed(2))
        sync()
        dt = time.perf_counter() - t0
        grad = float(info["grad_norms"][-1])
        e64 = host_energy_gauge_free(AL, h32.astype(np.float64), f32_ref=e)
        # the certificate as bench.py reads it (float32, bench's solver: its
        # terms cancel to ~1e-5, below which it can read negative) and the
        # one the gate reads: in float64 on the card, with the dense solve,
        # of the nearest exact isometry to the state (the certificate
        # assumes a left-canonical AL, and float32 leaves a ~1e-7 defect;
        # the upcast state read -1.2e-6 at D = 64 through GMRES)
        var32 = variance_certificate(AL, h32, env_solver="auto" if D == 8 else "gmres")
        AL64 = torch.from_numpy(isometry_f64(AL[None].to(torch.complex128).cpu().numpy())[0]).to(dev)
        var = variance_certificate(AL64, h32.astype(np.float64), env_solver="dense")
        err, bound = e64 - exact, 1e-4 if D == 8 else 5e-5
        print(f"VUMPS D = {D} ({AL.dtype} on {AL.device}, k {VUMPS_D8['k'] if D == 8 else VUMPS_CONV['k']}, "
              f"{'dense' if D <= 24 else 'GMRES'} environments): {total} iterations in {dt:.4f} s "
              f"({total / dt:.2f} iterations/s; {WARM_STEPS} untimed iterations {t_first:.4f} s), knee {knee}, final "
              f"gradient {grad:.4g}; float32 energy error {e - exact:.4g}, float64 readout {err:.4g} (in "
              f"[-1e-6, {bound:g}]), variance {var32:.4g} in float32, {var:.4g} in float64 (>= -1e-6) "
              f"(on {card})")
        require(AL.device.type == dev.type and AL.shape == (2, D, D) and math.isfinite(grad) and math.isfinite(var)
                and math.isfinite(var32) and math.isfinite(err), f"VUMPS D = {D}: finite figures of the expected shape")
        require(-1e-6 <= err <= bound and var >= -1e-6, f"VUMPS D = {D} against the exact energy")
        out.update({f"vumps_iters_per_sec_D{D}": total / dt, f"vumps_seconds_D{D}": dt,
                    f"vumps_warm_up_seconds_D{D}": t_first, f"vumps_energy_error_D{D}": err,
                    f"vumps_energy_error_f32_D{D}": e - exact, f"vumps_grad_norm_D{D}": grad,
                    f"vumps_iters_to_knee_D{D}": knee, f"vumps_total_iters_D{D}": total,
                    f"vumps_variance_f32_D{D}": var32, f"vumps_variance_D{D}": var})
        states[D] = (AL, e, e64)

    # MPO-VUMPS on the textbook TFIM MPO (mpo_tfim(-g) is ham.tfim(g))
    t0 = time.perf_counter()
    A0 = random_tensor(torch.Generator().manual_seed(2), 2, 8, torch.complex64, dev)  # float32 on any device
    ALm, _, em, infom = vumps_ground_state_mpo(mpo_tfim(-1.0), 8, iters=100, k=24, A0=A0)
    sync()
    t_mpo = time.perf_counter() - t0
    # both states read back in float64: float32 readouts of one state
    # scatter by ~5e-6 on the card
    em64 = host_energy_gauge_free(ALm, h32.astype(np.float64), f32_ref=em)
    d_mpo = em64 - states[8][2]
    print(f"MPO-VUMPS D = 8 (mpo_tfim(-1), 100 iterations, k 24; {ALm.dtype}): {t_mpo:.4f} s, float32 energy "
          f"{em:.8f} against the two-site {states[8][1]:.8f}; float64 readouts {em64:.10f} and "
          f"{states[8][2]:.10f}: |d| {abs(d_mpo):.3g} (< {MPO_GATE:g}), final gradient "
          f"{float(infom['grad_norms'][-1]):.4g}")
    require(math.isfinite(em64) and abs(d_mpo) < MPO_GATE, "MPO-VUMPS against the two-site energy")
    out.update({"mpo_vumps_seconds_D8": t_mpo, "mpo_vumps_energy_difference_D8": d_mpo,
                "mpo_vumps_energy_difference_f32_D8": em - states[8][1],
                "mpo_vumps_grad_norm_D8": float(infom["grad_norms"][-1])})

    # the classical TDVP quench 1.5 -> 0.2 from the "suN" ground state
    t0 = time.perf_counter()
    # find_ground_state's own seeded start, in float64: in float32 its
    # L-BFGS stalls at 7.6e-5 above exact (1.1e-5 in float64), and that
    # start, not the float32 flow, moved a float32 CPU run's rate error to
    # 8.8e-3 (1.5e-3 from the float64 start); the flow runs in float32
    p0 = torch.randn(n_params("suN", TRAJ_D), generator=torch.Generator().manual_seed(0), dtype=torch.float64) * 0.5
    gs0 = find_ground_state(tfim(TRAJ_G0), D=TRAJ_D, ansatz="suN", method="lbfgs", steps=TRAJ_GS,
                            initial_guess=p0.to(dev))
    sync()
    t_gs = time.perf_counter() - t0
    t0 = time.perf_counter()
    traj = Trajectory(gs0.A.to(torch.complex64), tfim(TRAJ_G1).to_matrix()).eulerint(TRAJ_T, TRAJ_STEPS)
    rates = -torch.log(traj.loschmidts()).double().cpu().numpy()
    t_traj = time.perf_counter() - t0
    ts = np.linspace(TRAJ_T / TRAJ_STEPS, TRAJ_T, TRAJ_STEPS)
    sel = slice(149, None, 150)
    err_t = np.abs(rates[sel] - loschmidt_rate(ts[sel], TRAJ_G0, TRAJ_G1)).max()
    print(f"Trajectory D = {TRAJ_D} ({traj.ALs.dtype} on {traj.ALs.device}): ground state {t_gs:.4f} s "
          f"({TRAJ_GS} L-BFGS steps, {gs0.A.dtype}, error {gs0.energy - float(tfim_gs_energy_f64(TRAJ_G0)):.4g}), "
          f"eulerint({TRAJ_T}, {TRAJ_STEPS}) with the echoes {t_traj:.4f} s "
          f"({TRAJ_STEPS / t_traj:.2f} steps/s); max |rate - exact| {err_t:.4g} (< 1e-2) (on {card})")
    require(traj.ALs.shape == (TRAJ_STEPS + 1, 2, TRAJ_D, TRAJ_D) and np.all(np.isfinite(rates)),
            "the trajectory's rates finite, of the expected shape")
    require(err_t < 1e-2, "the trajectory's rate against the exact rate")
    out.update({"trajectory_seconds": t_traj, "trajectory_steps_per_second": TRAJ_STEPS / t_traj,
                "trajectory_ground_state_seconds": t_gs, "trajectory_max_rate_error": float(err_t)})

    # the quasiparticle dispersion against 2 sqrt(1 + g^2 - 2 g cos p)
    ps = np.linspace(0.0, np.pi, 5)
    t0 = time.perf_counter()
    om = dispersion(np.asarray(tfim(DISP_G).to_matrix().real, np.float32), DISP_D, ps, iters=DISP_ITERS,
                    generator=torch.Generator().manual_seed(2), device=dev)
    t_disp = time.perf_counter() - t0
    err_d = np.abs(om[:, 0] - 2.0 * np.sqrt(1.0 + DISP_G ** 2 - 2.0 * DISP_G * np.cos(ps))).max()
    print(f"dispersion g = {DISP_G}, D = {DISP_D} ({DISP_ITERS} VUMPS iterations, 5 momenta): {t_disp:.4f} s; "
          f"max |omega - exact| {err_d:.4g} (< {DISP_GATE:g})")
    require(om.shape == (5, 1) and np.all(np.isfinite(om)) and err_d < DISP_GATE, "the dispersion against exact")
    out.update({"dispersion_seconds": t_disp, "dispersion_max_error": float(err_d)})

    # one vumps_step with each environment solver: where GMRES wins
    hc = torch.from_numpy(tfim(1.0).to_matrix()).to(dev, torch.complex64)
    for D in CROSS_DS:
        AL, AR, C = mixed_gauge(random_tensor(torch.Generator().manual_seed(D), 2, D, torch.complex64, dev))
        ms = {}
        for solver in ("dense", "gmres"):
            vumps_step(AL, AR, C, hc, VUMPS_CONV["k"], env_solver=solver)
            sync()
            t0 = time.perf_counter()
            for _ in range(3):
                vumps_step(AL, AR, C, hc, VUMPS_CONV["k"], env_solver=solver)
            sync()
            ms[solver] = (time.perf_counter() - t0) * 1e3 / 3
        print(f"vumps_step D = {D} (k {VUMPS_CONV['k']}): dense environments {ms['dense']:.4f} ms, GMRES "
              f"{ms['gmres']:.4f} ms (on {card})")
        out.update({f"vumps_step_ms_dense_D{D}": ms["dense"], f"vumps_step_ms_gmres_D{D}": ms["gmres"]})

    # where a D = 64 iteration's time goes (from a seeded state: the work
    # of an iteration does not depend on it, and the converged state's
    # mixed gauge is out of float32's reach, see vumps_ground_state_converged)
    if cuda and 64 in states:
        AL, AR, C = mixed_gauge(random_tensor(torch.Generator().manual_seed(64), 2, 64, torch.complex64, dev))

        def step():
            return vumps_step(AL, AR, C, hc, VUMPS_CONV["k"], env_solver="gmres")

        step()
        sync()
        t0 = time.perf_counter()
        step()
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3
        host, busy, top, ops = device_breakdown(step, 1, host_ops=12)
        idle = None if busy is None else 1 - busy / step_ms
        print(f"VUMPS D = 64 iteration (GMRES) under torch.profiler: {step_ms:.4f} ms unprofiled, {host:.4f} "
              f"profiled; {ops:.0f} device operations; device busy "
              + ("not measured (no kernel recorded)" if busy is None else
                 f"{busy:.4f} ms, idle share {idle:.4f}; largest: " + "; ".join(f"{n[:60]} {t:.4f} ms" for n, t in top))
              + f" (on {card})")
        out.update({"vumps_step_ms_D64": step_ms, "vumps_device_ops_D64": ops, "vumps_device_idle_share_D64": idle})

    launched = dict(_lib.launches)
    print(f"phase 15 hand-kernel launches: {launched}")
    require(not any(launched.values()), "the classical uMPS path launches no hand kernel")
    return out


def sweep_readout(D, ansatz, ps, gvals, pool):
    """Float64 energies of a chart sweep's returned parameters: each state
    rebuilt from its parameters in complex128 on the host, read by
    ``readout_f64`` on ``pool`` from identity environments."""
    from qmps_torch.embed.unitaries import unitary_to_tensor
    from qmps_torch.parallel.sweep import _sweep_ansatz

    build, _ = _sweep_ansatz(ansatz, D)
    with torch.no_grad():
        As = unitary_to_tensor(build(ps.detach().cpu().double()))
    rs = torch.eye(D, dtype=torch.complex128).expand(len(gvals), D, D) / D ** 0.5
    return readout_f64(As, rs, gvals, pool)


def chart_step(D, n, dev):
    """One descent step of a "deep_bw" sweep of n points at D as the sweep
    runs it (the recycled energy of 24 warm matvecs, its backward, one
    fused adam update), from seeded starts; returns the step as a function."""
    from qmps_torch.parallel.sweep import _recycled_loss_env, _sweep_ansatz, tfim_matrix

    build, k = _sweep_ansatz("deep_bw", D)
    loss_env = _recycled_loss_env(build, D)
    gs = torch.linspace(0.1, 2.0, n, dtype=torch.float64).to(dev, torch.float32)
    hs = tfim_matrix(gs)
    x = (torch.randn(n, k, generator=torch.Generator().manual_seed(D), dtype=torch.float64) * 0.5).to(dev,
                                                                                                     torch.float32)
    x.requires_grad_()
    opt = torch.optim.Adam([x], lr=0.05, fused=dev.type == "cuda")
    r = (torch.eye(D, dtype=torch.complex64, device=dev) / D ** 0.5).expand(n, D, D)

    def step():
        opt.zero_grad(set_to_none=True)
        v, _ = loss_env(hs, x, r, 24)
        v.sum().backward()
        opt.step()

    return step


def sweeps_and_deep_brickwork(dev, card, pool, points=SW_POINTS, steps=SW_STEPS, grown_points=GROWN_POINTS,
                              dbw_D=DBW_D, grown_D=16):
    """Phase 16 on ``dev`` in float32: the chart sweeps (bench.py's `sweep`
    and `sweep_deep_bw` rows, GrownSweepConfig) and DeepBrickworkConfig,
    each after an untimed call of WARM_STEPS steps, read back in float64
    on the host (``pool``, a ``host_pool``); one "deep_bw" descent step of
    the sweep's batch at D = 8 and D = 16 under torch.profiler.  No hand
    kernel but the environment unroll's two, and the counters show it.  Returns the figures of the summary
    line (the arguments cut the sizes for a rehearsal on the CPU)."""
    from qmps_torch.algorithms import ground_state_deep_brickwork
    from qmps_torch.ham.exact import tfim_gs_energy_f64
    from qmps_torch.ham.hamiltonian import tfim
    from qmps_torch.kernels import _lib
    from qmps_torch.mps.tdvp import variance_certificate
    from qmps_torch.parallel import sweep_ground_states
    from qmps_torch.utils.host_eval import host_energy_gauge_free
    from qmps_torch.workloads import DeepBrickworkConfig, GrownSweepConfig, SweepConfig

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    _lib.reset_launches()

    def timed_sweep(tag, run, n, D, ansatz, gate_median):
        """run(gs, steps) untimed at WARM_STEPS on the grid, then timed at
        full steps on grid + 1e-3; gates on the float64 readout."""
        gs = torch.linspace(0.1, 2.0, n, dtype=torch.float64).to(dev, torch.float32)
        t0 = time.perf_counter()
        run(gs, WARM_STEPS)
        sync()
        t_warm = time.perf_counter() - t0
        t0 = time.perf_counter()
        es, ps = run(gs + 1e-3, steps)
        sync()
        dt = time.perf_counter() - t0
        gvals = np.linspace(0.1, 2.0, n) + 1e-3
        exact = tfim_gs_energy_f64(gvals)
        err32 = es.double().cpu().numpy() - exact
        t0 = time.perf_counter()
        err = sweep_readout(D, ansatz, ps, gvals, pool) - exact
        t_read = time.perf_counter() - t0
        print(f"{tag} ({n} points, D = {D} {ansatz!r}, {steps} steps; {ps.dtype}): {dt:.4f} s ({n / dt:.2f} "
              f"points/s; the untimed {WARM_STEPS} steps {t_warm:.4f} s); float64 readout ({t_read:.2f} s): "
              f"median {np.median(err):.4g}" + (" (< 5e-4)" if gate_median else "") + f", max {err.max():.4g} "
              f"(< 5e-3), min {err.min():.4g} (> -1e-6); float32 energies: median {np.median(err32):.4g}, max "
              f"{err32.max():.4g}, min {err32.min():.4g} (on {card})", flush=True)
        require(es.shape == (n,) and ps.shape[0] == n and np.all(np.isfinite(err)) and np.all(np.isfinite(err32)),
                f"{tag}: finite energies of the expected shapes")
        require((not gate_median or np.median(err) < 5e-4) and err.max() < 5e-3 and err.min() > -1e-6,
                f"{tag}'s float64 readout against the exact energy")
        out.update({f"{tag}_seconds": dt, f"{tag}_points_per_second": n / dt, f"{tag}_warm_up_seconds": t_warm,
                    f"{tag}_median_error": float(np.median(err)), f"{tag}_max_error": float(err.max()),
                    f"{tag}_min_error": float(err.min()), f"{tag}_median_error_f32": float(np.median(err32)),
                    f"{tag}_max_error_f32": float(err32.max()), f"{tag}_min_error_f32": float(err32.min()),
                    f"{tag}_readout_seconds": t_read})

    # (a) bench.py's `sweep` row
    timed_sweep("sweep_suN_d2",
                lambda gs, n: sweep_ground_states(gs, D=2, steps=n, restarts=SW_RESTARTS, refine_passes=1),
                points, 2, "suN", True)
    # (b) bench.py's `sweep_deep_bw` row, through SweepConfig
    cfg = SweepConfig(n_points=points, D=SW_DBW_D, steps=steps, ansatz="deep_bw", refine_passes=2, device=str(dev))
    timed_sweep(f"sweep_deep_bw_d{SW_DBW_D}", lambda gs, n: dataclasses.replace(cfg, steps=n).sweep(gs),
                points, SW_DBW_D, "deep_bw", True)

    # (c) DeepBrickworkConfig: the untimed call through the config, the
    # timed one its workload, with the state kept for the readout
    cfg = DeepBrickworkConfig(D=dbw_D, steps=steps, device=str(dev))
    t0 = time.perf_counter()
    dataclasses.replace(cfg, steps=WARM_STEPS).run()
    sync()
    t_warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ground_state_deep_brickwork(tfim(cfg.g), D=cfg.D, steps=cfg.steps,
                                      generator=torch.Generator().manual_seed(1), device=dev)
    sync()
    dt = time.perf_counter() - t0
    exact = float(tfim_gs_energy_f64(cfg.g))
    h = tfim(cfg.g).to_matrix().real
    e64 = host_energy_gauge_free(res.A, np.asarray(h, np.float64), f32_ref=res.energy)
    t0 = time.perf_counter()
    var = variance_certificate(res.A, np.asarray(h, np.float32), env_solver="gmres")  # bench.py:513-519, D > 24
    t_var = time.perf_counter() - t0
    tag = f"deep_bw_gs_d{dbw_D}"
    print(f"DeepBrickworkConfig(D = {dbw_D}, {cfg.steps} steps, seed 1, {res.params.numel()} parameters; "
          f"{res.A.dtype}): {dt:.4f} s ({cfg.steps / dt:.2f} steps/s; the untimed {WARM_STEPS} steps "
          f"{t_warm:.4f} s); float64 readout error {e64 - exact:.4g} (in (-1e-6, 5e-3)), float32 "
          f"{res.energy - exact:.4g}; variance certificate (GMRES environments, {t_var:.2f} s) {var:.4g} "
          f"(on {card})", flush=True)
    require(math.isfinite(e64) and -1e-6 < e64 - exact < 5e-3 and bool(torch.isfinite(res.history).all()),
            "DeepBrickworkConfig's float64 readout against the exact energy")
    out.update({f"{tag}_seconds": dt, f"{tag}_steps_per_second": cfg.steps / dt, f"{tag}_error": e64 - exact,
                f"{tag}_error_f32": res.energy - exact, f"{tag}_variance": var})

    # (d) GrownSweepConfig: D 2 -> 16 (max and min gated)
    cfg = GrownSweepConfig(n_points=grown_points, D=grown_D, steps=steps, device=str(dev))
    timed_sweep(f"grown_sweep_d{grown_D}", lambda gs, n: dataclasses.replace(cfg, steps=n).sweep(gs),
                grown_points, grown_D, "suN", False)

    # (e) one "deep_bw" descent step of the sweep's batch at D = 8 and 16,
    # timed as the mean of five (one step's host clock once read 3x high)
    for D in (SW_DBW_D, 16):
        step = chart_step(D, points, dev)
        step()
        sync()
        t0 = time.perf_counter()
        for _ in range(5):
            step()
        sync()
        step_ms = (time.perf_counter() - t0) * 1e3 / 5
        if not cuda:
            print(f"deep_bw descent step D = {D} ({points} points): {step_ms:.4f} ms on the CPU")
            continue
        host, busy, top, ops = device_breakdown(step, 1, host_ops=10 if D == 16 else 0)
        idle = None if busy is None else 1 - busy / step_ms
        print(f"deep_bw descent step D = {D} ({points} points) under torch.profiler: {step_ms:.4f} ms "
              f"unprofiled (a mean of 5), {host:.4f} profiled; {ops:.0f} device operations a step; device busy "
              + ("not measured (no kernel recorded)" if busy is None else
                 f"{busy:.4f} ms, idle share {idle:.4f}; largest: "
                 + "; ".join(f"{n[:60]} {t:.4f} ms" for n, t in top)) + f" (on {card})")
        out.update({f"deep_bw_d{D}_step_ms": step_ms, f"deep_bw_d{D}_step_device_ops": ops,
                    f"deep_bw_d{D}_step_idle_share": idle})

    launched = dict(_lib.launches)
    print(f"phase 16 hand-kernel launches: {launched}")
    require(not any(v for k, v in launched.items() if not k.startswith("stiefel_unroll_")),
            "the chart sweeps and the deep brickwork launch no hand kernel but the unroll's two")
    return out


def noise_and_sampling(dev, card, steps=NOISE_STEPS, inner=INNER, n_traj=NOISE_TRAJ, adam=NOISY_ADAM,
                       shots=SAMPLED_SHOTS, nm_iters=SAMPLED_NM_ITERS):
    """Phase 17 on ``dev`` in float32: the noisy and sampled NISQ path, (a)
    to (e) of the module's docstring.  No hand kernel, and the counters
    show it.  Returns the figures of the summary line (the arguments cut
    the sizes for a rehearsal on the CPU)."""
    import scipy.linalg

    from qmps_torch.algorithms import (
        NoisyNonSparseFullEnergyOptimizer,
        NoisySparseSampledEnergyOptimizer,
        batched_noise_sweep,
    )
    from qmps_torch.algorithms.evolve import _batched_noise_sweep
    from qmps_torch.circuits.ansatze import shallow_cnot_state, shallow_full_state
    from qmps_torch.embed.unitaries import unitary_to_tensor
    from qmps_torch.env.exact import get_env_exact
    from qmps_torch.env.variational import state_circuit_psi
    from qmps_torch.ham.exact import loschmidt_rate, tfim_gs_energy_f64
    from qmps_torch.ham.hamiltonian import tfim
    from qmps_torch.kernels import _lib
    from qmps_torch.mps.transfer import right_fixed_point
    from qmps_torch.objectives.energy import energy_exact_env
    from qmps_torch.objectives.noise import noisy_tdvp_amplitude, noisy_tdvp_objective
    from qmps_torch.objectives.sampling import _measured_state
    from qmps_torch.objectives.overlap import bell_tdvp_ops, mixed_transfer_with_gate
    from qmps_torch.objectives.trajectories import _trajectory_states, _uniforms, trajectory_tdvp_p0
    from qmps_torch.utils.host_eval import host_energy_gauge_free, tfim_h64_batch

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out = {}
    _lib.reset_launches()
    levels = torch.tensor(NOISE_LEVELS, dtype=torch.float32, device=dev)
    n_lv = levels.shape[0]

    def u2t(p):
        return unitary_to_tensor(shallow_full_state(p))

    # (a) untimed: the entry point, 2 outer steps from its own ground state
    t0 = time.perf_counter()
    _, warm_rates = batched_noise_sweep(G0, 0.2, 2 * DT, 2, levels, inner_steps=inner, gs_steps=GS_STEPS, lr=QUENCH_LR,
                                        generator=torch.Generator().manual_seed(0))
    sync()
    t_warm = time.perf_counter() - t0
    # timed: the entry point's body, which also hands back the final
    # states (for (b)) and the ground state's parameters
    t0 = time.perf_counter()
    times, rates, ps, p_gs = _batched_noise_sweep(G0, 0.2, steps * DT, steps, levels, inner, GS_STEPS, QUENCH_LR,
                                                  torch.Generator().manual_seed(0), None)
    sync()
    t_sweep = time.perf_counter() - t0
    n_inner = steps * inner
    t = np.arange(1, steps + 1) * DT
    got = rates.double().cpu().numpy()
    err0 = np.abs(got[0] - loschmidt_rate(t, G0, 0.2))
    d_warm = float(np.abs(warm_rates.double().cpu().numpy() - got[:, :2]).max())
    with torch.no_grad():
        e_dev = float(energy_exact_env(shallow_full_state(p_gs), torch.from_numpy(tfim(G0).to_matrix())))
        A_gs = u2t(p_gs)
    err_gs = host_energy_gauge_free(A_gs, tfim_h64_batch([G0])[0], f32_ref=e_dev) - float(tfim_gs_energy_f64(G0))
    print(f"noise sweep batched_noise_sweep({G0} -> 0.2, dt {DT}, {steps} x {inner} inner steps, levels "
          f"{NOISE_LEVELS}; {rates.dtype} on {rates.device}): {t_sweep:.4f} s with its {GS_STEPS}-step ground "
          f"state, {n_inner / t_sweep:.2f} inner steps/s ({n_inner * n_lv / t_sweep:.1f} level-steps/s; the "
          f"untimed 2 outer steps through the entry point {t_warm:.3f} s, their rates {d_warm:.3g} from the timed "
          f"run's); start float64 readout error {err_gs:.4g} (in (-1e-9, 5e-4)); p = 0 max |rate - exact| "
          f"{err0.max():.4g} (< 0.02); last rates " + ", ".join(f"{p:g}: {r:.6f}" for p, r in zip(NOISE_LEVELS, got[:, -1]))
          + f" (on {card})", flush=True)
    require(got.shape == (n_lv, steps) and np.all(np.isfinite(got)) and ps.shape == (n_lv, 15),
            "the noise sweep's rates finite, of the expected shape")
    require(np.abs(times.double().cpu().numpy() - t).max() < 1e-6, "the noise sweep's time grid")
    require(-1e-9 < err_gs < 5e-4, "the noise sweep's start against the exact energy")
    require(err0.max() < 0.02, "the noise sweep's p = 0 row against the exact rate")
    require(got[-1, -1] < got[0, -1], "the strongest noise stalls below the noiseless rate")
    require(d_warm < 1e-4, "the entry point's first steps are the timed run's")
    out.update({"noise_sweep_seconds": t_sweep, "noise_sweep_inner_steps_per_second": n_inner / t_sweep,
                "noise_sweep_warm_up_seconds": t_warm, "noise_gs_energy_error_f64": err_gs,
                "noise_p0_max_rate_error": float(err0.max()),
                **{f"noise_last_rate_{p:g}": float(r) for p, r in zip(NOISE_LEVELS, got[:, -1])}})

    # the float32 objective and gradient of all five levels at the start,
    # against complex128 on the same device
    W_np = scipy.linalg.expm(-1j * tfim(0.2).to_matrix() * (2 * DT))
    grads = {}
    for ct in (torch.complex64, torch.complex128):
        q = p_gs.to(ct.to_real()).expand(n_lv, -1).clone().requires_grad_()
        with torch.no_grad():
            A = u2t(q)
        v = noisy_tdvp_objective(A, u2t(q), torch.from_numpy(W_np).to(dev, ct), levels.to(ct.to_real()))
        v.sum().backward()
        grads[ct] = (v.detach().double(), q.grad.double())
    (v32, g32), (v64, g64) = grads[torch.complex64], grads[torch.complex128]
    err_v = (v32 - v64).abs().max().item()
    err_g = ((g32 - g64).abs().amax(-1) / g64.abs().amax(-1).clamp(min=1)).max().item()
    print(f"noise sweep start, float32 against complex128 on {dev.type}: objective {err_v:.3g} (< 2e-5), gradient "
          f"{err_g:.3g} (< 2e-4 max(1, |grad|)) over the {n_lv} levels")
    require(err_v < 2e-5 and err_g < 2e-4, "the float32 noisy objective and gradient against complex128")
    out.update({"noise_objective_error_f32": err_v, "noise_gradient_error_f32": err_g})

    # (b) trajectories on (a)'s final states, 4,096 a level
    W = torch.from_numpy(W_np).to(dev, torch.complex64)
    with torch.no_grad():
        B = u2t(ps)
        _, r = right_fixed_point(*mixed_transfer_with_gate(B, B, W))
        exact = noisy_tdvp_amplitude(B, B, W, r, levels).double()
        seed = 5
        gen = (lambda: torch.Generator(device=dev).manual_seed(seed))
        p0_mc = trajectory_tdvp_p0(B, B, W, r, levels, gen(), n_traj).double()  # also the warm-up
        sync()
        # one call lasts ~10-20 ms: time a loop of them
        t0 = time.perf_counter()
        for _ in range(NOISE_TRAJ_CALLS):
            trajectory_tdvp_p0(B, B, W, r, levels, gen(), n_traj)
        sync()
        t_traj = (time.perf_counter() - t0) / NOISE_TRAJ_CALLS
        # the spread of the same draws, for the standard error
        us = _uniforms(gen(), (n_lv, n_traj, 11, 6))
        x = _trajectory_states(bell_tdvp_ops(B, B, W, r), 6, levels, us, dtype=B.dtype, device=dev)[..., 0]
        x = x.abs().square().double()
    se = (x.std(-1) / n_traj ** 0.5).cpu().numpy()
    dev_mc = (p0_mc - exact).abs().cpu().numpy()
    same = (x.mean(-1) - p0_mc).abs().max().item()
    print(f"trajectories (4,096 a level on the final states, {n_lv * n_traj / t_traj:.0f} trajectories/s, "
          f"{t_traj:.5f} s a call, the mean of {NOISE_TRAJ_CALLS}): |P0_mc - P0| "
          + ", ".join(f"{p:g}: {d:.3g} ({d / s:.2f} se)" if s > 0 else f"{p:g}: {d:.3g}"
                      for p, d, s in zip(NOISE_LEVELS, dev_mc, se))
          + f"; the spread's draws reproduce the estimate to {same:.2g}")
    require(dev_mc[0] < 1e-5 and np.all(dev_mc[1:] < 4 * se[1:]) and same < 1e-6,
            "the trajectories' P0 against the density matrix")
    out.update({"noise_trajectories_per_second": n_lv * n_traj / t_traj, "noise_trajectory_call_seconds": t_traj,
                "noise_trajectory_max_standard_errors": float(np.max(dev_mc[1:] / se[1:]))})

    # (c) the noisy optimizer, density matrix and trajectories
    opt = NoisyNonSparseFullEnergyOptimizer(tfim(1.0), 1e-3, device=dev)
    opt.change_settings({"method": "adam", "maxiter": adam})
    sync()
    t0 = time.perf_counter()
    res = opt.optimize()
    sync()
    t_opt = time.perf_counter() - t0
    e_ex = float(tfim_gs_energy_f64(1.0))
    opt_mc = NoisyNonSparseFullEnergyOptimizer(tfim(1.0), 1e-3, simulation="trajectories", n_traj=NOISY_TRAJ,
                                               device=dev)
    with torch.no_grad():
        e_dm0 = opt.objective_function(opt.initial_guess).item()
        e_mc0 = opt_mc.objective_function(opt_mc.initial_guess).item()
    print(f"NoisyNonSparseFullEnergyOptimizer(tfim(1), 1e-3, adam {adam}; {opt.initial_guess.dtype}): {t_opt:.3f} s "
          f"({adam / t_opt:.1f} steps/s), energy - exact {res.fun - e_ex:.4g} (in (0, 0.25)); at the start "
          f"trajectories ({NOISY_TRAJ}) {e_mc0:.5f} against the density matrix {e_dm0:.5f} (within 0.2)")
    require(e_ex < res.fun < e_ex + 0.25, "the noisy optimizer's energy above exact, under exact + 0.25")
    require(abs(e_mc0 - e_dm0) < 0.2, "the trajectory mode against the density matrix")
    out.update({"noisy_optimizer_seconds": t_opt, "noisy_optimizer_energy_error": res.fun - e_ex,
                "noisy_optimizer_trajectory_gap": abs(e_mc0 - e_dm0)})

    # (d) the sampled optimizer: fresh shots at every evaluation.  An
    # estimate is sum_s c_s (1 - 2 k_s / N), so two fresh draws can give
    # the same value (at 2e5 shots a TFIM estimate takes ~1,400 likely
    # values): the gate is the spread, which a frozen draw makes zero, set
    # against the shot noise the exact probabilities predict
    sopt = NoisySparseSampledEnergyOptimizer(tfim(1.0), n_samples=shots, depth=2, device=dev)
    p = sopt.initial_guess
    with torch.no_grad():
        U = shallow_cnot_state(2, p.double().cpu())
        e_c = float(energy_exact_env(U, torch.from_numpy(tfim(1.0).to_matrix())))
        psi = state_circuit_psi(U, get_env_exact(U), 2)
        var = 0.0
        for string, coef in tfim(1.0).strings.items():
            # P(qubit 1 reads 1) of the state the string measures
            b = _measured_state(string, psi, (1, 2)).abs().square().reshape(2, 2, -1)[:, 1].sum().item()
            var += 4 * complex(coef).real ** 2 * b * (1 - b) / shots
    sopt.objective_function(p)  # warm-up
    sync()
    t0 = time.perf_counter()
    vals = [sopt.objective_function(p).item() for _ in range(SAMPLED_EVALS)]
    t_eval = time.perf_counter() - t0
    sopt.change_settings({"maxiter": nm_iters})
    t0 = time.perf_counter()
    nm = sopt.optimize()
    t_nm = time.perf_counter() - t0
    d = np.abs(np.asarray(vals) - e_c)
    spread = float(np.std(vals, ddof=1)) / var ** 0.5
    print(f"NoisySparseSampledEnergyOptimizer(tfim(1), {shots} shots, depth 2): {SAMPLED_EVALS / t_eval:.1f} "
          f"evaluations/s; max |E_sampled - E| {d.max():.4g} (< 5e-2); {len(set(vals))} distinct of "
          f"{SAMPLED_EVALS}, their spread {spread:.3f} of the shot noise's {var ** 0.5:.3g} (in (0.5, 2)); "
          f"Nelder-Mead {nm.nit} iterations in {t_nm:.2f} s, final {nm.fun:.5f} (exact "
          f"{float(tfim_gs_energy_f64(1.0)):.5f})")
    require(d.max() < 5e-2 and 0.5 < spread < 2, "the sampled objective: near exact, fresh shot noise")
    require(math.isfinite(nm.fun), "the sampled Nelder-Mead ends finite")
    out.update({"sampled_evaluations_per_second": SAMPLED_EVALS / t_eval, "sampled_max_error": float(d.max()),
                "sampled_spread_over_shot_noise": spread,
                "sampled_nelder_mead_seconds": t_nm, "sampled_nelder_mead_final": nm.fun})

    # (e) one inner step of (a) under torch.profiler
    q = ps.detach().clone().requires_grad_()
    adam_opt = torch.optim.Adam([q], lr=QUENCH_LR, fused=cuda)
    with torch.no_grad():
        As = u2t(ps)

    def inner_step():
        adam_opt.zero_grad(set_to_none=True)
        noisy_tdvp_objective(As, u2t(q), W, levels).sum().backward()
        adam_opt.step()

    inner_step()
    sync()
    t0 = time.perf_counter()
    for _ in range(10):
        inner_step()
    sync()
    step_ms = (time.perf_counter() - t0) * 1e2
    if cuda:
        host, busy, top, ops = device_breakdown(inner_step, 5, host_ops=12)
        idle = None if busy is None else 1 - busy / step_ms
        print(f"noise sweep inner step ({n_lv} levels) under torch.profiler: {step_ms:.4f} ms unprofiled (a mean "
              f"of 10), {host:.4f} profiled; {ops:.0f} device operations a step; device busy "
              + ("not measured (no kernel recorded)" if busy is None else
                 f"{busy:.4f} ms, idle share {idle:.4f}; largest: " + "; ".join(f"{n[:60]} {t:.4f} ms" for n, t in top))
              + f" (on {card})")
        out.update({"noise_inner_step_ms": step_ms, "noise_inner_step_device_ops": ops,
                    "noise_inner_step_idle_share": idle})
    else:
        print(f"noise sweep inner step ({n_lv} levels): {step_ms:.4f} ms on the CPU")

    launched = dict(_lib.launches)
    print(f"phase 17 hand-kernel launches: {launched}")
    require(not any(launched.values()), "the noisy and sampled path launches no hand kernel")
    return out


def _scars_rhs_np(y, mu):
    """The classical scars equations in numpy (scars.py:176-199), written
    apart from the port's torch ones: the host oracle's right-hand side."""
    th1, ph1, ph2, th2 = y

    def dth(a, b, c, d):
        return np.tan(d) * np.sin(a) * np.cos(a) ** 2 * np.cos(b) + np.cos(d) * np.cos(c)

    def dph(a, b, c, d):
        return 2 * np.tan(a) * np.cos(d) * np.sin(c) - 0.5 * np.tan(d) * np.cos(a) * np.sin(b) * (
            2 * np.sin(d) ** -2 + np.cos(2 * a) - 5)

    return np.array([dth(th1, ph1, ph2, th2), -mu + dph(th1, ph1, ph2, th2), -mu + dph(th2, ph2, ph1, th1),
                     dth(th2, ph2, ph1, th1)])


def _dop853(y0s, ts):
    """scipy's DOP853 at rtol = atol = 1e-12 on the host from each row of
    y0s, at the times ts: (rows, len(ts), 4)."""
    from scipy.integrate import solve_ivp

    return np.stack([solve_ivp(lambda t, y: _scars_rhs_np(y, SCARS_MU), (ts[0], ts[-1]), y0, method="DOP853",
                               rtol=1e-12, atol=1e-12, t_eval=ts).y.T for y0 in y0s])


def _odeint_cpu(y0s, ts):
    """The port's eager odeint of the scars equations on the CPU at its
    default tolerances: (rows, len(ts), 4)."""
    from qmps_torch.algorithms.scars import classical_poincare_sweep

    return classical_poincare_sweep(torch.from_numpy(y0s), torch.from_numpy(ts), SCARS_MU, device="cpu").numpy()


def _quantum_cpu(starts, steps, inner):
    """The port's quantum ensemble from ``starts`` in float64 on the CPU."""
    from qmps_torch.algorithms.scars import quantum_poincare_sweep

    return quantum_poincare_sweep(torch.from_numpy(starts), SCARS_MU, SCARS_DT, steps, inner_steps=inner,
                                  device="cpu").numpy()


def wrapped_gap(a, b):
    """|a - b| of angles, wrapped to [0, pi]."""
    return np.abs(np.angle(np.exp(1j * (np.asarray(a, np.float64) - np.asarray(b, np.float64)))))


def chart_free_gap(q, c):
    """The largest wrapped gap over the last axis between the angles q and
    c ([th1, ph1, ph2, th2]) up to the bond gauges diag(1, -1) of the
    2-site cell, which leave the state as it is and map (th1, ph2) to
    (-th1, ph2 + pi) and (th2, ph1) to (-th2, ph1 + pi): (...,)."""
    gaps = []
    for f1 in (False, True):
        for f2 in (False, True):
            e = np.array(q, np.float64)
            if f1:
                e[..., 0], e[..., 2] = -e[..., 0], e[..., 2] + np.pi
            if f2:
                e[..., 3], e[..., 1] = -e[..., 3], e[..., 1] + np.pi
            gaps.append(wrapped_gap(e, c).max(-1))
    return np.min(gaps, 0)


def scars_path(dev, card):
    """Phase 18 on ``dev``: the scars Poincare ensembles, (a) to (f) of the
    module's docstring; the quantum paths in float32.  No hand kernel, and
    the counters show it.  Returns the figures of the summary line."""
    from qmps_torch.algorithms.scars import (
        ScarsEvolver,
        _cost_from,
        _tdvp_step,
        blocked_tensor,
        classical_poincare_sweep,
        classical_rhs,
        classical_trajectory,
        constant_energy_initial_conditions,
        poincare_sections,
        quantum_poincare_sweep,
        scars_W,
        scars_energy,
    )
    from qmps_torch.core.ode import odeint
    from qmps_torch.kernels import _lib
    from qmps_torch.mps.transfer import dominant_eigval_dense, transfer_dense
    from qmps_torch.native import optimal_einsum_path, plan_total_flops
    from qmps_torch.utils.flops import PEAK_F32 as FLOPS_PEAK_F32, mfu_fields, program_costs

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n, n_times, steps, inner, dtype = SCARS_N, SCARS_TIMES, SCARS_STEPS, SCARS_INNER, torch.float32
    out = {}
    _lib.reset_launches()

    # the native planner on K6's network, beside chip_smoke's own count
    ops6 = [list(idx) for _, idx in K6_NETWORK]
    dims6 = {i: 2 for t in ops6 for i in t}
    path6 = optimal_einsum_path(ops6, dims6, [])
    mac6, mul6 = cheapest_contraction(K6_NETWORK)
    plan6 = plan_total_flops(ops6, dims6, [])
    print(f"native planner on K6's network: {len(path6) - 1} pairwise contractions, plan_total_flops {plan6}; "
          f"cheapest_contraction {mac6} complex multiply-adds + {mul6} products")
    require(isinstance(path6, list) and len(path6) == len(ops6) and plan6 > 0, "the native planner plans K6's network")
    out["k6_plan_total_flops"] = plan6

    # (a) starts on the energy shell of p0
    p0_64 = torch.tensor(SCARS_P0, dtype=torch.float64, device=dev)
    target = float(scars_energy(p0_64, SCARS_MU))
    sync()
    t0 = time.perf_counter()
    starts = constant_energy_initial_conditions(0, n, SCARS_MU, target, steps=SCARS_SHELL_STEPS, device=dev).to(dtype)
    sync()
    t_shell = time.perf_counter() - t0
    resid = (scars_energy(starts.double(), SCARS_MU) - target).abs()
    print(f"(a) {n} starts on the <H({SCARS_MU})> = {target:.6f} shell ({SCARS_SHELL_STEPS} adam steps, "
          f"{starts.dtype}) in {t_shell:.2f} s: largest shell residual {float(resid.max()):.3g} (float64 readout)")
    require(bool(torch.isfinite(starts).all()) and bool(torch.isfinite(resid).all()), "the shell starts are finite")
    out.update({"scars_shell_seconds": t_shell, "scars_shell_max_residual": float(resid.max())})

    y0s = starts.double()
    ts = torch.linspace(0, SCARS_T, n_times, dtype=torch.float64, device=dev)
    rows = min(SCARS_ORACLE_ROWS, n)
    y0_h, ts_h, halves = y0s[:rows].cpu().numpy(), ts.cpu().numpy(), (slice(0, rows // 2), slice(rows // 2, rows))
    # the host's references, computed in spawned processes while the card
    # runs (b) to (e)
    with host_pool(4) as pool:
        f_dop = [pool.submit(_dop853, y0_h[h], ts_h) for h in halves]
        f_cpu = [pool.submit(_odeint_cpu, y0_h[h], ts_h) for h in halves]
        f_q64 = pool.submit(_quantum_cpu, starts[:4].double().cpu().numpy(), steps, inner)

        # (b) the classical ensemble on the example's grid, float64
        classical_poincare_sweep(y0s[:2], ts[:3], SCARS_MU)  # untimed: first calls
        sync()
        t0 = time.perf_counter()
        trajs = classical_poincare_sweep(y0s, ts, SCARS_MU)
        sync()
        t_cl = time.perf_counter() - t0
        require(trajs.shape == (n, n_times, 4) and bool(torch.isfinite(trajs).all()),
                "the classical ensemble is finite")
        secs = poincare_sections(torch.remainder(trajs, 2 * math.pi))
        n_secs = sum(len(x) for x in secs)
        n_or = int((ts_h <= SCARS_ORACLE_T).sum())
        tight = odeint(lambda y, t: classical_rhs(y, t, SCARS_MU), y0s[:rows], ts[:n_or], rtol=1e-12, atol=1e-12)
        print(f"(b) classical ensemble, {n} trajectories x {n_times} times on [0, {float(ts[-1]):g}] (float64): "
              f"{t_cl:.2f} s, {n * n_times / t_cl:.0f} trajectory points/s; {n_secs} Poincare section points "
              f"(per trajectory: min {min(len(x) for x in secs)}, max {max(len(x) for x in secs)})")

        # (c) one quantum trajectory against the classical equations
        p0 = p0_64.to(dtype)
        ev = ScarsEvolver(SCARS_MU, SCARS_DT, inner_steps=200, lr=1e-2)
        sync()
        t0 = time.perf_counter()
        qtraj = ev.simulate(p0, steps)
        sync()
        t_one = time.perf_counter() - t0
        tq = torch.arange(steps, dtype=torch.float64, device=dev) * SCARS_DT
        ctraj = classical_trajectory(p0_64, tq, SCARS_MU)
        err_one = float(wrapped_gap(qtraj.cpu().numpy(), torch.remainder(ctraj, 2 * math.pi).cpu().numpy()).max())
        print(f"(c) ScarsEvolver(mu {SCARS_MU}, dt {SCARS_DT}, 200 inner steps, lr 1e-2).simulate(p0, {steps}) in "
              f"{dtype}: {t_one:.2f} s, {(steps - 1) * 200 / t_one:.1f} inner steps/s; max wrapped-angle gap to the "
              f"classical trajectory {err_one:.4g} (tol 0.05)")
        require(err_one < 0.05, "one quantum scars trajectory within 0.05 of the classical equations")
        out.update({"scars_trajectory_seconds": t_one, "scars_trajectory_classical_gap": err_one})

        # (d) the quantum ensemble
        quantum_poincare_sweep(starts[:2], SCARS_MU, SCARS_DT, 2, inner_steps=2)  # untimed: first calls
        sync()
        t0 = time.perf_counter()
        qens = quantum_poincare_sweep(starts, SCARS_MU, SCARS_DT, steps, inner_steps=inner)
        sync()
        t_q = time.perf_counter() - t0
        cl_q = torch.remainder(classical_poincare_sweep(y0s, tq, SCARS_MU), 2 * math.pi).cpu().numpy()
        qens_h = qens.cpu().numpy()
        dev_cl = wrapped_gap(qens_h, cl_q).max(axis=(1, 2))
        dev_chart = chart_free_gap(qens_h, cl_q).max(axis=1)
        # the states themselves: |x| of the quantum and classical cells'
        # mixed transfer matrix, 1 where they agree, in any chart
        with torch.no_grad():
            q64, c64 = (torch.from_numpy(x).to(dev, torch.float64) for x in (qens_h, cl_q))
            fid = dominant_eigval_dense(transfer_dense(blocked_tensor(q64), blocked_tensor(c64))).abs()
        fid_row, off = fid.cpu().numpy().min(1), dev_cl > 1

        # (b) and (d) against the host's references
        ref_full = np.concatenate([f.result() for f in f_dop])
        cpu_full = np.concatenate([f.result() for f in f_cpu])
        ref64 = f_q64.result()
    trajs_h = trajs[:rows].cpu().numpy()
    gap_cpu = float(np.abs(trajs_h - cpu_full).max())
    gap_full = float(np.abs(trajs_h - ref_full).max())
    gap_or = float(np.abs(tight.movedim(0, 1).cpu().numpy() - ref_full[:, :n_or]).max())
    print(f"(b) {rows} rows of the ensemble against the port's eager odeint on the CPU at the same tolerances "
          f"{gap_cpu:.3g} (tol {SCARS_CPU_GATE:g}); against scipy DOP853 (rtol = atol = 1e-12) on the host: "
          f"odeint at 1e-12 on t <= {SCARS_ORACLE_T:g} {gap_or:.3g} (tol 1e-6), the ensemble's default-tolerance "
          f"rows over the whole horizon {gap_full:.3g} (tol 1e-2)")
    require(gap_cpu < SCARS_CPU_GATE, f"the classical ensemble on the card against the CPU's ({SCARS_CPU_GATE:g})")
    require(gap_or < 1e-6, "odeint on the card against DOP853 (1e-6)")
    require(gap_full < 1e-2, "the classical ensemble against DOP853 over the horizon (1e-2)")
    out.update({"scars_classical_seconds": t_cl, "scars_classical_points_per_second": n * n_times / t_cl,
                "scars_poincare_points": n_secs, "scars_classical_cpu_gap": gap_cpu,
                "scars_classical_oracle_error": gap_or, "scars_classical_horizon_error": gap_full})

    gap32 = float(wrapped_gap(qens_h[:4], ref64).max())
    n_inner = (steps - 1) * inner
    print(f"(d) quantum ensemble, {n} trajectories x {steps} steps of {inner} inner steps (dt {SCARS_DT}, "
          f"{dtype}): {t_q:.2f} s, {n_inner / t_q:.1f} inner steps/s, {n * (steps - 1) / t_q:.1f} trajectory "
          f"steps/s; rows 0-3 against the port's float64 run on the CPU: max wrapped-angle gap {gap32:.3g} "
          f"(tol {SCARS_F32_GATE:g}); each row's max gap to the classical ensemble (not gated): median "
          f"{float(np.median(dev_cl)):.4g}, max {float(dev_cl.max()):.4g} ({int((dev_cl > 1).sum())} rows over 1, "
          f"where a theta crossed 0 or pi); up to the bond gauges (th1, ph2) -> (-th1, ph2 + pi) and (th2, ph1) -> "
          f"(-th2, ph1 + pi): median {float(np.median(dev_chart)):.4g}, max {float(dev_chart.max()):.4g}; the states' "
          f"overlap a cell |x| at least {fid_row.min():.6f}, in the rows over 1 at least "
          f"{fid_row[off].min() if off.any() else float('nan'):.6f}")
    require(bool(np.isfinite(qens_h).all()) and gap32 < SCARS_F32_GATE,
            f"the {dtype} quantum ensemble against float64 ({SCARS_F32_GATE:g})")
    out.update({"scars_quantum_seconds": t_q, "scars_inner_steps_per_second": n_inner / t_q,
                "scars_trajectory_steps_per_second": n * (steps - 1) / t_q, "scars_quantum_f32_gap": gap32,
                "scars_quantum_classical_gap_median": float(np.median(dev_cl)),
                "scars_quantum_classical_gap_max": float(dev_cl.max()),
                "scars_quantum_classical_gauge_free_gap_max": float(dev_chart.max()),
                "scars_quantum_classical_min_overlap": float(fid_row.min())})

    # (e) one outer step under torch.profiler, and one inner step's MFU
    W = scars_W(SCARS_MU, 4.0 * SCARS_DT)
    ps = qens[:, -1].clone()
    outer_ms = t_q / (steps - 1) * 1e3
    q = ps.clone().requires_grad_()
    adam_opt = torch.optim.Adam([q], lr=2e-2, fused=cuda)
    cost = _cost_from(ps, W)

    def inner_step():
        adam_opt.zero_grad(set_to_none=True)
        cost(q).sum().backward()
        adam_opt.step()

    inner_step()
    costs = program_costs(inner_step)
    sync()
    t0 = time.perf_counter()
    for _ in range(20):
        inner_step()
    sync()
    inner_s = (time.perf_counter() - t0) / 20
    mfu = mfu_fields("scars_inner_step", costs["flops"], 1 / inner_s, FLOPS_PEAK_F32, costs["bytes"])
    rate = costs["flops"] / inner_s
    print(f"(e) one inner step: {inner_s * 1e3:.4f} ms (a mean of 20), {costs['flops']:.0f} product flops and "
          f"{costs['bytes']:.0f} bytes dispatched (utils/flops.program_costs): {rate:.4g} flop/s, MFU "
          f"{rate / FLOPS_PEAK_F32:.3g} of the float32 peak; {mfu}")
    out.update({"scars_inner_step_ms": inner_s * 1e3, "scars_inner_step_flops_per_second": rate, **mfu})
    if cuda:
        host, busy, top, n_ops = device_breakdown(lambda: _tdvp_step(ps, W, inner, 2e-2), 1, host_ops=12)
        idle = None if busy is None else 1 - busy / outer_ms
        print(f"(e) one outer step ({inner} inner steps, {n} trajectories) under torch.profiler: {outer_ms:.2f} ms "
              f"unprofiled (the mean of (d)), {host:.2f} profiled; {n_ops:.0f} device operations "
              f"({n_ops / inner:.1f} an inner step); device busy "
              + ("not measured (no kernel recorded)" if busy is None else
                 f"{busy:.3f} ms, idle share {idle:.4f}; largest: " + "; ".join(f"{nm[:60]} {t:.4f} ms" for nm, t in top))
              + f" (on {card})")
        out.update({"scars_outer_step_ms": outer_ms, "scars_outer_step_device_ops": n_ops,
                    "scars_outer_step_idle_share": idle})

    launched = dict(_lib.launches)
    print(f"phase 18 hand-kernel launches: {launched}")
    require(not any(launched.values()), "the scars path launches no hand kernel")
    return out


def sharded_sweeps(dev, card, g64, params0, pool):
    """Phase 19: (a) phase 5's config-4 sweep and its represent step on
    ``make_mesh()`` (every card), on a mesh of the card twice and
    unsharded, each after an untimed run: energies within 1e-6 of the
    unsharded run, phase 5's float64 readout gates, K1-K3 launched by every
    shard; (b) phase 7's quench family, cut to SHARD_QUENCH_STEPS outer
    steps, on the card twice against unsharded: rates within 1e-6, K4 and
    K5 launched by both shards; (c) the Stiefel sweep at the "default"
    tier with a full-float32 tail (``stiefel_tier_sharded``); (d) the wall
    times, not gated.  Returns the metrics for the JSON line."""
    from qmps_torch.algorithms.evolve import batched_quench_sweep
    from qmps_torch.ham.classical_baselines import host_energy_d2
    from qmps_torch.ham.exact import tfim_gs_energy_f64
    from qmps_torch.kernels import _lib
    from qmps_torch.kernels.pallas_power import dominant_eig_batched
    from qmps_torch.parallel import make_mesh
    from qmps_torch.parallel.mesh import Mesh, shard_over_sweep
    from qmps_torch.parallel.sweep import sweep_ground_states_fused, tfim_matrix

    def counts(**launched):
        return {**dict.fromkeys(_lib.launches, 0), **launched}

    n_cards = torch.cuda.device_count()
    meshes = {"make_mesh()": make_mesh(), "the card twice": Mesh((dev, dev)), "unsharded": None}
    h_host = tfim_matrix(torch.from_numpy(g64)).numpy()
    exact = tfim_gs_energy_f64(g64)

    def main_path(mesh):
        t0 = time.perf_counter()
        es, As = sweep_ground_states_fused(g64, steps=STEPS, lr=LR, momentum=MOMENTUM, restarts=RESTARTS, mesh=mesh)
        torch.cuda.synchronize()
        t_sweep = time.perf_counter() - t0
        lam, _ = shard_over_sweep(lambda A: dominant_eig_batched(transfer(A), iters=K1_ITERS), mesh)(As)
        torch.cuda.synchronize()
        return es, As, lam, t_sweep

    runs = {}
    for tag, mesh in meshes.items():
        main_path(mesh)  # untimed: the first call of each mesh
        _lib.reset_launches()
        runs[tag] = main_path(mesh)
        n = 1 if mesh is None else len(mesh)
        got = dict(_lib.launches)
        require(got == counts(dominant_eig=n, energy_fwd=n * (STEPS + 1), energy_bwd=n * STEPS),
                f"phase 19 {tag}: K1-K3 carried each of its {n} shards {got}")
    out = {"shard_device_count": n_cards}
    es_ref = runs["unsharded"][0].double()
    for tag in ("make_mesh()", "the card twice"):
        es, As, lam, t_sweep = runs[tag]
        diff = (es.double() - es_ref).abs().max().item()
        A_host = isometry_f64(As.cpu().numpy().astype(np.complex128))
        err = np.array([host_energy_d2(A_host[b], h_host[b]) for b in range(N_POINTS)]) - exact
        unit = (lam.abs() - 1).abs().max().item()
        print(f"phase 19 sweep on {tag} ({len(meshes[tag])} shards, {n_cards} cards): {t_sweep:.4f} s against "
              f"{runs['unsharded'][3]:.4f} s unsharded; |energy - unsharded| {diff:.3g} (tol 1e-6); float64 readout "
              f"median {np.median(err):.4g}, max {err.max():.4g}, min {err.min():.4g}; represent ||lam|-1| {unit:.3g}")
        require(es.shape == (N_POINTS,) and As.shape == (N_POINTS, 2, 2, 2) and es.is_cuda
                and np.all(np.isfinite(err)), f"phase 19 {tag}: finite sweep output of the expected shapes")
        require(diff < 1e-6, f"phase 19 {tag}: the energies of the unsharded run")
        require(np.median(err) < 5e-4 and err.max() < 5e-3 and err.min() > -1e-9, f"phase 19 {tag}: sweep vs exact")
        require(unit < 1e-5, f"phase 19 {tag}: represent step |lam| = 1")
        key = "make_mesh" if tag == "make_mesh()" else "card_twice"
        out.update({f"shard_sweep_seconds_{key}": t_sweep, f"shard_sweep_energy_diff_{key}": diff,
                    f"shard_sweep_max_error_{key}": float(err.max())})
    out["shard_sweep_seconds_unsharded"] = runs["unsharded"][3]

    g1 = np.linspace(G1_MIN, G1_MAX, N_G1)
    n_inner = SHARD_QUENCH_STEPS * INNER
    rates = {}
    for tag in ("unsharded", "the card twice"):
        _lib.reset_launches()
        t0 = time.perf_counter()
        _, les = batched_quench_sweep(G0, g1, t_max=SHARD_QUENCH_STEPS * DT, n_steps=SHARD_QUENCH_STEPS,
                                      inner_steps=INNER, lr=QUENCH_LR, params0=params0, engine="pallas",
                                      pallas_iters=TDVP_ITERS, mesh=meshes[tag])
        torch.cuda.synchronize()
        n = 1 if meshes[tag] is None else 2
        rates[tag] = (-torch.log(les.double()), time.perf_counter() - t0)
        got = dict(_lib.launches)
        require(got == counts(tdvp_fwd=n * n_inner, tdvp_bwd=n * n_inner), f"phase 19 quench on {tag}: {got}")
    diff_q = (rates["the card twice"][0] - rates["unsharded"][0]).abs().max().item()
    print(f"phase 19 quench family ({N_G1} g1, {SHARD_QUENCH_STEPS} x {INNER} inner steps) on the card twice: "
          f"{rates['the card twice'][1]:.4f} s against {rates['unsharded'][1]:.4f} s unsharded (first calls); "
          f"|rate - unsharded| {diff_q:.3g} (tol 1e-6) on {card}")
    require(bool(torch.isfinite(rates["the card twice"][0]).all()) and diff_q < 1e-6,
            "phase 19: the sharded quench's rates equal the unsharded run's")
    out.update(shard_quench_seconds_card_twice=rates["the card twice"][1],
               shard_quench_seconds_unsharded=rates["unsharded"][1], shard_quench_rate_diff=diff_q)
    out.update(stiefel_tier_sharded(dev, card, {t: meshes[t] for t in ("the card twice", "unsharded")}, pool))
    return out


def stiefel_tier_sharded(dev, card, meshes, pool):
    """Phase 19 (c): the Stiefel sweep at phase 14's D = 32 schedule (180
    steps, the first 120 at the "default" tier, one-pass TF32, the last 60
    and the readout at full float32) on SHARD_STF_POINTS points of its grid,
    on each mesh of ``meshes`` (the card twice: two worker threads), read
    back in float64 on ``pool`` against the exact energy at phase 14's gates
    (median < 5e-4, max < 5e-3, min > -1e-4).  After each call the
    process is back at the package's full-float32 pin (precision "highest",
    allow_tf32 False), and every step of every shard ran at the tier its
    phase sets: each retraction's precision is recorded with its thread
    (the first steps of both shards under the caller's tier, then the
    polish steps of both at full float32).  Unsharded on the card each phase
    is one CUDA graph: its two eager warm-ups and its capture record the
    retractions that its replays repeat.  Sharded and unsharded float32
    energies are printed, not gated: cuBLAS may take other TF32 algorithms
    for a shard's half of the batch.  No hand kernel."""
    import threading

    from qmps_torch.ham.exact import tfim_gs_energy_f64
    from qmps_torch.kernels import _lib
    from qmps_torch.parallel import sweep as psweep

    kw = STF_RUNS[SHARD_STF_D]
    steps, polish = kw["steps"], kw["polish_steps"]
    gvals = np.linspace(*STF_G, SHARD_STF_POINTS) + 1e-3
    exact = tfim_gs_energy_f64(gvals)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)  # a CPU rehearsal runs it too
    polar, seen = psweep._polar_ns, []
    psweep._polar_ns = lambda W, iters=10: seen.append((threading.get_ident(), torch.get_float32_matmul_precision())) \
        or polar(W, iters)
    out, runs = {}, {}
    try:
        for tag, mesh in meshes.items():
            seen.clear()
            _lib.reset_launches()
            t0 = time.perf_counter()
            es, As, rs = psweep.sweep_ground_states_stiefel(torch.tensor(gvals, dtype=torch.float32, device=dev),
                                                            D=SHARD_STF_D, mesh=mesh, **kw)
            sync()
            dt = time.perf_counter() - t0
            pin = (torch.get_float32_matmul_precision(), torch.backends.cuda.matmul.allow_tf32)
            n = 1 if mesh is None else len(mesh)
            threads = n if dev.type == "cuda" else 1  # the CPU's shards run in the caller's thread
            # retractions run in Python a shard: each step's, or a graphed phase's warm-ups and capture
            graphed = dev.type == "cuda" and mesh is None
            first, last = (min(k, 3) if graphed else k for k in (steps - polish, polish))
            low, tail = seen[:n * first], seen[n * first:]
            per_thread = [sorted({t for t, _ in part}) for part in (low, tail)]
            t0 = time.perf_counter()
            err = readout_f64(As, rs, gvals, pool, parts=SHARD_STF_WORKERS) - exact
            t_read = time.perf_counter() - t0
            runs[tag] = es.double()
            print(f"phase 19 Stiefel sweep D = {SHARD_STF_D} on {tag} ({n} shards, {SHARD_STF_POINTS} points, {steps} "
                  f"steps, the first {steps - polish} at 'default'): {dt:.4f} s; after it precision {pin[0]!r}, "
                  f"allow_tf32 {pin[1]}; retractions at 'high' {sum(p == 'high' for _, p in low)} of {len(low)} "
                  f"first steps in {len(per_thread[0])} threads, at 'highest' {sum(p == 'highest' for _, p in tail)} "
                  f"of {len(tail)} polish steps in {len(per_thread[1])} threads; float64 readout ({t_read:.2f} s): "
                  f"median {np.median(err):.4g}, max {err.max():.4g}, min {err.min():.4g} (on {card})")
            require(es.shape == (SHARD_STF_POINTS,) and As.shape == (SHARD_STF_POINTS, 2, SHARD_STF_D, SHARD_STF_D)
                    and np.all(np.isfinite(err)), f"phase 19 Stiefel {tag}: finite output of the expected shapes")
            require(pin == ("highest", False), f"phase 19 Stiefel {tag}: the full-float32 pin after the call {pin}")
            require(len(seen) == n * (first + last) and all(p == "high" for _, p in low)
                    and all(p == "highest" for _, p in tail) and all(len(t) == threads for t in per_thread),
                    f"phase 19 Stiefel {tag}: each shard's first steps under the tier, its polish at full float32")
            require(not any(v for k, v in _lib.launches.items() if not k.startswith("stiefel_unroll_")),
                    f"phase 19 Stiefel {tag}: no hand kernel but the unroll's two {dict(_lib.launches)}")
            require(np.median(err) < 5e-4 and err.max() < 5e-3 and err.min() > -1e-4,
                    f"phase 19 Stiefel {tag}: float64 readout against the exact energy")
            key = "card_twice" if mesh is not None else "unsharded"
            out.update({f"shard_stiefel_seconds_{key}": dt, f"shard_stiefel_max_error_{key}": float(err.max()),
                        f"shard_stiefel_median_error_{key}": float(np.median(err))})
    finally:
        psweep._polar_ns = polar
    diff = (runs["the card twice"] - runs["unsharded"]).abs().max().item()
    print(f"phase 19 Stiefel sweep: |float32 energy, the card twice - unsharded| {diff:.3g} (not gated)")
    out["shard_stiefel_energy_diff"] = diff
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    if not (Path(__file__).resolve().parent / "qmps_torch").is_dir():
        # the script alone, outside a checkout: there is no port to drive
        print("chip_smoke: no qmps_torch beside this script; run it from the repo's root", file=sys.stderr)
        return 1
    from qmps_torch import kernel_ab
    from qmps_torch.algorithms.evolve import batched_quench_sweep
    from qmps_torch.algorithms.ground_state import find_ground_state
    from qmps_torch.circuits.ansatze import shallow_full_state
    from qmps_torch.ham.classical_baselines import host_energy_d2
    from qmps_torch.ham.exact import loschmidt_rate, tfim_gs_energy_f64
    from qmps_torch.ham.hamiltonian import tfim
    from qmps_torch.kernels import _lib
    from qmps_torch.kernels import energy_fused as tef
    from qmps_torch.kernels import pallas_power as tpp
    from qmps_torch.kernels import tdvp_fused as tdf
    from qmps_torch.mps.transfer import transfer_dense
    from qmps_torch.objectives.energy import energy_exact_env
    from qmps_torch.objectives.overlap import mixed_transfer_with_gate, tdvp_objective, tdvp_objective_pallas
    from qmps_torch.kernels.pallas_power import _dominant_eig_plain, dominant_eig_batched
    from qmps_torch.parallel.sweep import _fused_sweep_programs, sweep_ground_states_fused, tfim_matrix
    from qmps_torch.algorithms import brickwork_tdvp as bwt
    from qmps_torch.kernels import brickwork_pallas as k6
    from qmps_torch.kernels.brickwork_fast import manifold_overlap_batched
    from qmps_torch.workloads import BrickworkConfig

    dev = torch.device("cuda")
    c64, c128 = torch.complex64, torch.complex128

    def counts(**launched):
        """The launch counters as a run that launched only ``launched`` leaves them."""
        return {**dict.fromkeys(_lib.launches, 0), **launched}

    # ---- 1. device ----
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)

    # ---- 2. build ----
    t0 = time.perf_counter()
    path, log = _lib.build()
    _lib.lib()
    print(f"build: {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in log.splitlines():
        if "ptxas" in line or "spill" in line:
            print("  " + line.strip())

    results = {}

    # ---- 3. represent: K1 at 65,536 and 1,024 ----
    A1 = torch.from_numpy(left_canonical(np.random.default_rng(0), K1_BATCH)).to(dev, c64)
    E = transfer(A1).contiguous()
    lib, stream = _lib.lib(), torch.cuda.current_stream().cuda_stream
    errs1 = {}
    for n in (K1_BATCH, N_POINTS):  # one thread an element, and the represent step's layout
        En = E[:n]
        lam, v = dominant_eig_batched(En, iters=K1_ITERS)
        lam_w, v_w, w = tpp._dominant_eig_cuda(En, K1_ITERS, "squaring", left=True)
        M_p = tpp._squarings(En.to(c128), K1_ITERS)
        lam_p, v_p = tpp._extract_eigpair(En.to(c128), M_p)
        w_p = tpp._left_vector(M_p)
        errs1[n] = ((lam.to(c128) - lam_p).abs().max().item(), (phase_aligned(v.to(c128), v_p) - v_p).abs().max().item(),
                    (phase_aligned(w.to(c128), w_p) - w_p).abs().max().item(), (lam.abs() - 1).abs().max().item())
        print(f"K1 ({n} x 4x4, iters {K1_ITERS}): |dlam| {errs1[n][0]:.3g} (tol 1e-5), |dv| up to phase "
              f"{errs1[n][1]:.3g} (tol 1e-4), ||lam|-1| {errs1[n][3]:.3g} (tol 1e-5); the left vector: |dw| up to "
              f"phase {errs1[n][2]:.3g} (tol 1e-4)")
        require(errs1[n][0] < 1e-5 and errs1[n][1] < 1e-4 and errs1[n][3] < 1e-5 and errs1[n][2] < 1e-4,
                f"K1 against its plain version ({n})")
        require(torch.equal(lam_w, lam) and torch.equal(v_w, v), f"K1 with the left vector: the same lam and v ({n})")
    # kernel times: raw launches into preallocated outputs, so that the
    # wrapper's host work (~30 us) does not hide a shorter kernel, and
    # queued behind a spin kernel (the card's time); the outputs are then
    # checked against the wrapper's
    lam, v = dominant_eig_batched(E, iters=K1_ITERS)
    lam_o, v_o = torch.empty_like(lam), torch.empty_like(v)

    def launch1(n):
        return lambda: lib.qmps_dominant_eig(E.data_ptr(), lam_o.data_ptr(), v_o.data_ptr(), None, n, K1_ITERS, 0,
                                             stream)

    results["K1"] = dict(
        max_abs_err=max(max(e[:3]) for e in errs1.values()),
        ms=cuda_ms(launch1(K1_BATCH), 50),
        plain_ms=cuda_ms(lambda: _dominant_eig_plain(E, iters=K1_ITERS), 5),
        library_ms=eig_library_ms(E),
    )
    results["K1"].update(zip(("bound_ms", "bound_by"), bound(*kernel_work("K1", K1_BATCH))))
    require(torch.equal(lam_o, lam) and torch.equal(v_o, v), "K1 timed launches reproduce its output")
    for n in (K1_BATCH, 4096, N_POINTS):
        results["K1"][f"device_ms_{n}"] = cuda_ms(launch1(n), 50 if n > 4096 else 200, queued=True)
        results["K1"][f"bound_ms_{n}"] = bound(*kernel_work("K1", n))[0]
    results["K1"][f"ms_{N_POINTS}"] = cuda_ms(launch1(N_POINTS), 200)
    print("K1 times: raw " + f"{results['K1']['ms']:.5f} ms at {K1_BATCH}, {results['K1'][f'ms_{N_POINTS}']:.5f} ms at "
          f"{N_POINTS}; queued " + ", ".join(f"{results['K1'][f'device_ms_{n}']:.5f} ms at {n} (bound "
                                             f"{results['K1'][f'bound_ms_{n}']:.5f})" for n in (K1_BATCH, 4096, N_POINTS)))

    # ---- 4. energy: K2, K3 on the sweep's first-step batch ----
    g64 = np.linspace(0.1, 2.0, N_POINTS) + 1e-3
    gs = torch.tensor(g64, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(0)
    B = N_POINTS * RESTARTS
    xre = torch.randn((B, 4, 2), generator=gen, dtype=torch.float64).to(dev, torch.float32)
    xim = torch.randn((B, 4, 2), generator=gen, dtype=torch.float64).to(dev, torch.float32)
    init, _, _ = _fused_sweep_programs(LR, MOMENTUM, RESTARTS, 48)
    hs, V0, _ = init(gs, xre, xim)
    A = V0.reshape(-1, 2, 2, 2).transpose(1, 2).contiguous()
    h = hs.to(c64).contiguous()
    ct = torch.ones(B, device=dev)
    e, lam, v = tef._fwd_cuda(A, h, 48)
    Abar, hbar = tef._bwd_cuda(A, h, lam, v, ct)
    e_p, lam_p, v_p = tef._fwd_plain(A.to(c128), h.to(c128), 48)
    Abar_p, hbar_p = tef._bwd_plain(A.to(c128), h.to(c128), lam_p, v_p, ct.double())
    err_e = (e.double() - e_p).abs().max().item()
    err_lam = (lam.to(c128) - lam_p).abs().max().item()
    err_v = (v.to(c128) - v_p).abs().max().item()
    err_h = (hbar.to(c128) - hbar_p).abs().max().item()
    dA = (Abar.to(c128) - Abar_p).abs().reshape(B, -1).max(1).values
    scale = Abar_p.abs().reshape(B, -1).max(1).values.clamp(min=1.0)
    err_A, err_A_scaled = dA.max().item(), (dA / scale).max().item()
    print(f"K2 ({B}): |de| {err_e:.3g} (tol 2e-5), |dlam| {err_lam:.3g} (tol 1e-5), "
          f"|dv| {err_v:.3g} (tol 1e-4)")
    print(f"K3 ({B}): |dhbar| {err_h:.3g} (tol 3e-4), |dAbar| {err_A:.3g}, "
          f"|dAbar|/max(1,|Abar|) {err_A_scaled:.3g} (tol 3e-4), "
          f"elements over 3e-4 absolute: {int((dA > 3e-4).sum())} of {B}")
    require(err_e < 2e-5 and err_lam < 1e-5 and err_v < 1e-4, "K2 against its plain version")
    require(err_h < 3e-4 and err_A_scaled < 3e-4, "K3 against its plain version")
    e_o, lam_o, v_o = torch.empty_like(e), torch.empty_like(lam), torch.empty_like(v)
    Abar_o, hbar_o = torch.empty_like(Abar), torch.empty_like(hbar)
    results["K2"] = dict(
        max_abs_err=err_e,
        ms=cuda_ms(lambda: lib.qmps_energy_fwd(
            A.data_ptr(), h.data_ptr(), e_o.data_ptr(), lam_o.data_ptr(), v_o.data_ptr(),
            B, 48, stream), 50),
        plain_ms=cuda_ms(lambda: tef._fwd_plain(A, h, 48), 5),
    )
    def launch3():
        lib.qmps_energy_bwd(A.data_ptr(), h.data_ptr(), v.data_ptr(), lam.data_ptr(), ct.data_ptr(),
                            Abar_o.data_ptr(), hbar_o.data_ptr(), B, tef.SERIES_K, stream)

    results["K3"] = dict(max_abs_err=err_A, ms=cuda_ms(launch3, 50), device_ms=cuda_ms(launch3, 200, queued=True),
                         plain_ms=cuda_ms(lambda: tef._bwd_plain(A, h, lam, v, ct), 5))
    require(torch.equal(e_o, e) and torch.equal(v_o, v) and torch.equal(Abar_o, Abar)
            and torch.equal(hbar_o, hbar), "K2, K3 timed launches reproduce their outputs")
    # K2 at 65,536, where the launcher may pick another layout than at the
    # sweep's 4,096: phase 4's gates on seeded left-canonical A, TFIM h
    A2 = torch.from_numpy(left_canonical(np.random.default_rng(4), TDVP_BATCH)).to(dev, c64)
    h2 = tfim_matrix(torch.linspace(0.1, 2.0, TDVP_BATCH, dtype=torch.float64, device=dev)).to(c64)
    e2, lam2, v2 = tef._fwd_cuda(A2, h2, 48)
    e2_p, lam2_p, v2_p = tef._fwd_plain(A2.to(c128), h2.to(c128), 48)
    errs2 = ((e2.double() - e2_p).abs().max().item(), (lam2.to(c128) - lam2_p).abs().max().item(),
             (v2.to(c128) - v2_p).abs().max().item())
    print(f"K2 ({TDVP_BATCH}): |de| {errs2[0]:.3g} (tol 2e-5), |dlam| {errs2[1]:.3g} (tol 1e-5), "
          f"|dv| {errs2[2]:.3g} (tol 1e-4)")
    require(errs2[0] < 2e-5 and errs2[1] < 1e-5 and errs2[2] < 1e-4, f"K2 against its plain version ({TDVP_BATCH})")
    results["K2"]["max_abs_err"] = max(err_e, errs2[0])
    # K3 there too, on K2's outputs, under the gates of the sweep's batch
    ct2 = torch.ones(TDVP_BATCH, device=dev)
    Abar2, hbar2 = tef._bwd_cuda(A2, h2, lam2, v2, ct2)
    Abar2_p, hbar2_p = tef._bwd_plain(A2.to(c128), h2.to(c128), lam2_p, v2_p, ct2.double())
    err_h2 = (hbar2.to(c128) - hbar2_p).abs().max().item()
    dA2 = (Abar2.to(c128) - Abar2_p).abs().reshape(TDVP_BATCH, -1).max(1).values
    err_A2 = (dA2 / Abar2_p.abs().reshape(TDVP_BATCH, -1).max(1).values.clamp(min=1.0)).max().item()
    Abar2_o, hbar2_o = torch.empty_like(Abar2), torch.empty_like(hbar2)
    A2, h2 = A2.contiguous(), h2.contiguous()  # the raw launches read the memory as is

    def launch3_big():
        lib.qmps_energy_bwd(A2.data_ptr(), h2.data_ptr(), v2.data_ptr(), lam2.data_ptr(), ct2.data_ptr(),
                            Abar2_o.data_ptr(), hbar2_o.data_ptr(), TDVP_BATCH, tef.SERIES_K, stream)

    results["K3"].update(max_abs_err=max(err_A, dA2.max().item()), batch_big=TDVP_BATCH,
                         device_ms_big=cuda_ms(launch3_big, 50, queued=True),
                         bound_ms_big=bound(*kernel_work("K3", TDVP_BATCH))[0])
    require(torch.equal(Abar2_o, Abar2) and torch.equal(hbar2_o, hbar2), "K3 timed launches reproduce its output")
    print(f"K3 ({TDVP_BATCH}): |dhbar| {err_h2:.3g} (tol 3e-4), |dAbar| {dA2.max().item():.3g}, |dAbar|/max(1,|Abar|) "
          f"{err_A2:.3g} (tol 3e-4); queued {results['K3']['device_ms_big']:.5f} ms. At {B}: raw "
          f"{results['K3']['ms']:.5f} ms, queued {results['K3']['device_ms']:.5f} ms")
    require(err_h2 < 3e-4 and err_A2 < 3e-4, f"K3 against its plain version ({TDVP_BATCH})")
    # no single PyTorch call computes the energy objective or its adjoint
    for k in ("K2", "K3"):
        results[k].update(zip(("bound_ms", "bound_by"), bound(*kernel_work(k, B))), library_ms=None)

    # ---- 5. main path, optimize: config-4 sweep, then represent its states ----
    def main_path():
        """The sweep (timed) and the represent step on its states."""
        t0 = time.perf_counter()
        # host floats and no device: the entry point's default is the card
        es, As = sweep_ground_states_fused(
            g64, steps=STEPS, lr=LR, momentum=MOMENTUM, restarts=RESTARTS
        )
        torch.cuda.synchronize()
        t_sweep = time.perf_counter() - t0
        lam, _ = dominant_eig_batched(transfer(As), iters=K1_ITERS)
        torch.cuda.synchronize()
        return es, As, lam, t_sweep

    main_path()  # warm-up
    _lib.reset_launches()
    es, As, lam_out, dt = main_path()
    launches = dict(_lib.launches)
    print(f"sweep: {N_POINTS} points x {STEPS} steps x {RESTARTS} restarts in {dt:.4f} s, "
          f"{N_POINTS / dt:.1f} points/s on {card}; launches {launches}")
    require(launches == counts(dominant_eig=1, energy_fwd=STEPS + 1, energy_bwd=STEPS),
            f"launch counts of the main path {launches}")

    A_host = isometry_f64(As.cpu().numpy().astype(np.complex128))
    h_host = tfim_matrix(torch.from_numpy(g64)).numpy()
    e64 = np.array([host_energy_d2(A_host[b], h_host[b]) for b in range(N_POINTS)])
    err = e64 - tfim_gs_energy_f64(g64)
    err_dev = np.abs(es.cpu().numpy().astype(np.float64) - e64).max()
    unit = (lam_out.abs() - 1).abs().max().item()
    print(f"sweep vs exact (float64 readout): median {np.median(err):.4g} (< 5e-4), "
          f"max {err.max():.4g} (< 5e-3), min {err.min():.4g} (> -1e-9); "
          f"|device f32 energy - readout| max {err_dev:.3g}; represent ||lam|-1| {unit:.3g}")
    require(np.all(np.isfinite(err)) and es.shape == (N_POINTS,) and As.shape == (N_POINTS, 2, 2, 2)
            and es.is_cuda and As.is_cuda, "finite sweep output of the expected shapes, on the card")
    require(np.median(err) < 5e-4 and err.max() < 5e-3 and err.min() > -1e-9, "sweep against exact")
    require(unit < 1e-5, "represent step: |lam| = 1")
    # K1 at the main path's own batch: the represent step's 1,024 matrices,
    # raw and queued behind a spin kernel, checked against the main path's
    E_main = transfer(As).contiguous()
    lam_mo, v_mo = torch.empty_like(lam_out), torch.empty(N_POINTS, 4, dtype=c64, device=dev)

    def launch1_main():
        lib.qmps_dominant_eig(E_main.data_ptr(), lam_mo.data_ptr(), v_mo.data_ptr(), None, N_POINTS, K1_ITERS, 0,
                              stream)

    results["K1"].update(batch_main=N_POINTS, ms_main=cuda_ms(launch1_main, 200),
                         device_ms_main=cuda_ms(launch1_main, 200, queued=True),
                         bound_ms_main=bound(*kernel_work("K1", N_POINTS))[0])
    require(torch.equal(lam_mo, lam_out), "K1 timed launches reproduce the main path's (1,024)")
    print(f"K1 at the main path's batch ({N_POINTS}): raw {results['K1']['ms_main']:.5f} ms, queued "
          f"{results['K1']['device_ms_main']:.5f} ms, bound {results['K1']['bound_ms_main']:.5f} ms")

    # ---- 6. TDVP objective: K4, K5 on quench-like inputs at 65,536 ----
    rng = np.random.default_rng(6)
    A6 = left_canonical(rng, TDVP_BATCH)
    # contiguous: the timed raw launches below read the tensors' memory as is
    B6 = torch.from_numpy(near_isometry(rng, A6, 0.05)).to(dev, c64).contiguous()
    A6 = torch.from_numpy(A6).to(dev, c64).contiguous()
    g6 = torch.from_numpy(rng.uniform(G1_MIN, G1_MAX, TDVP_BATCH)).to(dev)
    W6 = torch.linalg.matrix_exp(-1j * tfim_matrix(g6).to(c128) * (2 * DT)).to(c64).contiguous()
    eye4 = torch.eye(4, dtype=c64, device=dev)
    errs = [tdvp_check(tdf, "TDVP quench-like, batched W", A6, B6, W6, True),
            tdvp_check(tdf, "TDVP quench-like, shared W = I", A6, B6, eye4, True)]
    # bench.py:171-179: random normals scaled to Frobenius norm 2, W = I.
    # Random mixed transfer matrices can have a near-degenerate dominant
    # pair, where no float32 solve agrees with float64: reported only.
    raw = [rng.standard_normal((TDVP_BATCH, 2, 2, 2)) + 1j * rng.standard_normal((TDVP_BATCH, 2, 2, 2))
           for _ in range(2)]
    raw = [torch.from_numpy(x / np.linalg.norm(x.reshape(TDVP_BATCH, -1), axis=1)[:, None, None, None] * 2)
           .to(dev, c64) for x in raw]
    tdvp_check(tdf, "TDVP bench.py raw inputs, W = I", raw[0], raw[1], eye4, False)
    # kernel times: raw launches into preallocated outputs (K4 with the left
    # solve, as the main path runs it), then checked against the wrapper's
    lam6, v6, w6 = tdf._fwd_cuda(A6, B6, W6, TDVP_ITERS, True)
    ct6 = torch.ones(TDVP_BATCH, device=dev)
    bars6 = tdf._bwd_cuda(A6, B6, W6, lam6, v6, w6, ct6)
    lam_o, v_o, w_o = (torch.empty_like(t) for t in (lam6, v6, w6))
    bars_o = [torch.empty_like(t) for t in bars6]
    ms4 = cuda_ms(lambda: lib.qmps_tdvp_fwd(
        A6.data_ptr(), B6.data_ptr(), W6.data_ptr(), 16, lam_o.data_ptr(), v_o.data_ptr(),
        w_o.data_ptr(), TDVP_BATCH, TDVP_ITERS, 1, stream), 50)
    ms5 = cuda_ms(lambda: lib.qmps_tdvp_bwd(
        A6.data_ptr(), B6.data_ptr(), W6.data_ptr(), 16, v6.data_ptr(), w6.data_ptr(),
        lam6.data_ptr(), ct6.data_ptr(), *(t.data_ptr() for t in bars_o), TDVP_BATCH, stream), 50)
    require(torch.equal(lam_o, lam6) and torch.equal(v_o, v6) and torch.equal(w_o, w6)
            and all(torch.equal(a, b) for a, b in zip(bars_o, bars6)),
            "K4, K5 timed launches reproduce their outputs")
    # no single PyTorch call computes the TDVP objective or its adjoint
    results["K4"] = dict(batch=TDVP_BATCH, ms=ms4,
                         plain_ms=cuda_ms(lambda: tdf._fwd_plain(A6, B6, W6, TDVP_ITERS, True), 5),
                         library_ms=None)
    results["K5"] = dict(ms=ms5, plain_ms=cuda_ms(
        lambda: tdf._bwd_plain(A6, B6, W6, lam6, v6, w6, ct6), 5), library_ms=None)
    for k in ("K4", "K5"):
        results[k].update(zip(("bound_ms", "bound_by"),
                              bound(*kernel_work(k, TDVP_BATCH, w_bytes=128 * TDVP_BATCH))))
    print(f"TDVP kernel times ({TDVP_BATCH}, batched W): K4 {ms4:.5f} ms (plain "
          f"{results['K4']['plain_ms']:.4f} ms), K5 {ms5:.5f} ms (plain {results['K5']['plain_ms']:.4f} ms)")

    # ---- 7. main path, evolve: ground state, then the quench family ----
    t0 = time.perf_counter()
    gs = find_ground_state(tfim(G0), D=2, ansatz="full15", method="lbfgs", steps=GS_STEPS)
    t_gs = time.perf_counter() - t0
    require(gs.params.is_cuda and gs.params.dtype == torch.float32, "the ground state ran on the card")
    e_gs = float(energy_exact_env(shallow_full_state(gs.params.cpu().double()), tfim(G0).to_matrix()))
    err_gs = e_gs - float(tfim_gs_energy_f64(G0))
    print(f"ground state of tfim({G0}) ({GS_STEPS} L-BFGS steps, {t_gs:.3f} s): float64 readout "
          f"error {err_gs:.4g} (in (-1e-9, 5e-4)); device f32 energy {gs.energy:.8f}")
    require(-1e-9 < err_gs < 5e-4, "ground state against exact")

    g1_host = np.linspace(G1_MIN, G1_MAX, N_G1)

    def quench(n_steps):
        return batched_quench_sweep(
            G0, g1_host, t_max=n_steps * DT, n_steps=n_steps, inner_steps=INNER, lr=QUENCH_LR,
            params0=gs.params, engine="pallas", pallas_iters=TDVP_ITERS,
        )

    # warm-up, capturing the main path's first K4 inputs on the way
    captured = []
    fwd_cuda = tdf._fwd_cuda

    def capture(*args):
        if not captured:
            captured.extend(a.detach().clone() if isinstance(a, torch.Tensor) else a for a in args)
        return fwd_cuda(*args)

    tdf._fwd_cuda = capture
    quench(2)
    tdf._fwd_cuda = fwd_cuda
    torch.cuda.synchronize()
    As_q, Bs_q, Ws_q = captured[:3]
    require(As_q.shape == (N_G1, 2, 2, 2) and Ws_q.shape == (N_G1, 4, 4), "captured inputs' shapes")
    errs.append(tdvp_check(tdf, "TDVP main path's first inner step", As_q, Bs_q, Ws_q, True))
    # K4 at the quench's own batch (64: under 2% of the card's SMs), raw
    # launches as in phase 6, checked against the wrapper's output
    As_q, Bs_q, Ws_q = (t.contiguous() for t in (As_q, Bs_q, Ws_q))
    outs_q = tdf._fwd_cuda(As_q, Bs_q, Ws_q, TDVP_ITERS, True)
    lam_o, v_o, w_o = (torch.empty_like(t) for t in outs_q)
    def launch4q():
        lib.qmps_tdvp_fwd(As_q.data_ptr(), Bs_q.data_ptr(), Ws_q.data_ptr(), 16, lam_o.data_ptr(), v_o.data_ptr(),
                          w_o.data_ptr(), N_G1, TDVP_ITERS, 1, stream)

    ms4q = cuda_ms(launch4q, 200)
    require(all(torch.equal(x, y) for x, y in zip((lam_o, v_o, w_o), outs_q)),
            "K4 timed launches reproduce its output (the quench's batch)")
    results["K4"].update(
        batch_quench=N_G1, ms_quench=ms4q, device_ms_quench=cuda_ms(launch4q, 200, queued=True),
        plain_ms_quench=cuda_ms(lambda: tdf._fwd_plain(As_q, Bs_q, Ws_q, TDVP_ITERS, True), 5),
        bound_ms_quench=bound(*kernel_work("K4", N_G1, w_bytes=128 * N_G1))[0])
    print(f"K4 time on the quench's batch ({N_G1}, batched W, left vector): {ms4q:.5f} ms (plain "
          f"{results['K4']['plain_ms_quench']:.4f} ms); at {TDVP_BATCH}: {results['K4']['ms']:.5f} ms")
    # K5 on the same inputs and K4's outputs there (ct = 1), raw launches;
    # an empty kernel on K5's grid, launched the same way, is the floor
    lam_q, v_q, u_q = outs_q
    ct_q = torch.ones(N_G1, device=dev)
    bars_q = tdf._bwd_cuda(As_q, Bs_q, Ws_q, lam_q, v_q, u_q, ct_q)
    bars_qo = [torch.empty_like(t) for t in bars_q]

    def launch5q():
        lib.qmps_tdvp_bwd(As_q.data_ptr(), Bs_q.data_ptr(), Ws_q.data_ptr(), 16, v_q.data_ptr(), u_q.data_ptr(),
                          lam_q.data_ptr(), ct_q.data_ptr(), *(t.data_ptr() for t in bars_qo), N_G1, stream)

    ms5q = cuda_ms(launch5q, 200)
    require(all(torch.equal(x, y) for x, y in zip(bars_qo, bars_q)),
            "K5 timed launches reproduce its output (the quench's batch)")
    _lib.check(lib.qmps_empty(N_G1, stream), "empty")
    floor_ms = cuda_ms(lambda: lib.qmps_empty(N_G1, stream), 200)
    # the same, queued behind a spin kernel: the card's own time a launch
    dev5q = cuda_ms(launch5q, 200, queued=True)
    dev_floor_ms = cuda_ms(lambda: lib.qmps_empty(N_G1, stream), 200, queued=True)
    results["K5"].update(
        batch_quench=N_G1, ms_quench=ms5q, launch_floor_ms=floor_ms, device_ms_quench=dev5q,
        device_launch_floor_ms=dev_floor_ms,
        plain_ms_quench=cuda_ms(lambda: tdf._bwd_plain(As_q, Bs_q, Ws_q, lam_q, v_q, u_q, ct_q), 5),
        bound_ms_quench=bound(*kernel_work("K5", N_G1, w_bytes=128 * N_G1))[0])
    print(f"K5 time on the quench's batch ({N_G1}, batched W): {ms5q:.5f} ms (plain "
          f"{results['K5']['plain_ms_quench']:.4f} ms, bound {results['K5']['bound_ms_quench']:.3g} ms); "
          f"an empty kernel launched the same way {floor_ms:.5f} ms; queued behind a spin kernel (the card's "
          f"time): K4 {results['K4']['device_ms_quench']:.5f}, K5 {dev5q:.5f}, empty {dev_floor_ms:.5f} ms; "
          f"at {TDVP_BATCH}: K5 {results['K5']['ms']:.5f} ms")
    results["K4"]["max_abs_err"] = max(e[0] for e in errs)
    results["K5"]["max_abs_err"] = max(e[1] for e in errs)

    _lib.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    times, les = quench(QUENCH_STEPS)
    torch.cuda.synchronize()
    t_q = time.perf_counter() - t0
    launches_q = dict(_lib.launches)
    n_inner = QUENCH_STEPS * INNER
    print(f"quench: {N_G1} trajectories x {QUENCH_STEPS} steps x {INNER} inner in {t_q:.4f} s, "
          f"{n_inner / t_q:.1f} inner steps/s, {N_G1 * QUENCH_STEPS / t_q:.1f} trajectory-steps/s "
          f"on {card}; launches {launches_q}")
    require(launches_q == counts(tdvp_fwd=n_inner, tdvp_bwd=n_inner), f"launch counts of the quench {launches_q}")
    require(les.is_cuda, "the quench ran on the card")
    les64 = les.double().cpu().numpy()
    t64 = np.arange(1, QUENCH_STEPS + 1) * (QUENCH_STEPS * DT / QUENCH_STEPS)
    require(les64.shape == (N_G1, QUENCH_STEPS) and np.all(np.isfinite(les64))
            and les64.min() > 0 and les64.max() <= 1 + 1e-5, "overlaps finite and in (0, 1]")
    require(np.abs(times.double().cpu().numpy() - t64).max() < 1e-6, "the quench's time grid")
    exact = np.stack([loschmidt_rate(t64, G0, g1) for g1 in g1_host])
    rate_err = np.abs(-np.log(les64) - exact)
    print(f"quench vs exact Loschmidt rate: max |error| {rate_err.max():.4g} (< 0.02), at t = {t64[-1]:.2f} "
          f"max {rate_err[:, -1].max():.4g}; overlaps in [{les64.min():.6f}, {les64.max():.6f}]")
    require(rate_err.max() < 0.02, "quench against the exact rate")

    # ---- 8. brickwork overlap: K6 at 65,536 ----
    h15 = tfim(BW_G0).to_matrix()
    W_bw = bwt.quench_window_gate(tfim(BW_G1).to_matrix(), 0.05)
    t0 = time.perf_counter()
    bw_gs = bwt.optimize_brickwork(h15, 400)
    t_bw_gs = time.perf_counter() - t0
    print(f"brickwork ground state of tfim({BW_G0}) (400 L-BFGS steps, float32 on the card): "
          f"windowed energy {bw_gs.fun:.6f} in {t_bw_gs:.3f} s")
    rng = np.random.default_rng(8)
    # bench.py:81-92's inputs are config 5's at 65,536 (the same seeded QR
    # unitaries, Ml = M^dag, one random 16x16 W); config 5's own are those
    # of phase 9's run
    sets = {"bench.py's random inputs": BrickworkConfig(batch=BW_BATCH).inputs(),
            "config 5's inputs": BrickworkConfig().inputs(),
            "brickwork TDVP inputs": tdvp_overlap_inputs(rng, bw_gs.x, W_bw, dev)}
    err6 = 0.0
    for tag, args in sets.items():
        n = args[0].shape[0]
        out = k6.manifold_overlap_pallas(*args)
        ref = manifold_overlap_batched(*(t.to(c128) for t in args))
        d = (out.to(c128) - ref).abs()
        print(f"K6 {tag} ({n}): max |d overlap| {d.max().item():.3g} (tol 1e-5 on every element), "
              f"elements over: {int((d > 1e-5).sum())}; |overlap| in [{ref.abs().min().item():.4f}, "
              f"{ref.abs().max().item():.4f}]")
        require(out.shape == (n,) and bool(torch.isfinite(out).all()) and d.max().item() <= 1e-5,
                f"K6 against its plain version ({tag})")
        err6 = max(err6, d.max().item())
    # kernel time: raw launches into a preallocated output on bench.py's
    # inputs, checked against the wrapper's output
    U1, U2, U1p, U2p, Mr, Ml, W = sets["bench.py's random inputs"]
    out_o = torch.empty(BW_BATCH, dtype=c64, device=dev)
    ms6 = cuda_ms(lambda: lib.qmps_brickwork_overlap(
        U1.data_ptr(), U2.data_ptr(), U1p.data_ptr(), U2p.data_ptr(), Ml.data_ptr(), Mr.data_ptr(),
        W.data_ptr(), out_o.data_ptr(), BW_BATCH, stream), 50)
    require(torch.equal(out_o, k6.manifold_overlap_pallas(U1, U2, U1p, U2p, Mr, Ml, W)),
            "K6 timed launches reproduce its output")
    args6 = (U1, U2, U1p, U2p, Mr, Ml, W)
    results["K6"] = dict(max_abs_err=err6, ms=ms6, plain_ms=cuda_ms(lambda: manifold_overlap_batched(*args6), 5),
                         library_ms=cuda_ms(lambda: overlap_einsum(*args6), 5))
    results["K6"].update(zip(("bound_ms", "bound_by"), bound(*kernel_work("K6", BW_BATCH, w_bytes=2048))))
    # the bound of the same work with W's product on the CUDA cores
    results["K6"]["bound_ms_cuda_cores"] = bound(k6_flops(False)[0] * BW_BATCH,
                                                 kernel_work("K6", BW_BATCH, w_bytes=2048)[1])[0]
    print(f"K6 times ({BW_BATCH}): kernel {ms6:.5f} ms, plain {results['K6']['plain_ms']:.4f} ms, "
          f"one torch.einsum {results['K6']['library_ms']:.4f} ms, bound {results['K6']['bound_ms']:.5f} ms "
          f"({results['K6']['bound_by']}; W's product on the tensor cores; on the CUDA cores "
          f"{results['K6']['bound_ms_cuda_cores']:.5f} ms)")
    # K6 at config 5's own batch (16,384) on its own inputs, the launches of
    # phase 9: raw, and queued behind a spin kernel (the card's time)
    U1, U2, U1p, U2p, Mr, Ml, W = sets["config 5's inputs"]
    n5 = U1.shape[0]
    out5 = torch.empty(n5, dtype=c64, device=dev)

    def launch6_cfg5():
        lib.qmps_brickwork_overlap(U1.data_ptr(), U2.data_ptr(), U1p.data_ptr(), U2p.data_ptr(), Ml.data_ptr(),
                                   Mr.data_ptr(), W.data_ptr(), out5.data_ptr(), n5, stream)

    results["K6"].update(batch_config5=n5, ms_config5=cuda_ms(launch6_cfg5, 200),
                         device_ms_config5=cuda_ms(launch6_cfg5, 200, queued=True),
                         bound_ms_config5=bound(*kernel_work("K6", n5, w_bytes=2048))[0],
                         library_ms_config5=cuda_ms(lambda: overlap_einsum(U1, U2, U1p, U2p, Mr, Ml, W), 5))
    require(torch.equal(out5, k6.manifold_overlap_pallas(U1, U2, U1p, U2p, Mr, Ml, W)),
            "K6 timed launches reproduce its output (config 5's batch)")
    print(f"K6 at config 5's batch ({n5}): raw {results['K6']['ms_config5']:.5f} ms, queued "
          f"{results['K6']['device_ms_config5']:.5f} ms, bound {results['K6']['bound_ms_config5']:.5f} ms, "
          f"one torch.einsum {results['K6']['library_ms_config5']:.4f} ms")

    def wrapper_steps():
        """Each step of K6's wrapper alone, on config 5's inputs (host us a call)."""
        args5 = (U1, U2, U1p, U2p, Mr, Ml, W)
        shapes = ((U1, (n5, 4, 4)), (U2, (n5, 4, 4)), (U1p, (n5, 4, 4)), (U2p, (n5, 4, 4)), (Mr, (n5, 2, 2)),
                  (Ml, (n5, 2, 2)), (W, (16, 16)))
        return host_steps({
            "checks (7 _lib.require)": lambda: [_lib.require(t, "t", c64, s) for t, s in shapes],
            "operands (7 is_conj, is_contiguous)": lambda: k6._overlap_operands(*args5),
            "torch.empty of the output": lambda: torch.empty(n5, dtype=c64, device=dev),
            "current device test": lambda: U1.device.index == torch.cuda.current_device(),
            "current stream query": lambda: _lib.raw_stream(U1.device.index),
            "ctypes call (the launch)": launch6_cfg5,
            "the workload's .abs()": lambda: out5.abs(),
            "the whole wrapper": lambda: k6.manifold_overlap_pallas(U1, U2, U1p, U2p, Mr, Ml, W),
            "the wrapper and .abs() (config 5's call)": lambda: k6.manifold_overlap_pallas(
                U1, U2, U1p, U2p, Mr, Ml, W).abs(),
        })

    steps6 = wrapper_steps()
    print("K6 wrapper, host us a call by step (config 5's inputs, 200 calls each): "
          + "; ".join(f"{k} {v:.2f}" for k, v in steps6.items()))
    # the wrapper alone launches K6 and nothing else: no copy kernel
    prof_w = device_breakdown(lambda: k6.manifold_overlap_pallas(U1, U2, U1p, U2p, Mr, Ml, W), 120)
    print(f"K6's wrapper under torch.profiler (120 calls): {prof_w[3]:.2f} device operations a call: "
          + "; ".join(f"{n[:50]} {t:.5f} ms" for n, t in prof_w[2]))
    require(prof_w[3] == 1 and "brickwork_overlap" in prof_w[2][0][0], "K6's wrapper launches K6 alone")
    cfg5_call = lambda: k6.manifold_overlap_pallas(U1, U2, U1p, U2p, Mr, Ml, W).abs()
    prof5 = device_breakdown(cfg5_call, 120, host_ops=14)
    print(f"config 5's call under torch.profiler (120 calls): host {prof5[0]:.4f} ms a call, device busy "
          f"{prof5[1]:.5f} ms a call, {prof5[3]:.2f} device operations a call: "
          + "; ".join(f"{n[:50]} {t:.5f} ms" for n, t in prof5[2]))

    # ---- 9. main path, config 5: the brickwork overlap throughput ----
    cfg5 = BrickworkConfig()
    _lib.reset_launches()
    m5 = cfg5.run()
    torch.cuda.synchronize()
    launches_5 = dict(_lib.launches)
    print(f"config 5 ({cfg5.batch} x {cfg5.iters}): flat form {m5['overlap_evals_per_sec']:.4g} evals/s, "
          f"fused K6 {m5['overlap_evals_per_sec_fused']:.4g} evals/s (the headline), flat vs fused "
          f"|d| {m5['max_abs_diff']:.3g} (< 1e-5) on {m5['device']}; launches {launches_5}")
    require(launches_5 == counts(brickwork_overlap=4 * cfg5.iters + 2), f"launch counts of config 5 {launches_5}")
    # the fused row's time a call (K6 and the .abs()) against the kernel's
    # queued time: the rest is the host's, the wrapper's and the launch's
    call5_ms = m5["seconds_fused"] * 1e3 / (4 * cfg5.iters)
    idle5 = None if prof5[1] is None else 1 - prof5[1] / call5_ms
    print(f"config 5 fused row: {call5_ms:.5f} ms a call of {cfg5.batch}, K6 queued "
          f"{results['K6']['device_ms_config5']:.5f} ms, difference {call5_ms - results['K6']['device_ms_config5']:.5f} "
          f"ms (the wrapper's host share); device idle share " + ("not measured" if idle5 is None else f"{idle5:.4f}"))

    # ---- 10. the brickwork family on the card (float32) ----
    _lib.reset_launches()
    fam = brickwork_family(bw_gs.x)
    launches_10 = dict(_lib.launches)
    print(f"brickwork family launches {launches_10}; the Loschmidt path with its ground state "
          f"{fam['loschmidt_seconds'] + t_bw_gs:.3f} s")
    # the brickwork algorithms reach no kernel (nor do the JAX package's)
    require(launches_10 == counts(), f"launch counts of the brickwork family {launches_10}")

    # ---- 11. K7, K8 against their plain versions ----
    t11 = time.perf_counter()
    rng = np.random.default_rng(11)
    big = {D: big_tdvp_inputs(rng, D, dev) for D in (4, 8)}  # phase 12's inputs too
    E_big = {}  # D -> (E, the path's 4,096 matrices; [E, E^dag], the 8,192 of earlier runs)
    for D, (A, B, W) in big.items():
        E = transfer_dense(*mixed_transfer_with_gate(A, B, W)).contiguous()
        E_big[D] = (E, torch.cat([E, E.mH]).resolve_conj().contiguous())
    tags = ("E", "[E, E^dag]")
    # N = 9 runs matpow_small_kernel (K7s below), N = 16 the tensor cores
    errs7_small, *errs7 = [matpow_check(tpp, "random", random_matrices(rng, N, 1001, dev)) for N in (9, 16)]
    errs7 += [matpow_check(tpp, f"D = 4 TDVP {t}", X) for t, X in zip(tags, E_big[4])]
    errs8 = [matpow_check(tpp, "random", random_matrices(rng, N, 1001, dev)) for N in (25, 64)]
    errs8 += [matpow_check(tpp, f"D = 8 TDVP {t}", X) for t, X in zip(tags, E_big[8])]
    tiles = {N: random_matrices(rng, N, n, dev) for N, n in TILE_SETS}
    errs8t = [matpow_check(tpp, "random, tiles", X) for X in tiles.values()]
    print(f"K8 on the tensor cores (3xTF32), largest errors against complex128: random N = 64 lam "
          f"{errs8[1][0]:.3g}, v {errs8[1][1]:.3g}; over N = 25, 64 and the D = 8 matrices lam "
          f"{max(e[0] for e in errs8):.3g}, v {max(e[1] for e in errs8):.3g}; K8's tiles over N = 81, 144, 256 "
          f"lam {max(e[0] for e in errs8t):.3g}, v {max(e[1] for e in errs8t):.3g}. The CUDA-core K8 of earlier "
          f"runs: lam 6.5e-7, v 1.3e-6 at random N = 64 (PERF.md)")
    hmma = sass_hmma(path)
    print("K7/K8 SASS (cuobjdump -sass): " + "; ".join(f"{n} {c} HMMA" for n, c in sorted(hmma.items())))
    # one kernel a padded size: 16 (K7), 32, 48, 64 (K8), and K8's tiles
    require(len(hmma) == 5 and min(hmma.values()) > 0, f"K7's and K8's kernels run on the tensor cores {hmma}")
    # kernel times on both inputs: raw launches into a preallocated output,
    # then checked against the wrapper's
    for D in (4, 8):
        k = BIG_DS[D][0]
        E, E2 = E_big[D]
        N = E.shape[-1]

        def launch(X, M_o):
            n = X.shape[0]
            if k == "K7":
                return lambda: lib.qmps_matpow_small(X.data_ptr(), M_o.data_ptr(), n, N, TDVP_ITERS, stream)
            return lambda: lib.qmps_matpow_large(X.data_ptr(), M_o.data_ptr(), None, n, N, TDVP_ITERS, stream)

        ms = {}
        for t, X in zip(tags, (E, E2)):
            M = tpp._matrix_power_cuda(X, TDVP_ITERS)
            M_o = torch.empty_like(M)
            ms[t] = cuda_ms(launch(X, M_o), 50 if k == "K7" else 10)
            require(torch.equal(M_o, M), f"{k} timed launches reproduce its output ({t})")
        results[k] = dict(batch=BIG_BATCH, max_abs_err=max(max(e) for e in (errs7 if k == "K7" else errs8)),
                          ms=ms["E"], ms_e_edag_8192=ms["[E, E^dag]"],
                          plain_ms=cuda_ms(lambda: tpp._matrix_power_plain(E, TDVP_ITERS), 5 if k == "K7" else 2),
                          library_ms=eig_library_ms(E))
        results[k].update(zip(("bound_ms", "bound_by"), bound(*kernel_work(k, BIG_BATCH))))
        results[k]["bound_ms_e_edag_8192"] = bound(*kernel_work(k, 2 * BIG_BATCH))[0]
        # the bound of the same work with the products on the CUDA cores
        results[k]["bound_ms_cuda_cores"] = bound(matpow_flops(N, TDVP_ITERS) * BIG_BATCH,
                                                  kernel_work(k, BIG_BATCH)[1])[0]
        print(f"{k} times ({N}x{N}, {TDVP_ITERS} squarings): kernel {ms['E']:.5f} ms on E ({BIG_BATCH}), "
              f"{ms['[E, E^dag]']:.5f} ms on [E, E^dag] ({2 * BIG_BATCH}); plain {results[k]['plain_ms']:.4f} ms, "
              f"torch.linalg.eig + pick {results[k]['library_ms']:.1f} ms, bound {results[k]['bound_ms']:.5f} ms "
              f"({results[k]['bound_by']}, the products on the tensor cores; on the CUDA cores "
              f"{results[k]['bound_ms_cuda_cores']:.5f} ms) on E")
    # K8's tiles (N > 64) on the 133 x 256 set through kernel_ab's launcher:
    # raw launches into a preallocated output and one workspace
    E256 = tiles[K8T_N]
    n256 = E256.shape[0]
    M256 = tpp._matrix_power_cuda(E256, TDVP_ITERS)
    work256 = torch.empty(tpp.matpow_work_floats(n256, K8T_N), dtype=torch.float32, device=dev)
    M256_o = torch.empty_like(E256)
    ms256 = cuda_ms(kernel_ab.matpow_large_launcher(lib, E256, M256_o, work256, TDVP_ITERS, stream), 3)
    require(torch.equal(M256_o, M256), "K8's tiles: timed launches reproduce the wrapper's output")
    results["K8t"] = dict(batch=n256, n=K8T_N, max_abs_err=max(max(e) for e in errs8t), ms=ms256,
                          plain_ms=cuda_ms(lambda: tpp._matrix_power_plain(E256, TDVP_ITERS), 2),
                          library_ms=eig_library_ms(E256))
    results["K8t"].update(zip(("bound_ms", "bound_by"), bound(*kernel_work("K8t", n256))))
    results["K8t"]["bound_ms_cuda_cores"] = bound(matpow_flops(K8T_N, TDVP_ITERS) * n256,
                                                  kernel_work("K8t", n256)[1])[0]
    r8t = results["K8t"]
    print(f"K8's tiles ({n256} x {K8T_N}x{K8T_N}, {TDVP_ITERS} squarings): {ms256:.4f} ms; plain bmm chain "
          f"{r8t['plain_ms']:.4f} ms, torch.linalg.eig + pick {r8t['library_ms']:.1f} ms; bound "
          f"{r8t['bound_ms']:.4f} ms ({r8t['bound_by']}, the products on the tensor cores; on the CUDA cores "
          f"{r8t['bound_ms_cuda_cores']:.4f} ms)")
    # K7 below kMatpowTcMinN (matpow_small_kernel, on the CUDA cores) on the
    # D = 3 objective's 4,096 E, drawn from a generator of its own (phase
    # 12's D = 3 inputs), with the random N = 9 set above
    big[3] = big_tdvp_inputs(np.random.default_rng(113), 3, dev)
    E3 = transfer_dense(*mixed_transfer_with_gate(*big[3])).contiguous()
    errs7s = [errs7_small, matpow_check(tpp, "D = 3 TDVP E (matpow_small_kernel)", E3)]
    M3 = tpp._matrix_power_cuda(E3, TDVP_ITERS)
    M3_o = torch.empty_like(M3)

    def launch_small():
        lib.qmps_matpow_small(E3.data_ptr(), M3_o.data_ptr(), BIG_BATCH, 9, TDVP_ITERS, stream)

    ms3, ms3_q = cuda_ms(launch_small, 50), cuda_ms(launch_small, 50, queued=True)
    require(torch.equal(M3_o, M3), "matpow_small_kernel: timed launches reproduce its output (D = 3)")
    results["K7s"] = dict(batch=BIG_BATCH, n=9, max_abs_err=max(max(e) for e in errs7s), ms=ms3, device_ms=ms3_q,
                          plain_ms=cuda_ms(lambda: tpp._matrix_power_plain(E3, TDVP_ITERS), 5),
                          library_ms=eig_library_ms(E3))
    results["K7s"].update(zip(("bound_ms", "bound_by"), bound(*kernel_work("K7s", BIG_BATCH))))
    # the bound of the same work with the products on the tensor cores
    tc3 = matpow_tc_flops(9, TDVP_ITERS)
    results["K7s"]["bound_ms_tensor_cores"] = bound(tc3[1] * BIG_BATCH, kernel_work("K7s", BIG_BATCH)[1],
                                                    tc3[0] * BIG_BATCH)[0]
    r7s = results["K7s"]
    print(f"matpow_small_kernel (K7 below kMatpowTcMinN) on the D = 3 objective's {BIG_BATCH} E (9x9, "
          f"{TDVP_ITERS} squarings): raw {ms3:.5f} ms, queued {ms3_q:.5f} ms; plain {r7s['plain_ms']:.4f} ms, "
          f"torch.linalg.eig + pick {r7s['library_ms']:.1f} ms; bound {r7s['bound_ms']:.5f} ms ({r7s['bound_by']}, "
          f"on the CUDA cores; {r7s['bound_ms'] / ms3_q:.1%} of it queued), {r7s['bound_ms_tensor_cores']:.5f} ms "
          f"with the products on the tensor cores")
    print(f"phase 11 in {time.perf_counter() - t11:.1f} s")

    # ---- 12. main path, the batched D >= 3 TDVP objective at 4,096 ----
    launches_12, big_rates, big_errs, big_idle = {}, {}, {}, {}
    big[16] = big_tdvp_inputs(np.random.default_rng(12), 16, dev, BIG_DS[16][2])
    for D, (k, name, n_pairs) in BIG_DS.items():
        A, B, W = big[D]

        def value_and_grad():
            Bg = B.clone().requires_grad_()
            val = tdvp_objective_pallas(A, Bg, W, TDVP_ITERS)
            n_fwd = dict(_lib.launches)
            val.sum().backward()
            return val.detach(), Bg.grad, n_fwd

        # the batch each K7/K8 launch is given: the matrices E, whose one
        # power gives both eigenvectors
        batches, power_cuda = [], tpp._matrix_power_cuda
        tpp._matrix_power_cuda = lambda X, iters: batches.append(X.shape[0]) or power_cuda(X, iters)
        _lib.reset_launches()
        val, grad, n_fwd = value_and_grad()
        torch.cuda.synchronize()
        tpp._matrix_power_cuda = power_cuda
        n_all = dict(_lib.launches)
        require(n_fwd == n_all == counts(**{name: 1}),
                f"D = {D}: one {k} launch a value and gradient, none in the backward ({n_fwd}, {n_all})")
        require(batches == [n_pairs], f"D = {D}: {k} launched on {batches} matrices, not {n_pairs}")
        B64 = B.to(c128).requires_grad_()
        ref = tdvp_objective(A.to(c128), B64, W.to(c128))  # the dense path, dominant_eigval_dense
        ref.sum().backward()
        err_val = (val.double() - ref.detach()).abs().max().item()
        d = (grad.to(c128) - B64.grad).abs().reshape(n_pairs, -1).max(1).values
        sc = B64.grad.abs().reshape(n_pairs, -1).max(1).values.clamp(min=1.0)
        err_grad = (d / sc).max().item()
        big_errs[D] = (err_val, err_grad)
        print(f"TDVP objective D = {D} ({n_pairs}, batched W, one {k} launch on {batches[0]} matrices): "
              f"|d value| {err_val:.3g} (tol 2e-5), "
              f"|d grad|/max(1,|grad|) {err_grad:.3g} (tol 2e-4), |grad| up to {sc.max().item():.4g}; "
              f"values in [{ref.min().item():.6f}, {ref.max().item():.6f}]")
        require(val.shape == (n_pairs,) and bool(torch.isfinite(val).all() and torch.isfinite(
            torch.view_as_real(grad)).all()), f"D = {D}: finite value and gradient of the expected shapes")
        require(err_val < 2e-5 and err_grad < 2e-4, f"D = {D} objective against the dense path")
        value_and_grad()  # warm-up
        torch.cuda.synchronize()
        _lib.reset_launches()
        t0 = time.perf_counter()
        for _ in range(BIG_CALLS):
            value_and_grad()
        torch.cuda.synchronize()
        dt12 = time.perf_counter() - t0
        n_timed = dict(_lib.launches)
        require(n_timed == counts(**{name: BIG_CALLS}), f"D = {D}: launches of the timed calls {n_timed}")
        launches_12[k] = n_all[name] + n_timed[name]
        big_rates[D] = BIG_CALLS * n_pairs / dt12
        call_ms = dt12 * 1e3 / BIG_CALLS
        print(f"TDVP objective D = {D}: {BIG_CALLS} value-and-gradient calls of {n_pairs} in {dt12:.4f} s "
              f"({call_ms:.4f} ms a call), {big_rates[D]:.4g} objectives/s on {card}")
        # device busy from the profiler, over the unprofiled time of a call
        host_ms, busy_ms, top, _ = device_breakdown(value_and_grad, 5)
        big_idle[D] = None if busy_ms is None else 1 - busy_ms / call_ms
        print(f"TDVP objective D = {D} under torch.profiler (5 calls): {host_ms:.4f} ms a call, device busy "
              + ("not measured (no kernel recorded)" if busy_ms is None else
                 f"{busy_ms:.4f} ms, idle share {big_idle[D]:.4f} of the unprofiled call; largest: "
                 + "; ".join(f"{n[:60]} {t:.4f} ms" for n, t in top)))
        if k == "K8t":  # K8's tiles at the path's own batch: raw launches into a preallocated output
            E16 = transfer_dense(*mixed_transfer_with_gate(A, B, W)).contiguous()
            M16 = tpp._matrix_power_cuda(E16, TDVP_ITERS)
            M16_o = torch.empty_like(M16)
            work16 = torch.empty(tpp.matpow_work_floats(n_pairs, K8T_N), dtype=torch.float32, device=dev)
            ms16 = cuda_ms(kernel_ab.matpow_large_launcher(lib, E16, M16_o, work16, TDVP_ITERS, stream), 3)
            require(torch.equal(M16_o, M16), "K8's tiles: timed launches reproduce the wrapper's output (D = 16)")
            results["K8t"].update(batch_main=n_pairs, ms_main=ms16, bound_ms_main=bound(*kernel_work("K8t", n_pairs))[0])
            print(f"K8's tiles on the D = 16 objective's {n_pairs} E: {ms16:.4f} ms, bound "
                  f"{results['K8t']['bound_ms_main']:.4f} ms")
            del E16, M16, M16_o, work16

    # ---- 13. main path, evolve: the single-trajectory pipeline (float32) ----
    t13 = time.perf_counter()
    evo, p_last = evolve_pipeline(dev)
    # where an inner step's time goes: one MPSTimeEvolve step of 50 inner
    # steps from the pipeline's last state, unprofiled, then profiled
    from qmps_torch.algorithms.evolve import MPSTimeEvolve

    probe = MPSTimeEvolve(tfim(ECHO_G1), ECHO_T / ECHO_STEPS, inner_steps=50)
    probe.step(p_last)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    probe.step(p_last)
    torch.cuda.synchronize()
    step50_ms = (time.perf_counter() - t0) * 1e3
    host13, busy13, top13, ops13 = device_breakdown(lambda: probe.step(p_last), 1, host_ops=12)
    evo["evolve_device_idle_share"] = None if busy13 is None else 1 - busy13 / step50_ms
    print(f"evolve inner steps under torch.profiler (one step of 50): {step50_ms / 50:.4f} ms an inner step "
          f"unprofiled, {host13 / 50:.4f} profiled; {ops13 / 50:.1f} device operations an inner step; device busy "
          + ("not measured (no kernel recorded)" if busy13 is None else
             f"{busy13 / 50:.4f} ms, idle share {evo['evolve_device_idle_share']:.4f}; largest: "
             + "; ".join(f"{n[:60]} {t / 50:.5f} ms" for n, t in top13)) + f" (on {card})")
    print(f"phase 13 in {time.perf_counter() - t13:.1f} s")

    # the float64 readouts' processes of phases 14 and 16, started while
    # the card runs phase 14's first sweep
    with host_pool() as pool:
        # ---- 14. the large-D path: the unroll's kernels, Krylov, the Stiefel sweeps, certificates ----
        t14 = time.perf_counter()
        unroll, launches_u = stiefel_unroll_kernels(dev, card)
        results.update(unroll)
        large = large_d_path(dev, card, pool)
        print(f"phase 14 in {time.perf_counter() - t14:.1f} s")

        # ---- 15. the classical uMPS path: VUMPS, MPO, trajectory, dispersion ----
        t15 = time.perf_counter()
        classical = classical_umps(dev, card)
        print(f"phase 15 in {time.perf_counter() - t15:.1f} s")

        # ---- 16. the chart sweeps, deep brickwork, the grown sweep ----
        t16 = time.perf_counter()
        charts = sweeps_and_deep_brickwork(dev, card, pool)
        print(f"phase 16 in {time.perf_counter() - t16:.1f} s")

    # ---- 17. the noisy and sampled NISQ path ----
    t17 = time.perf_counter()
    noisy = noise_and_sampling(dev, card)
    print(f"phase 17 in {time.perf_counter() - t17:.1f} s")

    # ---- 18. the scars Poincare ensembles ----
    t18 = time.perf_counter()
    scars = scars_path(dev, card)
    print(f"phase 18 in {time.perf_counter() - t18:.1f} s")

    # ---- 19. sharded sweeps: the config-4 sweep, the quench family, the Stiefel sweep ----
    t19 = time.perf_counter()
    with host_pool(SHARD_STF_WORKERS) as pool:  # (c)'s readout processes import while (a) runs
        sharded = sharded_sweeps(dev, card, g64, gs.params, pool)
    print(f"phase 19 in {time.perf_counter() - t19:.1f} s")

    names = {
        "K1": ("dominant_eig", "qmps_torch/csrc/pallas_power.cu", "qmps_tpu/kernels/pallas_power.py:168"),
        "K2": ("energy_fwd", "qmps_torch/csrc/energy_fused.cu", "qmps_tpu/kernels/energy_fused.py:271"),
        "K3": ("energy_bwd", "qmps_torch/csrc/energy_fused.cu", "qmps_tpu/kernels/energy_fused.py:303"),
        "K4": ("tdvp_fwd", "qmps_torch/csrc/tdvp_fused.cu", "qmps_tpu/kernels/tdvp_fused.py:121"),
        "K5": ("tdvp_bwd", "qmps_torch/csrc/tdvp_fused.cu", "qmps_tpu/kernels/tdvp_fused.py:247"),
        "K6": ("brickwork_overlap", "qmps_torch/csrc/brickwork_overlap.cu",
               "qmps_tpu/kernels/brickwork_pallas.py:34"),
        # K7 below kMatpowTcMinN: its launches are phase 12's D = 3 run's (the counter matpow_small)
        "K7s": ("matpow_small_kernel", "qmps_torch/csrc/matpow.cu", "qmps_tpu/kernels/pallas_power.py:245"),
        "K7": ("matpow_small", "qmps_torch/csrc/matpow.cu", "qmps_tpu/kernels/pallas_power.py:245"),
        "K8": ("matpow_large", "qmps_torch/csrc/matpow.cu", "qmps_tpu/kernels/pallas_power.py:332"),
        # K8 above N = 64: its launches are phase 12's D = 16 run's (the counter matpow_large)
        "K8t": ("matpow_tc_tiles", "qmps_torch/csrc/matpow.cu", "qmps_tpu/kernels/pallas_power.py:332"),
        # no TPU kernel: the JAX package runs the unroll through XLA; launches are phase 14's first part's
        "unroll_fwd": ("stiefel_unroll_fwd", "qmps_torch/csrc/stiefel_unroll.cu", "qmps_tpu/mps/transfer.py:378"),
        "unroll_bwd": ("stiefel_unroll_bwd", "qmps_torch/csrc/stiefel_unroll.cu", "qmps_tpu/mps/transfer.py:378"),
    }
    # each kernel's launches in the runs of its own main path (phase 5, 7, 9
    # or 12: the checked call and the timed ones)
    all_launches = {**launches, "tdvp_fwd": launches_q["tdvp_fwd"], "tdvp_bwd": launches_q["tdvp_bwd"],
                    "brickwork_overlap": launches_5["brickwork_overlap"], **launches_u}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches_12[k] if k in launches_12 else all_launches[name], **results[k]}
        for k, (name, src, rep) in names.items()
    ]
    print(json.dumps({"kernels": kernels, "sweep_seconds": dt, "points_per_second": N_POINTS / dt,
                      "median_error": float(np.median(err)), "max_error": float(err.max()),
                      "min_error": float(err.min()), "gs_energy_error": err_gs,
                      "quench_seconds": t_q, "inner_steps_per_second": n_inner / t_q,
                      "trajectory_steps_per_second": N_G1 * QUENCH_STEPS / t_q,
                      "quench_max_rate_error": float(rate_err.max()),
                      "overlap_evals_per_sec": m5["overlap_evals_per_sec"],
                      "overlap_evals_per_sec_fused": m5["overlap_evals_per_sec_fused"],
                      "config5_fused_call_ms": call5_ms, "config5_device_idle_share": idle5,
                      "config5_device_ops_per_call": prof5[3], "k6_wrapper_host_us": steps6,
                      **{f"brickwork_{k}": v for k, v in fam.items()},
                      **{f"tdvp_d{D}_objectives_per_second": r for D, r in big_rates.items()},
                      **{f"tdvp_d{D}_device_idle_share": r for D, r in big_idle.items()},
                      **{f"tdvp_d{D}_value_error": e[0] for D, e in big_errs.items()},
                      **{f"tdvp_d{D}_scaled_grad_error": e[1] for D, e in big_errs.items()}, **evo,
                      **large, **classical, **charts, **noisy, **scars, **sharded}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
