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
     tensor cores) and 256 (K8's device-memory path), one zero matrix in
     each set, and the real D = 4 and D = 8 TDVP transfer matrices of phase
     12's 4,096 pairs, E (4,096, the path's input) and [E, E^dag] (8,192,
     the input of earlier runs); every element's lam (2e-5) and v up to
     phase (1e-4) against the plain version at complex128, both through the
     same _extract_eigpair; the HMMA (tensor-core) instructions of K7's
     and K8's kernels in the library's SASS (cuobjdump); kernel timed on
     both inputs, plain version and torch.linalg.eig on E (one call after
     one warm-up call), K7's bound with its products on the tensor cores
     and on the CUDA cores; K8's device-memory path timed at N = 256;
 12. main path, the batched D >= 3 TDVP objective: tdvp_objective_pallas
     and its Bs-gradient on 4,096 pairs at D = 4 (K7) and D = 8 (K8) with a
     per-pair gate, every element against the dense objective at
     complex128 on the card (values 2e-5, gradients 2e-4 times max(1, the
     element's largest |grad|)), one K7 or K8 launch a value and gradient,
     on the 4,096 matrices E (the left vector is read off the same power),
     and none in the backward, then 20 value-and-gradient calls timed.
Each kernel's entry in the JSON line has its bound: the larger of its
operations over the card's peak for their type and its bytes (each input
read once, each output written once) over 3.35 TB/s, the published H100
SXM peaks (``kernel_work``, ``bound``).  K1-K5's and K7-K8's operations
are those of their functions, every squaring of a complex matrix counted
in its three-product form (``csquare_flops``), K4 with one squaring chain
for both eigenvectors; K6's those of the cheapest pairwise contraction
order of its network (``cheapest_contraction``).  All run on the float32
CUDA cores (67 TFLOP/s) but K7's and K8's products and K6's W product,
which run on the tensor cores in 3xTF32: three TF32 products each, over
495 TFLOP/s.
Prints one JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}.
"""
import functools
import json
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
BIG_DS = {4: ("K7", "matpow_small"), 8: ("K8", "matpow_large")}  # D -> the kernel and its counter
# the brickwork family (tests/test_brickwork.py:109-129, 171-205)
BW_BATCH, BW_G0, BW_G1 = 65536, 1.5, 0.2

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
    tensor cores (``matpow_tc_flops``); K6 the cheapest contraction of its
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
        # the main path's N: D = 4 and D = 8 transfer matrices, read and
        # written once, their products on the tensor cores
        "K7": (matpow_tc_flops(16, TDVP_ITERS)[1], 2 * 8 * 16 ** 2),
        "K8": (matpow_tc_flops(64, TDVP_ITERS)[1], 2 * 8 * 64 ** 2),
    }[name]
    tc = {"K7": lambda: matpow_tc_flops(16, TDVP_ITERS)[0], "K8": lambda: matpow_tc_flops(64, TDVP_ITERS)[0],
          "K6": lambda: k6_flops()[1]}.get(name, lambda: 0)()
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


def big_tdvp_inputs(rng, D, dev):
    """BIG_BATCH quench-like TDVP pairs at bond dimension D, complex64 on the
    card: left-canonical A, B the nearest isometry to A + 0.03 noise
    (tests/test_pallas.py:143-161), W = expm(-i h(g1) 0.04) for g1 in
    [0.1, 0.4], one a pair."""
    from qmps_torch.parallel.sweep import tfim_matrix

    A = left_canonical(rng, BIG_BATCH, D)
    B = near_isometry(rng, A, 0.03)
    g1 = torch.from_numpy(rng.uniform(G1_MIN, G1_MAX, BIG_BATCH)).to(dev)
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
    (``matpow_tc_kernel``) in the library's SASS, by cuobjdump beside nvcc."""
    from qmps_torch.kernels import _lib

    cuobjdump = str(Path(_lib._nvcc()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(lib_path)], capture_output=True, text=True, check=True).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function : " in line:
            name = line.split("Function : ")[1].strip()
            if "matpow_tc_kernel" in name:
                counts[name] = 0
        elif name in counts and "HMMA" in line:
            counts[name] += 1
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
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
        # one call after a warm-up call: eig on CUDA tensors computes on the
        # host (~30 s a call)
        library_ms=cuda_ms(lambda: eig_dominant(E), 1),
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
    big = {D: big_tdvp_inputs(rng, D, dev) for D in BIG_DS}  # phase 12's inputs too
    E_big = {}  # D -> (E, the path's 4,096 matrices; [E, E^dag], the 8,192 of earlier runs)
    for D, (A, B, W) in big.items():
        E = transfer_dense(*mixed_transfer_with_gate(A, B, W)).contiguous()
        E_big[D] = (E, torch.cat([E, E.mH]).resolve_conj().contiguous())
    tags = ("E", "[E, E^dag]")
    errs7 = [matpow_check(tpp, "random", random_matrices(rng, N, 1001, dev)) for N in (9, 16)]
    errs7 += [matpow_check(tpp, f"D = 4 TDVP {t}", X) for t, X in zip(tags, E_big[4])]
    errs8 = [matpow_check(tpp, "random", random_matrices(rng, N, 1001, dev)) for N in (25, 64)]
    errs8 += [matpow_check(tpp, f"D = 8 TDVP {t}", X) for t, X in zip(tags, E_big[8])]
    tc = errs8[:]  # the tensor-core path's
    E256 = random_matrices(rng, 256, 133, dev)
    errs8.append(matpow_check(tpp, "random, device-memory path", E256))
    print(f"K8 on the tensor cores (3xTF32), largest errors against complex128: random N = 64 lam "
          f"{errs8[1][0]:.3g}, v {errs8[1][1]:.3g}; over N = 25, 64 and the D = 8 matrices lam "
          f"{max(e[0] for e in tc):.3g}, v {max(e[1] for e in tc):.3g}. The CUDA-core K8 of earlier runs: "
          f"lam 6.5e-7, v 1.3e-6 at random N = 64 (PERF.md)")
    hmma = sass_hmma(path)
    print("K7/K8 SASS (cuobjdump -sass): " + "; ".join(f"{n} {c} HMMA" for n, c in sorted(hmma.items())))
    # one kernel a padded size: 16 (K7), 32, 48, 64 (K8)
    require(len(hmma) == 4 and min(hmma.values()) > 0, f"K7's and K8's kernels run on the tensor cores {hmma}")
    # kernel times on both inputs: raw launches into a preallocated output,
    # then checked against the wrapper's
    for D, (k, _) in BIG_DS.items():
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
                          # one call after a warm-up call: eig on CUDA tensors computes on the host
                          library_ms=cuda_ms(lambda: eig_dominant(E), 1))
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
    # K8's device-memory path (matpow_global_kernel, N > 64) on the N = 256
    # set: raw launches into a preallocated output and workspace
    n256 = E256.shape[0]
    M256 = tpp._matrix_power_cuda(E256, TDVP_ITERS)
    M256_o, work256 = torch.empty_like(M256), torch.empty_like(E256)
    ms_g = cuda_ms(lambda: lib.qmps_matpow_large(E256.data_ptr(), M256_o.data_ptr(), work256.data_ptr(), n256, 256,
                                                 TDVP_ITERS, stream), 3)
    require(torch.equal(M256_o, M256), "K8's device-memory path: timed launches reproduce its output")
    results["K8"].update(batch_global_n256=n256, ms_global_n256=ms_g,
                         bound_ms_global_n256=bound(matpow_flops(256, TDVP_ITERS) * n256, 2 * 8 * 256 ** 2 * n256)[0])
    print(f"K8 device-memory path ({n256} x 256x256, {TDVP_ITERS} squarings): {ms_g:.4f} ms, bound "
          f"{results['K8']['bound_ms_global_n256']:.4f} ms (operations, float32 CUDA cores)")
    print(f"phase 11 in {time.perf_counter() - t11:.1f} s")

    # ---- 12. main path, the batched D >= 3 TDVP objective at 4,096 ----
    launches_12, big_rates, big_errs, big_idle = {}, {}, {}, {}
    for D, (k, name) in BIG_DS.items():
        A, B, W = big[D]

        def value_and_grad():
            Bg = B.clone().requires_grad_()
            val = tdvp_objective_pallas(A, Bg, W, TDVP_ITERS)
            n_fwd = dict(_lib.launches)
            val.sum().backward()
            return val.detach(), Bg.grad, n_fwd

        # the batch each K7/K8 launch is given: the 4,096 matrices E, whose
        # one power gives both eigenvectors
        batches, power_cuda = [], tpp._matrix_power_cuda
        tpp._matrix_power_cuda = lambda X, iters: batches.append(X.shape[0]) or power_cuda(X, iters)
        _lib.reset_launches()
        val, grad, n_fwd = value_and_grad()
        torch.cuda.synchronize()
        tpp._matrix_power_cuda = power_cuda
        n_all = dict(_lib.launches)
        require(n_fwd == n_all == counts(**{name: 1}),
                f"D = {D}: one {k} launch a value and gradient, none in the backward ({n_fwd}, {n_all})")
        require(batches == [BIG_BATCH], f"D = {D}: {k} launched on {batches} matrices, not {BIG_BATCH}")
        B64 = B.to(c128).requires_grad_()
        ref = tdvp_objective(A.to(c128), B64, W.to(c128))  # the dense path, dominant_eigval_dense
        ref.sum().backward()
        err_val = (val.double() - ref.detach()).abs().max().item()
        d = (grad.to(c128) - B64.grad).abs().reshape(BIG_BATCH, -1).max(1).values
        sc = B64.grad.abs().reshape(BIG_BATCH, -1).max(1).values.clamp(min=1.0)
        err_grad = (d / sc).max().item()
        big_errs[D] = (err_val, err_grad)
        print(f"TDVP objective D = {D} ({BIG_BATCH}, batched W, one {k} launch on {batches[0]} matrices): "
              f"|d value| {err_val:.3g} (tol 2e-5), "
              f"|d grad|/max(1,|grad|) {err_grad:.3g} (tol 2e-4), |grad| up to {sc.max().item():.4g}; "
              f"values in [{ref.min().item():.6f}, {ref.max().item():.6f}]")
        require(val.shape == (BIG_BATCH,) and bool(torch.isfinite(val).all() and torch.isfinite(
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
        launches_12[name] = n_all[name] + n_timed[name]
        big_rates[D] = BIG_CALLS * BIG_BATCH / dt12
        call_ms = dt12 * 1e3 / BIG_CALLS
        print(f"TDVP objective D = {D}: {BIG_CALLS} value-and-gradient calls of {BIG_BATCH} in {dt12:.4f} s "
              f"({call_ms:.4f} ms a call), {big_rates[D]:.4g} objectives/s on {card}")
        # device busy from the profiler, over the unprofiled time of a call
        host_ms, busy_ms, top, _ = device_breakdown(value_and_grad, 5)
        big_idle[D] = None if busy_ms is None else 1 - busy_ms / call_ms
        print(f"TDVP objective D = {D} under torch.profiler (5 calls): {host_ms:.4f} ms a call, device busy "
              + ("not measured (no kernel recorded)" if busy_ms is None else
                 f"{busy_ms:.4f} ms, idle share {big_idle[D]:.4f} of the unprofiled call; largest: "
                 + "; ".join(f"{n[:60]} {t:.4f} ms" for n, t in top)))

    names = {
        "K1": ("dominant_eig", "qmps_torch/csrc/pallas_power.cu", "qmps_tpu/kernels/pallas_power.py:168"),
        "K2": ("energy_fwd", "qmps_torch/csrc/energy_fused.cu", "qmps_tpu/kernels/energy_fused.py:271"),
        "K3": ("energy_bwd", "qmps_torch/csrc/energy_fused.cu", "qmps_tpu/kernels/energy_fused.py:303"),
        "K4": ("tdvp_fwd", "qmps_torch/csrc/tdvp_fused.cu", "qmps_tpu/kernels/tdvp_fused.py:121"),
        "K5": ("tdvp_bwd", "qmps_torch/csrc/tdvp_fused.cu", "qmps_tpu/kernels/tdvp_fused.py:247"),
        "K6": ("brickwork_overlap", "qmps_torch/csrc/brickwork_overlap.cu",
               "qmps_tpu/kernels/brickwork_pallas.py:34"),
        "K7": ("matpow_small", "qmps_torch/csrc/matpow.cu", "qmps_tpu/kernels/pallas_power.py:245"),
        "K8": ("matpow_large", "qmps_torch/csrc/matpow.cu", "qmps_tpu/kernels/pallas_power.py:332"),
    }
    # each kernel's launches in the runs of its own main path (phase 5, 7, 9
    # or 12: the checked call and the timed ones)
    all_launches = {**launches, "tdvp_fwd": launches_q["tdvp_fwd"], "tdvp_bwd": launches_q["tdvp_bwd"],
                    "brickwork_overlap": launches_5["brickwork_overlap"], **launches_12}
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": all_launches[name], **results[k]}
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
                      **{f"tdvp_d{D}_scaled_grad_error": e[1] for D, e in big_errs.items()}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
