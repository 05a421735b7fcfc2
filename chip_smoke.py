#!/usr/bin/env python3
"""Smoke run of the qmps_torch port on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero, and nothing is caught):
  1. device: a CUDA card must be present; prints its name and power limit;
  2. build: compiles the CUDA kernels of qmps_torch/csrc with nvcc for
     sm_90a and prints ptxas's registers and spills per kernel;
  3. represent (K1): 65,536 transfer matrices of seeded left-canonical D = 2
     tensors; the kernel (complex64) against its plain PyTorch version at
     complex128 on the card;
  4. energy (K2, K3): the sweep's own first-step batch (1024 points x 4
     restarts); forward and adjoint kernels against the plain versions at
     complex128;
  5. main path, optimize: the config-4 phase-diagram sweep (1024 values of
     g, 300 steps, 4 restarts) on the card, then the represent step on the
     returned states; every returned tensor is read back in float64 against
     the exact TFIM energy, and the launch counters show that K1, K2 and K3
     carried it;
  6. TDVP objective (K4, K5): quench-like inputs at 65,536 (a batched and a
     shared gate), forward and adjoint kernels against the plain versions
     at complex128, gated; bench.py's raw random inputs, reported only;
  7. main path, evolve: the ground state of tfim(1.5) (300 L-BFGS steps),
     read back in float64 against the exact energy; the K4/K5 check of
     phase 6 on the quench's own first inner-step inputs; then the quench
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
     of the 13 operands timed at 65,536;
  9. main path, config 5: BrickworkConfig().run() (16,384 x 30), both rates,
     the launch counter showing that K6 carried the fused row;
 10. the brickwork family in float32 (``brickwork_family``, which
     tests/test_torch_brickwork.py also runs in float32 on the CPU): the
     Loschmidt pipeline from the ground state of phase 8 (12 steps of 120
     inner steps) against the exact rate, and the warm start (the "suN"
     ground state, compiled into bricks, evolved 12 steps of 200 inner
     steps) against the exact rate, each path timed.
Each kernel's entry in the JSON line has its bound: the larger of its
float32 operations over 67 TFLOP/s and its bytes (each input read once,
each output written once) over 3.35 TB/s, the published H100 SXM peaks
(``kernel_work``).  K1-K5's operations are those of their solves'
algorithms; K6's those of the cheapest pairwise contraction order of its
network (``cheapest_contraction``), fewer than the kernel does.
Prints one JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}.
"""
import functools
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_POINTS, STEPS, RESTARTS, LR, MOMENTUM = 1024, 300, 4, 0.1, 0.9
K1_BATCH, K1_ITERS = 65536, 40
# the quench family of docs/TUTORIAL.md:150 on the production time grid
# (dt 0.02, bench.py:545-556), cut to 30 of 300 outer steps (t_max 0.6)
G0, N_G1, G1_MIN, G1_MAX, DT, QUENCH_STEPS, INNER, QUENCH_LR = 1.5, 64, 0.1, 0.4, 0.02, 30, 80, 3e-2
GS_STEPS, TDVP_ITERS, TDVP_BATCH = 300, 48, 65536
# the brickwork family (tests/test_brickwork.py:109-129, 171-205)
BW_BATCH, BW_G0, BW_G1 = 65536, 1.5, 0.2

# published H100 SXM peaks (NVIDIA's data sheet): float32 outside the
# tensor cores, device memory
PEAK_F32, PEAK_BYTES = 67e12, 3.35e12
CMAC, CMUL = 8, 6  # real flops of a complex multiply-add (4 FMAs) and of a product


def solve_flops(iters):
    """planes.cuh::solve4 by squaring: per squaring a 4x4 complex product
    (64 multiply-adds) and the normalisation of its 16 entries (6 flops
    each); then three matvecs, the Rayleigh quotient and two norms."""
    return iters * (64 * CMAC + 16 * 6) + 52 * CMAC + 56


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


def kernel_work(name, B, w_bytes=0):
    """(flops, bytes) of one launch over B elements: a complex multiply-add
    is 8 flops, a product 6; each input byte read once and each output byte
    written once (``w_bytes``: a W read once per launch or per element).
    K1-K5 count their solves as written; K6 the cheapest contraction of its
    network (1,444 multiply-adds: Ml and Mr fold into the outer c2 and r2
    first, and W's 1,024 dominate), not the 2,240 multiply-adds and 384
    products of the kernel as written."""
    k6 = cheapest_contraction(K6_NETWORK)
    aa, e = 16 * (CMUL + CMAC), 64 * CMAC  # build_AA, build_E
    flops, nbytes = {
        "K1": (solve_flops(K1_ITERS), 128 + 8 + 32),
        "K2": (2 * aa + e + solve_flops(48) + 64 * CMAC + 124, 64 + 128 + 4 + 8 + 32),
        # before the series ~3,660, the series 24 x 80 multiply-adds, after it ~4,730
        "K3": (3656 + 24 * 80 * CMAC + 4732, 64 + 128 + 32 + 8 + 4 + 64 + 128),
        # the two AA builds, WAA, E, and the right and left solves
        "K4": (2 * aa + 2 * e + 2 * solve_flops(TDVP_ITERS), 64 + 64 + 8 + 32 + 32),
        # the two AA builds, WAA, P and C (96 multiply-adds each), Wbar and
        # Q (64 each), the two AA-build adjoints (64 each), the coefficient
        "K5": (2 * aa + e + 2 * 96 * CMAC + 4 * 64 * CMAC + 60,
               64 + 64 + 32 + 32 + 8 + 4 + 64 + 64 + 128),
        "K6": (CMAC * k6[0] + CMUL * k6[1], 128 + 128 + 32 + 32 + 32 + 32 + 8),
    }[name]
    return flops * B, nbytes * B + w_bytes


def bound(flops, nbytes):
    """(bound_ms, what sets it): the larger of operations over the float32
    peak and bytes over the memory rate."""
    t_ops, t_mem = flops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_mem else (t_mem, "bytes")


def cuda_ms(fn, reps, warm_up=True):
    """Mean time of fn over reps calls on the card's timeline, by CUDA
    events after one warm-up call (for a plain version made of many small
    launches this includes the gaps the host leaves between them)."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def require(ok, what):
    """Fail the run (not an assert: -O would strip it)."""
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def left_canonical(rng, B):
    """(B, 2, 2, 2) left-canonical tensors A[s, i, j] from numpy QR."""
    x = rng.standard_normal((B, 4, 2)) + 1j * rng.standard_normal((B, 4, 2))
    V, _ = np.linalg.qr(x)
    return V.reshape(B, 2, 2, 2).transpose(0, 2, 1, 3)


def transfer(A):
    """One-site transfer matrices E[(i j), (k l)] = sum_s A[s,i,k] conj(A[s,j,l])."""
    return torch.einsum("bsik,bsjl->bijkl", A, A.conj()).reshape(-1, 4, 4)


def phase_aligned(v, ref):
    ph = (v.conj() * ref).sum(-1)
    return v * (ph / ph.abs())[:, None]


def isometry_f64(A):
    """The nearest exact isometry, in float64, to each returned f32 tensor
    (n, 2, 2, 2): host_energy_d2 assumes left-canonical input, and f32
    leaves a ~1e-7 defect that would bias the readout by as much."""
    n = A.shape[0]
    V = A.transpose(0, 2, 1, 3).reshape(n, 4, 2)
    U, _, Wh = np.linalg.svd(V, full_matrices=False)
    return (U @ Wh).reshape(n, 2, 2, 2).transpose(0, 2, 1, 3)


def near_isometry(rng, A, eps):
    """The nearest left-canonical tensors, in float64, to A + eps * complex
    normal noise (n, 2, 2, 2): a TDVP candidate B close to its A."""
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
    from qmps_torch.kernels import tdvp_fused as tdf
    from qmps_torch.objectives.energy import energy_exact_env
    from qmps_torch.kernels.pallas_power import _dominant_eig_plain, dominant_eig_batched
    from qmps_torch.parallel.sweep import _fused_sweep_programs, sweep_ground_states_fused, tfim_matrix
    from qmps_torch.algorithms import brickwork_tdvp as bwt
    from qmps_torch.kernels import brickwork_pallas as k6
    from qmps_torch.kernels.brickwork_fast import manifold_overlap_batched
    from qmps_torch.workloads import BrickworkConfig

    dev = torch.device("cuda")
    c64, c128 = torch.complex64, torch.complex128

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

    # ---- 3. represent: K1 at 65,536 ----
    A1 = torch.from_numpy(left_canonical(np.random.default_rng(0), K1_BATCH)).to(dev, c64)
    E = transfer(A1).contiguous()
    lam, v = dominant_eig_batched(E, iters=K1_ITERS)
    lam_p, v_p = _dominant_eig_plain(E.to(c128), iters=K1_ITERS)
    err_lam = (lam.to(c128) - lam_p).abs().max().item()
    err_v = (phase_aligned(v.to(c128), v_p) - v_p).abs().max().item()
    err_unit = (lam.abs() - 1).abs().max().item()
    print(f"K1 ({K1_BATCH} x 4x4, iters {K1_ITERS}): |dlam| {err_lam:.3g} (tol 1e-5), "
          f"|dv| up to phase {err_v:.3g} (tol 1e-4), ||lam|-1| {err_unit:.3g} (tol 1e-5)")
    require(err_lam < 1e-5 and err_v < 1e-4 and err_unit < 1e-5, "K1 against its plain version")
    # kernel times: raw launches into preallocated outputs, so that the
    # wrapper's host work (~30 us) does not hide a shorter kernel; the
    # outputs are then checked against the wrapper's
    lib, stream = _lib.lib(), torch.cuda.current_stream().cuda_stream
    lam_o, v_o = torch.empty_like(lam), torch.empty_like(v)
    results["K1"] = dict(
        max_abs_err=max(err_lam, err_v),
        ms=cuda_ms(lambda: lib.qmps_dominant_eig(
            E.data_ptr(), lam_o.data_ptr(), v_o.data_ptr(), K1_BATCH, K1_ITERS, 0, stream), 50),
        plain_ms=cuda_ms(lambda: _dominant_eig_plain(E, iters=K1_ITERS), 5),
        # one call, not warmed: eig on CUDA tensors computes on the host (~30 s)
        library_ms=cuda_ms(lambda: eig_dominant(E), 1, warm_up=False),
    )
    results["K1"].update(zip(("bound_ms", "bound_by"), bound(*kernel_work("K1", K1_BATCH))))
    require(torch.equal(lam_o, lam) and torch.equal(v_o, v), "K1 timed launches reproduce its output")

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
    results["K3"] = dict(
        max_abs_err=err_A,
        ms=cuda_ms(lambda: lib.qmps_energy_bwd(
            A.data_ptr(), h.data_ptr(), v.data_ptr(), lam.data_ptr(), ct.data_ptr(),
            Abar_o.data_ptr(), hbar_o.data_ptr(), B, tef.SERIES_K, stream), 50),
        plain_ms=cuda_ms(lambda: tef._bwd_plain(A, h, lam, v, ct), 5),
    )
    require(torch.equal(e_o, e) and torch.equal(v_o, v) and torch.equal(Abar_o, Abar)
            and torch.equal(hbar_o, hbar), "K2, K3 timed launches reproduce their outputs")
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
    require(launches == {"dominant_eig": 1, "energy_fwd": STEPS + 1, "energy_bwd": STEPS,
                         "tdvp_fwd": 0, "tdvp_bwd": 0, "brickwork_overlap": 0},
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
    results["K4"] = dict(ms=ms4, plain_ms=cuda_ms(lambda: tdf._fwd_plain(A6, B6, W6, TDVP_ITERS, True), 5),
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
    require(launches_q == {"dominant_eig": 0, "energy_fwd": 0, "energy_bwd": 0,
                           "tdvp_fwd": n_inner, "tdvp_bwd": n_inner, "brickwork_overlap": 0},
            f"launch counts of the quench {launches_q}")
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
    c2, r2 = U2[:, :, 0].contiguous(), U2p[:, :, 0].conj().resolve_conj().contiguous()
    out_o = torch.empty(BW_BATCH, dtype=c64, device=dev)
    ms6 = cuda_ms(lambda: lib.qmps_brickwork_overlap(
        U1.data_ptr(), c2.data_ptr(), U1p.data_ptr(), r2.data_ptr(), Ml.data_ptr(), Mr.data_ptr(),
        W.data_ptr(), out_o.data_ptr(), BW_BATCH, stream), 50)
    require(torch.equal(out_o, k6.manifold_overlap_pallas(U1, U2, U1p, U2p, Mr, Ml, W)),
            "K6 timed launches reproduce its output")
    args6 = (U1, U2, U1p, U2p, Mr, Ml, W)
    results["K6"] = dict(max_abs_err=err6, ms=ms6, plain_ms=cuda_ms(lambda: manifold_overlap_batched(*args6), 5),
                         library_ms=cuda_ms(lambda: overlap_einsum(*args6), 5))
    results["K6"].update(zip(("bound_ms", "bound_by"), bound(*kernel_work("K6", BW_BATCH, w_bytes=2048))))
    print(f"K6 times ({BW_BATCH}): kernel {ms6:.5f} ms, plain {results['K6']['plain_ms']:.4f} ms, "
          f"one torch.einsum {results['K6']['library_ms']:.4f} ms, bound {results['K6']['bound_ms']:.5f} ms "
          f"({results['K6']['bound_by']})")

    # ---- 9. main path, config 5: the brickwork overlap throughput ----
    cfg5 = BrickworkConfig()
    _lib.reset_launches()
    m5 = cfg5.run()
    torch.cuda.synchronize()
    launches_5 = dict(_lib.launches)
    print(f"config 5 ({cfg5.batch} x {cfg5.iters}): flat form {m5['overlap_evals_per_sec']:.4g} evals/s, "
          f"fused K6 {m5['overlap_evals_per_sec_fused']:.4g} evals/s (the headline), flat vs fused "
          f"|d| {m5['max_abs_diff']:.3g} (< 1e-5) on {m5['device']}; launches {launches_5}")
    require(launches_5 == {"dominant_eig": 0, "energy_fwd": 0, "energy_bwd": 0, "tdvp_fwd": 0,
                           "tdvp_bwd": 0, "brickwork_overlap": 4 * cfg5.iters + 2},
            f"launch counts of config 5 {launches_5}")

    # ---- 10. the brickwork family on the card (float32) ----
    _lib.reset_launches()
    fam = brickwork_family(bw_gs.x)
    launches_10 = dict(_lib.launches)
    print(f"brickwork family launches {launches_10}; the Loschmidt path with its ground state "
          f"{fam['loschmidt_seconds'] + t_bw_gs:.3f} s")
    # the brickwork algorithms reach no kernel (nor do the JAX package's)
    require(not any(launches_10.values()), f"launch counts of the brickwork family {launches_10}")

    names = {
        "K1": ("dominant_eig", "qmps_torch/csrc/pallas_power.cu", "qmps_tpu/kernels/pallas_power.py:168"),
        "K2": ("energy_fwd", "qmps_torch/csrc/energy_fused.cu", "qmps_tpu/kernels/energy_fused.py:271"),
        "K3": ("energy_bwd", "qmps_torch/csrc/energy_fused.cu", "qmps_tpu/kernels/energy_fused.py:303"),
        "K4": ("tdvp_fwd", "qmps_torch/csrc/tdvp_fused.cu", "qmps_tpu/kernels/tdvp_fused.py:121"),
        "K5": ("tdvp_bwd", "qmps_torch/csrc/tdvp_fused.cu", "qmps_tpu/kernels/tdvp_fused.py:247"),
        "K6": ("brickwork_overlap", "qmps_torch/csrc/brickwork_overlap.cu",
               "qmps_tpu/kernels/brickwork_pallas.py:34"),
    }
    # each kernel's launches in the run of its own main path (phase 5, 7 or 9)
    all_launches = {**launches, "tdvp_fwd": launches_q["tdvp_fwd"], "tdvp_bwd": launches_q["tdvp_bwd"],
                    "brickwork_overlap": launches_5["brickwork_overlap"]}
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
                      **{f"brickwork_{k}": v for k, v in fam.items()}}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
