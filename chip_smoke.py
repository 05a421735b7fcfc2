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
  5. main path: the config-4 phase-diagram sweep (1024 values of g, 300
     steps, 4 restarts) on the card, then the represent step on the returned
     states; every returned tensor is read back in float64 against the exact
     TFIM energy, and the launch counters show that K1, K2 and K3 carried it.
Prints one JSON line of per-kernel results, the card line, and last
{"ok": true, "device": {...}}.
"""
import json
import subprocess
import sys
import time

import numpy as np
import torch

N_POINTS, STEPS, RESTARTS, LR, MOMENTUM = 1024, 300, 4, 0.1, 0.9
K1_BATCH, K1_ITERS = 65536, 40


def cuda_ms(fn, reps):
    """Mean time of fn over reps calls on the card's timeline, by CUDA
    events after one warm-up call (for a plain version made of many small
    launches this includes the gaps the host leaves between them)."""
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from qmps_torch.ham.classical_baselines import host_energy_d2
    from qmps_torch.ham.exact import tfim_gs_energy_f64
    from qmps_torch.kernels import _lib
    from qmps_torch.kernels import energy_fused as tef
    from qmps_torch.kernels.pallas_power import _dominant_eig_plain, dominant_eig_batched
    from qmps_torch.parallel.sweep import _fused_sweep_programs, sweep_ground_states_fused, tfim_matrix

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
    )
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

    # ---- 5. main path: config-4 sweep, then represent its states ----
    def main_path():
        """The sweep (timed) and the represent step on its states."""
        t0 = time.perf_counter()
        es, As = sweep_ground_states_fused(
            gs, steps=STEPS, lr=LR, momentum=MOMENTUM, restarts=RESTARTS
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
    require(launches == {"dominant_eig": 1, "energy_fwd": STEPS + 1, "energy_bwd": STEPS},
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
    require(np.all(np.isfinite(err)) and es.shape == (N_POINTS,) and As.shape == (N_POINTS, 2, 2, 2),
            "finite sweep output of the expected shapes")
    require(np.median(err) < 5e-4 and err.max() < 5e-3 and err.min() > -1e-9, "sweep against exact")
    require(unit < 1e-5, "represent step: |lam| = 1")

    names = {
        "K1": ("dominant_eig", "qmps_torch/csrc/pallas_power.cu", "qmps_tpu/kernels/pallas_power.py:168"),
        "K2": ("energy_fwd", "qmps_torch/csrc/energy_fused.cu", "qmps_tpu/kernels/energy_fused.py:271"),
        "K3": ("energy_bwd", "qmps_torch/csrc/energy_fused.cu", "qmps_tpu/kernels/energy_fused.py:303"),
    }
    kernels = [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], **results[k]}
        for k, (name, src, rep) in names.items()
    ]
    print(json.dumps({"kernels": kernels, "sweep_seconds": dt, "points_per_second": N_POINTS / dt,
                      "median_error": float(np.median(err)), "max_error": float(err.max()),
                      "min_error": float(err.min())}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
