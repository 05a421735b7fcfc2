"""Host-side float64 re-evaluation of returned device states (counterpart
of ``qmps_tpu.utils.host_eval``; its numpy/scipy core, copied).

The accuracy columns report float64 energies of the same tensors the
float32 card runs return.  These helpers are the one implementation of
that readout: the phase rotation before hermitizing and the gauge-free
double fixed point are subtle enough that two drifting copies once
reported energies below the exact bound.

One difference from the JAX package, pinned in
tests/test_torch_host_eval.py: a non-finite ``f32_ref`` is no reference.
The JAX package compares the readout with it, the comparison fails, and a
valid float64 energy is thrown away as NaN.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def device_to_host_c128(X) -> np.ndarray:
    """A tensor on any device (or an array) -> host numpy complex128."""
    if isinstance(X, torch.Tensor):
        return X.detach().cpu().to(torch.complex128).resolve_conj().numpy()
    return np.asarray(X, np.complex128)


def host_energy_gauge_free(AL_dev, h64, f32_ref=None, max_dev: float = 1e-2) -> float:
    """Float64 gauge-free energy of a returned uMPS tensor, on the host.

    The masked adaptive power iteration with the guarded ARPACK tail of
    ``host_f64_sweep_energies`` (n = 1, identity warm starts, a deep
    budget).  Both fixed points enter, because a float32-rounded tensor is
    left-canonical only to ~1e-7: an identity left fixed point with a
    slightly non-canonical A reported energies below the exact bound.

    ``f32_ref``: the card's own float32 energy of the same state, where the
    caller has one.  The readout refines it by ~1e-5 and can never
    legitimately move it by ``max_dev``: on disagreement it restarts from a
    random PSD environment with a deeper budget, and returns NaN if that
    disagrees too rather than a confident wrong number (an identity start
    once landed on a wrong eigenvector of a near-degenerate transfer
    spectrum).  A non-finite ``f32_ref`` is treated as none."""
    A = device_to_host_c128(AL_dev)
    D = A.shape[-1]
    h64b = np.asarray(h64, np.float64)[None]
    r0 = np.broadcast_to(np.eye(D), (1, D, D)).copy().astype(complex)
    e64, _ = host_f64_energies(A[None], r0, h64b, power_iters=200, max_iters=5000)
    e = float(e64[0])
    if f32_ref is None or not math.isfinite(float(f32_ref)) or abs(e - float(f32_ref)) <= max_dev:
        return e
    rng = np.random.default_rng(0)
    m = rng.normal(size=(D, D)) + 1j * rng.normal(size=(D, D))
    r1 = (m @ m.conj().T)[None]
    r1 /= np.linalg.norm(r1)
    e64, _ = host_f64_energies(A[None], r1.astype(complex), h64b, power_iters=500, max_iters=20000)
    e = float(e64[0])
    return e if abs(e - float(f32_ref)) <= max_dev else float("nan")


def host_f64_sweep_energies(As_dev, rs_dev, hs64, power_iters: int = 40,
                            tol: float = 1e-11, max_iters: int = 200):
    """Batched f64 energies of a sweep's returned (As, rs) on the host.

    As (n, d, D, D) near-left-canonical tensors and rs (n, D, D) their
    converged environments (warm starts for the f64 power refinement);
    hs64 (n, d^2, d^2) the per-point two-site Hamiltonians.  The Rayleigh
    lam**2 division makes the readout gauge-free against the ~1e-7
    non-canonicality of f32-retracted isometries.

    The refinement is ADAPTIVE and MASKED with an ARPACK FALLBACK: after
    the initial ``power_iters`` it keeps power-iterating — only the
    points whose residual |E(x) - lam x| is still above ``tol`` — up to
    ``max_iters``, then hands the surviving tail to per-point warm-
    started ARPACK ``eigs``.  Near-critical points have transfer gaps
    ~1e-2..1e-4 where a fixed 40 iterations left ~1e-4 environment error
    in the ENERGY readout (observed as min_error = -3e-4 at D=32:
    energies below the exact bound, which a variational state cannot
    produce) — and pure power iteration to 1e-11 at gap 1e-3 needs ~25k
    sweeps over hundreds of live points (measured: >40 min of host time
    at D=32); Krylov gets the same tail in ~dozens of matvecs per point.

    BOTH fixed points are converged: the LEFT one too (identity warm
    start), not assumed identity — the f32 polar retraction leaves the
    returned isometries non-canonical at ~sqrt(2D*D)*eps_f32, and the
    identity-left readout inherited that as a ~-5e-6 floor on min_error
    at D=16, drowning the exploitation signal this column exists to
    expose.  Returns (e64, lam): energies (n,) and the per-point
    transfer eigenvalues (deviation from 1 is the canonicality
    diagnostic the probes print as lam_dev)."""
    return host_f64_energies(
        device_to_host_c128(As_dev), device_to_host_c128(rs_dev), hs64,
        power_iters=power_iters, tol=tol, max_iters=max_iters,
    )


def host_f64_energies(A, r, hs64, power_iters: int = 40,
                      tol: float = 1e-11, max_iters: int = 200):
    """Host-array core of `host_f64_sweep_energies` (same contract, A and
    r already complex128 on the host)."""
    d, D = A.shape[1], A.shape[-1]

    def refine(A, x, spec, warm_iters):
        """Masked adaptive power iteration of the transfer action given
        by einsum ``spec`` over operands (A, x, A.conj()) — right action
        "bsik,bkl,bsjl->bij", left action "bslj,bkl,bski->bij" —
        hermitized + normalized each step."""

        def step(A, x, k):
            for _ in range(k):
                x = np.einsum(spec, A, x, A.conj(), optimize=True)
                x = (x + np.conj(np.swapaxes(x, 1, 2))) / 2
                x /= np.linalg.norm(x, axis=(1, 2))[:, None, None]
            return x

        def resid_of(A, x):
            Ex = np.einsum(spec, A, x, A.conj(), optimize=True)
            lam_est = np.einsum("bij,bij->b", np.conj(x), Ex).real
            return np.linalg.norm(Ex - lam_est[:, None, None] * x,
                                  axis=(1, 2))

        x = step(A, x, warm_iters)
        done, block = warm_iters, 20
        while done < max_iters:
            live = resid_of(A, x) >= tol
            if not live.any():
                return x
            x[live] = step(A[live], x[live], block)
            done += block
            block = min(2 * block, 2000)

        # Krylov fallback for the slow-gap tail
        live = np.nonzero(resid_of(A, x) >= tol)[0]
        if live.size:
            from scipy.sparse.linalg import ArpackNoConvergence
            from scipy.sparse.linalg import LinearOperator, eigs

            spec1 = spec.replace("b", "")
            Dl = A.shape[-1]
            for b in live:
                Ab = A[b]

                def mv(v):
                    return np.einsum(spec1, Ab, v.reshape(Dl, Dl),
                                     Ab.conj(), optimize=True).ravel()

                # tol 1e-13 not machine-eps, a widened subspace, and a
                # no-convergence guard: ARPACK at default tol threw on a
                # near-degenerate deep-brickwork D=64 transfer spectrum
                # (BENCH r5 baseline lost its row to this); a partial
                # result or the warm power iterate (residual < the
                # while-loop's exit state, hermitized/normalized already)
                # is strictly better than losing the readout
                op = LinearOperator((Dl * Dl,) * 2, matvec=mv,
                                    dtype=complex)
                try:
                    _, vecs = eigs(op, k=1, which="LM", v0=x[b].ravel(),
                                   tol=1e-13, ncv=min(Dl * Dl, 48))
                except ArpackNoConvergence as exc:
                    vecs = (exc.eigenvectors
                            if getattr(exc, "eigenvectors", None) is not None
                            and exc.eigenvectors.size else None)
                if vecs is None:
                    continue  # keep the power iterate
                m = vecs[:, 0].reshape(Dl, Dl)
                tr = np.trace(m)
                if abs(tr) > 1e-30:  # phase-rotate BEFORE hermitizing
                    m = m * (np.conj(tr) / abs(tr))
                m = (m + m.conj().T) / 2
                x[b] = m / np.linalg.norm(m)
        return x

    r = refine(A, r, "bsik,bkl,bsjl->bij", power_iters)
    l0 = np.broadcast_to(np.eye(D), (A.shape[0], D, D)).copy().astype(complex)
    # near-left-canonical tensors: identity is an excellent warm start
    l = refine(A, l0, "bslj,bkl,bski->bij", max(8, power_iters // 4))
    lam = np.einsum(
        "bsik,bkl,bsjl,bij->b", A, r, A.conj(), np.conj(r), optimize=True
    ).real / np.einsum("bij,bij->b", r, np.conj(r)).real
    rt = r / np.trace(r, axis1=1, axis2=2)[:, None, None]
    A2 = np.einsum("bsij,btjk->bstik", A, A).reshape(-1, d * d, D, D)
    num = np.einsum(
        "bts,bai,bsij,bjk,btak->b", np.asarray(hs64), l, A2, rt, A2.conj(),
        optimize=True,
    ).real
    den = np.einsum("bai,bia->b", l, rt).real
    e64 = num / (den * lam ** 2)
    return e64, lam


def tfim_h64_batch(gvals) -> np.ndarray:
    """(n, 4, 4) f64 TFIM two-site matrices -ZZ + g/2 (XI + IX)."""
    gvals = np.asarray(gvals, np.float64)
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    Z = np.diag([1.0, -1.0])
    I2 = np.eye(2)
    return np.stack([
        -np.kron(Z, Z) + g / 2 * (np.kron(X, I2) + np.kron(I2, X))
        for g in gvals
    ])
