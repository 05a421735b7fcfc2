"""Quasiparticle excitations on a uMPS ground state (counterpart of
``qmps_tpu.mps.excitations``; the tangent-space ansatz).

|Phi_p(B)> = sum_n e^{ipn} |... AL_{n-1} B_n AR_{n+1} ...> with B = V_L X
left-gauge-fixed (sum_s AL_s^dag B_s = 0), on top of a VUMPS-converged
(AL, AR, C).  The excitation energies at momentum p are the eigenvalues of
the hermitian effective Hamiltonian H_X = V_L^dag H_eff(V_L X) (Haegeman
et al.'s quasiparticle ansatz).

Diagram bookkeeping (bra disturbance fixed at site 0; every term is
projected by V_L^dag at the end, which kills each diagram whose bra left
index ties directly to an AL ket column):

  same site (n = 0): effective_H_AC(B), h-tilde on both touching bonds
      and the HL/HR geometric environments;
  ket right (n >= 1): RB = e^{ip} (1 - e^{ip} T)^{-1}(sum_s B_s AR_s^dag)
      with T(r) = sum_s AL_s r AR_s^dag (dominant pair deflated), used by
      X1 (h on bond (0,1), B at site 1), X2 (h on (0,1), B at n >= 2),
      X3 (h on (-1,0)) and X4 (h at bonds <= (-2,-1): HL . AL . RB);
  ket left (n <= -1): L1 = e^{-ip} G'(l_h1 + l_h2) + e^{-2ip} G'(v) with
      G' = (1 - e^{-ip} T')^{-1}, T'(l) = sum_s AR_s^T l conj(AL_s), used
      by T_E = L1 . AR; and X5 (B at -1 with h on bond (-1,0)).

Conventions: A[s, i, j] (left bond i); h[(s t), (u v)] with the bra row
index; h-tilde = h - e.  H_X is built for every basis vector X at once
(one batched contraction over the identity basis; the JAX package vmaps
a column), and ``null_space_VL``'s complete QR fixes the completion's
column phases as LAPACK or the card's solver does: H_X is a unitary
similarity of the JAX package's, with the same eigenvalues.  No gradient
flows through H_X's construction: the entry points run under
``torch.no_grad``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..config import resolve_device
from .tdvp import _as_h, _eye, _h_on, _pair, _two_site, effective_H_AC, hamiltonian_environments, mixed_gauge


def null_space_VL(AL: torch.Tensor) -> torch.Tensor:
    """(d, D, (d-1) D) tensor V_L with sum_s AL_s^dag VL_s = 0 and
    orthonormal columns in the (s, i) row layout: the complete-QR
    completion of the left isometry."""
    d, D, _ = AL.shape
    Q, _ = torch.linalg.qr(AL.reshape(d * D, D), mode="complete")
    return Q[:, D:].reshape(d, D, (d - 1) * D)


def _transfer_mats(AL: torch.Tensor, AR: torch.Tensor):
    """Dense (D^2, D^2) mixed transfers T (right-moving) and T'
    (left-moving), row-major vec: vec(A r B^T) = (A (x) B) vec(r)."""
    return _kron_sum(AL, AR.conj()), _kron_sum(AR.transpose(-2, -1), AL.mH)


def _kron_sum(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """sum_s kron(A_s, B_s) for (d, D, D) stacks: a (D^2, D^2) matrix."""
    D = A.shape[-1]
    return torch.einsum("sik,sjl->ijkl", A, B).reshape(D * D, D * D)


def _deflated_solve(M, v_dom, phase, rhs, w_dom=None):
    """(1 - phase M_deflated)^{-1} rhs for rows rhs (..., n), with the
    dominant direction (right vector v_dom, left vector w_dom, by default
    v_dom) projected out of the operator and the right-hand side: the
    physical seeds are orthogonal to the dominant pair, and the projection
    removes the p -> 0 singular direction without changing them.  One
    factorization serves every row."""
    n = M.shape[-1]
    eye = _eye(n, M)
    if v_dom is None:  # no unit eigenvalue to remove (|spec(M)| < 1)
        A, b = eye - phase * M, rhs
    else:
        w = v_dom if w_dom is None else w_dom
        P = torch.outer(v_dom, w.conj()) / (w.conj() @ v_dom)
        A = eye - phase * (M - P)
        b = rhs - rhs @ P.mT
    return torch.linalg.solve(A, b.reshape(-1, n).mT).mT.reshape(rhs.shape)


def excitation_matrix(AL, AR, C, h, p: float, symmetrize: bool = True, deflate: bool = True) -> torch.Tensor:
    """Dense hermitian H_X at momentum p: ((d-1) D^2, (d-1) D^2).

    Eigenvalues are the excitation energies omega(p) above the ground
    state (h's extensive part is subtracted through the energy density).
    symmetrize=False returns the raw diagram sum, hermitian only up to the
    ground state's convergence: what the hermiticity test asserts.

    Topological (domain-wall) sector: pass AR from a different degenerate
    ground state (the global X flip of AL's state in the ordered TFIM
    phase) and deflate=False: the mixed transfer then has spectral radius
    < 1, and the dominant-pair projection would remove a physical
    component."""
    d, D, _ = AL.shape
    nX = (d - 1) * D * D
    ht = _as_h(h, AL)
    HL, HR, e = hamiltonian_environments(AL, AR, C, ht)
    ht = ht - e.to(ht.dtype) * _eye(ht.shape[-1], ht)

    VL = null_space_VL(AL)
    T, Tp = _transfer_mats(AL, AR)
    vC = C.reshape(-1) if deflate else None
    vCt = C.mT.reshape(-1) if deflate else None
    ph = torch.exp(1j * torch.tensor(float(p), dtype=AL.real.dtype)).to(AL.device, AL.dtype)
    ARc, hAL2 = AR.conj(), _h_on(ht, _two_site(AL))
    AL2c = _two_site(AL).conj()
    HLAL = HL @ AL

    # every basis vector X at once: B (nX, d, D, D)
    B = torch.einsum("sia,naj->nsij", VL, _eye(nX, AL).reshape(nX, (d - 1) * D, D))

    # --- same site ---------------------------------------------------------
    out = effective_H_AC(B, AL, AR, HL, HR, ht)

    # --- ket disturbance right of the bra (n >= 1) ---------------------------
    rB = torch.einsum("nsij,skj->nik", B, ARc)
    RB = (ph * _deflated_solve(T, vC, ph, rB.reshape(nX, -1))).reshape(nX, 1, D, D)
    # X1: h on (0,1), B at site 1, right env I
    out = out + ph * torch.einsum("nuvib,vjb->nuij", _h_on(ht, _pair(AL, B)), ARc)
    # X2: h on (0,1), B at n >= 2, right env e^{ip} RB
    out = out + ph * torch.einsum("nuvic,vjc->nuij", hAL2 @ RB[:, None], ARc)
    # X3: h on (-1,0), right env RB
    out = out + torch.einsum("uai,nuvaj->nvij", AL.conj(), hAL2 @ RB[:, None])
    # X4: h at bonds <= (-2,-1): HL (bra, ket) . AL . RB
    out = out + HLAL @ RB

    # --- ket disturbance left of the bra (n <= -1), seeds [j_ket, j_bra] -----
    l_h1 = torch.einsum("nsbi,sbj->nij", HL @ B, AL.conj())
    l_h2 = torch.einsum("nuvai,uvaj->nij", _h_on(ht, _pair(AL, B)), AL2c)
    hBAR = _h_on(ht, _pair(B, AR))
    v_seed = torch.einsum("nuvai,uvaj->nij", hBAR, AL2c)
    L1 = _deflated_solve(Tp, vCt, 1.0 / ph,
                         ((1.0 / ph) * (l_h1 + l_h2) + (1.0 / ph ** 2) * v_seed).reshape(nX, -1))
    out = out + L1.reshape(nX, 1, D, D).mT @ AR
    # X5: B at -1, h on (-1,0), left env I, phase e^{-ip}
    out = out + (1.0 / ph) * torch.einsum("uai,nuvaj->nvij", AL.conj(), hBAR)

    HX = torch.einsum("sia,nsij->naj", VL.conj(), out).reshape(nX, nX).mT
    return (HX + HX.mH) / 2 if symmetrize else HX


def excitation_overlaps(AL, AR, C, O, p: float) -> torch.Tensor:
    """o_X[a] = <Phi_p(V_L X_a)| O_p |GS> over the X basis: the
    one-particle matrix elements of O_p = sum_n e^{ipn} O_n (O one-site,
    its expectation subtracted).  With the ket center AC at the bra's
    site, every O right of it dies by the bra's left gauge: the on-site
    term plus one deflated geometric sum over the left AL/AL* transfer."""
    d, D, _ = AL.shape
    O = torch.as_tensor(O).to(AL.device, AL.dtype)
    r = C @ C.mH
    eO = torch.einsum("st,tij,jk,sik->", O, AL, r, AL.conj())
    Ot = O - eO * _eye(d, AL)
    AC = AL @ C
    ph = torch.exp(1j * torch.tensor(float(p), dtype=AL.real.dtype)).to(AL.device, AL.dtype)

    o = torch.einsum("st,tij->sij", Ot, AC)  # O at the bra's site
    # O strictly left: seed l_O [bra, ket] through the AL/AL* column
    # (dominant pair: right vec(I), left vec(r))
    l_O = torch.einsum("st,sca,tcb->ab", Ot, AL.conj(), AL)
    M_LL = _kron_sum(AL.mH, AL.transpose(-2, -1))
    L = _deflated_solve(M_LL, _eye(D, AL).reshape(-1), 1.0 / ph, l_O.reshape(-1),
                        w_dom=r.reshape(-1)).reshape(D, D)
    o = o + (1.0 / ph) * (L @ AC)
    return torch.einsum("sia,sij->aj", null_space_VL(AL).conj(), o).reshape(-1)


def _host_c128(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().resolve_conj().numpy().astype(np.complex128)


@torch.no_grad()
def spectral_weights(AL, AR, C, h, O, p: float, n_levels: int = 4):
    """(omegas, weights): the lowest one-particle energies at momentum p
    and their spectral weights |<Phi_p(i)| O_p |GS>|^2, the delta-peak
    strengths of the dynamical structure factor in the single-mode
    subspace (numpy; the eigensolve on the host in complex128)."""
    HX = _host_c128(excitation_matrix(AL, AR, C, h, p))
    oX = _host_c128(excitation_overlaps(AL, AR, C, O, p))
    evals, evecs = np.linalg.eigh(HX)
    w = np.abs(evecs.conj().T @ oX) ** 2
    return evals[:n_levels], w[:n_levels]


@torch.no_grad()
def dispersion(h, D: int, ps, n_levels: int = 1, iters: int = 250, k: int = 32, A0=None, gs=None,
               deflate: bool = True, generator: torch.Generator | None = None, device=None):
    """omega(p) for each momentum in ps: numpy (len(ps), n_levels).

    gs: a converged (AL, AR, C) triple; otherwise VUMPS runs first
    (``tdvp.vumps_ground_state`` with ``A0``, ``generator`` and
    ``device``).  H_X is built where the state lies, in its precision;
    its eigenvalues are taken on the host in complex128."""
    from .tdvp import vumps_ground_state

    if gs is None:
        AL, C, _, _ = vumps_ground_state(h, D, iters=iters, k=k, generator=generator, A0=A0, device=device)
        AL, AR, C = mixed_gauge(AL)
    else:
        AL, AR, C = gs
        resolve_device(device, AL)
    return np.asarray([np.linalg.eigvalsh(_host_c128(excitation_matrix(AL, AR, C, h, p, deflate=deflate)))
                       [:n_levels] for p in ps])


@torch.no_grad()
def domain_wall_dispersion(h, D: int, ps, n_levels: int = 1, iters: int = 250, k: int = 32, flip=None,
                           generator: torch.Generator | None = None, device=None):
    """Dispersion of topological (domain-wall, kink) excitations in a
    symmetry-broken phase: the ansatz interpolates two degenerate ground
    states, |Phi_p(B)> = sum_n e^{ipn} |.. AL1 B_n AR2 ..>, state 2 = the
    on-site ``flip`` unitary (default Pauli X, the Z2 flip of the ordered
    TFIM phase) applied to state 1.  An on-site unitary leaves the bond
    matrices alone, so C is shared; the mixed transfer has |spectrum| < 1
    and the geometric sums run undeflated.  In the ordered phase (g < 1)
    the kinks are the TFIM's fermions."""
    from .tdvp import vumps_ground_state

    AL, C, _, _ = vumps_ground_state(h, D, iters=iters, k=k, generator=generator, device=device)
    AL, AR, C = mixed_gauge(AL)
    flip = np.array([[0.0, 1.0], [1.0, 0.0]]) if flip is None else np.asarray(flip)
    AR2 = torch.einsum("st,tij->sij", torch.as_tensor(flip).to(AL.device, AL.dtype), AR)
    return dispersion(h, D, ps, n_levels=n_levels, gs=(AL, AR2, C), deflate=False)
