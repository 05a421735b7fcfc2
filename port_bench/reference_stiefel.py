"""The plain reference of the large-D phase-diagram sweep, in NumPy and
plain PyTorch.

Like ``reference``, it imports neither JAX, nor the JAX package, nor
anything of the program (``qmps_torch``), and takes nothing the program
made but the outputs it judges.

- ``mps_energy_f64_general``: the float64 energy per site of uniform MPS
  tensors of any bond dimension D under H = -sum ZZ + g sum X, no gauge
  assumed.
- ``stiefel_sweep_plain``: the heavy-ball Stiefel descent on the (2D, D)
  isometries with recycled environments, written from the algorithm, its
  products at a chosen precision ("f64", "f32" or "tf32", as
  ``reference.product`` has them).  The benchmark's control is this
  sweep at "tf32".

Wherever it runs at "f32" or "f64" it turns TF32 off in cuBLAS and cuDNN
(``_no_tf32``): on an H100 a float32 product may otherwise run in TF32.
"""
from __future__ import annotations

import numpy as np
import torch

from .reference import complex_type, product, tfim_two_site

#: normalised squarings of the transfer matrix in ``mps_energy_f64_general``:
#: its power 2^48 leaves a subdominant eigenvalue's share below 1e-16
#: wherever |lam_2 / lam_1| < 1 - 1e-13
SQUARINGS = 48
#: points read back at once on the card: 256 D = 16 transfer matrices of
#: complex128 are 256 MiB an array
READ_BLOCK = 256

def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ---------------------------------------------------------------------------
# the float64 readout of any D
# ---------------------------------------------------------------------------


def _mm(a, b, prec):
    return product("...ij,...jk->...ik", a, b, prec)


def _two_site_transfer(A: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(n, D^2, D^2) two-site transfer matrix with the weights w (n, 4, 4)
    between ket and bra: E_w[(i j), (k l)] = sum_ts w[t, s] AA_s[i, k]
    conj(AA_t[j, l]), AA_(s1 s2) = A_s1 A_s2.  Its action on a right
    environment r is sum_ts w[t, s] AA_s r AA_t^dag."""
    n, D = A.shape[0], A.shape[-1]
    AA = torch.einsum("bsik,btkj->bstij", A, A).reshape(n, 4, D, D)
    wAA = torch.einsum("bts,bsik->btik", w, AA)  # sum_s w[t, s] AA_s
    E = torch.einsum("btik,btjl->bijkl", wAA, AA.conj())
    return E.reshape(n, D * D, D * D)


def _transfer(A: torch.Tensor, prec: str = "f64") -> torch.Tensor:
    """(n, D^2, D^2) one-site transfer matrix T[(i j), (k l)] = sum_s A_s[i, k]
    conj(A_s[j, l]): T vec(x) = vec(sum_s A_s x A_s^dag)."""
    n, D = A.shape[0], A.shape[-1]
    return product("bsik,bsjl->bijkl", A, A.conj(), prec).reshape(n, D * D, D * D)


def _dominant_projector(T: torch.Tensor, squarings: int = SQUARINGS, prec: str = "f64") -> torch.Tensor:
    """lim (T / lam)^m up to a scale, by ``squarings`` squarings each
    normalised to unit Frobenius norm: the projector onto the dominant
    eigenspace along the others (rank 1 for an injective state, in which
    case it is r l^T / (l^T r) with the right and left fixed points)."""
    M = T / torch.linalg.matrix_norm(T)[:, None, None]
    for _ in range(squarings):
        M = _mm(M, M, prec)
        M = M / torch.linalg.matrix_norm(M)[:, None, None]
    return M


def mps_energy_f64_general(As, g, device="cpu") -> np.ndarray:
    """Energy per site, in float64, of the uniform MPS of each tensor
    A (n, 2, D, D) [physical s, left bond i, right bond j] under
    ``tfim_two_site(g)``, at complex128 on ``device``.  No gauge is
    assumed: with T the one-site transfer matrix (T(x) = sum_s A_s x
    A_s^dag) and P the projector onto its dominant eigenspace,
    e = tr(E_h P) / tr(E_1 P), E_h the two-site transfer matrix with h
    between ket and bra and E_1 = T^2 with the identity there; for an
    injective state P = r l^T / (l^T r) and this is sum_ts h_ts
    tr(l AA_s r AA_t^dag) / (lam^2 tr(l r)), as ``mps_energy_f64`` reads
    it at D = 2.  Returns (n,) NumPy."""
    _no_tf32()
    device = torch.device(device)
    A_all = torch.as_tensor(np.asarray(As)).to(device, torch.complex128)
    h_all = torch.as_tensor(tfim_two_site(np.asarray(g, np.float64))).to(device, torch.complex128)
    n, D = A_all.shape[0], A_all.shape[-1]
    eye = torch.eye(4, dtype=torch.complex128, device=device).expand(min(n, READ_BLOCK), 4, 4)
    out = []
    for i in range(0, n, READ_BLOCK):
        A, h = A_all[i:i + READ_BLOCK], h_all[i:i + READ_BLOCK]
        m = A.shape[0]
        P = _dominant_projector(_transfer(A))
        num = (_two_site_transfer(A, h) * P.mT).sum((-2, -1))
        den = (_two_site_transfer(A, eye[:m]) * P.mT).sum((-2, -1))
        out.append((num / den).real)
    return torch.cat(out).cpu().numpy()


# ---------------------------------------------------------------------------
# the plain large-D sweep (heavy-ball Stiefel descent, recycled environments)
# ---------------------------------------------------------------------------


def isometry_tensor(V: torch.Tensor, D: int) -> torch.Tensor:
    """(n, 2D, D) isometry -> MPS tensor (n, 2, D, D), A[s, i, j] = V[2 i + s, j]."""
    return V.reshape(-1, D, 2, D).transpose(1, 2)


def transfer_power(A: torch.Tensor, r: torch.Tensor, iters: int, prec: str) -> torch.Tensor:
    """``iters`` power matvecs r <- T(r) / |T(r)|_F, T(r) = sum_s A_s r A_s^dag."""
    for _ in range(iters):
        x = product("bsij,bjk->bsik", A, r, prec)
        r = product("bsik,bslk->bil", x, A.conj(), prec)
        r = r / torch.linalg.matrix_norm(r)[:, None, None]
    return r


def energy_warm(A: torch.Tensor, hs: torch.Tensor, r: torch.Tensor, prec: str) -> torch.Tensor:
    """Re sum_ts h_ts tr(AA_s r AA_t^dag) / tr(r) for each point."""
    n, D = A.shape[0], A.shape[-1]
    AA = product("bsik,btkj->bstij", A, A, prec).reshape(n, 4, D, D)
    X = product("bsij,bjk->bsik", AA, r, prec)
    Tr = product("bsik,btik->bts", X, AA.conj(), prec)  # [t, s] = tr(AA_s r AA_t^dag)
    trace = r.diagonal(dim1=-2, dim2=-1).sum(-1)
    return ((hs.to(Tr.dtype) * Tr).sum((-2, -1)) / trace).real


def dominant_projection(A: torch.Tensor, r: torch.Tensor, prec: str, squarings: int = 40) -> torch.Tensor:
    """r projected onto the dominant eigenspace of the transfer matrix T:
    T^(2^squarings) r, the power by normalised squarings, rotated to a real
    positive trace (the power's phase is lam_1^(2^squarings), rounding's
    phase of lam_1 blown up)."""
    n, D = A.shape[0], A.shape[-1]
    M = _dominant_projector(_transfer(A, prec), squarings, prec)
    x = product("bij,bj->bi", M, r.reshape(n, D * D), prec).reshape(n, D, D)
    t = x.diagonal(dim1=-2, dim2=-1).sum(-1)
    return x * (t.conj() / t.abs())[:, None, None]


def polar(W: torch.Tensor, prec: str) -> torch.Tensor:
    """W (W^dag W)^(-1/2), the exact polar factor of each (2D, D) W of full
    rank, by ``eigh`` of W^dag W.  The program uses a 10-iteration
    Newton-Schulz iteration with a 1e-6 (float32) or 1e-12 (float64)
    relative jitter instead: a departure of that size per retraction."""
    H = _mm(W.mH, W, prec)
    H = (H + H.mH) / 2
    w, U = torch.linalg.eigh(H)
    inv_sqrt = _mm(U * w.rsqrt().to(U.dtype)[:, None, :], U.mH, prec)
    return _mm(W, inv_sqrt, prec)


def _project(V: torch.Tensor, G: torch.Tensor, prec: str) -> torch.Tensor:
    """P_V(G) = G - V sym(V^dag G), the tangent projection at V."""
    VG = _mm(V.mH, G, prec)
    return G - _mm(V, (VG + VG.mH) / 2, prec)


def stiefel_sweep_plain(gs, xre, xim, D: int, steps: int, lr: float, momentum: float, restarts: int,
                        recycle_iters: int, final_iters: int, prec: str, device="cpu"):
    """The large-D phase-diagram sweep: each (point, restart) an isometry V
    (2D, D) from the QR of its start normals, read as A[s, i, j] =
    V[2 i + s, j]; its right environment r starts at I / sqrt(D).  A step:
    r refined by ``recycle_iters`` power matvecs from the last step's r
    (the energy differentiated by plain autograd through them), then
    M <- momentum M + P_V(G), V <- polar(V - lr M), M <- P_V(M), and the
    refined r carried to the next step.  After ``steps`` steps the carried
    r is projected onto the transfer matrix's dominant eigenspace
    (``dominant_projection``), the energy read after ``final_iters`` more
    matvecs, and each point keeps its best restart.

    ``gs`` (n,); ``xre``, ``xim`` (n restarts, 2D, D) float64 start normals
    (row p * restarts + k is point p's restart k).  Returns (energies
    (n,), As (n, 2, D, D)) as NumPy."""
    if prec in ("f32", "f64"):
        _no_tf32()
    ct = complex_type(prec)
    gs = np.asarray(gs, np.float64)
    hs = torch.as_tensor(np.repeat(tfim_two_site(gs), restarts, axis=0)).to(device, ct)
    V, _ = torch.linalg.qr(torch.complex(torch.as_tensor(xre), torch.as_tensor(xim)).to(device, ct))
    M = torch.zeros_like(V)
    r = (torch.eye(D, dtype=ct, device=device) / D ** 0.5).expand(V.shape[0], D, D)

    for _ in range(steps):
        Vg = V.detach().requires_grad_()
        A = isometry_tensor(Vg, D)
        r_new = transfer_power(A, r, recycle_iters, prec)
        (G,) = torch.autograd.grad(energy_warm(A, hs, r_new, prec).sum(), Vg)
        with torch.no_grad():
            M = momentum * M + _project(V, G, prec)
            V = polar(V - lr * M, prec)
            M = _project(V, M, prec)
        r = r_new.detach()
    with torch.no_grad():
        A = isometry_tensor(V, D)
        r = transfer_power(A, dominant_projection(A, r, prec), final_iters, prec)
        e = energy_warm(A, hs, r, prec).reshape(-1, restarts)
        best = torch.argmin(e, dim=1)
        rows = torch.arange(e.shape[0], device=V.device)
        As = A.reshape(-1, restarts, 2, D, D)[rows, best]
        return e[rows, best].double().cpu().numpy(), As.cpu().numpy()
