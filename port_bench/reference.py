"""The plain reference of the port's benchmark, in NumPy and plain PyTorch.

It imports neither JAX, nor the JAX package, nor anything of the program
(``qmps_torch``), and takes nothing the program made: it is handed the
benchmark's own inputs (couplings, seeds) and, to judge them, the
program's outputs.

- Exact oracles of the transverse-field Ising chain H = -sum ZZ + g sum X:
  the ground-state energy per site and the Loschmidt rate of a quench.
- Float64 readouts of what the program returns: the energy per site of
  any D = 2 uniform MPS tensor (left and right fixed points by ``eig``,
  no canonical form assumed) and the state of the 15-angle circuit
  ("full15").
- Plain re-implementations of the two timed paths, the D = 2 heavy-ball
  Riemannian sweep and the TDVP quench family, written from the
  algorithms they run (not from the program's code).  Their products run
  at a chosen precision: "f64" (complex128), "f32" (complex64) or "tf32"
  (complex64 with every product's operands rounded to TF32, accumulated
  in float32, forward and backward: what tensor cores do with TF32 on).
  The control of the benchmark's comparison is this reference at "tf32",
  the step below the float32-with-TF32-off that the configurations state.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

# ---------------------------------------------------------------------------
# exact oracles
# ---------------------------------------------------------------------------


@lru_cache(maxsize=None)
def _nodes(n: int, panels: int = 1):
    """Composite Gauss-Legendre nodes and weights on [0, pi]: ``panels``
    equal panels of ``n`` nodes each."""
    x, w = np.polynomial.legendre.leggauss(n)
    h = np.pi / panels
    left = h * np.arange(panels)[:, None]
    return (left + (x + 1) * (h / 2)).ravel(), np.tile(w * (h / 2), panels)


def tfim_energy_exact(g) -> np.ndarray:
    """Ground-state energy per site of H = -sum ZZ + g sum X (infinite
    chain): -(1/pi) int_0^pi sqrt(1 + g^2 - 2 g cos k) dk, float64."""
    k, w = _nodes(256)
    g = np.asarray(g, np.float64)[..., None]
    return -(np.sqrt(1.0 + g * g - 2.0 * g * np.cos(k)) * w).sum(-1) / np.pi


def loschmidt_rate_exact(t, g0: float, g1: float) -> np.ndarray:
    """Rate of the Loschmidt echo per site after a quench g0 -> g1 from the
    ground state of g0, lambda(t) = -(1/2 pi) int_0^pi ln(1 - sin^2(2 phi_k)
    sin^2(eps_k t)) dk, with eps_k = 2 sqrt((g1 - cos k)^2 + sin^2 k) the
    post-quench mode energy and phi_k the difference of the two Bogoliubov
    angles; float64, 64 panels of 64 Gauss-Legendre nodes."""
    k, w = _nodes(64, 64)
    theta0 = np.arctan2(np.sin(k), g0 - np.cos(k)) / 2
    theta1 = np.arctan2(np.sin(k), g1 - np.cos(k)) / 2
    eps = 2 * np.sqrt((g1 - np.cos(k)) ** 2 + np.sin(k) ** 2)
    t = np.asarray(t, np.float64)[..., None]
    arg = 1.0 - np.sin(2 * (theta0 - theta1)) ** 2 * np.sin(eps * t) ** 2
    return -(np.log(arg) * w).sum(-1) / (2 * np.pi)


def tfim_two_site(g) -> np.ndarray:
    """(..., 4, 4) two-site term -ZZ + g (XI + IX) / 2, float64: its sum over
    bonds is H, and its mean on a uniform state is the energy per site."""
    Z = np.diag([1.0, -1.0])
    X = np.array([[0.0, 1.0], [1.0, 0.0]])
    I = np.eye(2)
    g = np.asarray(g, np.float64)[..., None, None]
    return -np.kron(Z, Z) + g / 2 * (np.kron(X, I) + np.kron(I, X))


# ---------------------------------------------------------------------------
# float64 readouts of the program's outputs
# ---------------------------------------------------------------------------


def _dominant(T: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(lam (n,), x (n, D, D)) of the largest-modulus eigenpair of each
    superoperator matrix T (n, D^2, D^2), x scaled to unit trace."""
    w, v = np.linalg.eig(T)
    i = np.argmax(np.abs(w), axis=1)
    n = np.arange(T.shape[0])
    D = int(round(np.sqrt(T.shape[1])))
    x = v[n, :, i].reshape(-1, D, D)
    x = x / np.trace(x, axis1=1, axis2=2)[:, None, None]
    return w[n, i], (x + x.conj().transpose(0, 2, 1)) / 2


def mps_energy_f64(As, g) -> np.ndarray:
    """Energy per site, in float64, of the uniform MPS of each tensor
    A (n, 2, 2, 2) [physical s, left bond i, right bond j] under
    ``tfim_two_site(g)``.  No gauge is assumed: with T(x) = sum_s A_s x
    A_s^dag, its dominant eigenvalue lam, right fixed point r and left
    fixed point l,  e = sum_{ts} h_ts tr(l AA_s r AA_t^dag) / (lam^2
    tr(l r)),  AA_(s1 s2) = A_s1 A_s2."""
    A = np.asarray(As, np.complex128)
    h = tfim_two_site(g).astype(np.complex128)
    T = np.einsum("bsik,bsjl->bijkl", A, A.conj()).reshape(-1, 4, 4)
    lam, r = _dominant(T)
    _, l = _dominant(T.conj().transpose(0, 2, 1))
    AA = np.einsum("bsik,btkj->bstij", A, A).reshape(-1, 4, 2, 2)
    M = np.einsum("bij,bsjk,bkl->bsil", l, AA, r)  # l AA_s r
    val = np.einsum("bts,bsil,btil->b", h, M, AA.conj())
    norm = lam.real ** 2 * np.einsum("bij,bji->b", l, r).real
    return (val / norm).real


# ---------------------------------------------------------------------------
# precision of the plain implementations
# ---------------------------------------------------------------------------

_TYPES = {"f64": torch.complex128, "f32": torch.complex64, "tf32": torch.complex64}


def complex_type(prec: str) -> torch.dtype:
    return _TYPES[prec]


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """x (float32 or complex64) with each real component rounded to TF32's
    10-bit mantissa, to nearest with ties away from zero (cvt.rna.tf32)."""
    if x.is_complex():
        return torch.view_as_complex(tf32_round(torch.view_as_real(x.resolve_conj())))
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


class _Tf32Product(torch.autograd.Function):
    """A two-operand einsum with TF32 operands, forward and backward."""

    @staticmethod
    def forward(ctx, spec, a, b):
        ra, rb = tf32_round(a), tf32_round(b)
        ctx.spec = spec
        ctx.save_for_backward(ra, rb)
        return torch.einsum(spec, ra, rb)

    @staticmethod
    def backward(ctx, grad):
        ra, rb = ctx.saved_tensors
        with torch.enable_grad():
            a = ra.detach().requires_grad_(ctx.needs_input_grad[1])
            b = rb.detach().requires_grad_(ctx.needs_input_grad[2])
            out = torch.einsum(ctx.spec, a, b)
            wrt = [t for t in (a, b) if t.requires_grad]
            got = iter(torch.autograd.grad(out, wrt, tf32_round(grad)))
        return None, next(got) if a.requires_grad else None, next(got) if b.requires_grad else None


def product(spec: str, a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """einsum(spec, a, b) at precision ``prec``."""
    if prec == "tf32":
        return _Tf32Product.apply(spec, a, b)
    return torch.einsum(spec, a, b)


def _mm(a, b, prec):
    return product("...ij,...jk->...ik", a, b, prec)


def _dominant_power(E: torch.Tensor, iters: int, prec: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(lam (n,), v (n, N)): the dominant right eigenpair of each E (n, N, N)
    by ``iters`` normalised squarings, v = M x from a fixed start x, unit
    norm, lam its Rayleigh quotient.  Differentiable by the implicit
    function theorem, not through the squarings (whose backward doubles
    rounding errors at every squaring): (v, lam) solve F = (E v - lam v,
    v0^dag v - 1) = 0, and one Newton step from the detached solution,
    y = y0 - J^-1 F(y0; E), has the value y0 and the implicit derivative."""
    n, N = E.shape[0], E.shape[-1]
    with torch.no_grad():
        M = E / torch.linalg.matrix_norm(E)[:, None, None]
        for _ in range(iters):
            M = _mm(M, M, prec)
            M = M / torch.linalg.matrix_norm(M)[:, None, None]
        x = torch.ones(N, dtype=E.dtype, device=E.device) + 0.1 * torch.arange(N, device=E.device)
        v = product("bij,j->bi", M, x, prec)
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        lam = product("bi,bi->b", v.conj(), product("bij,bj->bi", E, v, prec), prec)
        J = torch.zeros((n, N + 1, N + 1), dtype=E.dtype, device=E.device)
        J[:, :N, :N] = E - lam[:, None, None] * torch.eye(N, dtype=E.dtype, device=E.device)
        J[:, :N, N] = -v
        J[:, N, :N] = v.conj()
    F = torch.cat([product("bij,bj->bi", E, v, prec) - lam[:, None] * v, torch.zeros_like(v[:, :1])], 1)
    y = torch.cat([v, lam[:, None]], 1) - torch.linalg.solve(J, F)
    return y[:, N], y[:, :N]


# ---------------------------------------------------------------------------
# the plain D = 2 sweep (heavy-ball Riemannian descent on the isometries)
# ---------------------------------------------------------------------------


def isometry_tensor(V: torch.Tensor) -> torch.Tensor:
    """(n, 4, 2) isometry, rows (i s) -> MPS tensor (n, 2, 2, 2), A[s, i, j] =
    V[2 i + s, j]."""
    return V.reshape(-1, 2, 2, 2).transpose(1, 2)


def energy_left_canonical(A: torch.Tensor, hs: torch.Tensor, iters: int, prec: str) -> torch.Tensor:
    """Energy per site of left-canonical A (n, 2, 2, 2) under hs (n, 4, 4):
    the two-site transfer matrix's right fixed point r by ``iters``
    squarings (its phase removed by the trace, then made hermitian),
    e = Re sum h_ts tr(AA_s r AA_t^dag)."""
    AA = product("bsik,btkj->bstij", A, A, prec).reshape(-1, 4, 2, 2)
    E = product("bsik,bsjl->bijkl", AA, AA.conj(), prec).reshape(-1, 4, 4)
    _, v = _dominant_power(E, iters, prec)
    r = v.reshape(-1, 2, 2)
    r = r / r.diagonal(dim1=-2, dim2=-1).sum(-1)[:, None, None]  # the phase first
    r = (r + r.mH) / 2
    T = product("bsij,bjk->bsik", AA, r, prec)
    T = product("bsik,btik->bts", T, AA.conj(), prec)
    return (hs.to(T.dtype) * T).sum((-1, -2)).real


def _polar(W: torch.Tensor, prec: str) -> torch.Tensor:
    """W (W^dag W)^(-1/2) for (n, 4, 2) W of full rank, in closed form: for
    a 2 x 2 positive H with s = sqrt(det H) and t = sqrt(tr H + 2 s),
    sqrt(H) = (H + s I) / t, so H^(-1/2) = adj(H + s I) / (s t)."""
    H = _mm(W.mH, W, prec)
    a, d, b = H[:, 0, 0].real, H[:, 1, 1].real, H[:, 0, 1]
    s = torch.sqrt((a * d - b.abs() ** 2).clamp_min(1e-30))
    t = torch.sqrt(a + d + 2 * s)
    adj = torch.stack([torch.stack([d + s, -b], -1), torch.stack([-b.conj(), a + s], -1)], -2)
    return _mm(W, adj / (s * t).to(adj.dtype)[:, None, None], prec)


def sweep_plain(gs, xre, xim, steps: int, lr: float, momentum: float, restarts: int, iters: int,
                prec: str, device="cpu"):
    """The D = 2 phase-diagram sweep: every (point, restart) an isometry V
    (4, 2) from the QR of its start normals; ``steps`` heavy-ball steps,
    M <- momentum M + P_V(G), V <- polar(V - lr M), M <- P_V(M), with G the
    energy's gradient and P_V the tangent projection; then the best
    restart of each point.  ``xre``, ``xim`` (n restarts, 4, 2) the start
    normals (row p * restarts + k is point p's restart k).  Returns
    (energies (n,), As (n, 2, 2, 2)) as NumPy."""
    ct = complex_type(prec)
    gs = np.asarray(gs, np.float64)
    hs = torch.as_tensor(np.repeat(tfim_two_site(gs), restarts, axis=0), device=device).to(ct)
    V, _ = torch.linalg.qr(torch.complex(torch.as_tensor(xre), torch.as_tensor(xim)).to(device, ct))
    M = torch.zeros_like(V)

    def proj(V, G):
        VG = _mm(V.mH, G, prec)
        return G - _mm(V, (VG + VG.mH) / 2, prec)

    for _ in range(steps):
        Vg = V.detach().requires_grad_()
        (G,) = torch.autograd.grad(energy_left_canonical(isometry_tensor(Vg), hs, iters, prec).sum(), Vg)
        with torch.no_grad():
            M = momentum * M + proj(V, G)
            V = _polar(V - lr * M, prec)
            M = proj(V, M)
    with torch.no_grad():
        e = energy_left_canonical(isometry_tensor(V), hs, iters, prec).reshape(-1, restarts)
        best = torch.argmin(e, dim=1)
        n = torch.arange(e.shape[0], device=V.device)
        As = isometry_tensor(V).reshape(-1, restarts, 2, 2, 2)[n, best]
        return e[n, best].cpu().numpy(), As.cpu().numpy()


# ---------------------------------------------------------------------------
# the plain quench family (TDVP on the 15-angle circuit state)
# ---------------------------------------------------------------------------

_PAULI = {"x": [[0, 1], [1, 0]], "y": [[0, -1j], [1j, 0]], "z": [[1, 0], [0, -1]]}
# the 15-angle SU(4) circuit on qubits (0, 1), qubit 0 the major bit of
# the state index: (axis, qubit) of each angle in order, "cx01" / "cx10"
# a CNOT with control qubit 0 / 1
_FULL15 = ["z0", "x0", "z0", "z1", "x1", "z1", "cx01", "y0", "cx10", "y0", "z1", "cx01",
           "z0", "x0", "z0", "z1", "x1", "z1"]


def full15_unitary(p: torch.Tensor, prec: str) -> torch.Tensor:
    """(..., 15) angles -> (..., 4, 4): the gates applied in turn, rotation
    R_a(t) = exp(-i t P_a / 2)."""
    ct = complex_type(prec)
    dev = p.device
    eye2 = torch.eye(2, dtype=ct, device=dev)
    cx = torch.tensor([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=ct, device=dev)
    swap = torch.tensor([[1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]], dtype=ct, device=dev)
    U = torch.eye(4, dtype=ct, device=dev).expand(p.shape[:-1] + (4, 4))
    k = 0
    for op in _FULL15:
        if op == "cx01":
            G = cx
        elif op == "cx10":
            G = swap @ cx @ swap
        else:
            t = p[..., k].to(ct)[..., None, None] / 2
            k += 1
            P = torch.tensor(_PAULI[op[0]], dtype=ct, device=dev)
            R = torch.cos(t) * eye2 - 1j * torch.sin(t) * P
            G = product("...ij,...kl->...ikjl", R, eye2.expand_as(R), prec) if op[1] == "0" else \
                product("...ij,...kl->...ikjl", eye2.expand_as(R), R, prec)
            G = G.reshape(R.shape[:-2] + (4, 4))
        U = _mm(G, U, prec)
    return U


def circuit_tensor(U: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) state unitary -> (..., 2, 2, 2) MPS tensor, its first
    input qubit at |0>: A[s, i, j] = U[2 i + s, j]."""
    return U[..., :, :2].reshape(U.shape[:-2] + (2, 2, 2)).transpose(-3, -2)


def full15_tensor_f64(params) -> np.ndarray:
    """The MPS tensors (n, 2, 2, 2) of the 15-angle circuit states of params
    (n, 15), in float64 as NumPy (``mps_energy_f64`` reads them)."""
    p = torch.as_tensor(np.asarray(params, np.float64))
    return circuit_tensor(full15_unitary(p, "f64")).numpy()


def _gate(g1s, dt: float, ct, device) -> torch.Tensor:
    """W = expm(-i h(g1) 2 dt) per coupling (n, 4, 4), in float64 first:
    the two-site gate advances the two-site cell by dt."""
    h = torch.as_tensor(tfim_two_site(np.asarray(g1s, np.float64)), dtype=torch.complex128)
    return torch.linalg.matrix_exp(-1j * h * (2 * dt)).to(device, ct)


def _overlap_objective(A, B, W, iters, prec):
    """-|lam| of E = sum_s (W AA)_s (x) conj(BB_s), the two-site mixed
    transfer matrix of the evolved state and the candidate B."""
    AA = product("bsik,btkj->bstij", A, A, prec).reshape(-1, 4, 2, 2)
    BB = product("bsik,btkj->bstij", B, B, prec).reshape(-1, 4, 2, 2)
    WAA = product("bst,btij->bsij", W, AA, prec)
    E = product("bsik,bsjl->bijkl", WAA, BB.conj(), prec).reshape(-1, 4, 4)
    lam, _ = _dominant_power(E, iters, prec)
    return -lam.abs()


def _overlap_density(A, A0, iters, prec):
    """|<psi_0|psi>|^2 per site: |lam|^2 of sum_s A_s (x) conj(A0_s)."""
    E = product("bsik,bsjl->bijkl", A, A0.conj(), prec).reshape(-1, 4, 4)
    lam, _ = _dominant_power(E, iters, prec)
    return lam.abs() ** 2


def quench_plain(params0, g1s, t_max: float, n_steps: int, inner_steps: int, lr: float, iters: int,
                 prec: str, device="cpu") -> np.ndarray:
    """The quench family from the circuit state ``params0`` (15,): per outer
    step of dt = t_max / n_steps, ``inner_steps`` adam steps (a fresh
    optimizer, rate ``lr``) of the summed -|overlap| of each trajectory's
    candidate with W|psi(t)>, then the overlap density with the initial
    state.  Returns (len(g1s), n_steps) as NumPy."""
    ct = complex_type(prec)
    rt = torch.float64 if prec == "f64" else torch.float32
    g1s = np.asarray(g1s, np.float64)
    n = g1s.shape[0]
    W = _gate(g1s, t_max / n_steps, ct, device)
    p0 = torch.as_tensor(np.asarray(params0, np.float64)).to(device, rt)
    with torch.no_grad():
        A0 = circuit_tensor(full15_unitary(p0, prec)).expand(n, 2, 2, 2)
    ps = p0.expand(n, 15).clone()
    out = []
    for _ in range(n_steps):
        with torch.no_grad():
            A = circuit_tensor(full15_unitary(ps, prec))
        q = ps.detach().clone().requires_grad_()
        opt = torch.optim.Adam([q], lr=lr)
        for _ in range(inner_steps):
            opt.zero_grad(set_to_none=True)
            _overlap_objective(A, circuit_tensor(full15_unitary(q, prec)), W, iters, prec).sum().backward()
            opt.step()
        ps = q.detach()
        with torch.no_grad():
            out.append(_overlap_density(circuit_tensor(full15_unitary(ps, prec)), A0, iters, prec))
    return torch.stack(out, 1).double().cpu().numpy()


def ground_state_plain(g0: float, x0, steps: int = 300) -> np.ndarray:
    """The 15 angles of the lowest-energy circuit state of tfim_two_site(g0),
    by L-BFGS in float64 on the CPU from ``x0`` (15,)."""
    h = torch.as_tensor(tfim_two_site(np.array([g0])), dtype=torch.complex128)
    x = torch.as_tensor(np.asarray(x0, np.float64)).clone().requires_grad_()
    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=steps, history_size=10, line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        A = circuit_tensor(full15_unitary(x[None], "f64"))
        loss = energy_left_canonical(A, h, 60, "f64").sum()
        loss.backward()
        return loss

    opt.step(closure)
    return x.detach().numpy()
