"""The plain reference of the brick-wall circuit ansatz ("deep_bw") and its
phase-diagram sweep, in plain PyTorch.

Like ``reference`` and ``reference_stiefel``, it imports neither JAX, nor
the JAX package, nor anything of the program (``qmps_torch``), and takes
nothing the program made but the outputs it judges.  Written from the
published description: the closed-form gates of the reference's
``new_tdvp/unitary_param.py:77-120``, its brick-wall uMPS
(``new_tdvp/BrickWallMPS.py``) and the TFIM phase diagram of
``scripts/ground_state_finding.py``.

- ``u2``, ``rotation``, ``kak_brick``: the general U(2) with explicit
  phases, the Pauli rotations and the 19-parameter KAK brick (four U(2)s,
  three CNOTs and the "yyz" rotations between them).
- ``brick_layout``, ``wall_unitary``: the depth-d wall on n qubits, layer k
  a brick on each wire pair (i, i+1), i = k % 2, k % 2 + 2, ...; qubit 0
  is the major bit of a state's index.  Each brick is written as a dense
  2^n x 2^n matrix (identities on the other wires) and the bricks are
  multiplied in the order they act.
- ``wall_tensor``: the uMPS tensor of the wall at D = 2^(n-1), its first
  input qubit at |0>: A[s, i, j] = U[2 i + s, j].
- ``wall_energy_f64``: the float64 energy per site of a wall's parameters,
  read by ``reference_stiefel.mps_energy_f64_general`` (no gauge assumed).
- ``deep_bw_sweep_plain``: the sweep the benchmark's control runs: adam
  with the cosine-decayed rate on the parameters of every point at once,
  each step's energy from the exact environment, then the refine passes.

Its products run at a chosen precision, "f64", "f32" or "tf32", as
``reference.product`` has them; at "f32" and "f64" TF32 is turned off in
cuBLAS and cuDNN (on an H100 a float32 product may otherwise run in TF32).

Departures from the program, each a choice of method and not of what is
computed:
- the exact environment.  The program refines the right environment by 24
  warm power matvecs a step from the last step's and differentiates
  through them; the reference takes the transfer matrix's dominant right
  eigenvector every step (48 normalised squarings, differentiated by the
  implicit function theorem, ``reference._dominant_power``).  The two
  gradients agree as the program's power residual vanishes.
- the evaluations.  The program reads a descent's energy from its last
  environment, and a neighbour's parameters' from the identity, each
  projected onto the transfer matrix's dominant eigenspace (40 complex128
  squarings) and then refined by 200 power matvecs; the reference reads
  both at the exact environment.
- adam is written from its formula (b1 0.9, b2 0.999, eps 1e-8 outside
  the square root, bias correction); the program runs
  ``torch.optim.Adam``, fused on the card: the same formula, another
  order of rounding.
- one restart, the configuration's: the program's jittered restart slots
  have no counterpart here.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .reference import _dominant_power, complex_type, product, tfim_two_site
from .reference_stiefel import _no_tf32, energy_warm, mps_energy_f64_general

#: parameters of one brick (``kak_brick``)
BRICK_PARAMS = 19
#: normalised squarings of the transfer matrix for the exact environment
SQUARINGS = 48
#: adam's constants (optax.adam's defaults)
B1, B2, EPS = 0.9, 0.999, 1e-8
#: the rate's floor in the cosine decay (optax's cosine_decay_schedule alpha)
ALPHA = 0.05

_PAULI = {"x": [[0, 1], [1, 0]], "y": [[0, -1j], [1j, 0]], "z": [[1, 0], [0, -1]]}


def _mm(a, b, prec):
    return product("...ij,...jk->...ik", a, b, prec)


def _kron(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    """kron of (..., p, p) with (..., q, q) -> (..., pq, pq), per batch row."""
    out = product("...ij,...kl->...ikjl", a, b, prec)
    n = a.shape[-1] * b.shape[-1]
    return out.reshape(out.shape[:-4] + (n, n))


# ---------------------------------------------------------------------------
# the gates (new_tdvp/unitary_param.py:77-120)
# ---------------------------------------------------------------------------


def u2(a, b, c, d) -> torch.Tensor:
    """The general U(2) with explicit phases, angles (...,) real:
    [[e^{i(a-b/2-d/2)} cos(c/2), -e^{i(a-b/2+d/2)} sin(c/2)],
     [e^{i(a+b/2-d/2)} sin(c/2),  e^{i(a+b/2+d/2)} cos(c/2)]]."""
    ct = torch.promote_types(a.dtype, torch.complex64)

    def ph(x):
        return torch.exp(1j * x.to(ct))

    cos, sin = torch.cos(c / 2).to(ct), torch.sin(c / 2).to(ct)
    row0 = torch.stack([ph(a - b / 2 - d / 2) * cos, -ph(a - b / 2 + d / 2) * sin], -1)
    row1 = torch.stack([ph(a + b / 2 - d / 2) * sin, ph(a + b / 2 + d / 2) * cos], -1)
    return torch.stack([row0, row1], -2)


def rotation(axis: str, t: torch.Tensor) -> torch.Tensor:
    """exp(-i t P / 2) = cos(t/2) I - i sin(t/2) P, P the Pauli ``axis``;
    t (...,) -> (..., 2, 2)."""
    ct = torch.promote_types(t.dtype, torch.complex64)
    P = torch.tensor(_PAULI[axis], dtype=ct, device=t.device)
    eye = torch.eye(2, dtype=ct, device=t.device)
    half = (t / 2).to(ct)[..., None, None]
    return torch.cos(half) * eye - 1j * torch.sin(half) * P


def kak_brick(p: torch.Tensor, prec: str) -> torch.Tensor:
    """The 19-parameter two-qubit brick, p (..., 19) -> (..., 4, 4): with
    u1 .. u4 the U(2)s of p[0:4], p[4:8], p[8:12], p[12:16], acting in turn
    kron(u1, u2), CNOT (control qubit 0), kron(Ry(p[17]), Rz(p[18])), CNOT
    (control qubit 1), kron(Ry(p[16]), I), CNOT (control qubit 0),
    kron(u3, u4)."""
    ct = complex_type(prec)
    dev = p.device
    cx01 = torch.tensor([[1, 0, 0, 0], [0, 1, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0]], dtype=ct, device=dev)
    cx10 = torch.tensor([[1, 0, 0, 0], [0, 0, 0, 1], [0, 0, 1, 0], [0, 1, 0, 0]], dtype=ct, device=dev)
    eye = torch.eye(2, dtype=ct, device=dev)
    u = [u2(*p[..., 4 * k:4 * k + 4].unbind(-1)).to(ct) for k in range(4)]
    ry16, ry17, rz18 = rotation("y", p[..., 16]), rotation("y", p[..., 17]), rotation("z", p[..., 18])
    acting = [_kron(u[0], u[1], prec), cx01, _kron(ry17, rz18, prec), cx10, _kron(ry16, eye.expand_as(ry16), prec),
              cx01, _kron(u[2], u[3], prec)]
    U = acting[0]
    for G in acting[1:]:
        U = _mm(G, U, prec)
    return U


# ---------------------------------------------------------------------------
# the wall and its tensor
# ---------------------------------------------------------------------------


def brick_layout(n_qubits: int, depth: int) -> list[tuple[int, int]]:
    """Wire pairs of the wall in the order they act: layer k (k = 0 ..
    depth - 1) a brick on (i, i+1) for i = k % 2, k % 2 + 2, ... < n - 1."""
    return [(i, i + 1) for k in range(depth) for i in range(k % 2, n_qubits - 1, 2)]


def n_qubits(D: int) -> int:
    """n with D = 2^(n-1): the wall of a bond dimension D state."""
    n = int(round(math.log2(D))) + 1
    if 2 ** (n - 1) != D:
        raise ValueError(f"the brick wall needs a power-of-two D, got {D}")
    return n


def wall_unitary(params: torch.Tensor, n: int, depth: int, prec: str) -> torch.Tensor:
    """The dense (..., 2^n, 2^n) unitary of the depth-``depth`` wall of
    ``params`` (..., 19 x bricks), the bricks' parameters in layout order:
    the product of each brick written as kron(I_{2^i}, B, I_{2^(n-i-2)}),
    the first to act rightmost."""
    ct = complex_type(prec)
    layout = brick_layout(n, depth)
    p = params.reshape(params.shape[:-1] + (len(layout), BRICK_PARAMS))
    bricks = kak_brick(p, prec)
    U = torch.eye(2 ** n, dtype=ct, device=params.device).expand(params.shape[:-1] + (2 ** n, 2 ** n))
    for b, (i, _) in enumerate(layout):
        left = torch.eye(2 ** i, dtype=ct, device=params.device)
        right = torch.eye(2 ** (n - i - 2), dtype=ct, device=params.device)
        B = bricks[..., b, :, :]
        full = torch.einsum("xz,...pq,yw->...xpyzqw", left, B, right).reshape(U.shape)
        U = _mm(full, U, prec)
    return U


def wall_tensor(params: torch.Tensor, D: int, prec: str) -> torch.Tensor:
    """(..., 2, D, D) uMPS tensor of the depth-(n+1) wall at D = 2^(n-1):
    A[s, i, j] = U[2 i + s, j] for j < D, the columns whose first input
    qubit is |0>, the rows' last qubit the physical index s."""
    n = n_qubits(D)
    U = wall_unitary(params, n, n + 1, prec)
    return U[..., :, :D].reshape(U.shape[:-2] + (D, 2, D)).transpose(-3, -2)


def wall_energy_f64(params, g, D: int, device="cpu") -> np.ndarray:
    """Energy per site, in float64, of the wall of each row of ``params``
    (n, 19 x bricks) under the TFIM term of each g: the tensors built at
    complex128 on ``device``, then ``mps_energy_f64_general``."""
    _no_tf32()
    p = torch.as_tensor(np.asarray(params, np.float64)).to(device)
    with torch.no_grad():
        A = wall_tensor(p, D, "f64").cpu().numpy()
    return mps_energy_f64_general(A, g, device)


# ---------------------------------------------------------------------------
# the plain sweep (adam on the circuit's parameters, exact environments)
# ---------------------------------------------------------------------------


def energy_exact(A: torch.Tensor, hs: torch.Tensor, prec: str, squarings: int = SQUARINGS) -> torch.Tensor:
    """Energy per site of left-canonical tensors A (n, 2, D, D) under hs
    (n, 4, 4) at the exact right environment: the dominant right
    eigenvector of the transfer matrix T(x) = sum_s A_s x A_s^dag by
    ``squarings`` normalised squarings, differentiable by the implicit
    function theorem (``reference._dominant_power``); then
    Re sum_ts h_ts tr(AA_s r AA_t^dag) / tr(r)."""
    n, D = A.shape[0], A.shape[-1]
    T = product("bsik,bsjl->bijkl", A, A.conj(), prec).reshape(n, D * D, D * D)
    _, v = _dominant_power(T, squarings, prec)
    return energy_warm(A, hs, v.reshape(n, D, D), prec)


def cosine_factor(k: int, steps: int) -> float:
    """The rate's factor at update k: optax's cosine_decay_schedule with
    decay_steps = steps and alpha ``ALPHA``."""
    return (1 - ALPHA) * 0.5 * (1 + math.cos(math.pi * min(k, steps) / steps)) + ALPHA


def deep_bw_sweep_plain(gs, p0, D: int, steps: int, lr: float, refine_passes: int, prec: str, device="cpu"):
    """The "deep_bw" phase-diagram sweep from the starts p0 (n, 19 x
    bricks), one restart: every point's parameters descend together by
    ``steps`` adam updates of the summed energy (each point's gradient its
    own) at the cosine-decayed rate lr * ``cosine_factor(k, steps)``; then
    ``refine_passes`` adiabatic-continuation passes: for each shift 1 and
    -1, each point (a) takes its neighbour's parameters (rolled by the
    shift along the sorted couplings) where their energy at its own g is
    lower, and (b) re-optimises from the neighbour's parameters and keeps
    the result where it is lower still.  Returns (energies (n,), params
    (n, 19 x bricks)) as NumPy."""
    if prec in ("f32", "f64"):
        _no_tf32()
    rt = torch.float64 if prec == "f64" else torch.float32
    hs = torch.as_tensor(tfim_two_site(np.asarray(gs, np.float64))).to(device, complex_type(prec))

    def energies(p):
        return energy_exact(wall_tensor(p, D, prec), hs, prec)

    def optimize(x0):
        x, m, v = x0, torch.zeros_like(x0), torch.zeros_like(x0)
        for k in range(steps):
            xg = x.detach().requires_grad_()
            (G,) = torch.autograd.grad(energies(xg).sum(), xg)
            with torch.no_grad():
                m = B1 * m + (1 - B1) * G
                v = B2 * v + (1 - B2) * G * G
                m_hat, v_hat = m / (1 - B1 ** (k + 1)), v / (1 - B2 ** (k + 1))
                x = x - lr * cosine_factor(k, steps) * m_hat / (torch.sqrt(v_hat) + EPS)
        with torch.no_grad():
            return energies(x), x

    es, ps = optimize(torch.as_tensor(np.asarray(p0)).to(device, rt))
    for _ in range(refine_passes):
        for shift in (1, -1):
            p_nb = torch.roll(ps, shift, 0)
            with torch.no_grad():
                e_nb = energies(p_nb)
            better = e_nb < es
            es, ps = torch.where(better, e_nb, es), torch.where(better[:, None], p_nb, ps)
            e2, p2 = optimize(p_nb)
            better = e2 < es
            es, ps = torch.where(better, e2, es), torch.where(better[:, None], p2, ps)
    return es.double().cpu().numpy(), ps.cpu().numpy()
