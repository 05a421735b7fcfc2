"""Variational environments (counterpart of ``qmps_tpu.env.variational``).

Three families, as in the reference:

1. Tomography matching (qmps/represent.py:18-114): minimize the
   bloch-vector distance between the top qubit of State(U, V) and of V.
2. Trace distance / destructive swap test (qmps/represent.py:116-175):
   Tr[(rho - sigma)^2] from the reduced density matrices.
3. Gen-2 M-ansatz matching ``represent_variational_M``
   (ClassicalTDVPStripped.py:599-655), the brickwork Represent.

And the gen-1 mixed environment ``variational_fixed_point``
(scripts/mixed_environment.py:34-209).  Every solver is adam with exact
gradients; random starts come from a ``torch.Generator`` (a CPU generator,
seed 0, if None).  The private ``_*_from`` entries take the starts
themselves, so the tests can hand them the JAX package's.
"""
from __future__ import annotations

import math

import torch

from ..circuits.brickwork import env_M, right_env_map
from ..circuits.ir import circuit_state, n_qubits
from ..core.linalg import from_real_vector
from ..core.paulis import X, Y, Z
from ..embed.unitaries import environment_to_unitary
from ..mps import transfer as tr
from ..optim.minimize import adam_steps, exponential_decay

#: the reference's name for the brickwork M ansatz
env_M_ansatz = env_M


def reduced_density_matrix(psi: torch.Tensor, keep, n: int) -> torch.Tensor:
    """Partial trace of |psi><psi| keeping the qubits in ``keep`` (cirq
    big-endian order)."""
    keep = list(keep)
    rest = [q for q in range(n) if q not in keep]
    T = psi.reshape((2,) * n).permute(keep + rest).reshape(2 ** len(keep), 2 ** len(rest))
    return T @ T.mH


def bloch_vector(rho: torch.Tensor) -> torch.Tensor:
    """(<X>, <Y>, <Z>) of a one-qubit density matrix."""
    return torch.stack([(rho @ P.to(rho.device, rho.dtype)).diagonal().sum().real for P in (X, Y, Z)])


def state_circuit_psi(U: torch.Tensor, V: torch.Tensor, n_phys: int = 1) -> torch.Tensor:
    """|psi> of the canonical State(U, V, n) preparation
    (qmps/represent.py:251-265): V on the bottom qubits, then n copies of U
    walking up."""
    ku, kv = n_qubits(U), n_qubits(V)
    ops = [(V, tuple(range(n_phys, n_phys + kv)))]
    ops += [(U, tuple(range(i, i + ku))) for i in reversed(range(n_phys))]
    return circuit_state(ops, n_phys + kv)


def _bloch_pair(U: torch.Tensor, V: torch.Tensor):
    """The top qubit's bloch vectors of State(U, V, 1) and of V alone."""
    kv = n_qubits(V)
    b1 = bloch_vector(reduced_density_matrix(state_circuit_psi(U, V, 1), [0], 1 + kv))
    b2 = bloch_vector(reduced_density_matrix(circuit_state([(V, tuple(range(kv)))], kv), [0], kv))
    return b1, b2


def tomography_env_objective(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """|bloch(q0; State(U, V)) - bloch(q0; V)| (qmps/represent.py:88-114)."""
    b1, b2 = _bloch_pair(U, V)
    return torch.linalg.vector_norm(b1 - b2)


def _get_env_variational_from(U: torch.Tensor, v0: torch.Tensor, steps: int, lr: float):
    def loss(v):
        # the squared bloch distance: smooth at the optimum (the reference's
        # norm has a gradient singularity there, harmless to Nelder-Mead)
        b1, b2 = _bloch_pair(U, environment_to_unitary(from_real_vector(v)))
        return (b1 - b2).square().sum()

    v, _ = adam_steps(loss, v0.to(U.device, U.real.dtype), steps, lr)
    with torch.no_grad():
        return environment_to_unitary(from_real_vector(v)), loss(v)


def get_env_variational(U: torch.Tensor, generator: torch.Generator | None = None, steps: int = 600,
                        lr: float = 5e-2):
    """Variational environment of a 2-qubit state unitary: ``steps`` adam
    steps at a constant rate on the 8 real parameters of the environment
    vector (qmps/represent.py:18-53), from normals drawn from
    ``generator``.  Returns (V, the final squared bloch distance)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    v0 = torch.randn(8, generator=generator, dtype=torch.float64)
    return _get_env_variational_from(U, v0, steps, lr)


def trace_distance_objective(U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
    """The destructive-swap-test objective Tr[(rho - sigma)^2]
    (qmps/represent.py:116-175): rho the top-bond state of State(U, V),
    sigma that of V; exact, from the reduced density matrices (the sampled
    estimate is ``objectives.sampling.sampled_trace_distance``)."""
    kv = n_qubits(V)
    aux = list(range(kv // 2))
    rho = reduced_density_matrix(state_circuit_psi(U, V, 1), aux, 1 + kv)
    sigma = reduced_density_matrix(circuit_state([(V, tuple(range(kv)))], kv), aux, kv)
    d = rho - sigma
    return (d @ d).diagonal().sum().real.abs()


def _variational_fixed_point_from(A: torch.Tensor, B: torch.Tensor, rand: torch.Tensor, steps: int,
                                  lr: float):
    E = tr.transfer_dense(A, B)
    n = E.shape[-1]
    # the warm start: six power steps from the all-ones vector
    v = torch.ones(E.shape[:-1], dtype=E.dtype, device=E.device)
    for _ in range(6):
        v = (E @ v[..., None])[..., 0]
        v = v / torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    lam0 = (v.conj() * (E @ v[..., None])[..., 0]).sum(-1)
    warm = torch.cat([torch.stack([lam0.real, lam0.imag], -1), v.real, v.imag], -1)
    starts = torch.cat([warm[..., None, :], rand.to(warm.device, warm.dtype)], -2)  # (..., n_starts, 2 + 2n)

    def residuals(p):
        lam = torch.complex(p[..., 0], p[..., 1])
        x = torch.complex(p[..., 2:2 + n], p[..., 2 + n:])
        x = x / torch.linalg.vector_norm(x, dim=-1, keepdim=True)
        Ex = (E[..., None, :, :] @ x[..., None])[..., 0]
        return (Ex - lam[..., None] * x).abs().square().sum(-1)

    # adam is elementwise: the summed loss moves each start as it alone would
    p, _ = adam_steps(lambda q: residuals(q).sum(), starts, steps, lr,
                      exponential_decay(max(steps // 2, 1), 0.03))
    with torch.no_grad():
        res = residuals(p)
        lams = torch.complex(p[..., 0], p[..., 1])
        i = torch.argmax(lams.abs() - 1e6 * (res > 1e-8), -1, keepdim=True)
        best = p.gather(-2, i[..., None].expand(i.shape + (p.shape[-1],)))[..., 0, :]
        vbest = torch.complex(best[..., 2:2 + n], best[..., 2 + n:])
        vbest = vbest / torch.linalg.vector_norm(vbest, dim=-1, keepdim=True)
        lam = torch.complex(best[..., 0], best[..., 1])
        return lam, vbest.reshape(vbest.shape[:-1] + (A.shape[-2], B.shape[-2])), res.gather(-1, i)[..., 0]


def variational_fixed_point(A: torch.Tensor, B: torch.Tensor, n_starts: int = 8, steps: int = 1000,
                            lr: float = 1e-1, generator: torch.Generator | None = None):
    """Variational dominant eigenpair of the mixed transfer Map(A, B):
    minimize the residual |E v - lam v|^2 over (complex lam, complex unit
    vector v), the gen-1 mixed-environment study
    (scripts/mixed_environment.py:34-209), by adam with the rate decayed
    as optax's exponential_decay(lr, steps // 2, 0.03).

    Every eigenpair is a zero of the residual, so the solver multi-starts
    (the reference retries Nelder-Mead until |lam| is large): one start is
    warmed by six power steps, the other ``n_starts`` - 1 are normals from
    ``generator`` with lam = 1; the winner is the largest |lam| among the
    converged starts (residual < 1e-8).  A and B may carry leading batch
    dimensions.  Returns (lam, r, residual), r (D_A, D_B) with an
    arbitrary phase and unit Frobenius norm."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    n = A.shape[-2] * B.shape[-2]
    batch = torch.broadcast_shapes(A.shape[:-3], B.shape[:-3])
    rand = torch.randn(batch + (n_starts - 1, 2 + 2 * n), generator=generator, dtype=torch.float64)
    rand[..., 0], rand[..., 1] = 1.0, 0.0
    return _variational_fixed_point_from(A, B, rand, steps, lr)


def represent_variational_M(U1, U2, U1d, U2d, p0=None, steps: int = 400, lr: float = 5e-2,
                            eta_bounds=None):
    """Gen-2 variational environment: minimize |eta M(p) - E[M(p)]|_F^2
    over (eta, 6 params) by adam with the rate decayed as optax's
    exponential_decay(lr, steps // 2, 0.03) (Represent.cost_function,
    ClassicalTDVPStripped.py:614-636).  The residual is squared: the
    reference's norm has a gradient singularity at the optimum.

    ``eta_bounds=(lo, hi)`` reparametrizes eta = lo + (hi - lo)
    sigmoid(x), the dt-bounded eta of loschmidt_classical.py:196-219.
    ``p0`` (7,) real defaults to (1, pi/4, 0, 0, 0, 0, 0); the run is on
    the bricks' device, in the real type of their complex type.
    Returns (eta, M, the residual norm)."""
    rdtype = U1.real.dtype
    if p0 is None:
        p0 = torch.tensor([1.0, math.pi / 4, 0, 0, 0, 0, 0], dtype=torch.float64)
    p0 = torch.as_tensor(p0).to(U1.device, rdtype)

    def eta_of(x):
        if eta_bounds is None:
            return x
        lo, hi = eta_bounds
        return lo + (hi - lo) * torch.sigmoid(x)

    def loss(params):
        eta, M = eta_of(params[0]), env_M(params[1:])
        return (eta * M - right_env_map(U1, U2, U1d, U2d, M)).abs().square().sum()

    v, _ = adam_steps(loss, p0, steps, lr, exponential_decay(max(steps // 2, 1), 0.03))
    with torch.no_grad():
        return eta_of(v[0]), env_M(v[1:]), loss(v).sqrt()
