"""TDVP overlap objectives (counterpart of ``qmps_tpu.objectives.overlap``).

The canonical TDVP cost (qmps/new_time_evolve.py:193-221): given the
current left-canonical tensor A and the Trotter gate W = exp(-i h 2dt),
score a candidate tensor B by the dominant eigenvalue x of the mixed
transfer operator E = Map(W (A (x) A), B (x) B), as -|x|.

The dense objective, and the batched ``tdvp_objective_pallas`` dispatch,
which at D = 2 runs the fused kernels K4/K5 and at D >= 3 the batched
eigenvalue over K7/K8.  The circuit path reproduces the reference's
6-qubit Bell-form Hadamard-test amplitude (scripts/loschmidt.py:227-238)
for the parity tests, and the overlap of two states exactly or with a
variational environment (qmps/time_evolve_tools.py:84-131).
"""
from __future__ import annotations

import torch

from ..circuits.ir import circuit_state, dagger_ops
from ..core import gates as g
from ..core.linalg import rotate_to_hermitian
from ..embed.unitaries import put_env_on_left_site, put_env_on_right_site, tensor_to_unitary
from ..kernels.pallas_power import dominant_eigval_batched
from ..kernels.tdvp_fused import tdvp_objective_fused
from ..mps import transfer as tr
from ..mps.imps import merge
from ..optim.minimize import adam_steps


def mixed_transfer_with_gate(A: torch.Tensor, B: torch.Tensor, W: torch.Tensor):
    """(W (A (x) A), B (x) B): the blocked two-site tensors of the mixed
    transfer operator, with the Trotter gate applied to the ket."""
    AA = merge(A, A)
    WAA = torch.einsum("...st,...tij->...sij", W.to(A.device, A.dtype), AA)
    return WAA, merge(B, B)


def tdvp_objective(A: torch.Tensor, B: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """-|x| (batched over leading dimensions); the gradient is the rank-1
    implicit adjoint of ``dominant_eigval_dense``."""
    WAA, BB = mixed_transfer_with_gate(A, B, W)
    return -tr.dominant_eigval_dense(tr.transfer_dense(WAA, BB)).abs()


def tdvp_objective_pallas(
    As: torch.Tensor, Bs: torch.Tensor, W: torch.Tensor, iters: int = 48
) -> torch.Tensor:
    """Batched fast TDVP objective: (B, 2, D, D) x 2 and W, one (4, 4)
    gate or a (B, 4, 4) batch -> (B,) of -|x|.

    At D = 2 it is the fused objective (kernels/tdvp_fused.py: K4 forward,
    K5 backward on CUDA).  At D >= 3 the D^2 x D^2 mixed transfer matrices
    are built batched in PyTorch and their dominant eigenvalue taken by
    ``dominant_eigval_batched`` (on CUDA one launch of K7 for D = 3, 4 or
    K8 above; the backward is a rank-1 product with no launch).  Matches
    the batched dense ``tdvp_objective`` to solver precision."""
    if As.dim() != 4 or As.shape[1] != 2:
        raise ValueError(f"As must be batched (B, 2, D, D) MPS tensors, got {tuple(As.shape)}")
    if tuple(W.shape[-2:]) != (4, 4):
        raise ValueError(f"W must be a 2-site (4, 4) gate (optionally batched), got {tuple(W.shape)}")
    if As.shape[-1] == 2:
        return tdvp_objective_fused(As, Bs, W, iters)
    WAA, BB = mixed_transfer_with_gate(As, Bs, W)  # a (4, 4) W broadcasts over the batch
    return -dominant_eigval_batched(tr.transfer_dense(WAA, BB), iters).abs()


def bell_tdvp_ops(A: torch.Tensor, B: torch.Tensor, W: torch.Tensor, r: torch.Tensor):
    """The 6-qubit Bell-form TDVP circuit as an op list: Bell pair, two U's
    up, W across the physical legs, L from r^dag on top, R from r at the
    bottom, two U'^dag down, CNOT and H (scripts/loschmidt.py:227-238)."""
    U, Ud = tensor_to_unitary(A), tensor_to_unitary(B)
    ops = [
        (g.H, (3,)),
        (g.CNOT, (3, 4)),
        (U, (2, 3)),
        (U, (1, 2)),
        (W, (2, 3)),
        (put_env_on_right_site(r.mH), (0, 1)),
        (put_env_on_left_site(r), (4, 5)),
    ]
    ops += dagger_ops([(Ud, (1, 2))])
    ops += dagger_ops([(Ud, (2, 3))])
    return ops + [(g.CNOT, (3, 4)), (g.H, (3,))]


def hadamard_test_amplitude(A: torch.Tensor, B: torch.Tensor, W: torch.Tensor, r: torch.Tensor):
    """2 psi[0] of the Bell-form TDVP circuit (``bell_tdvp_ops``).  For the
    normalised fixed point r of E = Map(W (A x A), B x B) it is x tr(r^dag
    r) = x: the Bell preparation and readout address only the rows of the
    environment embeddings that are fixed, so the amplitude does not
    depend on their completion."""
    return 2 * circuit_state(bell_tdvp_ops(A, B, W, r), 6, dtype=A.dtype, device=A.device)[0]


def get_overlap_exact(A: torch.Tensor, B: torch.Tensor):
    """(|x|^2, r): the per-site overlap density of two uMPS tensors and the
    mixed fixed point (qmps/time_evolve_tools.py:84-91)."""
    x, r = tr.right_fixed_point(A, B)
    return x.abs() ** 2, r


def _env_of(rs: torch.Tensor) -> torch.Tensor:
    """8 real parameters -> a unit-norm hermitian 2x2 environment."""
    r = rotate_to_hermitian(torch.complex(rs[:4], rs[4:]).reshape(2, 2))
    return r / torch.linalg.matrix_norm(r)


def get_overlap_variational(A: torch.Tensor, B: torch.Tensor, steps: int = 400, lr: float = 5e-2,
                            generator: torch.Generator | None = None):
    """The overlap with a variational environment: ``steps`` adam steps on
    8 real parameters of r (normals from ``generator``, a CPU generator,
    seed 0 if None) to maximise |amplitude| of the Bell-form circuit at
    W = I (qmps/time_evolve_tools.py:95-131, with gradients).  Returns
    (|amplitude|, r)."""
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    W = torch.eye(4, dtype=A.dtype, device=A.device)
    v0 = torch.randn(8, generator=generator, dtype=torch.float64).to(A.device, A.real.dtype)
    v = adam_steps(lambda rs: -hadamard_test_amplitude(A, B, W, _env_of(rs)).abs(), v0, steps, lr)[0]
    r = _env_of(v)
    return hadamard_test_amplitude(A, B, W, r).abs(), r


def tdvp_objective_circuit(A: torch.Tensor, B: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """The circuit path's objective -|2 psi[0]| = -|x|, the fast path's
    value (the reference's -sqrt(2|psi[0]|) ranks the same)."""
    WAA, BB = mixed_transfer_with_gate(A, B, W)
    _, r = tr.right_fixed_point(WAA, BB)
    return -hadamard_test_amplitude(A, B, W, r).abs()
