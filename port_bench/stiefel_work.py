"""The work of one large-D phase-diagram sweep, counted from its algorithm
(``reference_stiefel.stiefel_sweep_plain``, with the program's
10-iteration Newton-Schulz polar factor), not from the kernels that run
it: complex multiply-adds of the products, 8 real flops each, and the
elementwise work of each normalisation.  ``roofline_pct.stiefel_job``
reads it; its least time is ``yardstick.bound_s`` of these flops and
bytes, so the share reads the same whatever implements the step.

Counted per (point, restart) row, d = 2 physical states:
- a power matvec T(r) = sum_s A_s r A_s^dag: 2 d D^3 multiply-adds, and
  its Frobenius normalisation (|.|^2, the sum, the division: 6 D^2 flops);
  its backward through plain autograd twice the products and the
  normalisation;
- the energy: the d^2 two-site tensors AA (d^2 D^3), AA_s r (d^2 D^3),
  the d^4 traces tr(AA_s r AA_t^dag) (d^4 D^2); its backward twice that;
- the retraction: two tangent projections (2 x 2 (2D) D^2 each: V^dag G
  and V sym), the polar factor by Newton-Schulz (W^dag W, then 3 D^3 a
  iteration, then W Z);
- the readout: the (D^2, D^2) transfer matrix (d D^4), its normalised
  power by ``READOUT_SQUARINGS`` squarings (D^6 each, and the
  normalisation of its D^4 entries: 6 flops each, as in the first
  normalisation), the carried environment projected by it (D^4), then
  ``final_iters`` matvecs and the energy, forward only.

Bytes are each input read once and each output written once: the start
normals, the couplings, the returned energies, tensors and environments.
"""
from __future__ import annotations

CMAC = 8  # real flops of a complex multiply-add
D_PHYS = 2
NS_ITERS = 10  # the program's Newton-Schulz iterations a retraction
READOUT_SQUARINGS = 40  # the readout's squarings (reference_stiefel.dominant_projection)


def matvec_cmacs(D: int) -> int:
    return 2 * D_PHYS * D ** 3


def energy_cmacs(D: int) -> int:
    return 2 * D_PHYS ** 2 * D ** 3 + D_PHYS ** 4 * D ** 2


def retract_cmacs(D: int) -> int:
    projections = 2 * 2 * (D_PHYS * D) * D * D
    polar = (D_PHYS * D) * D * D + NS_ITERS * 3 * D ** 3 + (D_PHYS * D) * D * D
    return projections + polar


def step_cmacs(D: int, recycle_iters: int) -> int:
    """Complex multiply-adds of one descent step of one row: the unroll
    forward and backward, the energy forward and backward, the retraction."""
    return 3 * (recycle_iters * matvec_cmacs(D) + energy_cmacs(D)) + retract_cmacs(D)


def step_flops(D: int, recycle_iters: int) -> int:
    """Real flops of one descent step of one row."""
    return CMAC * step_cmacs(D, recycle_iters) + 3 * recycle_iters * 6 * D * D


def power_flops(D: int, squarings: int = READOUT_SQUARINGS) -> int:
    """Real flops of the readout's normalised power of one row's (D^2, D^2)
    transfer matrix: its first normalisation, then each squaring and its
    normalisation."""
    N = D * D
    return squarings * (CMAC * N ** 3 + 6 * N * N) + 6 * N * N


def readout_flops(D: int, final_iters: int) -> int:
    """Real flops of the final readout of one row: the transfer matrix, its
    power, the projection, the matvecs and the energy."""
    projection = CMAC * (D_PHYS * D ** 4 + D ** 4)
    return (projection + power_flops(D) + CMAC * (final_iters * matvec_cmacs(D) + energy_cmacs(D))
            + final_iters * 6 * D * D)


def job_work(points: int, restarts: int, D: int, steps: int, recycle_iters: int,
             final_iters: int) -> tuple[int, int]:
    """(flops, bytes) of one sweep job."""
    rows = points * restarts
    flops = rows * (steps * step_flops(D, recycle_iters) + readout_flops(D, final_iters))
    # float32 normals (re, im) and couplings in; complex64 energies, tensors, environments out
    nbytes = rows * 2 * (D_PHYS * D * D) * 4 + points * 4 + points * (4 + 8 * D_PHYS * D * D + 8 * D * D)
    return flops, nbytes
