"""Circuit-to-tensor compiler (counterpart of ``qmps_tpu.circuits.ir``).

A circuit is a list of ``(U, wires)`` dense gate applications.  Gates may
carry leading batch dimensions, (..., 2^k, 2^k); they broadcast against
each other and against the state.  Conventions match cirq: qubit 0 is the
most significant bit of the state index; ops listed first are applied
first.  The result's type and device are the first gate's unless given.
"""
from __future__ import annotations

from typing import Iterable, Sequence, Tuple

import torch

Op = Tuple[torch.Tensor, Sequence[int]]

_LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def n_qubits(M: torch.Tensor) -> int:
    """The qubits of a (..., 2^n) state or a (..., 2^n, 2^n) gate."""
    return int(M.shape[-1]).bit_length() - 1


def apply_unitary(psi: torch.Tensor, U: torch.Tensor, wires: Sequence[int], n: int, d: int = 2) -> torch.Tensor:
    """Apply a (..., d^k, d^k) gate to sites ``wires`` of (..., d^n) states
    (qubits for d = 2; the density-matrix path applies superoperators to
    (ket, bra) pairs, d = 4)."""
    k = len(wires)
    state = _LETTERS[:n]
    out = _LETTERS[n:n + k]
    result = list(state)
    for w, o in zip(wires, out):
        result[w] = o
    psi_t = psi.reshape(psi.shape[:-1] + (d,) * n)
    U_t = U.reshape(U.shape[:-2] + (d,) * (2 * k))
    ins = "".join(state[w] for w in wires)
    psi_t = torch.einsum(f"...{out}{ins},...{state}->...{''.join(result)}", U_t, psi_t)
    return psi_t.reshape(psi_t.shape[:-n] + (d**n,))


def apply_on_every_site(psi: torch.Tensor, mats, n: int, d: int = 2) -> torch.Tensor:
    """Apply a one-site (..., d, d) matrix to every site of (..., d^n)
    states: ``mats`` one tensor for all sites, or a list of n, one a site.
    One batched product a site: each contracts the leading site and moves
    it last, so after n of them the sites are back in order."""
    for q in range(n):
        m = mats if isinstance(mats, torch.Tensor) else mats[q]
        psi = psi.reshape(psi.shape[:-1] + (d, d ** (n - 1))).mT @ m.mT
        psi = psi.reshape(psi.shape[:-2] + (d**n,))
    return psi


def _first_gate(ops):
    return next(iter(ops))[0]


def circuit_state(
    ops: Iterable[Op], n: int, psi0: torch.Tensor | None = None, dtype=None, device=None
) -> torch.Tensor:
    """Run the circuit on |0...0> (or psi0) and return the state vector(s)."""
    ops = list(ops)
    first = psi0 if psi0 is not None else _first_gate(ops)
    dtype = dtype or first.dtype
    device = device or first.device
    if psi0 is None:
        psi = torch.zeros(2**n, dtype=dtype, device=device)
        psi[0] = 1.0
    else:
        psi = psi0.to(device, dtype)
    for U, wires in ops:
        psi = apply_unitary(psi, U.to(device, dtype), wires, n)
    return psi


def circuit_unitary(ops: Iterable[Op], n: int, dtype=None, device=None) -> torch.Tensor:
    """Compile the circuit to its dense (..., 2^n, 2^n) unitary: the
    circuit run on the 2^n basis states, one column each."""
    ops = list(ops)
    dtype = dtype or _first_gate(ops).dtype
    device = device or _first_gate(ops).device
    cols = torch.eye(2**n, dtype=dtype, device=device)  # row c = basis state c
    for g, wires in ops:
        # a gate's batch dims sit before the column index
        cols = apply_unitary(cols, g.to(device, dtype)[..., None, :, :], wires, n)
    return cols.mT


def dagger_ops(ops: Sequence[Op]) -> list:
    """Inverse circuit: reversed order, conjugate-transposed gates."""
    return [(U.mH, wires) for U, wires in reversed(list(ops))]
