"""Pauli-string Hamiltonians (counterpart of ``qmps_tpu.ham.hamiltonian``).

``Hamiltonian({'ZZ': -1, 'X': g})`` is the TFIM; single-character strings
are split symmetrically across the bond, as the reference does
(qmps/ground_state.py:73-80).  Matrices are host numpy complex128; the
callers move them onto their device and type.  ``as_host_matrix`` also
takes an ``mps.mpo.MPO`` of range <= 2.
"""
from __future__ import annotations

from itertools import product
from typing import Dict

import numpy as np
import torch

from ..core.paulis import PAULI, embed


class Hamiltonian:
    """Two-site Hamiltonian as a dict of Pauli strings -> couplings."""

    def __init__(self, strings: Dict[str, float] | None = None):
        self.strings = dict(strings) if strings is not None else None
        if self.strings is not None:
            for key, val in list(self.strings.items()):
                if len(key) == 1:
                    self.strings["I" + key] = self.strings.get("I" + key, 0) + val / 2
                    self.strings[key + "I"] = self.strings.get(key + "I", 0) + val / 2
                    del self.strings[key]

    def to_matrix(self) -> np.ndarray:
        """Dense 4x4 matrix, host numpy complex128."""
        if self.strings is None:
            raise ValueError("a Hamiltonian without Pauli strings has no matrix")
        h = np.zeros((4, 4), np.complex128)
        for js, J in self.strings.items():
            term = PAULI[js[0]].numpy()
            for c in js[1:]:
                term = np.kron(term, PAULI[c].numpy())
            h = h + complex(J) * term
        return h

    def measure_energy(self, generator: torch.Generator, psi: torch.Tensor, qubits=(1, 2),
                       shots: int = 300000) -> torch.Tensor:
        """Finite-shot Pauli-string energy estimate on a prepared state
        (qmps/ground_state.py:97-108), shots from ``generator`` on psi's
        device."""
        from ..objectives.sampling import measure_energy

        return measure_energy(generator, self.strings, psi, qubits=qubits, shots=shots)

    def calculate_energy(self, psi: torch.Tensor, loc: int = 1) -> torch.Tensor:
        """Exact <H> on the adjacent qubits (loc, loc + 1) of a prepared
        state vector (qmps/ground_state.py:110-118)."""
        n = int(psi.shape[0]).bit_length() - 1
        H = embed(torch.from_numpy(self.to_matrix()), loc, n).to(psi.device, psi.dtype)
        return (psi.conj() @ (H @ psi)).real

    @classmethod
    def from_matrix(cls, mat) -> "Hamiltonian":
        """Project a 4x4 matrix back onto Pauli strings
        (qmps/ground_state.py:90-95)."""
        mat = np.asarray(as_host_matrix(mat), np.complex128)
        out = cls.__new__(cls)
        out.strings = {
            a + b: complex(np.trace(np.kron(PAULI[a].numpy(), PAULI[b].numpy()) @ mat) / 4.0)
            for a, b in product(PAULI, PAULI) if a + b != "II"
        }
        return out


def as_host_matrix(H) -> np.ndarray:
    """Hamiltonian | MPO | tensor | array -> host numpy matrix.  An MPO of
    range <= 2 reduces exactly to its bond matrix (so the circuit-TDVP
    steppers, whose Trotter gate is two-site, take it); a longer-range one
    raises there: ``mps.tdvp.Trajectory(A0, h=mpo)`` evolves it."""
    from ..mps.mpo import MPO  # deferred: the ham layer sits below mps

    if isinstance(H, Hamiltonian):
        return H.to_matrix()
    if isinstance(H, MPO):
        return H.two_site_matrix()
    if isinstance(H, torch.Tensor):
        return H.detach().cpu().resolve_conj().numpy()
    return np.asarray(H)


def tfim(g: float) -> Hamiltonian:
    """Transverse-field Ising H = -ZZ + g X (per-site field split over bonds)."""
    return Hamiltonian({"ZZ": -1.0, "X": g})


def xy() -> Hamiltonian:
    """XY model (scripts/bond_dimension.py:18)."""
    return Hamiltonian({"XX": 1.0, "YY": 1.0})


def heisenberg(J: float = 1.0) -> Hamiltonian:
    """Isotropic Heisenberg (new_tdvp/HeisenbergHam.py:24-25)."""
    return Hamiltonian({"XX": J, "YY": J, "ZZ": J})


def xxz(delta: float, J: float = 1.0) -> Hamiltonian:
    """Anisotropic Heisenberg H = J sum (XX + YY + delta ZZ): critical for
    |delta| <= 1, gapped and Neel-ordered for delta > 1, where the ground
    state needs a two-site unit cell (``block_two_site``)."""
    return Hamiltonian({"XX": J, "YY": J, "ZZ": J * delta})


def sublattice_rotate(h) -> np.ndarray:
    """h' = (I (x) R) h (I (x) R)^dag with R = exp(-i pi Y / 2), the
    odd-site rotation X -> -X, Z -> -Z: in that frame the Neel-structured
    ground states of the XY and Heisenberg chains are translation
    invariant.  Energies are frame-invariant.  Host numpy; real where the
    result has no imaginary part."""
    h = np.asarray(as_host_matrix(h))
    R = np.array([[0.0, -1.0], [1.0, 0.0]])
    IR = np.kron(np.eye(2), R)
    out = IR @ h @ IR.T.conj()
    return out.real if np.allclose(out.imag, 0) else out


def block_two_site(h, h1=None) -> np.ndarray:
    """The two-cell bond term of a chain blocked into cells of two sites:
    I_d (x) h (x) I_d (the bond between cells) + (h (x) I + I (x) h) / 2
    (each cell's inner bond, split over its two blocked bonds), plus, for a
    one-site term h1, (cell1 (x) I + I (x) cell1) / 2 with cell1 = h1 (x) I
    + I (x) h1.  The blocked energy per cell is twice the chain's per site.
    Host numpy; real when the imaginary part is roundoff relative to the
    matrix's scale."""
    h = np.asarray(as_host_matrix(h))
    d = int(round(h.shape[0] ** 0.5))
    Id, Id2 = np.eye(d), np.eye(d * d)
    out = np.kron(Id, np.kron(h, Id)) + 0.5 * (np.kron(h, Id2) + np.kron(Id2, h))
    if h1 is not None:
        h1 = np.asarray(as_host_matrix(h1))
        cell1 = np.kron(h1, Id) + np.kron(Id, h1)
        out = out + 0.5 * (np.kron(cell1, Id2) + np.kron(Id2, cell1))
    if not np.iscomplexobj(out):
        return out
    scale = max(1.0, float(np.max(np.abs(out))))
    return out.real if np.max(np.abs(out.imag)) <= 1e-12 * scale else out


def scars_H(mu: float) -> np.ndarray:
    """The 4-site PXP scars Hamiltonian (scars.py:22-25), dense 16x16 host
    numpy complex128."""
    P = np.array([[0, 0], [0, 1]], dtype=complex)
    Xm = np.array([[0, 1], [1, 0]], dtype=complex)
    n = np.array([[1, 0], [0, 0]], dtype=complex)
    I = np.eye(2, dtype=complex)

    def mt(ops):
        out = ops[0]
        for o in ops[1:]:
            out = np.kron(out, o)
        return out

    return 0.5 * (mt([I, P, Xm, P]) + mt([P, Xm, P, I])) + (mu / 4) * (
        mt([I, I, I, n]) + mt([I, I, n, I]) + mt([I, n, I, I]) + mt([n, I, I, I])
    )
