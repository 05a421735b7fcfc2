"""Pauli-string Hamiltonians (counterpart of ``qmps_tpu.ham.hamiltonian``).

``Hamiltonian({'ZZ': -1, 'X': g})`` is the TFIM; single-character strings
are split symmetrically across the bond, as the reference does
(qmps/ground_state.py:73-80).  Matrices are host numpy complex128; the
callers move them onto their device and type.  The MPO branch of
``as_host_matrix`` waits for mps/mpo (ROADMAP.md, item 18).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.paulis import PAULI


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


def as_host_matrix(H) -> np.ndarray:
    """Hamiltonian | tensor | array -> host numpy matrix."""
    if isinstance(H, Hamiltonian):
        return H.to_matrix()
    if isinstance(H, torch.Tensor):
        return H.detach().cpu().resolve_conj().numpy()
    return np.asarray(H)


def tfim(g: float) -> Hamiltonian:
    """Transverse-field Ising H = -ZZ + g X (per-site field split over bonds)."""
    return Hamiltonian({"ZZ": -1.0, "X": g})
