"""Independent host-numpy float64 readouts (copied from
``qmps_tpu.ham.classical_baselines``; the rest of that module comes with a
later slice)."""
from __future__ import annotations

import numpy as np


def host_energy_d2(A, h) -> float:
    """f64 host-numpy uMPS energy of a single left-canonical D = 2 tensor
    (2, 2, 2) against a two-site Hamiltonian matrix (4, 4) — the
    independent validation of a returned state (a device-side f32 energy
    can dip below the exact value near criticality; a reported error must
    be one the returned tensor achieves in exact arithmetic).  Dense numpy
    eig for the right fixed point.  Takes numpy arrays (move tensors to
    the host first).
    """
    A = np.asarray(A).astype(np.complex128)
    AA = np.einsum("sik,tkj->stij", A, A).reshape(4, 2, 2)
    E = np.einsum("sik,sjl->ijkl", AA, AA.conj()).reshape(4, 4)
    w, vv = np.linalg.eig(E)
    r = vv[:, np.argmax(w.real)].reshape(2, 2)
    r = (r + r.conj().T) / 2
    r = r / np.trace(r)
    return float(
        np.einsum("ts,sij,jk,tik->", np.asarray(h, np.complex128), AA, r, AA.conj()).real
    )
