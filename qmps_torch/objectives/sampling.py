"""Finite-shot (sampled) measurements (counterpart of
``qmps_tpu.objectives.sampling``).

Shot-noise emulation of the reference's sampled objectives: bloch-vector
tomography (qmps/tools.py:308-332), Pauli-string energy measurement
(qmps/ground_state.py:32-108), the destructive swap test
(qmps/qiskit_qmps.py:64-130) and sampled TDVP amplitudes
(scripts/loschmidt.py:279-318).  Shots are ``torch.multinomial`` over the
exact distribution, or ``torch.bernoulli`` on one probability, on the
state's device from the caller's ``torch.Generator`` (which must lie on
that device); each call advances it, so every evaluation draws fresh shot
noise.
"""
from __future__ import annotations

import torch

from ..circuits.ir import apply_unitary, circuit_state, n_qubits
from ..core import gates as g


def _gate(U: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return U.to(like.device, like.dtype)


def sample_bitstrings(generator: torch.Generator, psi: torch.Tensor, shots: int) -> torch.Tensor:
    """(shots,) basis-state indices sampled from |psi|^2."""
    return torch.multinomial(psi.detach().abs().square(), shots, replacement=True, generator=generator)


def sampled_qubit_z(generator: torch.Generator, psi: torch.Tensor, qubit: int, n: int, shots: int) -> torch.Tensor:
    """The mean measured bit of one qubit (z basis)."""
    bits = (sample_bitstrings(generator, psi, shots) >> (n - 1 - qubit)) & 1
    return bits.to(psi.real.dtype).mean()


def _y_basis(psi: torch.Tensor, qubit: int, n: int) -> torch.Tensor:
    psi = apply_unitary(psi, _gate(g.S_DAG, psi), (qubit,), n)
    return apply_unitary(psi, _gate(g.H, psi), (qubit,), n)


def sampled_bloch_vector(generator: torch.Generator, psi: torch.Tensor, qubit: int, n: int,
                         shots: int = 10**6) -> torch.Tensor:
    """-2 <bit> + 1 in the x, y and z bases (qmps/tools.py:308-332
    conventions); z is drawn first, then y, then x."""
    z = sampled_qubit_z(generator, psi, qubit, n, shots)
    y = sampled_qubit_z(generator, _y_basis(psi, qubit, n), qubit, n, shots)
    x = sampled_qubit_z(generator, apply_unitary(psi, _gate(g.H, psi), (qubit,), n), qubit, n, shots)
    return -2 * torch.stack([x, y, z]) + 1


def pauli_measure_ops(string: str):
    """The basis change after which measuring qubit 0 in z reads the
    2-qubit Pauli string (PauliMeasure gate, qmps/ground_state.py:32-64)."""
    if len(string) != 2 or string == "II":
        raise ValueError(f"need a 2-qubit Pauli string other than 'II', got {string!r}")
    i, j = string
    ops = []
    if i == "I":
        ops.append((g.SWAP, (0, 1)))
        i, j = j, i
    for ch, q in ((i, 0), (j, 1)):
        if ch == "X":
            ops.append((g.H, (q,)))
        elif ch == "Y":
            ops.append((g.S_DAG, (q,)))
            ops.append((g.H, (q,)))
    if i != "I" and j != "I":
        ops.append((g.CNOT, (1, 0)))
    return ops


def _measured_state(string: str, psi: torch.Tensor, qubits) -> torch.Tensor:
    """psi after ``pauli_measure_ops(string)`` on ``qubits``."""
    n = n_qubits(psi)
    for U, wires in pauli_measure_ops(string):
        psi = apply_unitary(psi, _gate(U, psi), tuple(qubits[w] for w in wires), n)
    return psi


def measure_energy(generator: torch.Generator, strings: dict, psi: torch.Tensor, qubits=(1, 2),
                   shots: int = 300000) -> torch.Tensor:
    """Sampled <H> of a Pauli-string Hamiltonian on two adjacent qubits of
    psi (Hamiltonian.measure_energy, qmps/ground_state.py:97-108): each
    string measured with ``shots`` shots, in the order of ``strings``."""
    n = n_qubits(psi)
    ev = torch.zeros((), dtype=psi.real.dtype, device=psi.device)
    for string, coef in strings.items():
        b = sampled_qubit_z(generator, _measured_state(string, psi, qubits), qubits[0], n, shots)
        ev = ev + complex(coef).real * (1 - 2 * b)
    return ev


def _swap_test_state(psi1: torch.Tensor, psi2: torch.Tensor) -> torch.Tensor:
    """psi1 (x) psi2 after CNOT and H between the two registers' qubit 0."""
    n1 = n_qubits(psi1)
    n = n1 + n_qubits(psi2)
    psi = torch.kron(psi1, psi2)
    psi = apply_unitary(psi, _gate(g.CNOT, psi), (0, n1), n)
    return apply_unitary(psi, _gate(g.H, psi), (0,), n)


def swap_test_p11(generator: torch.Generator, psi1: torch.Tensor, psi2: torch.Tensor, shots: int) -> torch.Tensor:
    """Destructive swap test: P(11) across the two registers' qubit 0
    estimates (1 - Tr[rho sigma]) / 2 (qmps/qiskit_qmps.py:64-130)."""
    n1 = n_qubits(psi1)
    n = n1 + n_qubits(psi2)
    psi = _swap_test_state(psi1, psi2)
    idx = sample_bitstrings(generator, psi, shots)
    b0 = (idx >> (n - 1)) & 1
    b1 = (idx >> (n - 1 - n1)) & 1
    return (b0 * b1).to(psi.real.dtype).mean()


def sampled_trace_distance(generator: torch.Generator, U: torch.Tensor, V: torch.Tensor,
                           shots: int = 10**5) -> torch.Tensor:
    """Sampled Tr[(rho - sigma)^2] by three destructive swap tests
    (trace_distance_cost_function, qmps/represent.py:116-175): r_s, r^2 and
    s^2 from P(11), the score r^2 + s^2 - 2 r_s."""
    from ..env.variational import state_circuit_psi

    kv = n_qubits(V)
    psi_state = state_circuit_psi(U, V, 1)
    psi_env = circuit_state([(V, tuple(range(kv)))], kv)
    rs = 1 - 2 * swap_test_p11(generator, psi_state, psi_env, shots)
    rr = 1 - 2 * swap_test_p11(generator, psi_state, psi_state, shots)
    ss = 1 - 2 * swap_test_p11(generator, psi_env, psi_env, shots)
    return (rr + ss - 2 * rs).abs()


def sampled_p0(generator: torch.Generator, psi: torch.Tensor, shots: int) -> torch.Tensor:
    """The fraction of all-zero outcomes (the sampled TDVP amplitude
    estimator, scripts/loschmidt.py:315-317)."""
    return (sample_bitstrings(generator, psi, shots) == 0).to(psi.real.dtype).mean()


def sampled_noisy_p0(generator: torch.Generator, rho: torch.Tensor, shots: int) -> torch.Tensor:
    """Sampled P(0...0) of a density matrix: binomial shot noise on the
    exact probability rho[0, 0]."""
    p0 = rho[..., 0, 0].real.detach().clamp(0.0, 1.0)
    return torch.bernoulli(p0.expand(shots), generator=generator).mean()
