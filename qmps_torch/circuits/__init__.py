from .ir import apply_unitary, circuit_state, circuit_unitary  # noqa: F401
from . import ansatze, hardware  # noqa: F401
