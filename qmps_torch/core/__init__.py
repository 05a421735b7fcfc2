from . import gates, lie, linalg, paulis  # noqa: F401
