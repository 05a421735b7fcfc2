from .mesh import make_mesh  # noqa: F401
from .sweep import (  # noqa: F401
    multi_start_ground_state,
    phase_diagram_sweep,
    sweep_ground_states,
    sweep_ground_states_fused,
    sweep_ground_states_grown,
    sweep_ground_states_stiefel,
)
