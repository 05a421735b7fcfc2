from .ground_state import (  # noqa: F401
    GroundStateResult,
    find_ground_state,
    ground_state_deep_brickwork,
)
from .evolve import (  # noqa: F401
    MPSTimeEvolve,
    batched_quench_sweep,
    compile_state_to_ansatz,
    loschmidt_echo_run,
)
