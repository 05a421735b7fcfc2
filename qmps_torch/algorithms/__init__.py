from .ground_state import (  # noqa: F401
    GroundStateResult,
    GuessInitialFullParameterOptimizer,
    NoisyNonSparseFullEnergyOptimizer,
    NoisySparseFullEnergyOptimizer,
    NoisySparseSampledEnergyOptimizer,
    NonSparseFullEnergyOptimizer,
    NonSparseFullTwoSiteEnergyOptimizer,
    SparseFullEnergyOptimizer,
    find_ground_state,
    ground_state_deep_brickwork,
)
from .evolve import (  # noqa: F401
    MPSTimeEvolve,
    NoisyMPSTimeEvolve,
    batched_noise_sweep,
    batched_quench_sweep,
    compile_state_to_ansatz,
    loschmidt_echo_run,
    noisy_loschmidt_echo_run,
)
from .represent import RepresentMPS  # noqa: F401
