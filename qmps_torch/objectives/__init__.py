from .energy import (  # noqa: F401
    energy_circuit,
    energy_exact_env,
    energy_joint_env_purity,
    energy_two_site,
)
from .overlap import (  # noqa: F401
    hadamard_test_amplitude,
    tdvp_objective,
    tdvp_objective_circuit,
)
