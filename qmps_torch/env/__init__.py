from .exact import get_env_exact, get_env_exact_C, power_method_env  # noqa: F401
from .variational import (  # noqa: F401
    env_M_ansatz,
    represent_variational_M,
    tomography_env_objective,
    trace_distance_objective,
    variational_fixed_point,
)
