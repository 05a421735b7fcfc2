from .brickwork_fast import manifold_overlap_batched  # noqa: F401
from .brickwork_pallas import manifold_overlap_pallas  # noqa: F401
from .tdvp_fused import tdvp_objective_fused  # noqa: F401
from .energy_fused import energy_objective_fused  # noqa: F401
