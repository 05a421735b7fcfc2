from .minimize import OptResult, minimize_adam, minimize_lbfgs, minimize_scipy  # noqa: F401
from .rotosolve import double_rotosolve, rotosolve  # noqa: F401
