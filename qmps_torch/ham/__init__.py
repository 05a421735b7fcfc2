from .hamiltonian import (  # noqa: F401
    Hamiltonian,
    block_two_site,
    heisenberg,
    scars_H,
    sublattice_rotate,
    tfim,
    xxz,
    xy,
)
from .exact import (  # noqa: F401
    loschmidt_rate,
    tfim_gs_energy,
    tfim_gs_energy_f64,
    xxz_gs_energy,
    xxz_staggered_magnetization,
    xy_gs_energy,
)
