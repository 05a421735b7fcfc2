from .excitations import (  # noqa: F401
    dispersion,
    domain_wall_dispersion,
    excitation_matrix,
    spectral_weights,
)
from .imps import iMPS, Map, TransferMatrix  # noqa: F401
from .mpo import (  # noqa: F401
    MPO,
    mpo_exp_decay,
    mpo_from_two_site,
    mpo_heisenberg,
    mpo_nnn_ising,
    mpo_tfim,
    mpo_xxz,
    vumps_ground_state_mpo,
)
from .tdvp import (  # noqa: F401
    split_cell,
    variance_certificate,
    vumps_ground_state,
    vumps_ground_state_cell2,
    vumps_ground_state_converged,
)
from .transfer import dominant_eig_dense, dominant_eig_power  # noqa: F401
