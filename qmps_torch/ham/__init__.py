from .exact import (
    loschmidt_rate,
    tfim_gs_energy_f64,
    xxz_gs_energy,
    xxz_staggered_magnetization,
    xy_gs_energy,
)

__all__ = ["loschmidt_rate", "tfim_gs_energy_f64", "xxz_gs_energy", "xxz_staggered_magnetization",
           "xy_gs_energy"]
