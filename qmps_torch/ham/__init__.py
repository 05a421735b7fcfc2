from .exact import tfim_gs_energy_f64

__all__ = ["tfim_gs_energy_f64"]
