"""Environment representation, the "represent" capability (counterpart of
``qmps_tpu.algorithms.represent``): the RepresentMPS API the reference's
tests import (tests/test_represent.py:6) with its three strategies:

- 'exact':        the transfer fixed point (qmps/tools.py:176-182)
- 'variational':  bloch-tomography matching (qmps/represent.py:18-53)
- 'power':        k-fold transfer application (qmps/represent.py:235-248)
"""
from __future__ import annotations

import torch

from ..embed.unitaries import environment_to_unitary
from ..env.exact import get_env_exact, power_method_env
from ..env.variational import get_env_variational
from ..mps.imps import _cholesky_psd


class RepresentMPS:
    def __init__(self, U: torch.Tensor, strategy: str = "exact", **kwargs):
        self.U = torch.as_tensor(U)
        self.strategy = strategy
        self.kwargs = kwargs
        self.v = None

    def get_env(self) -> torch.Tensor:
        """The environment unitary V (V|00> = vec(C), C C^dag = r)."""
        if self.strategy == "exact":
            self.v = get_env_exact(self.U)
        elif self.strategy == "variational":
            self.v, self.loss = get_env_variational(self.U, **self.kwargs)
        elif self.strategy == "power":
            # the type's jitter: a fixed 1e-14 underflows in float32
            C = _cholesky_psd(power_method_env(self.U, self.kwargs.get("k", 20)))
            self.v = environment_to_unitary(C.reshape(-1))
        else:
            raise ValueError(f"unknown strategy {self.strategy}")
        return self.v
