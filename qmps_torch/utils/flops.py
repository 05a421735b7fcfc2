"""Analytic FLOP/byte accounting and the H100's roofline constants
(counterpart of ``qmps_tpu.utils.flops``, whose constants are a TPU v5e's).

Peaks (NVIDIA's H100 SXM data sheet; the constants ``chip_smoke.py``
bounds its kernels with):

- ``PEAK_F32``: 67e12 FLOP/s, float32 on the CUDA cores.  The port pins
  full-float32 products (``torch.set_float32_matmul_precision("highest")``,
  ``qmps_torch/__init__.py``), so cuBLAS runs its float32 and complex64
  products there: MFU of a product-bound program is read against this.
- ``PEAK_TF32``: 495e12 FLOP/s, TF32 on the tensor cores (dense), the
  rate of a product run under the "default" precision tier.
- ``HBM_BPS``: 3.35e12 bytes/s of device memory.

``program_costs(fn, *args)`` counts the FLOPs and bytes of the aten
operations ``fn`` dispatches (forward, and backward and optimizer steps
if ``fn`` runs them), under a ``TorchDispatchMode``:

- FLOPs are those of the products only (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, ``addbmm``, ``mv``, ``addmv``, ``dot``, ``vdot``): 2 a real
  multiply-add and 8 a complex one (its real-FLOP content).  Elementwise
  operations, reductions and factorizations are not counted.  XLA's cost
  model, which ``qmps_tpu``'s ``program_costs`` reads, counts a complex
  product like a real one (2 a multiply-add; jax 0.9 on the CPU), so on
  complex products the two differ by a factor of 4, and on real ones not.
- Bytes are each operation's tensor operands plus its results; views
  (``expand``, ``transpose``, ``view``, ...) move nothing and are skipped.
"""
from __future__ import annotations

from typing import Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

PEAK_F32 = 67e12
PEAK_TF32 = 495e12
HBM_BPS = 3.35e12

_aten = torch.ops.aten
_PRODUCTS = {
    _aten.mm, _aten.bmm, _aten.addmm, _aten.baddbmm, _aten.addbmm, _aten.mv, _aten.addmv,
    _aten.dot, _aten.vdot,
}
_VIEWS = {_aten._unsafe_view}


def _product_macs(packet, args) -> int:
    """Multiply-adds of one product: the contracted operands are the last
    two tensor arguments (addmm's first is the added term)."""
    a, b = [t for t in args if isinstance(t, torch.Tensor)][-2:]
    if packet in (_aten.dot, _aten.vdot, _aten.mv, _aten.addmv):
        return a.numel()
    if packet in (_aten.bmm, _aten.baddbmm, _aten.addbmm):
        return a.shape[0] * a.shape[1] * a.shape[2] * b.shape[2]
    return a.shape[0] * a.shape[1] * b.shape[1]


class _Costs(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if func.is_view or func.overloadpacket in _VIEWS:
            return out
        ins = [t for t in tree_flatten((args, kwargs))[0] if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        self.bytes += sum(t.numel() * t.element_size() for t in ins + outs)
        if func.overloadpacket in _PRODUCTS:
            per_mac = 8 if outs[0].is_complex() else 2
            self.flops += per_mac * _product_macs(func.overloadpacket, args)
        return out


def program_costs(fn: Callable, *args) -> dict:
    """{"flops": float, "bytes": float} of ``fn(*args)``, counted from the
    operations it dispatches (one call, run for real)."""
    with _Costs() as costs:
        fn(*args)
    return {"flops": float(costs.flops), "bytes": float(costs.bytes)}


def mfu_fields(prefix: str, flops_per_call: float, calls_per_sec: float,
               peak: float, hbm_bytes_per_call: float | None = None) -> dict:
    """Derived bench fields for one row: achieved GFLOP/s, MFU against the
    given peak, and (where the bytes a call moves are known) achieved
    memory GB/s and its fraction of ``HBM_BPS``."""
    rate = flops_per_call * calls_per_sec
    out = {
        f"{prefix}_gflops": round(rate / 1e9, 1),
        f"{prefix}_mfu": round(rate / peak, 4),
    }
    if hbm_bytes_per_call is not None:
        bw = hbm_bytes_per_call * calls_per_sec
        out[f"{prefix}_hbm_gbps"] = round(bw / 1e9, 1)
        out[f"{prefix}_hbm_frac"] = round(bw / HBM_BPS, 4)
    return out
