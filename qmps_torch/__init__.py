"""qmps_torch — the PyTorch/CUDA port of ``qmps_tpu``.

Same module paths and function names as ``qmps_tpu``; PyTorch inside:
plain functions on tensors, an explicit ``device=``, explicit
``torch.Generator``s and ``torch.autograd.Function`` where JAX had a
``custom_vjp``.  The hot kernels are hand-written CUDA C++ for Hopper
(``csrc/``, built at first use by ``kernels/_lib.py``); each has a plain
PyTorch version beside it, which runs for tensors that lie on the CPU.

This package never imports JAX.
"""
import torch

# Full-f32 products everywhere: reduced-precision (TF32) passes break the
# repeated-squaring fixed points, as bf16 passes did on the TPU
# (qmps_tpu/__init__.py, docs/DESIGN.md section 3).
torch.set_float32_matmul_precision("highest")
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__version__ = "0.1.0"

from . import config  # noqa: E402,F401
