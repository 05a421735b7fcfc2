"""qmps_torch.utils.flops: the H100's peaks, ``program_costs`` counted from
the dispatched aten operations against XLA's cost model (qmps_tpu's
``program_costs``) on a pure product program and against the hand count,
and ``mfu_fields``' names and arithmetic."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_parity  # noqa: F401  (one torch thread per worker)
from qmps_torch.utils.flops import HBM_BPS, PEAK_F32, PEAK_TF32, mfu_fields, program_costs

SHAPES = [(3, 4, 5), (3, 5, 6), (3, 6, 2)]


def _chain(a, b, c):
    return (a @ b) @ c


def _hand_count(shapes, itemsize):
    (B, m, k), (_, _, n), (_, _, p) = shapes
    macs = B * m * k * n + B * m * n * p
    moved = (B * m * k + B * k * n + B * m * n) + (B * m * n + B * n * p + B * m * p)
    return macs, moved * itemsize


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_product_chain_against_xla_and_the_hand_count(dtype):
    """A batched matmul chain.  Flops: 2 a real multiply-add, as XLA counts;
    8 a complex one, where XLA's cost model counts 2 (it reports a complex
    dot like a real one), so the port's count is 4x XLA's there.  Bytes: each
    product's operands and result."""
    from qmps_tpu.utils.flops import program_costs as xla_costs

    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(s) + (1j * rng.standard_normal(s) if dtype == "complex64" else 0) for s in SHAPES]
    xs = [x.astype(dtype) for x in xs]
    ours = program_costs(_chain, *[torch.from_numpy(x) for x in xs])
    xla = xla_costs(_chain, *[jnp.asarray(x) for x in xs])
    macs, moved = _hand_count(SHAPES, np.dtype(dtype).itemsize)
    per_mac = 8 if dtype == "complex64" else 2
    assert ours["flops"] == per_mac * macs
    assert xla["flops"] == 2 * macs
    assert ours["flops"] == xla["flops"] * per_mac / 2
    assert ours["bytes"] == moved


def test_views_move_nothing_and_elementwise_has_no_flops():
    x = torch.randn(8, 8)
    costs = program_costs(lambda x: x.t().t().reshape(64).sin(), x)
    assert costs["flops"] == 0.0
    assert costs["bytes"] == 2 * 64 * 4  # sin's operand and result; the views none
    copied = program_costs(lambda x: x.t().reshape(64).sin(), x)  # reshape of a transpose copies
    assert copied["bytes"] == 2 * costs["bytes"]


def test_backward_products_are_counted():
    a = torch.randn(4, 5, requires_grad=True)
    b = torch.randn(5, 3)

    def step(a, b):
        (a @ b).sum().backward()

    assert program_costs(step, a, b)["flops"] == 2 * (4 * 5 * 3) * 2  # forward mm and grad mm


def test_peaks_and_mfu_fields():
    assert (PEAK_F32, PEAK_TF32, HBM_BPS) == (67e12, 495e12, 3.35e12)
    f = mfu_fields("row", 1e9, 100.0, PEAK_F32, hbm_bytes_per_call=1e8)
    assert f == {"row_gflops": 100.0, "row_mfu": round(1e11 / 67e12, 4), "row_hbm_gbps": 10.0,
                 "row_hbm_frac": round(1e10 / 3.35e12, 4)}
    from qmps_tpu.utils.flops import mfu_fields as jax_fields

    assert set(jax_fields("row", 1e9, 100.0, 1e12, 1e8)) == set(f)
