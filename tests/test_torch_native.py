"""qmps_torch.native: the C++ contraction-path planner (a copy of
qmps_tpu/native's), built by g++ into qmps_torch/_build/ at first use,
held to the JAX package's planner path for path (tests/test_native.py's
networks and the brickwork manifold network)."""
import re

import numpy as np
import pytest

from qmps_torch.native import optimal_einsum_path, plan_total_flops

CHAIN = ([[0, 1], [1, 2], [2, 3]], {0: 2, 1: 100, 2: 2, 3: 2}, [0, 3])
HETERO = ([[0, 1, 2], [2, 3], [3, 4, 5], [5, 6], [6, 0], [1, 4]], {0: 3, 1: 8, 2: 17, 3: 2, 4: 9, 5: 5, 6: 11}, [])


def _jax_native():
    import qmps_tpu.native as jn

    if jn._lib() is None:
        pytest.skip("the JAX package's planner did not build")
    return jn


def test_chain_contraction_order():
    """A(2,100) B(100,2) C(2,2): the optimal order contracts AB first."""
    ops, dims, out = CHAIN
    path = optimal_einsum_path(ops, dims, out)
    assert path[0] == "einsum_path" and path[1] == (0, 1)
    rng = np.random.default_rng(0)
    A, B, C = rng.standard_normal((2, 100)), rng.standard_normal((100, 2)), rng.standard_normal((2, 2))
    np.testing.assert_allclose(np.einsum("ij,jk,kl->il", A, B, C, optimize=path), A @ B @ C, atol=1e-12)


def test_optimal_beats_or_matches_greedy():
    ops, dims, out = HETERO
    path = optimal_einsum_path(ops, dims, out)
    alpha = "abcdefghijklmnopqrstuvwxyz"
    sub = ",".join("".join(alpha[i] for i in t) for t in ops) + "->"
    views = [np.zeros([dims[i] for i in t]) for t in ops]
    _, ig = np.einsum_path(sub, *views, optimize="greedy")
    _, io = np.einsum_path(sub, *views, optimize=path)
    fg = float(re.search(r"Optimized FLOP count:\s+([\d.e+]+)", ig).group(1))
    fo = float(re.search(r"Optimized FLOP count:\s+([\d.e+]+)", io).group(1))
    assert fo <= fg * (1 + 1e-12)
    rng = np.random.default_rng(0)
    views = [rng.standard_normal([dims[i] for i in t]) for t in ops]
    np.testing.assert_allclose(np.einsum(sub, *views, optimize=path), np.einsum(sub, *views, optimize="greedy"),
                               rtol=1e-10)


@pytest.mark.parametrize("net", ["chain", "hetero", "manifold"])
def test_paths_and_flops_equal_jax(net):
    jn = _jax_native()
    if net == "manifold":
        from qmps_tpu.circuits.brickwork import _MANIFOLD_OPS

        ops = _MANIFOLD_OPS
        dims, out = {i: 2 for t in ops for i in t}, list(range(12))
    else:
        ops, dims, out = CHAIN if net == "chain" else HETERO
    path = optimal_einsum_path(ops, dims, out)
    assert path == jn.optimal_einsum_path(ops, dims, out)
    assert plan_total_flops(ops, dims, out) == jn.plan_total_flops(ops, dims, out) > 0
    if net == "manifold":
        from qmps_tpu.circuits.brickwork import _MANIFOLD_PATH

        assert len(path) - 1 == 12 and path[1:] == _MANIFOLD_PATH


def test_the_planners_own_limits_return_greedy():
    """Where the planner declines (as the JAX package's does): one operand,
    more than 20, or more than 63 index ids."""
    assert optimal_einsum_path([[0, 1]], {0: 2, 1: 2}, [0]) == "greedy"
    assert optimal_einsum_path([[i, i + 1] for i in range(21)], {i: 2 for i in range(22)}, []) == "greedy"
    wide = [list(range(0, 40)), list(range(30, 70))]
    assert optimal_einsum_path(wide, {i: 2 for i in range(70)}, []) == "greedy"


def test_a_broken_toolchain_raises(monkeypatch, tmp_path):
    """No greedy fallback for a failed build: the loader raises."""
    import qmps_torch.native as nat

    monkeypatch.setattr(nat, "_SO", tmp_path / "libpathfinder.so")
    monkeypatch.setattr(nat, "_BUILD", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))  # no g++ on it
    nat._lib.cache_clear()
    try:
        with pytest.raises((RuntimeError, FileNotFoundError)):
            optimal_einsum_path(*CHAIN)
    finally:
        nat._lib.cache_clear()
