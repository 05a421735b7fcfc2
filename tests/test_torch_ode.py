"""qmps_torch.core.ode.odeint: the batched Dormand-Prince integrator held
to jax.experimental.ode.odeint (which qmps_tpu.algorithms.scars
integrates with) step for step, to scipy's DOP853 as an oracle, and to
itself row by row (each trajectory steps on its own)."""
import jax
import jax.numpy as jnp
import numpy as np
import torch
from jax.experimental.ode import odeint as jax_odeint

import _torch_parity  # noqa: F401  (one torch thread per worker)
from qmps_torch.algorithms.scars import classical_rhs
from qmps_torch.core.ode import odeint

MU = 0.325


def test_matches_jax_odeint_on_the_scars_equations():
    """The JAX scars test's inputs (tests/test_scars.py:60-69): 4 normal
    starts, 400 times on [0, 20]; JAX's vmapped odeint against one batched
    call, to 1e-8 max(1, |y|)."""
    from qmps_tpu.algorithms.scars import classical_rhs as jax_rhs

    y0s = jax.random.normal(jax.random.PRNGKey(0), (4, 4))
    ts = jnp.linspace(0, 20, 400)
    ref = np.asarray(jax.vmap(lambda y: jax_odeint(lambda y, t: jax_rhs(y, t, MU), y, ts))(y0s))
    out = odeint(lambda y, t: classical_rhs(y, t, MU), torch.tensor(np.asarray(y0s)), torch.tensor(np.asarray(ts)))
    out = out.movedim(0, -2).numpy()
    assert out.shape == ref.shape == (4, 400, 4)
    err = np.abs(out - ref) / np.maximum(1.0, np.abs(ref))
    assert err.max() < 1e-8, err.max()


def test_matches_jax_odeint_with_hmax_and_mxstep():
    """The optional limits: hmax caps every step, mxstep the attempts between
    two output times (a row that runs out stops where it is, as JAX's)."""

    def f_j(y, t):
        return jnp.stack([y[1], -jnp.sin(y[0]) + 0.3 * jnp.cos(1.7 * t)])

    def f_t(y, t):
        return torch.stack([y[..., 1], -torch.sin(y[..., 0]) + 0.3 * torch.cos(1.7 * t)], -1)

    y0s = np.array([[0.3, 0.0], [2.5, -0.4]])
    ts = np.linspace(0.0, 6.0, 31)
    for kw in ({"hmax": 0.05}, {"mxstep": 3}):
        ref = np.stack([np.asarray(jax_odeint(f_j, jnp.asarray(y), jnp.asarray(ts), **kw)) for y in y0s], 1)
        out = odeint(f_t, torch.tensor(y0s), torch.tensor(ts), **kw).numpy()
        np.testing.assert_allclose(out, ref, atol=1e-10, rtol=1e-10, err_msg=str(kw))


def test_matches_scipy_dop853():
    """Against scipy's DOP853 at rtol = atol = 1e-12 on [0, 5], within 1e-6,
    with odeint at the same tolerances (at its default 1.4e-8 the global
    error over [0, 1] is already ~2e-6 on the scars equations)."""
    from scipy.integrate import solve_ivp

    starts = np.array([[0.6, 0.9, 1.1, 0.4], [0.5, 1.2, 0.8, 0.7], [1.0, 0.3, 0.2, 1.3]])
    ts = np.linspace(0.0, 5.0, 101)
    out = odeint(lambda y, t: classical_rhs(y, t, MU), torch.tensor(starts), torch.tensor(ts),
                 rtol=1e-12, atol=1e-12).numpy()
    for k, y0 in enumerate(starts):
        ref = solve_ivp(lambda t, y: classical_rhs(torch.tensor(y), t, MU).numpy(), (0.0, 5.0), y0,
                        method="DOP853", rtol=1e-12, atol=1e-12, t_eval=ts).y.T
        assert np.abs(out[:, k] - ref).max() < 1e-6


def test_rows_step_independently():
    """A fast oscillator beside a slow one: the fast row takes many more
    steps, and each row of the batched call equals its own solve (a shared
    step size would change the slow row's steps and so its rounding)."""

    def oscillator(w):
        return lambda y, t: torch.stack([y[..., 1], -(w**2) * y[..., 0]], -1)

    ws = torch.tensor([1.0, 40.0], dtype=torch.float64)
    ts = torch.linspace(0.0, 2.0, 21, dtype=torch.float64)
    y0 = torch.tensor([[1.0, 0.0], [1.0, 0.0]], dtype=torch.float64)
    both = odeint(oscillator(ws), y0, ts)
    for k in range(2):
        assert torch.equal(both[:, k], odeint(oscillator(ws[k]), y0[k], ts))
    exact = torch.cos(torch.outer(ts, ws))
    assert (both[..., 0] - exact).abs().max() < 1e-5


def test_runs_in_float64():
    out = odeint(lambda y, t: -y, torch.ones(3, 2, dtype=torch.float32), torch.linspace(0, 1, 5))
    assert out.dtype == torch.float64 and out.shape == (5, 3, 2)
    np.testing.assert_allclose(out[-1].numpy(), np.exp(-1.0), rtol=1e-7)
