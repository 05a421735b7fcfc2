"""qmps_torch's single-trajectory evolve (algorithms.evolve.MPSTimeEvolve,
compile_state_to_ansatz, loschmidt_echo_run), its checkpoint/resume and
convergence log (utils.checkpoint, utils.logging) and the carrying of
records and checkpoints across (utils.convert), against qmps_tpu at
complex128 and the exact oracles (tests/test_evolve.py,
tests/test_checkpoint_resume.py)."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import to_np
from qmps_torch.algorithms.evolve import EvolveRecord, MPSTimeEvolve, compile_state_to_ansatz, loschmidt_echo_run
from qmps_torch.circuits.ansatze import shallow_full_state
from qmps_torch.embed.unitaries import unitary_to_tensor
from qmps_torch.ham.exact import loschmidt_rate
from qmps_torch.ham.hamiltonian import tfim
from qmps_torch.mps.imps import iMPS
from qmps_torch.utils import checkpoint as tck
from qmps_torch.utils.convert import from_evolve_record, from_tree
from qmps_torch.utils.logging import ConvergenceRecord
from qmps_tpu.algorithms import evolve as jev
from qmps_tpu.ham import tfim as jtfim
from qmps_tpu.utils import checkpoint as jck

FIELDS = ("params", "loschmidt", "evs", "errors")


def _p0(seed=0, scale=0.3):
    return np.random.default_rng(seed).standard_normal(15) * scale


def _jax_run(p0, n, **kw):
    return jev.MPSTimeEvolve(jtfim(0.5), dt=0.05, inner_steps=8).evolve(jnp.asarray(p0), n, **kw)


def _port(**kw):
    return MPSTimeEvolve(tfim(0.5), dt=0.05, inner_steps=8, **kw)


def _assert_matches_jax(rec, rj):
    """loschmidt, evs and errors to 1e-8; params[:, 1:] to 1e-12, and the
    states' tensors to 1e-12 up to their global phase.  params[:, 0] (rz
    on the qubit that enters in |0>) sets only that phase: its gradient is
    rounding (~1e-15), which adam's 1/eps (1e-8) turns into steps of ~3e-9,
    so the two packages' values of it drift apart by up to ~1e-8 (1.03e-8
    under the suite's XLA flags): it is held to 1e-7."""
    for f in ("loschmidt", "evs", "errors"):
        np.testing.assert_allclose(to_np(getattr(rec, f)), np.asarray(getattr(rj, f)), rtol=0, atol=1e-8,
                                   err_msg=f)
    pt, pj = to_np(rec.params), np.array(rj.params)
    np.testing.assert_allclose(pt[:, 1:], pj[:, 1:], rtol=0, atol=1e-12)
    d0 = np.abs(pt[:, 0] - pj[:, 0]).max()
    print("max |d params[:, 0]|", d0)
    assert d0 < 1e-7
    At = to_np(unitary_to_tensor(shallow_full_state(rec.params)))
    Aj = to_np(unitary_to_tensor(shallow_full_state(torch.from_numpy(pj))))
    ph = np.exp(-0.5j * (pt[:, 0] - pj[:, 0]))[:, None, None, None]  # rz(p0)|0> = e^{-i p0 / 2}|0>
    np.testing.assert_allclose(At, Aj * ph, rtol=0, atol=1e-12)


def test_stepper_matches_jax():
    """4 steps of 8 adam steps from the same params0, complex128: the
    record against JAX's (``_assert_matches_jax``)."""
    p0 = _p0()
    rj = _jax_run(p0, 4)
    rt = _port().evolve(torch.from_numpy(p0), 4)
    assert isinstance(rt, EvolveRecord) and rt.params.shape == (5, 15) and rt.evs.shape == (4, 3)
    assert rt.loschmidt.dtype == torch.float64
    _assert_matches_jax(rt, rj)


def test_step_reports_the_loss_at_the_returned_params():
    st = _port()
    p0 = torch.from_numpy(_p0(1))
    p, err = st.step(p0)
    with torch.no_grad():
        from qmps_torch.objectives.overlap import tdvp_objective
        ref = tdvp_objective(st.tensor(p0), st.tensor(p), torch.from_numpy(st.W))
    assert float(err) == float(ref) and -1.0 <= float(err) < 0


def test_kill_and_resume(tmp_path):
    """tests/test_checkpoint_resume.py:13-34: a run killed after 2 of 4
    steps resumes from its checkpoint in a fresh stepper and reproduces
    the uninterrupted run to 1e-12."""
    ckpt = str(tmp_path / "traj.npz")
    p0 = torch.from_numpy(_p0(2, 0.1))
    ref = _port().evolve(p0, 4)
    _port().evolve(p0, 2, checkpoint_path=ckpt, checkpoint_every=1)
    saved = tck.load_checkpoint(ckpt)
    assert int(saved["step"]) == 2 and saved["ps"].shape == (3, 15)
    assert [f for f in os.listdir(tmp_path)] == ["traj.npz"]  # the temporary file is gone
    rec = _port().evolve(p0, 4, checkpoint_path=ckpt, checkpoint_every=2)
    assert rec.params.shape == (5, 15)
    for f in FIELDS:
        np.testing.assert_allclose(to_np(getattr(rec, f)), to_np(getattr(ref, f)), rtol=0, atol=1e-12,
                                   err_msg=f)


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoints_cross_packages(tmp_path, writer):
    """A trajectory checkpointed after 2 steps by one package resumes in the
    other and ends where JAX's uninterrupted 4-step run does (the
    stepper's parity, ``_assert_matches_jax``): the files have one format."""
    ckpt = str(tmp_path / "traj.npz")
    p0 = _p0(3, 0.1)
    ref = _jax_run(p0, 4)
    if writer == "jax":
        _jax_run(p0, 2, checkpoint_path=ckpt, checkpoint_every=1)
        rec = _port().evolve(torch.from_numpy(p0), 4, checkpoint_path=ckpt)
    else:
        _port().evolve(torch.from_numpy(p0), 2, checkpoint_path=ckpt, checkpoint_every=1)
        rec = from_evolve_record(_jax_run(p0, 4, checkpoint_path=ckpt))
    _assert_matches_jax(rec, ref)


def test_checkpoint_format_is_the_jax_packages(tmp_path):
    """Dict keys flatten in sorted order, lists and tuples in order, as
    jax.tree_util does: a tree saved by either package loads in the other
    with every leaf under its own key; ``like`` restores a template's
    structure."""
    tree = {"zeta": np.arange(3.0), "alpha": [np.int64(7), (np.ones((2, 2)), 1.5)],
            "mid": {"b": np.float32(2.0), "a": np.arange(4).reshape(2, 2)}}
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    tck.save_checkpoint(tpath, from_tree(tree))
    jck.save_checkpoint(jpath, tree)
    with np.load(tpath) as zt, np.load(jpath) as zj:
        assert sorted(zt.files) == sorted(zj.files)
        for k in zt.files:
            np.testing.assert_array_equal(zt[k], zj[k])
    back = tck.load_checkpoint(jpath)
    assert to_np(back["mid"]["a"]).tolist() == [[0, 1], [2, 3]] and float(back["alpha"][1][1]) == 1.5
    jback = jck.load_checkpoint(tpath)
    np.testing.assert_array_equal(np.asarray(jback["zeta"]), tree["zeta"])
    like = tck.load_checkpoint(tpath, like=tree)
    assert list(like) == list(tree) and isinstance(like["alpha"][1], tuple)
    assert like["mid"]["b"].dtype == torch.float32 and int(like["alpha"][0]) == 7


def test_convergence_log():
    """tests/test_checkpoint_resume.py:37-44: one finite value a step."""
    log = ConvergenceRecord()
    _port().evolve(torch.from_numpy(_p0(4, 0.1)), 3, log=log)
    assert len(log.values) == 3 and all(np.isfinite(v) for v in log.values)
    assert log.steps_per_sec() > 0 and log.best == min(log.values)


def test_compile_state_to_ansatz():
    """tests/test_evolve.py:24-33: a random left-canonical D = 2 tensor
    compiled into the full15 gate in 600 adam steps reaches overlap
    > 1 - 1e-5.  The start is torch's draw, not JAX's, so the bound is
    held, not the parameters."""
    A = iMPS.random(torch.Generator().manual_seed(0), 2, 2, device="cpu").left_canonicalise()[0]
    p = compile_state_to_ansatz(A, steps=600)
    assert p.shape == (15,) and p.dtype == torch.float64
    ov = float(iMPS([unitary_to_tensor(shallow_full_state(p))]).overlap(iMPS([A])))
    print("compile overlap", ov)
    assert ov > 1 - 1e-5


def test_record_and_checkpoint_trees_carry_across():
    rj = _jax_run(_p0(5, 0.1), 2)
    rec = from_evolve_record(rj, dtype=torch.float32)
    assert all(getattr(rec, f).dtype == torch.float32 for f in FIELDS)
    np.testing.assert_allclose(to_np(rec.loschmidt), np.asarray(rj.loschmidt), rtol=1e-7)
    tree = from_tree({"a": [np.zeros(2), (1.0,)]})
    assert isinstance(tree["a"][1], tuple) and tree["a"][0].dtype == torch.float64


def _rates_within(times, rates, g0, g1):
    exact = loschmidt_rate(to_np(times), g0, g1)
    return np.abs(to_np(rates) - exact).max()


def test_loschmidt_echo_run_cut():
    """tests/test_evolve.py:50-62 cut to what tier 1 affords: 8 of its 20
    steps (t = 0.32) of 100 adam steps, from a 300-step L-BFGS ground state
    of tfim(1.5): within 0.02 of the exact rate at every step."""
    times, rates, rec = loschmidt_echo_run(1.5, 0.2, t_max=0.32, n_steps=8, inner_steps=100, gs_steps=300,
                                           device="cpu")
    assert rates.shape == (8,) and rec.params.shape == (9, 15) and rates.dtype == torch.float64
    np.testing.assert_allclose(to_np(times), np.arange(1, 9) * 0.04, atol=1e-15)
    err = _rates_within(times, rates, 1.5, 0.2)
    print("max |rate - exact|", err)
    assert err < 0.02


@pytest.mark.slow
def test_loschmidt_echo_run_full_size():
    """tests/test_evolve.py:50-62 at its own size: 20 steps to t = 0.8."""
    times, rates, _ = loschmidt_echo_run(1.5, 0.2, t_max=0.8, n_steps=20, inner_steps=100, gs_steps=300,
                                         device="cpu")
    assert _rates_within(times, rates, 1.5, 0.2) < 0.02
    assert float(rates[-1]) > 0.1
