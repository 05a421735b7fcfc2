"""Old against new: K4, K7 and K8 of two source trees on the same inputs,
on one CUDA card.

    python -m qmps_torch.kernel_ab --old DIR [--out FILE]

DIR is a checkout of an earlier commit (its ``qmps_torch/csrc`` is built
beside this tree's, by the same flags).  Each kernel is timed by CUDA
events over raw launches into preallocated outputs, old and new in turns
(old, new, new, old), after a warm-up, on:
- K4 (with the left vector, batched W): quench-like D = 2 inputs
  (left-canonical A, B the nearest isometry to A + 0.05 noise, W =
  expm(-i h(g1) 0.04), g1 in [0.1, 0.4]) at batches 64 (the quench's) to
  65,536; this tree's K4 also with each of its two layouts forced (the
  source copied with ``kQuadMaxB`` rewritten), to measure where the quad
  layout stops paying;
- K7 and K8: the D = 4 and D = 8 TDVP transfer matrices of 4,096 such
  pairs (the objective's batch), E alone (4,096, this tree's path) and
  [E, E^dag] (8,192, the earlier path).
Every output is checked against the complex128 plain version (lam and the
vectors up to phase) and the largest errors are printed beside the times.
Prints one line per measurement and writes all of them as JSON to FILE
(default ``qmps_torch/_build/kernel_ab.json``, beside the built libraries).
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from .kernels import _lib
from .kernels import pallas_power as tpp
from .kernels import tdvp_fused as tdf
from .mps.transfer import transfer_dense
from .objectives.overlap import mixed_transfer_with_gate
from .parallel.sweep import tfim_matrix

ITERS = 48
K4_BATCHES = (64, 1024, 4096, 6144, 8192, 12288, 16384, 65536)
BIG = 4096


def _left_canonical(rng, B, D):
    x = rng.standard_normal((B, 2 * D, D)) + 1j * rng.standard_normal((B, 2 * D, D))
    V, _ = np.linalg.qr(x)
    return V.reshape(B, D, 2, D).transpose(0, 2, 1, 3)


def _near_isometry(rng, A, eps):
    B, _, D, _ = A.shape
    x = (A + eps * (rng.standard_normal(A.shape) + 1j * rng.standard_normal(A.shape)))
    U, _, Vh = np.linalg.svd(x.transpose(0, 2, 1, 3).reshape(B, 2 * D, D), full_matrices=False)
    return (U @ Vh).reshape(B, D, 2, D).transpose(0, 2, 1, 3)


def _pairs(rng, B, D, eps, dev):
    A = _left_canonical(rng, B, D)
    Bt = _near_isometry(rng, A, eps)
    g1 = torch.from_numpy(rng.uniform(0.1, 0.4, B))
    W = torch.linalg.matrix_exp(-1j * tfim_matrix(g1).to(torch.complex128) * 0.04)
    return [torch.as_tensor(t).to(dev, torch.complex64).contiguous() for t in (A, Bt, W)]


def _ms(fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _in_turns(fns, reps):
    """{name: [t1, t2]}: the names timed in order and back (a, b, b, a)."""
    names = list(fns)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        out[n].append(_ms(fns[n], reps))
    return out


def _phase_err(v, ref):
    ph = (v.conj() * ref).sum(-1)
    v = v * torch.where(ph.abs() > 0, ph / ph.abs(), torch.ones_like(ph))[:, None]
    return (v - ref).abs().max().item()


def _variant(src: Path, quad_max_b: int, root: Path) -> Path:
    """A copy of ``src`` whose K4 launcher takes the quad layout up to
    ``quad_max_b`` elements."""
    dst = root / f"csrc_quad_{quad_max_b}"
    shutil.copytree(src, dst)
    cu = dst / "tdvp_fused.cu"
    text, n = re.subn(r"constexpr int kQuadMaxB = \d+;", f"constexpr int kQuadMaxB = {quad_max_b};",
                      cu.read_text())
    if n != 1:
        raise RuntimeError("kQuadMaxB not found in tdvp_fused.cu")
    cu.write_text(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old", required=True, type=Path, help="checkout of the earlier commit")
    ap.add_argument("--out", type=Path, default=_lib.BUILD_DIR / "kernel_ab.json")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device")
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)

    _lib.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="kernel_ab_", dir=_lib.BUILD_DIR))
    try:
        return _run(args, dev, card, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(args, dev, card, tmp: Path) -> int:
    trees = {"old": args.old / "qmps_torch" / "csrc", "new": _lib.SRC_DIR,
             "quad": _variant(_lib.SRC_DIR, 1 << 30, tmp), "thread": _variant(_lib.SRC_DIR, 0, tmp)}
    with ThreadPoolExecutor(len(trees)) as pool:  # each build runs its own nvcc per source
        built = dict(zip(trees, pool.map(lambda d: _lib.build(d, tmp / "build")[0], trees.values())))
    libs = {k: _lib.load(p) for k, p in built.items()}
    stream = torch.cuda.current_stream().cuda_stream
    rows = []

    # ---- K4 ----
    A, Bt, W = _pairs(np.random.default_rng(6), max(K4_BATCHES), 2, 0.05, dev)
    for n in K4_BATCHES:
        a, b, w = A[:n].contiguous(), Bt[:n].contiguous(), W[:n].contiguous()
        lam_p, v_p, u_p = tdf._fwd_plain(*(t.to(torch.complex128) for t in (a, b, w)), ITERS, True)
        outs = {k: (torch.empty(n, dtype=torch.complex64, device=dev),
                    torch.empty(n, 4, dtype=torch.complex64, device=dev),
                    torch.empty(n, 4, dtype=torch.complex64, device=dev)) for k in libs}

        def launch(k):
            lam, v, u = outs[k]
            return lambda: libs[k].qmps_tdvp_fwd(a.data_ptr(), b.data_ptr(), w.data_ptr(), 16, lam.data_ptr(),
                                                 v.data_ptr(), u.data_ptr(), n, ITERS, 1, stream)

        reps = 200 if n <= 4096 else 50
        times = {**_in_turns({k: launch(k) for k in ("old", "new")}, reps),
                 **_in_turns({k: launch(k) for k in ("thread", "quad")}, reps)}
        for k, (lam, v, u) in outs.items():
            err = max((lam.to(torch.complex128) - lam_p).abs().max().item(),
                      _phase_err(v.to(torch.complex128), v_p), _phase_err(u.to(torch.complex128), u_p))
            rows.append({"kernel": "K4", "tree": k, "batch": n, "ms": times[k], "max_err": err})
            print(f"K4 {k:6s} B = {n:6d}: {times[k][0]:.5f} / {times[k][1]:.5f} ms, max err {err:.3g}",
                  flush=True)

    # ---- K7, K8 on the D = 4 and D = 8 TDVP matrices of 4,096 pairs ----
    rng = np.random.default_rng(11)
    for D, fn, name in ((4, "qmps_matpow_small", "K7"), (8, "qmps_matpow_large", "K8")):
        E = transfer_dense(*mixed_transfer_with_gate(*_pairs(rng, BIG, D, 0.03, dev))).contiguous()
        N = E.shape[-1]
        for tag, X in (("E", E), ("[E, E^dag]", torch.cat([E, E.mH]).resolve_conj().contiguous())):
            n = X.shape[0]
            X64 = X.to(torch.complex128)
            lam_p, v_p = tpp._extract_eigpair(X64, tpp._matrix_power_plain(X64, ITERS))
            outs = {k: torch.empty_like(X) for k in ("old", "new")}

            def launch(k):
                f = getattr(libs[k], fn)
                if fn == "qmps_matpow_small":
                    return lambda: f(X.data_ptr(), outs[k].data_ptr(), n, N, ITERS, stream)
                return lambda: f(X.data_ptr(), outs[k].data_ptr(), None, n, N, ITERS, stream)

            times = _in_turns({k: launch(k) for k in ("old", "new")}, 20 if name == "K7" else 5)
            for k, M in outs.items():
                lam, v = tpp._extract_eigpair(X64, M.to(torch.complex128))
                err_lam = (lam - lam_p).abs().max().item()
                err_v = _phase_err(v, v_p)
                rows.append({"kernel": name, "tree": k, "batch": n, "input": tag, "ms": times[k],
                             "lam_err": err_lam, "v_err": err_v})
                print(f"{name} {k:3s} {tag:10s} ({n} x {N}x{N}): {times[k][0]:.5f} / {times[k][1]:.5f} ms, "
                      f"lam err {err_lam:.3g}, v err {err_v:.3g}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
