"""Old against new: K1-K8 of two source trees on the same inputs, on one
CUDA card.

    python -m qmps_torch.kernel_ab --old DIR [--out FILE]

DIR is a checkout of an earlier commit (its ``qmps_torch/csrc`` is built
beside this tree's, by the same flags).  Each kernel is timed by CUDA
events over raw launches into preallocated outputs, queued behind a spin
kernel so that the card runs them back to back (the device's time a
launch, not the host's launch rate, which sets the pace of a kernel of a
few microseconds), old and new in turns (old, new, new, old), after a
warm-up, on:
- K4 (with the left vector, batched W) and K5 (on K4's complex128 lam, v
  and u, rounded): quench-like D = 2 inputs (left-canonical A, B the
  nearest isometry to A + 0.05 noise, W = expm(-i h(g1) 0.04), g1 in
  [0.1, 0.4]) at batches 64 (the quench's) to 65,536;
- K2 and K3 (on the complex128 forward's lam and v, rounded, and a
  cotangent that varies by element): the sweep's kind of inputs
  (left-canonical A, h the TFIM matrix of g in [0.1, 2.0]) at batches
  1,024 to 65,536 (the sweep's is 4,096);
- this tree's K1-K4 and K7 also with each layout forced: the source
  copied with the limits of ``LAYOUT_LIMITS`` rewritten, "quad" with the
  new layout everywhere (K1-K4 a quad of lanes an element at every batch,
  K7 the tensor cores at every N) and "thread" with the old one (one
  thread an element, K7 the CUDA cores), to measure where the new layout
  stops paying (K5 has one layout, 16 lanes an element, and K6 one, its
  W product on the tensor cores);
- K1 (squaring, 40 squarings, no left vector: the represent step's call):
  the transfer matrices of seeded left-canonical D = 2 tensors at batches
  1,024 (the sweep's represent step) to 65,536;
- K6: config 5's inputs (``workloads.BrickworkConfig``) at its 16,384 and
  at bench.py's 65,536;
- K7: random complex normal matrices scaled by 1/sqrt(N), 4,096 at each of
  N = 9, 12, 13, 16, and K7 and K8 on the D = 4 and D = 8 TDVP transfer
  matrices of 4,096 such pairs (the objective's batch), E alone (4,096,
  this tree's path) and [E, E^dag] (8,192, the earlier path); K8 above
  N = 64 on 133 random 256 x 256 matrices;
- an empty kernel on K5's grid at 64 elements, queued and not: the floor
  of the card's and of the host's launch rate.
Each tree is called through its own interface (``_interface``): an earlier
tree's K1 may take no left-vector output, and its K6 U2's and conj(U2p)'s
column 0 as (B, 4) tensors where this tree's takes U2 and U2p whole.
Every output is checked against the complex128 plain version (lam and the
vectors up to phase; K5's cotangents scaled by max(1, the element's
largest)) and the largest errors are printed beside the times.  Prints one
line per measurement and writes all of them as JSON to FILE (default
``qmps_torch/_build/kernel_ab.json``, beside the built libraries).
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
from .kernels import energy_fused as tef
from .kernels import pallas_power as tpp
from .kernels import tdvp_fused as tdf
from .kernels.brickwork_fast import manifold_overlap_batched
from .mps.transfer import transfer_dense
from .objectives.overlap import mixed_transfer_with_gate
from .parallel.sweep import tfim_matrix
from .workloads import BrickworkConfig

ITERS = 48
#: ~10 ms of the card's clock: longer than the host takes to queue 200 raw launches
SLEEP_CYCLES = 20_000_000
K4_BATCHES = (64, 1024, 4096, 6144, 8192, 12288, 16384, 65536)
K5_BATCHES = (64, 1024, 4096, 8192, 16384, 65536)
K2_BATCHES = (1024, 4096, 6144, 8192, 12288, 16384, 65536)
K1_BATCHES, K1_ITERS = (1024, 4096, 8192, 16384, 65536), 40
K6_BATCHES = (16384, 65536)
K7_NS = (9, 12, 13, 16)
#: the limits of the new layouts, rewritten to force a layout: constant ->
#: (its value with the new layout everywhere, with the old one everywhere)
LAYOUT_LIMITS = {"tdvp_fused.cu": {"kQuadMaxB": (1 << 30, 0)},
                 "energy_fused.cu": {"kEnergyQuadMaxB": (1 << 30, 0), "kEnergyBwdQuadMaxB": (1 << 30, 0)},
                 "matpow.cu": {"kMatpowTcMinN": (0, 1 << 30)},
                 "pallas_power.cu": {"kDominantQuadMaxB": (1 << 30, 0)}}
#: the earlier K1 entry point's argument types (no left-vector output)
_K1_NO_LEFT = [_lib._P, _lib._P, _lib._P, _lib._I, _lib._I, _lib._I, _lib._P]
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


def _ms(fn, reps, queued=True):
    """Mean time of fn over reps launches after a warm-up, by CUDA events;
    ``queued``: the launches wait behind a spin kernel (torch.cuda._sleep),
    so the events time the card's work, not the host's launches."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
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


def matpow_large_launcher(lib, X, out, work, iters, stream):
    """One raw launch of ``lib``'s K8 (``qmps_matpow_large``) on X (B, N, N)
    into out; ``work`` a workspace of ``pallas_power.matpow_work_floats(B,
    N)`` floats above N = 64 (an earlier tree may use fewer of them), None
    below."""
    n, N = X.shape[0], X.shape[-1]
    w = None if work is None else work.data_ptr()
    return lambda: lib.qmps_matpow_large(X.data_ptr(), out.data_ptr(), w, n, N, iters, stream)


def _phase_err(v, ref):
    ph = (v.conj() * ref).sum(-1)
    v = v * torch.where(ph.abs() > 0, ph / ph.abs(), torch.ones_like(ph))[:, None]
    return (v - ref).abs().max().item()


def _interface(src: Path) -> dict:
    """Which interface a tree's K1 and K6 entry points have, read off their
    C declarations: ``k1_left`` (a left-vector output after v) and
    ``k6_columns`` (U2's and conj(U2p)'s column 0 passed as (B, 4) tensors)."""
    k1 = (src / "pallas_power.cu").read_text()
    k6 = (src / "brickwork_overlap.cu").read_text()
    return {"k1_left": "void* v, void* w, int B" in k1, "k6_columns": "const void* c2" in k6}


def _variant(src: Path, new: bool, name: str, root: Path) -> Path:
    """A copy of ``src`` whose launchers take the ``new`` layouts (else the
    old ones) everywhere: every constant of ``LAYOUT_LIMITS`` rewritten."""
    dst = root / f"csrc_{name}"
    shutil.copytree(src, dst)
    for fname, consts in LAYOUT_LIMITS.items():
        cu = dst / fname
        text = cu.read_text()
        for c, values in consts.items():
            limit = values[0 if new else 1]
            text, n = re.subn(rf"constexpr int {c} = [^;]+;", f"constexpr int {c} = {limit};", text)
            if n != 1:
                raise RuntimeError(f"{c} not found in {fname}")
        cu.write_text(text)
    return dst


def _timed_rows(rows, kernel, n, launch, outs, err_of, reps, layouts=True):
    """Time ``launch(tree)`` old/new and (``layouts``) thread/quad in turns,
    check each tree's outputs with ``err_of``, and append and print one row
    a tree."""
    times = _in_turns({k: launch(k) for k in ("old", "new")}, reps)
    if layouts:
        times.update(_in_turns({k: launch(k) for k in ("thread", "quad")}, reps))
    for k in times:
        err = err_of(outs[k])
        rows.append({"kernel": kernel, "tree": k, "batch": n, "ms": times[k], "max_err": err})
        print(f"{kernel} {k:6s} B = {n:6d}: {times[k][0]:.5f} / {times[k][1]:.5f} ms, max err {err:.3g}", flush=True)


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
             "quad": _variant(_lib.SRC_DIR, True, "quad", tmp), "thread": _variant(_lib.SRC_DIR, False, "thread", tmp)}
    with ThreadPoolExecutor(len(trees)) as pool:  # each build runs its own nvcc per source
        built = dict(zip(trees, pool.map(lambda d: _lib.build(d, tmp / "build")[0], trees.values())))
    libs = {k: _lib.load(p, strict=k != "old") for k, p in built.items()}
    abi = {k: _interface(d) for k, d in trees.items()}
    for k in libs:
        if not abi[k]["k1_left"]:
            libs[k].qmps_dominant_eig.argtypes = _K1_NO_LEFT
    stream = torch.cuda.current_stream().cuda_stream
    rows = []

    # ---- K1 on the transfer matrices of left-canonical D = 2 tensors ----
    c128 = torch.complex128
    A1 = torch.from_numpy(_left_canonical(np.random.default_rng(0), max(K1_BATCHES), 2)).to(dev, torch.complex64)
    E1 = transfer_dense(A1, A1).contiguous()
    for n in K1_BATCHES:
        E = E1[:n]
        lam_p, v_p = tpp._dominant_eig_plain(E.to(c128), K1_ITERS)
        outs = {k: (torch.empty(n, dtype=torch.complex64, device=dev),
                    torch.empty(n, 4, dtype=torch.complex64, device=dev)) for k in libs}

        def launch1(k):
            lam, v = outs[k]
            if abi[k]["k1_left"]:
                return lambda: libs[k].qmps_dominant_eig(E.data_ptr(), lam.data_ptr(), v.data_ptr(), None, n,
                                                         K1_ITERS, 0, stream)
            return lambda: libs[k].qmps_dominant_eig(E.data_ptr(), lam.data_ptr(), v.data_ptr(), n, K1_ITERS, 0,
                                                     stream)

        def err1(o):
            return max((o[0].to(c128) - lam_p).abs().max().item(), _phase_err(o[1].to(c128), v_p))

        _timed_rows(rows, "K1", n, launch1, outs, err1, 200 if n <= 4096 else 50)

    # ---- K4, K5 ----
    A, Bt, W = _pairs(np.random.default_rng(6), max(K4_BATCHES), 2, 0.05, dev)
    for n in sorted(set(K4_BATCHES) | set(K5_BATCHES)):
        a, b, w = A[:n].contiguous(), Bt[:n].contiguous(), W[:n].contiguous()
        a2, b2, w2 = (t.to(c128) for t in (a, b, w))
        lam_p, v_p, u_p = tdf._fwd_plain(a2, b2, w2, ITERS, True)
        reps = 200 if n <= 4096 else 50
        if n in K4_BATCHES:
            outs = {k: (torch.empty(n, dtype=torch.complex64, device=dev),
                        torch.empty(n, 4, dtype=torch.complex64, device=dev),
                        torch.empty(n, 4, dtype=torch.complex64, device=dev)) for k in libs}

            def launch4(k):
                lam, v, u = outs[k]
                return lambda: libs[k].qmps_tdvp_fwd(a.data_ptr(), b.data_ptr(), w.data_ptr(), 16, lam.data_ptr(),
                                                     v.data_ptr(), u.data_ptr(), n, ITERS, 1, stream)

            def err4(o):
                lam, v, u = (t.to(c128) for t in o)
                return max((lam - lam_p).abs().max().item(), _phase_err(v, v_p), _phase_err(u, u_p))

            _timed_rows(rows, "K4", n, launch4, outs, err4, reps)
        if n in K5_BATCHES:
            lam, v, u = (t.to(torch.complex64).contiguous() for t in (lam_p, v_p, u_p))
            ct = torch.ones(n, device=dev)
            bars_p = tdf._bwd_plain(a2, b2, w2, lam.to(c128), v.to(c128), u.to(c128), ct.double())
            outs = {k: [torch.empty(n, 2, 2, 2, dtype=torch.complex64, device=dev),
                        torch.empty(n, 2, 2, 2, dtype=torch.complex64, device=dev),
                        torch.empty(n, 4, 4, dtype=torch.complex64, device=dev)] for k in ("old", "new")}

            def launch5(k):
                ab, bb, wb = outs[k]
                return lambda: libs[k].qmps_tdvp_bwd(a.data_ptr(), b.data_ptr(), w.data_ptr(), 16, v.data_ptr(),
                                                     u.data_ptr(), lam.data_ptr(), ct.data_ptr(), ab.data_ptr(),
                                                     bb.data_ptr(), wb.data_ptr(), n, stream)

            def err5(o):
                return max(((x.to(c128) - p).abs().reshape(n, -1).max(1).values
                            / p.abs().reshape(n, -1).max(1).values.clamp(min=1.0)).max().item()
                           for x, p in zip(o, bars_p))

            _timed_rows(rows, "K5", n, launch5, outs, err5, reps, layouts=False)

    # ---- the launch floor at the quench's 64 ----
    for queued in (True, False):
        t = _ms(lambda: libs["new"].qmps_empty(64, stream), 200, queued)
        rows.append({"kernel": "empty", "tree": "new", "batch": 64, "queued": queued, "ms": [t]})
        print(f"empty kernel on K5's grid, B = 64, {'queued' if queued else 'raw launches'}: {t:.5f} ms", flush=True)

    # ---- K2 ----
    rng = np.random.default_rng(4)
    nmax = max(K2_BATCHES)
    A2 = torch.from_numpy(_left_canonical(rng, nmax, 2)).to(dev, torch.complex64).contiguous()
    H2 = tfim_matrix(torch.linspace(0.1, 2.0, nmax, dtype=torch.float64)).to(dev, torch.complex64).contiguous()
    for n in K2_BATCHES:
        a, h = A2[:n].contiguous(), H2[:n].contiguous()
        e_p, lam_p, v_p = tef._fwd_plain(a.to(c128), h.to(c128), ITERS)
        outs = {k: (torch.empty(n, dtype=torch.float32, device=dev),
                    torch.empty(n, dtype=torch.complex64, device=dev),
                    torch.empty(n, 4, dtype=torch.complex64, device=dev)) for k in libs}

        def launch2(k):
            e, lam, v = outs[k]
            return lambda: libs[k].qmps_energy_fwd(a.data_ptr(), h.data_ptr(), e.data_ptr(), lam.data_ptr(),
                                                   v.data_ptr(), n, ITERS, stream)

        def err2(o):
            e, lam, v = o
            return max((e.double() - e_p).abs().max().item(), (lam.to(c128) - lam_p).abs().max().item(),
                       (v.to(c128) - v_p).abs().max().item())

        _timed_rows(rows, "K2", n, launch2, outs, err2, 200 if n <= 4096 else 50)

        lam, v = lam_p.to(torch.complex64), v_p.to(torch.complex64)
        ct = torch.linspace(0.5, 1.5, n, device=dev)
        bars_p = tef._bwd_plain(a.to(c128), h.to(c128), lam.to(c128), v.to(c128), ct.double())
        outs = {k: (torch.empty(n, 2, 2, 2, dtype=torch.complex64, device=dev),
                    torch.empty(n, 4, 4, dtype=torch.complex64, device=dev)) for k in libs}

        def launch3(k):
            abar, hbar = outs[k]
            return lambda: libs[k].qmps_energy_bwd(a.data_ptr(), h.data_ptr(), v.data_ptr(), lam.data_ptr(),
                                                   ct.data_ptr(), abar.data_ptr(), hbar.data_ptr(), n,
                                                   tef.SERIES_K, stream)

        def err3(o):  # hbar absolute, Abar scaled by max(1, the element's largest), as chip_smoke gates them
            return max(((x.to(c128) - p).abs().reshape(n, -1).max(1).values
                        / (p.abs().reshape(n, -1).max(1).values.clamp(min=1.0) if x.dim() == 4 else 1.0)).max().item()
                       for x, p in zip(o, bars_p))

        _timed_rows(rows, "K3", n, launch3, outs, err3, 200 if n <= 4096 else 50)

    # ---- K6 on config 5's inputs ----
    for n in K6_BATCHES:
        U1, U2, U1p, U2p, Mr, Ml, W = BrickworkConfig(batch=n).inputs()
        c2, r2 = U2[:, :, 0].contiguous(), U2p[:, :, 0].conj().resolve_conj().contiguous()
        ref = manifold_overlap_batched(*(t.to(c128) for t in (U1, U2, U1p, U2p, Mr, Ml, W)))
        outs = {k: torch.empty(n, dtype=torch.complex64, device=dev) for k in ("old", "new")}

        def launch6(k):
            u2, u2p = (c2, r2) if abi[k]["k6_columns"] else (U2, U2p)
            return lambda: libs[k].qmps_brickwork_overlap(U1.data_ptr(), u2.data_ptr(), U1p.data_ptr(), u2p.data_ptr(),
                                                          Ml.data_ptr(), Mr.data_ptr(), W.data_ptr(),
                                                          outs[k].data_ptr(), n, stream)

        _timed_rows(rows, "K6", n, launch6, outs, lambda o: (o.to(c128) - ref).abs().max().item(), 200,
                    layouts=False)

    # ---- K7 on random N x N matrices, K7 and K8 on the D = 4 and D = 8 TDVP matrices of 4,096 pairs ----
    rng, sets = np.random.default_rng(11), []
    for D, name in ((4, "K7"), (8, "K8")):
        E = transfer_dense(*mixed_transfer_with_gate(*_pairs(rng, BIG, D, 0.03, dev))).contiguous()
        sets += [(name, f"D = {D} E", E), (name, f"D = {D} [E, E^dag]", torch.cat([E, E.mH]).resolve_conj().contiguous())]
    sets += [("K7", f"random N = {N}", torch.from_numpy(
        (rng.standard_normal((BIG, N, N)) + 1j * rng.standard_normal((BIG, N, N))) / np.sqrt(N)).to(dev, torch.complex64))
        for N in K7_NS]
    sets.append(("K8", "random N = 256", torch.from_numpy(
        (rng.standard_normal((133, 256, 256)) + 1j * rng.standard_normal((133, 256, 256))) / 16).to(dev, torch.complex64)))
    for name, tag, X in sets:
        n, N = X.shape[0], X.shape[-1]
        X64 = X.to(torch.complex128)
        lam_p, v_p = tpp._extract_eigpair(X64, tpp._matrix_power_plain(X64, ITERS))
        # K7's "quad" tree squares on the tensor cores at every N, its "thread"
        # tree on the CUDA cores
        trees = ("old", "new", "thread", "quad") if name == "K7" and "dag" not in tag else ("old", "new")
        outs = {k: torch.empty_like(X) for k in trees}
        work = (torch.empty(tpp.matpow_work_floats(n, N), dtype=torch.float32, device=dev)
                if N > tpp.MAX_SHARED_N else None)

        def launch(k):
            if name == "K7":
                return lambda: libs[k].qmps_matpow_small(X.data_ptr(), outs[k].data_ptr(), n, N, ITERS, stream)
            return matpow_large_launcher(libs[k], X, outs[k], work, ITERS, stream)

        reps = 20 if name == "K7" else 5 if N <= 64 else 2
        times = _in_turns({k: launch(k) for k in trees[:2]}, reps)
        if len(trees) > 2:
            times.update(_in_turns({k: launch(k) for k in trees[2:]}, reps))
        for k, M in outs.items():
            lam, v = tpp._extract_eigpair(X64, M.to(torch.complex128))
            err_lam = (lam - lam_p).abs().max().item()
            err_v = _phase_err(v, v_p)
            rows.append({"kernel": name, "tree": k, "batch": n, "n": N, "input": tag, "ms": times[k],
                         "lam_err": err_lam, "v_err": err_v})
            print(f"{name} {k:6s} {tag:20s} ({n} x {N}x{N}): {times[k][0]:.5f} / {times[k][1]:.5f} ms, "
                  f"lam err {err_lam:.3g}, v err {err_v:.3g}", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "rows": rows}, indent=1))
    print(card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
