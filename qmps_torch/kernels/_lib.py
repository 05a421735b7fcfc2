"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` for ``sm_90a`` (all at
once) and linked into one shared library with a plain C interface, loaded
with ``ctypes``.  The build runs at first use, into ``qmps_torch/_build/``,
under a name keyed by a hash of the sources and flags, so an edited source
rebuilds and an unchanged one loads.
A missing compiler or a failed build raises: there is no silent fallback.
Each C entry point returns ``cudaGetLastError()`` after its launch, and
:func:`check` raises on a non-zero code.

``launches`` holds one plain-integer launch counter per kernel; a wrapper
adds one (:func:`count`) where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
#: per-source compile flags (each ``.cu`` is compiled by its own nvcc, all
#: started together) and the flags of the link into one shared library
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
LINK_FLAGS = [*_ARCH, "-shared"]

#: kernel name -> launches since the last :func:`reset_launches`
launches = {"dominant_eig": 0, "energy_fwd": 0, "energy_bwd": 0, "tdvp_fwd": 0, "tdvp_bwd": 0,
            "brickwork_overlap": 0, "matpow_small": 0, "matpow_large": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "qmps_dominant_eig": [_P, _P, _P, _P, _I, _I, _I, _P],
    "qmps_energy_fwd": [_P, _P, _P, _P, _P, _I, _I, _P],
    "qmps_energy_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "qmps_tdvp_fwd": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P],
    "qmps_tdvp_bwd": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "qmps_brickwork_overlap": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "qmps_matpow_small": [_P, _P, _I, _I, _I, _P],
    "qmps_matpow_large": [_P, _P, _P, _I, _I, _I, _P],
    # an empty kernel on K5's grid: the launch floor of a measurement, no counter
    "qmps_empty": [_I, _P],
}

_lib: ctypes.CDLL | None = None
_count_lock = threading.Lock()  # the shards of a sharded sweep launch from threads of their own


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def count(name: str) -> None:
    """One launch of kernel ``name``."""
    with _count_lock:
        launches[name] += 1


def _sources(src_dir: Path = SRC_DIR) -> list[Path]:
    return sorted(p for p in src_dir.iterdir() if p.suffix in (".cu", ".cuh"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under $CUDA_HOME/bin): the CUDA "
        "kernels of qmps_torch cannot be built"
    )


def library_path(src_dir: Path = SRC_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library for the sources in ``src_dir`` lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in _sources(src_dir):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return build_dir / f"libqmps_torch_{h.hexdigest()[:16]}.so"


def build(src_dir: Path = SRC_DIR, build_dir: Path = BUILD_DIR) -> tuple[Path, str]:
    """Compile the sources of ``src_dir`` (the package's own by default) if
    their library is missing; returns (path, the compiler's log, kept beside
    the library: ``-Xptxas -v`` registers and spills per kernel)."""
    out = library_path(src_dir, build_dir)
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    nvcc = _nvcc()
    build_dir.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build_dir) as tmp:
        jobs = []
        for src in (p for p in _sources(src_dir) if p.suffix == ".cu"):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
            jobs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        text = ""
        for cmd, _, proc in jobs:  # every compile runs to its end before any raise
            text += proc.communicate()[0]
        for cmd, _, proc in jobs:
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        so = Path(tmp) / "lib.so"
        cmd = [nvcc, *LINK_FLAGS, "-o", str(so), *(str(obj) for _, obj, _ in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        text += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{' '.join(cmd)}\n{text}")
        log.write_text(text)
        os.replace(so, out)  # atomic: a concurrent build never loads a partial file
    return out, text


def load(path: Path, strict: bool = True) -> ctypes.CDLL:
    """A built library with the C entry points' signatures set; ``strict``
    False skips those it lacks (an earlier tree's, in a comparison)."""
    handle = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if not strict and not hasattr(handle, name):
            continue
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be."""
    global _lib
    if _lib is None:
        _lib = load(build()[0])
    return _lib


def require(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a CUDA tensor of ``dtype`` and ``shape`` (None
    matches any size) — what the kernels take."""
    if t.is_cuda and t.dtype == dtype and t.shape == shape:  # the common case, in one test
        return
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def raw_stream(device_index: int) -> int:
    """The current stream of a CUDA device as the integer a C entry point
    takes: torch's own accessor for generated kernels, ~1 us where
    ``torch.cuda.current_stream(device).cuda_stream`` builds a Stream object
    first (~5 us on the card's host, a fifth of K6's call at config 5)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(device_index)


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
