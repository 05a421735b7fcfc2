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
adds one where it launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
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
            "brickwork_overlap": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "qmps_dominant_eig": [_P, _P, _P, _I, _I, _I, _P],
    "qmps_energy_fwd": [_P, _P, _P, _P, _P, _I, _I, _P],
    "qmps_energy_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "qmps_tdvp_fwd": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _P],
    "qmps_tdvp_bwd": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "qmps_brickwork_overlap": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
}

_lib: ctypes.CDLL | None = None


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def _sources() -> list[Path]:
    return sorted(p for p in SRC_DIR.iterdir() if p.suffix in (".cu", ".cuh"))


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


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"libqmps_torch_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile the sources if their library is missing; returns (path, the
    compiler's log, kept beside the library: ``-Xptxas -v`` registers and
    spills per kernel)."""
    out = library_path()
    log = out.with_suffix(".log")
    if out.exists():
        return out, log.read_text() if log.exists() else ""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for src in (p for p in _sources() if p.suffix == ".cu"):
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


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if need be."""
    global _lib
    if _lib is None:
        path, _ = build()
        handle = ctypes.CDLL(str(path))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def require(t, name: str, dtype, shape: tuple) -> None:
    """Raise unless ``t`` is a CUDA tensor of ``dtype`` and ``shape`` (None
    matches any size) — what the kernels take."""
    if not t.is_cuda:
        raise ValueError(f"{name}: the CUDA kernel takes a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: the CUDA kernel takes {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != n for s, n in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {rc}")
