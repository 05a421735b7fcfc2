"""Native runtime components (C++ via ctypes; counterpart of
``qmps_tpu.native``).

``optimal_einsum_path``: the exact minimal-flop contraction order of a
tensor network, from the dynamic-programming planner in pathfinder.cpp (a
copy of the JAX package's).  The library is built at first use with g++
into ``qmps_torch/_build/``.  A failed build raises: there is no greedy
fallback that would hide a broken toolchain.  "greedy" is returned only
where the planner itself declines: fewer than 2 or more than 20 operands,
more than 63 index ids, or a negative plan.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
from functools import lru_cache
from pathlib import Path
from typing import Dict, List, Sequence

_SRC = Path(__file__).resolve().parent / "pathfinder.cpp"
_BUILD = _SRC.parent.parent / "_build"
_SO = _BUILD / "libpathfinder.so"


@lru_cache(maxsize=1)
def _lib():
    if not _SO.exists() or _SO.stat().st_mtime < _SRC.stat().st_mtime:
        _BUILD.mkdir(parents=True, exist_ok=True)
        # build beside the target and rename, so that concurrent first uses
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
        os.close(fd)
        proc = subprocess.run(["g++", "-O3", "-shared", "-fPIC", str(_SRC), "-o", tmp],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"building {_SRC.name} with g++ failed:\n{proc.stderr}")
        os.replace(tmp, _SO)
    lib = ctypes.CDLL(str(_SO))
    lib.plan_path.restype = ctypes.c_longlong
    lib.plan_path.argtypes = [
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_uint64,
        ctypes.POINTER(ctypes.c_uint32),
        ctypes.POINTER(ctypes.c_uint32),
    ]
    return lib


def _plan(operands, dims, output):
    """(total flops, left merges, right merges) of the planner, over the
    sorted index ids of the network."""
    ids = sorted({i for t in operands for i in t} | set(output))
    remap = {idx: k for k, idx in enumerate(ids)}
    n = len(operands)
    masks = (ctypes.c_uint64 * n)(*[sum(1 << remap[i] for i in set(t)) for t in operands])
    dim_arr = (ctypes.c_longlong * len(ids))(*[int(dims[i]) for i in ids])
    out_mask = sum(1 << remap[i] for i in set(output))
    ml = (ctypes.c_uint32 * (n - 1))()
    mr = (ctypes.c_uint32 * (n - 1))()
    flops = _lib().plan_path(n, masks, len(ids), dim_arr, out_mask, ml, mr)
    return int(flops), ml, mr


def optimal_einsum_path(
    operands: Sequence[Sequence[int]],
    dims: Dict[int, int],
    output: Sequence[int],
):
    """opt_einsum-style pairwise path ["einsum_path", (i, j), ...]
    minimizing total flops.

    operands: per-tensor index-id lists; dims: id -> dimension; output:
    ids kept in the result.  Returns "greedy" where the planner declines:
    more than 20 tensors or 63 ids, fewer than 2 tensors."""
    _lib()  # a broken toolchain raises whatever the network
    n = len(operands)
    n_ids = len({i for t in operands for i in t} | set(output))
    if n > 20 or n_ids > 63 or n < 2:
        return "greedy"
    flops, ml, mr = _plan(operands, dims, output)
    if flops < 0:
        return "greedy"
    # the subset-mask merge list as positional pairs: a working list of
    # subset masks (singletons first); each merge pops its two operands by
    # position and appends their union
    work: List[int] = [1 << i for i in range(n)]
    path: List = ["einsum_path"]  # numpy/opt_einsum explicit-path marker
    for k in range(n - 1):
        i, j = sorted((work.index(int(ml[k])), work.index(int(mr[k]))))
        path.append((i, j))
        hi = work.pop(j)
        lo = work.pop(i)
        work.append(lo | hi)
    return path


def plan_total_flops(
    operands: Sequence[Sequence[int]], dims: Dict[int, int], output: Sequence[int]
) -> int:
    """Total flops of the optimal plan (for diagnostics and benchmarks)."""
    return _plan(operands, dims, output)[0]
