"""Device meshes for sharded sweeps (counterpart of ``qmps_tpu.parallel.mesh``).

The points of a sweep are independent, so sharding one over devices is pure
data parallelism, the JAX package's ``shard_map`` with ``P(axis)`` in and
out and no collectives (docs/DESIGN.md 4c): ``shard_over_sweep`` splits the
leading axis of every tensor argument into one contiguous block a device of
the mesh, runs the function on each block on its device, and concatenates
the outputs on the mesh's first device.  A mesh may name a device more than
once: two shards on one card run on two streams of it.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import torch

_shard = threading.local()


@dataclass(frozen=True)
class Mesh:
    """A 1-D mesh: the devices a sweep's leading axis is split over, in
    order, and the axis' name.  Any device list makes one, as JAX's
    ``Mesh`` does from any device array: ``Mesh(("cpu",) * 8)`` or the
    card twice, ``Mesh(("cuda:0", "cuda:0"))``."""

    devices: tuple
    axis: str = "sweep"

    def __post_init__(self):
        devices = tuple(torch.device(d) for d in self.devices)
        if not devices:
            raise ValueError("a mesh needs at least one device")
        object.__setattr__(self, "devices", devices)

    def __len__(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, axis: str = "sweep") -> Mesh:
    """1-D mesh over the first n CUDA devices (default: all)."""
    n = torch.cuda.device_count()
    if n == 0:
        raise RuntimeError("make_mesh: no CUDA device; a mesh of other devices is Mesh(devices)")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n))[:n_devices], axis)


def shards_on_device() -> int:
    """How many shards of the running sharded call share this shard's
    device (1 outside one): the point-chunk rules plan for that share of the
    device's free memory."""
    return getattr(_shard, "sharing", 1)


def _concat(outs: list, device: torch.device):
    """The shards' outputs joined on their leading axis on ``device``:
    tensors, and tuples or lists of them, at any depth."""
    first = outs[0]
    if isinstance(first, torch.Tensor):
        return torch.cat([o.to(device) for o in outs])
    if isinstance(first, (tuple, list)):
        return type(first)(_concat([o[k] for o in outs], device) for k in range(len(first)))
    raise TypeError(f"shard_over_sweep: an output must be a tensor or a tuple of them, got {type(first).__name__}")


def shard_over_sweep(f, mesh: Mesh | None, axis: str = "sweep"):
    """Shard a batched function's leading axis across ``mesh`` (``f``
    itself when mesh is None).

    Every tensor argument is split into ``len(mesh)`` equal contiguous
    blocks, as shard_map's ``P(axis)`` splits it, and a batch that does not
    divide raises, as there; other arguments pass to every shard as they
    are.  Block i runs ``f`` on ``mesh.devices[i]``: on CUDA one worker
    thread a shard, on a stream of its own device that first waits for the
    caller's work, so the shards' host-bound drivers overlap; on the CPU
    in turn.  Each output (tensors, tuples of them) is concatenated on
    the first device.  A shard that raises makes the call raise; nothing
    runs unsharded in its place.
    """
    if mesh is None:
        return f
    if axis != mesh.axis:
        raise ValueError(f"the mesh has axis {mesh.axis!r}, not {axis!r}")
    n = len(mesh)

    def sharded(*args):
        for a in args:
            if isinstance(a, torch.Tensor) and (a.dim() == 0 or a.shape[0] % n):
                raise ValueError(f"shard_over_sweep: a leading axis of {tuple(a.shape)[:1]} does not divide "
                                 f"into {n} shards over {axis!r}")
        waits = {d: torch.cuda.current_stream(d) for d in mesh.devices if d.type == "cuda"}
        grad = torch.is_grad_enabled()  # thread-local: a worker starts with the default

        def block(a, i):
            if not isinstance(a, torch.Tensor):
                return a
            m = a.shape[0] // n
            return a[i * m:(i + 1) * m].to(mesh.devices[i])

        def run(i):
            dev = mesh.devices[i]
            _shard.sharing = mesh.devices.count(dev)
            try:
                if dev.type != "cuda":
                    with torch.set_grad_enabled(grad):
                        return f(*(block(a, i) for a in args))
                stream = torch.cuda.Stream(dev)
                stream.wait_stream(waits[dev])
                with torch.cuda.device(dev), torch.cuda.stream(stream), torch.set_grad_enabled(grad):
                    out = f(*(block(a, i) for a in args))
                # the shard's work is done before its outputs, and the
                # memory it freed on its stream, meet the caller's stream
                stream.synchronize()
                return out
            finally:
                _shard.sharing = 1

        if any(d.type == "cuda" for d in mesh.devices):
            with ThreadPoolExecutor(n) as pool:
                futures = [pool.submit(run, i) for i in range(n)]
            outs = [fut.result() for fut in futures]  # the first failure raises
        else:
            outs = [run(i) for i in range(n)]
        return _concat(outs, mesh.devices[0])

    return sharded
