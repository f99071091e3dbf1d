"""Device mesh helpers — the topology layer for multi-card and multi-host
scaling: the port of ``xsmm_tpu/parallel/mesh.py``.

The reference has no in-core distributed layer (SURVEY.md §2.4): its
parallelism is caller-owned thread teams plus MLSL data parallelism in the
GxM sample (samples/deeplearning/gxm/src/Conv.cpp:350).  The JAX package
uses a ``jax.sharding.Mesh`` with named axes and one controller per
process.  The port keeps that design:

* within a process, a ``Mesh`` is a numpy grid of ``torch.device`` with
  named axes, driven by one controller.  A device may repeat: D ranks on
  ``cuda:0`` (or the CPU) are the analog of the JAX tests' virtual CPU
  devices, and each rank gets its own CUDA streams (``Mesh.streams``);
* across processes, ``torch.distributed`` joins the controllers
  (``init_multihost``): gloo on the CPU, and gloo staged through host
  memory where several processes share one card (NCCL refuses two ranks of
  one communicator on one card); NCCL where each process has its own card.
  A global mesh (``global_mesh``) spans every process's ranks and knows
  which process owns each; a process holds the tensors of its own ranks.

A ``Sharded`` value holds one process's per-rank tensors of a global array,
its ``PartitionSpec`` and ``gather()``: it takes the place of a global
``jax.Array`` with a ``NamedSharding``.

Axis convention used across the framework:
  "dp"  - data parallel (batch / problem-instance dimension)
  "mp"  - model/row parallel (matrix row-block partitioning for the
          distributed SpMM/GEMM paths)

Collectives over the local ranks (``psum``, ``pmean``, ``all_gather``) are
torch ops in a fixed rank order, so autograd differentiates them; an axis
that spans processes adds ``torch.distributed.nn.functional.all_reduce``,
which autograd differentiates too.  Every collective and point-to-point
transfer across processes carries a timeout (``COMM_TIMEOUT_S``).
"""

from __future__ import annotations

import contextlib
import datetime
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core import platform

# seconds a cross-process collective, transfer or group join may take
COMM_TIMEOUT_S = float(os.environ.get("XSMM_COMM_TIMEOUT_S", 120))

# backend -> times init_multihost chose it; bytes staged through host memory
backend_choices: Dict[str, int] = {"gloo": 0, "nccl": 0}
staged: Dict[str, int] = {"transfers": 0, "bytes": 0}


def reset_counts() -> None:
    for counts in (backend_choices, staged):
        for k in counts:
            counts[k] = 0


class PartitionSpec(tuple):
    """Which mesh axis (or None) splits each array dimension, as JAX's."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)


P = PartitionSpec


class Mesh:
    """A grid of ranks with named axes.

    ``devices[idx]`` is the ``torch.device`` of the rank at grid index
    ``idx`` when this process owns it, else None; ``owners[idx]`` is the
    owning process.  Ranks are numbered in C order over the grid.
    """

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str],
                 owners: Optional[np.ndarray] = None, process: int = 0):
        self.devices = devices
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != devices.ndim:
            raise ValueError(f"{len(self.axis_names)} axis names for a "
                             f"{devices.ndim}-d device grid")
        self.owners = (np.zeros(devices.shape, np.int64) if owners is None
                       else owners)
        self.process = process
        self._streams: Dict[Tuple[int, str], torch.cuda.Stream] = {}

    # -- shape and ranks -----------------------------------------------------
    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def coords(self, rank: int) -> Tuple[int, ...]:
        return tuple(int(i) for i in np.unravel_index(rank,
                                                      self.devices.shape))

    def coord(self, rank: int, axis: str) -> int:
        return self.coords(rank)[self.axis_names.index(axis)]

    def device(self, rank: int) -> Optional[torch.device]:
        return self.devices.flat[rank]

    def owner(self, rank: int) -> int:
        return int(self.owners.flat[rank])

    def local_ranks(self) -> List[int]:
        return [r for r in range(self.size) if self.owner(r) == self.process]

    def is_local(self, rank: int) -> bool:
        return self.owner(rank) == self.process

    def spans_processes(self, axes: Optional[Sequence[str]] = None) -> bool:
        """Whether a group along ``axes`` (default: all) holds ranks of
        more than one process."""
        axes = self.axis_names if axes is None else tuple(axes)
        return any(len({self.owner(r) for r in g}) > 1
                   for g in self.groups(axes))

    def groups(self, axes: Sequence[str]) -> List[List[int]]:
        """The rank groups that differ only along ``axes``, each in C order
        over those axes (the order of a psum)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.axis_names:
                raise ValueError(f"no mesh axis {a!r} in {self.axis_names}")
        keep = [i for i, a in enumerate(self.axis_names) if a not in axes]
        out: Dict[Tuple[int, ...], List[int]] = {}
        for r in range(self.size):
            c = self.coords(r)
            out.setdefault(tuple(c[i] for i in keep), []).append(r)
        return list(out.values())

    # -- streams -------------------------------------------------------------
    def streams(self, rank: int):
        """(compute, communication) CUDA streams of a local rank on the
        card, made once; (None, None) on the CPU."""
        dev = self.device(rank)
        if dev is None or dev.type != "cuda":
            return None, None
        got = []
        for kind in ("compute", "comm"):
            s = self._streams.get((rank, kind))
            if s is None:
                s = self._streams[(rank, kind)] = torch.cuda.Stream(dev)
            got.append(s)
        return tuple(got)

    def __repr__(self):
        devs = sorted({str(d) for d in self.devices.flat if d is not None})
        return (f"Mesh({self.shape}, devices={devs}, "
                f"processes={len(set(self.owners.flat))})")


def default_devices() -> List[torch.device]:
    """The entry points' devices: every card (``torch.cuda.device_count()``)
    unless the target is the CPU, then the CPU."""
    if platform.backend() == "cpu":
        return [torch.device("cpu")]
    platform.device()   # raises without a card
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def virtual_devices(n: int) -> List[torch.device]:
    """``n`` rank devices: the cards round robin, so that a card repeats
    where there are fewer (virtual ranks), or the CPU on the CPU
    target."""
    if platform.backend() == "cpu":
        return [torch.device("cpu")] * n
    platform.device()    # raises without a card
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def _fill_shape(shape, n: int, n_axes: int) -> List[int]:
    if shape is None:
        shape = (n,) + (1,) * (n_axes - 1)
    shape = list(shape)
    if -1 in shape:
        known = int(np.prod([s for s in shape if s != -1]))
        shape[shape.index(-1)] = n // max(known, 1)
    if int(np.prod(shape)) != n:
        raise ValueError(f"mesh shape {tuple(shape)} != {n} devices")
    return shape


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("dp", "mp"),
              devices=None) -> Mesh:
    """Build a mesh over ``devices`` (default: ``default_devices()``).

    Default shape: all devices on the first axis.  ``shape`` entries may be
    -1 (inferred).  A device may repeat (D ranks on one card or on the
    CPU).  Raises ``ValueError`` when the shape does not hold the devices.
    """
    devices = [torch.device(d) for d in (devices if devices is not None
                                         else default_devices())]
    shape = _fill_shape(shape, len(devices), len(axis_names))
    grid = np.empty(len(devices), dtype=object)
    grid[:] = devices
    return Mesh(grid.reshape(shape), axis_names)


def global_mesh(shape: Optional[Tuple[int, ...]],
                axis_names: Sequence[str], local_devices: Sequence) -> Mesh:
    """A mesh over every process's ranks (after ``init_multihost``): each
    process brings ``len(local_devices)`` ranks, process p the ranks p*L ..
    p*L + L - 1 in C order, as ``jax.devices()`` orders a multi-process
    job; this process knows the devices of its own."""
    import torch.distributed as dist

    n_proc = dist.get_world_size() if dist.is_initialized() else 1
    me = dist.get_rank() if dist.is_initialized() else 0
    per = len(local_devices)
    n = n_proc * per
    shape = _fill_shape(shape, n, len(axis_names))
    grid = np.empty(n, dtype=object)
    grid[me * per:(me + 1) * per] = [torch.device(d) for d in local_devices]
    owners = np.repeat(np.arange(n_proc), per)
    return Mesh(grid.reshape(shape), axis_names, owners.reshape(shape), me)


class NamedSharding:
    """A mesh and a ``PartitionSpec``: how a global array lies on the
    ranks."""

    def __init__(self, mesh: Mesh, spec: PartitionSpec):
        self.mesh = mesh
        self.spec = PartitionSpec(*spec)

    def __repr__(self):
        return f"NamedSharding({self.mesh!r}, {tuple(self.spec)})"


def dp_sharding(mesh: Mesh, axis: int = 0, name: str = "dp") -> NamedSharding:
    """Shard one array axis across the data-parallel mesh axis."""
    spec = [None] * (axis + 1)
    spec[axis] = name
    return NamedSharding(mesh, P(*spec))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


class Sharded:
    """One process's shards of a global array: ``shards[i]`` is the tensor
    of local rank ``mesh.local_ranks()[i]`` on that rank's device."""

    def __init__(self, sharding: NamedSharding, shards: Sequence[torch.Tensor],
                 global_shape: Tuple[int, ...]):
        self.sharding = sharding
        self.shards = list(shards)
        self.shape = tuple(global_shape)
        if len(self.shards) != len(self.mesh.local_ranks()):
            raise ValueError(f"{len(self.shards)} shards for "
                             f"{len(self.mesh.local_ranks())} local ranks")

    @property
    def mesh(self) -> Mesh:
        return self.sharding.mesh

    @property
    def spec(self) -> PartitionSpec:
        return self.sharding.spec

    @property
    def dtype(self):
        return self.shards[0].dtype

    def shard(self, rank: int) -> torch.Tensor:
        return self.shards[self.mesh.local_ranks().index(rank)]

    def gather(self, device=None) -> torch.Tensor:
        """The global array on ``device`` (default: the first local rank's),
        assembled from the shards (replicas along unsplit axes are read
        once).  Every rank must be local."""
        mesh, spec = self.mesh, self.spec
        if len(mesh.local_ranks()) != mesh.size:
            raise ValueError("gather() needs every rank of the mesh in this "
                             "process; this mesh spans processes")
        dev = torch.device(device) if device is not None else \
            self.shards[0].device
        # index of each array dim's mesh axis (or None)
        dims = [mesh.axis_names.index(a) if a is not None else None
                for a in spec] + [None] * (len(self.shape) - len(spec))
        blocks: Dict[Tuple[int, ...], torch.Tensor] = {}
        for r, t in zip(mesh.local_ranks(), self.shards):
            c = mesh.coords(r)
            key = tuple(c[i] if i is not None else 0 for i in dims)
            blocks.setdefault(key, t)

        def build(prefix: Tuple[int, ...]) -> torch.Tensor:
            k = len(prefix)
            if k == len(dims):
                return blocks[prefix].to(dev)
            n = mesh.devices.shape[dims[k]] if dims[k] is not None else 1
            parts = [build(prefix + (i,)) for i in range(n)]
            return parts[0] if n == 1 else torch.cat(parts, dim=k)

        return build(())

    def numpy(self) -> np.ndarray:
        return self.gather().detach().cpu().numpy()

    def __repr__(self):
        return (f"Sharded(shape={self.shape}, spec={tuple(self.spec)}, "
                f"{len(self.shards)} local shards)")


def device_put(x, sharding: NamedSharding) -> Sharded:
    """Split a global array (numpy or tensor, the same on every process)
    into this process's shards; each array dim named in the spec must
    divide by its mesh axis."""
    from ..ops.smm import as_tensor

    mesh, spec = sharding.mesh, sharding.spec
    t = x if isinstance(x, torch.Tensor) else as_tensor(
        np.ascontiguousarray(x), torch.device("cpu"))
    shards = []
    for r in mesh.local_ranks():
        c = mesh.coords(r)
        piece = t
        for dim, a in enumerate(spec):
            if a is None:
                continue
            n = mesh.shape[a]
            if piece.shape[dim] % n:
                raise ValueError(f"dim {dim} of size {piece.shape[dim]} does "
                                 f"not divide over axis {a!r} of size {n}")
            size = piece.shape[dim] // n
            piece = piece.narrow(dim, c[mesh.axis_names.index(a)] * size,
                                 size)
        piece = piece.to(mesh.device(r))
        if (piece.untyped_storage().data_ptr()
                == t.untyped_storage().data_ptr()):
            piece = piece.clone()    # each rank owns its memory
        shards.append(piece.contiguous())
    return Sharded(sharding, shards, tuple(t.shape))


# ---------------------------------------------------------------------------
# Collectives over an axis: torch ops over the local ranks in a fixed order,
# plus torch.distributed across processes
# ---------------------------------------------------------------------------


def _dist_group_check(mesh: Mesh, groups: List[List[int]]) -> None:
    """A group along a cross-process axis must reach every process, and
    every process must hold members of the same groups (so that all of
    them issue the same collectives in the same order)."""
    n_proc = len(set(mesh.owners.flat))
    for g in groups:
        if len({mesh.owner(r) for r in g}) != n_proc:
            raise ValueError("a collective across processes needs each group "
                             "along the axis to reach every process")


def _stage(t: torch.Tensor) -> torch.Tensor:
    """A CUDA tensor through host memory for a gloo collective (counted)."""
    if t.device.type == "cpu":
        return t
    staged["transfers"] += 1
    staged["bytes"] += t.numel() * t.element_size()
    return t.cpu()


def _all_reduce(t: torch.Tensor) -> torch.Tensor:
    """The differentiable sum over every process (gloo, staged through
    host memory for a card's tensor; NCCL on the card's tensor)."""
    import torch.distributed as dist
    import torch.distributed.nn.functional as dnn

    dev = t.device
    if dist.get_backend() == "nccl":
        return dnn.all_reduce(t)
    return dnn.all_reduce(_stage(t)).to(dev)


def psum(mesh: Mesh, axes, values: Sequence[torch.Tensor]
         ) -> List[torch.Tensor]:
    """The sum over ``axes`` of ``values`` (one tensor a local rank, in
    ``mesh.local_ranks()`` order): every rank gets its group's sum on its
    own device.  The local members add in rank order on the group's first
    local device; an axis that spans processes then sums the partial sums
    over every process.  Differentiable."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    local = mesh.local_ranks()
    by_rank = dict(zip(local, values))
    groups = mesh.groups(axes)
    cross = mesh.spans_processes(axes)
    if cross:
        _dist_group_check(mesh, groups)
    total: Dict[int, torch.Tensor] = {}
    for g in groups:
        mine = [r for r in g if r in by_rank]
        if not mine:
            continue
        dev = by_rank[mine[0]].device
        acc = by_rank[mine[0]]
        for r in mine[1:]:
            acc = acc + by_rank[r].to(dev)
        if cross:
            acc = _all_reduce(acc)
        for r in mine:
            total[r] = acc
    return [total[r].to(by_rank[r].device) for r in local]


def pmean(mesh: Mesh, axes, values: Sequence[torch.Tensor]
          ) -> List[torch.Tensor]:
    """``psum`` over ``axes`` divided by the group size (equal shards)."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    n = int(np.prod([mesh.shape[a] for a in axes]))
    return [v / n for v in psum(mesh, axes, values)]


def all_gather(mesh: Mesh, axis: str, values: Sequence[torch.Tensor],
               dim: int) -> List[torch.Tensor]:
    """Concatenate the group's tensors along ``dim`` in ``axis`` order;
    every rank gets the whole on its device.  The axis must lie within this
    process.  Differentiable."""
    if mesh.spans_processes((axis,)):
        raise ValueError(f"all_gather over {axis!r}: the axis spans "
                         f"processes; the port gathers within a process")
    local = mesh.local_ranks()
    by_rank = dict(zip(local, values))
    out = {}
    for g in mesh.groups((axis,)):
        if g[0] not in by_rank:
            continue
        dev = by_rank[g[0]].device
        whole = torch.cat([by_rank[r].to(dev) for r in g], dim=dim)
        for r in g:
            out[r] = whole
    return [out[r].to(by_rank[r].device) for r in local]


# ---------------------------------------------------------------------------
# Processes
# ---------------------------------------------------------------------------


def pick_backend(local_devices: Sequence, num_processes: int,
                 backend: Optional[str] = None) -> str:
    """The ``torch.distributed`` backend for this device layout: gloo for
    CPU ranks and where processes share a card (hops staged through pinned
    host memory); NCCL where each process's ranks are cards of their own.
    Asking for NCCL where processes share a card raises."""
    devs = [torch.device(d) for d in local_devices]
    on_card = any(d.type == "cuda" for d in devs)
    shared = False
    if on_card:
        cards = torch.cuda.device_count()
        shared = (len({d.index for d in devs}) < len(devs)
                  or cards < num_processes * len(devs))
    if backend == "nccl":
        if not on_card:
            raise ValueError("NCCL needs the ranks on cards")
        if shared:
            raise ValueError(
                "NCCL refuses two ranks of one communicator on one card: "
                f"{num_processes} processes x {len(devs)} ranks share "
                f"{torch.cuda.device_count()} card(s); use gloo, which "
                "stages the transfers through pinned host memory")
        return "nccl"
    if backend not in (None, "gloo"):
        raise ValueError(f"unknown backend {backend!r}: gloo or nccl")
    if backend is None and on_card and not shared:
        return "nccl"
    return "gloo"


def init_multihost(init_method: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None,
                   local_devices: Optional[Sequence] = None,
                   backend: Optional[str] = None,
                   timeout_s: float = COMM_TIMEOUT_S) -> int:
    """Join the processes (the GxM MLSL-environment analog): one controller
    a process, ``torch.distributed`` between them.

    Arguments default to the standard environment (``env://``:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).  The backend follows the
    device layout (``pick_backend``), printed and counted in
    ``backend_choices``.  A no-op when already joined or single-process; a
    genuine failure (bad address, unreachable peer, the timeout) raises.
    Returns the number of processes."""
    import torch.distributed as dist

    if dist.is_initialized():
        return dist.get_world_size()
    n = num_processes if num_processes is not None else int(
        os.environ.get("WORLD_SIZE", 1))
    if n <= 1 and init_method is None:
        return 1
    devs = list(local_devices) if local_devices is not None else \
        default_devices()
    be = pick_backend(devs, n, backend)
    backend_choices[be] += 1
    rank = process_id if process_id is not None else int(
        os.environ.get("RANK", 0))
    print(f"[proc {rank}] torch.distributed backend {be} for "
          f"{n} processes x {len(devs)} ranks on "
          f"{sorted({str(d) for d in devs})}", flush=True)
    dist.init_process_group(
        be, init_method=init_method or "env://", world_size=n, rank=rank,
        timeout=datetime.timedelta(seconds=timeout_s))
    return dist.get_world_size()


def host_count() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def local_device_count() -> int:
    return len(default_devices())


@contextlib.contextmanager
def on_rank(mesh: Mesh, rank: int, stream=None):
    """Make ``rank``'s device (and ``stream``) current for the calls in the
    block: the kernels' wrappers launch on the current stream of the
    current device."""
    dev = mesh.device(rank)
    if dev is None or dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev):
        if stream is None:
            yield
        else:
            with torch.cuda.stream(stream):
                yield
