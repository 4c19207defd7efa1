"""Device mesh for multi-device flow estimation (port of ``optical_flow_tpu/parallel/mesh.py``).

A mesh is a (batch, space) grid of ``torch.device``s, held row-major:
batch row b is ``devices[b * space : (b + 1) * space]``.

* ``space``: image rows are tiled over it.  A sharded field is a list of
  row blocks, block i on device i of the first batch row.
* ``batch``: frame pairs are split over it (``parallel/batch.py``), one
  contiguous group a batch row.

The same device may appear more than once (n shards on one card, or n
shards on the CPU).

**One process or several.**  By default a mesh belongs to one process: its
collectives are copies between the shards' devices, issued in shard order.
After :func:`initialize_distributed` (the counterpart of
``jax.distributed.initialize``), ``flow_mesh()`` spans the devices of every
process in rank order, as ``jax.devices()`` does, and each process holds
the shards of its own entries (a sharded field is then the list of this
process's blocks).  Every process holds the whole input, as in the JAX
package's multi-process runs, and the collectives go over
``torch.distributed``:

* :func:`shard_rows` slices this process's rows;
* :func:`gather_rows` all-gathers the blocks: every process gets the whole
  field, as JAX's replicated outputs;
* :func:`psum` all-gathers the shards' partials and adds them in shard
  order in every process, never by ``all_reduce`` (whose order is the
  backend's), so it is bit-equal to the one-process sum;
* :func:`broadcast` copies a value that every process computed from the
  same gathered bits onto this process's shards.

The sharded code learns which shards are this process's from the mesh of
the sharded call in progress (:func:`sharded_over`, set by the host-callable
level steps and solves).  The backend is the caller's choice and nothing
switches it: NCCL moves CUDA tensors directly; gloo moves CUDA tensors only
for broadcast and all-reduce, so with gloo the all-gathers and halo
messages of CUDA tensors are staged through pinned host buffers.  A failed
initialisation or collective raises (within the timeout given to
:func:`initialize_distributed`).
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import threading
from typing import Optional, Sequence

import torch

BATCH_AXIS = "batch"
SPACE_AXIS = "space"


def canonical_device(d) -> torch.device:
    """``d`` as a torch device with its index ("cuda" is the current card)."""
    d = torch.device(d)
    if d.type == "cuda" and d.index is None and torch.cuda.is_available():
        d = torch.device("cuda", torch.cuda.current_device())
    return d


# ---------------------------------------------------------------------------
# processes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class World:
    """The processes of a run: this one's rank, their number, the backend
    and each rank's devices, in rank order."""

    rank: int
    size: int
    backend: str
    devices: tuple


_world: Optional[World] = None


def initialize_distributed(address: str, world_size: int, rank: int, backend: str, device=None,
                           timeout: float = 300.0) -> World:
    """Join this process to a run of ``world_size`` processes as ``rank``.

    ``address``: the rendezvous, ``"tcp://host:port"`` or ``"file:///path"``.
    ``backend``: ``"nccl"`` (one card a rank) or ``"gloo"`` (CPU tensors;
    several ranks may share a card).  ``device``: this rank's device, or a
    list of devices (the rank's entries of a mesh); by default
    ``cuda:(rank % device_count)``, the CPU only when named.  ``timeout``
    (seconds) bounds the rendezvous and every collective: a dead peer fails
    the run instead of hanging it.  Each rank's devices are exchanged once.
    """
    global _world
    import torch.distributed as dist

    if _world is not None:
        raise RuntimeError("initialize_distributed(): this process already belongs to a run")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("initialize_distributed(): no CUDA device is visible; pass device='cpu'")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    local = tuple(canonical_device(d) for d in (device if isinstance(device, (list, tuple)) else [device]))
    if local[0].type == "cuda":
        torch.cuda.set_device(local[0])
    dist.init_process_group(backend, init_method=address, world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout))
    every = [None] * world_size
    dist.all_gather_object(every, [str(d) for d in local])
    _world = World(rank, world_size, backend, tuple(tuple(torch.device(d) for d in ds) for ds in every))
    return _world


def shutdown_distributed() -> None:
    """Leave the run joined by :func:`initialize_distributed` (no-op outside one)."""
    global _world
    if _world is not None:
        import torch.distributed as dist

        _world = None
        dist.destroy_process_group()


def world() -> Optional[World]:
    """The run this process belongs to, or None."""
    return _world


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where the n shards of a space axis live: ``index`` holds the shards
    of this process, ascending; across processes ``owner`` is each shard's
    rank and ``slot`` its position among that rank's shards (both empty in
    one process)."""

    n: int
    index: tuple
    owner: tuple = ()
    slot: tuple = ()

    @property
    def spans_processes(self) -> bool:
        return bool(self.owner)

    @property
    def width(self) -> int:
        """The most shards one process holds."""
        return max(self.slot) + 1 if self.slot else len(self.index)


def owner_layout(owners, rank: int) -> ShardLayout:
    slot, seen = [], {}
    for r in owners:
        slot.append(seen.get(r, 0))
        seen[r] = slot[-1] + 1
    return ShardLayout(len(owners), tuple(i for i, r in enumerate(owners) if r == rank), tuple(owners), tuple(slot))


@dataclasses.dataclass(frozen=True)
class FlowMesh:
    """A (batch, space) grid of devices, row-major; shard i of a row-sharded
    field lives on ``devices[i]`` (the first batch row).  ``owners``: the
    rank holding each entry when the mesh spans processes, else None."""

    devices: tuple
    batch: int = 1
    owners: Optional[tuple] = None
    rank: int = 0

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {BATCH_AXIS: self.batch, SPACE_AXIS: len(self.devices) // self.batch}

    def batch_row(self, b: int) -> tuple:
        """The devices of batch row ``b``."""
        space = self.shape[SPACE_AXIS]
        return self.devices[b * space : (b + 1) * space]

    @property
    def spans_processes(self) -> bool:
        return self.owners is not None

    def is_local(self, i: int) -> bool:
        """Whether entry ``i`` belongs to this process."""
        return self.owners is None or self.owners[i] == self.rank

    @property
    def home(self) -> torch.device:
        """This process's first device of the mesh: where whole-image work
        runs and gathered fields land."""
        return next(d for i, d in enumerate(self.devices) if self.is_local(i))

    def space_layout(self) -> ShardLayout:
        """The layout of the first batch row's shards."""
        n = self.shape[SPACE_AXIS]
        if self.owners is None:
            return ShardLayout(n, tuple(range(n)))
        return owner_layout(self.owners[:n], self.rank)


def flow_mesh(batch: int = 1, space: Optional[int] = None, devices: Optional[Sequence] = None) -> FlowMesh:
    """A (batch, space) mesh over ``devices``.

    By default: every visible CUDA device, or, after
    :func:`initialize_distributed`, the devices of every process in rank
    order (the mesh then spans the processes).  ``space`` defaults to the
    number of devices over ``batch``; ``batch * space`` must equal it.  A
    device may be listed more than once, e.g. ``devices=["cpu"] * 8``; a
    given list makes a mesh of this process alone.
    """
    owners = None
    if devices is None and _world is not None:
        devices = [d for ds in _world.devices for d in ds]
        owners = tuple(r for r, ds in enumerate(_world.devices) for _ in ds)
    elif devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("flow_mesh(): no CUDA device is visible; pass devices, e.g. ['cpu'] * n")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(canonical_device(d) if owners is None else d for d in devices)
    n = len(devices)
    if space is None:
        if batch < 1 or n % batch:
            raise ValueError(f"{n} devices not divisible by batch={batch}")
        space = n // batch
    if batch * space != n or n < 1:
        raise ValueError(f"batch*space = {batch * space} != {n} devices")
    return FlowMesh(devices, int(batch), owners, _world.rank if owners is not None else 0)


# ---------------------------------------------------------------------------
# the sharded call in progress
# ---------------------------------------------------------------------------

_scope = threading.local()


@contextlib.contextmanager
def sharded_over(mesh: FlowMesh):
    """Run the sharded code inside on ``mesh``'s layout (this thread only).

    Across processes every process must hold a shard of the first batch
    row: each takes part in every collective of the row.  Every process
    checks that from the mesh alone, so all of them raise together.
    """
    if mesh.spans_processes and set(mesh.space_layout().owner) != set(mesh.owners):
        raise ValueError("a process holds no shard of the mesh's first batch row; every process of a row-sharded "
                         "run must (use flow_mesh(batch=1) or put a device of each process in the row)")
    prev = getattr(_scope, "mesh", None)
    _scope.mesh = mesh
    try:
        yield
    finally:
        _scope.mesh = prev


def shard_layout(k: int) -> ShardLayout:
    """The layout of the sharded call in progress, whose fields hold ``k``
    blocks in this process: all the shards, unless its mesh spans processes."""
    mesh = getattr(_scope, "mesh", None)
    if mesh is None or not mesh.spans_processes:
        return ShardLayout(k, tuple(range(k)))
    return mesh.space_layout()


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def to_wire(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the run's backend moves it: a contiguous copy in pinned host
    memory for a CUDA tensor under gloo, else ``x`` contiguous."""
    if _world.backend == "gloo" and x.is_cuda:
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf
    return x.contiguous()


def wire_buffer(shape, dtype, device) -> torch.Tensor:
    """A receive buffer for blocks bound for ``device`` (see :func:`to_wire`)."""
    device = torch.device(device)
    if _world.backend == "gloo" and device.type == "cuda":
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


def all_gather_blocks(blocks, owner, slot, width: int, like=None) -> list:
    """Every block of a field split over the processes, in order, on this process.

    Block j is the ``slot[j]``-th of rank ``owner[j]``; ``blocks`` are this
    process's, in order (the others' arrive by one all-gather of each
    process's stack of ``width`` blocks, zero-padded).  Blocks share a shape
    and dtype; ``like`` gives them where this process holds none.  The
    blocks land on the device of this process's first block (of ``like``).
    """
    import torch.distributed as dist

    ref = blocks[0] if blocks else like
    stack = torch.zeros((width, *ref.shape), dtype=ref.dtype, device=ref.device)
    for j, b in enumerate(blocks):
        stack[j] = b
    wire = to_wire(stack)
    got = [torch.empty_like(wire) for _ in range(_world.size)]
    dist.all_gather(got, wire)
    mine = iter(blocks)
    return [next(mine) if r == _world.rank else got[r][s].to(ref.device) for r, s in zip(owner, slot)]


def _all_shards(blocks) -> list:
    """The blocks of every shard of the sharded call in progress, in shard order."""
    lay = shard_layout(len(blocks))
    if not lay.spans_processes:
        return list(blocks)
    return all_gather_blocks(blocks, lay.owner, lay.slot, lay.width)


def shard_rows(x, mesh: FlowMesh) -> list:
    """This process's row blocks of ``x`` (H, ...), block i on device i of the
    mesh's first batch row; H must divide over the row's n shards."""
    row = mesh.batch_row(0)
    n = len(row)
    if x.shape[0] % n:
        raise ValueError(f"shard_rows: {x.shape[0]} rows do not divide over {n} shards")
    Hs = x.shape[0] // n
    return [x[i * Hs : (i + 1) * Hs].to(row[i]) for i in mesh.space_layout().index]


def gather_rows(shards, device) -> torch.Tensor:
    """The row blocks of every shard joined in order on ``device``."""
    return torch.cat([s.to(device) for s in _all_shards(shards)], dim=0)


def psum(parts) -> torch.Tensor:
    """The shards' partial sums ``parts`` added in shard order on the first
    shard's device (a fixed order: runs repeat bit for bit, in one process
    or several)."""
    parts = _all_shards(parts)
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def broadcast(x, shards) -> list:
    """``x`` on the device of each of ``shards``, in shard order."""
    return [x.to(s.device) for s in shards]
