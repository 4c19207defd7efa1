"""Device mesh for multi-device flow estimation (port of ``optical_flow_tpu/parallel/mesh.py``).

A mesh is one process over a (batch, space) grid of ``torch.device``s,
held row-major: batch row b is ``devices[b * space : (b + 1) * space]``.

* ``space``: image rows are tiled over it.  A sharded field is a list of
  ``space`` row blocks, block i on device i of the first batch row.
* ``batch``: frame pairs are split over it (``parallel/batch.py``), one
  contiguous group a batch row.

The same device may appear more than once (n shards on one card, or n
shards on the CPU).  Nothing here uses ``torch.distributed``: the
collectives are copies between the shards' devices, issued from the one
process, in shard order, so that a run repeats bit for bit.
Multi-process runs are ROADMAP item 14c.
"""
from __future__ import annotations

import dataclasses
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


@dataclasses.dataclass(frozen=True)
class FlowMesh:
    """A (batch, space) grid of devices, row-major; shard i of a row-sharded
    field lives on ``devices[i]`` (the first batch row)."""

    devices: tuple
    batch: int = 1

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {BATCH_AXIS: self.batch, SPACE_AXIS: len(self.devices) // self.batch}

    def batch_row(self, b: int) -> tuple:
        """The devices of batch row ``b``."""
        space = self.shape[SPACE_AXIS]
        return self.devices[b * space : (b + 1) * space]


def flow_mesh(batch: int = 1, space: Optional[int] = None, devices: Optional[Sequence] = None) -> FlowMesh:
    """A (batch, space) mesh over ``devices`` (default: every visible CUDA device).

    ``space`` defaults to the number of devices over ``batch``; ``batch *
    space`` must equal it.  A device may be listed more than once, e.g.
    ``devices=["cpu"] * 8``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("flow_mesh(): no CUDA device is visible; pass devices, e.g. ['cpu'] * n")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(canonical_device(d) for d in devices)
    n = len(devices)
    if space is None:
        if batch < 1 or n % batch:
            raise ValueError(f"{n} devices not divisible by batch={batch}")
        space = n // batch
    if batch * space != n or n < 1:
        raise ValueError(f"batch*space = {batch * space} != {n} devices")
    return FlowMesh(devices, int(batch))


def shard_rows(x, mesh: FlowMesh) -> list:
    """The n row blocks of ``x`` (H, ...), block i on device i of the mesh's
    first batch row; H must divide n."""
    row = mesh.batch_row(0)
    n = len(row)
    if x.shape[0] % n:
        raise ValueError(f"shard_rows: {x.shape[0]} rows do not divide over {n} shards")
    Hs = x.shape[0] // n
    return [x[i * Hs : (i + 1) * Hs].to(d) for i, d in enumerate(row)]


def gather_rows(shards, device) -> torch.Tensor:
    """The row blocks ``shards`` joined in order on ``device``."""
    return torch.cat([s.to(device) for s in shards], dim=0)


def psum(parts) -> torch.Tensor:
    """The shards' partial sums ``parts`` added in shard order on the first
    shard's device (a fixed order: runs repeat bit for bit)."""
    total = parts[0]
    for p in parts[1:]:
        total = total + p.to(total.device)
    return total


def broadcast(x, shards) -> list:
    """``x`` on the device of each of ``shards``, in shard order."""
    return [x.to(s.device) for s in shards]
