"""Device mesh for row-sharded flow estimation (port of ``optical_flow_tpu/parallel/mesh.py``).

A mesh is one process over an ordered list of devices: a (batch = 1,
space = n) grid of ``torch.device``s.  Image rows are tiled over the
``space`` axis: a sharded field is a list of n row blocks, block i on
device i.  The same device may appear more than once (n shards on one
card, or n shards on the CPU).  Nothing here uses ``torch.distributed``:
the collectives are copies between the shards' devices, issued from the
one process, in shard order, so that a run repeats bit for bit.

The batch × space mesh and multi-process runs are ROADMAP item 14b.
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
    """The shards' devices, in shard order (shard i holds the i-th row block)."""

    devices: tuple

    @property
    def shape(self) -> dict:
        """Axis sizes by name, as a JAX mesh's ``shape``."""
        return {BATCH_AXIS: 1, SPACE_AXIS: len(self.devices)}


def flow_mesh(batch: int = 1, space: Optional[int] = None, devices: Optional[Sequence] = None) -> FlowMesh:
    """A (batch = 1, space) mesh over ``devices`` (default: every visible CUDA device).

    ``space`` defaults to the number of devices and must equal it.  A device
    may be listed more than once, e.g. ``devices=["cpu"] * 8``.
    """
    if batch != 1:
        raise NotImplementedError(f"flow_mesh(batch={batch}): the batch x space mesh is ROADMAP item 14b")
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("flow_mesh(): no CUDA device is visible; pass devices, e.g. ['cpu'] * n")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = tuple(canonical_device(d) for d in devices)
    n = len(devices)
    if space is None:
        space = n
    if space != n or n < 1:
        raise ValueError(f"batch*space = {space} != {n} devices")
    return FlowMesh(devices)


def shard_rows(x, mesh: FlowMesh) -> list:
    """The n row blocks of ``x`` (H, ...), block i on the mesh's device i; H must divide n."""
    n = len(mesh.devices)
    if x.shape[0] % n:
        raise ValueError(f"shard_rows: {x.shape[0]} rows do not divide over {n} shards")
    Hs = x.shape[0] // n
    return [x[i * Hs : (i + 1) * Hs].to(d) for i, d in enumerate(mesh.devices)]


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
