"""Halo exchange for row-sharded image fields (port of ``optical_flow_tpu/parallel/halo.py``).

The image grid is tiled along H over the mesh's ``space`` axis.  A stencil
of radius r needs r rows from each neighbouring shard: they are copied onto
the shard's device (a slice where both shards share a device).  The true
image edges (the top of shard 0, the bottom of shard n-1) are filled by
``mode``, so that every boundary convention of the pipeline runs sharded:

* ``'zero'``      — zero rows.  Right for the flow Laplacian, whose
  dangling edge weights are zero by construction (``ops/stencil.py``).
* ``'edge'``      — the edge row repeated (scipy ``nearest``): the warp's
  clamped reads.
* ``'symmetric'`` — mirrored with the edge row (scipy ``reflect``, numpy
  ``symmetric``): the derivative, pyramid and median filters.
* ``'reflect'``   — mirrored without the edge row (numpy ``reflect``, the
  port's ``"mirror"``): the weighted median and the B-spline tables.

A shard is a tensor whose axis 0 is its rows.
"""
from __future__ import annotations

import torch


def _edge_fill(x, radius: int, top: bool, mode: str):
    """The ``radius`` rows a shard at the true top (bottom) edge synthesises."""
    if mode == "zero":
        return x.new_zeros((radius,) + tuple(x.shape[1:]))
    if mode == "edge":
        return (x[:1] if top else x[-1:]).expand((radius,) + tuple(x.shape[1:]))
    if mode == "symmetric":
        return (x[:radius] if top else x[-radius:]).flip(0)
    if mode == "reflect":
        return (x[1 : radius + 1] if top else x[-radius - 1 : -1]).flip(0)
    raise ValueError(f"unknown halo mode {mode!r}")


def halo_exchange_rows(shards, radius: int, mode: str = "zero") -> list:
    """Extend each (Hs, ...) row block with ``radius`` rows of halo above and below.

    Returns the (Hs + 2 radius, ...) blocks: interior edges take the
    neighbours' boundary rows, the true top and bottom edges are filled per
    ``mode`` (see the module docstring).
    """
    if radius == 0:
        return list(shards)
    n = len(shards)
    out = []
    for i, x in enumerate(shards):
        top = shards[i - 1][-radius:].to(x.device) if i > 0 else _edge_fill(x, radius, True, mode)
        bottom = shards[i + 1][:radius].to(x.device) if i < n - 1 else _edge_fill(x, radius, False, mode)
        out.append(torch.cat([top, x, bottom], dim=0))
    return out


def _receive(strips, device) -> list:
    """The neighbour's strips of several fields on ``device``: one copy of
    their stack when the devices differ, the strips themselves when not."""
    if strips[0].device == device:
        return strips
    return list(torch.stack(strips).to(device).unbind(0))


def halo_exchange_rows_multi(fields, radius: int) -> list:
    """Halo-extend several sharded fields of one shape in one exchange, zero-filled at the true edges.

    ``fields`` is a list of sharded fields (each a list of row blocks); the
    fields' strips travel to a neighbour as one stacked copy, so the number
    of copies between devices is that of one field (the distributed PCG's u
    and v planes).  Returns the extended fields in the same layout.
    """
    n = len(fields[0])
    out = [[] for _ in fields]
    for i in range(n):
        x0 = fields[0][i]
        tops = (_receive([f[i - 1][-radius:] for f in fields], x0.device) if i > 0
                else [_edge_fill(f[i], radius, True, "zero") for f in fields])
        bottoms = (_receive([f[i + 1][:radius] for f in fields], x0.device) if i < n - 1
                   else [_edge_fill(f[i], radius, False, "zero") for f in fields])
        for k, f in enumerate(fields):
            out[k].append(torch.cat([tops[k], f[i], bottoms[k]], dim=0))
    return out
