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

A shard is a tensor whose axis 0 is its rows.  A sharded field holds this
process's shards; a neighbour in another process (a mesh that spans
processes, ``parallel/mesh.py``) sends its strips by ``torch.distributed``
point-to-point messages.
"""
from __future__ import annotations

import torch

from optical_flow_tpu_torch.parallel.mesh import shard_layout, to_wire, wire_buffer, world


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
    out = []
    for x, (top, bottom) in zip(shards, _neighbour_strips([shards], radius)):
        top = top[0] if top is not None else _edge_fill(x, radius, True, mode)
        bottom = bottom[0] if bottom is not None else _edge_fill(x, radius, False, mode)
        out.append(torch.cat([top, x, bottom], dim=0))
    return out


def _receive(strips, device) -> list:
    """The neighbour's strips of several fields on ``device``: one copy of
    their stack when the devices differ, the strips themselves when not."""
    if strips[0].device == device:
        return strips
    if len(strips) == 1:
        return [strips[0].to(device)]
    return list(torch.stack(strips).to(device).unbind(0))


def _neighbour_strips(fields, radius: int) -> list:
    """For each of this process's shards, (the strips of every field from the
    shard above, those from the shard below), each None at a true image edge.

    A neighbour in this process gives its strips by copy; one in another
    process sends them as one stacked message (``_exchange``).
    """
    lay = shard_layout(len(fields[0]))
    pos = {g: k for k, g in enumerate(lay.index)}
    remote = _exchange(fields, radius, lay, pos) if lay.spans_processes else {}
    out = []
    for k, g in enumerate(lay.index):
        dev = fields[0][k].device
        ends = []
        for nb, rows in ((g - 1, slice(-radius, None)), (g + 1, slice(0, radius))):
            if not 0 <= nb < lay.n:
                ends.append(None)
            elif nb in pos:
                ends.append(_receive([f[pos[nb]][rows] for f in fields], dev))
            else:
                ends.append(remote[(g, nb)])
        out.append(tuple(ends))
    return out


def _exchange(fields, radius: int, lay, pos) -> dict:
    """{(shard, neighbour): the neighbour's strips} for the neighbours of this
    process's shards held by other processes.

    Each shard sends its top rows to the shard above and its bottom rows to
    the shard below when that shard is another process's, every field's
    strip in one stacked message tagged with the receiving halo (2 g for
    shard g's top, 2 g + 1 for its bottom).  Under NCCL the messages post as
    one batch; under gloo CUDA strips are staged through pinned host buffers.
    """
    import torch.distributed as dist

    ops, recvs = [], []
    for k, g in enumerate(lay.index):
        x0 = fields[0][k]
        shape = (len(fields), radius, *x0.shape[1:])
        for nb, rows, tag in ((g - 1, slice(0, radius), 2 * (g - 1) + 1), (g + 1, slice(-radius, None), 2 * (g + 1))):
            if 0 <= nb < lay.n and nb not in pos:
                ops.append((dist.isend, to_wire(torch.stack([f[k][rows] for f in fields])), lay.owner[nb], tag))
        for nb, tag in ((g - 1, 2 * g), (g + 1, 2 * g + 1)):
            if 0 <= nb < lay.n and nb not in pos:
                buf = wire_buffer(shape, x0.dtype, x0.device)
                ops.append((dist.irecv, buf, lay.owner[nb], tag))
                recvs.append(((g, nb), buf, x0.device))
    if world().backend == "nccl":
        works = dist.batch_isend_irecv([dist.P2POp(op, t, peer, tag=tag) for op, t, peer, tag in ops]) if ops else []
    else:
        works = [op(t, peer, tag=tag) for op, t, peer, tag in ops]
    for w in works:
        w.wait()
    return {key: list(buf.to(dev).unbind(0)) for key, buf, dev in recvs}


def halo_exchange_rows_multi(fields, radius: int) -> list:
    """Halo-extend several sharded fields of one shape in one exchange, zero-filled at the true edges.

    ``fields`` is a list of sharded fields (each a list of row blocks); the
    fields' strips travel to a neighbour as one stacked copy or message, so
    the number of copies between devices is that of one field (the
    distributed PCG's u and v planes).  Returns the extended fields in the
    same layout.
    """
    out = [[] for _ in fields]
    for i, (tops, bottoms) in enumerate(_neighbour_strips(fields, radius)):
        for k, f in enumerate(fields):
            top = tops[k] if tops is not None else _edge_fill(f[i], radius, True, "zero")
            bottom = bottoms[k] if bottoms is not None else _edge_fill(f[i], radius, False, "zero")
            out[k].append(torch.cat([top, f[i], bottom], dim=0))
    return out
