"""Batched flow estimation over frame pairs of one shape (port of ``optical_flow_tpu/parallel/batch.py``).

B pairs run as one program, for every method family (Classic+NL, BA,
Horn–Schunck, alt-BA): every op of a family's schedule takes the leading
batch axis, so most launches of the single-pair path are issued once for
the whole batch.  The exceptions run once an item: the matrix products of
the flow resample, of the warp's Hermite table and of the B-spline
prefilter (``ops/interp.py::per_item``, so that each item gets an
unbatched call's rounding), and the PCG launches of the levels whose plan
takes one item a launch.  The whole-PCG kernel solves the B systems of a
warp iteration in one call (each item with its own stopping test), SOR
converges each item on its own, the weighted median filters all B flows in
one launch and ROF decomposes the 2B images of the batch in one call.
Each item is normalised, stopped and guarded on its own, and Horn–Schunck
ends each item's warp loop on its own, as ``jax.vmap`` of the JAX
package's whole-flow programs does, so each item gets its single-pair flow
(up to the order of the kernels' sums).

With a ``mesh`` (``parallel/mesh.py::flow_mesh(batch=b, space=s)``) the B
pairs split into b contiguous groups, one a batch row, as the JAX package
shards the batch axis alone (``P(BATCH_AXIS)``, the space axis
replicated): each group runs as one batched program on its row's first
device, and the flows are gathered in order on the mesh's first device.
Each item computes the same function as without the mesh.  ``fuse`` (TPU
compile plumbing in the JAX package) is accepted and ignored.
"""
from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.config import load_of_method
from optical_flow_tpu_torch.interface import _resolve_dtype, resolve_device
from optical_flow_tpu_torch.methods.alt_ba import AltBAOpticalFlow, alt_ba_flow_program
from optical_flow_tpu_torch.methods.ba import BAOpticalFlow, ba_flow_program
from optical_flow_tpu_torch.methods.classic_nl import ClassicNLOpticalFlow, classic_nl_flow_program
from optical_flow_tpu_torch.methods.hs import HSOpticalFlow, hs_flow_program
from optical_flow_tpu_torch.utils.compat import preprocess_color_batch

__all__ = ["estimate_flow_batched", "estimate_flow_batched_rgb", "preprocess_color_batch"]


def _batched_method(method: str, params):
    """The method object of ``method`` with ``params``."""
    ope = load_of_method(method)
    if params is not None:
        ope.parse_input_parameter(params)
    return ope


def _batch_groups(mesh, B: int, device, caller: str):
    """[(device, item slice)] of the mesh's batch rows, one contiguous group
    of the B items a row; B must divide over them, as JAX's ``device_put``
    requires.  ``device``, if given, must be the mesh's first device."""
    from optical_flow_tpu_torch.parallel.mesh import BATCH_AXIS, FlowMesh, canonical_device

    if not isinstance(mesh, FlowMesh):
        raise TypeError(f"{caller}(mesh=...): expected a parallel.mesh.flow_mesh(...), got {type(mesh).__name__}")
    rows = mesh.shape[BATCH_AXIS]
    if B % rows:
        raise ValueError(f"{caller}: a batch of {B} pairs does not divide over the mesh's {rows} batch rows")
    if device is not None and canonical_device(device) != mesh.devices[0]:
        raise ValueError(f"{caller}(device={device!r}) disagrees with the mesh's first device {mesh.devices[0]}")
    per = B // rows
    return [(mesh.batch_row(g)[0], slice(g * per, (g + 1) * per)) for g in range(rows)]


def _as_batch(x, dtype, dev):
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=dtype)
    return torch.as_tensor(np.array(x)).to(device=dev, dtype=dtype)


def estimate_flow_batched(images_batch, method: str = "hs-brightness", mesh=None, params=None, color_batch=None,
                          device=None):
    """Estimate flow for a (B, H, W, 2) batch of gray frame pairs -> (B, H, W, 2).

    All pairs share one pyramid schedule and run as one program.
    ``color_batch``: optional (B, H, W, 3) guides for the non-local term
    ([0, 255]-scaled Lab of frame 1, as :func:`preprocess_color_batch` makes
    them; (B, H, W) gray guides work too).  With it the batch runs the
    colour-guided weighted median of the single-pair path; without it, the
    plain-median route, as the JAX package and the reference do without a
    guide.  The other families take no guide and ignore it.  ``device``:
    ``"cuda"`` (the default without a mesh; raises without a GPU) or
    ``"cpu"``.  ``mesh``: the batch splits over its batch rows (see the
    module docstring); ``device`` then defaults to, and must name, the
    mesh's first device, where the flows are gathered.

    Every family follows its single-pair plan, which is the JAX package's
    fused program: ``jax.vmap`` of the family's whole-flow program.  Its
    unfused batched route knows only texture and rescale preprocessing, so
    for the BA presets with the high-pass (``fc``) the fused route is the
    one this matches.  Alt-BA returns its auxiliary field, as there.
    """
    if mesh is not None:
        B = len(images_batch)
        groups = _batch_groups(mesh, B, device, "estimate_flow_batched")
        first = resolve_device(mesh.devices[0], "estimate_flow_batched")
        uv = [estimate_flow_batched(images_batch[sl], method, params=params, device=dev,
                                    color_batch=None if color_batch is None else color_batch[sl])
              for dev, sl in groups]
        return torch.cat([x.to(first) for x in uv])
    ope = _batched_method(method, params)
    dev = resolve_device("cuda" if device is None else device, "estimate_flow_batched")
    dtype = _resolve_dtype(ope.dtype)
    with torch.no_grad():
        images = _as_batch(images_batch, dtype, dev)
        if images.ndim != 4 or images.shape[-1] % 2:
            raise ValueError(f"expected (B, H, W, 2C) frame pairs, got {tuple(images.shape)}")
        B, H, W = images.shape[:3]
        uv = torch.zeros((B, H, W, 2), dtype=dtype, device=dev)
        # exact types: alt-BA and Classic+NL subclass BA
        if type(ope) is HSOpticalFlow:
            uv = hs_flow_program(ope._make_plan((H, W)), images, uv)
        elif type(ope) is BAOpticalFlow:
            uv = ba_flow_program(ope._make_plan((H, W)), images, uv)
        elif type(ope) is AltBAOpticalFlow:
            uv = alt_ba_flow_program(ope._make_alt_plan((H, W)), images, uv, uv)  # the auxiliary field
        else:
            color = None if color_batch is None else _as_batch(color_batch, dtype, dev)
            plan = ope._make_nl_plan((H, W), use_color=color is not None)
            uv = classic_nl_flow_program(plan, images, color, uv)
        if ope.out_dtype is not None:
            uv = uv.to(_resolve_dtype(ope.out_dtype))
    return uv


def estimate_flow_batched_rgb(im1_batch, im2_batch, method: str = "classic+nl-fast", mesh=None, params=None,
                              device=None):
    """(B, H, W, 3) RGB frame pairs -> (B, H, W, 2) flows, one program.

    The batched single-pair RGB path: MATLAB-exact gray conversion and the
    [0, 255]-Lab guide of every pair (each item rescaled on its own), then
    :func:`estimate_flow_batched` with the guides where a Classic+NL method
    asks for colour; the other families run on the gray pairs.  With a
    ``mesh`` the conversion runs on its first device and the batch splits
    over its batch rows, as :func:`estimate_flow_batched`.
    """
    ope = _batched_method(method, params)
    if mesh is not None:
        _batch_groups(mesh, len(im1_batch), device, "estimate_flow_batched_rgb")
        device = mesh.devices[0]
    dev = resolve_device("cuda" if device is None else device, "estimate_flow_batched_rgb")
    dtype = _resolve_dtype(ope.dtype)
    with torch.no_grad():
        im1, im2 = _as_batch(im1_batch, dtype, dev), _as_batch(im2_batch, dtype, dev)
        if im1.shape != im2.shape or im1.ndim != 4 or im1.shape[-1] < 3:
            raise ValueError(f"expected two (B, H, W, 3) RGB batches, got {tuple(im1.shape)} and {tuple(im2.shape)}")
        images, lab = preprocess_color_batch(im1, im2)
    want_color = ope.color_images is not None and type(ope) is ClassicNLOpticalFlow
    return estimate_flow_batched(images, method, mesh=mesh, params=params, color_batch=lab if want_color else None,
                                 device=dev)
