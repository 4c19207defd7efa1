"""High-level interface: ``estimate_flow(im1, im2, method, params, device)`` (port of ``optical_flow_tpu/interface.py``).

Grayscale conversion (MATLAB uint8-quantized), the Lab guide for the
non-local term (channels rescaled to [0, 255]), parameter overrides and
dispatch.  The device is explicit: ``"cuda"`` without a GPU raises, and the
CPU runs only when asked for by name.  A ``mesh`` (``parallel/mesh.py``)
runs the levels row-sharded, or raises: it never computes unsharded.
"""
from __future__ import annotations

import numpy as np
import torch

from optical_flow_tpu_torch.config import load_of_method
from optical_flow_tpu_torch.utils.compat import preprocess_color_pair
from optical_flow_tpu_torch.utils.profiling import annotate


def _resolve_dtype(dt):
    return getattr(torch, dt) if isinstance(dt, str) else dt


def resolve_device(device, caller: str = "estimate_flow") -> torch.device:
    """``device`` as a torch device; the card without a GPU raises (no CPU fallback)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{caller}(device='cuda'): no CUDA device is available")
    return dev


def _apply_mesh(ope, method: str, mesh, device) -> torch.device:
    """Check that ``ope`` can run row-sharded on ``mesh``, set the mesh on it,
    and return the device of the whole-image work: the mesh's first device
    (of this process, when the mesh spans processes).  The rows shard over
    the space axis of the mesh's first batch row: the JAX package replicates
    a single pair over the batch axis."""
    from optical_flow_tpu_torch.parallel.mesh import FlowMesh, canonical_device
    from optical_flow_tpu_torch.parallel.spatial import check_spatial_config

    if not isinstance(mesh, FlowMesh):
        raise TypeError(f"estimate_flow(mesh=...): expected a parallel.mesh.flow_mesh(...), got {type(mesh).__name__}")
    if not ope.spatial_mesh_supported:
        raise ValueError(
            f"method {method!r} does not support spatial sharding (mesh=); supported families: hs, "
            "ba/classic-c/classic++, classic+nl, alt-ba/classic-c-a"
        )
    check_spatial_config(str(ope.interpolation_method), str(ope.solver))
    first = mesh.home
    if device is not None and canonical_device(device) != first:
        raise ValueError(f"estimate_flow(device={device!r}) disagrees with the mesh's first device {first}")
    ope.spatial_mesh = mesh
    return resolve_device(first)


def estimate_flow(im1, im2, method: str = "classic+nl-fast", params=None, device=None, mesh=None):
    """Estimate optical flow between two images.

    Args:
        im1, im2: (H, W) grayscale or (H, W, 3) RGB images (float or uint8);
            (H, W, C) frames with C < 3 are taken channel by channel, the pair
            as (H, W, 2C), with the raw first frame as the colour guide.
        method: preset name (see :func:`~optical_flow_tpu_torch.config.load_of_method`).
        params: optional dict (or MATLAB-style k/v list) of overrides, e.g.
            ``{"solver": "pcg"}``, ``{"dtype": torch.float64}`` or
            ``{"out_dtype": "float16"}``.
        device: ``"cuda"`` (the default without a mesh; raises without a GPU)
            or ``"cpu"``.  With a mesh it defaults to the mesh's first device
            (this process's first, when the mesh spans processes) and must
            name it if given.
        mesh: optional :func:`~optical_flow_tpu_torch.parallel.mesh.flow_mesh`:
            every pyramid level that tiles runs on its row shards (halo
            exchange and distributed PCG, ``parallel/spatial.py``), over
            the space axis of its first batch row; every family shards.
            A mesh that spans processes (``initialize_distributed``) runs
            the call in every process on the same input; each process
            computes its own shards and gets the whole flow (and calls a
            checkpointer with every gathered level).
            ``params["spatial_halo"]`` fixes the warp halo; ``"auto"``
            sizes it a level from the incoming flow.  SOR, an unknown
            interpolation or a method class without a sharded level raises
            ``ValueError``.

    Returns:
        uv: (H, W, 2) tensor on ``device``; uv[..., 0] horizontal, uv[..., 1] vertical.
    """
    im1 = np.asarray(im1)
    im2 = np.asarray(im2)
    if im1.shape != im2.shape:
        raise ValueError(f"frame shapes differ: {im1.shape} vs {im2.shape}")

    ope = load_of_method(method)
    if params is not None:
        ope.parse_input_parameter(params)
    dev = resolve_device("cuda" if device is None else device) if mesh is None else _apply_mesh(ope, method, mesh, device)
    with torch.no_grad(), annotate("entry", B=1, **dict(zip("HW", im1.shape)), method=method):
        # the JAX package's call: the pair and, where the preset asks for
        # colour, the guide go on the method object
        with annotate("prepare", bytes=im1.nbytes + im2.nbytes):
            ope.images, color = prepare_pair(ope, im1, im2, dev)
        if ope.color_images is not None:
            ope.color_images = color
        uv = ope.compute_flow()
        if ope.out_dtype is not None:
            uv = uv.to(_resolve_dtype(ope.out_dtype))
    return uv


def prepare_pair(ope, im1, im2, dev, small_channel_guide: bool = True):
    """(images (H, W, 2C), colour guide or None) of a numpy frame pair on
    ``dev``, in the method's compute dtype.

    RGB frames give the gray pair and the [0, 255]-Lab guide; a gray pair
    and (H, W, C < 3) frames (taken channel by channel) give the raw first
    frame as the guide, the latter only with ``small_channel_guide``.  The
    guide is None unless the method asks for colour.
    """
    dtype = _resolve_dtype(ope.dtype)
    a1 = torch.as_tensor(np.ascontiguousarray(im1)).to(device=dev, dtype=dtype)
    a2 = torch.as_tensor(np.ascontiguousarray(im2)).to(device=dev, dtype=dtype)
    want_color = ope.color_images is not None
    if a1.ndim == 3 and a1.shape[2] >= 3:
        images, lab = preprocess_color_pair(a1, a2)
        return images, lab if want_color else None
    if a1.ndim == 2:
        return torch.stack([a1, a2], dim=2), a1 if want_color else None
    if a1.ndim == 3:
        return torch.cat([a1, a2], dim=2), a1 if want_color and small_channel_guide else None
    raise ValueError(f"expected (H, W) or (H, W, C) frames, got {tuple(a1.shape)}")
