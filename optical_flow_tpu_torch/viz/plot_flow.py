"""Flow-field plotting (port of ``optical_flow_tpu/viz/plot_flow.py``).

The same four styles (``color``, ``quiver``, ``magnitude``, ``hsv``) and the
same unknown-flow suppression as the JAX package; the flow may be a numpy
array or a tensor on any device (it is read to the host).  matplotlib is
optional: it is imported by :func:`plot_flow`, never when the package is.
"""
from __future__ import annotations

import numpy as np

from optical_flow_tpu_torch.viz.flow_color import UNKNOWN_FLOW_THRESH, flow_to_color

_RENDERERS = {}


def _style(name):
    def register(fn):
        _RENDERERS[name] = fn
        return fn

    return register


@_style("color")
def _render_middlebury(ax, u, v, uv, max_flow, step):
    ax.imshow(flow_to_color(uv, max_flow=max_flow))
    return "Optical Flow (Color)"


@_style("quiver")
def _render_quiver(ax, u, v, uv, max_flow, step):
    rows, cols = np.mgrid[0 : u.shape[0] : step, 0 : u.shape[1] : step]
    ax.quiver(cols, rows, u[::step, ::step], v[::step, ::step], angles="xy")
    # image convention: row 0 on top
    ax.set_ylim(u.shape[0], 0)
    ax.set_xlim(0, u.shape[1])
    ax.set_aspect("equal")
    return "Optical Flow (Quiver)"


@_style("magnitude")
def _render_magnitude(ax, u, v, uv, max_flow, step):
    ax.imshow(np.sqrt(u * u + v * v), cmap="jet")
    return "Flow Magnitude"


@_style("hsv")
def _render_hsv(ax, u, v, uv, max_flow, step):
    from matplotlib.colors import hsv_to_rgb

    magnitude = np.sqrt(u * u + v * v)
    peak = magnitude.max() if max_flow is None else max_flow
    hsv = np.stack(
        [
            (np.arctan2(v, u) + np.pi) / (2 * np.pi),  # hue <- direction
            np.ones_like(u),
            np.clip(magnitude / max(peak, 1e-8), 0, 1),  # value <- speed
        ],
        axis=-1,
    )
    ax.imshow(hsv_to_rgb(hsv))
    return "Optical Flow (HSV)"


def plot_flow(uv, style: str = "color", ax=None, max_flow=None, step: int = 1):
    """Render an (H, W, 2) flow field (numpy or tensor) in the given style; returns the axes."""
    try:
        renderer = _RENDERERS[style]
    except KeyError:
        raise ValueError(f"Unknown style: {style}") from None

    uv = uv.detach().cpu().numpy() if hasattr(uv, "detach") else np.asarray(uv)
    # .flo sentinel values (~1e9) would swamp every renderer's scaling;
    # a pixel is unknown if either component carries the sentinel
    unknown = np.any(np.abs(uv) > UNKNOWN_FLOW_THRESH, axis=-1)
    u = np.where(unknown, 0.0, uv[:, :, 0].astype(float))
    v = np.where(unknown, 0.0, uv[:, :, 1].astype(float))

    if ax is None:
        import matplotlib.pyplot as plt

        ax = plt.subplots(1, 1, figsize=(8, 6))[1]
    ax.set_title(renderer(ax, u, v, uv, max_flow, step))
    ax.axis("off")
    return ax
