"""Visualisation and profiling of the port against the JAX package.

``viz/flow_color.py`` is a copy, pinned to the original below its docstring;
``plot_flow`` renders the same arrays in its four styles (under Agg), from
numpy or a tensor; ``utils/profiling.py`` writes a trace holding its
annotations, and ``StageTimer`` reports in the JAX package's format.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
matplotlib = pytest.importorskip("matplotlib")
matplotlib.use("Agg")

from torch_parity import one_cpu_thread, t  # noqa: E402,F401

STYLES = ["color", "quiver", "magnitude", "hsv"]


def _body(path):
    """A module's source below its docstring."""
    src = open(path).read()
    return src[src.index('"""', 3) + 3 :]


def _flow():
    """A seeded (20, 30, 2) flow with a few unknown (1e10) pixels."""
    uv = 3 * np.random.default_rng(0).standard_normal((20, 30, 2))
    uv[2, 3, 0] = uv[5, 7, 1] = 1e10
    return uv


def test_flow_color_copy_is_pinned_to_the_original():
    import optical_flow_tpu.viz.flow_color as J
    import optical_flow_tpu_torch.viz.flow_color as P

    assert _body(P.__file__) == _body(J.__file__)
    uv = _flow()
    for max_flow in (None, 2.0):
        np.testing.assert_array_equal(P.flow_to_color(uv, max_flow=max_flow), J.flow_to_color(uv, max_flow=max_flow))
    np.testing.assert_array_equal(P.make_colorwheel(), J.make_colorwheel())
    np.testing.assert_array_equal(P.compute_color(uv[..., 0] / 9, uv[..., 1] / 9),
                                  J.compute_color(uv[..., 0] / 9, uv[..., 1] / 9))


def _rendered(ax):
    """What the axes show: the image arrays, or the quiver's arrows, and the title."""
    images = [np.asarray(im.get_array()) for im in ax.get_images()]
    arrows = [np.stack([np.asarray(q.U), np.asarray(q.V)]) for q in ax.collections]
    return images, arrows, ax.get_title()


@pytest.mark.parametrize("style", STYLES)
def test_plot_flow_renders_what_jax_renders(style):
    """Each style draws the same arrays and title as the JAX package's, from a
    numpy flow and from a tensor, the unknown pixels suppressed."""
    import matplotlib.pyplot as plt

    from optical_flow_tpu.viz.plot_flow import plot_flow as pj
    from optical_flow_tpu_torch.viz.plot_flow import plot_flow as pp

    uv = _flow()
    shown = []
    for fn, arg in ((pj, uv), (pp, uv), (pp, t(uv))):
        fig, ax = plt.subplots()
        shown.append(_rendered(fn(arg, style=style, ax=ax, step=3)))
        plt.close(fig)
    ref = shown[0]
    assert ref[0] or ref[1]
    for images, arrows, title in shown[1:]:
        assert title == ref[2]
        assert len(images) == len(ref[0]) and len(arrows) == len(ref[1])
        for a, b in zip(images + arrows, ref[0] + ref[1]):
            np.testing.assert_array_equal(a, b)
    if style == "magnitude":
        assert ref[0][0].max() < 1e9  # the unknown pixels are not drawn at 1e10


def test_plot_flow_makes_its_own_axes_and_refuses_an_unknown_style():
    import matplotlib.pyplot as plt

    from optical_flow_tpu_torch.viz import plot_flow

    ax = plot_flow(_flow())
    assert ax.get_title() == "Optical Flow (Color)"
    plt.close(ax.figure)
    with pytest.raises(ValueError, match="Unknown style"):
        plot_flow(_flow(), style="arrows")


def test_trace_writes_a_file_holding_the_annotation(tmp_path):
    from optical_flow_tpu_torch.utils.profiling import annotate, trace

    with trace(str(tmp_path)):
        with annotate("flow-stage"):
            torch.ones(64, 64).matmul(torch.ones(64, 64))
    path = tmp_path / "trace.json"
    assert path.is_file() and os.path.getsize(path) > 0
    assert "flow-stage" in path.read_text()


def test_stage_timer_reports_in_the_jax_format():
    """The same records give the JAX package's totals and report, character for
    character; ``sync`` takes a tensor or a list of them, and times are positive."""
    from optical_flow_tpu.utils.profiling import StageTimer as TJ
    from optical_flow_tpu_torch.utils.profiling import StageTimer as TP

    records = [("pyramid", 0.0123), ("levels", 1.5), ("pyramid", 0.0011), ("wmedian", 0.25)]
    tj, tp = TJ(), TP()
    tj.records, tp.records = list(records), list(records)
    assert tp.totals() == tj.totals()
    assert tp.report() == tj.report()
    assert TP().report() == TJ().report() == ""
    timer = TP()
    x = torch.ones(8)
    with timer.stage("a", sync=x):
        x = x * 2
    with timer.stage("b", sync=[x, x]):
        pass
    assert [name for name, _ in timer.records] == ["a", "b"] and all(dt > 0 for _, dt in timer.records)
