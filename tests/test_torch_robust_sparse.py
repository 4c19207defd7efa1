"""The port's ``robust/`` shim and ``ops/sparse_compat.py`` against the JAX package, in float64 on the CPU.

``RobustFunction(name, *params)`` gives JAX's descriptor and its values for
each of the ten implemented penalties at two parameter sets; ``mixture`` and
``spline_penalty`` raise in both packages.  ``sparse_compat`` is a copy,
pinned to the original below its docstring, whose matrices equal JAX's and
whose ``make_imfilter_mat`` applies the port's ``correlate2d``.
"""
import ast
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_parity import n, one_cpu_thread, t  # noqa: E402,F401

REPO = pathlib.Path(__file__).resolve().parents[1]

PARAMS = {
    "quadratic": [(0.03,), (1.5,)],
    "lorentzian": [(0.03,), (1.5,)],
    "charbonnier": [(1e-3,), (0.8,)],
    "generalized_charbonnier": [(1e-3, 0.45), (0.5, 0.3)],
    "geman_mcclure": [(0.03,), (1.5,)],
    "huber": [(0.03,), (1.2,)],
    "tukey": [(0.5,), (2.0,)],
    "gaussian": [(0.03,), (1.5,)],
    "tdist": [(2.0, 0.5), (5.0, 1.2)],
    "tdist_unnorm": [(2.0, 0.5), (5.0, 1.2)],
}
CASES = [(name, p) for name, sets in PARAMS.items() for p in sets]


def _x():
    """Seeded values over several scales, with 0 and the thresholds of huber and tukey."""
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.standard_normal(64) * s for s in (1e-3, 0.1, 2.0)])
    return np.concatenate([x, [0.0, 9e-4, -9e-4, 0.5, -2.0, 1.44]])


@pytest.mark.parametrize("name,params", CASES, ids=[f"{nm}-{i}" for nm, sets in PARAMS.items() for i in range(2)])
def test_robust_function_matches_jax(name, params):
    """The same descriptor (name and float params), and evaluate / deriv /
    deriv_over_x within 1e-12."""
    from optical_flow_tpu.robust import RobustFunction as RJ
    from optical_flow_tpu_torch.robust import RobustFunction as RP

    rj, rp = RJ(name, *params), RP(name, *params)
    assert (rp.name, rp.params, rp.param) == (rj.name, rj.params, rj.param)
    x = _x()
    for fn in ("evaluate", "deriv", "deriv_over_x", "evaluate_log"):
        np.testing.assert_allclose(n(getattr(rp, fn)(t(x))), n(getattr(rj, fn)(x)), rtol=1e-12, atol=1e-12, err_msg=fn)


def test_robust_defaults_and_unimplemented_penalties_match_jax():
    """No params give (1.0,); ``mixture`` and ``spline_penalty`` raise
    ``NotImplementedError`` with JAX's messages, as functions and as
    descriptors; an unknown name raises ``ValueError`` in both."""
    import optical_flow_tpu.ops.penalties as PJ
    import optical_flow_tpu.robust as RJ
    import optical_flow_tpu_torch.ops.penalties as PP
    import optical_flow_tpu_torch.robust as RP

    assert RP.RobustFunction("lorentzian") == PP.robust("lorentzian") == PP.Robust("lorentzian", (1.0,))
    assert RP.RobustFunction("lorentzian").params == RJ.RobustFunction("lorentzian").params == (1.0,)
    assert sorted(RP.PENALTY_MAP) == sorted(RJ.PENALTY_MAP) and RP.__all__ == RJ.__all__
    x = np.zeros(3)
    for fn in ("mixture", "spline_penalty"):
        messages = []
        for mod, arr in ((PJ, x), (PP, t(x))):
            with pytest.raises(NotImplementedError) as err:
                getattr(mod, fn)(arr, (1.0,), 0)
            messages.append(str(err.value))
        assert messages[0] == messages[1]
        for R in (RJ, RP):
            with pytest.raises(NotImplementedError):
                R.RobustFunction(fn, 1.0)
    for R in (RJ, RP):
        with pytest.raises(ValueError):
            R.RobustFunction("no_such_penalty")


def test_robust_penalties_module_reexports_jax_names():
    """``robust.penalties`` offers the 13 names JAX's module imports, each the
    port's ``ops.penalties`` object; ``robust_function`` exports ``Robust``."""
    import optical_flow_tpu_torch.ops.penalties as PP
    import optical_flow_tpu_torch.robust.penalties as RPP
    from optical_flow_tpu_torch.robust.robust_function import Robust

    tree = ast.parse((REPO / "optical_flow_tpu" / "robust" / "penalties.py").read_text())
    names = [a.name for node in tree.body if isinstance(node, ast.ImportFrom) for a in node.names]
    assert len(names) == 13
    for name in names:
        assert getattr(RPP, name) is getattr(PP, name), name
    assert Robust is PP.Robust


# ------------------------------------------------------------------ sparse_compat

FILTERS = [
    np.array([[1.0, 2.0, 1.0], [2.0, 4.0, 2.0], [1.0, 2.0, 1.0]]) / 16,  # 3x3
    np.array([[1.0, -2.0, 0.5, 3.0], [0.0, 1.5, -1.0, 2.0]]),  # 2x4: non-square, even-sized
    np.array([[1.0, -8.0, 0.0, 8.0, -1.0]]) / 12,  # 1x5
]
SIZES = [(5, 6), (7, 4), (6, 9)]


def _body(path):
    src = open(path).read()
    return src[src.index('"""', 3) + 3 :]


def test_sparse_compat_copy_is_pinned_to_the_original():
    import optical_flow_tpu.ops.sparse_compat as J
    import optical_flow_tpu_torch.ops.sparse_compat as P

    assert _body(P.__file__) == _body(J.__file__)


@pytest.mark.parametrize("k", range(3))
def test_sparse_compat_matrices_equal_jax(k):
    """convmtxn, make_convn_mat (full / same / valid / valid + sameswap) and
    make_imfilter_mat (replicate / 0 / symmetric) equal JAX's, bit for bit."""
    import optical_flow_tpu.ops.sparse_compat as J
    import optical_flow_tpu_torch.ops.sparse_compat as P

    F, sz = FILTERS[k], SIZES[k]
    np.testing.assert_array_equal(P.convmtxn(F, sz), J.convmtxn(F, sz))
    for shape, pad in (("full", None), ("same", None), ("valid", None), ("valid", "sameswap")):
        np.testing.assert_array_equal(P.make_convn_mat(F, sz, shape, pad), J.make_convn_mat(F, sz, shape, pad))
    for boundary in ("replicate", "0", "symmetric"):
        np.testing.assert_array_equal(P.make_imfilter_mat(F, sz, boundary), J.make_imfilter_mat(F, sz, boundary))


@pytest.mark.parametrize("boundary,scipy_mode", [("symmetric", "reflect"), ("replicate", "nearest")])
def test_imfilter_mat_applies_the_ports_correlate2d(boundary, scipy_mode):
    """One make_imfilter_mat on a vectorised (Fortran order) 9x11 image equals
    ``ops/filters.py::correlate2d`` within 1e-12."""
    from optical_flow_tpu_torch.ops.filters import correlate2d
    from optical_flow_tpu_torch.ops.sparse_compat import make_imfilter_mat

    rng = np.random.default_rng(5)
    F = rng.standard_normal((3, 5))
    im = rng.uniform(0, 255, (9, 11))
    out = (make_imfilter_mat(F, im.shape, boundary) @ im.ravel(order="F")).reshape(im.shape, order="F")
    np.testing.assert_allclose(out, n(correlate2d(t(im), F, scipy_mode)), rtol=0, atol=1e-12)
