"""The port's presets, method state and package boundary against the JAX package."""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

from torch_parity import jax_method_state  # noqa: E402

PORTED = ["classic+nl", "classic+nl-fast", "classic+nl-full"]
NOT_PORTED = [
    "hs-brightness", "hs", "ba-brightness", "ba", "classic-l",
    "classic-c-brightness", "classic-c", "classic++", "classic-c-a",
]


def _plain(val):
    """Comparable form of an attribute value of either package."""
    if hasattr(val, "name") and hasattr(val, "params"):
        return ("robust", val.name, tuple(val.params))
    if isinstance(val, (list, tuple)):
        return tuple(_plain(v) for v in val)
    if isinstance(val, np.ndarray):
        return ("array", val.shape, tuple(val.ravel().tolist()))
    if isinstance(val, torch.dtype):
        return str(val).replace("torch.", "")
    return val


@pytest.mark.parametrize("name", PORTED)
def test_method_from_state_equals_load_of_method(name):
    from optical_flow_tpu_torch.config import load_of_method, method_from_state

    state = jax_method_state(name)
    from_state = method_from_state(state)
    loaded = load_of_method(name)
    assert set(vars(from_state)) == set(vars(loaded))
    for key in vars(loaded):
        assert _plain(getattr(from_state, key)) == _plain(getattr(loaded, key)), key
    # every setting the JAX object carries (bar its JAX-only machinery) is in the port's
    from optical_flow_tpu.config import load_of_method as load_jax

    jax_ope = load_jax(name)
    for key in state:
        if key not in ("spatial_mesh", "spatial_halo", "checkpoint", "fuse", "images", "dtype"):
            assert _plain(getattr(loaded, key)) == _plain(getattr(jax_ope, key)), key


@pytest.mark.parametrize("name", PORTED)
def test_level_configs_and_schedule_match_jax(name):
    from optical_flow_tpu.config import load_of_method as lj
    from optical_flow_tpu_torch.config import load_of_method as lp

    oj, op = lj(name), lp(name)
    for o in (oj, op):
        o.parse_input_parameter({"solver": "pcg", "display": False})
    for use_color in (True, False):
        cj = oj._nl_cfg(use_color, 1)
        cp = op._nl_cfg(use_color, 1)
        assert _plain(tuple(vars(cj.irls).values())) == _plain(tuple(vars(cp.irls).values()))
        assert (cj.area_hsz, cj.sigma_i, cj.full_version) == (cp.area_hsz, cp.sigma_i, cp.full_version)
    assert op._gnc_alphas() == oj._gnc_alphas()
    pj, pp = oj._make_nl_plan((388, 584), True), op._make_nl_plan((388, 584), True)
    assert (pp.levels, pp.shapes, pp.gnc_levels, pp.gnc_shapes) == (pj.levels, pj.shapes, pj.gnc_levels, pj.gnc_shapes)
    assert [a for _, a in pp.stages] == [a for _, a in pj.stages]


def test_main_path_schedule_is_21_solves():
    """classic+nl-fast at 584x388: 5 + 2 levels x 3 warp iterations = 21 solves and medians."""
    from optical_flow_tpu_torch.config import load_of_method

    plan = load_of_method("classic+nl-fast")._make_nl_plan((388, 584), True)
    (cfg0, _), (cfg1, _) = plan.stages
    assert plan.levels == 5 and plan.gnc_levels == 2
    assert cfg0.irls.max_iters == cfg1.irls.max_iters == 3
    assert cfg0.irls.max_linear == cfg1.irls.max_linear == 1
    assert plan.levels * cfg0.irls.max_iters + plan.gnc_levels * cfg1.irls.max_iters == 21


@pytest.mark.parametrize("name", NOT_PORTED)
def test_unported_presets_raise_with_roadmap_item(name):
    from optical_flow_tpu.config import available_methods
    from optical_flow_tpu_torch.config import load_of_method

    assert name in available_methods()  # a real preset of the JAX package
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1, item 10"):
        load_of_method(name)


def test_method_from_state_rejects_what_it_cannot_carry():
    from optical_flow_tpu_torch.config import method_from_state

    with pytest.raises(KeyError):
        method_from_state({"no_such_setting": 1})
    with pytest.raises(ValueError):
        method_from_state({"fuse": True})
    with pytest.raises(ValueError, match="Unknown optical flow method"):
        from optical_flow_tpu_torch.config import load_of_method

        load_of_method("classic+nl-turbo")


def test_port_never_imports_jax():
    """Importing every module of the port leaves JAX and the JAX package out of sys.modules."""
    code = (
        "import sys, pkgutil, importlib, optical_flow_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith(('jax.', 'jaxlib', 'optical_flow_tpu.')) or k == 'optical_flow_tpu')\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120, cwd=repo)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
