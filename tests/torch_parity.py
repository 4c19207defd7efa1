"""Helpers shared by the ``test_torch_*`` files (not a test module).

They move numpy inputs into the JAX package and into the PyTorch port and
compare the results as numpy arrays; ``one_cpu_thread`` is the modules'
shared fixture.
"""
import os

import numpy as np
import pytest

REPO_DATA_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")


@pytest.fixture(scope="module", autouse=True)
def one_cpu_thread():
    """Autouse in every ``test_torch_*`` module that imports it: the port's
    CPU tensors in these tests are small, so one intra-op thread runs them
    fastest, and it keeps torch's thread pool from oversubscribing the CPU
    beside the other test workers (the suite runs in parallel).  The count
    is restored after the module."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def t(x, dtype=None):
    """numpy -> CPU torch tensor (float64 unless ``dtype`` says otherwise)."""
    import torch

    return torch.as_tensor(np.asarray(x), dtype=dtype if dtype is not None else torch.float64)


def j(x, dtype=None):
    """numpy -> JAX array (float64 unless ``dtype`` says otherwise)."""
    import jax.numpy as jnp

    return jnp.asarray(np.asarray(x), dtype=dtype if dtype is not None else jnp.float64)


def n(x):
    """JAX array / torch tensor -> numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def close(a, b, rtol=1e-10, atol=1e-10):
    np.testing.assert_allclose(n(a), n(b), rtol=rtol, atol=atol)


def rubberwhale_crop(h=64, w=96, y0=100, x0=200):
    """A (h, w) crop of RubberWhale frames 10/11 (float64 RGB) + its GT flow."""
    from optical_flow_tpu_torch.io.flo import read_flow_file

    im1, im2, tu, tv = read_flow_file("RubberWhale", 10, REPO_DATA_DIR)
    sl = np.s_[y0 : y0 + h, x0 : x0 + w]
    return im1[sl], im2[sl], tu[sl], tv[sl]


# The main path's parameters, and the RubberWhale crops the slice tests run
# on.  Neither crop holds a pixel whose gray value sits on an exact .5 tie
# (see test_torch_slice.py); the float32 crop lies inside the float64 one.
MAIN_PATH_PARAMS = {"display": False, "solver": "pcg"}
SLICE_CROP = dict(h=64, w=96, y0=220, x0=200)
SLICE_CROP32 = dict(h=48, w=64, y0=220, x0=200)  # 2 + 2 levels: fewer JAX compiles
# the batched families' crop: inside SLICE_CROP32, so free of gray ties too
FAMILY_CROP = dict(h=24, w=32, y0=220, x0=200)
STATIC = 2  # the static pair's index in family_batch()


def family_batch():
    """The batched families' (3, 24, 32, 3) RGB batches (im1, im2): the frame
    10 / 11 crops (``FAMILY_CROP``) of RubberWhale and Hydrangea, and a static
    pair, RubberWhale's frame 10 crop as both frames (index ``STATIC``)."""
    from optical_flow_tpu_torch.io.flo import read_flow_file

    c = FAMILY_CROP
    sl = np.s_[c["y0"] : c["y0"] + c["h"], c["x0"] : c["x0"] + c["w"]]
    pairs = [read_flow_file(s, 10, REPO_DATA_DIR)[:2] for s in ("RubberWhale", "Hydrangea")]
    im1 = np.stack([a[sl] for a, _ in pairs] + [pairs[0][0][sl]])
    im2 = np.stack([b[sl] for _, b in pairs] + [pairs[0][0][sl]])
    return im1, im2


def jax_family_flows(cases):
    """``family_batch()``'s RGB batches, the JAX package's gray pairs of them
    and its fused batched flow (``jax.vmap`` of the whole-flow program) of
    each ``{label: (method, params)}`` case in float64, as numpy."""
    import jax.numpy as jnp

    from optical_flow_tpu.parallel import batch as bj

    im1, im2 = family_batch()
    images = np.asarray(bj.preprocess_color_batch(im1, im2, dtype=jnp.float64)[0])
    out = {"im1": im1, "im2": im2, "images": images}
    for label, (method, params) in cases.items():
        p = {"display": False, **params, "dtype": jnp.float64, "fuse": True}
        out[label] = np.asarray(bj.estimate_flow_batched(images, method, params=p))
    return out


def port_batched(images, method, params):
    """The port's batched flow of (B, H, W, 2) gray pairs on the CPU in float64, as numpy."""
    import torch

    from optical_flow_tpu_torch.parallel.batch import estimate_flow_batched

    p = {"display": False, **params, "dtype": torch.float64}
    return estimate_flow_batched(images, method, params=p, device="cpu").numpy()


def port_single(pair, method, params):
    """The port's single-pair flow of an (H, W, 2) gray pair on the CPU in float64, as numpy."""
    import torch

    from optical_flow_tpu_torch.config import load_of_method

    ope = load_of_method(method)
    ope.parse_input_parameter({"display": False, **params, "dtype": torch.float64})
    ope.images = t(pair)
    return ope.compute_flow().numpy()


def jax_flow(a, b, dtype):
    """The JAX package's classic+nl-fast flow of the pair, as numpy."""
    from optical_flow_tpu.interface import estimate_flow

    return np.asarray(estimate_flow(a, b, "classic+nl-fast", {**MAIN_PATH_PARAMS, "dtype": dtype}))


def port_flow(a, b, dtype):
    """The port's classic+nl-fast flow of the pair on the CPU, as numpy."""
    from optical_flow_tpu_torch import estimate_flow

    return estimate_flow(a, b, "classic+nl-fast", {**MAIN_PATH_PARAMS, "dtype": dtype}, device="cpu").numpy()


def jax_method_state(name):
    """The JAX preset's attributes as plain values, and its class name under
    ``"__class__"``, for ``method_from_state``."""
    from optical_flow_tpu.config import load_of_method
    from optical_flow_tpu.ops.penalties import Robust

    ope = load_of_method(name)
    state = {"__class__": type(ope).__name__}
    for key, val in vars(ope).items():
        if isinstance(val, Robust):
            val = (val.name, val.params)
        elif isinstance(val, list) and val and isinstance(val[0], Robust):
            val = [(r.name, r.params) for r in val]
        elif key == "dtype":
            val = np.dtype(val).name
        state[key] = val
    return state


def flows(a, b, method, params):
    """(JAX flow, port flow on the CPU) of the pair, as numpy; ``params`` may
    name ``"dtype"`` as a string (``"float64"``), read by each package."""
    import jax.numpy as jnp
    import torch

    from optical_flow_tpu.interface import estimate_flow as ej
    from optical_flow_tpu_torch import estimate_flow as ep

    dt = params.get("dtype", "float64")
    uv_j = np.asarray(ej(a, b, method, {**params, "dtype": getattr(jnp, dt)}))
    uv_p = ep(a, b, method, {**params, "dtype": getattr(torch, dt)}, device="cpu").numpy()
    return uv_j, uv_p
