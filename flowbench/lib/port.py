"""The system under test, ``optical_flow_tpu_torch``, as the benchmark drives and observes it.

:func:`make_entry` returns the call a user makes for one prepared call of
a mix: the frames in host memory in, the flows synchronised on the host
out.  :class:`OpRanges` puts the benchmark's own ``record_function``
ranges around the port's calls into the four operations the rooflines
read (the PCG solve, the weighted median, ROF and the plain median) and
records each call's shapes; it is installed only in traced runs.  The
ranges wrap module attributes of the port, by name: where a later change
renames one, its range and its roofline fall silent.
"""
from __future__ import annotations

import importlib
import math

PORT = "optical_flow_tpu_torch"

# op -> (module of the port, attribute that the pipeline calls)
TARGETS = {
    "cg": (f"{PORT}.methods.ba", "solve_flow_system"),
    "wmedian": (f"{PORT}.methods.classic_nl", "denoise_color_weighted_medfilt2"),
    "rof": (f"{PORT}.methods.ba", "structure_texture_decomposition_rof"),
    "median": (f"{PORT}.methods.base", "median_filter2d"),
}
RANGE_PREFIX = "flowbench."


def load_port():
    """Import the port and load its kernel library (built at first use into the checkout)."""
    importlib.import_module(PORT)
    build = importlib.import_module(f"{PORT}.ops.cuda.build")
    build.load_library()


def make_entry(config: dict, traffic: dict, device: str = "cuda"):
    """``call(prepared call) -> flows on the host`` for the mix's entry point."""
    import torch

    port = importlib.import_module(PORT)
    method, params = config["method"], dict(config["params"])
    if traffic["entry"] == "batched_rgb":
        batched = importlib.import_module(f"{PORT}.parallel.batch").estimate_flow_batched_rgb

        def call(c):
            return batched(c.im1, c.im2, method, params=params, device=device).cpu()
    else:
        def call(c):
            return port.estimate_flow(c.im1, c.im2, method, params, device=device).cpu()
    torch.backends.cuda.matmul.allow_tf32 = False  # the configurations state float32 on every plane
    torch.backends.cudnn.allow_tf32 = False
    return call


def reset_counters():
    importlib.import_module(f"{PORT}.ops.cuda.cg_kernel").reset_stats()


def cg_iterations_total(device) -> int:
    """PCG iterations summed over every solve since :func:`reset_counters` (the port's counter)."""
    return importlib.import_module(f"{PORT}.ops.cuda.cg_kernel").iteration_counts(device)[1]


class OpRanges:
    """Ranges ``flowbench.<op>`` around the port's operation calls, and each call's shapes in ``calls[op]``."""

    def __init__(self):
        self.calls = {op: [] for op in TARGETS}
        self._saved = []

    def __enter__(self):
        for op, (mod_name, attr) in TARGETS.items():
            mod = importlib.import_module(mod_name)
            if hasattr(mod, attr):
                orig = getattr(mod, attr)
                self._saved.append((mod, attr, orig))
                setattr(mod, attr, getattr(self, f"_wrap_{op}")(orig))
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()

    def _wrap_cg(self, orig):
        import torch

        kernel = importlib.import_module(f"{PORT}.ops.cuda.cg_kernel")

        def solve(sys, solver="pcg", *args, **kwargs):
            with torch.profiler.record_function(RANGE_PREFIX + "cg"):
                x = orig(sys, solver, *args, **kwargs)
            H, W = sys.a11.shape[-2:]
            B = sys.a11.numel() // (H * W)
            iters = None
            buf = getattr(kernel, "_iters", {}).get(x.device) if solver in ("pcg", "backslash") else None
            if buf is not None:
                with torch.profiler.record_function(RANGE_PREFIX + "probe"):
                    iters = buf[1 : 1 + B].clone()  # this call's per-item iterations, read after the trace
            self.calls["cg"].append({"B": B, "H": H, "W": W, "iters": iters})
            return x

        return solve

    def _wrap_wmedian(self, orig):
        import torch

        def wmedian(uv, color_images, occ, area_hsz, *args, **kwargs):
            nb = uv.ndim - 3
            H, W = uv.shape[-3:-1]
            C = 0 if color_images is None else (color_images.shape[-1] if color_images.ndim - nb == 3 else 1)
            self.calls["wmedian"].append({"B": math.prod(uv.shape[:nb]), "H": H, "W": W, "C": C,
                                          "hsz": int(area_hsz)})
            with torch.profiler.record_function(RANGE_PREFIX + "wmedian"):
                return orig(uv, color_images, occ, area_hsz, *args, **kwargs)

        return wmedian

    def _wrap_rof(self, orig):
        import torch

        def rof(im, theta=1.0 / 8, n_iters=100, alp=0.95, batch_dims=0):
            H, W = im.shape[batch_dims : batch_dims + 2]
            self.calls["rof"].append({"planes": im.numel() // (H * W), "H": H, "W": W, "iters": int(n_iters)})
            with torch.profiler.record_function(RANGE_PREFIX + "rof"):
                return orig(im, theta, n_iters, alp, batch_dims)

        return rof

    def _wrap_median(self, orig):
        import torch

        def median(im, size, boundary="reflect"):
            H, W = im.shape[-2:]
            self.calls["median"].append({"planes": im.numel() // (H * W), "H": H, "W": W})
            with torch.profiler.record_function(RANGE_PREFIX + "median"):
                return orig(im, size, boundary)

        return median

    def cg_iterations(self):
        """Each recorded solve's per-item iteration counts, read once the device is done."""
        return [None if c["iters"] is None else c["iters"].tolist() for c in self.calls["cg"]]
