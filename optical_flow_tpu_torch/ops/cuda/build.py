"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source to an object, all at once in parallel, and
links them into one shared library with a plain C interface, loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The library lives in ``optical_flow_tpu_torch/_build/<key>/``,
where ``<key>`` hashes the sources and the flags, so an edited source
rebuilds and an unchanged one is reused.  Nothing here runs at import time.

Flags: ``sm_90a`` (Hopper), ``-O3``, no ``--use_fast_math``, and
``--fmad=false``: without it nvcc contracts ``a * b + c`` into FMAs and the
weighted median's colour distances and weights stop being bit-identical to
the plain PyTorch version, which rounds every operation.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_ROOT = PKG_DIR / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points: name -> argtypes (every entry returns a cudaError_t as int)
SIGNATURES = {
    # u, v, occ, guide, out, B, C, H, W, hsz, inv_2sigma2, stream
    "wmedian_f32": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # out: [SM count, shared memory a block may opt in to]
    "device_limits": [_P],
    # a11, a12, a22, wu_h, wu_v, wv_h, wv_v, b_u, b_v, x, work, partials,
    # iters, B, H, W, rtol2, maxiter, blocks, tile rows, stream
    "cg_stream_f32": [_P] * 13 + [_I, _I, _I, _F, _I, _I, _I, _P],
    # a11, a12, a22, wu_h, wu_v, wv_h, wv_v, b_u, b_v, x, zhalo, partials,
    # iters, B, H, W, rtol2, maxiter, bands an item, items a launch, ppt, smem, stream
    "cg_resident_f32": [_P] * 13 + [_I, _I, _I, _F, _I, _I, _I, _I, _I, _P],
    # im, p, out, B, H, W, theta, n_iters, halo, passes, smem, stream
    "rof_tiled_f32": [_P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _I, _P],
    # im, halo, out, B, H, W, theta, n_iters, per_image, smem, stream
    "rof_resident_f32": [_P] * 3 + [_I, _I, _I, _F, _I, _I, _I, _P],
}

_lock = threading.Lock()
_lib = None
build_log = ""


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [os.path.join(CUDA_HOME, "bin", "nvcc")] if CUDA_HOME else []
    candidates.append(shutil.which("nvcc") or "")
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the CUDA toolkit is installed")


def _sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def build_key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def load_library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call.  Raises on failure."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        out_dir = BUILD_ROOT / build_key()
        so = out_dir / "libofkernels.so"
        if not so.exists():
            out_dir.mkdir(parents=True, exist_ok=True)
            tmp = out_dir / f"libofkernels.{os.getpid()}.so"
            nvcc = _nvcc()
            objs, procs = [], []
            for src in (s for s in _sources() if s.suffix == ".cu"):
                obj = out_dir / f"{src.stem}.{os.getpid()}.o"
                cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                objs.append(obj)
                procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
            logs = [p.communicate()[0] for p in procs]
            link = None
            if all(p.returncode == 0 for p in procs):
                link = subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared", "-o", str(tmp),
                                       *map(str, objs)], capture_output=True, text=True)
                logs.append(link.stdout + link.stderr)
            build_log = "".join(logs)
            for obj in objs:
                obj.unlink(missing_ok=True)
            if link is None or link.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{build_log}")
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a C entry returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {err}")


_limits = {}


def device_limits(device) -> tuple:
    """(SM count, shared memory a block may opt in to, in bytes) of a CUDA device."""
    import torch

    device = torch.device(device)
    if device not in _limits:
        out = (ctypes.c_int * 2)()
        with torch.cuda.device(device):
            check(load_library().device_limits(out), "device_limits")
        _limits[device] = (out[0], out[1])
    return _limits[device]


def current_stream(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda_f32(name: str, *tensors) -> None:
    """Raise unless every tensor is a contiguous float32 tensor on one CUDA device."""
    import torch

    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected tensors on one CUDA device, got {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: the kernel takes float32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel takes contiguous tensors")
