"""The reference flow of one frame pair: Classic+NL and Classic++ in plain PyTorch.

:func:`reference_flow` takes the two uint8 RGB frames as the user hands
them and a configuration's ``settings`` (``flowbench/configs/<name>.json``)
and runs the whole pipeline of Sun, Roth & Black (CVPR 2010) as the
configuration states it: the MATLAB gray pair and Lab guide, the ROF
texture, the GNC stages over their pyramids, coarse to fine, and in each
warp iteration the alpha-blended quadratic / robust IRLS systems, PCG, the
update clipped to +-1 and the non-local weighted median (Classic+NL) or the
plain median (Classic++).  It shares no code and no state with the port.
"""
from __future__ import annotations

import numpy as np
import torch

from flowbench.reference import ops


def gnc_alphas(gnc_iters: int, alpha: float = 1.0):
    """The GNC blend weight of each stage: 1 for the quadratic first stage, falling to 0."""
    out = []
    for i in range(gnc_iters):
        out.append(alpha)
        if gnc_iters > 1:
            alpha = max(0.0, min(alpha, 1.0 - (i + 1) / (gnc_iters - 1)))
    return out


def _penalty(p):
    return p[0], tuple(float(v) for v in p[1])


def _relaxed(settings):
    """The quadratic penalties of the first GNC stage, (spatial, data)."""
    spatial, data = _penalty(settings["rho_spatial"]), _penalty(settings["rho_data"])
    if settings["relaxation"] == "own_sigma":  # Classic+NL: each penalty's own sigma
        return ("quadratic", (spatial[1][0],)), ("quadratic", (data[1][0],))
    # Black & Anandan: unit spatial sigma, data sigma sigma_data / sigma_spatial
    return ("quadratic", (1.0,)), ("quadratic", (data[1][0] / spatial[1][0],))


def _level(settings, images, guide, uv, alpha, max_linear, solves):
    """One pyramid level: ``max_iters`` warp iterations."""
    qs, qd = _relaxed(settings)
    rs, rd = _penalty(settings["rho_spatial"]), _penalty(settings["rho_data"])
    lam, lam_q = float(settings["lambda"]), float(settings["lambda_q"])
    rtol, maxiter = float(settings["pcg_rtol"]), int(settings["pcg_maxiter"])
    blend = float(settings["blend"])
    f = ops.DERIV_FILTER
    im1, im2 = images[..., 0], images[..., 1]
    I1x, I1y = ops.correlate2d(im1, f.reshape(1, -1)), ops.correlate2d(im1, f.reshape(-1, 1))
    tables = ops.hermite_tables(im2)
    for _ in range(int(settings["max_iters"])):
        It, Ix, Iy = ops.warp_derivatives(im1, I1x, I1y, tables, uv, blend)
        duv = torch.zeros_like(uv)
        for _j in range(max_linear):
            sys_q = ops.irls_system(uv, duv, It, Ix, Iy, qs, qd, lam_q)
            sys_r = ops.irls_system(uv, duv, It, Ix, Iy, rs, rd, lam)
            system = [alpha * q + (1.0 - alpha) * r for q, r in zip(sys_q, sys_r)]
            duv, iters = ops.pcg(system, rtol, maxiter)
            solves.append(iters)
            lim = float(settings["limit_update"])
            duv = torch.clamp(duv, -lim, lim)
            new_uv = uv + duv
            if settings["nonlocal"]:
                occ = ops.occlusion(new_uv, images, float(settings["occlusion_sigma_d"]),
                                    float(settings["occlusion_sigma_i"]))
                duv = ops.weighted_median(new_uv, guide, occ, int(settings["area_hsz"]),
                                          float(settings["sigma_i"])) - uv
            else:
                size = int(settings["median_filter_size"])
                duv = ops.median_filter2d(new_uv.movedim(-1, 0), size).movedim(0, -1) - uv
        uv = uv + duv
    return uv


def reference_flow(rgb1: np.ndarray, rgb2: np.ndarray, settings: dict, device="cpu", dtype=torch.float32,
                   solves=None):
    """(H, W, 2) flow of the uint8 RGB pair under ``settings``; ``solves``, if a list, gets each
    PCG solve's iteration count."""
    solves = [] if solves is None else solves
    with torch.no_grad():
        a1 = torch.as_tensor(np.ascontiguousarray(rgb1)).to(device=device, dtype=dtype)
        a2 = torch.as_tensor(np.ascontiguousarray(rgb2)).to(device=device, dtype=dtype)
        gray, lab = ops.gray_pair_and_guide(a1, a2)
        H, W = gray.shape[:2]
        images = ops.texture(gray, float(settings["rof_theta"]), int(settings["rof_iters"]), float(settings["alp"]))
        spacing, gnc_spacing = float(settings["pyramid_spacing"]), float(settings["gnc_pyramid_spacing"])
        levels = ops.auto_pyramid_levels((H, W), spacing)
        gnc_levels = int(settings["gnc_pyramid_levels"])
        shapes = ops.pyramid_shapes((H, W), levels, 1.0 / spacing)
        gnc_shapes = ops.pyramid_shapes((H, W), gnc_levels, 1.0 / gnc_spacing)
        pyr, gnc_pyr = ops.build_pyramid(images, levels, spacing), ops.build_pyramid(images, gnc_levels, gnc_spacing)
        if settings["nonlocal"]:
            guide_pyr, guide_gnc_pyr = ops.build_pyramid(lab, levels, spacing), ops.build_pyramid(lab, gnc_levels,
                                                                                                   gnc_spacing)
        else:
            guide_pyr, guide_gnc_pyr = [None] * levels, [None] * gnc_levels
        uv = torch.zeros((H, W, 2), dtype=dtype, device=device)
        for stage, alpha in enumerate(gnc_alphas(int(settings["gnc_iters"]))):
            if stage == 0:
                n, cur, guides, sh = levels, pyr, guide_pyr, shapes
            else:
                n, cur, guides, sh = gnc_levels, gnc_pyr, guide_gnc_pyr, gnc_shapes
            max_linear = 1 if stage == 0 else int(settings["max_linear"])
            for level in range(n - 1, -1, -1):
                uv = ops.resample_flow(uv, sh[level])
                uv = _level(settings, cur[level], guides[level], uv, alpha, max_linear, solves)
    return uv
