"""Row-sharded pyramid levels of every method family (port of ``optical_flow_tpu/parallel/spatial.py``).

Image rows are tiled over the mesh's ``space`` axis and a whole level —
warp and derivatives, the linear systems, the distributed PCG, occlusion
and the (weighted) median — runs on the row blocks, exchanging only halo
strips and PCG inner products (``parallel/halo.py``, ``parallel/dist.py``).
A sharded field is a list of (Hs, ...) row blocks, one a shard, in shard
order, each on its shard's device: every shard in one process, or this
process's shards when the mesh spans processes (``parallel/mesh.py``).  One
level code serves both: the host-callable steps run it under
``sharded_over(mesh)``, and the loops over shards, the weighted median's
launches by device (:func:`_device_groups`) among them, run over this
process's shards.  Whole-image work (preprocessing, ROF, pyramids, the
levels too short to shard, the guard) runs replicated in every process on
the gathered level, as the JAX package runs it outside ``shard_map``, and
every host decision (the PCG's stop, HS's early stop) is read from sums
gathered in shard order, the same bits in every process.

* :func:`classic_nl_level_local` — the Classic+NL level; with
  ``use_color=False`` it is also the BA level (the same α-blended solve and
  duv-trick median, no occlusion term).
* :func:`alt_ba_level_local` — the alt-BA level: the BA system plus the
  coupling to the auxiliary field (masked to the true rows) and the
  Li–Osher update through the sharded median.
* :func:`hs_level_local` — the Horn–Schunck level, whose early stop tests
  the update's norm over all the shards, read on the host once a warp
  iteration, so that every shard (in every process) stops at the same
  iteration.
* The weighted median runs on each shard's halo-padded planes through the
  kernel's wrapper (``ops/cuda/wmedian_kernel.py::wmedian``): one launch
  for all the shards of a device, the shards as its batch axis.

Interpolations: ``'bi-cubic'`` (Hermite), ``'bi-linear'`` and ``'cubic'``
(B-spline).  The B-spline prefilter is a global operator but flow
independent: the host wrapper computes its tables on the whole level
(:func:`_global_spline_tables`) and shards them; only the 4x4 evaluation
runs on the shards, with halo reads.

Exactness: each sharded level computes the function of its single-device
counterpart up to the order of the PCG's sums.  The true image edges are
reproduced by the halo fill modes; when H does not divide over the shards,
rows are padded at the bottom, masked out of the system (coefficients,
right-hand side and the H-1 coupling edge are zero), and every
boundary-dependent read re-synthesises the pad from the true rows
(:func:`_fixup_bottom`).  The warp's gather is exact for displacements up
to the ``halo`` rows; the methods size the halo a level from the incoming
flow (``methods/base.py::_resolve_spatial_halo``).  Levels too short for
their halo (:func:`spatial_plan` returns None) run the single-device step:
coarse levels unsharded, fine levels sharded, as in the JAX package.
"""
from __future__ import annotations

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from optical_flow_tpu_torch.ops.cuda import wmedian_kernel
from optical_flow_tpu_torch.ops.derivatives import HERMITE_CORNER_SHIFTS, hermite_eval
from optical_flow_tpu_torch.ops.filters import correlate2d, correlate_padded, median_of_windows, pad_axis
from optical_flow_tpu_torch.ops.interp import _bspline3, gather_points, spline_coeffs_2d, tap_index
from optical_flow_tpu_torch.ops.stencil import FlowSystem, add_coupling, blend_systems
from optical_flow_tpu_torch.parallel.dist import sharded_laplacian_apply_local, solve_flow_system_local
from optical_flow_tpu_torch.parallel.halo import halo_exchange_rows
from optical_flow_tpu_torch.parallel.mesh import SPACE_AXIS, gather_rows, psum, shard_layout, shard_rows, sharded_over
from optical_flow_tpu_torch.utils.guard import guard_level, guard_level_pair

SUPPORTED_INTERP = ("bi-cubic", "bi-linear", "cubic")
SUPPORTED_SOLVERS = ("pcg", "backslash")

CUBIC_OFFSETS = (-1, 0, 1, 2)


def check_spatial_config(interp: str, solver: str):
    """Reject configurations the sharded levels cannot run: ``mesh=`` shards or raises."""
    if interp not in SUPPORTED_INTERP:
        raise ValueError(
            f"spatial sharding (mesh=) does not support interpolation_method={interp!r}; "
            f"supported: {SUPPORTED_INTERP}"
        )
    if solver not in SUPPORTED_SOLVERS:
        raise ValueError(
            f"spatial sharding (mesh=) does not support solver={solver!r} (SOR's sequential row sweep "
            f"is inherently global); supported: {SUPPORTED_SOLVERS}"
        )


@dataclasses.dataclass(frozen=True)
class SpatialConfig:
    """Static row-sharding geometry of one pyramid level."""

    axis_name: str
    n: int  # shards along the space axis
    Hs: int  # rows a shard (the pad included)
    pad: int  # bottom pad rows (0 when H divides over n)
    halo: int  # warp-gather halo radius (largest exact displacement)
    H_true: int  # true row count
    W: int


def spatial_plan(H, W, n, boundary_radius, halo, axis_name=SPACE_AXIS, warp_margin: int = 0):
    """Geometry for sharding H rows over n shards, or None if infeasible.

    ``boundary_radius`` is the largest filter radius whose mirror fill must
    be synthesised inside the pad region (the weighted median's
    ``area_hsz`` on the colour path, the plain median's radius otherwise).
    ``warp_margin`` is the rows the warp reads past the halo (2 for the
    cubic B-spline's 4x4 support, 0 otherwise).
    """
    if n <= 1:
        return None
    if H % n == 0:
        pad = 0
    else:
        # pad >= boundary_radius, so every mirror read of a true row lands in the pad
        req = max(int(boundary_radius), 2)
        pad = req + (-(H + req)) % n
    Hs = (H + pad) // n
    # one-neighbour halo exchange and in-shard fix-up
    if Hs < max(2 * pad + 1, boundary_radius + 1, halo + 1 + warp_margin, 8):
        return None
    if pad > max(H - 1, 0):
        return None  # the mirror pads need enough true rows
    return SpatialConfig(axis_name=axis_name, n=int(n), Hs=int(Hs), pad=int(pad), halo=int(halo),
                         H_true=int(H), W=int(W))


def _fixup_bottom(xs, scfg: SpatialConfig, mode: str) -> list:
    """The sharded field with the last shard's pad rows overwritten by mirrored true rows.

    ``mode``: 'reflect' (numpy reflect: the weighted median, the spline
    tables), 'symmetric' (scipy reflect: the plain filters) or 'edge'
    (clamped warp reads).  The field itself when there is no pad.
    """
    pad = scfg.pad
    if pad == 0 or shard_layout(len(xs)).index[-1] != scfg.n - 1:
        return xs  # no pad, or the last shard is another process's
    x = xs[-1]
    off = scfg.Hs - pad  # the last shard's first pad row: global row H_true
    if mode == "reflect":
        fill = x[off - 1 - pad : off - 1].flip(0)
    elif mode == "symmetric":
        fill = x[off - pad : off].flip(0)
    else:  # edge
        fill = x[off - 1 : off].expand((pad,) + tuple(x.shape[1:]))
    return [*xs[:-1], torch.cat([x[:off], fill], dim=0)]


def _median_filter_local(scfg: SpatialConfig, uv, kh: int, kw: int) -> list:
    """scipy-'reflect' median of both fields of the sharded (Hs, W, 2) flow,
    exact at the true edges; the selection of ``ops/filters.py::median_filter2d``."""
    cy, cx = kh // 2, kw // 2
    x_ext = halo_exchange_rows(_fixup_bottom(uv, scfg, "symmetric"), cy, mode="symmetric")
    out = []
    for x in x_ext:
        padded = pad_axis(x.movedim(-1, 0), -1, cx, kw - 1 - cx, "reflect")
        out.append(median_of_windows(padded, scfg.Hs, scfg.W, kh, kw).movedim(0, -1))
    return out


# ---------------------------------------------------------------------------
# the warp and its derivatives on the shards
# ---------------------------------------------------------------------------


def _taps(planes, iy, ix, shifts):
    """(K, S, h, w): the (K, HH, WW) ``planes`` read at rows ``iy + a`` and
    columns ``ix + b`` for each shift (a, b) of ``shifts``."""
    K, HH, WW = planes.shape
    idx = torch.stack([(iy + a) * WW + (ix + b) for a, b in shifts])
    return gather_points(planes.reshape(K, HH * WW), idx, 0)


def _warp_setup(scfg: SpatialConfig, images, interp, deriv_filter, blend, spline_tables, dtype):
    """Flow-independent warp tables and samplers of a level on the shards.

    Mirrors :func:`~optical_flow_tpu_torch.ops.derivatives.precompute_warp`
    and :func:`warp_deriv` for the three interpolations.  ``spline_tables``
    (the 'cubic' path only) are, per channel, the row shards of the whole
    level's coefficient tables of (frame 2, its d/dx, its d/dy), the pad
    rows already mirror-filled by the host wrapper.
    """
    R, Hs, W, H_true = scfg.halo, scfg.Hs, scfg.W, scfg.H_true

    f = np.asarray(deriv_filter, dtype=np.float64)
    fx_k, fy_k, fxy_k = f.reshape(1, -1), f.reshape(-1, 1), np.outer(f, f)
    rv = fy_k.shape[0] // 2  # the derivative filter's vertical radius

    index = shard_layout(len(images)).index  # the global shard index of each of this process's shards
    g_col = [g * Hs + torch.arange(Hs, device=x.device)[:, None] for g, x in zip(index, images)]  # global rows
    nc = images[0].shape[2] // 2

    # one symmetric exchange of the pair serves every derivative filter; with a
    # pad the images' pad rows already hold the symmetric mirror (the host
    # wrapper's), so plain interior arithmetic is exact at the true bottom
    im_ext = [x.movedim(-1, 0) for x in halo_exchange_rows(images, rv, mode="symmetric")]  # (2C, Hs+2rv, W)

    def corr(x_ext, kernel):
        """Correlation of a block pre-extended by rv rows (scipy-'reflect' columns)."""
        kh, kw = kernel.shape
        cx = kw // 2
        padded = pad_axis(x_ext, -1, cx, kw - 1 - cx, "reflect")
        return correlate_padded(padded, kernel, Hs, W, row0=rv - kh // 2)

    im1s = [[x[:, :, c] for x in images] for c in range(nc)]
    I1x = [[corr(x[c], fx_k) for x in im_ext] for c in range(nc)]
    I1y = [[corr(x[c], fy_k) for x in im_ext] for c in range(nc)]

    def table_ext(A):
        """Pad rows as edge copies of the true last row, the warp halo, and
        one edge row and column more for the ceil-corner reads."""
        A = halo_exchange_rows(_fixup_bottom(A, scfg, "edge"), R, mode="edge")
        return [pad_axis(pad_axis(a, 0, 0, 1, "nearest"), 1, 0, 1, "nearest") for a in A]

    def local_rows(iy_global, g0):
        return torch.clamp(iy_global - g0 + R, 0, Hs + 2 * R - 1)

    def hermite_local(tabs, yq, xq, g0):
        fy = torch.floor(yq)
        fxq = torch.floor(xq)
        oob = (fxq < 0) | (fxq + 1 > W - 1) | (fy < 0) | (fy + 1 > H_true - 1)
        iy0 = local_rows(tap_index(fy, H_true), g0)
        ix0 = tap_index(fxq, W)
        # (4 tables, 4 corners, Hs, W) -> (16, Hs, W): table-major, then corner
        taps = _taps(tabs, iy0, ix0, HERMITE_CORNER_SHIFTS).flatten(0, 1)
        val, vx, vy = hermite_eval(taps, xq - fxq, yq - fy)
        return val, vx, vy, oob

    def bilinear_local(tabs, yq, xq, g0):
        """(K, Hs, W) clamped bilinear reads of the (K, Hs+2R+1, W+1) tables."""
        ysc = torch.clamp(yq, 0.0, H_true - 1.0)
        xsc = torch.clamp(xq, 0.0, W - 1.0)
        y0f = torch.floor(ysc)
        x0f = torch.floor(xsc)
        ay, axx = ysc - y0f, xsc - x0f
        taps = _taps(tabs, local_rows(tap_index(y0f, H_true), g0), tap_index(x0f, W),
                     ((0, 0), (0, 1), (1, 0), (1, 1)))
        v00, v01, v10, v11 = taps.unbind(1)
        top = v00 * (1.0 - axx) + v01 * axx
        bot = v10 * (1.0 - axx) + v11 * axx
        return top * (1.0 - ay) + bot * ay

    frame2 = [[x[:, :, nc + c] for x in images] for c in range(nc)]
    # per channel, per shard: the stacked tables of the channel's warp
    if interp == "bi-cubic":
        warp_tables = [[torch.stack(t) for t in zip(*(table_ext(T) for T in (
            frame2[c], [corr(x[nc + c], fx_k) for x in im_ext], [corr(x[nc + c], fy_k) for x in im_ext],
            [corr(x[nc + c], fxy_k) for x in im_ext])))] for c in range(nc)]
        occ_tabs = [[t[:1] for t in tabs] for tabs in warp_tables]
    elif interp == "bi-linear":
        warp_tables = [[torch.stack(t) for t in zip(*(table_ext(T) for T in (
            frame2[c], [corr(x[nc + c], fx_k) for x in im_ext], [corr(x[nc + c], fy_k) for x in im_ext])))]
            for c in range(nc)]
        occ_tabs = [[t[:1] for t in tabs] for tabs in warp_tables]
    else:  # 'cubic': the coefficients arrive computed on the whole level, sharded
        def cubic_ext(C):
            # numpy-reflect fills match pad(coeffs, 2, 'mirror'): the clamped
            # reads touch at most 2 rows and columns past the true edges
            return [pad_axis(c, -1, 2, 2, "mirror") for c in halo_exchange_rows(C, R + 2, mode="reflect")]

        warp_tables = [[torch.stack(t) for t in zip(*(cubic_ext(C) for C in tabs))] for tabs in spline_tables]
        occ_tabs = [[t[None] for t in table_ext(frame2[c])] for c in range(nc)]

    HH = Hs + 2 * R + 1
    cub_shifts = tuple((dy + 1, dx + 1) for dy in CUBIC_OFFSETS for dx in CUBIC_OFFSETS)

    def cubic_local(tabs, yq, xq, g0):
        """B-spline values of the (K, Hs+2R+4, W+4) tables at (yq, xq).

        Tap (dy, dx) of base (iy, ix) reads global coefficient row iy + dy:
        local row (iy - g0 + R + 1) + (dy + 1) of the (R+2)-halo'd table.
        The weights use the unclamped offsets, as ``sample_cubic_spline``.
        """
        fy = torch.floor(yq)
        fxq = torch.floor(xq)
        liy = torch.clamp(tap_index(fy, H_true) - g0 + R + 1, 0, HH - 1)
        lix = tap_index(fxq, W) + 1
        taps = _taps(tabs, liy, lix, cub_shifts)  # (K, 16, Hs, W)
        wy = [_bspline3(yq - (fy + dy)) for dy in CUBIC_OFFSETS]
        wx = [_bspline3(xq - (fxq + dx)) for dx in CUBIC_OFFSETS]
        out = torch.zeros_like(taps[:, 0])
        for a in range(4):
            for b in range(4):
                out = out + wy[a] * wx[b] * taps[:, a * 4 + b]
        return out

    ygrid = [g.to(dtype).expand(Hs, W) for g in g_col]
    xgrid = [torch.arange(W, dtype=dtype, device=g.device).expand(Hs, W) for g in g_col]
    g0s = [g * Hs for g in index]

    def warp_deriv_local(uv):
        """Per shard, (It, Ix, Iy): (Hs, W) for one channel, else (Hs, W, C)."""
        out = []
        for i, u in enumerate(uv):
            xq = xgrid[i] + u[:, :, 0]
            yq = ygrid[i] + u[:, :, 1]
            B = (xq > W - 1) | (xq < 0) | (yq > H_true - 1) | (yq < 0)
            zero = torch.zeros((), dtype=dtype, device=u.device)
            Its, Ixs, Iys = [], [], []
            for c in range(nc):
                if interp == "bi-cubic":
                    warp, wx, wy, mask = hermite_local(warp_tables[c][i], yq, xq, g0s[i])
                elif interp == "bi-linear":
                    warp, wx, wy = bilinear_local(warp_tables[c][i], yq, xq, g0s[i])
                    mask = B
                else:
                    warp, wx, wy = cubic_local(warp_tables[c][i], yq, xq, g0s[i])
                    mask = B
                Its.append(torch.where(mask, zero, warp - im1s[c][i]))
                Ixs.append(torch.where(mask, zero, blend * wx + (1 - blend) * I1x[c][i]))
                Iys.append(torch.where(mask, zero, blend * wy + (1 - blend) * I1y[c][i]))
            if nc == 1:
                out.append((Its[0], Ixs[0], Iys[0]))
            else:
                out.append(tuple(torch.stack(t, dim=-1) for t in (Its, Ixs, Iys)))
        return out

    def occ_sample(c, i, yq, xq):
        """Clamped bilinear read of raw frame 2 (occlusion detection)."""
        return bilinear_local(occ_tabs[c][i], yq, xq, g0s[i])[0]

    return SimpleNamespace(nc=nc, im1s=im1s, ygrid=ygrid, xgrid=xgrid, g_col=g_col,
                           warp_deriv=warp_deriv_local, occ_sample=occ_sample)


def _global_spline_tables(images, deriv_filter, scfg: SpatialConfig):
    """The whole level's B-spline coefficient tables of the 'cubic' warp.

    Per channel, the tables of (frame 2, its d/dx, its d/dy) from one
    prefilter call on their stack, as ``precompute_warp`` makes them, on the
    true rows; the pad rows are mirror-filled, so the clamped reads up to 2
    rows past H_true match ``pad(coeffs, 2, 'mirror')``.
    """
    f = np.asarray(deriv_filter, np.float64)
    fx, fy = f.reshape(1, -1), f.reshape(-1, 1)
    nc = images.shape[2] // 2
    out = []
    for c in range(nc):
        im2 = images[:, :, nc + c]
        tabs = spline_coeffs_2d(torch.stack([im2, correlate2d(im2, fx, "reflect"), correlate2d(im2, fy, "reflect")]))
        if scfg.pad:
            tabs = pad_axis(tabs, -2, 0, scfg.pad, "mirror")
        out.append(tuple(tabs.unbind(0)))
    return tuple(out)


# ---------------------------------------------------------------------------
# the level programs on the shards
# ---------------------------------------------------------------------------


def _solver_params(solver):
    """(rtol, maxiter) of a level's solver tuple ('pcg' or 'backslash')."""
    if solver[0] == "pcg":
        return solver[1], solver[2]
    return solver[3], solver[4]


def _make_sys_builder(scfg: SpatialConfig, valid, vmask, dtype):
    """Per-shard IRLS system assembly (mirrors ``ops/stencil.py::build_irls_system``).

    Returns ``build_sys_local(uv, duv, derivs, rsu, rsv, rd, lam)``, the
    sharded FlowSystems (one a shard) whose pad-row coefficients and
    right-hand side are zero, so the PCG iterates are the unpadded
    problem's.
    """
    W = scfg.W

    def cmean(x):
        return torch.mean(x, dim=2) if x.ndim == 3 else x

    def fdh(x):  # horizontal forward difference, 0 in the last column
        return F.pad(x[:, 1:] - x[:, :-1], (0, 1))

    # 0 in the last column: the dangling horizontal edges
    col_mask = [F.pad(torch.ones((1, W - 1), dtype=dtype, device=v.device), (0, 1)) for v in valid]

    def build_sys_local(uv, duv, derivs, rsu, rsv, rd, lam):
        new = [u + d for u, d in zip(uv, duv)]
        new_e = halo_exchange_rows(new, 1, mode="edge")
        parts = []
        for k, (u2, duvk, (It, Ix, Iy)) in enumerate(zip(uv, duv, derivs)):
            zero = torch.zeros((), dtype=dtype, device=u2.device)
            up, vp = new[k][:, :, 0], new[k][:, :, 1]
            ne = new_e[k]
            wu_h = rsu[0].deriv_over_x(fdh(up))
            wu_v = rsu[1].deriv_over_x(ne[2:, :, 0] - ne[1:-1, :, 0])
            wv_h = rsv[0].deriv_over_x(fdh(vp))
            wv_v = rsv[1].deriv_over_x(ne[2:, :, 1] - ne[1:-1, :, 1])
            wu_h = torch.where(valid[k], lam * wu_h * col_mask[k], zero)
            wv_h = torch.where(valid[k], lam * wv_h * col_mask[k], zero)
            wu_v = torch.where(vmask[k], lam * wu_v, zero)
            wv_v = torch.where(vmask[k], lam * wv_v, zero)
            if It.ndim == 3:
                It_lin = It + Ix * duvk[:, :, 0:1] + Iy * duvk[:, :, 1:2]
            else:
                It_lin = It + Ix * duvk[:, :, 0] + Iy * duvk[:, :, 1]
            pp_d = cmean(rd.deriv_over_x(It_lin))
            parts.append((wu_h, wu_v, wv_h, wv_v, pp_d, It_lin, Ix, Iy))
        lap_u = sharded_laplacian_apply_local([p[0] for p in parts], [p[1] for p in parts], [u[:, :, 0] for u in uv])
        lap_v = sharded_laplacian_apply_local([p[2] for p in parts], [p[3] for p in parts], [u[:, :, 1] for u in uv])
        systems = []
        for k, (wu_h, wu_v, wv_h, wv_v, pp_d, It_lin, Ix, Iy) in enumerate(parts):
            zero = torch.zeros((), dtype=dtype, device=pp_d.device)
            a11 = torch.where(valid[k], pp_d * cmean(Ix**2), zero)
            a12 = torch.where(valid[k], pp_d * cmean(Ix * Iy), zero)
            a22 = torch.where(valid[k], pp_d * cmean(Iy**2), zero)
            b_u = torch.where(valid[k], -lap_u[k] - pp_d * cmean(It_lin * Ix), zero)
            b_v = torch.where(valid[k], -lap_v[k] - pp_d * cmean(It_lin * Iy), zero)
            systems.append(FlowSystem(a11, a12, a22, wu_h, wu_v, wv_h, wv_v, b_u, b_v))
        return systems

    return build_sys_local


def _device_groups(shards):
    """[(device, [shard indices])] of the shards, in order of first appearance."""
    groups = {}
    for i, x in enumerate(shards):
        groups.setdefault(x.device, []).append(i)
    return list(groups.items())


def classic_nl_level_local(cfg, scfg: SpatialConfig, images, color, uv, alpha, spline_tables=()) -> list:
    """One Classic+NL pyramid level on the shards.

    ``images`` (Hs, W, 2C), ``color`` (Hs, W, C) (unused when
    ``cfg.use_color`` is False) and ``uv`` (Hs, W, 2) are sharded fields.
    Mirrors ``classic_nl_level_step`` (see the module docstring).  With
    ``use_color=False`` it is also the BA level body: the plain median and
    no occlusion term, as ``ba_level_step``.  Returns the sharded flow.
    """
    irls = cfg.irls
    Hs, W, H_true = scfg.Hs, scfg.W, scfg.H_true
    dtype = uv[0].dtype

    m = _warp_setup(scfg, images, irls.interp, np.asarray(irls.deriv_filter), irls.blend, spline_tables, dtype)
    nc = m.nc
    valid = [g < H_true for g in m.g_col]  # (Hs, 1): the true rows
    vmask = [g < H_true - 1 for g in m.g_col]  # the rows owning a live vertical edge
    build_sys_local = _make_sys_builder(scfg, valid, vmask, dtype)
    rtol, maxiter = _solver_params(irls.solver)

    def blended_solve_local(uv, duv, derivs):
        sys_q = build_sys_local(uv, duv, derivs, irls.qua_rho_spatial_u, irls.qua_rho_spatial_v,
                                irls.qua_rho_data, irls.lambda_q)
        sys_r = build_sys_local(uv, duv, derivs, irls.rho_spatial_u, irls.rho_spatial_v, irls.rho_data,
                                irls.lambda_)
        x = solve_flow_system_local([blend_systems(alpha, q, r) for q, r in zip(sys_q, sys_r)], rtol, maxiter)
        if irls.limit_update:
            x = [torch.clamp(t, -1.0, 1.0) for t in x]
        return x

    # occlusion (ops/occlusion.py on the shards)
    sigma_d, sigma_i_occ = 0.3, 20.0

    def occlusion_local(uv):
        v_e = halo_exchange_rows([x[:, :, 1] for x in uv], 1, mode="edge")  # edge fill: 0 difference at row 0
        out = []
        for i, x in enumerate(uv):
            u, v = x[:, :, 0], x[:, :, 1]
            dudx = F.pad(u[:, 1:] - u[:, :-1], (1, 0))
            dvdy = v_e[i][1:-1] - v_e[i][:-2]
            occ_div = torch.exp(-((dudx + dvdy) ** 2) / (2.0 * sigma_d**2))
            xq = m.xgrid[i] + u
            yq = m.ygrid[i] + v
            It = torch.zeros_like(u)
            for c in range(nc):
                It = It + torch.abs(m.occ_sample(c, i, yq, xq) - m.im1s[c][i])
            It = It / nc
            out.append(occ_div * torch.exp(-(It**2) / (2.0 * sigma_i_occ**2)))
        return out

    # the non-local term (ops/wmedian.py on the shards; numpy-reflect at the true edges)
    if irls.median_filter_size is not None and cfg.use_color:
        hsz = int(cfg.area_hsz)

        def prep(xs):
            xs = halo_exchange_rows(_fixup_bottom(xs, scfg, "reflect"), hsz, mode="reflect")
            return [pad_axis(x, 1, hsz, hsz, "mirror") for x in xs]

        groups = _device_groups(uv)
        guide_pad = prep([c if c.ndim == 3 else c[:, :, None] for c in color])
        guides = [torch.stack([guide_pad[i].movedim(-1, 0) for i in idx]).contiguous() for _, idx in groups]

        def nl_filter(new_uv, occ):
            uv_pad, occ_pad = prep(new_uv), prep(occ)
            out = [None] * len(new_uv)
            for (_, idx), guide in zip(groups, guides):
                res = wmedian_kernel.wmedian(
                    torch.stack([uv_pad[i][:, :, 0] for i in idx]), torch.stack([uv_pad[i][:, :, 1] for i in idx]),
                    torch.stack([occ_pad[i] for i in idx]), guide, (Hs, W), hsz, float(cfg.sigma_i))
                for j, i in enumerate(idx):
                    out[i] = res[j]
            return out

    elif irls.median_filter_size is not None:
        kh, kw = irls.median_filter_size

        def nl_filter(new_uv, occ):
            return _median_filter_local(scfg, new_uv, kh, kw)

    # the warp iterations (classic_nl_level_step)
    for _ in range(irls.max_iters):
        derivs = m.warp_deriv(uv)
        duv = [torch.zeros_like(x) for x in uv]
        for _j in range(irls.max_linear):
            duv = blended_solve_local(uv, duv, derivs)
            if irls.median_filter_size is not None:
                new_uv = [u + d for u, d in zip(uv, duv)]
                occ = occlusion_local(new_uv) if cfg.use_color else None
                duv = [f - u for f, u in zip(nl_filter(new_uv, occ), uv)]
        uv = [u + d for u, d in zip(uv, duv)]
    return uv


def alt_ba_level_local(cfg, scfg: SpatialConfig, images, uv, uvhat, alpha, replacement: bool,
                       spline_tables=()) -> tuple:
    """One alt-BA pyramid level on the shards; returns the sharded (uv, uvhat).

    Mirrors ``alt_ba_level_step``: the α-blended BA system of
    :func:`classic_nl_level_local` plus the per-pixel coupling
    ``lambda2 rho'(uv - uvhat)`` on the diagonal and its right-hand side,
    masked to the true rows so that the pad rows of every PCG iterate stay
    exactly zero, then the Li–Osher update of ``uvhat`` through the sharded
    median (``iters_lo`` passes, each re-synthesising the pad).
    """
    from optical_flow_tpu_torch.methods.alt_ba import _annealing

    irls = cfg.irls
    dtype = uv[0].dtype
    m = _warp_setup(scfg, images, irls.interp, np.asarray(irls.deriv_filter), irls.blend, spline_tables, dtype)
    valid = [g < scfg.H_true for g in m.g_col]
    vmask = [g < scfg.H_true - 1 for g in m.g_col]
    build_sys_local = _make_sys_builder(scfg, valid, vmask, dtype)
    rtol, maxiter = _solver_params(irls.solver)
    mfsz = irls.median_filter_size

    def denoise_lo_local(un, lam_lo):
        """``ops/denoise.py::denoise_LO`` on the shards: u <- medfilt(u + lam (un - u))."""
        if mfsz is None:
            return un
        u = un
        for _ in range(cfg.iters_lo):
            u = _median_filter_local(scfg, [a + lam_lo * (b - a) for a, b in zip(u, un)], *mfsz)
        return u

    for lambda2, lam_lo in _annealing(cfg, dtype):
        derivs = m.warp_deriv(uv)
        duv = [torch.zeros_like(x) for x in uv]
        for _j in range(irls.max_linear):
            sys_q = build_sys_local(uv, duv, derivs, irls.qua_rho_spatial_u, irls.qua_rho_spatial_v,
                                    irls.qua_rho_data, irls.lambda_q)
            sys_r = build_sys_local(uv, duv, derivs, irls.rho_spatial_u, irls.rho_spatial_v, irls.rho_data,
                                    irls.lambda_)
            systems = []
            for k, (q, r) in enumerate(zip(sys_q, sys_r)):
                tmp = cfg.rho_couple.deriv_over_x(uv[k] - uvhat[k])
                tmp = torch.where(valid[k][:, :, None], tmp, torch.zeros((), dtype=dtype, device=tmp.device))
                sys = add_coupling(blend_systems(alpha, q, r), lambda2 * tmp)
                delta = lambda2 * tmp * (uvhat[k] - uv[k])
                systems.append(sys._replace(b_u=sys.b_u + delta[:, :, 0], b_v=sys.b_v + delta[:, :, 1]))
            duv = solve_flow_system_local(systems, rtol, maxiter)
            if irls.limit_update:
                duv = [torch.clamp(x, -1.0, 1.0) for x in duv]
        uv = [u + d for u, d in zip(uv, duv)]
        uvhat = denoise_lo_local(uv, lam_lo)
        if replacement:
            uv = uvhat
    return uv, uvhat


def hs_level_local(cfg, scfg: SpatialConfig, images, uv, spline_tables=()) -> list:
    """One Horn–Schunck pyramid level on the shards; returns the sharded flow.

    Mirrors ``hs_level_step``: the HS system with unit edge weights (the
    Neumann graph Laplacian, the pad rows decoupled), the distributed PCG,
    and the early stop: once ``sqrt(sum over the shards of sum(x^2))`` falls
    below ``STOP_NORM`` the update is discarded and the level ends.  The
    norm is summed in shard order on the first shard's device and read on
    the host once a warp iteration, as the unsharded level reads its flag,
    so every shard takes the same number of warp iterations.
    """
    from optical_flow_tpu_torch.methods.hs import STOP_NORM

    Hs, W, H_true = scfg.Hs, scfg.W, scfg.H_true
    dtype = uv[0].dtype
    m = _warp_setup(scfg, images, cfg.interp, np.asarray(cfg.deriv_filter), cfg.blend, spline_tables, dtype)
    valid = [g < H_true for g in m.g_col]
    vmask = [g < H_true - 1 for g in m.g_col]
    rtol, maxiter = _solver_params(cfg.solver)

    def cmean(x):
        return torch.mean(x, dim=2) if x.ndim == 3 else x

    # unit edge weights (the Neumann graph Laplacian), the pad rows decoupled
    w_edge = cfg.lambda_ / cfg.sigmaS2
    wh, wv = [], []
    for v, vm in zip(valid, vmask):
        edge = torch.full((Hs, W), w_edge, dtype=dtype, device=v.device)
        zero = torch.zeros((), dtype=dtype, device=v.device)
        wh.append(torch.where(v, F.pad(edge[:, :-1], (0, 1)), zero))
        wv.append(torch.where(vm, edge, zero))

    def build_sys(uv, derivs):
        lap_u = sharded_laplacian_apply_local(wh, wv, [x[:, :, 0] for x in uv])
        lap_v = sharded_laplacian_apply_local(wh, wv, [x[:, :, 1] for x in uv])
        systems = []
        for k, (It, Ix, Iy) in enumerate(derivs):
            zero = torch.zeros((), dtype=dtype, device=It.device)
            a11 = torch.where(valid[k], cmean(Ix**2) / cfg.sigmaD2, zero)
            a12 = torch.where(valid[k], cmean(Ix * Iy) / cfg.sigmaD2, zero)
            a22 = torch.where(valid[k], cmean(Iy**2) / cfg.sigmaD2, zero)
            b_u = torch.where(valid[k], -lap_u[k] - cmean(It * Ix) / cfg.sigmaD2, zero)
            b_v = torch.where(valid[k], -lap_v[k] - cmean(It * Iy) / cfg.sigmaD2, zero)
            systems.append(FlowSystem(a11, a12, a22, wh[k], wv[k], wh[k], wv[k], b_u, b_v))
        return systems

    for _ in range(cfg.max_warping_iters):
        x = solve_flow_system_local(build_sys(uv, m.warp_deriv(uv)), rtol, maxiter)
        # the pad rows' update is exactly 0; a NaN norm stops the level, as `norm >= 1e-3` in JAX
        if not bool(torch.sqrt(psum([torch.sum(a * a) for a in x])) >= STOP_NORM):
            break
        if cfg.limit_update:
            x = [torch.clamp(a, -1.0, 1.0) for a in x]
        uv = [u + a for u, a in zip(uv, x)]
        if cfg.median_filter_size is not None:
            for _k in range(cfg.mf_iter):
                uv = _median_filter_local(scfg, uv, *cfg.median_filter_size)
    return uv


# ---------------------------------------------------------------------------
# host-callable level steps
# ---------------------------------------------------------------------------


def _pad_images(images, pad):
    """Bottom rows mirrored with the edge (scipy 'reflect'), as the filters read past the edge."""
    return pad_axis(images, 0, 0, pad, "reflect")


def _level_plan(images, mesh, boundary_radius: int, halo: int, interp: str):
    """The level's :class:`SpatialConfig` on ``mesh``'s space axis, or None
    if the level is too short to tile."""
    H, W = images.shape[:2]
    margin = 2 if interp == "cubic" else 0
    return spatial_plan(H, W, int(mesh.shape[SPACE_AXIS]), boundary_radius, halo, warp_margin=margin)


def _shard_level(scfg: SpatialConfig, mesh, images, fields, interp: str, deriv_filter):
    """The level's inputs on the shards: the images, each flow field of
    ``fields`` (zero in the pad rows) and, for the 'cubic' warp, the B-spline
    tables computed on the whole level's true rows before any padding."""
    tables = _global_spline_tables(images, deriv_filter, scfg) if interp == "cubic" else ()
    if scfg.pad:
        images = _pad_images(images, scfg.pad)
        fields = [F.pad(f, (0, 0, 0, 0, 0, scfg.pad)) for f in fields]
    return (shard_rows(images, mesh), [shard_rows(f, mesh) for f in fields],
            tuple(tuple(shard_rows(T, mesh) for T in tabs) for tabs in tables))


def classic_nl_level_step_spatial(cfg, images, color, uv, alpha, mesh, halo: int = 6, fallback=None):
    """Row-sharded ``classic_nl_level_step`` on ``mesh``; the flow returns on ``uv``'s device.

    Unsupported configurations raise (:func:`check_spatial_config`).  Levels
    too small to tile run the single-device step (``fallback``, if given:
    the BA wrapper passes its own level step, so the decision lives here
    alone).  The guard runs on the whole level after the shards are
    gathered: a rollback a shard would splice healthy and rolled-back tiles.
    """
    H = images.shape[0]
    check_spatial_config(cfg.irls.interp, cfg.irls.solver[0])
    if cfg.use_color:
        boundary_radius = int(cfg.area_hsz)
    elif cfg.irls.median_filter_size is not None:
        boundary_radius = int(cfg.irls.median_filter_size[0]) // 2
    else:
        boundary_radius = 2
    scfg = _level_plan(images, mesh, boundary_radius, halo, cfg.irls.interp)
    if scfg is None:
        if fallback is not None:
            return fallback()
        from optical_flow_tpu_torch.methods.classic_nl import classic_nl_level_step

        return classic_nl_level_step(cfg, images, color, uv, alpha)

    if cfg.use_color and scfg.pad:
        color = pad_axis(color, 0, 0, scfg.pad, "mirror")  # the median's numpy-reflect
    with sharded_over(mesh):
        im_s, (uv_s,), tables = _shard_level(scfg, mesh, images, [uv], cfg.irls.interp, cfg.irls.deriv_filter)
        out = classic_nl_level_local(cfg, scfg, im_s, shard_rows(color, mesh) if cfg.use_color else None, uv_s,
                                     alpha, tables)
        out = gather_rows(out, uv.device)[:H]
    if cfg.irls.guard:
        out = guard_level(out, uv, cfg.irls.guard)
    return out


def ba_level_step_spatial(cfg, images, uv, alpha, mesh, halo: int = 6):
    """Row-sharded ``ba_level_step`` (``cfg``: IRLSLevelConfig).

    The BA level is the Classic+NL local program with ``use_color=False``:
    the same α-blended IRLS solve and duv-trick median, no occlusion term.
    """
    from optical_flow_tpu_torch.methods.ba import ba_level_step
    from optical_flow_tpu_torch.methods.classic_nl import NLLevelConfig

    ncfg = NLLevelConfig(irls=cfg, area_hsz=0, sigma_i=0.0, full_version=False, use_color=False)
    # the too-small-to-tile decision lives in classic_nl_level_step_spatial
    # alone; only the single-device step it falls back to is BA's own
    return classic_nl_level_step_spatial(ncfg, images, None, uv, alpha, mesh, halo,
                                         fallback=lambda: ba_level_step(cfg, images, uv, alpha))


def alt_ba_level_step_spatial(cfg, images, uv, uvhat, alpha, replacement: bool, mesh, halo: int = 6):
    """Row-sharded ``alt_ba_level_step`` (``cfg``: AltBALevelConfig); returns
    (uv, uvhat) on ``uv``'s device.

    Both coupled fields shard over rows, zero in the pad rows; levels too
    small to tile run the single-device step.  The guard rolls the whole
    (uv, uvhat) pair back after the shards are gathered.
    """
    from optical_flow_tpu_torch.methods.alt_ba import alt_ba_level_step

    irls = cfg.irls
    check_spatial_config(irls.interp, irls.solver[0])
    mfsz = irls.median_filter_size
    boundary_radius = max(int(mfsz[0]) // 2 if mfsz else 2, 2)
    scfg = _level_plan(images, mesh, boundary_radius, halo, irls.interp)
    if scfg is None:
        return alt_ba_level_step(cfg, images, uv, uvhat, alpha, replacement)

    H = images.shape[0]
    with sharded_over(mesh):
        im_s, (uv_s, uvhat_s), tables = _shard_level(scfg, mesh, images, [uv, uvhat], irls.interp,
                                                     irls.deriv_filter)
        out_uv, out_uvhat = alt_ba_level_local(cfg, scfg, im_s, uv_s, uvhat_s, alpha, replacement, tables)
        out_uv, out_uvhat = gather_rows(out_uv, uv.device)[:H], gather_rows(out_uvhat, uv.device)[:H]
    if irls.guard:
        out_uv, out_uvhat = guard_level_pair(out_uv, out_uvhat, uv, uvhat, irls.guard)
    return out_uv, out_uvhat


def hs_level_step_spatial(cfg, images, uv, mesh, halo: int = 6):
    """Row-sharded ``hs_level_step`` (``cfg``: HSLevelConfig); the flow returns
    on ``uv``'s device.  Levels too small to tile run the single-device step;
    the guard runs on the gathered level."""
    from optical_flow_tpu_torch.methods.hs import hs_level_step

    check_spatial_config(cfg.interp, cfg.solver[0])
    boundary_radius = int(cfg.median_filter_size[0]) // 2 if cfg.median_filter_size else 2
    scfg = _level_plan(images, mesh, boundary_radius, halo, cfg.interp)
    if scfg is None:
        return hs_level_step(cfg, images, uv)

    H = images.shape[0]
    with sharded_over(mesh):
        im_s, (uv_s,), tables = _shard_level(scfg, mesh, images, [uv], cfg.interp, cfg.deriv_filter)
        out = gather_rows(hs_level_local(cfg, scfg, im_s, uv_s, tables), uv.device)[:H]
    if cfg.guard:
        out = guard_level(out, uv, cfg.guard)
    return out
