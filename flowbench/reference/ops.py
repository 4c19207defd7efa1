"""Plain PyTorch operations of the Classic+NL and Classic++ pipelines, for the reference flow.

A frozen copy of the plain (CPU) code of ``optical_flow_tpu_torch`` for one
frame pair: the MATLAB-compatible colour conversion, ROF, Gaussian
pyramids with MATLAB bilinear resizes, the Hermite bi-cubic warp, the IRLS
systems, block-Jacobi PCG, occlusion, the colour-weighted median and the
plain median.  Nothing here imports the port; every operation is written
in plain ``torch`` and runs on any device in the tensors' dtype.
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

DERIV_FILTER = np.array([1.0, -8.0, 0.0, 8.0, -1.0]) / 12.0

# Hermite bicubic coefficient matrix (Numerical Recipes "bcucof" table)
W_BICUBIC = np.array(
    [
        [1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0],
        [-3, 0, 0, 3, 0, 0, 0, 0, -2, 0, 0, -1, 0, 0, 0, 0],
        [2, 0, 0, -2, 0, 0, 0, 0, 1, 0, 0, 1, 0, 0, 0, 0],
        [0, 0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 0, 0],
        [0, 0, 0, 0, -3, 0, 0, 3, 0, 0, 0, 0, -2, 0, 0, -1],
        [0, 0, 0, 0, 2, 0, 0, -2, 0, 0, 0, 0, 1, 0, 0, 1],
        [-3, 3, 0, 0, -2, -1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, -3, 3, 0, 0, -2, -1, 0, 0],
        [9, -9, 9, -9, 6, 3, -3, -6, 6, -6, -3, 3, 4, 2, 1, 2],
        [-6, 6, -6, 6, -4, -2, 2, 4, -3, 3, 3, -3, -2, -1, -1, -2],
        [2, -2, 0, 0, 1, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 2, -2, 0, 0, 1, 1, 0, 0],
        [-6, 6, -6, 6, -3, -3, 3, 3, -4, 4, 2, -2, -2, -2, -1, -1],
        [4, -4, 4, -4, 2, 2, -2, -2, 2, -2, -2, 2, 1, 1, 1, 1],
    ],
    dtype=np.float64,
)
# corner order of the table: (fx, fy), (cx, fy), (cx, cy), (fx, cy)
HERMITE_CORNER_SHIFTS = ((0, 0), (0, 1), (1, 1), (1, 0))


# ---------------------------------------------------------------- MATLAB helpers

def matlab_round(x: float) -> int:
    return int(np.floor(x + 0.5))


def scale_image(im, vlow, vhigh):
    """Rescale ``im`` linearly from its own [min, max] (over every channel) to [vlow, vhigh]."""
    ilow, ihigh = im.amin(), im.amax()
    span = ihigh - ilow
    safe = torch.where(span == 0, torch.ones_like(span), span)
    scaled = (im - ilow) / safe * (vhigh - vlow) + vlow
    return torch.where(span == 0, torch.full_like(im, (vlow + vhigh) / 2.0), scaled)


def fspecial_gaussian(size: int, sigma: float) -> np.ndarray:
    m = n = (size - 1) / 2.0
    y, x = np.ogrid[-m : m + 1, -n : n + 1]
    h = np.exp(-(x**2 + y**2) / (2.0 * sigma**2))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    s = h.sum()
    if s != 0:
        h /= s
    return h


def rgb2gray(im):
    """MATLAB ``double(rgb2gray(uint8(im)))``: both roundings half away from zero."""
    q = torch.clamp(torch.floor(im + 0.5), 0, 255)
    gray = 0.2989 * q[..., 0] + 0.5870 * q[..., 1] + 0.1140 * q[..., 2]
    return torch.floor(gray + 0.5)


def _cbrt(t):
    return torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)


def rgb2lab(im):
    """(H, W, 3) RGB -> CIE Lab (BT.709 primaries, D65), divided by 255 if any value exceeds 1."""
    R, G, B = im[..., 0], im[..., 1], im[..., 2]
    scale = 1.0 / 255.0 if float(im.amax()) > 1.0 else 1.0
    R, G, B = R * scale, G * scale, B * scale
    T = 0.008856
    X = (0.412453 * R + 0.357580 * G + 0.180423 * B) / 0.950456
    Y = 0.212671 * R + 0.715160 * G + 0.072169 * B
    Z = (0.019334 * R + 0.119193 * G + 0.950227 * B) / 1.088754
    XT, YT, ZT = X > T, Y > T, Z > T
    Y3 = _cbrt(Y)
    fX = torch.where(XT, _cbrt(X), 7.787 * X + 16.0 / 116.0)
    fY = torch.where(YT, Y3, 7.787 * Y + 16.0 / 116.0)
    fZ = torch.where(ZT, _cbrt(Z), 7.787 * Z + 16.0 / 116.0)
    L = torch.where(YT, 116.0 * Y3 - 16.0, 903.3 * Y)
    return torch.stack([L, 500.0 * (fX - fY), 200.0 * (fY - fZ)], dim=-1)


def gray_pair_and_guide(rgb1, rgb2):
    """(H, W, 2) MATLAB gray pair and the (H, W, 3) Lab guide, each channel rescaled to [0, 255]."""
    gray = torch.stack([rgb2gray(rgb1), rgb2gray(rgb2)], dim=-1)
    lab = rgb2lab(rgb1)
    return gray, torch.stack([scale_image(lab[..., j], 0, 255) for j in range(3)], dim=-1)


# ---------------------------------------------------------------- padding and filters

def pad_index(n: int, before: int, after: int, boundary: str) -> np.ndarray:
    """Source index of every padded position, scipy.ndimage boundary names."""
    i = np.arange(-before, n + after)
    if boundary == "reflect":  # edge repeated
        i = np.mod(i, 2 * n)
        return np.where(i >= n, 2 * n - 1 - i, i)
    if boundary == "mirror":  # edge not repeated
        if n == 1:
            return np.zeros_like(i)
        i = np.mod(i, 2 * n - 2)
        return np.where(i >= n, 2 * n - 2 - i, i)
    raise ValueError(f"unknown boundary {boundary!r}")


def pad2d(im, t: int, b: int, l: int, r: int, boundary: str):
    rows = torch.as_tensor(pad_index(im.shape[-2], t, b, boundary), device=im.device)
    cols = torch.as_tensor(pad_index(im.shape[-1], l, r, boundary), device=im.device)
    return im.index_select(-2, rows).index_select(-1, cols)


def correlate2d(im, kernel, boundary: str = "reflect"):
    """Correlation of the last two axes with a constant kernel, origin at the centre (ties upper-left)."""
    kernel = np.atleast_2d(np.asarray(kernel))
    kh, kw = kernel.shape
    cy, cx = kh // 2, kw // 2
    padded = pad2d(im, cy, kh - 1 - cy, cx, kw - 1 - cx, boundary)
    H, W = im.shape[-2:]
    out = torch.zeros_like(im)
    for dy in range(kh):
        for dx in range(kw):
            w = float(kernel[dy, dx])
            if w != 0.0:
                out = out + w * padded[..., dy : dy + H, dx : dx + W]
    return out


def correlate_channels(im, kernel):
    """:func:`correlate2d` of (H, W) or of every channel of (H, W, C)."""
    if im.ndim == 2:
        return correlate2d(im, kernel)
    return correlate2d(im.movedim(-1, 0), kernel).movedim(0, -1)


def median_filter2d(im, size: int):
    """Median (rank k*k // 2) of each k x k window of the last two axes, scipy 'reflect' boundary, NaN last."""
    c = size // 2
    H, W = im.shape[-2:]
    padded = pad2d(im, c, size - 1 - c, c, size - 1 - c, "reflect")
    padded = torch.where(torch.isnan(padded), torch.inf, padded)
    stack = torch.stack([padded[..., dy : dy + H, dx : dx + W] for dy in range(size) for dx in range(size)], dim=-1)
    out = torch.sort(stack, dim=-1).values[..., size * size // 2]
    return torch.where(out == torch.inf, torch.nan, out)


# ---------------------------------------------------------------- resizes and pyramids

@lru_cache(maxsize=None)
def resize_matrix(n_in: int, n_out: int) -> np.ndarray:
    """1-D MATLAB ``imresize(..., 'bilinear', Antialiasing=false)`` as a dense (n_out, n_in) matrix."""
    u = np.clip((np.arange(n_out) + 0.5) / (n_out / n_in) - 0.5, 0, n_in - 1)
    lo = np.floor(u).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    a = u - lo
    M = np.zeros((n_out, n_in))
    M[np.arange(n_out), lo] += 1.0 - a
    M[np.arange(n_out), hi] += a
    return M


def resize_planes(x, out_hw):
    """MATLAB bilinear resize of the last two axes, as two matrix products."""
    H, W = x.shape[-2:]
    Rh = torch.as_tensor(resize_matrix(H, int(out_hw[0])), dtype=x.dtype, device=x.device)
    Rw = torch.as_tensor(resize_matrix(W, int(out_hw[1])), dtype=x.dtype, device=x.device)
    return Rh @ x @ Rw.T


def imresize(im, out_hw):
    if im.ndim == 2:
        return resize_planes(im, out_hw)
    return resize_planes(im.movedim(-1, 0), out_hw).movedim(0, -1)


def pyramid_shapes(hw, n_levels: int, ratio: float):
    shapes = [(int(hw[0]), int(hw[1]))]
    for _ in range(1, n_levels):
        H, W = shapes[-1]
        shapes.append((max(1, matlab_round(H * ratio)), max(1, matlab_round(W * ratio))))
    return shapes


def auto_pyramid_levels(hw, spacing: float) -> int:
    return 1 + int(np.floor(np.log(min(hw) / 16.0) / np.log(spacing)))


def build_pyramid(im, levels: int, spacing: float):
    """Gaussian pyramid of (H, W[, C]), finest first: smooth (scipy 'reflect'), then resize."""
    shapes = pyramid_shapes(im.shape[:2], levels, 1.0 / spacing)
    sigma = np.sqrt(spacing) / np.sqrt(2.0)
    f = fspecial_gaussian(2 * int(round(1.5 * sigma)) + 1, sigma)
    out = [im]
    for lvl in range(1, levels):
        out.append(imresize(correlate_channels(out[-1], f), shapes[lvl]))
    return out


def resample_flow(uv, hw):
    """Resize (H, W, 2) flow to ``hw``; both components scale by the height ratio (a MATLAB quirk)."""
    H = uv.shape[0]
    if tuple(uv.shape[:2]) == (int(hw[0]), int(hw[1])):
        return uv
    return resize_planes(uv.movedim(-1, 0), hw).movedim(0, -1) * (int(hw[0]) / H)


# ---------------------------------------------------------------- ROF texture

def _divergence(px, py):
    return (px - F.pad(px[..., :, :-1], (1, 0))) + (py - F.pad(py[..., :-1, :], (0, 0, 1, 0)))


def rof_structure(im, theta: float, n_iters: int):
    """Chambolle's primal-dual ROF structure component of every (H, W) plane of ``im``."""
    delta = 1.0 / (4.0 * theta)
    px = torch.zeros_like(im)
    py = torch.zeros_like(im)
    for _ in range(n_iters):
        u = im + theta * _divergence(px, py)
        gx = F.pad(u[..., :, 1:] - u[..., :, :-1], (0, 1))
        gy = F.pad(u[..., 1:, :] - u[..., :-1, :], (0, 0, 0, 1))
        px = px + delta * gx
        py = py + delta * gy
        norm = torch.clamp(torch.sqrt(px**2 + py**2), min=1.0)
        px = px / norm
        py = py / norm
    return im + theta * _divergence(px, py)


def texture(images, theta: float, n_iters: int, alp: float):
    """Texture of the (H, W, 2) pair: normalised to [-1, 1] over both frames, minus ``alp`` x structure, to [0, 255]."""
    norm = scale_image(images, -1, 1)
    structure = rof_structure(norm.movedim(-1, 0).contiguous(), theta, n_iters).movedim(0, -1)
    return scale_image(norm - alp * structure, 0, 255)


# ---------------------------------------------------------------- Hermite bi-cubic warp

def hermite_tables(im2):
    """(Z, dZ/dx, dZ/dy, d2Z/dxdy) of frame 2 under the 5-tap derivative filter."""
    f = DERIV_FILTER
    return (im2, correlate2d(im2, f.reshape(1, -1)), correlate2d(im2, f.reshape(-1, 1)),
            correlate2d(im2, np.outer(f, f)))


def _index(f, n: int):
    """Whole-number coordinates ``f`` as indices clamped to [0, n - 1], NaN as 0 (the clamp repeated on the
    integers: in bfloat16 n - 1 may round up to n)."""
    return torch.clamp(torch.clamp(torch.nan_to_num(f, nan=0.0), 0, n - 1).long(), 0, n - 1)


def hermite_sample(tables, yq, xq):
    """Hermite bicubic value and analytical d/dx, d/dy at 0-based points, and the out-of-grid mask."""
    H, W = tables[0].shape
    fx = torch.floor(xq)
    fy = torch.floor(yq)
    oob = (fx < 0) | (fx + 1 > W - 1) | (fy < 0) | (fy + 1 > H - 1)
    iy0 = _index(fy, H)
    ix0 = _index(fx, W)
    flat = torch.stack(tables, dim=0).reshape(4, H * W)
    corners = torch.stack([torch.clamp(iy0 + a, max=H - 1) * W + torch.clamp(ix0 + b, max=W - 1)
                           for a, b in HERMITE_CORNER_SHIFTS], dim=0)
    idx = corners.reshape(1, 4, -1).expand(4, 4, corners[0].numel())
    taps = torch.gather(flat.unsqueeze(1).expand(4, 4, H * W), -1, idx).reshape(16, *xq.shape)
    Wb = torch.as_tensor(W_BICUBIC, dtype=taps.dtype, device=taps.device)
    C = torch.tensordot(Wb, taps, dims=1)
    ax, ay = xq - fx, yq - fy
    ax_p = [torch.ones_like(ax), ax, ax * ax, ax * ax * ax]
    ay_p = [torch.ones_like(ay), ay, ay * ay, ay * ay * ay]
    val = torch.zeros_like(ax)
    vx = torch.zeros_like(ax)
    vy = torch.zeros_like(ax)
    k = 0
    for i in range(4):
        for j in range(4):
            c = C[k]
            val = val + c * ax_p[i] * ay_p[j]
            if i > 0:
                vx = vx + i * c * ax_p[i - 1] * ay_p[j]
            if j > 0:
                vy = vy + j * c * ax_p[i] * ay_p[j - 1]
            k += 1
    return val, vx, vy, oob


def warp_derivatives(im1, I1x, I1y, tables, uv, blend: float):
    """(It, Ix, Iy) of frame 2 warped by ``uv`` with the bi-cubic interpolator, zero outside the grid."""
    H, W = uv.shape[:2]
    ygrid, xgrid = torch.meshgrid(torch.arange(H, dtype=uv.dtype, device=uv.device),
                                  torch.arange(W, dtype=uv.dtype, device=uv.device), indexing="ij")
    warp, wx, wy, mask = hermite_sample(tables, ygrid + uv[..., 1], xgrid + uv[..., 0])
    zero = torch.zeros((), dtype=uv.dtype, device=uv.device)
    It = torch.where(mask, zero, warp - im1)
    Ix = torch.where(mask, zero, blend * wx + (1 - blend) * I1x)
    Iy = torch.where(mask, zero, blend * wy + (1 - blend) * I1y)
    return It, Ix, Iy


# ---------------------------------------------------------------- penalties and IRLS systems

def penalty_weight(name: str, params, x):
    """IRLS weight rho'(x) / x of the penalties the two configurations use."""
    if name == "quadratic":
        return torch.full_like(x, 2.0 / params[0] ** 2)
    if name == "generalized_charbonnier":
        sig, a = params
        return 2.0 * a * (sig**2 + x**2) ** (a - 1.0)
    raise ValueError(f"penalty {name!r} is not used by these configurations")


def _fdiff_h(x):
    return F.pad(x[..., :, 1:] - x[..., :, :-1], (0, 1))


def _fdiff_v(x):
    return F.pad(x[..., 1:, :] - x[..., :-1, :], (0, 0, 0, 1))


def laplacian_apply(w_h, w_v, x):
    """Edge-weighted 4-neighbour Laplacian F^T diag(w) F applied to ``x``."""
    eh = w_h * (x - F.pad(x[..., :, 1:], (0, 1)))
    ev = w_v * (x - F.pad(x[..., 1:, :], (0, 0, 0, 1)))
    out = eh + ev
    out = out - F.pad(eh[..., :, :-1], (1, 0))
    return out - F.pad(ev[..., :-1, :], (0, 0, 1, 0))


def laplacian_diag(w_h, w_v):
    return w_h + F.pad(w_h[..., :, :-1], (1, 0)) + w_v + F.pad(w_v[..., :-1, :], (0, 0, 1, 0))


def irls_system(uv, duv, It, Ix, Iy, spatial, data, lam):
    """The nine planes (a11, a12, a22, wu_h, wu_v, wv_h, wv_v, b_u, b_v) of the linearised IRLS system."""
    u, v = uv[..., 0], uv[..., 1]
    up, vp = u + duv[..., 0], v + duv[..., 1]
    name, params = spatial
    mask_h = torch.ones_like(u)
    mask_h[:, -1] = 0.0
    mask_v = torch.ones_like(u)
    mask_v[-1, :] = 0.0
    wu_h = lam * penalty_weight(name, params, _fdiff_h(up)) * mask_h
    wv_h = lam * penalty_weight(name, params, _fdiff_h(vp)) * mask_h
    wu_v = lam * penalty_weight(name, params, _fdiff_v(up)) * mask_v
    wv_v = lam * penalty_weight(name, params, _fdiff_v(vp)) * mask_v
    It_lin = It + Ix * duv[..., 0] + Iy * duv[..., 1]
    pp_d = penalty_weight(*data, It_lin)
    b_u = -laplacian_apply(wu_h, wu_v, u) - pp_d * (It_lin * Ix)
    b_v = -laplacian_apply(wv_h, wv_v, v) - pp_d * (It_lin * Iy)
    return [pp_d * Ix**2, pp_d * (Ix * Iy), pp_d * Iy**2, wu_h, wu_v, wv_h, wv_v, b_u, b_v]


def pcg(system, rtol: float, maxiter: int, check_every: int = 16):
    """Block-Jacobi (2x2 a pixel) PCG from x0 = 0, stopping when ||r||^2 <= rtol^2 ||b||^2
    (tested before every iteration) or at ``maxiter``; returns ((H, W, 2) solution, iterations).

    Inner products accumulate in float64 and round once to the planes' dtype.  The stopping test
    runs on the device: an iteration whose test fails leaves the state as it is, and the host looks
    every ``check_every`` iterations, so the result is that of the test before every iteration."""
    a11, a12, a22, wu_h, wu_v, wv_h, wv_v, bu, bv = system
    du = a11 + laplacian_diag(wu_h, wu_v)
    dv = a22 + laplacian_diag(wv_h, wv_v)
    zero = torch.zeros((), dtype=bu.dtype, device=bu.device)
    one = torch.ones((), dtype=bu.dtype, device=bu.device)
    det = du * dv - a12 * a12
    ok = torch.abs(det) > 1e-12
    safe = torch.where(ok, det, one)
    i00 = torch.where(ok, dv / safe, torch.where(torch.abs(du) > 1e-12, 1.0 / du, zero))
    i01 = torch.where(ok, -a12 / safe, zero)
    i11 = torch.where(ok, du / safe, torch.where(torch.abs(dv) > 1e-12, 1.0 / dv, zero))

    def dot(au, av, bu_, bv_):  # products and sums in float64, the result in the planes' dtype
        return (torch.sum(au.double() * bu_.double()) + torch.sum(av.double() * bv_.double())).to(au.dtype)

    xu, xv = torch.zeros_like(bu), torch.zeros_like(bv)
    ru, rv = bu, bv
    zu, zv = i00 * ru + i01 * rv, i01 * ru + i11 * rv
    pu, pv = zu, zv
    rz = dot(ru, rv, zu, zv)
    tol2 = rtol**2 * dot(bu, bv, bu, bv)
    k = torch.zeros((), dtype=torch.int64, device=bu.device)
    done = 0
    while done < maxiter and bool(dot(ru, rv, ru, rv) > tol2):
        for _ in range(min(check_every, maxiter - done)):
            go = dot(ru, rv, ru, rv) > tol2
            Apu = a11 * pu + a12 * pv + laplacian_apply(wu_h, wu_v, pu)
            Apv = a12 * pu + a22 * pv + laplacian_apply(wv_h, wv_v, pv)
            pAp = dot(pu, pv, Apu, Apv)
            alpha = torch.where(go & (pAp != 0.0), rz / pAp, zero)
            xu = xu + alpha * pu
            xv = xv + alpha * pv
            ru = ru - alpha * Apu
            rv = rv - alpha * Apv
            zu, zv = i00 * ru + i01 * rv, i01 * ru + i11 * rv
            rz_new = dot(ru, rv, zu, zv)
            beta = torch.where(rz != 0.0, rz_new / rz, zero)
            pu = torch.where(go, zu + beta * pu, pu)
            pv = torch.where(go, zv + beta * pv, pv)
            rz = torch.where(go, rz_new, rz)
            k = k + go.long()
        done += check_every
    return torch.stack([xu, xv], dim=-1), int(k)


# ---------------------------------------------------------------- occlusion and the non-local term

def _bilinear_nearest(im, ys, xs):
    """Bilinear sample of (H, W) ``im`` at 0-based points, coordinates clamped to the image."""
    H, W = im.shape
    ysc = torch.clamp(ys, 0.0, H - 1.0)
    xsc = torch.clamp(xs, 0.0, W - 1.0)
    y0f, x0f = torch.floor(ysc), torch.floor(xsc)
    y0 = _index(y0f, H)
    x0 = _index(x0f, W)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    x1 = torch.clamp(x0 + 1, max=W - 1)
    ay, ax = ysc - y0f, xsc - x0f
    flat = im.reshape(-1)
    v00, v01, v10, v11 = (flat[(r * W + c).reshape(-1)].reshape(ys.shape)
                          for r, c in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)))
    return (v00 * (1.0 - ax) + v01 * ax) * (1.0 - ay) + (v10 * (1.0 - ax) + v11 * ax) * ay


def occlusion(uv, images, sigma_d: float = 0.3, sigma_i: float = 20.0):
    """Occlusion confidence in [0, 1] from the flow's divergence and brightness constancy."""
    H, W = uv.shape[:2]
    u, v = uv[..., 0], uv[..., 1]
    div = F.pad(u[:, 1:] - u[:, :-1], (1, 0)) + F.pad(v[1:, :] - v[:-1, :], (0, 0, 1, 0))
    occ_div = torch.exp(-(div**2) / (2.0 * sigma_d**2))
    ygrid, xgrid = torch.meshgrid(torch.arange(H, dtype=uv.dtype, device=uv.device),
                                  torch.arange(W, dtype=uv.dtype, device=uv.device), indexing="ij")
    It = torch.abs(_bilinear_nearest(images[..., 1], ygrid + v, xgrid + u) - images[..., 0])
    return occ_div * torch.exp(-(It**2) / (2.0 * sigma_i**2))


def weighted_median(uv, guide, occ, hsz: int, sigma_i: float, chunk_elems: int = 32 * 1024 * 1024):
    """Colour- and occlusion-weighted median of both fields over (2 hsz + 1)^2 windows (numpy 'reflect'
    padding), weights max(exp(-|dc|^2 / (2 sigma^2)) occ, 1e-10).

    The median of a window is its smallest sample m whose summed weight (of the samples <= m) reaches
    half the total: the window's samples sorted, their weights summed in that order in float64.  Rows
    of pixels run in chunks of at most ``chunk_elems`` window samples."""
    H, W = uv.shape[:2]
    k = 2 * hsz + 1
    K2 = k * k

    def pad(x):
        return pad2d(x, hsz, hsz, hsz, hsz, "mirror")

    u_pad, v_pad, occ_pad = pad(uv[..., 0]), pad(uv[..., 1]), pad(occ)
    g_pad = pad(guide.movedim(-1, 0)).movedim(0, -1)
    inv_2sigma2 = 1.0 / (2.0 * sigma_i**2)
    rows_per = max(1, min(H, chunk_elems // (W * K2)))
    out = []
    for r0 in range(0, H, rows_per):
        rows = min(rows_per, H - r0)
        sl = slice(r0, r0 + rows + 2 * hsz)

        def patches(x):  # (rows * W, K2): each pixel's window samples
            return x[sl].unfold(0, k, 1).unfold(1, k, 1).reshape(rows * W, K2)

        cdiff = torch.zeros((rows * W, K2), dtype=uv.dtype, device=uv.device)
        for c in range(guide.shape[-1]):
            centre = guide[r0 : r0 + rows, :, c].reshape(rows * W, 1)
            cdiff = cdiff + (patches(g_pad[..., c]) - centre) ** 2
        w = torch.clamp(torch.exp(-cdiff * inv_2sigma2) * patches(occ_pad), min=1e-10).double()
        half = w.sum(1, keepdim=True) * 0.5
        fields = []
        for f in (u_pad, v_pad):
            vals, order = torch.sort(patches(f), dim=1, stable=True)
            reach = torch.cumsum(torch.gather(w, 1, order), dim=1) >= half
            first = torch.clamp(K2 - reach.sum(1, keepdim=True), max=K2 - 1)  # the first sorted sample reaching half
            fields.append(torch.gather(vals, 1, first).reshape(rows, W))
        out.append(torch.stack(fields, dim=-1))
    return torch.cat(out, dim=0)
