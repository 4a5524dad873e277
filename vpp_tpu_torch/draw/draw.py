"""Drawing primitives (port of ``vpp_tpu.draw.draw``).

* ``plot_color``: alpha-blended pixel plot;
* ``draw_line``: the Bresenham segment as uniform parametric samples
  (n >= max(|dr|, |dc|) + 1 samples give the same pixel set);
* ``draw_square``: filled or outlined square;
* ``draw_trajectories``: per-track polylines with age-decaying alpha.

Each primitive makes a fixed set of (row, col, value) samples and writes
them with one scatter; samples outside the image are dropped. Where two
samples hit one pixel, the sample last in flat order is written
(``core.keypoints.scatter_last``): a deterministic rule, the same on the
card as on the CPU, where the JAX package's scatter leaves the winner
open.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.image import Image2d, saturate_cast
from ..core.keypoints import scatter_last

RGB_COLORS = {
    "red": (255, 0, 0), "green": (0, 255, 0), "blue": (0, 0, 255),
    "white": (255, 255, 255), "black": (0, 0, 0), "yellow": (255, 255, 0),
    "cyan": (0, 255, 255), "magenta": (255, 0, 255),
    "orange": (255, 165, 0), "teal": (0, 128, 128),
}


def _as_data(img):
    if isinstance(img, Image2d):
        return img.data, img.border
    return torch.as_tensor(img), 0


def _wrap(img, data):
    if isinstance(img, Image2d):
        return Image2d(data=data, border=img.border)
    return data


def _cast(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``astype`` as the JAX package converts: saturating to integers."""
    return x.to(dtype) if dtype.is_floating_point else saturate_cast(x, dtype)


def linspace01(n: int, device) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` bit for bit: i / (n - 1) in float32."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return i / (n - 1) if n > 1 else i


def set_pixels(data: torch.Tensor, r: torch.Tensor, c: torch.Tensor,
               values: torch.Tensor) -> torch.Tensor:
    """``data.at[r, c].set(values, mode="drop")`` on an (H, W[, C]) buffer:
    rows r == H (or any pixel outside) are dropped, and where samples
    repeat a pixel the last in flat order is written."""
    h, w = data.shape[0], data.shape[1]
    r, c = r.reshape(-1).long(), c.reshape(-1).long()
    inside = (r >= 0) & (r < h) & (c >= 0) & (c < w)
    flat = torch.where(inside, r * w + c, torch.full_like(r, h * w))
    out = scatter_last(data.reshape((h * w,) + data.shape[2:]), flat,
                       values)
    return out.view(data.shape)


def plot_color(img, points, color, alpha: Optional[torch.Tensor] = None,
               valid: Optional[torch.Tensor] = None):
    """Alpha-blend ``color`` at integer (row, col) ``points`` (interior
    coordinates); ``alpha`` in [0, 1] per point, default opaque."""
    data, b = _as_data(img)
    h, w = data.shape[:2]
    dev = data.device
    pts = torch.as_tensor(points, device=dev)
    pts = (saturate_cast(pts, torch.int32) if pts.dtype.is_floating_point
           else pts.to(torch.int32)) + b
    color = torch.as_tensor(color, device=dev).to(data.dtype)
    n = pts.shape[0]
    a = (torch.ones((n,), dtype=torch.float32, device=dev) if alpha is None
         else torch.as_tensor(alpha, device=dev).to(torch.float32))
    ok = ((pts[:, 0] >= 0) & (pts[:, 0] < h)
          & (pts[:, 1] >= 0) & (pts[:, 1] < w))
    if valid is not None:
        ok = ok & valid
    r = torch.where(ok, pts[:, 0], torch.full_like(pts[:, 0], h))
    c = torch.where(ok, pts[:, 1], torch.zeros_like(pts[:, 1]))
    old = data[r.clamp(0, h - 1).long(), c.long()]
    if old.dim() > 1:
        a = a[..., None]
    blended = _cast(old.to(torch.float32) * (1 - a)
                    + color.to(torch.float32) * a, data.dtype)
    return _wrap(img, set_pixels(data, r, c, blended))


def line_points(p1, p2, n: int,
                device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """n uniformly spaced integer samples from p1 to p2: with n >=
    max(|dr|, |dc|) + 1 they are Bresenham's pixel set."""
    p1 = torch.as_tensor(p1, dtype=torch.float32, device=device)
    p2 = torch.as_tensor(p2, dtype=torch.float32, device=p1.device)
    t = linspace01(n, p1.device)[:, None]
    pts = saturate_cast(torch.round(p1[None] * (1 - t) + p2[None] * t),
                        torch.int32)
    return pts, torch.ones((n,), dtype=torch.bool, device=p1.device)


def draw_line(img, p1, p2, color, n: Optional[int] = None):
    """Rasterise the segment p1-p2; ``n`` samples, by default h + w."""
    data, _ = _as_data(img)
    h, w = data.shape[:2]
    if n is None:
        n = h + w
    pts, ok = line_points(p1, p2, n, data.device)
    return plot_color(img, pts, color, valid=ok)


def draw_square(img, center, half: int, color, fill: bool = True):
    """Filled (or outlined) axis-aligned square of half-width ``half``."""
    data, _ = _as_data(img)
    dev = data.device
    side = 2 * half + 1
    o = torch.arange(-half, half + 1, dtype=torch.int32, device=dev)
    rr = o[:, None].expand(side, side)
    cc = o[None, :].expand(side, side)
    if fill:
        edge = torch.ones((side, side), dtype=torch.bool, device=dev)
    else:
        edge = (rr.abs() == half) | (cc.abs() == half)
    ctr = torch.as_tensor(center, device=dev).to(torch.int32)
    pts = torch.stack([rr + ctr[0], cc + ctr[1]], dim=-1).reshape(-1, 2)
    return plot_color(img, pts, color, valid=edge.reshape(-1))


def _age_color(age: torch.Tensor) -> torch.Tensor:
    """Green-to-red ramp over 15 frames of age."""
    t = (age.to(torch.float32) / 15.0).clamp(0.0, 1.0)
    return torch.stack([255 * t, 255 * (1 - t), torch.zeros_like(t)], dim=-1)


def draw_trajectories(img, traj: torch.Tensor, traj_len: torch.Tensor,
                      alive: torch.Tensor, samples_per_seg: int = 8):
    """Render (K, L, 2) newest-first trajectory rings as polylines whose
    alpha fades with segment age; segment i joins traj[:, i] and
    traj[:, i+1], the first ``traj_len - 1`` segments of live tracks."""
    data, b = _as_data(img)
    h, w = data.shape[:2]
    dev = data.device
    k, length = traj.shape[:2]
    color = _age_color(traj_len)

    t = linspace01(samples_per_seg, dev)[None, None, :, None]
    p1 = traj[:, :-1, None, :]
    p2 = traj[:, 1:, None, :]
    pts = saturate_cast(torch.round(p1 * (1 - t) + p2 * t), torch.int32)
    seg_idx = torch.arange(length - 1, dtype=torch.int32, device=dev)
    seg_ok = (seg_idx[None, :] < (traj_len[:, None] - 1)) & alive[:, None]
    alpha = ((1.0 - seg_idx.to(torch.float32) / max(length - 1, 1))[None, :]
             * seg_ok.to(torch.float32))
    pts_f = pts.reshape(-1, 2) + b
    ok = seg_ok[:, :, None].expand(-1, -1, samples_per_seg).reshape(-1)
    a = alpha[:, :, None].expand(-1, -1, samples_per_seg).reshape(-1)
    col = color[:, None, None, :].expand(
        -1, length - 1, samples_per_seg, -1).reshape(-1, 3)

    inb = ((pts_f[:, 0] >= 0) & (pts_f[:, 0] < h)
           & (pts_f[:, 1] >= 0) & (pts_f[:, 1] < w) & ok)
    r = torch.where(inb, pts_f[:, 0], torch.full_like(pts_f[:, 0], h))
    c = torch.where(inb, pts_f[:, 1], torch.zeros_like(pts_f[:, 1]))
    old = data[r.clamp(0, h - 1).long(), c.long()].to(torch.float32)
    if old.dim() == 1:                     # grayscale target: the red channel
        blended = old * (1 - a) + col[:, 0] * a
    else:
        blended = old * (1 - a[:, None]) + col * a[:, None]
    return _wrap(img, set_pixels(data, r, c, _cast(blended, data.dtype)))
