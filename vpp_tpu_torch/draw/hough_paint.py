"""Image-space rendering of Hough line tracks (port of
``vpp_tpu.draw.hough_paint``).

* ``paint_hough_video``: a persistent RGBA paint buffer whose alpha decays
  each frame; each live track paints its current segment in an HSV colour
  coded by its (θ, ρ) trajectory direction, alpha scaled by its speed.
* ``draw_line_tracks``: every live track's current line in a stable slot
  colour, faded by frames without update, and a 3x3 marker at its centre.
* ``track_support_points``: for each track, the k strongest edge pixels
  whose gradient vote lands within its (θ, ρ) window: a (C, H·W) masked
  score and a per-track top-k, with ``lax.top_k``'s tie rule (of equal
  magnitudes the lower pixel index first; a binary image ties often).

Everything is batched over the track slots. Where the samples of two
tracks hit one pixel, the sample last in flat order (the higher track
slot, then the later sample) is written: ``set_pixels``, deterministic on
the card and on the CPU. The alpha channel takes the largest value, which
needs no rule.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from .._device import device_constant
from ..algorithms.hough import (_pixel_votes, default_rho_bins,
                                line_endpoints, top_k)
from ..core.image import Image2d, saturate_cast
from ..ops.color import hsv_to_rgb
from .draw import linspace01, set_pixels


def track_support_points(img: Image2d, theta_idx: torch.Tensor,
                         rho_idx: torch.Tensor, valid: torch.Tensor, *,
                         k: int = 64, t_theta: int = 255,
                         rho_bins: Optional[int] = None,
                         grad_threshold: float = 40.0,
                         radius_theta: float = 5.0,
                         radius_rho: float = 10.0
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per track, the ``k`` strongest edge pixels whose vote falls within
    (±radius_theta, ±radius_rho) bins of its (θ_idx, ρ_idx); θ distance
    is not circular. Returns (points (C, k, 2) int32 row/col, ok (C, k))."""
    h, w = img.shape
    if rho_bins is None:
        rho_bins = default_rho_bins(img.shape)
    th_n, rho_n, mag, edge = _pixel_votes(img, t_theta, rho_bins,
                                          grad_threshold)
    thf = th_n.reshape(-1)
    rhf = rho_n.reshape(-1)
    score = torch.where(edge, mag, torch.zeros_like(mag)).reshape(-1)
    ti = theta_idx.to(torch.float32)[:, None]
    ri = rho_idx.to(torch.float32)[:, None]
    m = (valid[:, None] & ((thf - ti).abs() <= radius_theta)
         & ((rhf - ri).abs() <= radius_rho))
    top, idx = top_k(torch.where(m, score, torch.zeros_like(score)), k)
    pts = torch.stack([idx // w, idx % w], dim=-1).to(torch.int32)
    return pts, top > 0


def _track_lines(state, acc_shape: Tuple[int, int],
                 img_shape: Tuple[int, int]):
    """(θ radians, ρ pixels) of each track slot."""
    t_theta, rho_bins = acc_shape
    h, w = img_shape
    diag = math.sqrt(h * h + w * w)
    theta = state.theta * math.pi / (t_theta - 1)
    rho = state.rho * 2 * diag / (rho_bins - 1) - diag
    return theta, rho


def _segment_samples(state, acc_shape, h: int, w: int, n: int, live):
    """The n rounded samples (C, n, 2) along each track's image-space
    segment, and the (r, c) to write: r = h for dead tracks and samples
    outside the image (dropped). A NaN sample (a track whose filter went
    NaN, as the reference's Kalman mode does) converts to 0, as in JAX."""
    theta, rho = _track_lines(state, acc_shape, (h, w))
    p1, p2 = line_endpoints(theta, rho, (h, w))          # (C, 2) each
    t = linspace01(n, p1.device)[None, :, None]
    pts = saturate_cast(torch.round(p1[:, None] * (1 - t) + p2[:, None] * t),
                        torch.int32)
    r, c = pts[..., 0], pts[..., 1]
    ok = live[:, None] & (r >= 0) & (r < h) & (c >= 0) & (c < w)
    return (p1, p2, torch.where(ok, r, torch.full_like(r, h)),
            torch.where(ok, c, torch.zeros_like(c)))


def paint_hough_video(paint: torch.Tensor, state,
                      acc_shape: Tuple[int, int], *, decay: float = 0.97,
                      n_samples: int = 128,
                      speed_scale: float = 10.0) -> torch.Tensor:
    """One frame of the trail-paint effect on an (H, W, 4) float32 RGBA
    buffer (alpha in [0, 255]): the buffer's alpha decays by ``decay``,
    then each live track with 2+ trajectory points paints ``n_samples``
    points of its segment, colour from its (θ, ρ) direction over up to 10
    steps, alpha min(1, speed / speed_scale) (kept where larger)."""
    h, w = paint.shape[:2]
    c = state.traj.shape[0]
    steps = (state.traj_n - 1).clamp(0, 10)
    older = state.traj[torch.arange(c, device=paint.device),
                       steps.clamp(0, state.traj.shape[1] - 1).long()]
    delta = state.traj[:, 0] - older                     # (C, 2)
    speed = torch.sqrt((delta * delta).sum(-1))
    hue = ((torch.atan2(delta[..., 0], delta[..., 1]) + math.pi)
           * (180.0 / math.pi))
    color = hsv_to_rgb(hue, 1.0, 1.0).to(torch.float32)  # (C, 3)
    alpha = torch.clamp(speed / speed_scale, max=1.0)
    live = (state.age > 0) & (state.traj_n >= 2)

    _, _, r, cc = _segment_samples(state, acc_shape, h, w, n_samples, live)
    col = color[:, None].expand(r.shape + (3,))
    a = alpha[:, None].expand(r.shape).reshape(-1)
    rgb = set_pixels(paint[..., :3], r, cc, col)
    flat = torch.where(r < h, r * w + cc, torch.full_like(r, h * w))
    av = torch.cat([paint[..., 3].reshape(-1) * decay,
                    paint.new_zeros(1)])
    av = av.scatter_reduce(0, flat.reshape(-1).long(), 255.0 * a, "amax",
                           include_self=True)[:h * w]
    return torch.cat([rgb, av.view(h, w, 1)], dim=-1)


# golden-angle hues of the 32 slot colours
_PALETTE_HUES = [i * 137.5 % 360.0 for i in range(32)]


def draw_line_tracks(img: torch.Tensor, state, acc_shape: Tuple[int, int],
                     *, n_samples: int = 256, max_fwu: int = 5
                     ) -> torch.Tensor:
    """Render live tracks onto an (H, W, 3) uint8 frame: each track's
    current line in its slot colour, alpha faded by frames without update,
    then a 3x3 marker at the segment centre."""
    h, w = img.shape[:2]
    dev = img.device
    c = state.age.shape[0]
    hues = device_constant(_PALETTE_HUES, torch.float32, dev)
    hues = hues[torch.arange(c, device=dev) % 32]
    color = hsv_to_rgb(hues, 1.0, 1.0).to(torch.float32)
    fade = (1.0 - state.fwu.to(torch.float32) / (max_fwu + 1)).clamp(0.2, 1.0)
    live = state.age > 0

    p1, p2, r, cc = _segment_samples(state, acc_shape, h, w, n_samples, live)
    a = fade[:, None].expand(r.shape).reshape(-1, 1)
    col = color[:, None].expand(r.shape + (3,)).reshape(-1, 3)
    base = img.to(torch.float32)
    old = base[r.clamp(0, h - 1).reshape(-1).long(),
               cc.clamp(0, w - 1).reshape(-1).long()]
    out = set_pixels(base, r, cc, old * (1 - a) + col * a)

    # marker: 3x3 block at the segment centre
    centre = saturate_cast(torch.round((p1 + p2) / 2), torch.int32)
    o = torch.arange(-1, 2, dtype=torch.int32, device=dev)
    offs = torch.stack(torch.meshgrid(o, o, indexing="ij"),
                       dim=-1).reshape(-1, 2)
    mpts = centre[:, None] + offs[None]                  # (C, 9, 2)
    mr, mc = mpts[..., 0], mpts[..., 1]
    mok = live[:, None] & (mr >= 0) & (mr < h) & (mc >= 0) & (mc < w)
    mr = torch.where(mok, mr, torch.full_like(mr, h))
    mcol = color[:, None].expand(c, 9, 3)
    out = set_pixels(out, mr, mc, mcol)
    return saturate_cast(out, torch.uint8)
