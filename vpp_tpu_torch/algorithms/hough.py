"""Dense one-to-one Hough line detection (port of the first stage of
``vpp_tpu.algorithms.hough``).

One pass over the image computes the Sobel gradient and lets each edge
pixel cast one vote at the (ρ, θ) implied by its gradient direction,
bilinearly spread over the 4 neighbouring accumulator cells; θ is
discretised to ``t_theta`` bins over [0, π) and ρ to the image diagonal.
``hough_peaks`` extracts m peaks with (θ, ρ) exclusion radii.

The accumulator is kernel K7 (``hough_cuda.hough_acc``). The NMS and seam
fold, the sparse revote, the adaptive threshold, line endpoints and
``hough_accumulator_mxu`` are not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from ..core.image import Image2d
from .hough_cuda import hough_acc

_NEG = -1e30


def sobel_gradients(img: Image2d) -> Tuple[torch.Tensor, torch.Tensor]:
    """(gy, gx) 3x3 Sobel over the interior. Requires border >= 1."""
    if img.border < 1:
        raise ValueError("sobel needs border >= 1")
    d = img.data.to(torch.float32)
    h, w = img.shape
    b = img.border

    def sl(dr, dc):
        return d[b + dr:b + dr + h, b + dc:b + dc + w]

    gx = (sl(-1, 1) + 2 * sl(0, 1) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(0, -1) - sl(1, -1))
    gy = (sl(1, -1) + 2 * sl(1, 0) + sl(1, 1)
          - sl(-1, -1) - 2 * sl(-1, 0) - sl(-1, 1))
    return gy, gx


def _vote_bins(img: Image2d, t_theta: int, rho_bins: Optional[int],
               grad_threshold: float, vote_weight: str,
               pixel_mask: Optional[torch.Tensor]):
    """Per pixel the 2x2 bilinear target bins and weights:
    (t0i, r0i, ft, fr, wgt, rho_bins)."""
    h, w = img.shape
    if rho_bins is None:
        rho_bins = int(math.ceil(math.sqrt(h * h + w * w)))
    gy, gx = sobel_gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    edge = mag > grad_threshold
    if pixel_mask is not None:
        edge = edge & (torch.as_tensor(pixel_mask, device=edge.device) != 0)
    theta = torch.atan2(gy, gx)
    theta = torch.where(theta < 0, theta + math.pi, theta)
    dev = theta.device
    rr = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cc = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    rho = cc * torch.cos(theta) + rr * torch.sin(theta)
    diag = math.sqrt(h * h + w * w)
    rho_n = (rho + diag) * (rho_bins - 1) / (2 * diag)
    th_n = theta * (t_theta - 1) / math.pi
    t0 = torch.floor(th_n)
    r0 = torch.floor(rho_n)
    ft = th_n - t0
    fr = rho_n - r0
    t0i = t0.to(torch.int32).clamp(0, t_theta - 1)
    r0i = r0.to(torch.int32).clamp(0, rho_bins - 1)
    wgt = edge.to(torch.float32)
    if vote_weight == "magnitude":
        wgt = mag * wgt
    return t0i, r0i, ft, fr, wgt, rho_bins


def hough_accumulator(img: Image2d, *, t_theta: int = 255,
                      rho_bins: Optional[int] = None,
                      grad_threshold: float = 40.0,
                      vote_weight: str = "binary",
                      pixel_mask: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """(t_theta, rho_bins) vote accumulator: one bilinear vote per edge
    pixel at its gradient-normal direction. ``vote_weight``: "binary" or
    "magnitude"; ``pixel_mask`` (H, W) restricts voting."""
    t0i, r0i, ft, fr, wgt, rho_bins = _vote_bins(
        img, t_theta, rho_bins, grad_threshold, vote_weight, pixel_mask)
    th_n = (t0i.to(torch.float32) + ft).reshape(-1)
    rho_n = (r0i.to(torch.float32) + fr).reshape(-1)
    return hough_acc(th_n, rho_n, wgt.reshape(-1).contiguous(), t_theta,
                     rho_bins)


class HoughLines(NamedTuple):
    theta_idx: torch.Tensor   # (m,) int32 accumulator row
    rho_idx: torch.Tensor     # (m,) int32 accumulator col
    votes: torch.Tensor       # (m,) float32
    valid: torch.Tensor       # (m,) bool — vote above threshold


def hough_peaks(acc: torch.Tensor, m: int, *, exclusion_theta: int = 5,
                exclusion_rho: int = 10,
                acc_threshold: float = 0.0) -> HoughLines:
    """m-first peaks with (θ, ρ) exclusion radii; the θ exclusion wraps.
    Each peak is the first (row-major) maximum of what remains."""
    t_theta, rho_bins = acc.shape
    dev = acc.device
    tt = torch.arange(t_theta, device=dev)[:, None]
    rr = torch.arange(rho_bins, device=dev)[None, :]
    a = acc.to(torch.float32)
    neg = torch.full_like(a, _NEG)
    flats, votes = [], []
    for _ in range(m):
        # a 1-element index keeps every step on the device (a 0-d tensor
        # index would be read back to the host)
        flat = torch.argmax(a).view(1)
        pt, pr = flat // rho_bins, flat % rho_bins
        flats.append(flat)
        votes.append(a.reshape(-1).gather(0, flat))
        dt = (tt - pt).abs()
        dt = torch.minimum(dt, t_theta - dt)
        suppress = (dt <= exclusion_theta) & ((rr - pr).abs() <= exclusion_rho)
        a = torch.where(suppress, neg, a)
    flat = torch.cat(flats)
    v = torch.cat(votes)
    ti = (flat // rho_bins).to(torch.int32)
    ri = (flat % rho_bins).to(torch.int32)
    return HoughLines(theta_idx=ti, rho_idx=ri, votes=v,
                      valid=v > acc_threshold)
