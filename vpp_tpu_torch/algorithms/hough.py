"""Dense one-to-one Hough line detection (port of the first stage of
``vpp_tpu.algorithms.hough``).

One pass over the image computes the Sobel gradient and lets each edge
pixel cast one vote at the (ρ, θ) implied by its gradient direction,
bilinearly spread over the 4 neighbouring accumulator cells; θ is
discretised to ``t_theta`` bins over [0, π) and ρ to the image diagonal.
Peaks: ``hough_peaks`` takes m greedy peaks with (θ, ρ) exclusion radii;
``hough_peaks_clustered`` keeps the local maxima of the θ-wrapped
accumulator (one ``max_pool2d``) and takes the k strongest;
``hough_adaptive_threshold`` moves the clustering threshold on the device;
``hough_top_k`` takes the k largest cells. Both top-k follow
``lax.top_k``'s tie rule, lower flat index first (``top_k``), so the
equal votes of equal-length lines come out in the JAX package's order.

Every accumulator is kernel K7 (``hough_cuda.hough_acc``), one launch a
call: ``hough_accumulator``, ``hough_accumulator_mxu`` (the JAX package's
matrix-unit formulation of the same votes; on the card the same K7 call),
``hough_sparse_revote`` (magnitude votes masked to a band around known
lines) and ``hough_lines``. No step reads the host.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

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


def default_rho_bins(shape: Tuple[int, int]) -> int:
    """ρ bins of an h x w image: the diagonal, rounded up."""
    h, w = shape
    return int(math.ceil(math.sqrt(h * h + w * w)))


def _pixel_votes(img: Image2d, t_theta: int, rho_bins: int,
                 grad_threshold: float):
    """Per pixel (θ_n, ρ_n, |grad|, is_edge): the continuous accumulator
    coordinates of its vote, before any clipping."""
    h, w = img.shape
    gy, gx = sobel_gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    edge = mag > grad_threshold
    theta = torch.atan2(gy, gx)
    theta = torch.where(theta < 0, theta + math.pi, theta)
    dev = theta.device
    rr = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    cc = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    rho = cc * torch.cos(theta) + rr * torch.sin(theta)
    diag = math.sqrt(h * h + w * w)
    rho_n = (rho + diag) * (rho_bins - 1) / (2 * diag)
    th_n = theta * (t_theta - 1) / math.pi
    return th_n, rho_n, mag, edge


def _vote_bins(img: Image2d, t_theta: int, rho_bins: Optional[int],
               grad_threshold: float, vote_weight: str,
               pixel_mask: Optional[torch.Tensor]):
    """Per pixel the 2x2 bilinear target bins and weights:
    (t0i, r0i, ft, fr, wgt, rho_bins)."""
    if rho_bins is None:
        rho_bins = default_rho_bins(img.shape)
    th_n, rho_n, mag, edge = _pixel_votes(img, t_theta, rho_bins,
                                          grad_threshold)
    if pixel_mask is not None:
        edge = edge & (torch.as_tensor(pixel_mask, device=edge.device) != 0)
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


def hough_accumulator_mxu(img: Image2d, *, t_theta: int = 255,
                          rho_bins: Optional[int] = None,
                          grad_threshold: float = 40.0,
                          vote_weight: str = "binary",
                          pixel_mask: Optional[torch.Tensor] = None,
                          chunk: int = 4096) -> torch.Tensor:
    """``hough_accumulator`` under the JAX package's name for its
    matrix-unit formulation: the same votes, one K7 launch on the card.

    ``chunk`` was the TPU's tiling of the pixels into one-hot matmuls (a
    positive int); K7 votes every pixel in one launch, so it does not
    change the result, which is ``hough_accumulator``'s bit for bit (the
    JAX version rounds the bilinear weights to bf16; K7 keeps float32)."""
    if isinstance(chunk, bool) or not isinstance(chunk, int) or chunk < 1:
        raise ValueError(f"hough_accumulator_mxu: chunk must be a positive "
                         f"int, got {chunk!r}")
    return hough_accumulator(img, t_theta=t_theta, rho_bins=rho_bins,
                             grad_threshold=grad_threshold,
                             vote_weight=vote_weight, pixel_mask=pixel_mask)


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


def top_k(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest entries along the last dim, largest first, with
    ``lax.top_k``'s tie rule: of equal values the lower index comes first
    (``torch.topk`` leaves that order open). Each float32 is mapped to an
    order-preserving int32 and joined with its reverse index into one
    distinct int64 key, so ``torch.topk`` has no tie to break. Returns
    (values, int64 indices)."""
    n = x.shape[-1]
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    key32 = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    rev = (n - 1) - torch.arange(n, dtype=torch.int64, device=x.device)
    _, idx = torch.topk(key32 * (1 << 32) + rev, k, dim=-1, sorted=True)
    return x.gather(-1, idx), idx


def _fold_seam(acc: torch.Tensor) -> torch.Tensor:
    """Merge the duplicate θ seam rows: rows 0 and t_theta-1 are the same
    line family (θ = 0 and π) with ρ mirrored; both get the full mass."""
    seam = acc[0] + acc[-1].flip(0)
    return torch.cat([seam[None], acc[1:-1], seam.flip(0)[None]])


def _maxima(acc: torch.Tensor, nms_theta: int,
            nms_rho: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(folded accumulator, cells >= every cell of their (2·nms_theta+1,
    2·nms_rho+1) window), the threshold left out. θ wraps with period
    t_theta-1 (rows 0 and t_theta-1 are one family), and the wrapped
    slabs are reversed along ρ: θ ± π names the same line with ρ
    mirrored. ρ is padded with -1e30 by hand, then one ``max_pool2d``
    with no padding. The last row (a mirrored duplicate of row 0 after
    the fold) is never a maximum: seam peaks report at row 0."""
    accf = _fold_seam(acc)
    a = torch.cat([accf[-nms_theta - 1:-1].flip(1), accf,
                   accf[1:nms_theta + 1].flip(1)])
    side = a.new_full((a.shape[0], nms_rho), _NEG)
    a = torch.cat([side, a, side], dim=1)
    pooled = F.max_pool2d(a[None, None],
                          (2 * nms_theta + 1, 2 * nms_rho + 1),
                          stride=1)[0, 0]
    is_max = accf >= pooled
    return accf, torch.cat([is_max[:-1], torch.zeros_like(is_max[-1:])])


def _local_maxima_mask(acc: torch.Tensor, nms_theta: int, nms_rho: int,
                       threshold) -> torch.Tensor:
    """(t_theta, rho_bins) bool: the cell is >= everything in its
    (2·nms_theta+1, 2·nms_rho+1) neighbourhood (θ wrapping) and above
    ``threshold`` (a float or a 0-d tensor)."""
    accf, is_max = _maxima(acc, nms_theta, nms_rho)
    return is_max & (accf > threshold)


def hough_peaks_clustered(acc: torch.Tensor, k: int, *, nms_theta: int = 15,
                          nms_rho: int = 12, threshold=50.0) -> HoughLines:
    """The k strongest local maxima above ``threshold`` (a float or a 0-d
    tensor, e.g. ``hough_adaptive_threshold``'s), votes descending, ties
    in flat-index order. A θ=0/π seam line reports once, at row 0, with
    its full folded mass; slots past the maxima hold vote 0 and the
    lowest-index cells that are not maxima, as in JAX."""
    rho_bins = acc.shape[1]
    accf, is_max = _maxima(acc, nms_theta, nms_rho)
    vals = torch.where(is_max & (accf > threshold), accf,
                       torch.zeros_like(accf))
    v, flat = top_k(vals.reshape(-1), k)
    return HoughLines(theta_idx=(flat // rho_bins).to(torch.int32),
                      rho_idx=(flat % rho_bins).to(torch.int32),
                      votes=v, valid=v > 0)


def _near_lines(shape: Tuple[int, int], theta: torch.Tensor,
                rho: torch.Tensor, valid: torch.Tensor,
                band: float) -> torch.Tensor:
    """(H, W) bool: pixels within ``band`` px of a valid (θ, ρ) line,
    distance |c·cosθ + r·sinθ - ρ|."""
    h, w = shape
    dev = theta.device
    rr = torch.arange(h, dtype=torch.float32, device=dev)[:, None, None]
    cc = torch.arange(w, dtype=torch.float32, device=dev)[None, :, None]
    d = (cc * torch.cos(theta) + rr * torch.sin(theta) - rho).abs()
    return ((d <= band) & valid).any(dim=-1)


def hough_sparse_revote(img: Image2d, theta: torch.Tensor, rho: torch.Tensor,
                        valid: torch.Tensor, *, band: float = 4.0,
                        t_theta: int = 255, rho_bins: Optional[int] = None,
                        grad_threshold: float = 40.0,
                        vote_weight: str = "magnitude") -> torch.Tensor:
    """Re-vote only the pixels within ``band`` px of the given (M,) lines
    (image-space θ, ρ as ``accumulator_to_lines`` gives them; ``valid``
    masks live ones): the (H, W, M) band test, then one K7 launch with the
    mask. K7's fixed-point sums hold magnitude votes below 1443 exactly
    enough (``hough_acc.cu``)."""
    near = _near_lines(img.shape, theta, rho, valid, band)
    return hough_accumulator(img, t_theta=t_theta, rho_bins=rho_bins,
                             grad_threshold=grad_threshold,
                             vote_weight=vote_weight, pixel_mask=near)


def hough_adaptive_threshold(acc: torch.Tensor, *, target_lo: int = 50,
                             target_hi: int = 100, th0: float = 50.0,
                             max_calls: int = 5, nms_theta: int = 15,
                             nms_rho: int = 12
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Adapt the clustering threshold until the local-maxima count lies in
    [target_lo, target_hi]: up to ``max_calls`` rounds, each scaling the
    threshold by its call count. Every round runs on the device (no host
    read); the window maxima are pooled once, since the threshold does not
    move them. Returns (threshold float32, count int32), 0-d tensors on
    ``acc``'s device."""
    accf, is_max = _maxima(acc, nms_theta, nms_rho)

    def count_at(th):
        return (is_max & (accf > th)).sum(dtype=torch.int32)

    th = torch.full((), th0, dtype=torch.float32, device=acc.device)
    done = torch.zeros((), dtype=torch.bool, device=acc.device)
    for i in range(max_calls):
        n = count_at(th)
        in_band = (n >= target_lo) & (n <= target_hi)
        # a tensor divisor: CUDA divides by a Python scalar through its
        # reciprocal, which rounds otherwise than the CPU and JAX
        scale = th.new_full((), float(i + 2))
        th_new = torch.where(n > target_hi, th * scale,
                             torch.where(n > 0, th / scale, th))
        th = torch.where(done | in_band, th, th_new)
        done = done | in_band
    return th, count_at(th)


def hough_top_k(acc: torch.Tensor, k: int) -> HoughLines:
    """The k largest cells, ties in flat-index order."""
    rho_bins = acc.shape[1]
    v, flat = top_k(acc.reshape(-1), k)
    return HoughLines(theta_idx=(flat // rho_bins).to(torch.int32),
                      rho_idx=(flat % rho_bins).to(torch.int32),
                      votes=v, valid=v > 0)


def accumulator_to_lines(lines: HoughLines, acc_shape: Tuple[int, int],
                         img_shape: Tuple[int, int]
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(θ_idx, ρ_idx) → (θ radians, ρ pixels) in image coordinates."""
    t_theta, rho_bins = acc_shape
    h, w = img_shape
    diag = math.sqrt(h * h + w * w)
    theta = lines.theta_idx.to(torch.float32) * math.pi / (t_theta - 1)
    rho = (lines.rho_idx.to(torch.float32) * 2 * diag / (rho_bins - 1)
           - diag)
    return theta, rho


def line_endpoints(theta: torch.Tensor, rho: torch.Tensor,
                   img_shape: Tuple[int, int],
                   length: Optional[float] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Endpoints ((N, 2) row/col each) of the centred segment of
    ``length`` (default: the image diagonal) on each (θ, ρ) line."""
    h, w = img_shape
    if length is None:
        length = math.sqrt(h * h + w * w)
    ct, st = torch.cos(theta), torch.sin(theta)
    x0, y0 = rho * ct, rho * st
    half = length / 2
    p1 = torch.stack([y0 - half * ct, x0 + half * st], dim=-1)
    p2 = torch.stack([y0 + half * ct, x0 - half * st], dim=-1)
    return p1, p2


def hough_lines(img: Image2d, m: int = 10, *, t_theta: int = 255,
                grad_threshold: float = 40.0, exclusion_theta: int = 5,
                exclusion_rho: int = 10, acc_threshold: float = 0.0):
    """One-shot line detection: the accumulator (one K7 launch), m peaks,
    (θ, ρ). Returns (HoughLines, theta, rho, accumulator)."""
    acc = hough_accumulator(img, t_theta=t_theta,
                            grad_threshold=grad_threshold)
    peaks = hough_peaks(acc, m, exclusion_theta=exclusion_theta,
                        exclusion_rho=exclusion_rho,
                        acc_threshold=acc_threshold)
    theta, rho = accumulator_to_lines(peaks, acc.shape, img.shape)
    return peaks, theta, rho, acc
