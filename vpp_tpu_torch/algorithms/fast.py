"""FAST9 corner detection (port of ``vpp_tpu.algorithms.fast``).

* 16-point Bresenham circle of radius 3; a keypoint iff 9 circularly
  contiguous points are all brighter than v+th or all darker than v-th.
* score = max(sum of diffs beyond +th, sum of |diffs| beyond -th) over the
  circle; the score *image* stores score/16 as uint8.
* selection: 3x3 strict local maxima, per-block argmax, top-K into static
  (K, 2) arrays with a validity mask.

Pixel values are truncated to int32 before differencing, as the JAX package
does. Kernel K2 (``kernels/csrc/fast9.cu``) has three entry points, each
launching once for a CUDA image and taking its plain version for a CPU
one: ``fast9_cuda`` (the full score map and flag; plain ``fast9_plain``),
``fast9_score_image`` (the bordered uint8 detection image;
``fast9_score_image_plain``) and ``fast9_cull_scores`` (the score at
rounded positions, the tracker's cull; ``fast9_cull_scores_plain``). The
blockwise selection is kernel K3 (``kernels/csrc/block_topk.cu``),
``_blockwise_keypoints``, with its plain version
``_blockwise_keypoints_plain``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.image import Image2d, from_array, pad2d
from ..kernels import LAUNCHES, require_cuda, stream_handle

CIRCLE = [(-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3),
          (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3),
          (-1, -3), (-2, -2)]


def _circle_diffs(img: Image2d) -> torch.Tensor:
    """(16, H, W) int32 diffs circle_point - center."""
    v = img.interior.to(torch.int32)
    return torch.stack([img.shifted(dr, dc).to(torch.int32) - v
                        for dr, dc in CIRCLE], dim=0)


def _has_9_contiguous(flags: torch.Tensor) -> torch.Tensor:
    """flags: (16, H, W) bool → (H, W) bool: any 9 circularly-contiguous
    set. The doubled-ring trick in int64, whose bits 16..31 equal those of
    the 32-bit original (left shifts only move low bits up)."""
    weights = torch.tensor([1 << k for k in range(16)], dtype=torch.int64,
                           device=flags.device)
    code = (flags.to(torch.int64) * weights[:, None, None]).sum(0)
    c = code | (code << 16)
    r2 = c & (c << 1)
    r4 = r2 & (r2 << 2)
    r8 = r4 & (r4 << 4)
    r9 = r8 & (c << 8)
    return (r9 & 0xFFFF0000) != 0


def fast9_plain(img: Image2d, th: int, detect: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K2: (H, W) int32 score and, with
    ``detect``, the (H, W) uint8 keypoint flag."""
    d = _circle_diffs(img)
    zero = torch.zeros_like(d)
    sum_sup = torch.where(d > th, d, zero).sum(0, dtype=torch.int32)
    sum_inf = torch.where(d < -th, -d, zero).sum(0, dtype=torch.int32)
    score = torch.maximum(sum_sup, sum_inf)
    if not detect:
        return score, None
    kp = _has_9_contiguous(d > th) | _has_9_contiguous(d < -th)
    return score, kp.to(torch.uint8)


def _k2_frame(img: Image2d, name: str) -> torch.Tensor:
    """K2's operand: the bordered frame as contiguous float32 on the card
    (integer pixel types up to 24 bits convert exactly)."""
    data = img.data
    if data.dim() != 2:
        raise ValueError(f"{name}: expected a 2-D image, got {data.shape}")
    if data.dtype != torch.float32:
        data = data.to(torch.float32)
    data = data.contiguous()
    require_cuda(name, data, dtypes=(torch.float32,))
    return data


def _need_border_3(img: Image2d) -> None:
    if img.border < 3:
        raise ValueError("FAST needs a border of at least 3px")


def fast9_cuda(img: Image2d, th: int, detect: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K2's full map: score (and flag) in one launch on a CUDA image; the
    plain version for a CPU image. Needs border >= 3."""
    _need_border_3(img)
    if img.data.device.type == "cpu":
        return fast9_plain(img, th, detect)
    data = _k2_frame(img, "fast9")
    from ..kernels import _build
    h, w = img.shape
    score = torch.empty((h, w), dtype=torch.int32, device=data.device)
    flag = (torch.empty((h, w), dtype=torch.uint8, device=data.device)
            if detect else None)
    code = _build.load().vpp_fast9(
        data.data_ptr(), data.shape[1], img.border, h, w, int(th),
        score.data_ptr(), flag.data_ptr() if detect else None,
        stream_handle(data))
    LAUNCHES["fast9"] += 1
    _build.check(code, "fast9")
    return score, flag


def fast9_detect(img: Image2d, th: int) -> torch.Tensor:
    """(H, W) bool keypoint mask. Needs border >= 3."""
    return fast9_cuda(img, th, detect=True)[1] != 0


def fast9_score(img: Image2d, th: int) -> torch.Tensor:
    """(H, W) int32 FAST score at every pixel."""
    return fast9_cuda(img, th, detect=False)[0]


def fast9_score_at(img: Image2d, positions: torch.Tensor,
                   th: int) -> torch.Tensor:
    """(K,) FAST score sampled at integer ``positions`` (row, col, interior
    coords); flat indices are clipped to the buffer."""
    _need_border_3(img)
    b = img.border
    wb = img.data.shape[1]
    p = positions.to(torch.int64) + b
    offs = torch.tensor([(0, 0)] + CIRCLE, dtype=torch.int64,
                        device=p.device)                          # (17, 2)
    flat = ((p[:, None, 0] + offs[None, :, 0]) * wb
            + (p[:, None, 1] + offs[None, :, 1]))                 # (K, 17)
    flat = flat.clamp(0, img.data.numel() - 1)
    smp = img.data.reshape(-1)[flat].to(torch.int32)
    d = smp[:, 1:] - smp[:, :1]
    zero = torch.zeros_like(d)
    s_sup = torch.where(d > th, d, zero).sum(1, dtype=torch.int32)
    s_inf = torch.where(d < -th, -d, zero).sum(1, dtype=torch.int32)
    return torch.maximum(s_sup, s_inf)


def fast9_cull_scores_plain(img: Image2d, positions: torch.Tensor,
                            th: int) -> torch.Tensor:
    """Plain version of K2's cull: the JAX tracker's expression
    ``fast9_score(img, th)[clip(round(positions))]`` written out, the full
    map and a gather."""
    h, w = img.shape
    score, _ = fast9_plain(img, th, detect=False)
    p = torch.round(positions.to(torch.float32)).to(torch.int32)
    return score[p[:, 0].clamp(0, h - 1).long(),
                 p[:, 1].clamp(0, w - 1).long()]


def fast9_cull_scores(img: Image2d, positions: torch.Tensor,
                      th: int) -> torch.Tensor:
    """K2's cull: the (K,) int32 FAST score at (K, 2) float ``positions``
    (row, col, interior coords) rounded half to even and clamped into the
    domain, in one launch on a CUDA image (one thread a slot, 17 samples);
    the plain version for a CPU image. Equal to the full map read at those
    pixels for every position within the int32 range. Needs border >= 3."""
    _need_border_3(img)
    if img.data.device.type == "cpu":
        return fast9_cull_scores_plain(img, positions, th)
    if positions.dim() != 2 or positions.shape[1] != 2:
        raise ValueError(f"fast9_cull_scores: positions must be (K, 2), got "
                         f"{tuple(positions.shape)}")
    data = _k2_frame(img, "fast9_cull_scores")
    pos = positions
    if pos.dtype != torch.float32:
        pos = pos.to(torch.float32)
    pos = pos.contiguous()
    require_cuda("fast9_cull_scores", data, pos,
                 dtypes=(torch.float32, torch.float32))
    from ..kernels import _build
    h, w = img.shape
    k = pos.shape[0]
    out = torch.empty((k,), dtype=torch.int32, device=data.device)
    if k == 0:
        return out
    code = _build.load().vpp_fast9_cull(
        data.data_ptr(), data.shape[1], img.border, h, w, int(th),
        pos.data_ptr(), k, out.data_ptr(), stream_handle(data))
    LAUNCHES["fast9"] += 1
    _build.check(code, "fast9_cull")
    return out


def fast9_score_image_plain(img: Image2d, th: int,
                            mask: Optional[torch.Tensor] = None) -> Image2d:
    """Plain version of K2's score image: the full map and flag, the mask,
    score // 16 clipped to uint8, and the zero border, as the JAX package
    composes them."""
    score, flag = fast9_plain(img, th, detect=True)
    kp = flag != 0
    if mask is not None:
        kp = kp & (torch.as_tensor(mask, device=kp.device) != 0)
    s = torch.where(kp, torch.div(score, 16, rounding_mode="floor"),
                    torch.zeros_like(score))
    return from_array(s.clamp(0, 255).to(torch.uint8), border=1)


def fast9_score_image(img: Image2d, th: int,
                      mask: Optional[torch.Tensor] = None) -> Image2d:
    """uint8 score/16 image (border 1), non-zero only at detected
    keypoints; an optional (H, W) ``mask`` zeroes masked-out pixels. On a
    CUDA image, one K2 launch writes the whole bordered image (a uint8 or
    bool mask is read as bytes); the plain version on a CPU image."""
    _need_border_3(img)
    if img.data.device.type == "cpu":
        return fast9_score_image_plain(img, th, mask)
    data = _k2_frame(img, "fast9_score_image")
    h, w = img.shape
    dev = data.device
    operands, dtypes = [data], [torch.float32]
    if mask is not None:
        mask = torch.as_tensor(mask, device=dev)
        if mask.dtype not in (torch.uint8, torch.bool):
            mask = mask != 0
        mask = mask.contiguous()
        if tuple(mask.shape) != (h, w):
            raise ValueError(f"fast9_score_image: mask must be {(h, w)}, got "
                             f"{tuple(mask.shape)}")
        operands.append(mask)
        dtypes.append(mask.dtype)
    require_cuda("fast9_score_image", *operands, dtypes=dtypes)
    from ..kernels import _build
    out = torch.empty((h + 2, w + 2), dtype=torch.uint8, device=dev)
    code = _build.load().vpp_fast9_image(
        data.data_ptr(), data.shape[1], img.border, h, w, int(th),
        mask.data_ptr() if mask is not None else None, out.data_ptr(),
        stream_handle(data))
    LAUNCHES["fast9"] += 1
    _build.check(code, "fast9_image")
    return Image2d(data=out, border=1)


def local_maxima_filter(scores: Image2d) -> Image2d:
    """Zero out non-(3x3 strict) maxima."""
    if scores.border < 1:
        raise ValueError("local_maxima_filter needs border >= 1")
    a = scores.interior
    is_max = torch.ones(a.shape, dtype=torch.bool, device=a.device)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            is_max = is_max & (a > scores.shifted(dr, dc))
    return from_array(torch.where(is_max, a, torch.zeros_like(a)),
                      border=scores.border)


def _block_argmax(scores: Image2d, bs: int):
    """Per-block first-max (row-major within the block) over the interior
    padded with -1: returns (idx, vmax, nbr, nbc)."""
    a = scores.interior.to(torch.int32)
    h, w = a.shape
    nbr, nbc = -(-h // bs), -(-w // bs)
    padded = pad2d(a, 0, nbr * bs - h, 0, nbc * bs - w, "constant", -1)
    flat = padded.reshape(nbr, bs, nbc, bs).permute(0, 2, 1, 3).reshape(
        nbr, nbc, bs * bs)
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return flat.argmax(dim=-1), flat.amax(dim=-1), nbr, nbc


def blockwise_maxima_filter(scores: Image2d, block_size: int) -> Image2d:
    """Keep only the per-block argmax of the score image, zero elsewhere;
    ties break to the first (row-major) position."""
    h, w = scores.shape
    bs = block_size
    idx, vmax, nbr, nbc = _block_argmax(scores, bs)
    keep = torch.zeros((nbr, nbc, bs * bs), dtype=torch.int32,
                       device=idx.device)
    keep.scatter_(2, idx[..., None], vmax.clamp(min=0)[..., None])
    out = keep.reshape(nbr, nbc, bs, bs).permute(0, 2, 1, 3).reshape(
        nbr * bs, nbc * bs)[:h, :w]
    return from_array(out.to(scores.dtype), border=scores.border,
                      border_mode="zero")


def select_keypoints(scores: Image2d, k: int
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-K extraction of non-zero score pixels: (positions (K, 2) int32,
    score (K,) int32, valid (K,) bool). Keys are biased by reverse index so
    equal scores extract in row-major order; invalid slots share key -1
    and their positions are unspecified."""
    a = scores.interior.to(torch.int32)
    h, w = a.shape
    n = h * w
    flat = a.reshape(-1)
    key = flat * n + (n - 1 - torch.arange(n, dtype=torch.int32,
                                           device=a.device))
    topv, topi = torch.topk(torch.where(flat > 0, key,
                                        torch.full_like(key, -1)),
                            k, sorted=True)
    valid = topv >= 0
    pos = torch.stack([topi // w, topi % w], dim=-1).to(torch.int32)
    score = torch.where(valid, flat[topi], torch.zeros_like(topv))
    return pos, score, valid


def _blockwise_keypoints_plain(scores: Image2d, block_size: int, k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain version of K3: per-block argmax, then the top k of the block
    winners. Every key is distinct: ``score*nb + (nb-1-i)`` where the score
    is positive (equal scores extract block-row-major, as in JAX) and
    ``-1-i`` elsewhere (the invalid entries in ascending block order, as
    ``lax.top_k`` orders its tied -1 keys), so every output is determined."""
    bs = block_size
    idx, vmax, nbr, nbc = _block_argmax(scores, bs)
    dev = idx.device
    pos_r = torch.arange(nbr, device=dev)[:, None] * bs + idx // bs
    pos_c = torch.arange(nbc, device=dev)[None, :] * bs + idx % bs
    cand_score = vmax.clamp(min=0).reshape(-1)
    cand_pos = torch.stack([pos_r, pos_c], dim=-1).reshape(-1, 2)
    nb = cand_score.shape[0]
    ar = torch.arange(nb, dtype=torch.int32, device=dev)
    key = torch.where(cand_score > 0, cand_score * nb + (nb - 1 - ar),
                      -1 - ar)
    kk = min(k, nb)
    topv, topi = torch.topk(key, kk, sorted=True)
    valid = topv >= 0
    pos = cand_pos[topi].to(torch.int32)
    score = torch.where(valid, cand_score[topi], torch.zeros_like(topv))
    if kk < k:
        pad = k - kk
        pos = torch.cat([pos, torch.zeros((pad, 2), dtype=torch.int32,
                                          device=dev)])
        score = torch.cat([score, torch.zeros((pad,), dtype=score.dtype,
                                              device=dev)])
        valid = torch.cat([valid, torch.zeros((pad,), dtype=torch.bool,
                                              device=dev)])
    return pos, score, valid


# the JAX key score*nb + (nb-1-i) of a score up to 255 fits int32
BLOCK_TOPK_MAX_BLOCKS = 2 ** 31 // 256


def _blockwise_keypoints(scores: Image2d, block_size: int, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 (``kernels/csrc/block_topk.cu``): per-block argmax + top-K over
    the block winners on a CUDA score image, one cooperative launch (a
    stable counting sort over the 256 scores); the plain version on a CPU
    one. Returns (pos (k, 2) int32, score (k,) int32, valid (k,) bool),
    bit-equal to the plain version. Scores must lie in 0..255 (the uint8
    score image; an int32 image with a larger block maximum makes the
    kernel trap, a CUDA error at the next synchronisation)."""
    data = scores.data
    if data.device.type == "cpu":
        return _blockwise_keypoints_plain(scores, block_size, k)
    h, w = scores.shape
    bs = block_size
    if data.dim() != 2 or bs < 1 or k < 1 or h < 1 or w < 1:
        raise ValueError(f"block_topk: needs a 2-D score image, block size "
                         f">= 1 and k >= 1 (got {tuple(data.shape)}, {bs}, "
                         f"{k})")
    nb = -(-h // bs) * -(-w // bs)
    if nb > BLOCK_TOPK_MAX_BLOCKS:
        raise ValueError(f"block_topk: {nb} blocks overflow the int32 key "
                         f"(at most {BLOCK_TOPK_MAX_BLOCKS})")
    if data.dtype not in (torch.uint8, torch.int32):
        data = data.to(torch.int32)
    data = data.contiguous()
    require_cuda("block_topk", data, dtypes=(data.dtype,))
    from ..kernels import _build
    lib = _build.load()
    dev = data.device
    # the winners' scores and indices, and a (CTAs, 256) histogram table
    # for at most one CTA per 64 blocks
    scratch = torch.empty((2 * nb + 256 * -(-nb // 64),), dtype=torch.int32,
                          device=dev)
    pos = torch.empty((k, 2), dtype=torch.int32, device=dev)
    score = torch.empty((k,), dtype=torch.int32, device=dev)
    valid = torch.empty((k,), dtype=torch.bool, device=dev)
    code = lib.vpp_block_topk(
        data.data_ptr(), data.element_size(), data.shape[1], scores.border,
        h, w, bs, k, scratch.data_ptr(), scratch.numel(), pos.data_ptr(),
        score.data_ptr(), valid.data_ptr(), stream_handle(data))
    LAUNCHES["block_topk"] += 1
    _build.check(code, "block_topk")
    return pos, score, valid


def fast9(img: Image2d, th: int, *, k: int = 512,
          local_maxima: bool = False, blockwise: bool = False,
          block_size: int = 10, mask: Optional[torch.Tensor] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Public entry: (positions (k, 2) int32, scores (k,) int32,
    valid (k,) bool)."""
    s = fast9_score_image(img, th, mask=mask)
    if local_maxima:
        s = local_maxima_filter(s)
    if blockwise:
        return _blockwise_keypoints(s, block_size, k)
    return select_keypoints(s, k)
