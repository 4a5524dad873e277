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

The tracker's stages also run on S frames at once: ``cull_scores``,
``score_image`` and ``block_topk`` take the raw bordered buffers (S, H+2b,
W+2b) with the border as an int (or one (H+2b, W+2b) frame), positions
(S, K, 2) and masks (S, H, W), and make one launch for every stream.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..core.image import Image2d, from_array, pad_hw
from ..kernels import LAUNCHES, require_cuda, stream_handle

CIRCLE = [(-3, -1), (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3),
          (2, 2), (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3),
          (-1, -3), (-2, -2)]


def _circle_diffs(data: torch.Tensor, b: int, h: int,
                  w: int) -> torch.Tensor:
    """(16, ..., H, W) int32 diffs circle_point - center of the (..., H +
    2b, W + 2b) bordered buffer(s)."""
    def view(dr, dc):
        return data[..., b + dr:b + dr + h, b + dc:b + dc + w].to(torch.int32)
    v = view(0, 0)
    return torch.stack([view(dr, dc) - v for dr, dc in CIRCLE], dim=0)


def _has_9_contiguous(flags: torch.Tensor) -> torch.Tensor:
    """flags: (16, ...) bool → (...) bool: any 9 circularly-contiguous
    set. The doubled-ring trick in int64, whose bits 16..31 equal those of
    the 32-bit original (left shifts only move low bits up)."""
    weights = torch.tensor([1 << k for k in range(16)], dtype=torch.int64,
                           device=flags.device)
    weights = weights.view((16,) + (1,) * (flags.dim() - 1))
    code = (flags.to(torch.int64) * weights).sum(0)
    c = code | (code << 16)
    r2 = c & (c << 1)
    r4 = r2 & (r2 << 2)
    r8 = r4 & (r4 << 4)
    r9 = r8 & (c << 8)
    return (r9 & 0xFFFF0000) != 0


def _fast9_raw(data: torch.Tensor, b: int, th: int, detect: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain K2 on (..., H + 2b, W + 2b) buffer(s): the (..., H, W) int32
    score and, with ``detect``, the uint8 keypoint flag."""
    h, w = data.shape[-2] - 2 * b, data.shape[-1] - 2 * b
    d = _circle_diffs(data, b, h, w)
    zero = torch.zeros_like(d)
    sum_sup = torch.where(d > th, d, zero).sum(0, dtype=torch.int32)
    sum_inf = torch.where(d < -th, -d, zero).sum(0, dtype=torch.int32)
    score = torch.maximum(sum_sup, sum_inf)
    if not detect:
        return score, None
    kp = _has_9_contiguous(d > th) | _has_9_contiguous(d < -th)
    return score, kp.to(torch.uint8)


def fast9_plain(img: Image2d, th: int, detect: bool = True
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Plain PyTorch version of K2: (H, W) int32 score and, with
    ``detect``, the (H, W) uint8 keypoint flag."""
    return _fast9_raw(img.data, img.border, th, detect)


def _streams(data: torch.Tensor, *more: torch.Tensor):
    """(one frame given, operands with a leading stream dimension): a 2-D
    frame and its operands gain S = 1."""
    if data.dim() == 2:
        return True, (data[None],) + tuple(
            None if t is None else t[None] for t in more)
    if data.dim() != 3:
        raise ValueError(f"expected (H, W) or (S, H, W) buffers, got "
                         f"{tuple(data.shape)}")
    return False, (data,) + more


def _k2_frame(data: torch.Tensor, name: str) -> torch.Tensor:
    """K2's operand: the bordered frame(s) as contiguous float32 on the
    card (integer pixel types up to 24 bits convert exactly)."""
    if data.dtype != torch.float32:
        data = data.to(torch.float32)
    data = data.contiguous()
    require_cuda(name, data, dtypes=(torch.float32,))
    return data


def _need_border_3(border: int) -> None:
    if border < 3:
        raise ValueError("FAST needs a border of at least 3px")


def fast9_cuda(img: Image2d, th: int, detect: bool = True
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K2's full map: score (and flag) in one launch on a CUDA image; the
    plain version for a CPU image. Needs border >= 3."""
    _need_border_3(img.border)
    if img.data.device.type == "cpu":
        return fast9_plain(img, th, detect)
    if img.data.dim() != 2:
        raise ValueError(f"fast9: expected a 2-D image, got "
                         f"{img.data.shape}")
    data = _k2_frame(img.data, "fast9")
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
    _need_border_3(img.border)
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


def _cull_plain(data: torch.Tensor, border: int, positions: torch.Tensor,
                th: int) -> torch.Tensor:
    """Plain K2 cull on (S, H+2b, W+2b) buffers and (S, K, 2) positions:
    the full map and a gather per stream."""
    h, w = data.shape[-2] - 2 * border, data.shape[-1] - 2 * border
    score, _ = _fast9_raw(data, border, th, detect=False)
    p = torch.round(positions.to(torch.float32)).to(torch.int32)
    flat = (p[..., 0].clamp(0, h - 1) * w + p[..., 1].clamp(0, w - 1)).long()
    return score.flatten(-2).gather(-1, flat)


def fast9_cull_scores_plain(img: Image2d, positions: torch.Tensor,
                            th: int) -> torch.Tensor:
    """Plain version of K2's cull: the JAX tracker's expression
    ``fast9_score(img, th)[clip(round(positions))]`` written out, the full
    map and a gather."""
    return _cull_plain(img.data, img.border, positions, th)


def cull_scores(data: torch.Tensor, border: int, positions: torch.Tensor,
                th: int) -> torch.Tensor:
    """K2's cull on raw buffers: the int32 FAST score at float
    ``positions`` (row, col, interior coords) rounded half to even and
    clamped into the domain; (S, H+2b, W+2b) buffers with (S, K, 2)
    positions give (S, K) in one launch for every stream (one thread a
    slot, 17 samples), one (H+2b, W+2b) frame with (K, 2) positions (K,).
    The plain version for CPU buffers. Equal to the full map read at those
    pixels for every position within the int32 range."""
    _need_border_3(border)
    one, (data, positions) = _streams(data, positions)
    if data.device.type == "cpu":
        out = _cull_plain(data, border, positions, th)
        return out[0] if one else out
    n_streams = data.shape[0]
    if (positions.dim() != 3 or positions.shape[0] != n_streams
            or positions.shape[2] != 2):
        raise ValueError(f"fast9_cull_scores: positions must be (K, 2) a "
                         f"stream, got {tuple(positions.shape)}")
    data = _k2_frame(data, "fast9_cull_scores")
    pos = positions
    if pos.dtype != torch.float32:
        pos = pos.to(torch.float32)
    pos = pos.contiguous()
    require_cuda("fast9_cull_scores", data, pos,
                 dtypes=(torch.float32, torch.float32))
    from ..kernels import _build
    h, w = data.shape[1] - 2 * border, data.shape[2] - 2 * border
    k = pos.shape[1]
    out = torch.empty((n_streams, k), dtype=torch.int32, device=data.device)
    if k > 0:
        code = _build.load().vpp_fast9_cull(
            data.data_ptr(), data.shape[2], border, h, w, int(th),
            pos.data_ptr(), k, n_streams, out.data_ptr(), stream_handle(data))
        LAUNCHES["fast9"] += 1
        _build.check(code, "fast9_cull")
    return out[0] if one else out


def fast9_cull_scores(img: Image2d, positions: torch.Tensor,
                      th: int) -> torch.Tensor:
    """K2's cull of one image (``cull_scores``): the (K,) int32 FAST score
    at (K, 2) float ``positions``. Needs border >= 3."""
    if img.data.dim() != 2:
        raise ValueError(f"fast9_cull_scores: expected a 2-D image, got "
                         f"{tuple(img.data.shape)}")
    return cull_scores(img.data, img.border, positions, th)


def _score_image_plain(data: torch.Tensor, border: int, th: int,
                       mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Plain K2 score image of (..., H+2b, W+2b) buffer(s): the full map
    and flag, the mask, score // 16 clipped to uint8, and the zero border
    of 1, as the JAX package composes them."""
    score, flag = _fast9_raw(data, border, th, detect=True)
    kp = flag != 0
    if mask is not None:
        kp = kp & (torch.as_tensor(mask, device=kp.device) != 0)
    s = torch.where(kp, torch.div(score, 16, rounding_mode="floor"),
                    torch.zeros_like(score))
    return pad_hw(s.clamp(0, 255).to(torch.uint8), 1, 1, 1, 1, "constant")


def fast9_score_image_plain(img: Image2d, th: int,
                            mask: Optional[torch.Tensor] = None) -> Image2d:
    """Plain version of K2's score image (``_score_image_plain``)."""
    return Image2d(data=_score_image_plain(img.data, img.border, th, mask),
                   border=1)


def score_image(data: torch.Tensor, border: int, th: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K2's score image on raw buffers: uint8 score/16 with a zero border
    of 1, non-zero only at detected keypoints, an optional ``mask`` (0:
    masked out) applied. (S, H+2b, W+2b) buffers with (S, H, W) masks give
    (S, H+2, W+2) in one launch for every stream (a uint8 or bool mask is
    read as bytes); one frame gives (H+2, W+2). The plain version for CPU
    buffers."""
    _need_border_3(border)
    if data.device.type == "cpu":
        return _score_image_plain(data, border, th, mask)
    if mask is not None:
        mask = torch.as_tensor(mask, device=data.device)
    one, (data, mask) = _streams(data, mask)
    data = _k2_frame(data, "fast9_score_image")
    n_streams = data.shape[0]
    h, w = data.shape[1] - 2 * border, data.shape[2] - 2 * border
    operands, dtypes = [data], [torch.float32]
    if mask is not None:
        if mask.dtype not in (torch.uint8, torch.bool):
            mask = mask != 0
        mask = mask.contiguous()
        if tuple(mask.shape) != (n_streams, h, w):
            raise ValueError(f"fast9_score_image: mask must be {(h, w)} a "
                             f"stream, got {tuple(mask.shape)}")
        operands.append(mask)
        dtypes.append(mask.dtype)
    require_cuda("fast9_score_image", *operands, dtypes=dtypes)
    from ..kernels import _build
    out = torch.empty((n_streams, h + 2, w + 2), dtype=torch.uint8,
                      device=data.device)
    code = _build.load().vpp_fast9_image(
        data.data_ptr(), data.shape[2], border, h, w, int(th),
        mask.data_ptr() if mask is not None else None, n_streams,
        out.data_ptr(), stream_handle(data))
    LAUNCHES["fast9"] += 1
    _build.check(code, "fast9_image")
    return out[0] if one else out


def fast9_score_image(img: Image2d, th: int,
                      mask: Optional[torch.Tensor] = None) -> Image2d:
    """uint8 score/16 image (border 1) of one image, non-zero only at
    detected keypoints; an optional (H, W) ``mask`` zeroes masked-out
    pixels (``score_image``: one K2 launch on a CUDA image)."""
    if img.data.dim() != 2:
        raise ValueError(f"fast9_score_image: expected a 2-D image, got "
                         f"{tuple(img.data.shape)}")
    return Image2d(data=score_image(img.data, img.border, th, mask),
                   border=1)


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


def _block_argmax(a: torch.Tensor, bs: int):
    """Per-block first-max (row-major within the block) over (..., h, w)
    interior(s) padded with -1: returns (idx, vmax, nbr, nbc)."""
    a = a.to(torch.int32)
    h, w = a.shape[-2], a.shape[-1]
    nbr, nbc = -(-h // bs), -(-w // bs)
    padded = pad_hw(a, 0, nbr * bs - h, 0, nbc * bs - w, "constant", -1)
    lead = a.shape[:-2]
    flat = padded.reshape(lead + (nbr, bs, nbc, bs)).transpose(-3, -2)
    flat = flat.reshape(lead + (nbr, nbc, bs * bs))
    # torch.argmax returns the first maximal index, as jnp.argmax does
    return flat.argmax(dim=-1), flat.amax(dim=-1), nbr, nbc


def blockwise_maxima_filter(scores: Image2d, block_size: int) -> Image2d:
    """Keep only the per-block argmax of the score image, zero elsewhere;
    ties break to the first (row-major) position."""
    h, w = scores.shape
    bs = block_size
    idx, vmax, nbr, nbc = _block_argmax(scores.interior, bs)
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


def _block_topk_plain(a: torch.Tensor, bs: int, k: int
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of K3 on (..., h, w) score interior(s): per-block
    argmax, then the top k of the block winners. Every key is distinct:
    ``score*nb + (nb-1-i)`` where the score is positive (equal scores
    extract block-row-major, as in JAX) and ``-1-i`` elsewhere (the invalid
    entries in ascending block order, as ``lax.top_k`` orders its tied -1
    keys), so every output is determined."""
    idx, vmax, nbr, nbc = _block_argmax(a, bs)
    dev = idx.device
    lead = idx.shape[:-2]
    pos_r = torch.arange(nbr, device=dev)[:, None] * bs + idx // bs
    pos_c = torch.arange(nbc, device=dev)[None, :] * bs + idx % bs
    cand_score = vmax.clamp(min=0).flatten(-2)
    cand_pos = torch.stack([pos_r, pos_c], dim=-1).flatten(-3, -2)
    nb = cand_score.shape[-1]
    ar = torch.arange(nb, dtype=torch.int32, device=dev)
    key = torch.where(cand_score > 0, cand_score * nb + (nb - 1 - ar),
                      -1 - ar)
    kk = min(k, nb)
    topv, topi = torch.topk(key, kk, dim=-1, sorted=True)
    valid = topv >= 0
    pos = cand_pos.gather(-2, topi[..., None].expand(
        topi.shape + (2,))).to(torch.int32)
    score = torch.where(valid, cand_score.gather(-1, topi),
                        torch.zeros_like(topv))
    if kk < k:
        pad = k - kk
        pos = torch.cat([pos, torch.zeros(lead + (pad, 2), dtype=torch.int32,
                                          device=dev)], dim=-2)
        score = torch.cat([score, torch.zeros(lead + (pad,),
                                              dtype=score.dtype,
                                              device=dev)], dim=-1)
        valid = torch.cat([valid, torch.zeros(lead + (pad,),
                                              dtype=torch.bool,
                                              device=dev)], dim=-1)
    return pos, score, valid


def _blockwise_keypoints_plain(scores: Image2d, block_size: int, k: int
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Plain version of K3 (``_block_topk_plain``) on one score image."""
    return _block_topk_plain(scores.interior, block_size, k)


# the JAX key score*nb + (nb-1-i) of a score up to 255 fits int32
BLOCK_TOPK_MAX_BLOCKS = 2 ** 31 // 256


def block_topk(data: torch.Tensor, border: int, block_size: int, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 (``kernels/csrc/block_topk.cu``) on raw score buffers: per-block
    argmax + top-K over the block winners. (S, h+2b, w+2b) buffers give
    (pos (S, k, 2) int32, score (S, k) int32, valid (S, k) bool) in one
    cooperative launch for every stream (a stable counting sort over the
    256 scores), bit-equal to the plain version; one buffer gives (k, 2),
    (k,), (k,). The plain version for CPU buffers. Scores must lie in
    0..255 (the uint8 score image; an int32 image with a larger block
    maximum makes the kernel trap, a CUDA error at the next
    synchronisation)."""
    b, bs = border, block_size
    if data.device.type == "cpu":
        return _block_topk_plain(data[..., b:data.shape[-2] - b,
                                      b:data.shape[-1] - b], bs, k)
    one, (data,) = _streams(data)
    n_streams = data.shape[0]
    h, w = data.shape[1] - 2 * b, data.shape[2] - 2 * b
    if bs < 1 or k < 1 or h < 1 or w < 1:
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
    # a stream's winners' scores and indices, and its (CTAs, 256) histogram
    # table for at most one CTA per 64 blocks
    per_stream = 2 * nb + 256 * -(-nb // 64)
    scratch = torch.empty((n_streams * per_stream,), dtype=torch.int32,
                          device=dev)
    pos = torch.empty((n_streams, k, 2), dtype=torch.int32, device=dev)
    score = torch.empty((n_streams, k), dtype=torch.int32, device=dev)
    valid = torch.empty((n_streams, k), dtype=torch.bool, device=dev)
    code = lib.vpp_block_topk(
        data.data_ptr(), data.element_size(), data.shape[2], b, h, w, bs, k,
        n_streams, data.shape[1] * data.shape[2], scratch.data_ptr(),
        per_stream, pos.data_ptr(), score.data_ptr(), valid.data_ptr(),
        stream_handle(data))
    LAUNCHES["block_topk"] += 1
    _build.check(code, "block_topk")
    if one:
        return pos[0], score[0], valid[0]
    return pos, score, valid


def _blockwise_keypoints(scores: Image2d, block_size: int, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """K3 on one score image (``block_topk``): (pos (k, 2) int32, score
    (k,) int32, valid (k,) bool)."""
    if scores.data.dim() != 2:
        raise ValueError(f"block_topk: needs a 2-D score image, got "
                         f"{tuple(scores.data.shape)}")
    return block_topk(scores.data, scores.border, block_size, k)


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
