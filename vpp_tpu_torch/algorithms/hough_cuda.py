"""Dense Hough accumulator kernel K7 and its plain version.

The port's counterpart of ``vpp_tpu.algorithms.hough_pallas``: it takes the
same per-pixel vectors as ``hough_accumulator_pallas`` — continuous bin
coordinates θ_n = t0 + ft, ρ_n = r0 + fr and vote weights w — and returns
the (t_theta, rho_bins) accumulator of the four bilinear votes of every
pixel, clipped at the last bin like ``hough.hough_accumulator``.

On the card (``kernels/csrc/hough_acc.cu``) one cooperative launch zeroes
the wrapper's scratch, sums the votes as 2^24 fixed-point integers with
64-bit atomics, and converts them, so the result is bit-identical from run
to run; weights stay float32 (the Pallas kernel's bf16 operands were the
price of the TPU's matrix unit).
"""

from __future__ import annotations

import torch

from ..kernels import LAUNCHES, require_cuda, stream_handle


def _check_votes(th_n, rho_n, w) -> None:
    if not (th_n.dim() == rho_n.dim() == w.dim() == 1
            and th_n.shape == rho_n.shape == w.shape):
        raise ValueError("hough_acc: th_n, rho_n and w must be equal-length "
                         "vectors")


def hough_acc_plain(th_n: torch.Tensor, rho_n: torch.Tensor,
                    w: torch.Tensor, t_theta: int,
                    rho_bins: int) -> torch.Tensor:
    """Plain version of K7: four ordered float32 scatter-add passes."""
    _check_votes(th_n, rho_n, w)
    t0f, r0f = torch.floor(th_n), torch.floor(rho_n)
    ft, fr = th_n - t0f, rho_n - r0f
    t0 = t0f.to(torch.int64).clamp(0, t_theta - 1)
    r0 = r0f.to(torch.int64).clamp(0, rho_bins - 1)
    t1 = (t0 + 1).clamp(max=t_theta - 1)
    r1 = (r0 + 1).clamp(max=rho_bins - 1)
    a0, a1 = w * (1 - ft), w * ft
    acc = torch.zeros((t_theta * rho_bins,), dtype=torch.float32,
                      device=w.device)
    acc.index_put_((t0 * rho_bins + r0,), a0 * (1 - fr), accumulate=True)
    acc.index_put_((t0 * rho_bins + r1,), a0 * fr, accumulate=True)
    acc.index_put_((t1 * rho_bins + r0,), a1 * (1 - fr), accumulate=True)
    acc.index_put_((t1 * rho_bins + r1,), a1 * fr, accumulate=True)
    return acc.view(t_theta, rho_bins)


def hough_acc(th_n: torch.Tensor, rho_n: torch.Tensor, w: torch.Tensor,
              t_theta: int, rho_bins: int) -> torch.Tensor:
    """K7 on CUDA vectors (the plain version on CPU ones): (t_theta,
    rho_bins) float32 accumulator, one launch a call."""
    if th_n.device.type == "cpu":
        return hough_acc_plain(th_n, rho_n, w, t_theta, rho_bins)
    _check_votes(th_n, rho_n, w)
    require_cuda("hough_acc", th_n, rho_n, w,
                 dtypes=(torch.float32,) * 3)
    from ..kernels import _build
    lib = _build.load()
    dev = th_n.device
    scratch = torch.empty((t_theta * rho_bins,), dtype=torch.int64,
                          device=dev)
    out = torch.empty((t_theta, rho_bins), dtype=torch.float32, device=dev)
    code = lib.vpp_hough_acc(th_n.data_ptr(), rho_n.data_ptr(),
                             w.data_ptr(), th_n.shape[0], t_theta, rho_bins,
                             scratch.data_ptr(), out.data_ptr(),
                             stream_handle(th_n))
    LAUNCHES["hough_acc"] += 1
    _build.check(code, "hough_acc")
    return out
