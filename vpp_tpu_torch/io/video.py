"""Video input: the frame pump that feeds the trackers (port of
``vpp_tpu.io.video``).

Frames are decoded on the host (ndarray, ``.npy`` and ``.npz`` clips
always; video files and cameras where OpenCV is installed) and copied to
the device. ``clip_prefetch`` keeps one frame in flight: frame t+1 is
copied from pinned host memory on a side CUDA stream while the caller
works on frame t, and the caller's stream waits on the copy's event
before it uses the frame.
"""

from __future__ import annotations

from typing import Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .._device import resolve_device


def _try_cv2():
    try:
        import cv2
        return cv2
    except ImportError:
        return None


def synthetic_clip(w: int, h: int, nframes: int, seed: int = 0,
                   speed: int = 1) -> np.ndarray:
    """(T, H, W) float32 moving smoothed-noise texture: the dataset-free
    test and benchmark clip."""
    rng = np.random.RandomState(seed)
    th, tw = h + speed * nframes + 8, w + speed * nframes + 8
    base = rng.randint(0, 256, (th, tw)).astype(np.float32)
    p = np.pad(base, 1, mode="edge")
    sm = sum(p[r:r + th, c:c + tw] for r in range(3) for c in range(3)) / 9.0
    return np.stack([sm[speed * t:speed * t + h, speed * t:speed * t + w]
                     for t in range(nframes)]).astype(np.float32)


def open_clip(source, max_frames: Optional[int] = None,
              gray: bool = True) -> Iterator[np.ndarray]:
    """Yield (H, W[, 3]) float32 host frames from: an ndarray (T, ...), a
    ``.npy`` / ``.npz`` path, or (where OpenCV is installed) any video file
    or camera index; ``gray`` averages the channels."""
    if isinstance(source, np.ndarray):
        frames: Iterable[np.ndarray] = source
    elif isinstance(source, str) and source.endswith(".npy"):
        frames = np.load(source)
    elif isinstance(source, str) and source.endswith(".npz"):
        z = np.load(source)
        frames = z[list(z.files)[0]]
    else:
        cv2 = _try_cv2()
        if cv2 is None:
            raise RuntimeError(
                "cv2 unavailable; pass an ndarray or .npy/.npz clip")
        cap = cv2.VideoCapture(int(source) if str(source).isdigit()
                               else source)

        def gen():
            while True:
                ok, frame = cap.read()
                if not ok:
                    break
                yield frame[..., ::-1]      # BGR -> RGB
            cap.release()
        frames = gen()

    for i, f in enumerate(frames):
        if max_frames is not None and i >= max_frames:
            break
        f = np.asarray(f)
        if gray and f.ndim == 3:
            f = f.mean(axis=-1)
        yield f.astype(np.float32)


def _host(f) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(f))


def clip_prefetch(frames: Iterable[np.ndarray],
                  device="cuda") -> Iterator[torch.Tensor]:
    """Double-buffered host-to-device pipeline: frame t+1 is copied while
    the caller computes on frame t. Yields tensors on ``device`` (the card
    unless asked for the CPU; there the frames pass through as tensors).

    On a card each frame goes through a pinned host buffer and a
    non-blocking copy on a side stream. The tensor handed out is safe on
    the caller's current stream: that stream waits on the copy's event,
    and the tensor is recorded on it, so the caching allocator does not
    reuse its memory while work queued there may still read it."""
    dev = resolve_device(device)
    it = iter(frames)
    if dev.type != "cuda":
        for f in it:
            yield _host(f).to(dev)
        return
    side = torch.cuda.Stream(dev)

    def put(f):
        host = _host(f).pin_memory()
        with torch.cuda.stream(side):
            out = host.to(dev, non_blocking=True)
            done = torch.cuda.Event()
            done.record(side)
        return out, done

    def ready(item):
        out, done = item
        stream = torch.cuda.current_stream(dev)
        stream.wait_event(done)
        out.record_stream(stream)
        return out

    try:
        nxt = put(next(it))
    except StopIteration:
        return
    for f in it:
        cur, nxt = nxt, put(f)
        yield ready(cur)
    yield ready(nxt)


def foreach_videoframe(source, fn: Callable, *, max_frames: int = None,
                       prefetch: bool = True, device="cuda") -> int:
    """Call ``fn(frame)`` on each frame of ``source`` (``open_clip``'s
    sources) as a tensor on ``device``; returns the frame count. With
    ``prefetch`` the frames come through ``clip_prefetch``; without it each
    is copied when its turn comes."""
    dev = resolve_device(device)
    frames = open_clip(source, max_frames=max_frames)
    frames = clip_prefetch(frames, dev) if prefetch else (
        _host(f).to(dev) for f in frames)
    n = 0
    for f in frames:
        fn(f)
        n += 1
    return n
