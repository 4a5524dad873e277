"""Host interop and video input (port of ``vpp_tpu.io``)."""

from .video import (foreach_videoframe, open_clip, clip_prefetch,
                    synthetic_clip)
from .bridge import from_numpy, to_numpy, from_opencv, to_opencv

__all__ = ["foreach_videoframe", "open_clip", "clip_prefetch",
           "synthetic_clip", "from_numpy", "to_numpy", "from_opencv",
           "to_opencv"]
