"""vpp_tpu_torch — the PyTorch/CUDA port of vpp_tpu's dense vision engine.

Same public functions, config dataclasses, defaults and array layouts as
``vpp_tpu``; plain tensor code is PyTorch, and the hot stages run as CUDA
C++ kernels for Hopper (``vpp_tpu_torch/kernels/csrc``), built with nvcc at
first use. Entry points take ``device=`` and default to ``"cuda"``; lower
level functions follow the device of their input tensors. A CPU tensor
takes each kernel's plain PyTorch version, a CUDA tensor the kernel.

The JAX reference runs its products at "highest" precision, so TF32 is
turned off here for matmuls and cuDNN convolutions alike.
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from ._device import resolve_device  # noqa: E402
from . import core  # noqa: E402

__all__ = ["core", "resolve_device"]

# The heavier subpackages are imported on attribute access, as in
# ``vpp_tpu``, so that a bare ``import vpp_tpu_torch`` stays light.
_SUBPACKAGES = ("algorithms", "slam", "kernels", "utils")


def __getattr__(name):
    if name in _SUBPACKAGES:
        import importlib
        mod = importlib.import_module(f".{name}", __name__)
        globals()[name] = mod
        return mod
    raise AttributeError(f"module 'vpp_tpu_torch' has no attribute {name!r}")
