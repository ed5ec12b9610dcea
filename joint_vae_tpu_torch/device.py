"""Device resolution and the float32 math the port uses.

Entry points run on the card unless the caller asks for the CPU; with no
card and no explicit request they raise instead of quietly running on the
CPU.  The JAX reference computes in full float32, so TF32 is switched off
for both cuBLAS matmuls and cuDNN convolutions (cuDNN defaults to TF32).
"""

from typing import Optional, Union

import numpy as np
import torch

DeviceLike = Union[str, torch.device, None]


def set_float32_math() -> None:
    """Full-precision float32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> the first CUDA card, or raise when there is none;
    otherwise the device asked for.  Also pins the float32 math."""
    set_float32_math()
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                'no CUDA device is available; pass device="cpu" '
                '(--device cpu on the CLI) to run on the CPU')
        return torch.device('cuda')
    dev = torch.device(device)
    if dev.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('device {} requested but CUDA is not '
                           'available'.format(dev))
    return dev


def module_device(module: torch.nn.Module) -> Optional[torch.device]:
    """Device of a module's first parameter (None for a parameterless one)."""
    for p in module.parameters():
        return p.device
    return None


def to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host batch on ``device``; to the card through pinned memory, so
    that the copy does not wait for the card's queue."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == 'cuda':
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
