"""Device policy: the card unless the caller asks for the CPU.

Entry points take a ``device=`` argument (``ServerConfig.device``,
``QuantizedServing.build(..., device=)``); without one,
``PIO_TORCH_DEVICE`` decides, and without that the device is ``cuda``.
Asking for ``cuda`` on a machine without a card raises — the port never
carries on on the CPU behind the caller's back.

Importing this module turns TF32 off for matmuls and cuDNN: the JAX
package computes its fp32 products at ``Precision.HIGHEST``.
"""

from __future__ import annotations

import os
from typing import Optional, Union

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

DeviceLike = Union[None, str, torch.device]


def resolve(device: DeviceLike = None) -> torch.device:
    """The torch.device to run on: ``device`` > ``PIO_TORCH_DEVICE`` >
    ``cuda``. Raises RuntimeError for ``cuda`` when no card is visible."""
    if isinstance(device, torch.device):
        dev = device
    else:
        dev = torch.device(device or os.environ.get("PIO_TORCH_DEVICE")
                           or "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' or set PIO_TORCH_DEVICE=cpu to run "
            "on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def describe(device: Optional[torch.device]) -> str:
    """Human-readable device name (the card's own name on cuda)."""
    if device is not None and device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"
