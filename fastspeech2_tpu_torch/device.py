"""Device placement shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``cuda``, and ``cuda`` without a GPU raises instead of carrying on on
the CPU. Resolving a CUDA device also turns TF32 off for both matmuls and
cuDNN convolutions: the f32 tier and the f32 duration head need full f32
products (cuDNN's TF32 default flips integer durations); and it turns
reduced-precision reductions of bf16 matmuls off.

``matmul_precision("default", device)`` lets f32 matmuls and cuDNN
convolutions use TF32 inside a block and restores the flags after it (the
GPU counterpart of JAX's DEFAULT precision; ``"highest"`` keeps full f32).
The flags are process-wide: overlapping blocks on several threads share one
TF32 window, opened by the first to enter and closed by the last to leave.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Union

import torch

PRECISIONS = ("default", "highest")
_tf32_lock = threading.Lock()
_tf32_open = [0, None]  # blocks inside the TF32 window, flags before it


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        # bf16 products accumulate and reduce in f32 (ops/nn.py's contract)
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return dev


@contextlib.contextmanager
def matmul_precision(precision: str, device: torch.device):
    """TF32 for f32 products on a CUDA device inside the block under
    ``"default"``; ``"highest"`` and the CPU change nothing."""
    if precision not in PRECISIONS:
        raise ValueError(f"matmul_precision must be one of {PRECISIONS}, got {precision!r}")
    if precision == "highest" or torch.device(device).type != "cuda":
        yield
        return
    flags = (torch.backends.cuda.matmul, torch.backends.cudnn)
    with _tf32_lock:
        if _tf32_open[0] == 0:
            _tf32_open[1] = tuple(f.allow_tf32 for f in flags)
            for f in flags:
                f.allow_tf32 = True
        _tf32_open[0] += 1
    try:
        yield
    finally:
        with _tf32_lock:
            _tf32_open[0] -= 1
            if _tf32_open[0] == 0:
                for f, was in zip(flags, _tf32_open[1]):
                    f.allow_tf32 = was
