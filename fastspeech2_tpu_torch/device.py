"""Device placement shared by the port's entry points.

Entry points run on the card unless the caller asks for the CPU: ``None``
means ``cuda``, and ``cuda`` without a GPU raises instead of carrying on on
the CPU. Resolving a CUDA device also turns TF32 off for both matmuls and
cuDNN convolutions: the f32 tier and the f32 duration head need full f32
products (cuDNN's TF32 default flips integer durations); and it turns
reduced-precision reductions of bf16 matmuls off.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


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
