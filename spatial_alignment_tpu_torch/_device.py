"""Device resolution for the port's entry points.

The port runs on the GPU unless the caller asks for the CPU. It never moves
to the CPU on its own: with no CUDA device and no explicit ``device`` it
raises, so a missing card cannot go unnoticed as a slow CPU run.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` means ``"cuda"``; raise if that is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device=\"cpu\" to run the "
            "PyTorch port on the CPU (the plain kernels, for tests)"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}; use 'cuda' or 'cpu'")
    return dev
