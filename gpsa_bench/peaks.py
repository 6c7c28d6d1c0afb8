"""Published peaks of the card, dense and without sparsity (NVIDIA's data
sheets, at the part's full power limit): memory bytes/s, float32 FLOP/s
outside the tensor cores, TF32 tensor-core FLOP/s."""

from __future__ import annotations

PEAKS = {
    "H100 SXM": {"bytes_per_s": 3.35e12, "fp32": 67e12, "tf32": 495e12},
    "H100 PCIe": {"bytes_per_s": 2.0e12, "fp32": 51e12, "tf32": 378e12},
}


def for_device(name: str) -> dict:
    """The peaks of the card ``torch.cuda.get_device_name()`` names; a PCIe
    part by its name, every other H100 as the SXM part."""
    if "H100" not in name:
        raise ValueError(f"no published peaks for {name!r}")
    return PEAKS["H100 PCIe" if "PCIe" in name else "H100 SXM"]


def least_seconds(flops: float, n_bytes: float, peaks: dict, rate: str) -> float:
    """The least time for ``flops`` at peak ``rate`` ("fp32" or "tf32") and
    ``n_bytes`` at the memory rate, whichever is larger."""
    return max(flops / peaks[rate], n_bytes / peaks["bytes_per_s"])
