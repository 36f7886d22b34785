"""PyTorch/CUDA port of the ``repro`` package (Hopper, one H100).

The JAX package in ``src/repro/`` is the reference and stays unchanged;
this package mirrors its layout and names and imports nothing of it.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on the CPU every kernel wrapper takes its plain PyTorch version.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
