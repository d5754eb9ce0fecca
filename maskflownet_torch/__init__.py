"""maskflownet_torch: the PyTorch/CUDA port of ``maskflownet_tpu``.

Public tensors are NCHW and conv weights OIHW. Every entry point takes a
``device`` argument that defaults to ``"cuda"``; without a card the caller
must ask for the CPU explicitly (``device="cpu"``), where the hand-written
kernels are replaced by their plain PyTorch versions.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def get_device(device: str | torch.device = "cuda") -> torch.device:
    """Resolve ``device``; a CUDA device without a card raises rather than
    silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "maskflownet_torch: CUDA is not available; pass device='cpu' to "
            "run the plain PyTorch path on the CPU")
    return dev
