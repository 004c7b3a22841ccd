"""Device selection for the entry points.

Entry points run on the card unless the caller asks for the CPU: the default
``"cuda"`` raises when CUDA is absent instead of moving the work to the CPU.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    d = torch.device(device)
    if d.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain PyTorch versions")
    return d


def default_generator(generator, device: torch.device) -> torch.Generator:
    """The caller's generator, or a fresh one on ``device`` seeded with 0."""
    if generator is not None:
        return generator
    return torch.Generator(device=device).manual_seed(0)


def to_numpy(x) -> np.ndarray:
    """A host copy of a tensor on any device; other array-likes as numpy."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
