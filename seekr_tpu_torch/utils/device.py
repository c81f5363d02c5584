"""Where the port's entry points run.

Every entry point takes ``device=None`` and resolves it here.  ``None`` means the
first CUDA card.  Without CUDA that raises: the port never moves work to the CPU
on its own.  A caller that wants the CPU (the tests do) asks for ``"cpu"``.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda:0``; any other value -> ``torch.device(device)``.

    Raises ``RuntimeError`` when the result is a CUDA device and CUDA is absent.
    """
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"CUDA is not available, so the port cannot run on {dev}; "
            "pass device='cpu' to run on the CPU")
    return dev
