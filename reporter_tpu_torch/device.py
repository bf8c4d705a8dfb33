"""The one place the port chooses its device.

Every entry point takes ``device=None`` and resolves it here: ``cuda``
when a card is present, otherwise an error. The CPU runs only when the
caller asks for it by name (``device="cpu"``, as the tests do), and then
every kernel wrapper takes its plain PyTorch version. Nothing falls back
to the CPU quietly.
"""

from __future__ import annotations

import torch


def resolve_device(device: "str | torch.device | None" = None) -> torch.device:
    """``None`` → ``cuda`` (raises without a card); ``"cpu"`` / ``"cuda"``
    / ``"cuda:N"`` as given, checked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch path on the host")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r} requested but no CUDA "
                               "device is available")
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}; use 'cuda' or 'cpu'")
    return dev
