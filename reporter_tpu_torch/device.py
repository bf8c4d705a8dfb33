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


def host_to_device(x, device) -> torch.Tensor:
    """A host numpy array as a tensor on ``device``, without making the
    host wait. On ``cuda`` the array is copied into pinned host memory and
    from there to the card with ``non_blocking=True``, queued on the
    device's current stream: PyTorch's caching host allocator keeps the
    pinned block until that copy's event has passed, so the caller may
    reuse its array at once (a pageable ``.to(device)`` synchronizes the
    stream instead). On ``cpu`` it is ``torch.from_numpy(x).to(device)``,
    the array's own memory."""
    t = torch.from_numpy(x)
    device = torch.device(device)
    if device.type != "cuda":
        return t.to(device)
    return t.pin_memory().to(device, non_blocking=True)
