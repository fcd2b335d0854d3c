"""Where the port's entry points put the data they are handed."""

from __future__ import annotations

import numpy as np
import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA device.

    With ``None`` and no CUDA device this raises instead of running on the
    CPU: the CPU is used only when a caller asks for it.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and no CUDA "
                "device is available; pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def as_tensor(x, *, device=None, dtype=None) -> torch.Tensor:
    """A tensor from ``x``.

    A tensor stays on its device unless ``device`` is given; anything else
    (numpy arrays, lists, scalars) goes to ``resolve_device(device)``.
    Floating numpy input defaults to float64.
    """
    if isinstance(x, torch.Tensor):
        if device is None:
            return x if dtype is None else x.to(dtype)
        return x.to(device=torch.device(device), dtype=dtype)
    arr = np.asarray(x)
    if not arr.flags.writeable:
        arr = arr.copy()
    if dtype is None and arr.dtype.kind == "f":
        dtype = torch.float64
    return torch.as_tensor(arr, dtype=dtype, device=resolve_device(device))
