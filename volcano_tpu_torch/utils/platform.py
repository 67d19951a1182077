"""Device selection: every entry point runs on the GPU unless the caller
asks for another device. There is no silent fall-back to the CPU."""

from __future__ import annotations

from typing import Optional, Union

import torch


def default_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``device`` as a torch.device, or ``cuda:0`` when it is None.

    Raises RuntimeError when no device is given and no CUDA device is
    present: the CPU is used only when the caller passes ``device="cpu"``.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions on the CPU")
    return torch.device("cuda", 0)
