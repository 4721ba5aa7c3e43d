"""Where the port's tensors live.

Every entry point (``QueryEngine``, ``DgraphServer``, the CLI) takes a
``device`` argument and resolves it once, here.  The default is
``cuda``: asking for it on a host without a GPU raises instead of
quietly running on the CPU.  ``"cpu"`` is an explicit choice (the tests
make it); on the CPU every kernel wrapper runs its plain PyTorch
version.
"""

from __future__ import annotations

from typing import Union

import torch

DEFAULT = "cuda"


def resolve(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` as a ``torch.device`` (``None`` means the default).
    Raises RuntimeError for a CUDA device when no GPU is visible."""
    dev = torch.device(DEFAULT if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch sees no CUDA GPU; "
                "pass device='cpu' to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev
