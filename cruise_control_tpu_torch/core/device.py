"""Device selection for the port's entry points.

Every entry point takes ``device``.  ``None`` means the GPU: the solver is
written for the card, and a run that silently carried on on the CPU would
report CPU behaviour under the GPU's name.  So with no GPU present and no
explicit ``device="cpu"``, :func:`resolve_device` raises.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The torch device an entry point runs on (``cuda`` unless told otherwise)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cruise_control_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU explicitly"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev!s}: use 'cuda' or 'cpu'")
    return dev

