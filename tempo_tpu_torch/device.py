"""Where the port runs: the one seam that turns a `device` argument into
a torch.device.

Entry points run on CUDA unless the caller asks for the CPU. Without a
CUDA device and without an explicit "cpu", they raise: nothing quietly
carries on on the host.
"""

from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """torch.device for `device` (None means "cuda"). Raises RuntimeError
    when CUDA is asked for, explicitly or by default, and is absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "tempo_tpu_torch: no CUDA device; pass device='cpu' to run on the host"
        )
    return dev
