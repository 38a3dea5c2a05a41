"""The port's device rule: its entry points run on the card unless the
caller asks for the CPU (``device="cpu"``)."""

import torch

DEFAULT = "cuda"


def resolve(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device on a machine where
    torch sees no card raises instead of running anywhere else."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} needs a CUDA card and torch sees none; "
                           "pass device='cpu' to run on the CPU")
    return dev
