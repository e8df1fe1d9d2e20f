"""Where the port runs: the card unless the caller asks for the CPU.

The counterpart of ``repro.kernels.ops.on_tpu``.  Entry points take a
``device`` argument; ``None`` means the CUDA card, and a missing card is
an error, never a silent fall back to the CPU.  Tests pass
``device="cpu"`` explicitly, which routes every kernel wrapper to its
plain PyTorch version.
"""
from __future__ import annotations

from typing import Optional, Union

import torch


def on_cuda() -> bool:
    """True when a CUDA card is visible to this process."""
    return torch.cuda.is_available()


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` → ``cuda``; raises ``RuntimeError`` when no card is present.
    An explicit ``"cpu"`` is honoured; an explicit CUDA device must exist.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not on_cuda():
        raise RuntimeError(
            "no CUDA card is visible; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; the port runs on cuda or cpu")
    return dev


def full_f32_math() -> None:
    """Run f32 matmuls and convolutions in full f32 in this process.

    The port is held to an f32 reference, and cuDNN's default runs f32
    convolutions in TF32, which keeps 10 bits of mantissa.  Every builder
    of a training step (``DSGDTrainer``, ``build_dist_train``,
    ``ClientPool``) calls this, so the library's routes run what
    ``build_run`` does.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
