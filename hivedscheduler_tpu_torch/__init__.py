"""PyTorch/CUDA port of the workload runtime of ``hivedscheduler_tpu``.

The JAX package beside this one is the reference; module paths and names
here mirror it (``models/transformer.py``, ``ops/attention.py``,
``parallel/train.py``, ``eval.py``) so each piece has an obvious
counterpart. This package imports ``torch`` and never JAX, and it keeps its
own copies of whatever it needs from the reference.

Entry points run on the CUDA card unless the caller asks for the CPU;
:func:`resolve_device` is the one place that decides, and it never falls
back from the card to the CPU.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

if TYPE_CHECKING:
    import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """The device a caller asked for, checked: ``cuda`` (the default) needs
    a card and raises without one; ``cpu`` is taken only when asked for.
    torch is imported here, not with the package, so that a CLI can start
    its goodput ledger before the import."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run on "
                "the CPU"
            )
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}; expected cuda or cpu")
    return dev
