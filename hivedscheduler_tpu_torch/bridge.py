"""Carry model weights between the JAX package and the port.

The JAX parameter tree (``hivedscheduler_tpu.models.transformer.init_params``:
nested dicts, stacked ``[n_layers]`` layer leaves) is the port's model
state too, so the bridge only converts leaves: numpy arrays in, tensors out,
and back. The caller turns JAX arrays into numpy (``jax.device_get``)
before :func:`from_numpy_tree`; this module imports no JAX.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def map_tree(fn, node):
    """The tree with ``fn`` applied to every leaf."""
    if isinstance(node, dict):
        return {k: map_tree(fn, v) for k, v in node.items()}
    return fn(node)


def from_numpy_tree(tree: Any, device: str | torch.device = "cpu") -> Any:
    """numpy-leaved parameter tree -> the same tree of tensors on ``device``,
    dtypes kept. A bfloat16 numpy leaf goes through f32, which holds every
    bfloat16 value exactly."""

    def leaf(x):
        arr = np.asarray(x)
        if arr.dtype.name == "bfloat16":
            t = torch.from_numpy(arr.astype(np.float32)).to(torch.bfloat16)
        else:
            t = torch.from_numpy(np.array(arr))  # a writable copy
        return t.to(device)

    return map_tree(leaf, tree)


def to_numpy_tree(tree: Any) -> Any:
    """Tensor-leaved tree -> numpy-leaved tree on the host. bfloat16 leaves
    come back as float32 (exact); other dtypes keep theirs."""

    def leaf(t):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.numpy()

    return map_tree(leaf, tree)
