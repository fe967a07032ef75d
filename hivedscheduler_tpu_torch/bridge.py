"""Carry model weights between the JAX package and the port.

The JAX parameter tree (``hivedscheduler_tpu.models.transformer.init_params``:
nested dicts, stacked ``[n_layers]`` layer leaves) is the port's model
state too, so the bridge only converts leaves: numpy arrays in, tensors out,
and back. The caller turns JAX arrays into numpy (``jax.device_get``)
before :func:`from_numpy_tree`; this module imports no JAX.
:func:`distribute_tree` places such a tree on a device mesh, each leaf by
its ``sharding_specs`` entry, so every rank holds its shard of the same
numbers; :func:`full_tree` brings a placed tree back whole.
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


def distribute_tree(tree: Any, mesh, specs: Any) -> Any:
    """A numpy- or tensor-leaved tree -> the same tree of DTensors on the
    parameter submesh of ``mesh`` (``parallel/sharding.param_mesh``, on
    its device type), each leaf laid out by its entry of ``specs``
    (``models/transformer.sharding_specs``). Every rank passes the same
    tree and keeps its own shard; nothing is communicated."""
    from torch.distributed.tensor import distribute_tensor

    from hivedscheduler_tpu_torch.parallel import sharding

    pmesh = sharding.param_mesh(mesh)

    def place(leaf, spec):
        t = leaf if isinstance(leaf, torch.Tensor) else from_numpy_tree(leaf)
        return distribute_tensor(t.to(pmesh.device_type), pmesh,
                                 sharding.placements(spec, pmesh),
                                 src_data_rank=None)

    def walk(node, spec):
        if isinstance(node, dict):
            return {k: walk(v, spec[k]) for k, v in node.items()}
        return place(node, spec)

    return walk(tree, specs)


def full_tree(tree: Any) -> Any:
    """A tree with every DTensor leaf gathered whole (a collective: every
    rank calls it); plain tensors pass through."""
    from torch.distributed.tensor import DTensor

    return map_tree(lambda t: t.full_tensor() if isinstance(t, DTensor) else t,
                    tree)
