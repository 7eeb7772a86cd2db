"""Parameters of the JAX reference, carried into the port.

The reference initialises with ``jax.random``, which torch cannot replay, so
a test that holds the port against the reference copies the parameters
across.  The port keeps the reference's tree: repeated units are stacked on
a leading layer axis as ``jax.vmap(unit_init)`` stacks them, and every leaf
keeps its shape.  So the two trees match path for path, with paths spelled
as ``jax.tree_util.keystr`` spells them, e.g. ``['units']['b0']['mixer']['wq']``.

This module does not import jax: the caller hands over numpy arrays
(``jax.tree.map(np.asarray, params)``).
"""
from __future__ import annotations

import numpy as np
import torch


def params_from_jax(tree, *, device="cpu"):
    """Nested dicts/lists of numpy arrays -> the same tree of tensors, each
    leaf keeping its dtype (numpy has no bfloat16: such leaves come over
    through f32)."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device=device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, device=device) for v in tree]
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(device,
                                                           torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True, order="C")).to(device)


def leaf_paths(tree, prefix=""):
    """``{keystr path: leaf}`` for a tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(leaf_paths(v, f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(leaf_paths(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}
