"""Checkpoint / resume for the SLAM engine state.

The port's own copy of ``lidar_feature_extraction_tpu/utils/checkpoint.py``
(which imports JAX only to flatten pytrees): named trees of tensors
(NamedTuples, tuples, lists, dicts) go to one ``.npz`` plus a small JSON
manifest. Leaves are numbered in JAX's ``tree_flatten`` order (fields and
items in order, dict keys sorted, None holding no leaf), so the two
packages name the arrays of a tree the same way.
"""

from __future__ import annotations

import json
import os
from typing import Any

import numpy as np
import torch


def _is_node(tree) -> bool:
    return isinstance(tree, (tuple, list, dict))


def tree_leaves(tree: Any) -> list:
    """The leaves of ``tree`` in JAX's flatten order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if _is_node(tree):
        return [x for item in tree for x in tree_leaves(item)]
    return [tree]


def tree_unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            out = {k: build(t[k]) for k in sorted(t)}
            return {k: out[k] for k in t}
        if hasattr(t, "_fields"):
            return type(t)(*[build(x) for x in t])
        if _is_node(t):
            return type(t)(build(x) for x in t)
        return next(it)

    return build(template)


def _np(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(path: str, _meta: dict | None = None,
                    **states: Any) -> None:
    """Save named trees. ``path`` is a .npz file; a sibling .json
    manifest records names and leaf counts, and ``_meta``, any
    JSON-serializable dict (the counts a resumer sizes its templates
    by, see ``load_meta``)."""
    arrays: dict = {}
    manifest: dict = {}
    for name, tree in states.items():
        leaves = tree_leaves(tree)
        for i, leaf in enumerate(leaves):
            arrays[f"{name}/{i}"] = _np(leaf)
        manifest[name] = {"n_leaves": len(leaves)}
    if _meta is not None:
        manifest["_meta"] = _meta
    np.savez_compressed(path, **arrays)
    with open(path + ".json", "w") as f:
        json.dump(manifest, f)


def load_meta(path: str) -> dict:
    """The ``_meta`` dict stored by ``save_checkpoint`` ({} if none)."""
    with open(path + ".json") as f:
        return json.load(f).get("_meta", {})


def load_checkpoint(path: str, **templates: Any) -> dict:
    """Load named trees. Each ``templates[name]`` gives the structure,
    the shapes and the device: every leaf comes back as a tensor with the
    stored dtype, on the template leaf's device (the CPU where the
    template leaf is not a tensor)."""
    with open(path + ".json") as f:
        manifest = json.load(f)
    out = {}
    with np.load(path) as data:
        for name, template in templates.items():
            if name not in manifest:
                raise KeyError(f"checkpoint has no state named {name!r}")
            leaves = tree_leaves(template)
            if len(leaves) != manifest[name]["n_leaves"]:
                raise ValueError(
                    f"{name}: template has {len(leaves)} leaves, checkpoint "
                    f"has {manifest[name]['n_leaves']}")
            new_leaves = []
            for i, leaf in enumerate(leaves):
                arr = data[f"{name}/{i}"]
                is_t = isinstance(leaf, torch.Tensor)
                shape = tuple(leaf.shape) if is_t else np.shape(leaf)
                if tuple(arr.shape) != tuple(shape):
                    raise ValueError(f"{name}[{i}]: shape {arr.shape} != "
                                     f"template {shape}")
                dev = leaf.device if is_t else "cpu"
                new_leaves.append(torch.as_tensor(arr, device=dev))
            out[name] = tree_unflatten(template, new_leaves)
    return out


def checkpoint_exists(path: str) -> bool:
    return os.path.exists(path) and os.path.exists(path + ".json")
