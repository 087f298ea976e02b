"""Weight bridge: JAX parameter trees -> the port's tensors.

A JAX tree is nested dicts/lists of arrays (numpy or anything
`np.asarray` takes).  The port keeps the JAX key names; the only layout
change is the conv weight `w`, HWIO -> OIHW (a depthwise (k, k, 1, C)
weight becomes (C, 1, k, k) by the same transpose).  Every other leaf
(biases, QP banks, `bit_estimator_z`) copies over unchanged.
"""

import numpy as np
import torch


def tree_map(fn, tree):
    """Apply fn to every leaf of a nested dict/list tree."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, v) for v in tree]
    return fn(tree)


def from_jax(tree, device="cpu"):
    """Convert a JAX parameter tree to float tensors on `device`."""
    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        a = np.asarray(node)
        if key == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        return torch.from_numpy(np.array(a, order="C")).to(device)
    return conv(tree)


def to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)
