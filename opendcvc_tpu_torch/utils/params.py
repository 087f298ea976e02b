"""Weight bridge: JAX parameter trees <-> the port's tensors.

A JAX tree is nested dicts/lists of arrays (numpy or anything
`np.asarray` takes).  The port keeps the JAX key names; the only layout
change is the conv weight `w`, HWIO -> OIHW (a depthwise (k, k, 1, C)
weight becomes (C, 1, k, k) by the same transpose).  Every other leaf
(biases, QP banks, `bit_estimator_z`) copies over unchanged.  bfloat16
leaves (`ml_dtypes.bfloat16` arrays, which torch.from_numpy refuses) cross
bit for bit through their uint16 view, so no ml_dtypes import is needed.
`to_jax` is the inverse: numpy leaves, HWIO conv weights.
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


def _tensor(node):
    """A leaf (an array, or a tensor such as `utils/checkpoint.py`'s
    bfloat16 leaves) -> a tensor of the same dtype and bits."""
    if isinstance(node, torch.Tensor):
        return node
    a = np.ascontiguousarray(np.asarray(node))
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()) \
            .view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def from_jax(tree, device="cpu"):
    """Convert a JAX parameter tree to tensors on `device` with default
    strides, each leaf in its own dtype."""
    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        t = _tensor(node)
        if key == "w" and t.ndim == 4:
            t = t.permute(3, 2, 0, 1)
        return t.clone(memory_format=torch.contiguous_format).to(device)
    return conv(tree)


def _numpy(t):
    """A tensor -> a numpy array of its dtype and bits; a bfloat16 tensor
    becomes an ml_dtypes.bfloat16 array (the type JAX reads), from its
    uint16 bits."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy().copy()


def jax_layout(tree, leaf=lambda t: t):
    """The port's tree in the JAX package's layout: OIHW conv weights back
    to HWIO, each leaf a tensor passed through `leaf`."""
    def conv(node, key=None):
        if isinstance(node, dict):
            return {k: conv(v, k) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        t = _tensor(node)
        if key == "w" and t.ndim == 4:
            t = t.permute(2, 3, 1, 0)
        return leaf(t)
    return conv(tree)


def to_jax(tree):
    """The inverse of from_jax: the port's tensors -> a tree of numpy
    arrays, each of its leaf's dtype (bfloat16 bit for bit), OIHW conv
    weights back to HWIO; the keys and lists kept."""
    return jax_layout(tree, _numpy)


def cast_floating(tree, dtype):
    """Cast every float32 leaf to `dtype` (round to nearest even); other
    leaves stay as they are.  The JAX package's rule for a codec built
    with a dtype (its DMC and DMCI `init_params`)."""
    return tree_map(lambda t: t.to(dtype) if t.dtype == torch.float32
                    else t, tree)


def to_device(tree, device):
    return tree_map(lambda t: t.to(device), tree)
