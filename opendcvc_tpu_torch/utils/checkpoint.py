"""Reader and writer of the JAX package's checkpoints, without JAX, flax or
msgpack.

`opendcvc_tpu/utils/checkpoint.py::save_params` writes flax's msgpack
encoding of {"params": tree[, "extra": tree]}: nested maps and arrays of
numpy leaves.  flax packs each leaf as a msgpack ext type:
  * code 1, an ndarray: an inner msgpack array (shape, dtype name, raw
    C-order bytes);
  * code 2, a native complex: an inner msgpack array (real, imag);
  * code 3, a numpy scalar: an ndarray as code 1, read back as a scalar.
A leaf larger than flax's chunk size (2^30 bytes) arrives as a chunked map
{"__msgpack_chunked_array__": True, "shape": {"0": ...}, "chunks": {"0":
...}} of flat pieces, which this reader joins back into the array.

The reader carries its own decoder for the msgpack types flax writes
(maps, arrays, str, bin, ext, ints, floats, nil, bools) and returns the
tree with numpy leaves, except that a bfloat16 leaf, which numpy has no
type for without ml_dtypes, comes back as a torch.bfloat16 tensor read
bit for bit from its raw bytes; `utils/params.py::from_jax` turns a
params tree into the port's tensors.  Malformed input raises ValueError.

`save_params` writes the same layout from the port's tensors (conv
weights back to HWIO, `utils/params.py::jax_layout`), with its own encoder:
dict keys sorted as JAX's tree utilities sort them, every leaf an ndarray
ext (code 1), msgpack's smallest encoding of each object, so the JAX
package's `load_params` reads it and the bytes equal its `save_params`'s
for the same tree.

`save_train_state` / `load_train_state` write and read the JAX package's
full training state: {"params", "opt_state", "step" (int64), "extra"},
`opt_state` being flax's `to_state_dict` of the JAX optimizer's state
(optax 0.2.6): {"0": {} (the clip), "1": {"0": {"count": int32, "mu",
"nu"} (Adam), "1": {"count": int32} (the schedule)}[, "2": the
reduce-on-plateau state]}, with mu and nu in the params' layout and their
lists written as {"0": ..., "1": ...}.  The port's optimizer keeps its
moments over the trainable leaves only (`training/train.py`): a fixed
leaf's moments (a masked convolution's "mask") are written as zeros and
dropped on load, since the JAX package trains that leaf and the port does
not.  Each package resumes the other's state.
"""

import os
import struct

import numpy as np
import torch

from ..training.train import _trainable, tree_leaves, tree_unflatten
from .params import from_jax, jax_layout

_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Decodes one msgpack object after another from a bytes buffer."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n):
        if n < 0 or self.pos + n > len(self.buf):
            raise ValueError("msgpack data ends inside an object")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def obj(self):
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return self.array(t & 0x0F)
        if 0xA0 <= t <= 0xBF:
            return self.str(t & 0x1F)
        if t in _FIXED:
            kind, arg = _FIXED[t]
            return getattr(self, kind)(arg)
        raise ValueError(f"msgpack type byte 0x{t:02x} is not one flax "
                         f"writes")

    # -- the type families ---------------------------------------------------

    def const(self, value):
        return value

    def num(self, fmt):
        return self.unpack(fmt)

    def str(self, n):
        return str(self.take(n if isinstance(n, int) else self.unpack(n)),
                   "utf-8")

    def bin(self, fmt):
        return bytes(self.take(self.unpack(fmt)))

    def array(self, n):
        n = n if isinstance(n, int) else self.unpack(n)
        return [self.obj() for _ in range(n)]

    def map(self, n):
        n = n if isinstance(n, int) else self.unpack(n)
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out

    def ext(self, size):
        n = size if isinstance(size, int) else self.unpack(size)
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))


# type byte -> (family, its length or struct format)
_FIXED = {
    0xC0: ("const", None), 0xC2: ("const", False), 0xC3: ("const", True),
    0xC4: ("bin", ">B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
    0xC7: ("ext", ">B"), 0xC8: ("ext", ">H"), 0xC9: ("ext", ">I"),
    0xCA: ("num", ">f"), 0xCB: ("num", ">d"),
    0xCC: ("num", ">B"), 0xCD: ("num", ">H"), 0xCE: ("num", ">I"),
    0xCF: ("num", ">Q"),
    0xD0: ("num", ">b"), 0xD1: ("num", ">h"), 0xD2: ("num", ">i"),
    0xD3: ("num", ">q"),
    0xD4: ("ext", 1), 0xD5: ("ext", 2), 0xD6: ("ext", 4), 0xD7: ("ext", 8),
    0xD8: ("ext", 16),
    0xD9: ("str", ">B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
    0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
    0xDE: ("map", ">H"), 0xDF: ("map", ">I"),
}


def unpackb(data):
    """Decode one msgpack object that fills `data` exactly."""
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"{len(r.buf) - r.pos} bytes after the msgpack "
                         f"object")
    return out


def _ndarray(data):
    """flax's ndarray encoding: msgpack (shape, dtype name, bytes)."""
    parts = unpackb(data)
    if not (isinstance(parts, list) and len(parts) == 3):
        raise ValueError("an ndarray leaf is not (shape, dtype, bytes)")
    shape, name, raw = parts
    name = name if isinstance(name, str) else bytes(name).decode()
    bf16 = name == "bfloat16"
    try:
        dtype = np.dtype(np.uint16 if bf16 else name)
    except TypeError as e:
        raise ValueError(f"leaf dtype {name!r} has no numpy type") from e
    if dtype.hasobject or int(np.prod(shape)) * dtype.itemsize != len(raw):
        raise ValueError(f"ndarray leaf of shape {shape} {name} holds "
                         f"{len(raw)} bytes")
    a = np.frombuffer(raw, dtype=dtype).reshape(shape, order="C")
    if bf16:
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    return a


def _ext(code, data):
    if code == 1:
        return _ndarray(data)
    if code == 2:
        re, im = unpackb(data)
        return complex(re, im)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"msgpack ext type {code} is not one flax writes")


def _unchunk(node):
    """Join a chunked leaf's flat pieces (flax's `_unchunk`)."""
    shape, chunks = node.get("shape"), node.get("chunks")
    if not (isinstance(shape, dict) and isinstance(chunks, dict)):
        raise ValueError("a chunked leaf lacks its shape or chunks")
    try:
        shape = tuple(shape[str(i)] for i in range(len(shape)))
        pieces = [chunks[str(i)] for i in range(len(chunks))]
    except KeyError as e:
        raise ValueError(f"a chunked leaf is missing entry {e}") from e
    if not all(isinstance(p, (np.ndarray, torch.Tensor)) and p.ndim == 1
               for p in pieces):
        raise ValueError("a chunked leaf's chunks are not flat arrays")
    tensors = [isinstance(p, torch.Tensor) for p in pieces]
    if any(tensors) and not all(tensors):
        raise ValueError("a chunked leaf's chunks differ in dtype")
    flat = torch.cat(pieces) if all(tensors) else np.concatenate(pieces)
    if flat.shape[0] != int(np.prod(shape)):
        raise ValueError(f"chunks of {flat.shape[0]} elements do not fill "
                         f"shape {shape}")
    return flat.reshape(shape)


def _restore(node):
    if isinstance(node, dict):
        if _CHUNKED in node:
            return _unchunk(node)
        return {k: _restore(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_restore(v) for v in node]
    return node


def load_checkpoint(path):
    """The whole payload ({"params": ..., and "extra" when saved})."""
    with open(path, "rb") as f:
        return _restore(unpackb(f.read()))


def load_params(path):
    """The params tree of a checkpoint (or the payload, when it has no
    "params" entry), as the JAX package's `load_params` returns it."""
    payload = load_checkpoint(path)
    if isinstance(payload, dict) and "params" in payload:
        return payload["params"]
    return payload


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_MAX_LEAF_BYTES = 1 << 30       # flax chunks larger leaves; none is here


def _head(n, fix, fix_max, wide):
    """A length-prefixed type head: fix | n up to fix_max, else the first
    of `wide` ((type byte, struct format, max n)) that holds n."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for byte, fmt, top in wide:
        if n <= top:
            return bytes([byte]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _pack_int(v):
    if 0 <= v < 0x80:
        return bytes([v])
    if v >= 0:
        for byte, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                               (0xCE, ">I", 0xFFFFFFFF)):
            if v <= top:
                return bytes([byte]) + struct.pack(fmt, v)
        return b"\xcf" + struct.pack(">Q", v)
    if v >= -32:
        return struct.pack(">b", v)
    for byte, fmt, lo in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                          (0xD2, ">i", -0x80000000)):
        if v >= lo:
            return bytes([byte]) + struct.pack(fmt, v)
    return b"\xd3" + struct.pack(">q", v)


def _pack_str(v):
    raw = v.encode()
    return _head(len(raw), 0xA0, 31, ((0xD9, ">B", 0xFF),
                                      (0xDA, ">H", 0xFFFF),
                                      (0xDB, ">I", 0xFFFFFFFF))) + raw


_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _ndarray_parts(a):
    """flax's ndarray ext, code 1 over msgpack (shape, dtype name, raw
    C-order bytes), as [its header, the raw bytes (a view)]."""
    if isinstance(a, torch.Tensor):        # a bfloat16 leaf
        shape, name = tuple(a.shape), "bfloat16"
        a = a.detach().cpu().contiguous().view(torch.int16).numpy()
    else:
        a = np.asarray(a)
        if a.dtype.hasobject:
            raise ValueError("object arrays have no checkpoint encoding")
        shape, name = a.shape, a.dtype.name
    raw = memoryview(np.ascontiguousarray(a)).cast("B")
    if raw.nbytes > _MAX_LEAF_BYTES:
        raise ValueError(f"a leaf of {raw.nbytes} bytes needs flax's "
                         f"chunked layout, which this writer does not "
                         f"write")
    inner = _head(3, 0x90, 15, ()) + _head(len(shape), 0x90, 15, (
        (0xDC, ">H", 0xFFFF), (0xDD, ">I", 0xFFFFFFFF))) \
        + b"".join(_pack_int(int(d)) for d in shape) + _pack_str(name) \
        + _head(raw.nbytes, None, 0, ((0xC4, ">B", 0xFF),
                                      (0xC5, ">H", 0xFFFF),
                                      (0xC6, ">I", 0xFFFFFFFF)))
    n = len(inner) + raw.nbytes
    head = bytes([_FIXEXT[n]]) if n in _FIXEXT else _head(
        n, None, 0, ((0xC7, ">B", 0xFF), (0xC8, ">H", 0xFFFF),
                     (0xC9, ">I", 0xFFFFFFFF)))
    return [head + struct.pack(">b", 1) + inner, raw]


def _pack_into(node, out):
    """Append the encoding of `node` to the list `out`, piece by piece (a
    leaf's raw bytes as a view, so a large tree is never copied whole)."""
    if isinstance(node, dict):
        out.append(_head(len(node), 0x80, 15, ((0xDE, ">H", 0xFFFF),
                                               (0xDF, ">I", 0xFFFFFFFF))))
        for k in sorted(node):
            out.append(_pack_str(k))
            _pack_into(node[k], out)
    elif isinstance(node, (list, tuple)):
        out.append(_head(len(node), 0x90, 15, ((0xDC, ">H", 0xFFFF),
                                               (0xDD, ">I", 0xFFFFFFFF))))
        for v in node:
            _pack_into(v, out)
    else:
        out.extend(_ndarray_parts(node))


def packb(node):
    """Encode a tree of dicts (str keys, sorted), lists and array leaves
    as flax's msgpack_serialize does."""
    out = []
    _pack_into(node, out)
    return b"".join(out)


def _write(path, payload):
    """Encode `payload` into a temporary file beside `path`, then rename
    it into place."""
    out = []
    _pack_into(payload, out)
    tmp = path + ".tmp"
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(tmp, "wb") as f:
        f.writelines(out)
    os.replace(tmp, path)


def _leaves_as_arrays(tree):
    """Every leaf as an ndarray (python and numpy scalars as 0-d arrays,
    as the JAX package's save_params turns them), bfloat16 tensors as
    they are."""
    if isinstance(tree, dict):
        return {k: _leaves_as_arrays(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_leaves_as_arrays(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree if tree.dtype == torch.bfloat16 else \
            tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_params(path, params, extra=None):
    """Write the port's params tree (and an optional `extra` dict of
    scalars or arrays, e.g. {"step": n}) as the JAX package's
    `save_params` writes a checkpoint: conv weights HWIO, flax's msgpack
    layout, written to a temporary file and renamed into place."""
    payload = {"params": _leaves_as_arrays(jax_layout(params))}
    if extra is not None:
        payload["extra"] = _leaves_as_arrays(extra)
    _write(path, payload)


# ---------------------------------------------------------------------------
# full training state
# ---------------------------------------------------------------------------

def _state_dict(tree):
    """flax's to_state_dict of a params-shaped tree: each list becomes a
    dict keyed "0", "1", ..."""
    if isinstance(tree, dict):
        return {k: _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def _from_state_dict(like, node, path="opt_state"):
    """The inverse of _state_dict on the structure of `like`, its dict keys
    in like's order; a node that does not fit raises ValueError."""
    if isinstance(like, (dict, list, tuple)):
        keys = list(like) if isinstance(like, dict) else \
            [str(i) for i in range(len(like))]
        if not isinstance(node, dict) or set(node) != set(keys):
            raise ValueError(f"{path} does not have the parameters' layout")
        out = [_from_state_dict(v, node[k], f"{path}/{k}")
               for k, v in zip(keys, like.values() if isinstance(like, dict)
                               else like)]
        return dict(zip(keys, out)) if isinstance(like, dict) else out
    return node


def _moments_tree(params, moments):
    """The trainable leaves' moments as a tree shaped as `params`, a fixed
    leaf's zeros."""
    it = iter(moments)
    return tree_unflatten(params, [
        next(it) if keep else torch.zeros_like(t)
        for t, keep in zip(tree_leaves(params), _trainable(params))])


def save_train_state(path, params, opt_state, step, extra=None):
    """Write params, the optimizer state (`Optimizer.init`'s dict, over
    trainable_leaves(params)) and the step as the JAX package's
    `save_train_state` writes them: equal arrays give equal bytes."""
    count = np.asarray(opt_state["count"], np.int32)
    adam = {"count": count}
    for k in ("mu", "nu"):
        adam[k] = _state_dict(jax_layout(_moments_tree(params,
                                                       opt_state[k])))
    state = {"0": {}, "1": {"0": adam, "1": {"count": count}}}
    if "plateau" in opt_state:
        state["2"] = dict(opt_state["plateau"])
    payload = {"params": _leaves_as_arrays(jax_layout(params)),
               "opt_state": _leaves_as_arrays(state),
               "step": np.asarray(step, np.int64)}
    if extra is not None:
        payload["extra"] = _leaves_as_arrays(extra)
    _write(path, payload)


def load_train_state(path, params_like, opt_state_template):
    """(params, opt_state, step, extra) of a file save_train_state wrote
    (by either package).  params_like: the run's parameter tree, whose
    structure, key order and device the loaded params take (so the leaves
    come back in the order the run's optimizer state has them);
    opt_state_template: `tx.init(trainable_leaves(params_like))` of the
    same optimizer, which says whether a plateau state is expected.  A
    params-only checkpoint, or a state of another layout, raises
    ValueError."""
    payload = load_checkpoint(path)
    if "opt_state" not in payload:
        raise ValueError(f"{path} is a params-only checkpoint; use "
                         f"load_checkpoint/load_params")
    device = tree_leaves(params_like)[0].device
    params = from_jax(_from_state_dict(params_like, _state_dict(
        payload["params"]), "params"), device)
    st = payload["opt_state"]
    want = {"0", "1", "2"} if "plateau" in opt_state_template else {"0", "1"}
    if not isinstance(st, dict) or set(st) != want:
        raise ValueError(f"{path}: the optimizer state's parts "
                         f"{sorted(st) if isinstance(st, dict) else st} are "
                         f"not this optimizer's {sorted(want)}")
    adam = st["1"]["0"]
    keep = _trainable(params)
    opt_state = {"count": int(adam["count"])}
    for k in ("mu", "nu"):
        full = tree_leaves(from_jax(_from_state_dict(params_like, adam[k],
                                                     f"opt_state/{k}"),
                                    device))
        opt_state[k] = [t for t, kept in zip(full, keep) if kept]
    if "2" in st:
        tmpl = opt_state_template["plateau"]
        if set(st["2"]) != set(tmpl):
            raise ValueError(f"{path}: the plateau state has keys "
                             f"{sorted(st['2'])}")
        opt_state["plateau"] = {
            k: torch.tensor(np.array(st["2"][k]), dtype=tmpl[k].dtype,
                               device=device) for k in tmpl}
    return params, opt_state, int(payload["step"]), payload.get("extra")


def _same(saved, want):
    if isinstance(want, dict):
        return isinstance(saved, dict) and set(saved) == set(want) and \
            all(_same(saved[k], v) for k, v in want.items())
    if isinstance(want, (list, tuple)):
        return isinstance(saved, (list, tuple)) and \
            len(saved) == len(want) and \
            all(_same(a, b) for a, b in zip(saved, want))
    a, b = np.asarray(saved), np.asarray(want)
    return a.shape == b.shape and bool(np.all(a == b))


def check_train_extra(path, saved, want):
    """Raise ValueError unless the `extra` saved with a train state holds
    every entry of `want` (the resuming run's settings) with equal
    values."""
    if not isinstance(saved, dict):
        raise ValueError(f"{path} carries no run settings to resume "
                         f"against")
    for k, v in want.items():
        if k not in saved or not _same(saved[k], v):
            raise ValueError(f"{path} was saved by another run: its {k} "
                             f"is {saved.get(k)!r}, this run's {v!r}")
