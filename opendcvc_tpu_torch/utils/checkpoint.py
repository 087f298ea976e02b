"""Reader of the JAX package's checkpoints, without JAX, flax or msgpack.

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
tree with numpy leaves; `utils/params.py::from_jax` turns a params tree
into the port's tensors.  Malformed input raises ValueError.
"""

import struct

import numpy as np

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
    try:
        dtype = np.dtype(name)
    except TypeError as e:
        raise ValueError(f"leaf dtype {name!r} has no numpy type") from e
    if dtype.hasobject or int(np.prod(shape)) * dtype.itemsize != len(raw):
        raise ValueError(f"ndarray leaf of shape {shape} {name} holds "
                         f"{len(raw)} bytes")
    return np.frombuffer(raw, dtype=dtype).reshape(shape, order="C")


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
    if not all(isinstance(p, np.ndarray) and p.ndim == 1 for p in pieces):
        raise ValueError("a chunked leaf's chunks are not flat arrays")
    flat = np.concatenate(pieces)
    if flat.size != int(np.prod(shape)):
        raise ValueError(f"chunks of {flat.size} elements do not fill "
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
