"""The harness slice's utilities in the port against the JAX package's.

  * transforms: `ycbcr420_to_444_np` exactly; the torch `rgb2ycbcr`,
    `ycbcr2rgb`, `yuv_444_to_420` within TRANSFORM_ATOL of the jnp ones
    (float32 on both sides, the same operation order; only the backends'
    rounding of single ops may differ);
  * the PNG and YUV420 readers and writers, array for array and byte for
    byte;
  * `calc_psnr`, `calc_msssim`, `calc_msssim_rgb`, `generate_log_json`
    and `dump_json`, equal;
  * the JAX-free checkpoint reader returns exactly the tree of the JAX
    package's `load_checkpoint` / `load_params` on the committed
    `docs/dmci_tiny_rd.msgpack` and on small trees that `save_params` and
    flax wrote (float, int and scalar leaves, complex, chunked leaves);
    its msgpack decoder agrees with the `msgpack` package on every type
    flax writes; malformed input raises ValueError.
"""

import io
import os

import flax.serialization as flax_ser
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu.utils import common as JC
from opendcvc_tpu.utils import io as JIO
from opendcvc_tpu.utils import metrics as JM
from opendcvc_tpu.utils import transforms as JT
from opendcvc_tpu_torch.utils import checkpoint as PCK
from opendcvc_tpu_torch.utils import common as PC
from opendcvc_tpu_torch.utils import io as PIO
from opendcvc_tpu_torch.utils import metrics as PM
from opendcvc_tpu_torch.utils import transforms as PT
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

TINY_CKPT = os.path.join(os.path.dirname(__file__), os.pardir, "docs",
                         "dmci_tiny_rd.msgpack")
# float32 results of the same ops in the same order; a single op's
# rounding may differ between XLA and torch by an ulp of values <= ~2
TRANSFORM_ATOL = 1e-6


def _rng(seed=0):
    return np.random.default_rng(seed)


# ---------------------------------------------------------------------------
# transforms
# ---------------------------------------------------------------------------

def test_ycbcr420_to_444_np_exact():
    rng = _rng(1)
    y = rng.random((1, 32, 48), dtype=np.float32)
    uv = rng.random((2, 16, 24), dtype=np.float32)
    for order in (0, 1):
        np.testing.assert_array_equal(PT.ycbcr420_to_444_np(y, uv, order),
                                      JT.ycbcr420_to_444_np(y, uv, order))


@pytest.mark.parametrize("fn", ["rgb2ycbcr", "ycbcr2rgb", "ycbcr2rgb_raw",
                                "yuv_444_to_420"])
def test_torch_transforms_match_jnp(fn):
    x = _rng(2).random((2, 16, 24, 3), dtype=np.float32)
    if fn == "ycbcr2rgb_raw":
        got = PT.ycbcr2rgb(torch.from_numpy(x), clamp=False)
        want = JT.ycbcr2rgb(jnp.asarray(x), clamp=False)
    else:
        got = getattr(PT, fn)(torch.from_numpy(x))
        want = getattr(JT, fn)(jnp.asarray(x))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=TRANSFORM_ATOL)


# ---------------------------------------------------------------------------
# readers and writers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("naming", ["im1", "im00001"])
def test_png_reader_and_writer_match(tmp_path, naming):
    from PIL import Image
    frames = [_rng(t).integers(0, 256, (20, 28, 3)).astype(np.uint8)
              for t in range(3)]
    for t, f in enumerate(frames):
        name = f"im{t + 1}.png" if naming == "im1" else f"im{t + 1:05d}.png"
        Image.fromarray(f).save(tmp_path / name)
    readers = (JIO.PNGReader(str(tmp_path), 28, 20),
               PIO.PNGReader(str(tmp_path), 28, 20))
    for t in range(4):
        a, b = (r.read_one_frame() for r in readers)
        if t == 3:
            assert a is None and b is None
            continue
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(b, frames[t].transpose(2, 0, 1))
    for tag, mod in (("jax", JIO), ("port", PIO)):
        w = mod.PNGWriter(str(tmp_path / tag), 28, 20)
        for f in frames:
            w.write_one_frame(f.transpose(2, 0, 1))
        w.close()
    for t in range(3):
        name = f"im{t + 1:05d}.png"
        assert (tmp_path / "port" / name).read_bytes() == \
            (tmp_path / "jax" / name).read_bytes()


def test_yuv420_reader_and_writer_match(tmp_path):
    h, w, n = 20, 28, 3
    raw = _rng(3).integers(0, 256, n * h * w * 3 // 2).astype(np.uint8)
    raw.tofile(tmp_path / "seq.yuv")
    for skip in (0, 1):
        readers = (JIO.YUV420Reader(str(tmp_path / "seq"), w, h, skip),
                   PIO.YUV420Reader(str(tmp_path / "seq.yuv"), w, h, skip))
        for _ in range(n + 1 - skip):
            (jy, juv), (py, puv) = (r.read_one_frame() for r in readers)
            if jy is None:
                assert py is None and puv is None
                continue
            np.testing.assert_array_equal(py, jy)
            np.testing.assert_array_equal(puv, juv)
        for r in readers:
            r.close()
    for tag, mod in (("jax", JIO), ("port", PIO)):
        wr = mod.YUV420Writer(str(tmp_path / f"{tag}.yuv"), w, h)
        rd = mod.YUV420Reader(str(tmp_path / "seq.yuv"), w, h)
        for _ in range(n):
            wr.write_one_frame(*rd.read_one_frame())
        wr.close()
        rd.close()
    assert (tmp_path / "port.yuv").read_bytes() == \
        (tmp_path / "jax.yuv").read_bytes() == raw.tobytes()


def test_png_reader_refuses_a_wrong_size(tmp_path):
    from PIL import Image
    Image.fromarray(np.zeros((8, 8, 3), np.uint8)).save(tmp_path / "im1.png")
    with pytest.raises(ValueError, match="not 16x8"):
        PIO.PNGReader(str(tmp_path), 16, 8).read_one_frame()


# ---------------------------------------------------------------------------
# metrics and logs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [(96, 120), (180, 200)],
                         ids=["four_levels", "five_levels"])
def test_metrics_match(size):
    rng = _rng(4)
    a = rng.integers(0, 256, size).astype(np.uint8)
    b = np.clip(a + rng.normal(0, 6, size), 0, 255).astype(np.float32)
    assert PM.calc_psnr(a, b) == JM.calc_psnr(a, b)
    assert PM.calc_psnr(a, a) == JM.calc_psnr(a, a) == 99.9
    assert PM.calc_msssim(a, b) == JM.calc_msssim(a, b)
    a3 = np.stack([a, a[::-1], a[:, ::-1]])
    b3 = np.stack([b, b[::-1], b[:, ::-1]])
    assert PM.calc_msssim_rgb(a3, b3) == JM.calc_msssim_rgb(a3, b3)


def test_msssim_refuses_small_frames():
    with pytest.raises(ValueError, match="88x88"):
        PM.calc_msssim(np.zeros((64, 96)), np.zeros((64, 96)))


@pytest.mark.parametrize("yuv", [False, True], ids=["rgb", "yuv"])
@pytest.mark.parametrize("verbose", [False, True], ids=["short", "verbose"])
def test_log_json_and_dump_match(yuv, verbose):
    rng = _rng(5)
    n = 5
    width = 4 if yuv else 1
    psnrs = [list(rng.random(width) * 40) for _ in range(n)]
    ssims = [list(rng.random(width)) for _ in range(n)]
    args = (n, 3072, 1.25, [0, 1, 1, 0, 1], [float(b) for b in
                                                rng.integers(100, 9000, n)],
            psnrs, ssims)
    kw = {"verbose": verbose, "avg_encoding_time": 0.5,
          "avg_decoding_time": 0.25}
    logs = [mod.generate_log_json(*args, **kw) for mod in (JC, PC)]
    assert logs[1] == logs[0] and list(logs[1]) == list(logs[0])
    dumps = []
    for mod in (JC, PC):
        buf = io.StringIO()
        mod.dump_json({"a": logs[0]}, buf, float_digits=6, indent=2)
        dumps.append(buf.getvalue())
    assert dumps[1] == dumps[0]


def test_flags_match(monkeypatch):
    for v in ("1", "true", "Yes", "0", "false", "no", "", "x"):
        assert PC.str2bool(v) == JC.str2bool(v)
        monkeypatch.setenv("OPENDCVC_TPU_DEVICE_EC", v)
        assert PC.env_flag("OPENDCVC_TPU_DEVICE_EC") == \
            JC.env_flag("OPENDCVC_TPU_DEVICE_EC")
    monkeypatch.delenv("OPENDCVC_TPU_DEVICE_EC")
    assert PC.env_flag("OPENDCVC_TPU_DEVICE_EC", True) is True


# ---------------------------------------------------------------------------
# the checkpoint reader
# ---------------------------------------------------------------------------

def _same_tree(got, want, path="root"):
    """Same structure, key order, leaf types, dtypes, shapes and bytes."""
    assert type(got) is type(want), path
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            _same_tree(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert got == want, path


def _n_leaves(tree):
    if isinstance(tree, dict):
        return sum(_n_leaves(v) for v in tree.values())
    if isinstance(tree, list):
        return sum(_n_leaves(v) for v in tree)
    return 1


def test_reader_matches_jax_on_the_committed_checkpoint():
    want = JCK.load_params(TINY_CKPT)
    got = PCK.load_params(TINY_CKPT)
    _same_tree(got, want)
    assert _n_leaves(got) > 300
    _same_tree(PCK.load_checkpoint(TINY_CKPT),
               JCK.load_checkpoint(TINY_CKPT))
    # the weight bridge takes the reader's tree as it takes the JAX one's
    a, b = from_jax(got), from_jax(want)
    assert torch.equal(a["enc_down"]["w"], b["enc_down"]["w"])
    assert a["enc_down"]["w"].shape[0] == 96


def test_reader_on_a_tree_save_params_wrote(tmp_path):
    tree = {"f32": jnp.arange(12, dtype=jnp.float32).reshape(3, 4) / 7,
            "i32": jnp.array([-5, 0, 7], jnp.int32),
            "u8": np.arange(6, dtype=np.uint8).reshape(2, 3),
            "f64": np.linspace(-1, 1, 5),
            "zero_d": np.float32(2.5), "int_scalar": np.int64(-3),
            "empty": np.zeros((0, 4), np.float32),
            "nested": [{"w": np.ones((1, 1, 2, 2), np.float32)},
                       {"b": np.array([True, False])}]}
    path = str(tmp_path / "t.msgpack")
    JCK.save_params(path, tree, extra={"step": np.int32(9)})
    _same_tree(PCK.load_params(path), JCK.load_params(path))
    _same_tree(PCK.load_checkpoint(path), JCK.load_checkpoint(path))


def test_reader_on_flax_scalars_complex_and_chunks(tmp_path, monkeypatch):
    """Leaves save_params never writes but flax's encoding has: numpy
    scalars (ext 3), complex (ext 2), Python values, and leaves over the
    chunk size (made small here), joined back as flax joins them."""
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)
    tree = {"scalar": np.float64(1.5), "iscalar": np.int16(-7),
            "cplx": complex(1.25, -2.0), "none": None, "flag": True,
            "text": "tiny", "num": 3, "neg": -40000, "real": 0.1,
            "big": np.arange(100, dtype=np.float32).reshape(4, 25),
            "deep": {"big_i": np.arange(40, dtype=np.int64)},
            "small": np.arange(3, dtype=np.float32)}
    data = flax_ser.msgpack_serialize(tree)
    raw = msgpack.unpackb(data, raw=False, strict_map_key=False,
                          ext_hook=lambda c, d: msgpack.ExtType(c, d))
    assert "__msgpack_chunked_array__" in raw["big"]
    (tmp_path / "c.msgpack").write_bytes(data)
    got = PCK.load_checkpoint(str(tmp_path / "c.msgpack"))
    _same_tree(got, flax_ser.msgpack_restore(data))
    assert got["big"].shape == (4, 25) and got["cplx"] == complex(1.25, -2)


def test_msgpack_decoder_matches_msgpack():
    """Every type family and width flax's encoder can write."""
    objs = [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32, 2 ** 63 + 5, -1,
            -32, -33, -128, -129, -32768, -32769, -2 ** 31 - 1, -2 ** 63,
            0.5, -1e300, None, True, False, "", "a" * 31, "b" * 32,
            "c" * 300, "é" * 40000, b"", b"x" * 300, b"y" * 70000,
            list(range(15)), list(range(16)), list(range(70000)),
            {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
            {str(i): [i] for i in range(70000)}, {"k": {"n": [1, [2, {}]]}}]
    for obj in objs:
        data = msgpack.packb(obj, use_bin_type=True)
        assert PCK.unpackb(data) == msgpack.unpackb(data, raw=False), \
            repr(obj)[:40]
    for obj in (1.5, -0.25):
        data = msgpack.packb(obj, use_single_float=True)
        assert data[0] == 0xCA and PCK.unpackb(data) == obj
    for n in (1, 2, 4, 8, 16, 3, 300, 70000):     # fixext and ext 8/16/32
        with pytest.raises(ValueError, match="ext type 9"):
            PCK.unpackb(msgpack.packb(msgpack.ExtType(9, b"z" * n)))


@pytest.mark.parametrize("case", ["truncated", "trailing", "type_byte",
                                  "leaf_bytes", "dtype", "ext_code",
                                  "chunk_missing"])
def test_reader_refuses_malformed_input(case):
    leaf = flax_ser._ndarray_to_bytes(np.arange(4, dtype=np.float32))
    good = msgpack.packb({"a": msgpack.ExtType(1, leaf)}, use_bin_type=True)
    bad = {
        "truncated": good[:-3],
        "trailing": good + b"\x00",
        "type_byte": b"\xc1",
        "leaf_bytes": msgpack.packb(msgpack.ExtType(1, msgpack.packb(
            ((5,), "float32", b"\x00" * 16), use_bin_type=True))),
        "dtype": msgpack.packb(msgpack.ExtType(1, msgpack.packb(
            ((1,), "bfloat17", b"\x00\x00"), use_bin_type=True))),
        "ext_code": msgpack.packb(msgpack.ExtType(4, b"\x00")),
        "chunk_missing": msgpack.packb(
            {"__msgpack_chunked_array__": True, "shape": {"0": 4},
             "chunks": {"1": msgpack.ExtType(1, leaf)}}, use_bin_type=True),
    }[case]
    with pytest.raises(ValueError):
        PCK._restore(PCK.unpackb(bad))
