"""The port's N-part entropy coder (`entropy/nparts.py`) against the JAX
package's, on the CPU.

Tables: DMCFM's (Laplace 256-level y rows, z rows of a seeded
BitEstimator(1, 64, support 50)).  Symbols from numpy (default_rng): y
planes of sizes no part count divides, symbols past every row's support
(escapes), and a z plane coded through the interleaved channel cycle.
The JAX coder runs its plain Python rANS (OPENDCVC_TPU_FORCE_PY_RANS),
which the JAX package's own tests hold byte-identical to its native
coder.  Held for stream_part 1, 2 and 3: the same bytes (u16 part sizes,
and u32 ones once a part passes 65535 bytes), each package decodes the
other's stream, threaded and unthreaded parts write the same bytes; a
stream of another part count, a truncated one or an out-of-range part
count raises ValueError.
"""

import numpy as np
import pytest
import torch

from opendcvc_tpu.entropy.nparts import NPartEntropyCoder as JNPart
from opendcvc_tpu_torch.entropy import models as PM
from opendcvc_tpu_torch.entropy.nparts import NPartEntropyCoder
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

PARTS = [1, 2, 3]
Y_SIZES = [1001, 517, 64]
Z_C, Z_N = 64, 64 * 6


def _tables():
    ge = PM.GaussianEncoder(distribution="laplace", scale_min=0.01,
                            scale_max=64.0, scale_levels=256, support=50)
    be = PM.BitEstimator(1, Z_C, support=50)
    gen = torch.Generator().manual_seed(4)
    return ge.update(), be.update(PM.bit_estimator_init(gen, 1, Z_C))


def _symbols(seed, sizes, spread):
    rng = np.random.default_rng(seed)
    ys = []
    for n in sizes:
        sym = np.clip(np.round(rng.laplace(0, spread, n)), -128, 127)
        idx = rng.integers(0, 256, n)
        ys.append((sym * 256 + idx).astype(np.int16))
    z = np.clip(np.round(rng.laplace(0, 3, Z_N)), -128, 127) \
        .astype(np.int8)
    return ys, z


def _coder(pkg, parts, threaded=None):
    if pkg == "port":
        return NPartEntropyCoder(parts, threaded=threaded)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        return JNPart(parts)


def _register(coder):
    y_rows, z_rows = _tables()
    assert coder.add_cdf(*y_rows, build_lut=True) == 0
    assert coder.add_cdf(*z_rows) == 1


def _encode(coder, ys, z):
    coder.reset()
    coder.encode_y(ys[0], 0)
    coder.encode_z(z, 1, 0, Z_C)
    for y in ys[1:]:
        coder.encode_y(y, 0)
    coder.flush()
    return coder.get_encoded_stream()


def _decode(coder, stream, ys):
    coder.set_stream(stream)

    def y_plane(y):
        coder.decode_y((y & 255).astype(np.uint8), 0)
        return coder.get_decoded_tensor()

    out = [y_plane(ys[0])]
    coder.decode_z(Z_N, 1, 0, Z_C)
    out.append(coder.get_decoded_tensor())
    out += [y_plane(y) for y in ys[1:]]
    return [np.asarray(v, np.int8) for v in out]


def _want(ys, z):
    return [(ys[0].astype(np.int32) >> 8).astype(np.int8), z] \
        + [(y.astype(np.int32) >> 8).astype(np.int8) for y in ys[1:]]


@pytest.fixture(scope="module", params=PARTS, ids=[f"{n}_parts"
                                                   for n in PARTS])
def run(request):
    parts = request.param
    ys, z = _symbols(parts, Y_SIZES, 4.0)
    coders = {pkg: _coder(pkg, parts) for pkg in ("port", "jax")}
    streams = {}
    for pkg, c in coders.items():
        _register(c)
        streams[pkg] = _encode(c, ys, z)
    return {"parts": parts, "ys": ys, "z": z, "coders": coders,
            "streams": streams}


def test_nparts_bytes_match_jax(run):
    s = run["streams"]["port"]
    assert s == run["streams"]["jax"]
    assert (s[0] >> 4) + 1 == run["parts"] and s[0] & 1


def test_nparts_each_decodes_the_other(run):
    want = _want(run["ys"], run["z"])
    for pkg, other in (("port", "jax"), ("jax", "port")):
        got = _decode(run["coders"][pkg], run["streams"][other], run["ys"])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w, err_msg=pkg)
    run["coders"]["port"].check_stream_end()


def test_nparts_threading_changes_no_byte(run):
    ys, z = run["ys"], run["z"]
    for threaded in (False, True):
        c = _coder("port", run["parts"], threaded=threaded)
        _register(c)
        assert _encode(c, ys, z) == run["streams"]["port"]


@pytest.mark.parametrize("parts", [2, 3])
def test_nparts_u32_part_sizes_match_jax(parts):
    """Symbols far past the rows' support (escapes of ~12 bits each): each
    part passes 65535 bytes, so the sizes are written as u32."""
    ys, z = _symbols(10 + parts, [60000 * parts], 60.0)
    streams = {}
    for pkg in ("port", "jax"):
        c = _coder(pkg, parts)
        _register(c)
        streams[pkg] = _encode(c, ys, z)
    s = streams["port"]
    assert s == streams["jax"]
    assert not s[0] & 1
    sizes = np.frombuffer(s[1:1 + 4 * (parts - 1)], "<u4")
    assert sizes.min() > 65535
    c = _coder("port", parts)
    _register(c)
    for g, w in zip(_decode(c, s, ys), _want(ys, z)):
        np.testing.assert_array_equal(g, w)
    c.check_stream_end()


def test_nparts_refuses_malformed_streams(run):
    parts, stream = run["parts"], run["streams"]["port"]
    other = NPartEntropyCoder(parts % 3 + 1)
    _register(other)
    with pytest.raises(ValueError, match="part"):
        other.set_stream(stream)
    c = NPartEntropyCoder(parts)
    _register(c)
    with pytest.raises(ValueError):
        c.set_stream(stream[:1 + 2 * (parts - 1)])
    with pytest.raises(ValueError):
        c.set_stream(b"")


def test_nparts_refuses_bad_part_counts():
    for n in (0, 17):
        with pytest.raises(ValueError):
            NPartEntropyCoder(n)
