"""Host-EC byte parity on trained weights.

The committed `docs/dmci_tiny_rd.msgpack` (a trained DMCI with the JAX
package's reduced widths, `eval/rd_evidence.py::TINY_KW`) is read by the
port's JAX-free reader into the port's DMCI and by the JAX package's
reader into its own.  A smooth seeded image (low-frequency sinusoids, no
noise) at 64x64 and 128x128 is coded at qp 20 and 40 (rd_evidence's
points) through host EC, one coder.  Held: the two streams are equal, the
port decodes its own stream exactly, and each package decodes the other's
stream (the port exactly, the JAX package within the codecs' 1e-4 float
agreement).  Printed: how many z and y values lie, before rounding, within
that agreement of a rounding boundary (k + 1/2), where the two packages'
floats could round to different symbols.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from opendcvc_tpu.eval.rd_evidence import TINY_KW
from opendcvc_tpu.models import dmci as JDMCI
from opendcvc_tpu.utils import checkpoint as JCK
from opendcvc_tpu_torch.models import common as C
from opendcvc_tpu_torch.models import dmci as PDMCI
from opendcvc_tpu_torch.ops import fused as F
from opendcvc_tpu_torch.utils import checkpoint as PCK
from opendcvc_tpu_torch.utils.params import from_jax
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

TINY_CKPT = os.path.join(os.path.dirname(__file__), os.pardir, "docs",
                         "dmci_tiny_rd.msgpack")
CASES = [(64, 20), (64, 40), (128, 20), (128, 40)]
# the codecs' float agreement (test_torch_port_codec, _host_ec)
REL_TOL = 1e-4


def _image(size, seed=0):
    """(1, size, size, 3) float32 in [0.1, 0.9]: three low-frequency
    sinusoids a channel."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:size, 0:size] / size
    chans = []
    for _ in range(3):
        f = rng.uniform(0.5, 3.0, (3, 2))
        ph = rng.uniform(0, 2 * np.pi, 3)
        c = sum(np.sin(2 * np.pi * (a * xx + b * yy) + p)
                for (a, b), p in zip(f, ph))
        chans.append((c - c.min()) / (c.max() - c.min()))
    return (0.1 + 0.8 * np.stack(chans, -1))[None].astype(np.float32)


@pytest.fixture(scope="module")
def codecs():
    with pytest.MonkeyPatch.context() as mp:
        mp.delenv("OPENDCVC_TPU_DEVICE_EC", raising=False)
        mp.setenv("OPENDCVC_TPU_FORCE_PY_RANS", "1")
        jax_net = JDMCI.DMCI(**TINY_KW)
        jax_net.load_params(JCK.load_params(TINY_CKPT))
        jax_net.update()
    port_net = PDMCI.DMCI(device="cpu", **TINY_KW)
    port_net.load_params(from_jax(PCK.load_params(TINY_CKPT)))
    port_net.update()
    return jax_net, port_net


def _near_boundary(v):
    """Values within REL_TOL * max|v| of a rounding boundary k + 1/2."""
    v = v.double()
    tol = REL_TOL * float(v.abs().max())
    return int(((v - torch.floor(v) - 0.5).abs() < tol).sum())


def _boundary_counts(p, x, qp):
    """(z, y) values near a rounding boundary in the port's encoder."""
    y = PDMCI.intra_encoder(p, x, C.q_vec(p["q_scale_enc"], qp))
    z = PDMCI.hyper_encoder(p, C.pad_for_y(y))
    z_hat, _ = F.round_and_to_int8(z)
    q_enc, _, scales, means, reduced = PDMCI._stage_prior(
        p, z_hat, y.shape[2], y.shape[3])
    y_s = y * q_enc
    n_y, so_far = 0, None
    for k in range(4):
        if k > 0:
            scales, means = PDMCI._stage_spatial(p, k, so_far, reduced)
        mask = PDMCI._masks_4x(y_s)[k]
        y_res, _, y_hat_k, _ = F.process_with_mask(y_s, scales, means, mask)
        n_y += _near_boundary(y_res[mask.expand_as(y_res) > 0])
        so_far = y_hat_k if so_far is None else so_far + y_hat_k
    return _near_boundary(z), n_y


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{s}px_qp{q}" for s, q in CASES])
def coded(request, codecs):
    size, qp = request.param
    jax_net, port_net = codecs
    x = _image(size)
    sps = {"height": size, "width": size, "ec_part": 0}
    j_enc = jax_net.compress(jnp.asarray(x), qp)
    p_enc = port_net.compress(x, qp)
    with torch.no_grad():
        n_z, n_y = _boundary_counts(port_net.params,
                                    C.frame_to_nchw(x, "cpu"), qp)
    print(f"\n{size}x{size} qp {qp}: {len(p_enc['bit_stream'])} B; z values "
          f"near a rounding boundary {n_z}, y values {n_y}")
    return {"jax": j_enc["bit_stream"], "port": p_enc["bit_stream"],
            "port_x": p_enc["x_hat"].numpy(),
            "port_own": port_net.decompress(p_enc["bit_stream"], sps,
                                            qp)["x_hat"].numpy(),
            "port_of_jax": port_net.decompress(j_enc["bit_stream"], sps,
                                               qp)["x_hat"].numpy(),
            "jax_of_port": np.asarray(jax_net.decompress(
                p_enc["bit_stream"], sps, qp)["x_hat"]),
            "near": (n_z, n_y)}


def test_trained_streams_byte_identical(coded):
    assert coded["port"] == coded["jax"], \
        f"values near a rounding boundary (z, y): {coded['near']}"


def test_trained_streams_cross_decode(coded):
    np.testing.assert_array_equal(coded["port_own"], coded["port_x"])
    np.testing.assert_array_equal(coded["port_of_jax"], coded["port_x"])
    np.testing.assert_allclose(coded["jax_of_port"], coded["port_x"],
                               rtol=0, atol=REL_TOL)
