"""The port harness's estimate mode (--write_stream 0) against the JAX
harness's, on the CPU.

3 frames of test_torch_port_harness.py's generated 64x48 YUV420 sequence
(intra_period -1: an I-frame, a P-frame from the pixel reference, a
P-frame from the feature), qp 21, the JAX package's init_params(0) /
init_params(1) weights saved by its save_params and read by the port.
Held: the JSON logs have the same keys, frame counts and types; each
frame's bpp estimate agrees within 1e-4 relative (the training forwards'
tolerance, tests/test_torch_port_training.py); PSNR within the bound
`_psnr_tol` derives from x_hat agreeing within 1e-4 (as the stream-mode
harness test holds it); no stream is written.
"""

import json
import os

import numpy as np
import pytest

from test_torch_port_harness import (X_HAT_ATOL, _dataset, _jax_main,
                                     _port_main, _psnr_tol)
from test_torch_port_harness import weights  # noqa: F401  (fixture)
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)

N, QP = 3, 21
BPP_RTOL = 1e-4


@pytest.fixture(scope="module")
def logs(weights, tmp_path_factory):
    root = tmp_path_factory.mktemp("estimate")
    cfg = _dataset(root, "yuv420", n=N)
    out = {}
    for tag, run, extra in (
            ("jax", _jax_main, ["--model_path_i", weights["i"],
                                "--model_path_p", weights["p"]]),
            ("port", _port_main, ["--device", "cpu", "--model_path_i",
                                  weights["i"], "--model_path_p",
                                  weights["p"]])):
        run(["--test_config", cfg, "--output_path", str(root / f"{tag}.json"),
             "--stream_path", str(root / f"{tag}_bins"), "--rate_num", "1",
             "--qp_i", str(QP), "--qp_p", str(QP), "--verbose_json", "1",
             "--write_stream", "0"] + extra)
        bins = root / f"{tag}_bins" / "tiny"
        out[tag] = {"log": json.loads((bins / f"seq_q{QP}.json").read_text()),
                    "files": sorted(os.listdir(bins))}
    return out


def test_layout_and_frames(logs):
    j, p = logs["jax"]["log"], logs["port"]["log"]
    assert list(p) == list(j)
    for key in ("frame_pixel_num", "i_frame_num", "p_frame_num",
                "frame_type"):
        assert p[key] == j[key], key
    assert j["frame_type"] == [0, 1, 1]
    assert logs["port"]["files"] == logs["jax"]["files"] == \
        [f"seq_q{QP}.json"]


def test_bpp_estimates_agree(logs):
    j, p = logs["jax"]["log"], logs["port"]["log"]
    np.testing.assert_allclose(p["frame_bpp"], j["frame_bpp"],
                               rtol=BPP_RTOL, atol=0)
    assert all(b > 0 for b in p["frame_bpp"])


def test_psnr_agrees(logs):
    j, p = logs["jax"]["log"], logs["port"]["log"]
    keys = ["frame_psnr"] + [k for k in j if "psnr" in k and k[0] == "a"]
    for key in keys:
        for a, b in zip(np.atleast_1d(p[key]), np.atleast_1d(j[key])):
            assert np.isfinite(a) and abs(a - b) <= _psnr_tol(
                b, X_HAT_ATOL * 255), key
