"""`python -m opendcvc_tpu_torch.bench` on the CPU, its line against
bench.py's, and the device-EC settings the port's codecs read from the
environment (OPENDCVC_TPU_EC_LANES / _EC_BPS / _EC_CAP_FRAC, as the JAX
package's codecs read them)."""

import json

import numpy as np
import pytest
import torch

import bench as jax_bench
from opendcvc_tpu.eval import rd_evidence as JRD
from opendcvc_tpu_torch import bench
from opendcvc_tpu_torch.eval import harness
from opendcvc_tpu_torch.eval import rd_evidence as PRD
from opendcvc_tpu_torch.models.dmc import DMC
from opendcvc_tpu_torch.models.dmci import DMCI
from test_torch_port_lane_rans import _one_thread  # noqa: F401  (fixture)


#: the keys of bench.py's line (bench.py:404-417)
LINE_KEYS = {"metric", "value", "unit", "vs_baseline", "enc_fps", "dec_fps",
             "bpp", "gop_n", "intra_enc_fps", "intra_dec_fps"}
EC_ENV = ("OPENDCVC_TPU_EC_LANES", "OPENDCVC_TPU_EC_BPS",
          "OPENDCVC_TPU_EC_CAP_FRAC")
SMALL = {"BENCH_PLATFORM": "cpu", "BENCH_HEIGHT": "64", "BENCH_WIDTH": "64",
         "BENCH_FRAMES": "2", "BENCH_GOP_N": "2", "BENCH_INTRA_FRAMES": "2"}


def _line(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[0]), out


@pytest.fixture
def small_env(monkeypatch):
    for k in EC_ENV + ("BENCH_CKPT_I", "BENCH_DTYPE", "BENCH_FZ",
                       "BENCH_DECODE", "BENCH_INTRA"):
        monkeypatch.delenv(k, raising=False)
    for k, v in SMALL.items():
        monkeypatch.setenv(k, v)


def test_bench_cpu_prints_bench_py_line(small_env, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_VERBOSE", "1")
    bench.main()
    line, out = _line(capsys)
    assert set(line) - {"ec_reruns"} == LINE_KEYS
    assert line["metric"] == "1080p_p_frame_enc_dec_fps"
    assert line["unit"] == "fps" and line["gop_n"] == 2
    assert line["value"] == min(line["enc_fps"], line["dec_fps"])
    for k in ("enc_fps", "dec_fps", "intra_enc_fps", "intra_dec_fps",
              "bpp"):
        assert line[k] > 0
    assert len(out) == 2 and out[1].startswith("# platform=cpu")


def test_bench_halves_can_be_skipped(small_env, monkeypatch, capsys):
    monkeypatch.setenv("BENCH_DECODE", "0")
    monkeypatch.setenv("BENCH_INTRA", "0")
    monkeypatch.setenv("BENCH_FZ", "-1")
    state = bench.run()
    line = state["result"]
    assert line["dec_fps"] is None and line["intra_enc_fps"] is None
    assert line["value"] == line["enc_fps"]
    assert state["fz"] is None
    assert state["coded"] == {"I": 1, "P": 2 * 2 + 2 + 2}
    assert "d_net" not in state and "i_dec" not in state


def test_bench_without_cuda_prints_infra_error(monkeypatch, capsys):
    monkeypatch.delenv("BENCH_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        bench.main()
    assert exc.value.code == 3
    line, out = _line(capsys)
    assert len(out) == 1
    assert line["infra_error"] is True and line["value"] == 0
    # bench.py's line, less the last_good of its TPU runs
    with pytest.raises(SystemExit) as exc:
        jax_bench._infra_fail("x")
    assert exc.value.code == 3
    ref, _ = _line(capsys)
    assert set(line) == set(ref) - {"last_good"}
    assert {k: line[k] for k in ("metric", "value", "unit", "vs_baseline")} \
        == {k: ref[k] for k in ("metric", "value", "unit", "vs_baseline")}


def test_bench_bfloat16_is_not_ported(small_env, monkeypatch):
    monkeypatch.setenv("BENCH_DTYPE", "bfloat16")
    with pytest.raises(NotImplementedError, match="float32"):
        bench.run()


def test_synthetic_images_match_jax():
    for n, size, seed, width in ((2, 32, 0, 48), (1, 40, 3, None)):
        got = PRD.synthetic_images(n, size, seed=seed, width=width)
        ref = JRD.synthetic_images(n, size, seed=seed, width=width)
        assert len(got) == n
        for g, r in zip(got, ref):
            assert g.dtype == np.float32
            np.testing.assert_array_equal(g, r)


def test_codecs_read_ec_settings_from_environment(monkeypatch):
    for k in EC_ENV:
        monkeypatch.delenv(k, raising=False)
    p, i = DMC(device="cpu"), DMCI(device="cpu")
    assert (p.lanes, p.bytes_per_symbol, p.cap_frac) == (4096, 0.5, 0.5)
    assert (i.lanes, i.bytes_per_symbol) == (4096, 0.5)
    monkeypatch.setenv("OPENDCVC_TPU_EC_LANES", "1024")
    monkeypatch.setenv("OPENDCVC_TPU_EC_BPS", "0.4")
    monkeypatch.setenv("OPENDCVC_TPU_EC_CAP_FRAC", "0.375")
    p, i = DMC(device="cpu"), DMCI(device="cpu")
    assert (p.lanes, p.bytes_per_symbol, p.cap_frac) == (1024, 0.4, 0.375)
    assert (i.lanes, i.bytes_per_symbol) == (1024, 0.4)
    # a 1080p P-frame's first rung (272 steps a lane): DMC's cap takes the
    # fraction, DMCI keeps 0.5 (the JAX package's DMCI reads none)
    assert p._rung(4096, 272, 0.4) == (58, 89088)
    assert i._rung(4096, 272, 0.4) == (58, 118784)
    p = DMC(device="cpu", lanes=512, bytes_per_symbol=0.8, cap_frac=0.25)
    assert (p.lanes, p.bytes_per_symbol, p.cap_frac) == (512, 0.8, 0.25)


def test_harness_codecs_read_ec_settings(monkeypatch, tmp_path):
    monkeypatch.setenv("OPENDCVC_TPU_DEVICE_EC", "1")
    monkeypatch.setenv("OPENDCVC_TPU_EC_LANES", "2048")
    monkeypatch.setenv("OPENDCVC_TPU_EC_BPS", "0.45")
    monkeypatch.setenv("OPENDCVC_TPU_EC_CAP_FRAC", "0.4")
    args = harness.parse_args([
        "--test_config", str(tmp_path / "cfg.json"),
        "--output_path", str(tmp_path / "out.json"), "--device", "cpu"])
    i_net, p_net = harness.build_nets(args)
    assert i_net.device_ec and p_net.device_ec
    assert (i_net.lanes, i_net.bytes_per_symbol) == (2048, 0.45)
    assert (p_net.lanes, p_net.bytes_per_symbol, p_net.cap_frac) == \
        (2048, 0.45, 0.4)
