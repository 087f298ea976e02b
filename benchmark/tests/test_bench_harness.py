"""The harness on the CPU: what it loads, how it finds a cell's files,
the rules BENCHMARK.json keeps, the kernels' byte counts, and that a
broken decoder makes a run incorrect."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from bench_tiny import TINY, overrides

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _bench():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _python(code, cwd=ROOT):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([ROOT, BENCH_DIR]))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=900)


# ---------------------------------------------------------------------------
# imports
# ---------------------------------------------------------------------------

def test_modes_load_neither_jax_nor_the_jax_package():
    """Each cell's mode driven at a tiny size on the CPU (run.execute, the
    test entry) leaves no module whose top-level name, compared whole, is
    jax, jaxlib, flax or opendcvc_tpu; the measured package itself
    (opendcvc_tpu_torch, whose name begins with the JAX package's) is
    loaded."""
    code = (
        "import json, sys\n"
        "import run\n"
        f"tiny = {json.dumps({c: overrides(c) for c in TINY})}\n"
        "for cell, ov in tiny.items():\n"
        "    out, _ = run.execute(cell, 31, 0.1, 0, 'cpu', ov)\n"
        "    assert out['correct'], cell\n"
        "top = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps({'forbidden': run.forbidden_modules(),\n"
        "                  'port': 'opendcvc_tpu_torch' in top}))\n")
    res = _python(code)
    assert res.returncode == 0, res.stderr[-3000:]
    got = json.loads(res.stdout.strip().splitlines()[-1])
    assert got == {"forbidden": [], "port": True}


def test_the_reference_imports_nothing_of_the_measured_package():
    """No module under reference/ imports the measured package, the JAX
    package or JAX (its sources, and a fresh process that loads them)."""
    bad = ("opendcvc_tpu_torch", "opendcvc_tpu", "jax", "jaxlib", "flax")
    ref_dir = os.path.join(BENCH_DIR, "reference")
    names = []
    for fn in sorted(os.listdir(ref_dir)):
        if not fn.endswith(".py"):
            continue
        with open(os.path.join(ref_dir, fn)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names += [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names.append(node.module)
        names.append(f"reference.{fn[:-3]}")
    assert not {n.split(".")[0] for n in names} & set(bad)
    mods = [n for n in names if n.startswith("reference.")]
    res = _python("import importlib, json, sys\n"
                  f"for m in {mods!r}: importlib.import_module(m)\n"
                  "print(json.dumps(sorted({m.split('.')[0] "
                  "for m in sys.modules})))")
    assert res.returncode == 0, res.stderr[-2000:]
    assert not set(json.loads(res.stdout.strip().splitlines()[-1])) & \
        set(bad)


def test_the_command_needs_a_card_and_the_package():
    """Without a CUDA device the command prints no result and exits 2; in
    a directory that holds only BENCHMARK.json and the benchmark's folder
    it exits non-zero, printing no result."""
    cmd = [sys.executable, "benchmark/run.py", "--workload", "rt_gop_dec",
           "--seed", "3", "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=300)
        assert res.returncode == 2 and res.stdout.strip() == ""


def test_the_command_fails_without_the_package(tmp_path):
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "rt_gop_dec",
         "--seed", "3", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""


# ---------------------------------------------------------------------------
# BENCHMARK.json and finding files by name
# ---------------------------------------------------------------------------

def test_benchmark_json_keeps_the_rules():
    b = _bench()
    e2e = {m["name"]: m for m in b["end_to_end"]}
    cells = {w["name"]: w for w in b["workloads"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    reports = {c: {n for n, m in e2e.items()
                   if c in m.get("workloads", cells)} for c in cells}
    layers = {}
    for m in b["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        assert m["workloads"], m["name"]
        for c in m["workloads"]:
            assert m["moves"] in reports[c], (m["name"], c)
        layers.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
        assert os.path.exists(os.path.join(BENCH_DIR, "metrics",
                                           f"{m['name']}.py"))
    for c, names in reports.items():
        assert "setup_s" in names and len(names) >= 2, c
        assert any(c in m["workloads"] for m in b["per_layer"]), c
        assert os.path.exists(os.path.join(BENCH_DIR, "workloads",
                                           f"{c}.json"))
    everything = ([m for m in b["end_to_end"] + b["per_layer"]]
                  + b["workloads"] + b["configs"])
    for m in everything:
        assert NAME.match(m["name"]), m["name"]
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for w in b["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in b["configs"]:
        assert c["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({m["name"] for m in everything}) == len(everything)


def test_a_new_cell_config_and_metric_are_files_and_entries(tmp_path):
    """In a copy of the benchmark, a new configuration (a file), a new
    traffic mix (a workload file) and a new per-layer metric (a reader
    file), with their BENCHMARK.json entries, run at a tiny size without
    an existing file being edited."""
    bench = tmp_path / "benchmark"
    shutil.copytree(BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    before = {p: open(p, "rb").read() for p in
              (str(f) for f in bench.rglob("*") if f.is_file())}
    with open(bench / "configs" / "dcvc_rt.json") as f:
        cfg = json.load(f)
    cfg["qp"] = 40
    (bench / "configs" / "dcvc_rt_q40.json").write_text(json.dumps(cfg))
    with open(bench / "workloads" / "rt_gop_dec.json") as f:
        wl = json.load(f)
    wl.update(config="dcvc_rt_q40", gop_n=2, gop_chunks=1, intra_period=4)
    (bench / "workloads" / "rt_q40_dec.json").write_text(json.dumps(wl))
    (bench / "metrics" / "dec_fps.q40.py").write_text(
        "from core import readers\n\n\ndef read(r):\n"
        "    return readers.rate(r)\n")
    (bench / "metrics" / "frames_in_window.py").write_text(
        "def read(r):\n    return r.rec.n_frames()\n")
    b = _bench()
    b["configs"].append({"name": "dcvc_rt_q40", "source": "x",
                         "file": "benchmark/configs/dcvc_rt_q40.json",
                         "reduced": ["qp"], "why": "a test"})
    b["workloads"].append({"name": "rt_q40_dec", "config": "dcvc_rt_q40",
                           "traffic": "t", "chips": 1, "why": "a test"})
    b["end_to_end"].append({"name": "dec_fps.q40", "unit": "frames/s",
                            "better": "higher", "bound": 0.25,
                            "source": "host_clock",
                            "workloads": ["rt_q40_dec"]})
    b["per_layer"].append({"name": "frames_in_window", "unit": "frames",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "dec_fps.q40",
                           "workloads": ["rt_q40_dec"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    code = (
        "import json, run\n"
        "ov = {'config': {'height': 64, 'width': 64}}\n"
        "outs = [run.execute('rt_q40_dec', 8, 0.1, t, 'cpu', ov)[0]\n"
        "        for t in (0, 1)]\n"
        "print(json.dumps(outs))\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(bench), ROOT]))
    res = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         env=env, capture_output=True, text=True,
                         timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    plain, traced = json.loads(res.stdout.strip().splitlines()[-1])
    assert plain["correct"] and traced["correct"]
    assert set(plain["metrics"]) == {"dec_fps.q40", "setup_s"}
    assert traced["metrics"]["frames_in_window"]["value"] >= 4
    for p, data in before.items():
        assert open(p, "rb").read() == data, p


# ---------------------------------------------------------------------------
# the kernels' byte counts
# ---------------------------------------------------------------------------

HBM = 3.35e12


def test_k1_bytes_give_the_chip_smoke_bounds():
    """K1's bound at the chip smoke test's launch shapes (4096 lanes; K =
    272 and a DMC frame's 16 + 2 x 128 steps, a DMCI frame's 16 + 4 x
    128, staging widths of the first rung (bps 0.5) and the top (3.0)):
    the fixed part of the count stays below each printed bound, and the
    rest is the table entries the launch coded, 4 bytes each, at most
    one per (row, symbol) of its rows."""
    from counts.lane_rans import bound_ms, k1_bytes
    lanes = 4096

    def mw(k, bps):
        return max(8, int(k * bps / 2)) + 4

    printed = [(272, 0.5, 0.00177, 256), (272, 0.5, 0.00170, 256),
               (272, 3.0, 0.00337, 256), (528, 0.5, 0.00327, 256),
               (528, 3.0, 0.00650, 256)]
    for k, bps, bound, rows in printed:
        fixed = k1_bytes(k, lanes, mw(k, bps), 0)
        lo, hi = (bound - 5e-6) * HBM / 1e3, (bound + 5e-6) * HBM / 1e3
        entries = (lo - fixed) / 4, (hi - fixed) / 4
        assert entries[1] > 0 and entries[0] < rows * 256 * 4, \
            (k, bps, bound, entries)
        assert bound_ms(k1_bytes(k, lanes, mw(k, bps),
                                 max(0, int(entries[0]) + 1)), HBM) == \
            pytest.approx(bound, abs=5e-6)


def test_k2_bytes_of_an_rt_period():
    """K2's count of a DCVC-RT 1088x1920 period read off its containers:
    z then y launches with the frame's steps, 784-byte table rows, the
    payload words once a frame."""
    import numpy as np
    from counts import lane_rans as LR

    def container(n, lanes, k, words):
        head = [np.uint8(0x76).tobytes(), np.uint32(n).tobytes(),
                np.uint16(lanes).tobytes(), np.uint16(k).tobytes(),
                np.uint16(40).tobytes(), np.uint32(0).tobytes(),
                np.uint16(0).tobytes(), np.uint32(2 * words).tobytes()]
        return b"".join(head)

    i_s = container(0, 4096, 16 + 4 * 128, 300000)
    p_s = container(0, 4096, 16 + 2 * 128, 25000)
    got = LR.rt_period_launches([i_s, p_s], 1088, 1920)
    assert got == [[(16, 4096, 128, 300000)] + [(128, 4096, 128, 0)] * 4,
                   [(16, 4096, 128, 25000)] + [(128, 4096, 128, 0)] * 2]
    assert LR.k2_bytes(272, 4096, 256, 0) == \
        8 * 272 * 4096 + 784 * 256 + 24 * 4096
    with pytest.raises(ValueError):
        LR.rt_frame_launches(container(0, 4096, 100, 1), 2, 1088, 1920)


# ---------------------------------------------------------------------------
# a broken decoder is caught
# ---------------------------------------------------------------------------

def _flip_one(t):
    t = t.clone()
    t.view(-1)[t.numel() // 2] += 1
    return t


def _fault_state_unchanged(mp):
    """The DPB keeps its old feature when a frame hands it a new one."""
    from opendcvc_tpu_torch.models.dmc import DMC
    add = DMC.add_ref_frame

    def stale(self, feature=None, frame=None, increase_poc=True):
        if feature is not None and self.dpb and \
                self.dpb[0].feature is not None:
            feature = self.dpb[0].feature
        return add(self, feature, frame, increase_poc)

    mp.setattr(DMC, "add_ref_frame", stale)


def _fault_half_chunk(mp):
    """A GOP chunk's decode returns its first half twice."""
    from opendcvc_tpu_torch.models.dmc import DMC
    dec = DMC.decompress_gop_uploaded

    def half(self, uploaded, sps, qps):
        out = dec(self, uploaded, sps, qps)
        x = out["x_hat"]
        n = x.shape[0] // 2
        return {"x_hat": torch.cat([x[:n], x[:n]])[:x.shape[0]]}

    mp.setattr(DMC, "decompress_gop_uploaded", half)


def _fault_device_symbol(mp):
    """One decoded symbol of each K2 launch is off by one."""
    from opendcvc_tpu_torch.models import dmc
    plane = dmc._dec_plane

    def flipped(*args):
        syms, carry = plane(*args)
        return _flip_one(syms), carry

    mp.setattr(dmc, "_dec_plane", flipped)


def _fault_host_symbol(mp):
    """One symbol of each host-decoded y pass is off by one."""
    from opendcvc_tpu_torch.models import common
    dec = common.decode_y_host
    mp.setattr(common, "decode_y_host",
               lambda *a, **k: _flip_one(dec(*a, **k)))


def _fault_fm_state_unchanged(mp):
    """A P-frame's decode hands back the DPB it was given."""
    from opendcvc_tpu_torch.models.dmc_fm import DMCFM
    dec = DMCFM.decompress

    def stale(self, bit_stream, dpb, sps):
        dec(self, bit_stream, dpb, sps)
        return {"dpb": dpb}

    mp.setattr(DMCFM, "decompress", stale)


def _fault_half_chunk_enc(mp):
    """A GOP chunk's encode hands back its first half's streams twice."""
    from opendcvc_tpu_torch.models.dmc import DMC
    enc = DMC.compress_gop_async

    def half(self, frames, qps):
        finish = enc(self, frames, qps)

        def first_half_twice():
            s = finish()
            n = len(s) // 2
            return (s[:n] + s[:n])[:len(s)]

        return first_half_twice

    mp.setattr(DMC, "compress_gop_async", half)


def _fault_enc_symbol(mp):
    """One symbol of each P-frame's first y pass is off by one where the
    encoder quantizes it."""
    from opendcvc_tpu_torch.models import dmc
    enc_pass = dmc._enc_pass

    def flipped(y, scales, means, k, fz):
        sym, idx, keep, y_hat = enc_pass(y, scales, means, k, fz)
        return (_flip_one(sym) if k == 0 else sym), idx, keep, y_hat

    mp.setattr(dmc, "_enc_pass", flipped)


FAULTS = {
    "rt_gop_enc": [_fault_state_unchanged, _fault_half_chunk_enc,
                   _fault_enc_symbol],
    "rt_gop_dec": [_fault_state_unchanged, _fault_half_chunk,
                   _fault_device_symbol],
    "rt_gop_dec_bf16": [_fault_state_unchanged, _fault_half_chunk,
                        _fault_device_symbol],
    "fm_dec_host_ec": [_fault_fm_state_unchanged, _fault_host_symbol],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items()
                                        for f in fs],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_broken_decoder_is_not_correct(cell, fault, monkeypatch):
    """The run, its look for a card skipped (run.execute on the CPU),
    with the timed path broken underneath: `correct` comes out false.
    Faults: a step that leaves its state unchanged, half of a chunk left
    out, an answer altered where it is produced (a decoded symbol).  No
    cell exchanges anything between chips."""
    import run
    fault(monkeypatch)
    out, checks = run.execute(cell, 1234567, 0.2, 0, "cpu",
                              overrides(cell))
    assert out["correct"] is False, checks
    # a wrong frame, or a decoder that refuses its stream (counted failed)
    assert any(c["value"] > c["limit"] for c in checks) or out["failed"] > 0
