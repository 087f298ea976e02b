"""The cells hem_dec_host_ec and fm_dec_device_ec on the CPU: each run at a
tiny size (device EC on the kernels' plain versions) compares its sampled
outputs with the plain reference and finds them equal, a traced run
reads the port's HEM spans, and the yardstick's counts are the
reference's (FLOPs) and the containers' (K2 launches)."""

import json

import pytest
import torch

from core import content
from reference import hem as REF

CPU = torch.device("cpu")
SIZES = [(64, 64), (128, 128)]
TINY = {"hem_dec_host_ec": {"workload": {"intra_period": 4}},
        "fm_dec_device_ec": {"workload": {"intra_period": 4}}}
HEM_PORT_METRICS = ("dec_entry_ms.hem", "nn_host_ms.hem",
                    "host_coder_ms.hem", "host_wait_ms.hem")


def overrides(cell, height=64, width=64):
    o = {"config": {"height": height, "width": width}}
    o.update({k: dict(v) for k, v in TINY[cell].items()})
    return o


@pytest.mark.parametrize("h,w", SIZES)
@pytest.mark.parametrize("cell", sorted(TINY))
def test_new_cells_are_correct_on_the_cpu(cell, h, w):
    import run
    out, checks = run.execute(cell, 4294967311 + h, 0.2, 0, "cpu",
                              overrides(cell, h, w))
    assert out["correct"], checks
    assert {c["name"]: c["value"] for c in checks} == {
        "x_hat_max_gap": 0.0, "x_hat_mean_gap": 0.0}
    assert checks[0]["compared"] >= 4


def test_traced_hem_run_reads_the_ports_spans():
    """A traced run's line holds the readers of the port's own HEM spans:
    four fetches a P-frame and two an I-frame, over 1 I + 3 P."""
    import run
    from core import port_trace
    out, _ = run.execute("hem_dec_host_ec", 91, 0.1, 1, "cpu",
                         overrides("hem_dec_host_ec"))
    assert out["correct"]
    for name in HEM_PORT_METRICS:
        assert out["metrics"][name]["value"] > 0, name
    s = port_trace.session()
    assert s["frames"] == 4
    assert s["spans"]["wait.fetch"]["n"] == 2 + 3 * 4
    assert s["spans"]["intra_no_ar.decompress"]["n"] == 1
    assert s["spans"]["dmc_hem.decompress"]["n"] == 3


def test_fm_device_run_counts_its_k2_launches():
    """The FM device-EC mode reads each frame's K2 launches from its
    container: 5 an I-frame, 10 a P-frame, their steps the container's."""
    import run
    from core import spec
    from counts import lane_rans
    from reference import fm as REF_FM
    ov = overrides("fm_dec_device_ec")
    cell = spec.Cell("fm_dec_device_ec")
    for part in ("config", "workload"):
        getattr(cell, part).update(ov[part])
    weights = content.make_weights(cell.config, REF_FM, CPU)
    from core.record import Recorder
    mode = cell.mode().Run(cell, weights, 7, CPU, Recorder())
    mode.setup()
    assert [len(f) for f in mode.k2_launches] == [5, 10, 10, 10]
    for stream, launches in zip((s for s, _ in mode.streams),
                                mode.k2_launches):
        head = lane_rans.parse_header(stream)
        assert sum(k for k, _, _, _ in launches) == head["K"]
        assert all(lanes == head["L"] for _, lanes, _, _ in launches)
    assert run.execute("fm_dec_device_ec", 7, 0.1, 0, "cpu", ov)[0][
        "correct"]


def test_flop_counts_are_the_references():
    """counts/flops_dcvc_hem.json holds the reference's FLOP_WORK count at
    1088x1920."""
    from core.spec import Cell
    from counts.flops import frame_flops, path_of
    cfg = Cell("hem_dec_host_ec").config
    with open(path_of("dcvc_hem")) as f:
        kept = json.load(f)["1088x1920"]
    assert kept == frame_flops(REF, cfg, 1088, 1920)


def test_flop_counts_equal_the_package_calls():
    """The package's own calls, counted by FlopCounterMode on the CPU at
    64x64: IntraNoAR encode / decode, the first DMCHEM P-frame after it
    and a second one, each side."""
    from torch.utils.flop_counter import FlopCounterMode
    from core.spec import Cell
    from counts.flops import frame_flops
    from opendcvc_tpu_torch.models.dmc_hem import DMCHEM
    from opendcvc_tpu_torch.models.intra_no_ar import IntraNoAR
    h = w = 64
    cfg = dict(Cell("hem_dec_host_ec").config, height=h, width=w)
    wts = content.make_weights(cfg, REF, CPU, 5)
    x = content.make_frames(cfg, 5, 3, CPU)
    q_i, (mv_q, y_q) = REF.rates(cfg, wts)
    nets = {}
    for name, cls, role in (("ie", IntraNoAR, "intra"),
                            ("id", IntraNoAR, "intra"),
                            ("pe", DMCHEM, "inter"), ("pd", DMCHEM, "inter")):
        nets[name] = cls(device="cpu")
        nets[name].load_params(wts[role])
        nets[name].update()
    counts = {}

    def counted(key, fn):
        with FlopCounterMode(display=False) as fc:
            out = fn()
        counts[key] = fc.get_total_flops()
        return out

    enc = counted(("intra", "enc"), lambda: nets["ie"].compress(x[0], q_i))
    counted(("intra", "dec"),
            lambda: nets["id"].decompress(enc["bit_stream"], h, w, q_i))
    dpb = REF.fresh_dpb(enc["x_hat"])
    for t, kind in ((1, "inter_first"), (2, "inter")):
        out = counted((kind, "enc"),
                      lambda: nets["pe"].compress(x[t], dpb, mv_q, y_q))
        counted((kind, "dec"), lambda: nets["pd"].decompress(
            dpb, out["bit_stream"], h, w, mv_q, y_q))
        dpb = out["dpb"]
    mine = frame_flops(REF, cfg, h, w)
    assert counts == {(k, s): mine[k][s] for k in mine for s in mine[k]}
