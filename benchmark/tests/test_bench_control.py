"""On the card: the output check's control and a short run of each cell
at a small size.  Run with `python3 -m pytest benchmark/tests -q -m card`.

The control is the plain reference in the measured package's place,
computed in the precision below the configurations' (TF32 in place of
float32 without it), judged by the cell's own comparison against the
float32 reference at the sampled positions of a period: one of the
cell's numbers has to exceed its limit, so a package that slipped into
TF32 would be caught.  At 1080p the same
reading is taken by `control.py` (PERF.md holds both)."""

import pytest

from bench_tiny import overrides

CELLS = ["rt_gop_dec", "fm_dec_host_ec", "rt_gop_enc"]
SEEDS = [101, 202, 303]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_control_fails_the_check(card, cell, seed):
    import control
    got, compared, _ = control.readings(cell, seed, "cuda",
                                        overrides(cell, 256, 256))
    assert compared >= 4
    assert any(c["value"] > c["limit"] for c in got["tf32"]), \
        (cell, seed, got)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    import run
    out, checks = run.execute(cell, 4242, 1.0, 1, "cuda",
                              overrides(cell, 256, 256))
    assert out["correct"], checks
    assert out["device"]["busy_s"] > 0
