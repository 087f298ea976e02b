"""On the card: the output check's control and a short run of each cell
at a small size.  Run with `python3 -m pytest benchmark/tests -q -m card`.

The control is the plain reference in the measured package's place,
computed in the precision below the configuration's (TF32 in place of
float32 without it; bfloat16 with each convolution's output rounded
through float8), judged by the cell's own comparison against the
reference in the configuration's precision at the sampled positions of a
period: one of the cell's numbers has to exceed its limit, so a package
that slipped into the lower precision would be caught.  At 1080p the
same reading is taken by `control.py` (PERF.md holds both)."""

import pytest

from bench_tiny import overrides

CELLS = ["rt_gop_dec", "fm_dec_host_ec", "rt_gop_enc", "rt_gop_dec_bf16"]
SEEDS = [101, 202, 303]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_tf32_control_fails_the_check(card, cell, seed):
    """The configuration's control (TF32 for float32, float8 convolution
    outputs for bfloat16) fails the cell's check."""
    import control
    from core.spec import Cell
    got, compared, _, _ = control.readings(cell, seed, "cuda",
                                           overrides(cell, 256, 256))
    assert compared >= 4
    ctl = control.control_of(Cell(cell).config)
    assert any(c["value"] > c["limit"] for c in got[ctl]), \
        (cell, seed, got)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell):
    import run
    out, checks = run.execute(cell, 4242, 1.0, 1, "cuda",
                              overrides(cell, 256, 256))
    assert out["correct"], checks
    assert out["device"]["busy_s"] > 0
