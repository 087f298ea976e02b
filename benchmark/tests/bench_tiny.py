"""Tiny sizes at which the CPU tests drive the benchmark's cells."""

TINY = {
    "rt_gop_dec": {"workload": {"gop_n": 2, "gop_chunks": 2,
                                "intra_period": 6}},
    "rt_gop_dec_bf16": {"workload": {"gop_n": 2, "gop_chunks": 2,
                                     "intra_period": 6}},
    "rt_gop_enc": {"workload": {"gop_n": 2, "gop_chunks": 2,
                                "intra_period": 6}},
    "fm_dec_host_ec": {"workload": {"intra_period": 4}},
}


def overrides(cell, height=64, width=64):
    o = {"config": {"height": height, "width": width}}
    o.update({k: dict(v) for k, v in TINY[cell].items()})
    return o
