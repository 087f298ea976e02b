"""Frame-by-frame decode on device EC (DCVC-FM).

`frame_dec`'s traffic, set-up and passes (loaded from its file), with the
FM codecs built with `device_ec=True`: K1 codes each frame's container in
set-up, and a pass decodes the period frame by frame with K2, each plane
one launch between the stages that need it.  The lanes and bytes a symbol
are the workload's, set on the codecs after construction (the FM codecs
take them from no argument).  With no host coder there is no wait for the
device until the window ends.  The K2 launches of a pass are read from
the set-up's containers (`counts/lane_rans_fm.py`)."""

import os

from core.mode import Mode
from core.spec import load_module

frame_dec = load_module(os.path.join(os.path.dirname(__file__),
                                     "frame_dec.py"), "bench_mode_frame_dec")


class Run(frame_dec.Run):
    def __init__(self, cell, weights, seed, device, rec):
        from core import content
        from opendcvc_tpu_torch.models.dmc_fm import DMCFM
        from opendcvc_tpu_torch.models.dmci_fm import DMCIFM
        from reference.fm import schedule
        Mode.__init__(self, cell, device, rec)
        cfg, wl = cell.config, cell.workload
        self.period = wl["intra_period"]
        self.plan = [schedule(t, cfg["qp_i"], cfg["qp_p"],
                              cfg["reset_interval"])
                     for t in range(self.period)]

        def codec(cls, role):
            net = cls(device=device, device_ec=True)
            net.lanes = wl["ec"]["lanes"]
            net.bytes_per_symbol = wl["ec"]["bytes_per_symbol"]
            net.load_params(weights[role])
            net.update()
            return net

        self.i_enc, self.p_enc = codec(DMCIFM, "intra"), \
            codec(DMCFM, "inter")
        self.i_dec, self.p_dec = codec(DMCIFM, "intra"), \
            codec(DMCFM, "inter")
        self.frames = content.make_frames(cfg, seed, self.period, device)
        h, w = self.frames[0].shape[1], self.frames[0].shape[2]
        self.size = (h, w)
        self.work = {"I": [("intra", "dec")], "P1": [("inter_reset", "dec")],
                     "P": [("inter", "dec")]}

    def setup(self):
        from counts import lane_rans_fm
        super().setup()
        self.k2_launches = lane_rans_fm.period_launches(
            [s for s, _ in self.streams], *self.size)
