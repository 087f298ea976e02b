"""Frame-by-frame decode on the host coder (DCVC-HEM).

Set-up encodes one intra period with the measured package's HEM codecs
on the host coder, as HEM's `test_video.py` codes it: an I-frame
(`IntraNoAR.compress`), then P-frames (`DMCHEM.compress`) from a DPB that
starts as {ref_frame: the I-frame's x_hat, ref_feature, ref_y, ref_mv_y:
None}, every frame at the configuration's rung of the rate ladders.  A
pass decodes the period from its I-frame (`IntraNoAR.decompress`, then
`DMCHEM.decompress` frame after frame), carrying the DPB the same way;
the host waits for the device only where the coder needs a pass's CDF
indexes, and the window ends with a synchronize."""

from core.mode import Mode


class Run(Mode):
    def __init__(self, cell, weights, seed, device, rec):
        from core import content
        from core.record import clock_coder
        from opendcvc_tpu_torch.models.dmc_hem import DMCHEM
        from opendcvc_tpu_torch.models.intra_no_ar import IntraNoAR
        from opendcvc_tpu_torch.utils.stream_helper import interpolate_log
        super().__init__(cell, device, rec)
        cfg, wl = cell.config, cell.workload
        self.period = wl["intra_period"]

        def codec(cls, role, clocked):
            net = cls(device=device)
            net.load_params(weights[role])
            net.update()
            if clocked:
                clock_coder(net.entropy_coder, rec)
            return net

        self.i_enc, self.p_enc = codec(IntraNoAR, "intra", False), \
            codec(DMCHEM, "inter", False)
        self.i_dec, self.p_dec = codec(IntraNoAR, "intra", True), \
            codec(DMCHEM, "inter", True)
        num, idx = cfg["rate"]["num"], cfg["rate"]["index"]
        anchors = self.i_dec.get_q_scales()
        self.q_i = float(interpolate_log(float(anchors.min()),
                                         float(anchors.max()), num)[idx])
        y_l, mv_l = self.p_dec.get_interpolated_q_scales(num)
        self.q_mv, self.q_y = float(mv_l[idx]), float(y_l[idx])
        self.frames = content.make_frames(cfg, seed, self.period, device)
        h, w = self.frames[0].shape[1], self.frames[0].shape[2]
        if h % 64 or w % 64:
            raise ValueError(f"DCVC-HEM codes frames of a multiple of 64, "
                             f"not {h}x{w}")
        self.size = (h, w)
        self.work = {"I": [("intra", "dec")], "P1": [("inter_first", "dec")],
                     "P": [("inter", "dec")]}

    @staticmethod
    def _fresh(x_hat):
        return {"ref_frame": x_hat, "ref_feature": None, "ref_y": None,
                "ref_mv_y": None}

    def setup(self):
        enc = self.i_enc.compress(self.frames[0], self.q_i)
        self.streams, dpb = [enc["bit_stream"]], self._fresh(enc["x_hat"])
        for x in self.frames[1:]:
            enc = self.p_enc.compress(x, dpb, self.q_mv, self.q_y)
            self.streams.append(enc["bit_stream"])
            dpb = enc["dpb"]
        del self.i_enc, self.p_enc, enc, dpb

    def run_pass(self):
        rec, (h, w), dpb = self.rec, self.size, None
        for t, stream in enumerate(self.streams):
            with rec.span("call.dec"):
                if t == 0:
                    dpb = self._fresh(self.i_dec.decompress(
                        stream, h, w, self.q_i)["x_hat"])
                else:
                    dpb = self.p_dec.decompress(dpb, stream, h, w, self.q_mv,
                                                self.q_y)["dpb"]
            rec.frame("I" if t == 0 else "P1" if t == 1 else "P")
            self.keep(t, dpb["ref_frame"])

    def release(self):
        del self.i_dec, self.p_dec, self.frames, self.streams
        return self.samples
