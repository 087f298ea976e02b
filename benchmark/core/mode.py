"""What every mode shares: the sampled outputs a run compares, the wait
for the device, and the comparison of decoded frames with the
reference.  A mode (`modes/<mode>.py`) defines `Run(Mode)` with `period`
(frames a pass), `size` (the padded frame), `work` (frame kind -> the
FLOP kinds it costs), `setup()`, `run_pass()` and `release()`."""

import torch


class Mode:
    def __init__(self, cell, device, rec):
        self.cell, self.dev, self.rec = cell, device, rec
        self.positions, self.samples = set(), {}

    def sample_at(self, positions):
        self.positions = set(positions)
        self.samples = {p: [] for p in positions}

    def keep(self, pos, out):
        """Keep a pass's output at a sampled position for the check."""
        if pos in self.positions:
            self.samples[pos].append(out.clone() if torch.is_tensor(out)
                                     else out)

    def sync(self):
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)

    def setup(self):
        """Nothing to code ahead of the window."""

    def compare(self, ref, weights, frames, samples):
        from core import checks
        return checks.decoded_frames(self.cell, ref, weights, frames,
                                     samples)
