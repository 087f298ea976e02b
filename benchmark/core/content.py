"""Frames from the run's seed and weights from the configuration's,
made on the device.

Content: a copy of the measured package's bench generator, uniform noise
in [0, 1) rolled `shift_px` pixels to the right each frame, padded to a
multiple of 16 by edge replication, drawn here from a generator on the
device seeded with the run's seed.  Weights: the configuration's
reference init rules, drawn by `reference.draws` from the
configuration's `weights_seed`, with its flat q banks set.  One model
for every run, as a deployment serves one: under random weights the
draw sets the bitrate (stream sizes differ by 15-25 % between weight
draws, by under 1.5 % between content draws of one model), so a weight
drawn from the run's seed would change the host coder's work from run
to run."""

import torch

from reference import draws
from reference import nn as N


def seeded(seed, device, salt):
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1000003 + salt) % (2 ** 63))
    return g


def make_frames(cfg, seed, n, device, dtype=torch.float32):
    """n NHWC frames (1, H', W', 3) of the configuration's size, H' and W'
    padded to a multiple of 16; frame t is the base rolled t * shift."""
    c = cfg["content"]
    h, w = cfg["height"], cfg["width"]
    base = torch.rand((1, h, w, 3), generator=seeded(seed, device, 1),
                      device=device, dtype=torch.float32)
    pr, pb = N.padding_size(h, w, 16)
    out = []
    for t in range(n):
        x = torch.roll(base, c["shift_px"] * t, dims=2).to(dtype)
        out.append(N.replicate_pad(x.permute(0, 3, 1, 2), pb, pr)
                   .permute(0, 2, 3, 1).contiguous())
    return out


def make_weights(cfg, ref, device, seed=None):
    """{"intra": tree, "inter": tree}: the reference's init rules drawn
    from `seed` (default: the configuration's weights_seed) on `device`
    in two calls, then the configuration's flat banks (a number fills the
    leaf, a list replaces it)."""
    d = draws.Draws(device)
    trees = {role: ref.INIT[role](d) for role in ("intra", "inter")}
    seed = cfg["weights_seed"] if seed is None else seed
    draws.materialize(d, seeded(seed, device, 2).initial_seed())
    for role, banks in cfg.get("q_banks", {}).items():
        for name, v in banks.items():
            leaf = trees[role][name]
            trees[role][name] = (torch.full_like(leaf, float(v))
                                 if isinstance(v, (int, float))
                                 else torch.tensor(v, dtype=leaf.dtype,
                                                   device=leaf.device))
    return trees
