"""Weights from a seed, drawn on the device in two calls.

The init functions of the reference (frozen copies of the codecs' init
rules) ask a `Draws` recorder for each random leaf.  The recorder hands
back an empty tensor on the target device and notes the leaf's law:
uniform on [-bound, bound) or normal with a standard deviation.
`materialize` then draws every uniform leaf from one `torch.rand` call
and every normal leaf from one `torch.randn` call of a generator seeded
on that device, scales them in one operation each, and copies each
leaf's slice into its own allocation.
"""

import torch


class Draws:
    def __init__(self, device):
        self.device = torch.device(device)
        self.uniform_leaves, self.normal_leaves = [], []

    def uniform(self, shape, bound):
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        self.uniform_leaves.append((t, float(bound)))
        return t

    def normal(self, shape, std):
        t = torch.empty(shape, dtype=torch.float32, device=self.device)
        self.normal_leaves.append((t, float(std)))
        return t


def _fill(leaves, draw, gen, device):
    if not leaves:
        return
    sizes = [t.numel() for t, _ in leaves]
    scale = torch.repeat_interleave(
        torch.tensor([s for _, s in leaves], dtype=torch.float32,
                     device=device),
        torch.tensor(sizes, device=device))
    flat = draw(sum(sizes), gen) * scale
    for (t, _), part in zip(leaves, torch.split(flat, sizes)):
        t.copy_(part.view(t.shape))


def materialize(draws, seed):
    """Fill the recorded leaves from `seed` (any integer; taken modulo
    2**63 for the generator)."""
    dev = draws.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (2 ** 63))
    _fill(draws.uniform_leaves,
          lambda n, g: torch.rand(n, generator=g, device=dev) * 2.0 - 1.0,
          gen, dev)
    _fill(draws.normal_leaves,
          lambda n, g: torch.randn(n, generator=g, device=dev), gen, dev)


def draw_tree(init_fn, seed, device):
    """`init_fn(draws)` -> a parameter tree whose random leaves are filled
    from `seed` on `device`."""
    d = Draws(device)
    tree = init_fn(d)
    materialize(d, seed)
    return tree
