"""The north star's data: float32 normal noise, trials stacked along time.

Adapted from ``chip_smoke.py::north_star_data`` (:828), which draws seed 0
with numpy on the host; here the draw is one ``torch.randn`` on the card
from a ``torch.Generator`` seeded by the run's seed and the dataset's index,
then one copy to the host.
"""

import numpy as np
import torch


def make(cfg, seed, index, device):
    """(trials * samples, channels) float32 numpy payload of dataset
    `index` of seed `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix(seed, index))
    n = cfg["trials"] * cfg["samples"]
    x = torch.randn((n, cfg["channels"]), generator=g, device=device, dtype=torch.float32)
    return x.cpu().numpy()


def _mix(seed, index):
    """One 63-bit generator seed from the run's seed and a dataset index."""
    return (int(seed) * 1_000_003 + int(index) * 7919 + 0x5EED) % (2**63)


def trialdefinition(cfg):
    trl = np.zeros((cfg["trials"], 3))
    trl[:, 0] = np.arange(cfg["trials"]) * cfg["samples"]
    trl[:, 1] = trl[:, 0] + cfg["samples"]
    return trl
