"""Granger's data: an AR(2) network, trials stacked along time. Every
channel is an AR(2) process with the configuration's ``network.alphas``
(poles at a spectral peak), and channel ``sender`` feeds channel
``receiver`` with weight ``coupling`` one sample later.

Adapted from ``chip_smoke.py::ar2_network`` (:515), which draws its noise
with numpy on the host and runs the recursion there as a matrix product
with ``M1^T``; here the noise is one ``torch.randn`` on the card from a
``torch.Generator`` seeded as ``north_star.py`` seeds it, the recursion
runs there elementwise (the coupling added after the AR(2) terms, the same
sum in another order), and the result is copied to the host once.
"""

import torch

from .north_star import _mix, trialdefinition  # noqa: F401  (trialdefinition: for the harness)


def make(cfg, seed, index, device):
    """(trials * samples, channels) float32 numpy payload of dataset
    `index` of seed `seed`."""
    g = torch.Generator(device=device)
    g.manual_seed(_mix(seed, index))
    x = torch.randn((cfg["trials"], cfg["samples"], cfg["channels"]), generator=g,
                    device=device, dtype=torch.float32)
    net = cfg["network"]
    a1, a2 = (float(a) for a in net["alphas"])
    src, dst, c = int(net["sender"]), int(net["receiver"]), float(net["coupling"])
    for t in range(2, cfg["samples"]):
        x[:, t] += a1 * x[:, t - 1] + a2 * x[:, t - 2]
        x[:, t, dst] += c * x[:, t - 1, src]
    return x.reshape(-1, cfg["channels"]).cpu().numpy()
