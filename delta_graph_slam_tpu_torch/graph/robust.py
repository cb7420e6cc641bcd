"""Robust loss kernels with g2o-compatible semantics.

Nine kernel names of robust_kernel_io.cpp:15-41 plus NONE. g2o
robustifies the squared error e2 = e^T Omega e with rho(e2) and scales the
normal equations by w = rho'(e2). Kernels are selected per edge by integer
id: every kernel is evaluated and the id picks one, so a whole edge table
runs without data-dependent control flow.
"""

import torch

ROBUST_KERNELS = (
    "NONE", "Huber", "Cauchy", "DCS", "Fair", "GemanMcClure",
    "PseudoHuber", "Saturated", "Tukey", "Welsch",
)
_IDS = {name: i for i, name in enumerate(ROBUST_KERNELS)}


def kernel_id(name: str) -> int:
    if name not in _IDS:
        raise ValueError(f"unknown robust kernel {name!r}; known: {ROBUST_KERNELS}")
    return _IDS[name]


def _all_rhos(e2, delta):
    """rho(e2) of every kernel, stacked on dim 0. delta is the kernel width."""
    d2 = delta * delta
    sqrte = torch.sqrt(torch.clamp(e2, min=1e-30))
    huber = torch.where(e2 <= d2, e2, 2.0 * delta * sqrte - d2)
    cauchy = d2 * torch.log1p(e2 / d2)
    s = torch.clamp(2.0 * d2 / (d2 + e2), max=1.0)
    dcs = s * (2.0 - s) * e2
    fair = 2.0 * d2 * (sqrte / delta - torch.log1p(sqrte / delta))
    gmc = d2 * e2 / (d2 + e2)
    phuber = 2.0 * d2 * (torch.sqrt(1.0 + e2 / d2) - 1.0)
    saturated = torch.minimum(e2, d2)
    tk = 1.0 - e2 / d2
    tukey = torch.where(e2 <= d2, (d2 / 3.0) * (1.0 - tk**3), d2 / 3.0)
    welsch = d2 * (1.0 - torch.exp(-e2 / d2))
    return torch.stack([e2, huber, cauchy, dcs, fair, gmc, phuber, saturated,
                        tukey, welsch])


def _all_weights(e2, delta):
    """w = d rho / d e2 of every kernel, stacked on dim 0 (DCS: g2o's
    covariance scaling s^2)."""
    d2 = delta * delta
    sqrte = torch.sqrt(torch.clamp(e2, min=1e-30))
    one = torch.ones_like(e2)
    zero = torch.zeros_like(e2)
    huber = torch.where(e2 <= d2, one, delta / sqrte)
    cauchy = 1.0 / (1.0 + e2 / d2)
    s = torch.clamp(2.0 * d2 / (d2 + e2), max=1.0)
    fair = 1.0 / (1.0 + sqrte / delta)
    gmc = (d2 / (d2 + e2)) ** 2
    phuber = 1.0 / torch.sqrt(1.0 + e2 / d2)
    saturated = torch.where(e2 <= d2, one, zero)
    tukey = torch.where(e2 <= d2, (1.0 - e2 / d2) ** 2, zero)
    welsch = torch.exp(-e2 / d2)
    return torch.stack([one, huber, cauchy, s * s, fair, gmc, phuber,
                        saturated, tukey, welsch])


def _select(table, kernel_ids):
    return torch.gather(table, 0, kernel_ids[None].to(torch.int64))[0]


def robust_rho(e2, kernel_ids, deltas):
    """Robustified squared error. e2 (...,), kernel_ids int (...,), deltas (...,)."""
    deltas = torch.where(deltas > 0, deltas, torch.ones_like(deltas))
    return _select(_all_rhos(e2, deltas), kernel_ids)


def robust_weight(e2, kernel_ids, deltas):
    """IRLS weight rho'(e2) applied to the edge information in H and b."""
    deltas = torch.where(deltas > 0, deltas, torch.ones_like(deltas))
    return _select(_all_weights(e2, deltas), kernel_ids)
