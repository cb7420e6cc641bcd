"""Scan-match fitness -> SE2 information matrices.

Replicates InformationMatrixCalculator
(information_matrix_calculator.cpp):

- calc_fitness_score: mean squared distance of cloud2 (transformed by
  relpose) to its 1-NN in cloud1, gated by max_range (:77-108). The 1-NN
  is ops/knn.py:nn_1, the Hopper kernel on the card;
- calc_information_matrix: saturating-exponential weight() maps fitness to
  [min_var, max_var]; info = diag(1/w_x, 1/w_x, 1/w_q) (:53-75). NB the
  reference divides by the *variance-valued* weight here and by the raw
  stddev in the const path (:54-58) - both reproduced;
- the building-constraint matrices (:110-157): the global-alignment prior
  weighted by fitness over the global importance ratio, the
  keyframe<->building edge by a logistic weight of the local alignment's
  distance, scaled by its coverage and, when edge-aligned, by the local
  importance ratio.
"""

import dataclasses
import math

import numpy as np
import torch

from ..ops.knn import nn_1
from ..utils.device import strict_fp32_matmul


def fitness_score(cloud1, cloud2, relpose, max_range=float("inf")):
    """Mean squared 1-NN distance of cloud2@relpose against cloud1."""
    points2 = cloud2.points
    T = torch.as_tensor(np.asarray(relpose), dtype=points2.dtype,
                        device=points2.device)
    with strict_fp32_matmul():
        moved = points2 @ T[:3, :3].T + T[:3, 3]
    d2, _ = nn_1(moved, cloud2.mask, cloud1.points, cloud1.mask)
    # reference quirk (information_matrix_calculator.cpp:96, PCL
    # getFitnessScore): the SQUARED NN distance is compared to the
    # un-squared max_range, so points up to sqrt(max_range) are accepted.
    ok = cloud2.mask & torch.isfinite(d2) & (d2 <= max_range)
    nr = ok.sum()
    s = torch.where(ok, d2, 0.0).sum()
    f = torch.where(nr > 0, s / torch.clamp(nr, min=1), float("inf"))
    return float(f)


@dataclasses.dataclass(frozen=True)
class InformationMatrixCalculator:
    use_const_inf_matrix: bool = False
    const_stddev_x: float = 0.5
    const_stddev_q: float = 0.1
    var_gain_a: float = 20.0
    min_stddev_x: float = 0.1
    max_stddev_x: float = 5.0
    min_stddev_q: float = 0.05
    max_stddev_q: float = 0.2
    fitness_score_thresh: float = 0.5
    b_var_gain_a: float = 20.0
    b_min_stddev_x: float = 0.1
    b_max_stddev_x: float = 5.0
    b_min_stddev_q: float = 0.05
    b_max_stddev_q: float = 0.2
    b_avg_fitness_score: float = 0.5
    b_importance_ratio_global: float = 1.0
    b_importance_ratio_local: float = 1.0

    @staticmethod
    def weight(a, max_x, min_y, max_y, x):
        y = (1.0 - math.exp(-a * x)) / (1.0 - math.exp(-a * max_x))
        return min_y + (max_y - min_y) * y

    @staticmethod
    def b_weight(a, avg_x, min_y, max_y, x):
        e = math.exp(a * (x - avg_x))
        y = e / (e + 1.0)
        return min_y + (max_y - min_y) * y

    def _weights(self, fitness):
        w_x = self.weight(self.var_gain_a, self.fitness_score_thresh,
                          self.min_stddev_x**2, self.max_stddev_x**2, fitness)
        w_q = self.weight(self.var_gain_a, self.fitness_score_thresh,
                          self.min_stddev_q**2, self.max_stddev_q**2, fitness)
        return w_x, w_q

    def _weighted_info(self, fitness):
        w_x, w_q = self._weights(fitness)
        return np.diag([1.0 / w_x, 1.0 / w_x, 1.0 / w_q])

    def _const_info(self, dim_t, dim_q):
        # reference quirk: const path divides by stddev, not variance
        return np.diag([1.0 / self.const_stddev_x] * dim_t
                       + [1.0 / self.const_stddev_q] * dim_q)

    def calc_information_matrix(self, cloud1, cloud2, relpose):
        if self.use_const_inf_matrix:
            return self._const_info(2, 1)
        return self._weighted_info(fitness_score(cloud1, cloud2, relpose))

    def calc_information_matrices(self, items):
        """calc_information_matrix over items = [(cloud1, cloud2, relpose
        4x4), ...] -> list of (3,3) infos."""
        return [self.calc_information_matrix(c1, c2, T) for c1, c2, T in items]

    def calc_information_matrix_se3(self, cloud1, cloud2, relpose):
        """6-DoF variant as used with SE3 edges upstream
        (information_matrix_calculator.cpp:53-75): one translational
        weight on all three axes, one rotational weight on all three."""
        if self.use_const_inf_matrix:
            return self._const_info(3, 3)
        w_x, w_q = self._weights(fitness_score(cloud1, cloud2, relpose))
        return np.diag([1.0 / w_x] * 3 + [1.0 / w_q] * 3)

    def calc_information_matrices_se3(self, items):
        return [self.calc_information_matrix_se3(c1, c2, T) for c1, c2, T in items]

    def calc_information_matrix_buildings_global(self, fitness):
        if self.use_const_inf_matrix:
            return self._const_info(2, 1)
        return self._weighted_info(fitness) / self.b_importance_ratio_global

    def calc_information_matrix_buildings_local(self, avg_distance, coverage_percentage,
                                                is_edge_aligned):
        w_x = self.b_weight(self.b_var_gain_a, self.b_avg_fitness_score,
                            self.b_min_stddev_x**2, self.b_max_stddev_x**2, avg_distance)
        w_q = self.b_weight(self.b_var_gain_a, self.b_avg_fitness_score,
                            self.b_min_stddev_q**2, self.b_max_stddev_q**2, avg_distance)
        inf = np.diag([1.0 / w_x, 1.0 / w_x, 1.0 / w_q])
        if is_edge_aligned:
            inf = inf * self.b_importance_ratio_local
        return inf * (coverage_percentage / 100.0)
