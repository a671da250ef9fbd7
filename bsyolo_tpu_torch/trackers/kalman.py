"""Constant-velocity Kalman filters for box tracking (counterpart of ``bsyolo_tpu/trackers/kalman.py``).

Host numpy and scipy, as in the JAX package: the state is a handful of
8-vectors per track. Reference: ultralytics/trackers/utils/kalman_filter.py (KalmanFilterXYAH).
State: (x, y, a, h, vx, vy, va, vh) — center, aspect ratio, height + rates.
Vectorized over tracks (multi_predict) since per-track 8x8 updates are tiny.
"""

from __future__ import annotations

import numpy as np

import scipy.linalg


class KalmanFilterXYAH:
    def __init__(self):
        ndim, dt = 4, 1.0
        self._motion_mat = np.eye(2 * ndim, 2 * ndim)
        for i in range(ndim):
            self._motion_mat[i, ndim + i] = dt
        self._update_mat = np.eye(ndim, 2 * ndim)
        self._std_weight_position = 1.0 / 20
        self._std_weight_velocity = 1.0 / 160

    def initiate(self, measurement: np.ndarray):
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.r_[mean_pos, mean_vel]
        std = [
            2 * self._std_weight_position * measurement[3],
            2 * self._std_weight_position * measurement[3],
            1e-2,
            2 * self._std_weight_position * measurement[3],
            10 * self._std_weight_velocity * measurement[3],
            10 * self._std_weight_velocity * measurement[3],
            1e-5,
            10 * self._std_weight_velocity * measurement[3],
        ]
        covariance = np.diag(np.square(std))
        return mean, covariance

    def predict(self, mean, covariance):
        std_pos = [
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[3],
            1e-2,
            self._std_weight_position * mean[3],
        ]
        std_vel = [
            self._std_weight_velocity * mean[3],
            self._std_weight_velocity * mean[3],
            1e-5,
            self._std_weight_velocity * mean[3],
        ]
        motion_cov = np.diag(np.square(np.r_[std_pos, std_vel]))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def multi_predict(self, mean: np.ndarray, covariance: np.ndarray):
        """Vectorized predict: mean (N, 8), covariance (N, 8, 8)."""
        std_pos = np.stack(
            [
                self._std_weight_position * mean[:, 3],
                self._std_weight_position * mean[:, 3],
                1e-2 * np.ones_like(mean[:, 3]),
                self._std_weight_position * mean[:, 3],
            ],
            axis=-1,
        )
        std_vel = np.stack(
            [
                self._std_weight_velocity * mean[:, 3],
                self._std_weight_velocity * mean[:, 3],
                1e-5 * np.ones_like(mean[:, 3]),
                self._std_weight_velocity * mean[:, 3],
            ],
            axis=-1,
        )
        sqr = np.square(np.concatenate([std_pos, std_vel], axis=-1))
        motion_cov = np.stack([np.diag(s) for s in sqr])
        mean = mean @ self._motion_mat.T
        covariance = self._motion_mat[None] @ covariance @ self._motion_mat.T[None] + motion_cov
        return mean, covariance

    def project(self, mean, covariance):
        std = [
            self._std_weight_position * mean[3],
            self._std_weight_position * mean[3],
            1e-1,
            self._std_weight_position * mean[3],
        ]
        innovation_cov = np.diag(np.square(std))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov

    def update(self, mean, covariance, measurement):
        projected_mean, projected_cov = self.project(mean, covariance)
        chol, lower = scipy.linalg.cho_factor(projected_cov, lower=True, check_finite=False)
        kalman_gain = scipy.linalg.cho_solve(
            (chol, lower), (covariance @ self._update_mat.T).T, check_finite=False
        ).T
        innovation = measurement - projected_mean
        new_mean = mean + innovation @ kalman_gain.T
        new_covariance = covariance - kalman_gain @ projected_cov @ kalman_gain.T
        return new_mean, new_covariance


class KalmanFilterXYWH(KalmanFilterXYAH):
    """State (x, y, w, h, vx, vy, vw, vh) — the BoT-SORT variant
    (reference trackers/utils/kalman_filter.py:289). Noise scales use w AND
    h instead of h alone."""

    def initiate(self, measurement: np.ndarray):
        mean_pos = measurement
        mean_vel = np.zeros_like(mean_pos)
        mean = np.r_[mean_pos, mean_vel]
        std = [
            2 * self._std_weight_position * measurement[2],
            2 * self._std_weight_position * measurement[3],
            2 * self._std_weight_position * measurement[2],
            2 * self._std_weight_position * measurement[3],
            10 * self._std_weight_velocity * measurement[2],
            10 * self._std_weight_velocity * measurement[3],
            10 * self._std_weight_velocity * measurement[2],
            10 * self._std_weight_velocity * measurement[3],
        ]
        covariance = np.diag(np.square(std))
        return mean, covariance

    def _stds(self, mean, vel_scale=1.0):
        swp, swv = self._std_weight_position, self._std_weight_velocity
        std_pos = [swp * mean[..., 2], swp * mean[..., 3], swp * mean[..., 2], swp * mean[..., 3]]
        std_vel = [swv * mean[..., 2], swv * mean[..., 3], swv * mean[..., 2], swv * mean[..., 3]]
        return std_pos, std_vel

    def predict(self, mean, covariance):
        std_pos, std_vel = self._stds(mean)
        motion_cov = np.diag(np.square(np.r_[std_pos, std_vel]))
        mean = self._motion_mat @ mean
        covariance = self._motion_mat @ covariance @ self._motion_mat.T + motion_cov
        return mean, covariance

    def multi_predict(self, mean: np.ndarray, covariance: np.ndarray):
        std_pos, std_vel = self._stds(mean)
        sqr = np.square(np.stack(std_pos + std_vel, axis=-1))
        motion_cov = np.stack([np.diag(s) for s in sqr])
        mean = mean @ self._motion_mat.T
        covariance = self._motion_mat[None] @ covariance @ self._motion_mat.T[None] + motion_cov
        return mean, covariance

    def project(self, mean, covariance):
        std_pos, _ = self._stds(mean)
        innovation_cov = np.diag(np.square(np.asarray(std_pos)))
        mean = self._update_mat @ mean
        covariance = self._update_mat @ covariance @ self._update_mat.T
        return mean, covariance + innovation_cov
