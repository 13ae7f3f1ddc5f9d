"""Offset-sampling search space of siamese training, copy of
`open3dsot_tpu/data/searchspace.py`'s KalmanFiltering (reference
datasets/searchspace.py). The other search spaces are used by no ported path.
"""

from __future__ import annotations

import numpy as np


class KalmanFiltering:
    """Gaussian offset sampler; used by siamese training (sampler.py:50-56)."""

    def __init__(self, bnd=(1, 1, 10)):
        self.bnd = list(bnd)
        self.reset()

    def sample(self, n=10):
        return np.random.multivariate_normal(self.mean, self.cov, size=n)

    def addData(self, data, score):
        score = score.clip(min=1e-5)
        self.data = np.concatenate((self.data, data))
        self.score = np.concatenate((self.score, score))
        self.mean = np.average(self.data, weights=self.score, axis=0)
        self.cov = np.cov(self.data.T, ddof=0, aweights=self.score)

    def reset(self):
        self.mean = np.zeros(len(self.bnd))
        self.cov = np.diag(self.bnd)
        self.data = np.zeros((0, len(self.bnd)))
        self.score = np.array([])
