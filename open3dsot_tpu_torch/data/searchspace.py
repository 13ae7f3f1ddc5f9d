"""Offset-sampling search spaces, copy of `open3dsot_tpu/data/searchspace.py`
(reference datasets/searchspace.py).

KalmanFiltering is the one used in training (sampler.py:53); the others are
kept for API completeness. GaussianMixtureModel is a real weighted-EM
mixture implemented in numpy (pomegranate-free), matching the reference's
fit/score/addData semantics (reference searchspace.py:110-187).
"""

from __future__ import annotations

import numpy as np


class SearchSpace:
    def reset(self):
        raise NotImplementedError

    def sample(self, n=10):
        raise NotImplementedError

    def addData(self, data, score):
        return


class ExhaustiveSearch(SearchSpace):
    def __init__(self, search_space=((-3.0, 3.0), (-3.0, 3.0), (-10.0, 10.0)),
                 search_dims=(7, 7, 3)):
        x_space = np.linspace(search_space[0][0], search_space[0][1], search_dims[0])
        y_space = np.linspace(search_space[1][0], search_space[1][1], search_dims[1])
        a_space = np.linspace(search_space[2][0], search_space[2][1], search_dims[2])
        X, Y, A = np.meshgrid(x_space, y_space, a_space)
        self.search_grid = np.array([X.flatten(), Y.flatten(), A.flatten()]).T
        self.reset()

    def reset(self):
        return

    def sample(self, n=0):
        return self.search_grid


class ParticleFiltering(SearchSpace):
    def __init__(self, bnd=(1, 1, 10)):
        self.bnd = list(bnd)
        self.reset()

    def sample(self, n=10):
        samples = []
        for _ in range(n):
            if len(self.data) > 0:
                i_mean = np.random.choice(
                    list(range(len(self.data))),
                    p=self.score / np.linalg.norm(self.score, ord=1),
                )
                sample = np.random.multivariate_normal(
                    mean=self.data[i_mean], cov=np.diag(np.array(self.bnd))
                )
            else:
                sample = np.random.multivariate_normal(
                    mean=np.zeros(len(self.bnd)), cov=np.diag(np.array(self.bnd) * 3)
                )
            samples.append(sample)
        return np.array(samples)

    def addData(self, data, score):
        score = score.clip(min=1e-5)
        self.data = data
        self.score = score

    def reset(self):
        self.data = np.zeros((0, len(self.bnd)))
        self.score = np.ones(0)


class KalmanFiltering(SearchSpace):
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


def _weighted_em_gmm(X, weights, n_comp, iters=50, seed=0, reg=1e-6):
    """Weighted EM fit of a full-covariance Gaussian mixture (numpy).

    Replaces the reference's pomegranate GeneralMixtureModel.from_samples
    (searchspace.py:163-168) without the dependency. Returns
    (pi (K,), means (K, D), covs (K, D, D)).
    """
    X = np.asarray(X, dtype=np.float64)
    w = np.asarray(weights, dtype=np.float64)
    w = w / w.sum()
    n, d = X.shape
    k = min(n_comp, n)
    rng = np.random.default_rng(seed)
    # init: k-means++-style seeding from weighted draws
    means = X[rng.choice(n, size=k, replace=False, p=w)]
    covs = np.tile(np.cov(X.T, aweights=w, ddof=0).reshape(d, d) + reg * np.eye(d),
                   (k, 1, 1))
    pi = np.full(k, 1.0 / k)
    for _ in range(iters):
        # E step: responsibilities under each component
        log_r = np.empty((n, k))
        for j in range(k):
            diff = X - means[j]
            cov = covs[j] + reg * np.eye(d)
            chol = np.linalg.cholesky(cov)
            from scipy.linalg import solve_triangular

            sol = solve_triangular(chol, diff.T, lower=True)
            maha = np.sum(sol**2, axis=0)
            logdet = 2.0 * np.sum(np.log(np.diag(chol)))
            log_r[:, j] = np.log(pi[j] + 1e-300) - 0.5 * (maha + logdet + d * np.log(2 * np.pi))
        log_r -= log_r.max(axis=1, keepdims=True)
        r = np.exp(log_r)
        r /= r.sum(axis=1, keepdims=True)
        rw = r * w[:, None]  # (n, k) weighted responsibilities
        nk = rw.sum(axis=0) + 1e-12
        # M step
        pi = nk / nk.sum()
        means = (rw.T @ X) / nk[:, None]
        for j in range(k):
            diff = X - means[j]
            covs[j] = (rw[:, j, None] * diff).T @ diff / nk[j] + reg * np.eye(d)
    return pi, means, covs


class GaussianMixtureModel(SearchSpace):
    """Weighted Gaussian-mixture offset sampler (reference
    searchspace.py:110-187, pomegranate-free).

    `addData` EM-fits an n_comp mixture to score-weighted offsets; `sample`
    draws 80% from the mixture plus 10% wide and 10% tight Gaussian jitter
    around the mixture-sample mean (the reference's exploration recipe).
    """

    def __init__(self, n_comp=5, dim=3):
        self.dim = dim
        self.reset(n_comp)

    def _model_sample(self, n):
        if self._means is None:  # unfitted: single broad Gaussian, as reference
            cov = np.diag([1.0, 1.0]) if self.dim == 2 else np.diag([1.0, 1.0, 5.0])
            return np.random.multivariate_normal(np.zeros(self.dim), cov, size=n)
        comp = np.random.choice(len(self._pi), size=n, p=self._pi)
        out = np.empty((n, self.dim))
        for j in np.unique(comp):
            m = comp == j
            out[m] = np.random.multivariate_normal(
                self._means[j], self._covs[j], size=int(m.sum())
            )
        return out

    def sample(self, n=10):
        n1 = int(np.round(0.8 * n))
        n2 = int(np.round(0.1 * n))
        X1 = self._model_sample(max(n1, 1))
        mean = np.mean(X1, axis=0)
        if self.dim == 2:
            wide, tight = np.diag([1.0, 1.0]), np.diag([1e-3, 1e-3])
        else:
            wide, tight = np.diag([1.0, 1.0, 1e-3]), np.diag([1e-3, 1e-3, 10.0])
        X2 = np.random.multivariate_normal(mean, wide, size=max(n2, 1))
        X3 = np.random.multivariate_normal(mean, tight, size=max(n2, 1))
        return np.concatenate((X1, X2, X3))

    def addData(self, data, score):
        score = score.clip(min=1e-5)
        self.data = data
        self.score = score
        self._pi, self._means, self._covs = _weighted_em_gmm(
            data, score / np.linalg.norm(score, ord=1), self.n_comp
        )

    def reset(self, n_comp=5):
        self.n_comp = n_comp
        self.data = np.zeros((0, self.dim))
        self.score = np.ones(0)
        self._pi = self._means = self._covs = None
