"""Gaussian mixture model by EM (counterpart of ``scann_tpu/utils/gmm.py``).

The EM loop runs on the device: each iteration's E-step (log densities of
every component at once, log-sum-exp responsibilities) and M-step
(``resp.T @ x`` and the responsibility-weighted covariances) stream the
rows in chunks, so no [N, K, D] intermediate exceeds ``CHUNK_BYTES``.
The convergence test reads one float32 difference per iteration on the
host. Covariance types: full (batched Cholesky), diagonal, spherical.

The start is drawn on the host from ``np.random.default_rng(seed)`` in the
JAX package's order (uniform weights, K distinct rows as means, the
per-dimension variance plus the regularizer as covariances), and a fit
whose log-likelihood is not finite is retried with the regularizer times
1e3, up to four times. ``sample`` draws on the host as well, so a model
carried across with ``from_numpy`` samples bit for bit as the JAX one.
"""

from __future__ import annotations

import dataclasses
import enum
import math
from typing import Optional, Tuple, Union

import numpy as np
import torch

from scann_tpu_torch.errors import ScannError
from scann_tpu_torch.types import DEFAULT_DEVICE, require_device
from scann_tpu_torch.utils.linear_algebra import as_rows

# bytes of the [chunk, K, D] float32 intermediates of one row chunk
CHUNK_BYTES = 1 << 30


class CovarianceType(enum.Enum):
    FULL = "Full"
    DIAGONAL = "Diagonal"
    SPHERICAL = "Spherical"


@dataclasses.dataclass
class GmmConfig:
    num_components: int = 2
    covariance_type: CovarianceType = CovarianceType.DIAGONAL
    max_iterations: int = 100
    convergence_threshold: float = 1e-4
    reg_covar: float = 1e-6
    seed: Optional[int] = None


def _row_chunk(k: int, d: int) -> int:
    """Rows a chunk: about four [chunk, K, D] float32 temporaries."""
    return max(1, CHUNK_BYTES // (16 * k * d))


def _log_prob(x: torch.Tensor, means: torch.Tensor, covs: torch.Tensor,
              cov_type: CovarianceType) -> torch.Tensor:
    """[n, K] log densities of the rows ``x`` [n, D] under every
    component. A FULL covariance whose Cholesky fails gives NaN, as the
    JAX package's does."""
    d = x.shape[1]
    diff = x[:, None, :] - means[None, :, :]                     # [n, K, D]
    if cov_type == CovarianceType.FULL:
        chol, info = torch.linalg.cholesky_ex(covs)
        chol = torch.where((info == 0)[:, None, None], chol, float("nan"))
        y = torch.linalg.solve_triangular(chol, diff.permute(1, 2, 0),
                                          upper=False)           # [K, D, n]
        maha = (y * y).sum(dim=1).T
        logdet = 2.0 * torch.log(
            torch.diagonal(chol, dim1=1, dim2=2)).sum(dim=1)
    elif cov_type == CovarianceType.DIAGONAL:
        maha = (diff * diff / covs[None, :, :]).sum(dim=-1)
        logdet = torch.log(covs).sum(dim=-1)
    else:
        maha = (diff * diff).sum(dim=-1) / covs[None, :]
        logdet = d * torch.log(covs)
    return -0.5 * (d * math.log(2.0 * math.pi) + logdet[None, :] + maha)


def _log_resp(x: torch.Tensor, weights: torch.Tensor, means: torch.Tensor,
              covs: torch.Tensor, cov_type: CovarianceType
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(log responsibilities [N, K], mean log-likelihood as a float32
    scalar tensor), over row chunks."""
    step = _row_chunk(*means.shape)
    log_w = torch.log(weights)[None, :]
    out, norms = [], []
    for lo in range(0, x.shape[0], step):
        wlp = _log_prob(x[lo:lo + step], means, covs, cov_type) + log_w
        norm = torch.logsumexp(wlp, dim=1)
        out.append(wlp - norm[:, None])
        norms.append(norm)
    return torch.cat(out), torch.cat(norms).mean()


def _m_step(x: torch.Tensor, resp: torch.Tensor, cov_type: CovarianceType,
            reg_covar: float):
    """(weights [K], means [K, D], covariances) from responsibilities
    ``resp`` [N, K]; the covariances accumulate over row chunks around the
    new means."""
    n, d = x.shape
    k = resp.shape[1]
    nk = resp.sum(dim=0) + 1e-10
    weights = nk / n
    means = (resp.T @ x) / nk[:, None]
    shape = {CovarianceType.FULL: (k, d, d), CovarianceType.DIAGONAL: (k, d),
             CovarianceType.SPHERICAL: (k,)}[cov_type]
    covs = x.new_zeros(shape)
    step = _row_chunk(k, d)
    for lo in range(0, n, step):
        r = resp[lo:lo + step]
        diff = x[lo:lo + step, None, :] - means[None, :, :]      # [n, K, D]
        if cov_type == CovarianceType.FULL:
            covs += (diff * r[:, :, None]).permute(1, 2, 0) @ \
                diff.permute(1, 0, 2)
        elif cov_type == CovarianceType.DIAGONAL:
            covs += torch.einsum("nk,nkd->kd", r, diff * diff)
        else:
            covs += torch.einsum("nk,nkd->k", r, diff * diff)
    if cov_type == CovarianceType.FULL:
        covs = covs / nk[:, None, None] + torch.eye(
            d, device=x.device)[None] * reg_covar
    elif cov_type == CovarianceType.DIAGONAL:
        covs = covs / nk[:, None] + reg_covar
    else:
        covs = covs / (nk * d) + reg_covar
    return weights, means, covs


class GaussianMixture:
    """A mixture of ``num_components`` Gaussians fitted on ``device`` (the
    current CUDA device unless the caller names another). The fitted
    parameters are float64 tensors on the device."""

    def __init__(self, config: Optional[GmmConfig] = None,
                 device: Union[str, torch.device] = DEFAULT_DEVICE):
        self.config = config or GmmConfig()
        self.device = torch.device(device)
        self.weights: Optional[torch.Tensor] = None       # [K]
        self.means: Optional[torch.Tensor] = None         # [K, D]
        self.covariances: Optional[torch.Tensor] = None   # [K,D,D]|[K,D]|[K]
        self.converged = False
        self.num_iterations = 0
        self._log_likelihood = -np.inf

    @classmethod
    def from_numpy(cls, weights, means, covariances,
                   config: Optional[GmmConfig] = None,
                   device: Union[str, torch.device] = DEFAULT_DEVICE
                   ) -> "GaussianMixture":
        """A fitted model from numpy parameters (a JAX model's ``weights``,
        ``means`` and ``covariances``). Without ``config`` the covariance
        type follows the covariances' rank."""
        covariances = np.asarray(covariances, np.float64)
        if config is None:
            config = GmmConfig(
                num_components=len(weights),
                covariance_type=(CovarianceType.FULL, CovarianceType.DIAGONAL,
                                 CovarianceType.SPHERICAL)[
                    3 - covariances.ndim])
        g = cls(config, device=device)
        dev = require_device(g.device)
        g.weights, g.means, g.covariances = (
            torch.tensor(np.asarray(a, np.float64), device=dev)
            for a in (weights, means, covariances))
        return g

    def _estimate_log_resp(self, x) -> Tuple[torch.Tensor, float]:
        lr, ll = _log_resp(as_rows(x, self.device), self.weights.float(),
                           self.means.float(), self.covariances.float(),
                           self.config.covariance_type)
        return lr, float(ll)

    # -- fit ------------------------------------------------------------------
    def fit(self, data) -> "GaussianMixture":
        x = as_rows(data, self.device)
        n, d = x.shape
        cfg = self.config
        k = cfg.num_components
        if n < k:
            raise ScannError.invalid_argument("fewer points than components")

        rng = np.random.default_rng(cfg.seed)
        weights0 = torch.full((k,), 1.0 / k, device=x.device)
        means0 = x[torch.from_numpy(rng.choice(n, k, replace=False)).to(
            x.device)].clone()
        var = x.var(dim=0, unbiased=False)

        # an ill-conditioned FULL covariance makes the float32 Cholesky
        # fail (NaN); retry with a larger regularizer, and raise if the fit
        # never becomes finite
        reg = float(cfg.reg_covar)
        for _attempt in range(4):
            gvar = var + reg
            if cfg.covariance_type == CovarianceType.FULL:
                covs0 = torch.diag(gvar)[None].repeat(k, 1, 1)
            elif cfg.covariance_type == CovarianceType.DIAGONAL:
                covs0 = gvar[None].repeat(k, 1)
            else:
                covs0 = torch.full((k,), float(gvar.mean()), device=x.device)
            weights, means, covs, ll, it, done = self._em(
                x, weights0, means0, covs0, reg)
            if math.isfinite(ll):
                break
            reg *= 1e3
        else:
            raise ScannError.internal(
                "GMM EM diverged to non-finite log-likelihood even with "
                f"reg_covar={reg / 1e3:g}; data may be degenerate")
        self.weights = weights.double()
        self.means = means.double()
        self.covariances = covs.double()
        self._log_likelihood = ll
        self.num_iterations = it
        self.converged = done
        return self

    def _em(self, x, weights, means, covs, reg_covar: float):
        """EM from the given start: each iteration's E-step with the current
        parameters, the M-step, then the convergence test on the E-step's
        log-likelihood sequence. Returns the parameters, the last E-step's
        log-likelihood, the iterations and whether it converged."""
        cfg = self.config
        prev = torch.tensor(float("-inf"), device=x.device)
        ll = prev
        it, done = 0, False
        while it < cfg.max_iterations and not done:
            log_resp, ll = _log_resp(x, weights, means, covs,
                                     cfg.covariance_type)
            weights, means, covs = _m_step(x, log_resp.exp(),
                                           cfg.covariance_type, reg_covar)
            done = bool((ll - prev).abs() < cfg.convergence_threshold)
            prev = ll
            it += 1
        return weights, means, covs, float(ll), it, done

    # -- inference ------------------------------------------------------------
    def predict(self, x) -> torch.Tensor:
        """[N] int32 most likely component of each row."""
        self._check()
        lr, _ = self._estimate_log_resp(x)
        return lr.argmax(dim=1).int()

    def predict_proba(self, x) -> torch.Tensor:
        self._check()
        lr, _ = self._estimate_log_resp(x)
        return lr.exp()

    def score(self, x) -> float:
        """Mean log-likelihood."""
        self._check()
        _, ll = self._estimate_log_resp(x)
        return ll

    def sample(self, n: int, seed: Optional[int] = None) -> torch.Tensor:
        """[n, D] float32 draws on the device, made on the host from
        ``np.random.default_rng(seed)`` in the JAX package's order."""
        self._check()
        rng = np.random.default_rng(seed)
        weights, means, covs = (t.cpu().numpy() for t in (
            self.weights, self.means, self.covariances))
        k, d = means.shape
        comp = rng.choice(k, size=n, p=weights / weights.sum())
        out = np.empty((n, d))
        for j in range(k):
            m = comp == j
            if not m.any():
                continue
            if self.config.covariance_type == CovarianceType.FULL:
                out[m] = rng.multivariate_normal(means[j], covs[j],
                                                 size=int(m.sum()))
            else:
                out[m] = means[j] + rng.normal(size=(int(m.sum()), d)) * \
                    np.sqrt(covs[j])
        return torch.from_numpy(out.astype(np.float32)).to(self.means.device)

    def _n_parameters(self) -> int:
        k, d = self.means.shape
        if self.config.covariance_type == CovarianceType.FULL:
            cov = k * d * (d + 1) // 2
        elif self.config.covariance_type == CovarianceType.DIAGONAL:
            cov = k * d
        else:
            cov = k
        return int(k - 1 + k * d + cov)

    def bic(self, x) -> float:
        """Bayesian information criterion on the rows ``x``."""
        return -2.0 * self.score(x) * len(x) + \
            self._n_parameters() * np.log(len(x))

    def aic(self, x) -> float:
        """Akaike information criterion on the rows ``x``."""
        return -2.0 * self.score(x) * len(x) + 2.0 * self._n_parameters()

    def _check(self):
        if self.means is None:
            raise ScannError.failed_precondition("GMM not fitted")
