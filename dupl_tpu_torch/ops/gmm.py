"""Per-image GMM noise filtering on the device (counterpart of
``dupl_tpu/ops/gmm.py``).

The reference fits a sklearn ``GaussianMixture(n_components=2, max_iter=10,
tol=1e-2, reg_covar=5e-4)`` per image and branch on the foreground CE-loss
values on the host (train_final_voc.py:358-394).  Here the same 1-D
two-component EM runs as batched, masked, fixed-iteration tensor code: the
``> 1000 pixels`` and ``|mu1 - mu0| > thre`` gates are ``where`` masks, so a
step has no data-dependent Python branch and no host sync.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class GmmFit(NamedTuple):
    means: torch.Tensor    # (..., 2)
    var: torch.Tensor      # (..., 2)
    weights: torch.Tensor  # (..., 2) mixing proportions
    count: torch.Tensor    # (...,) number of fitted points


def _weighted_kmeans_init(x: torch.Tensor, w: torch.Tensor,
                          iters: int = 8) -> torch.Tensor:
    """Deterministic 1-D 2-means on weighted points, seeded at the weighted
    min and max: a stand-in for sklearn's k-means init.  -> (..., 2)."""
    big = 1e30
    on = w > 0
    lo = torch.where(on, x, torch.full_like(x, big)).amin(dim=-1)
    hi = torch.where(on, x, torch.full_like(x, -big)).amax(dim=-1)
    mu = torch.stack([lo, hi], dim=-1)
    for _ in range(iters):
        d0 = (x - mu[..., 0:1]).abs()
        d1 = (x - mu[..., 1:2]).abs()
        a1 = (d1 < d0).to(x.dtype)
        a0 = 1.0 - a1
        n0 = (w * a0).sum(dim=-1)
        n1 = (w * a1).sum(dim=-1)
        m0 = (w * a0 * x).sum(dim=-1) / n0.clamp_min(1e-12)
        m1 = (w * a1 * x).sum(dim=-1) / n1.clamp_min(1e-12)
        m0 = torch.where(n0 > 0, m0, mu[..., 0])
        m1 = torch.where(n1 > 0, m1, mu[..., 1])
        mu = torch.stack([m0, m1], dim=-1)
    return mu


def _log_joint(x: torch.Tensor, mu: torch.Tensor, var: torch.Tensor,
               pi: torch.Tensor) -> torch.Tensor:
    """Joint log-densities log(pi_k N(x | mu_k, var_k)): (..., N, 2)."""
    diff = x[..., None] - mu[..., None, :]
    return (-0.5 * (diff * diff) / var[..., None, :]
            - 0.5 * torch.log(2.0 * math.pi * var[..., None, :])
            + torch.log(pi[..., None, :].clamp_min(1e-12)))


def fit_gmm2(x: torch.Tensor, mask: torch.Tensor, *, num_iter: int = 10,
             reg_covar: float = 5e-4, tol: float = 1e-2) -> GmmFit:
    """Fit a two-component 1-D Gaussian mixture to the masked entries of
    ``x``.  x (..., N); mask (..., N) bool: excluded points have zero
    responsibility.  Batched over the leading axes.

    ``tol`` is sklearn's convergence rule: it stops when the mean
    log-likelihood moves less than tol between iterations, so its exit
    parameters are a truncated EM.  Each batch element freezes its
    parameters once its own change falls under tol, inside the fixed-count
    loop."""
    x = x.float()
    w = mask.float()
    count = w.sum(dim=-1)
    wsum = count.clamp_min(1e-12)

    mu = _weighted_kmeans_init(x, w)
    # sklearn's k-means init is a full M step on the hard assignment:
    # per-cluster variances and mixing weights
    near1 = ((x - mu[..., 1:2]).abs() < (x - mu[..., 0:1]).abs()).to(x.dtype)
    a1 = near1 * w
    a0 = (1.0 - near1) * w
    n0 = a0.sum(dim=-1).clamp_min(1e-12)
    n1 = a1.sum(dim=-1).clamp_min(1e-12)
    v0 = (a0 * (x - mu[..., 0:1]) ** 2).sum(dim=-1) / n0 + reg_covar
    v1 = (a1 * (x - mu[..., 1:2]) ** 2).sum(dim=-1) / n1 + reg_covar
    var = torch.stack([v0, v1], dim=-1)
    pi = torch.stack([n0, n1], dim=-1) / wsum[..., None]

    prev_lb = torch.full_like(wsum, -float("inf"))
    done = torch.zeros_like(wsum, dtype=torch.bool)
    for _ in range(num_iter):
        # E step, and the mean log-likelihood that sklearn's tol monitors
        logp = _log_joint(x, mu, var, pi)
        log_norm = torch.logsumexp(logp, dim=-1)               # (..., N)
        lb = (w * log_norm).sum(dim=-1) / wsum
        resp = torch.exp(logp - log_norm[..., None]) * w[..., None]
        # M step
        nk = resp.sum(dim=-2)                                  # (..., 2)
        nk_safe = nk.clamp_min(1e-12)
        mu_new = (resp * x[..., None]).sum(dim=-2) / nk_safe
        d2 = (x[..., None] - mu_new[..., None, :]) ** 2
        var_new = (resp * d2).sum(dim=-2) / nk_safe + reg_covar
        pi_new = nk / wsum[..., None]
        # freeze converged elements where sklearn breaks: the parameters
        # keep this iteration's M step, later iterations change nothing
        keep = done[..., None]
        mu = torch.where(keep, mu, mu_new)
        var = torch.where(keep, var, var_new)
        pi = torch.where(keep, pi, pi_new)
        prev_lb_new = torch.where(done, prev_lb, lb)
        done = done | ((lb - prev_lb).abs() < tol)
        prev_lb = prev_lb_new
    return GmmFit(mu, var, pi, count)


def posterior(fit: GmmFit, x: torch.Tensor) -> torch.Tensor:
    """p(component | x): x (..., N) -> (..., N, 2)."""
    return torch.softmax(_log_joint(x.float(), fit.means, fit.var,
                                    fit.weights), dim=-1)


def gmm_filter_labels(loss_map: torch.Tensor, label: torch.Tensor, *,
                      num_iter: int = 10, reg_covar: float = 5e-4,
                      loss_floor: float = 0.1, min_pixels: int = 1000,
                      valid_thre: float = 1.0, gamma: float = 0.95,
                      ignore_index: int = 255) -> torch.Tensor:
    """Mark noisy pseudo-label pixels as ``ignore_index`` (reference:
    train_final_voc.py:358-394).

    loss_map (B, H, W): detached per-pixel CE of the seg head against its
    own refined label; label (B, H, W).  Per image: fit the mixture on
    foreground-pixel losses above ``loss_floor``; if more than
    ``min_pixels`` such pixels exist and the means are further apart than
    ``valid_thre``, pixels whose posterior of the high-mean ("noise")
    component exceeds ``gamma``, and that are not background, become
    ``ignore_index``."""
    b, h, w = loss_map.shape
    x = loss_map.reshape(b, h * w)
    lab = label.reshape(b, h * w)
    roi = (lab != 0) & (lab != ignore_index)
    fit_mask = roi & (x > loss_floor)

    fit = fit_gmm2(x, fit_mask, num_iter=num_iter, reg_covar=reg_covar)
    post = posterior(fit, x)                                   # (B, HW, 2)
    noise_is_1 = fit.means[..., 1] > fit.means[..., 0]         # argmax of 2
    p_noise = torch.where(noise_is_1[:, None], post[..., 1], post[..., 0])
    valid = (fit.count > min_pixels) & (
        (fit.means[..., 1] - fit.means[..., 0]).abs() > valid_thre)
    noise_mask = (p_noise > gamma) & (lab != 0) & valid[:, None]
    out = torch.where(noise_mask, torch.full_like(lab, ignore_index), lab)
    return out.reshape(b, h, w)
