"""Quality metrics: MSE, motion-masked MSE, PSNR, SSIM, Fréchet distances,
detection matching, and action-space diagnostics.

Port of playableenvironments_tpu/eval/metrics.py. The image metrics take
torch tensors (NHWC float in [0, 1], on any device) and compute where the
tensors lie; the statistics (Fréchet distances, detection matching, the
action-space diagnostics) are the JAX package's NumPy/SciPy code, copied,
in float64 on the host.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def mse(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per-pair MSE over (..., H, W, C) -> (...)."""
    return torch.mean(torch.square(a - b), dim=(-3, -2, -1))


def _median(frames: torch.Tensor) -> torch.Tensor:
    """The median over axis 0, keeping it: the mean of the two middle values
    for an even count (jnp.median's "midpoint"; torch.median takes the
    lower one)."""
    ordered = torch.sort(frames, dim=0).values
    count = frames.shape[0]
    low, high = ordered[(count - 1) // 2], ordered[count // 2]
    return ((low + high) * 0.5)[None]


def motion_mask(frames: torch.Tensor, threshold: float = 0.05) -> torch.Tensor:
    """Boolean (H, W) mask of the pixels that move across a (T, H, W, C)
    sequence: a deviation from the temporal median above `threshold` in any
    channel."""
    deviation = torch.amax(torch.abs(frames - _median(frames)), dim=-1)  # (T, H, W)
    return torch.amax(deviation, dim=0) > threshold


def motion_masked_mse(reference: torch.Tensor, generated: torch.Tensor, threshold: float = 0.05) -> torch.Tensor:
    """MSE restricted to the moving pixels of the reference sequence.

    :param reference, generated: (T, H, W, C) aligned sequences."""
    mask = motion_mask(reference, threshold)[None, ..., None].to(reference.dtype)
    sq = torch.square(reference - generated) * mask
    return torch.sum(sq) / torch.clamp(torch.sum(mask) * reference.shape[0] * reference.shape[-1], min=1)


def psnr(a: torch.Tensor, b: torch.Tensor, max_value: float = 1.0) -> torch.Tensor:
    """Peak signal-to-noise ratio over (..., H, W, C) -> (...) dB."""
    err = torch.clamp(mse(a, b), min=1e-10)
    return 10.0 * torch.log10(max_value ** 2 / err)


def _gaussian_kernel(size: int, sigma: float, device=None) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32, device=device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * torch.square(x / sigma))
    return g / torch.sum(g)


def ssim(a: torch.Tensor, b: torch.Tensor, max_value: float = 1.0, kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Structural similarity (Wang et al. 2004, Gaussian-windowed) over
    (..., H, W, C) -> (...). The Gaussian blur is separable: a grouped
    convolution along H, then one along W, each over the *valid* extent (the
    JAX package's two `jnp.convolve(..., "valid")` passes; the kernel is
    symmetric, so correlation and convolution agree)."""
    c1 = (k1 * max_value) ** 2
    c2 = (k2 * max_value) ** 2
    lead, (height, width, channels) = a.shape[:-3], a.shape[-3:]
    kernel = _gaussian_kernel(kernel_size, sigma, a.device).to(a.dtype)
    along_h = kernel.view(1, 1, kernel_size, 1).repeat(channels, 1, 1, 1)
    along_w = kernel.view(1, 1, 1, kernel_size).repeat(channels, 1, 1, 1)

    def blur(x):
        x = x.reshape((-1, height, width, channels)).permute(0, 3, 1, 2)
        x = F.conv2d(F.conv2d(x, along_h, groups=channels), along_w, groups=channels)
        return x

    mu_a, mu_b = blur(a), blur(b)
    mu_a2, mu_b2, mu_ab = mu_a * mu_a, mu_b * mu_b, mu_a * mu_b
    sigma_a2 = blur(a * a) - mu_a2
    sigma_b2 = blur(b * b) - mu_b2
    sigma_ab = blur(a * b) - mu_ab
    numerator = (2 * mu_ab + c1) * (2 * sigma_ab + c2)
    denominator = (mu_a2 + mu_b2 + c1) * (sigma_a2 + sigma_b2 + c2)
    return torch.mean(numerator / denominator, dim=(-3, -2, -1)).reshape(lead)


# ---------------------------------------------------------------------------
# Fréchet distances (FID / FVD core), float64 on the host
# ---------------------------------------------------------------------------


class FeatureStatistics:
    """Streaming mean/covariance accumulator for Fréchet metrics."""

    def __init__(self, features_count: int):
        self.n = 0
        self.sum = np.zeros(features_count, np.float64)
        self.outer = np.zeros((features_count, features_count), np.float64)

    def update(self, features: np.ndarray):
        """:param features: (N, F) batch of embeddings."""
        features = np.asarray(features, np.float64)
        self.n += features.shape[0]
        self.sum += features.sum(axis=0)
        self.outer += features.T @ features

    def finalize(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.n < 2:
            raise ValueError(f"need at least 2 samples for a covariance estimate, got {self.n}")
        mean = self.sum / self.n
        cov = self.outer / (self.n - 1) - np.outer(mean, mean) * self.n / (self.n - 1)
        return mean, cov


def frechet_distance(mean_a: np.ndarray, cov_a: np.ndarray, mean_b: np.ndarray, cov_b: np.ndarray,
                     eps: float = 1e-6) -> float:
    """Fréchet distance between two Gaussians (the FID/FVD formula), with
    eps*I jitter on both covariances (sample covariances of few frames are
    often singular), a retry at 1e3*eps where sqrtm is not finite, and a
    clamp at 0 (the jitter can push near-identical distributions a hair
    below it)."""
    import scipy.linalg

    if not (np.isfinite(cov_a).all() and np.isfinite(cov_b).all()
            and np.isfinite(mean_a).all() and np.isfinite(mean_b).all()):
        # sqrtm on non-finite matrices can take near-unbounded time.
        return float("nan")
    diff = mean_a - mean_b
    offset = np.eye(cov_a.shape[0]) * eps
    covmean = scipy.linalg.sqrtm((cov_a + offset) @ (cov_b + offset))
    if not np.isfinite(covmean).all():
        covmean = scipy.linalg.sqrtm((cov_a + offset * 1e3) @ (cov_b + offset * 1e3))
    if np.iscomplexobj(covmean):
        covmean = covmean.real
    value = float(diff @ diff + np.trace(cov_a) + np.trace(cov_b) - 2 * np.trace(covmean))
    return max(value, 0.0)


def frechet_from_features(features_a: np.ndarray, features_b: np.ndarray) -> float:
    sa = FeatureStatistics(features_a.shape[1])
    sa.update(features_a)
    sb = FeatureStatistics(features_b.shape[1])
    sb.update(features_b)
    return frechet_distance(*sa.finalize(), *sb.finalize())


# ---------------------------------------------------------------------------
# Detection metrics (MDR / ADD)
# ---------------------------------------------------------------------------


def greedy_box_matching(reference_centers: np.ndarray, detected_centers: np.ndarray) -> List[Tuple[int, int, float]]:
    """Greedy nearest-center matching between reference and detected boxes.

    :param reference_centers: (R, 2); detected_centers (D, 2), both normalized.
    :return: list of (ref_idx, det_idx, distance) matches (each used once)."""
    matches = []
    used_ref, used_det = set(), set()
    if len(reference_centers) == 0 or len(detected_centers) == 0:
        return matches
    distances = np.linalg.norm(reference_centers[:, None, :] - detected_centers[None, :, :], axis=-1)
    order = np.dstack(np.unravel_index(np.argsort(distances, axis=None), distances.shape))[0]
    for r, d in order:
        if r in used_ref or d in used_det:
            continue
        used_ref.add(int(r))
        used_det.add(int(d))
        matches.append((int(r), int(d), float(distances[r, d])))
    return matches


class DetectionScore:
    """Missed detection rate + average detection distance accumulator."""

    def __init__(self, match_threshold: float = 0.1):
        self.match_threshold = match_threshold
        self.total_reference = 0
        self.matched = 0
        self.distance_sum = 0.0

    def update(self, reference_centers: np.ndarray, detected_centers: np.ndarray):
        self.total_reference += len(reference_centers)
        for _, _, dist in greedy_box_matching(reference_centers, detected_centers):
            if dist <= self.match_threshold:
                self.matched += 1
                self.distance_sum += dist

    def results(self) -> Dict[str, float]:
        mdr = 1.0 - self.matched / max(self.total_reference, 1)
        add = self.distance_sum / max(self.matched, 1)
        return {"missed_detection_rate": mdr, "average_detection_distance": add}


# ---------------------------------------------------------------------------
# Action-space diagnostics
# ---------------------------------------------------------------------------


def action_variance(movements: np.ndarray, actions: np.ndarray, actions_count: int) -> Dict[str, float]:
    """Per-action movement variance against the global variance.

    :param movements: (N, D); actions (N,) integer labels."""
    movements = np.asarray(movements)
    actions = np.asarray(actions)
    global_variance = float(movements.var(axis=0).mean())
    per_action = []
    for a in range(actions_count):
        mask = actions == a
        if mask.sum() >= 2:
            per_action.append(float(movements[mask].var(axis=0).mean()))
    within = float(np.mean(per_action)) if per_action else float("nan")
    return {
        "global_movement_variance": global_variance,
        "mean_within_action_variance": within,
        "variance_ratio": within / global_variance if global_variance > 0 else float("nan"),
    }


def _fit_logistic_probe(x: np.ndarray, labels: np.ndarray, classes: int) -> np.ndarray:
    """scikit-learn LogisticRegression(max_iter=1000)'s fit without
    scikit-learn: its objective, the mean log-loss plus ||W||^2 / (2 C n), C 1
    (intercepts not penalized; binary for two classes, one weight vector,
    multinomial otherwise), minimized from zeros by SciPy's L-BFGS-B with
    its options (gtol 1e-4, ftol 64 eps, 50 line-search steps, 1000
    iterations), so that the iterates, and where it stops, are its own.
    :return: the (features + 1, outputs) weights, intercepts in the last row."""
    import scipy.optimize
    import scipy.special

    n, d = x.shape
    design = np.concatenate([x, np.ones((n, 1))], axis=1)
    outputs = 1 if classes == 2 else classes
    target = (labels == 1).astype(np.float64)[:, None] if classes == 2 else np.eye(classes)[labels]
    penalized = np.ones((d + 1, outputs))
    penalized[-1] = 0.0
    strength = 1.0 / n  # 1 / (C n)

    def objective(flat):
        w = flat.reshape(d + 1, outputs)
        logits = design @ w
        if classes == 2:
            loss = np.sum(np.logaddexp(0.0, logits) - target * logits)
            residual = scipy.special.expit(logits) - target
        else:
            log_norm = scipy.special.logsumexp(logits, axis=1, keepdims=True)
            loss = np.sum(log_norm - np.sum(target * logits, axis=1, keepdims=True))
            residual = np.exp(logits - log_norm) - target
        loss = loss / n + 0.5 * strength * np.sum(penalized * w * w)
        grad = design.T @ residual / n + strength * penalized * w
        return loss, grad.ravel()

    result = scipy.optimize.minimize(
        objective, np.zeros((d + 1) * outputs), jac=True, method="L-BFGS-B",
        options={"maxiter": 1000, "maxls": 50, "gtol": 1e-4, "ftol": 64 * np.finfo(float).eps})
    return result.x.reshape(d + 1, outputs)


def action_classification_score(movements: np.ndarray, actions: np.ndarray) -> float:
    """Linear-probe accuracy predicting the inferred action from the observed
    movement (how well actions partition movement space): an L2 logistic
    regression (C 1), scored on its own training set. The JAX package fits
    scikit-learn's LogisticRegression(max_iter=1000), which the card's
    machine lacks; `_fit_logistic_probe` is that fit."""
    movements = np.asarray(movements, np.float64)
    actions = np.asarray(actions)
    classes, labels = np.unique(actions, return_inverse=True)
    if len(classes) < 2:
        return float("nan")
    weights = _fit_logistic_probe(movements, labels, len(classes))
    logits = np.concatenate([movements, np.ones((len(movements), 1))], axis=1) @ weights
    predicted = (logits[:, 0] > 0).astype(int) if len(classes) == 2 else logits.argmax(axis=1)
    return float((predicted == labels).mean())


def delta_mse_action_accuracy(movements: np.ndarray, actions: np.ndarray, actions_count: int) -> float:
    """Δ-MSE accuracy: classify each movement by the nearest per-action mean
    movement; the fraction where the inferred action wins."""
    movements = np.asarray(movements)
    actions = np.asarray(actions)
    means = np.stack([
        movements[actions == a].mean(axis=0) if (actions == a).any() else np.full(movements.shape[1], np.inf)
        for a in range(actions_count)
    ])
    distances = np.linalg.norm(movements[:, None, :] - means[None], axis=-1)
    predicted = distances.argmin(axis=1)
    return float((predicted == actions).mean())


def inception_score(class_probabilities: np.ndarray, splits: int = 1, eps: float = 1e-12) -> float:
    """Inception Score from per-image class probabilities:
    exp(E_x[KL(p(y|x) || p(y))]) averaged over splits.

    :param class_probabilities: (N, classes), rows summing to 1."""
    p = np.asarray(class_probabilities, np.float64)
    n = p.shape[0]
    scores = []
    for split in np.array_split(np.arange(n), splits):
        part = p[split]
        marginal = part.mean(axis=0, keepdims=True)
        kl = np.sum(part * (np.log(part + eps) - np.log(marginal + eps)), axis=1)
        scores.append(np.exp(kl.mean()))
    return float(np.mean(scores))
