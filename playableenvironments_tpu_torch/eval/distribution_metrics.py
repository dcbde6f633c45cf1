"""FID / FVD: Fréchet distances over image / video embeddings.

Port of playableenvironments_tpu/eval/distribution_metrics.py.
`IncrementalFID` / `IncrementalFVD` accumulate streaming statistics over any
embedding function (images or clips in as NumPy, one row of features out
per image or clip). The default embedders are VGG19 up to relu4_1
(`VGG19_CUTS[:4]`), globally mean-pooled; the video embedder concatenates
the temporal mean and standard deviation of its frames' embeddings. No
trained weights ship with the repo: the defaults draw theirs from a seeded
torch generator (eval.perceptual.init_vgg19), so their distances are
self-consistent across the port's runs with one seed, and neither equal to
the JAX package's (whose weights come from `jax.random.PRNGKey(0)`) nor
comparable with published Inception/I3D numbers. An InceptionV3 with
user-supplied weights (eval.inception_v3) plugs in through the same
interface.

The networks run on the embedder's device, `EMBED_CHUNK` images a forward
pass, so that a whole camera's frames at full resolution fit the card; the
result is the one of a single pass up to the order of f32 sums.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from playableenvironments_tpu_torch.eval.metrics import FeatureStatistics, frechet_distance
from playableenvironments_tpu_torch.eval.perceptual import VGGFeatures, init_vgg19
from playableenvironments_tpu_torch.utils.device import resolve_device

EmbedFn = Callable[[np.ndarray], np.ndarray]

EMBED_CHUNK = 16  # images a forward pass of a metric network


@torch.no_grad()
def embed_in_chunks(fn: Callable[[torch.Tensor], torch.Tensor], images: np.ndarray, device) -> torch.Tensor:
    """fn over (N, ...) images, EMBED_CHUNK at a time on `device`,
    concatenated there."""
    outs = [fn(torch.as_tensor(np.asarray(images[i:i + EMBED_CHUNK]), dtype=torch.float32).to(device))
            for i in range(0, len(images), EMBED_CHUNK)]
    return torch.cat(outs)


def pooled_vgg_features(net: VGGFeatures) -> Callable[[torch.Tensor], torch.Tensor]:
    """(N, H, W, 3) -> (N, F): the last cut's activations, mean-pooled."""
    return lambda images: torch.mean(net(images)[-1], dim=(2, 3))


def default_image_embedder(device="cuda") -> EmbedFn:
    """VGG19 to relu4_1 on seeded random weights, globally average-pooled:
    images (N, H, W, 3) in [0, 1] -> (N, 512)."""
    device = resolve_device(device)
    embed = pooled_vgg_features(init_vgg19(cuts=4, device=device, seed=0))

    def fn(images: np.ndarray) -> np.ndarray:
        return embed_in_chunks(embed, images, device).cpu().numpy()

    return fn


def default_video_embedder(device="cuda") -> EmbedFn:
    """Per-frame VGG19 features and their temporal mean and (population)
    standard deviation: videos (N, T, H, W, 3) in [0, 1] -> (N, 1024)."""
    device = resolve_device(device)
    embed = pooled_vgg_features(init_vgg19(cuts=4, device=device, seed=0))

    def fn(videos: np.ndarray) -> np.ndarray:
        videos = np.asarray(videos)
        n, t = videos.shape[:2]
        pooled = embed_in_chunks(embed, videos.reshape((-1,) + videos.shape[2:]), device).reshape(n, t, -1)
        return torch.cat([torch.mean(pooled, dim=1), torch.std(pooled, dim=1, unbiased=False)], dim=-1).cpu().numpy()

    return fn


class IncrementalFrechet:
    """Streaming two-population Fréchet distance over an embedding function."""

    def __init__(self, embed_fn: EmbedFn):
        self.embed_fn = embed_fn
        self._stats_a: Optional[FeatureStatistics] = None
        self._stats_b: Optional[FeatureStatistics] = None

    def _update(self, which: str, batch: np.ndarray):
        features = self.embed_fn(batch)
        attr = f"_stats_{which}"
        stats = getattr(self, attr)
        if stats is None:
            stats = FeatureStatistics(features.shape[1])
            setattr(self, attr, stats)
        stats.update(features)

    def update_reference(self, batch: np.ndarray):
        self._update("a", batch)

    def update_generated(self, batch: np.ndarray):
        self._update("b", batch)

    def compute(self) -> float:
        if self._stats_a is None or self._stats_b is None:
            raise ValueError("both populations need at least one batch")
        return frechet_distance(*self._stats_a.finalize(), *self._stats_b.finalize())


def IncrementalFID(embed_fn: Optional[EmbedFn] = None, device="cuda") -> IncrementalFrechet:
    return IncrementalFrechet(embed_fn or default_image_embedder(device=device))


def IncrementalFVD(embed_fn: Optional[EmbedFn] = None, device="cuda") -> IncrementalFrechet:
    return IncrementalFrechet(embed_fn or default_video_embedder(device=device))
