"""Action-movement plots: per-action densities and mean movement vectors.

Port of playableenvironments_tpu/eval/plotting.py, which draws with
matplotlib. The card's machine has no matplotlib, so the port computes the
arrays that the JAX module plots (its histograms, 2-D histograms, scatter
points, per-action means and axis limits, each with the NumPy call that
matplotlib makes) in functions of their own, and draws them with Pillow
under the JAX module's file names: `<prefix>density_2d_action_<a>.png`,
`<prefix>density_2d_merged.png`, `<prefix>mean_vectors_2d.png` and the
path given to `plot_density_1d`. The playability evaluator writes them all.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

# matplotlib's "tab10" colours, which the JAX module's scatter and arrows use.
TAB10 = ((31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189), (140, 86, 75),
         (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207))
# Control points of matplotlib's "viridis" (0, 1/4, 1/2, 3/4, 1), for the 2-D histograms.
VIRIDIS = np.asarray([(68, 1, 84), (59, 82, 139), (33, 145, 140), (94, 201, 98), (253, 231, 37)], np.float64)
DPI = 110


def _flatten(actions: np.ndarray, vectors: np.ndarray):
    """Flat actions and the vectors' first two coordinates (the JAX module's
    default axes, the only ones its evaluator plots)."""
    actions = np.reshape(np.asarray(actions), (-1,))
    vectors = np.reshape(np.asarray(vectors), (-1, np.asarray(vectors).shape[-1]))
    return actions, vectors[:, :2]


# ---------------------------------------------------------------------------
# What each figure shows
# ---------------------------------------------------------------------------


def density_1d_histograms(actions: np.ndarray, values: np.ndarray,
                          actions_count: int) -> List[Optional[Tuple[np.ndarray, np.ndarray]]]:
    """Per action, (densities, bin edges) of its values (30 bins, density),
    None for an action without values: what `plot_density_1d` draws."""
    actions = np.reshape(np.asarray(actions), (-1,))
    values = np.reshape(np.asarray(values), (-1,))
    out = []
    for a in range(actions_count):
        sel = values[actions == a]
        out.append(np.histogram(sel, bins=30, density=True) if sel.size else None)
    return out


def density_2d_limits(actions: np.ndarray, vectors: np.ndarray):
    """The 2-D plots' axis limits: the data's range, None without data."""
    _, vectors = _flatten(actions, vectors)
    if not vectors.size:
        return None, None
    return (float(vectors[:, 0].min()), float(vectors[:, 0].max())), \
        (float(vectors[:, 1].min()), float(vectors[:, 1].max()))


def density_2d_histograms(actions: np.ndarray, vectors: np.ndarray,
                          actions_count: int) -> List[Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """Per action, (counts, x edges, y edges) of its 2-D movements (40 x 40
    bins over the limits), None for an action without movements: what
    `plot_density_2d` draws per action."""
    xlim, ylim = density_2d_limits(actions, vectors)
    actions, vectors = _flatten(actions, vectors)
    out = []
    for a in range(actions_count):
        sel = vectors[actions == a]
        out.append(np.histogram2d(sel[:, 0], sel[:, 1], bins=40, range=[xlim, ylim] if xlim and ylim else None)
                   if sel.size else None)
    return out


def merged_points(actions: np.ndarray, vectors: np.ndarray, actions_count: int) -> List[Optional[np.ndarray]]:
    """Per action, its (n, 2) movements, None for an action without any:
    the merged plot's scatter."""
    actions, vectors = _flatten(actions, vectors)
    return [vectors[actions == a] if (actions == a).any() else None for a in range(actions_count)]


def mean_vectors(actions: np.ndarray, vectors: np.ndarray, actions_count: int) -> Tuple[np.ndarray, float]:
    """(per-action mean movements (A, 2), zeros for an action without any;
    the symmetric axis limit, 1.2 x the largest mean coordinate or 1.2):
    what `plot_mean_vectors_2d` draws."""
    actions, vectors = _flatten(actions, vectors)
    means = np.zeros((actions_count, 2))
    for a in range(actions_count):
        sel = vectors[actions == a]
        if sel.size:
            means[a] = sel.mean(0)
    return means, float(np.abs(means).max() or 1.0) * 1.2


# ---------------------------------------------------------------------------
# Drawing (Pillow)
# ---------------------------------------------------------------------------


class _Axes:
    """A Pillow figure of `inches` at DPI with one data frame, a title and
    its limits marked at the frame's corners."""

    MARGIN = (60, 30, 20, 40)  # left, top, right, bottom

    def __init__(self, inches: Tuple[float, float], xlim, ylim, title: str):
        from PIL import Image, ImageDraw

        self.size = (int(inches[0] * DPI), int(inches[1] * DPI))
        self.image = Image.new("RGB", self.size, (255, 255, 255))
        self.draw = ImageDraw.Draw(self.image, "RGBA")
        left, top, right, bottom = self.MARGIN
        self.box = (left, top, self.size[0] - right, self.size[1] - bottom)
        self.xlim = tuple(xlim) if xlim and xlim[1] > xlim[0] else (xlim[0] - 0.5, xlim[0] + 0.5) if xlim else (0, 1)
        self.ylim = tuple(ylim) if ylim and ylim[1] > ylim[0] else (ylim[0] - 0.5, ylim[0] + 0.5) if ylim else (0, 1)
        self.draw.rectangle(self.box, outline=(0, 0, 0))
        self.draw.text((left, 8), title, fill=(0, 0, 0))
        self.draw.text((left, self.box[3] + 6), f"{self.xlim[0]:.3g}", fill=(0, 0, 0))
        self.draw.text((self.box[2] - 40, self.box[3] + 6), f"{self.xlim[1]:.3g}", fill=(0, 0, 0))
        self.draw.text((4, self.box[3] - 10), f"{self.ylim[0]:.3g}", fill=(0, 0, 0))
        self.draw.text((4, top), f"{self.ylim[1]:.3g}", fill=(0, 0, 0))

    def point(self, x: float, y: float) -> Tuple[float, float]:
        x0, y0, x1, y1 = self.box
        u = (x - self.xlim[0]) / (self.xlim[1] - self.xlim[0])
        v = (y - self.ylim[0]) / (self.ylim[1] - self.ylim[0])
        return x0 + u * (x1 - x0), y1 - v * (y1 - y0)

    def zero_lines(self, colour):
        if self.ylim[0] <= 0.0 <= self.ylim[1]:
            self.draw.line([self.point(self.xlim[0], 0.0), self.point(self.xlim[1], 0.0)], fill=colour)
        if self.xlim[0] <= 0.0 <= self.xlim[1]:
            self.draw.line([self.point(0.0, self.ylim[0]), self.point(0.0, self.ylim[1])], fill=colour)

    def legend(self, labels: Sequence[Tuple[str, Tuple[int, int, int]]]):
        for row, (label, colour) in enumerate(labels):
            y = self.box[1] + 6 + 12 * row
            self.draw.rectangle((self.box[2] - 60, y, self.box[2] - 52, y + 8), fill=colour)
            self.draw.text((self.box[2] - 48, y - 2), label, fill=(0, 0, 0))

    def save(self, path: str) -> str:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self.image.save(path)
        return path


def _viridis(values: np.ndarray) -> np.ndarray:
    """Colours of values in [0, 1] along VIRIDIS's control points."""
    positions = np.clip(values, 0.0, 1.0) * (len(VIRIDIS) - 1)
    low = np.minimum(positions.astype(int), len(VIRIDIS) - 2)
    frac = (positions - low)[..., None]
    return (VIRIDIS[low] * (1 - frac) + VIRIDIS[low + 1] * frac).astype(np.uint8)


def plot_density_1d(actions: np.ndarray, values: np.ndarray, actions_count: int, output_path: str,
                    prefix: str = "") -> str:
    """Per-action histogram of a scalar movement statistic (30 bins,
    density), overlaid."""
    histograms = density_1d_histograms(actions, values, actions_count)
    drawn = [h for h in histograms if h is not None]
    xlim = (min(float(e[0]) for _, e in drawn), max(float(e[-1]) for _, e in drawn)) if drawn else None
    ylim = (0.0, max(float(d.max()) for d, _ in drawn) * 1.05) if drawn else None
    ax = _Axes((6, 4), xlim, ylim, f"{prefix}movement density")
    labels = []
    for a, hist in enumerate(histograms):
        if hist is None:
            continue
        density, edges = hist
        colour = TAB10[a % 10]
        for d, lo, hi in zip(density, edges[:-1], edges[1:]):
            (x0, y0), (x1, y1) = ax.point(lo, d), ax.point(hi, 0.0)
            ax.draw.rectangle((x0, y0, max(x1, x0 + 1), y1), fill=colour + (102,))
        labels.append((f"action {a}", colour))
    ax.legend(labels)
    return ax.save(output_path)


def plot_density_2d(actions: np.ndarray, vectors: np.ndarray, actions_count: int, output_directory: str,
                    prefix: str = "", merged: bool = False) -> Sequence[str]:
    """Per-action 2-D histograms of the movement vectors (40 x 40 bins over
    the common limits), or with `merged` one scatter of every action's
    movements. :return: the written paths."""
    xlim, ylim = density_2d_limits(actions, vectors)
    os.makedirs(output_directory, exist_ok=True)
    if merged:
        ax = _Axes((5, 5), xlim, ylim, f"{prefix}movements by action")
        labels = []
        for a, points in enumerate(merged_points(actions, vectors, actions_count)):
            if points is None:
                continue
            colour = TAB10[a % 10]
            for x, y in points:
                px, py = ax.point(x, y)
                ax.draw.ellipse((px - 1.5, py - 1.5, px + 1.5, py + 1.5), fill=colour + (89,))
            labels.append((f"{a}", colour))
        ax.zero_lines((0, 0, 0))
        ax.legend(labels)
        return [ax.save(os.path.join(output_directory, f"{prefix}density_2d_merged.png"))]
    written = []
    for a, hist in enumerate(density_2d_histograms(actions, vectors, actions_count)):
        ax = _Axes((4, 4), xlim, ylim, f"{prefix}action {a}")
        if hist is not None:
            counts, xedges, yedges = hist
            colours = _viridis(counts / max(float(counts.max()), 1.0))
            ax.draw.rectangle(ax.box, fill=tuple(int(c) for c in _viridis(np.zeros(1))[0]))
            for i in range(counts.shape[0]):
                for j in range(counts.shape[1]):
                    if counts[i, j] > 0:
                        (x0, y1), (x1, y0) = ax.point(xedges[i], yedges[j]), ax.point(xedges[i + 1], yedges[j + 1])
                        ax.draw.rectangle((x0, y0, x1, y1), fill=tuple(int(c) for c in colours[i, j]))
        ax.zero_lines((255, 255, 255))
        written.append(ax.save(os.path.join(output_directory, f"{prefix}density_2d_action_{a}.png")))
    return written


def plot_mean_vectors_2d(actions: np.ndarray, vectors: np.ndarray, actions_count: int, output_directory: str,
                         prefix: str = "") -> str:
    """One arrow from the origin to each action's mean movement."""
    means, lim = mean_vectors(actions, vectors, actions_count)
    ax = _Axes((5, 5), (-lim, lim), (-lim, lim), f"{prefix}mean movement by action")
    ax.zero_lines((0, 0, 0))
    origin = np.asarray(ax.point(0.0, 0.0))
    for a in range(actions_count):
        colour = TAB10[a % 10]
        tip = np.asarray(ax.point(*means[a]))
        ax.draw.line([tuple(origin), tuple(tip)], fill=colour, width=2)
        direction = tip - origin
        length = float(np.linalg.norm(direction))
        if length > 1.0:
            unit, normal = direction / length, np.asarray([-direction[1], direction[0]]) / length
            head = [tuple(tip), tuple(tip - 8 * unit + 4 * normal), tuple(tip - 8 * unit - 4 * normal)]
            ax.draw.polygon(head, fill=colour)
        ax.draw.text(tuple(tip + 3), str(a), fill=colour)
    return ax.save(os.path.join(output_directory, f"{prefix}mean_vectors_2d.png"))
