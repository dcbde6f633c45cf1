"""Tennis-court world model: line-intersection keypoints of a regulation
court (public ITF dimensions), the planar field used for camera calibration
(dataset/calibration/tennis/tennis_calibration.py's world_points).

Copy of playableenvironments_tpu/acquisition/tennis_court.py (the port imports
nothing of the JAX package).

World frame: origin at court center, x right, y toward the far baseline,
z up out of the court plane.
"""

from __future__ import annotations

import numpy as np

SINGLES_HALF_WIDTH = 4.115  # meters
DOUBLES_HALF_WIDTH = 5.485
SERVICE_HALF_LENGTH = 6.40
BASELINE_HALF_LENGTH = 11.885


def court_keypoints() -> np.ndarray:
    """(19, 3) court line intersections, z = 0."""
    xs, xd = SINGLES_HALF_WIDTH, DOUBLES_HALF_WIDTH
    ys, yb = SERVICE_HALF_LENGTH, BASELINE_HALF_LENGTH
    points = [
        (-xd, yb), (-xs, yb), (xs, yb), (xd, yb),          # far baseline
        (-xs, ys), (0.0, ys), (xs, ys),                    # far service line
        (-xd, 0.0), (-xs, 0.0), (0.0, 0.0), (xs, 0.0), (xd, 0.0),  # net line
        (-xs, -ys), (0.0, -ys), (xs, -ys),                 # near service line
        (-xd, -yb), (-xs, -yb), (xs, -yb), (xd, -yb),      # near baseline
    ]
    return np.asarray([(x, y, 0.0) for x, y in points], np.float32)
