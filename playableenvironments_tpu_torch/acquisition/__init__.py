"""Offline data-acquisition pipeline.

Port of playableenvironments_tpu/acquisition/. Builds on-disk datasets in
the framework's (reference-compatible) format:
- minecraft: ReplayMod-style recording JSON -> camera/object poses, projected
  boxes, frame extraction (dataset/acquisition/minecraft/*).
- tennis: planar-court camera calibration, detector-based player boxes,
  sequence extraction (dataset/acquisition/tennis/*, dataset/calibration/*).
- shared: train/val/test splitting and fixed-length fragmenting
  (dataset/acquisition/utils/*).
Every module but `boxes` is a NumPy copy of the JAX package's; `boxes` runs
the port's player detector, on the card unless the trainer was built on the
CPU.
"""
