"""The port's drawing and scene viewer (utils/drawing.py,
utils/scene_viewer.py) against the JAX package's on the same inputs.

- `draw_boxes` and `draw_axes` (cv2 copies): pixels equal to JAX's.
- `save_feature_maps` (matplotlib's jet as a NumPy table, written with
  Pillow): every channel's PNG within 1/255 of the one JAX's `plt.imsave`
  writes (measured: equal).
- `view_scene` (Pillow through a fixed projection): its segments
  (`scene_geometry`: the boxes' 12 edges after o2w, object by object, then
  the strided rays) within 1e-6 of the lines of the figure JAX's returns
  (`get_data_3d()`), its camera points equal to the scatter's, and its PNG
  written.
No device: the drawing is host NumPy and Pillow.
"""

import os

import matplotlib
import numpy as np
import pytest
from PIL import Image

from playableenvironments_tpu.utils import drawing as jax_drawing
from playableenvironments_tpu.utils import scene_viewer as jax_viewer
from playableenvironments_tpu_torch.utils import drawing, scene_viewer
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

matplotlib.use("Agg")


def frames(rng):
    return {"float": rng.uniform(0, 1, (32, 48, 3)).astype(np.float32),
            "uint8": rng.integers(0, 256, (40, 64, 3)).astype(np.uint8)}


@pytest.mark.parametrize("kind", ["float", "uint8"])
def test_boxes_and_axes_draw_the_pixels_jax_draws(kind):
    rng = np.random.default_rng(0)
    frame = frames(rng)[kind]
    boxes = np.asarray([[0.2, 0.2, 0.6, 0.8], [0.05, 0.5, 0.4, 0.95], [0.7, 0.1, 0.9, 0.3], [0.1, 0.1, 0.9, 0.9]])
    validity = np.asarray([True, True, False, True])
    for kwargs in (dict(), dict(validity=validity), dict(validity=validity, labels=["p1", "p2", "p3", "p4"])):
        got = drawing.draw_boxes(frame, boxes, **kwargs)
        ref = jax_drawing.draw_boxes(frame, boxes, **kwargs)
        assert got.dtype == np.uint8 and np.array_equal(got, ref)
        assert not np.array_equal(got, jax_drawing._as_uint8(frame))
    for translation, rotation_z in (([0.0, 0.0, -5.0], 0.0), ([0.5, -0.3, -4.0], 0.7), ([0.0, 0.0, 0.5], 0.0)):
        o2w = np.eye(4)
        o2w[:3, 3] = translation
        o2w[:2, :2] = [[np.cos(rotation_z), -np.sin(rotation_z)], [np.sin(rotation_z), np.cos(rotation_z)]]
        w2c = np.eye(4)
        w2c[:3, 3] = [0.1, 0.0, -0.2]
        got = drawing.draw_axes(frame, o2w, w2c, focal=30.0, axis_length=0.8)
        assert np.array_equal(got, jax_drawing.draw_axes(frame, o2w, w2c, focal=30.0, axis_length=0.8))


def read(path):
    with Image.open(path) as image:
        return np.asarray(image.convert("RGBA")).astype(np.int16)


def test_feature_maps_match_jax_within_one_level(tmp_path):
    rng = np.random.default_rng(1)
    features = rng.normal(size=(5, 12, 20)).astype(np.float32)
    features[3] = 2.5  # a constant channel
    features[4, 0, 0] = 40.0  # one far peak
    drawing.save_feature_maps(features, str(tmp_path / "port"))
    jax_drawing.save_feature_maps(features, str(tmp_path / "jax"))
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [f"{i:05d}.png" for i in range(5)]
    for name in names:
        got, ref = read(tmp_path / "port" / name), read(tmp_path / "jax" / name)
        assert got.shape == ref.shape == (12, 20, 4)
        assert np.abs(got - ref).max() <= 1, name
    np.testing.assert_allclose(drawing.jet_table(), matplotlib.colormaps["jet"](np.arange(256)), rtol=0, atol=1e-12)


def scene(rng, rays=200):
    boxes = [np.asarray([[-1.0, 1.0], [-1.0, 1.0], [0.0, 2.0]]), np.asarray([[-5.0, 5.0], [-5.0, 5.0], [-0.5, 0.0]]),
             np.asarray([[-0.6, 0.6], [-0.3, 0.3], [0.0, 1.8]])]
    o2w = [np.eye(4) for _ in boxes]
    o2w[0][:3, 3] = [2.0, 1.0, 0.0]
    angle = 0.6
    o2w[2][:2, :2] = [[np.cos(angle), -np.sin(angle)], [np.sin(angle), np.cos(angle)]]
    o2w[2][:3, 3] = [-3.0, 2.0, 0.1]
    return dict(boxes=boxes, o2w_matrices=o2w, camera_positions=np.asarray([[0.0, -10.0, 3.0], [4.0, -8.0, 2.0]]),
                ray_origins=np.asarray([[0.0, -10.0, 3.0]]),
                ray_directions=rng.normal(size=(rays, 3)).astype(np.float32), ray_length=7.5, max_rays=16)


def test_scene_viewer_segments_match_the_lines_of_jax_figure(tmp_path):
    import matplotlib.pyplot as plt

    args = scene(np.random.default_rng(2))
    fig = jax_viewer.view_scene(**args)
    try:
        ax = fig.axes[0]
        lines = [np.stack(line.get_data_3d(), axis=-1) for line in ax.lines]
        cameras = np.asarray(ax.collections[0]._offsets3d).T
    finally:
        plt.close(fig)
    geometry = scene_viewer.scene_geometry(**args)
    segments = [edge for box in geometry["boxes"] for edge in box] + list(geometry["rays"])
    assert len(segments) == len(lines) == 12 * 3 + len(range(0, 200, 200 // 16))
    for k, (got, ref) in enumerate(zip(segments, lines)):
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6, err_msg=f"line {k}")
    np.testing.assert_array_equal(geometry["cameras"], cameras)

    path = scene_viewer.view_scene(**args, output_path=str(tmp_path / "views" / "scene.png"))
    assert path == str(tmp_path / "views" / "scene.png")
    with Image.open(path) as image:
        assert image.size == (scene_viewer.SIZE, scene_viewer.SIZE)
        pixels = np.asarray(image.convert("RGB"))
    assert (pixels != 255).any(axis=-1).mean() > 0.005  # lines were drawn
    assert isinstance(scene_viewer.view_scene(args["boxes"]), Image.Image)
