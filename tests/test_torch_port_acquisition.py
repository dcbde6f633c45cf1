"""The port's acquisition pipeline (acquisition/, cli/acquire.py) against the
JAX package's on the same inputs, tests/test_acquisition.py's ten cases:

- geometry and calibration: every output within 1e-9 of JAX's (the same
  NumPy code); the geometry also against the port's core/transforms3d.py,
  as JAX's test holds it against core.transforms3d;
- replay recording, split, fragment, boxes from an injected detector and
  the tennis and Minecraft ingests: the trees written by the port and by
  JAX compared file by file, frames (PNG) bit for bit and annotation
  pickles field by field (exactly); the tennis ingest decodes a tiny cv2
  mp4 (ffmpeg where it is on the PATH, else cv2, in both packages); the
  Minecraft ingest ends with one phase-2 step of the port's cli/train.py
  --device cpu on the ingested data;
- boxes from a detector: JAX's CenterNetDetector at seeded values, carried
  over with compat/from_flax.py::load_detector, both
  `annotate_dataset_boxes` trees within 1e-5 (boxes; validity equal);
- every `acquire` subcommand through the port's CLI on the CPU, `boxes`
  from a port detector checkpoint with --device cpu (the card by default:
  without one it raises).
"""

import json
import os
import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from PIL import Image

from playableenvironments_tpu.acquisition import boxes as jax_boxes
from playableenvironments_tpu.acquisition import field_calibration as jax_calibration
from playableenvironments_tpu.acquisition import geometry as jax_geometry
from playableenvironments_tpu.acquisition import replay_parser as jax_replay
from playableenvironments_tpu.acquisition import splits as jax_splits
from playableenvironments_tpu.train import trainer_detector as jax_td
from playableenvironments_tpu.train.state import TrainState
from playableenvironments_tpu_torch.acquisition import boxes, field_calibration, geometry, replay_parser, splits
from playableenvironments_tpu_torch.acquisition.tennis_court import court_keypoints
from playableenvironments_tpu_torch.compat.from_flax import load_detector
from playableenvironments_tpu_torch.core import transforms3d
from playableenvironments_tpu_torch.data import video as port_video
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.data.synthetic import make_synthetic_dataset
from playableenvironments_tpu_torch.train import checkpointing
from playableenvironments_tpu_torch.train import trainer_detector as td
from test_torch_port_detector import FEATURES, jax_variables
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRY_ATOL = 1e-9
BOX_ATOL = 1e-5


# ---------------------------------------------------------------------------
# Trees compared file by file
# ---------------------------------------------------------------------------


def same(got, ref, atol, where):
    """Field by field: poses by rotation and translation, arrays by shape
    and value (within atol), containers element by element."""
    if isinstance(ref, port_video.PoseParametersNumpy) or hasattr(ref, "translation"):
        same(got.rotation, ref.rotation, atol, where + ".rotation")
        same(got.translation, ref.translation, atol, where + ".translation")
    elif isinstance(ref, np.ndarray) or isinstance(got, np.ndarray):
        got, ref = np.asarray(got), np.asarray(ref)
        assert got.shape == ref.shape and got.dtype == ref.dtype, where
        if ref.dtype.kind in "fc":
            np.testing.assert_allclose(got, ref, rtol=0, atol=atol, err_msg=where)
        else:
            np.testing.assert_array_equal(got, ref, err_msg=where)
    elif isinstance(ref, (list, tuple)):
        assert type(got) is type(ref) and len(got) == len(ref), where
        for i, (g, r) in enumerate(zip(got, ref)):
            same(g, r, atol, f"{where}[{i}]")
    elif isinstance(ref, dict):
        assert set(got) == set(ref), where
        for k in ref:
            same(got[k], ref[k], atol, f"{where}[{k!r}]")
    elif isinstance(ref, float):
        assert abs(got - ref) <= atol, where
    else:
        assert got == ref, where


def files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root) for d, _, names in os.walk(root) for f in names)


def compare_trees(got_root, ref_root, atol=0.0):
    """Frames bit for bit, pickles field by field, other files byte for byte."""
    names = files(ref_root)
    assert names and files(got_root) == names
    for name in names:
        got, ref = os.path.join(got_root, name), os.path.join(ref_root, name)
        if name.endswith(".png"):
            with Image.open(got) as g, Image.open(ref) as r:
                np.testing.assert_array_equal(np.asarray(g), np.asarray(r), err_msg=name)
        elif name.endswith(".pkl"):
            same(port_video._load_pickle(got), port_video._load_pickle(ref), atol, name)
        else:
            with open(got, "rb") as g, open(ref, "rb") as r:
                assert g.read() == r.read(), name
    return names


def run_cli(module, *args):
    argv = sys.argv
    sys.argv = [module.__name__] + [str(a) for a in args]
    try:
        return module.main()
    finally:
        sys.argv = argv


def jax_acquire(*args):
    from playableenvironments_tpu.cli import acquire

    return run_cli(acquire, *args)


def port_acquire(*args):
    from playableenvironments_tpu_torch.cli import acquire

    return run_cli(acquire, *args)


# ---------------------------------------------------------------------------
# Geometry and calibration
# ---------------------------------------------------------------------------


def test_geometry_matches_jax_and_the_port_transforms():
    rng = np.random.default_rng(0)
    rotation, translation = rng.uniform(-1.2, 1.2, 3), rng.uniform(-5, 5, 3)
    got = geometry.pose_to_matrix(rotation, translation)
    np.testing.assert_allclose(got, jax_geometry.pose_to_matrix(rotation, translation), rtol=0, atol=GEOMETRY_ATOL)
    expected = transforms3d.euler_translation_to_matrix(torch.from_numpy(rotation), torch.from_numpy(translation))
    np.testing.assert_allclose(got, expected.numpy(), rtol=0, atol=GEOMETRY_ATOL)
    for name, args in (("euler_to_matrix", (rotation,)), ("matrix_to_euler_translation", (got,)),
                       ("invert_pose", (got,)), ("transform_points", (rng.normal(size=(7, 3)), got))):
        same(getattr(geometry, name)(*args), getattr(jax_geometry, name)(*args), GEOMETRY_ATOL, name)
    recovered_rot, recovered_trans = geometry.matrix_to_euler_translation(got)
    np.testing.assert_allclose(recovered_rot, rotation, atol=1e-6)
    np.testing.assert_allclose(recovered_trans, translation, atol=1e-6)
    np.testing.assert_allclose(geometry.invert_pose(got) @ got, np.eye(4), atol=1e-6)


def test_project_box_matches_jax_valid_and_behind_the_camera():
    box = np.asarray([(-0.2, 0.2), (0.0, 0.5), (-0.2, 0.2)])
    w2c = np.eye(4)  # camera at the origin looking down -z
    for z, valid in ((-5.0, True), (5.0, False)):
        o2w = geometry.pose_to_matrix([0, 0.3, 0], [0.4, 0.0, z])
        got = geometry.project_box_to_image(box, o2w, w2c, 300.0, 240, 320)
        same(got, jax_geometry.project_box_to_image(box, o2w, w2c, 300.0, 240, 320), 0.0, "project")
        assert got[1] == valid and (not valid or 0.0 <= got[0][0] < got[0][2] <= 1.0)


def court_view(rot, trans, focal, size):
    """tests/test_acquisition.py's `_synthetic_court_view`."""
    width, height = size
    world = court_keypoints().astype(np.float64)
    w2c = geometry.invert_pose(geometry.pose_to_matrix(rot, trans))
    cam = world @ w2c[:3, :3].T + w2c[:3, 3]
    proj = -cam[:, :2] / cam[:, 2:3] * focal
    proj[:, 1] *= -1
    proj += np.asarray([width / 2, height / 2])
    return world, proj


@pytest.mark.parametrize("noise", [0.0, 1.0])
def test_calibration_matches_jax(noise):
    """Exact keypoints (the pose recovered) and 1-pixel noise (reprojection
    under 3 pixels, the focal within 5%)."""
    rot, trans, focal, size = ((np.asarray([1.2, 0.05, -0.02]), np.asarray([1.5, -25.0, 8.0]), 1400.0, (2560, 1440))
                               if noise == 0.0 else
                               (np.asarray([1.25, 0.0, 0.0]), np.asarray([0.0, -22.0, 7.0]), 1300.0, (1920, 1080)))
    world, proj = court_view(rot, trans, focal, size)
    proj = proj + np.random.default_rng(3).normal(0, noise, proj.shape)
    got = field_calibration.calibrate_camera(world, proj, size)
    same(got, jax_calibration.calibrate_camera(world, proj, size), GEOMETRY_ATOL, "calibration")
    error = field_calibration.reprojection_error(world, proj, size, *got)
    assert abs(error - jax_calibration.reprojection_error(world, proj, size, *got)) <= GEOMETRY_ATOL
    same(field_calibration.homography_dlt(world[:, :2], proj), jax_calibration.homography_dlt(world[:, :2], proj),
         GEOMETRY_ATOL, "homography")
    if noise == 0.0:
        np.testing.assert_allclose(got[0], rot, atol=1e-4)
        np.testing.assert_allclose(got[1], trans, atol=1e-2)
        assert abs(got[2] - focal) < 1.0
    else:
        assert error < 3.0 and abs(got[2] - focal) / focal < 0.05


# ---------------------------------------------------------------------------
# Minecraft replay parsing
# ---------------------------------------------------------------------------


def test_rotation_conversion_matches_jax():
    for value, wrap in ((0.0, False), (-90.0, False), (270.0, True), (123.4, True), (-700.0, False)):
        assert replay_parser.minecraft_rotation_to_dataset(value, wrap) == \
            jax_replay.minecraft_rotation_to_dataset(value, wrap)
    assert replay_parser.minecraft_rotation_to_dataset(-90.0) == pytest.approx(np.pi / 2)
    assert replay_parser.focal_from_fov(64, 1.0) == jax_replay.focal_from_fov(64, 1.0)


def write_replay(directory, frames=6, fps=2, entities=2):
    """tests/test_acquisition.py's `_write_replay`."""
    timesteps = []
    for t in range(frames):
        objects = [{"uuid": f"player-{k}", "posX": 100.0 + k * 2.0 + 0.1 * t, "posY": 64.0, "posZ": 95.0 + k,
                    "rotX": 0.0, "rotY": 0.0, "rotZ": 0.0} for k in range(entities)]
        timesteps.append({"camera": {"posX": 100.0, "posY": 68.0, "posZ": 110.0, "rotX": -20.0, "rotY": 0.0,
                                     "rotZ": 0.0},
                          "entities": {"objects": objects}})
    annotations = {"camera_intrinsics": {"image_height": 64, "image_width": 96, "y_fov": 1.0, "z_near": 0.1,
                                         "z_far": 100.0},
                   "framerate": fps, "timesteps": timesteps}
    ann_path = os.path.join(directory, "recording.json")
    with open(ann_path, "w") as f:
        json.dump(annotations, f)
    split_path = os.path.join(directory, "splits.txt")
    with open(split_path, "w") as f:
        f.write("# world center\n100 64 100\n0 2\n2 3\n")
    return ann_path, split_path


def write_mp4(path, frames, size, fps, draw):
    cv2 = pytest.importorskip("cv2")
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), fps, size)
    assert writer.isOpened(), "cv2 mp4v writer unavailable"
    for i in range(frames):
        writer.write(draw(i))
    writer.release()
    return path


def test_replay_recording_exports_the_tree_jax_exports(tmp_path):
    ann, split_file = write_replay(str(tmp_path))
    recording = replay_parser.ReplayRecording(ann, split_file)
    reference = jax_replay.ReplayRecording(ann, split_file)
    assert recording.world_center == reference.world_center == [100, 64, 100]
    assert recording.splits == reference.splits and len(recording.splits) == 2
    video = recording.build_split_video(0)
    assert video.frames_count == 4 and video.cameras[0].translation[1] == pytest.approx(4.0)
    assert np.asarray(video.bounding_boxes[0]).shape == (4, 2)
    written = recording.export(str(tmp_path / "port"), extract_frames=False)
    reference.export(str(tmp_path / "jax"), extract_frames=False)
    assert len(written) == 2
    names = compare_trees(tmp_path / "port", tmp_path / "jax")
    assert any(n.endswith("object_poses.pkl") for n in names)
    loaded = port_video.Video().load(os.path.join(written[0], "00000"))
    assert len(loaded.cameras) == 4 and loaded.object_poses is not None


# ---------------------------------------------------------------------------
# Splits, fragments and boxes
# ---------------------------------------------------------------------------


@pytest.fixture()
def flat_dataset(tmp_path):
    """A flat root of three synthetic videos (make_synthetic_dataset's train
    split), written by the port's generator."""
    root = make_synthetic_dataset(str(tmp_path / "src"), videos=3, frames=9, height=8, width=12,
                                  splits=("train",))
    return os.path.join(root, "train")


def test_split_and_fragment_write_the_trees_jax_writes(tmp_path, flat_dataset):
    fractions = (0.34, 0.33, 0.33)
    got = splits.split_dataset(flat_dataset, str(tmp_path / "port_split"), fractions=fractions)
    assert got == jax_splits.split_dataset(flat_dataset, str(tmp_path / "jax_split"), fractions=fractions)
    assert [len(got[k]) for k in ("train", "val", "test")] == [1, 1, 1]
    compare_trees(tmp_path / "port_split", tmp_path / "jax_split")

    count = splits.make_fixed_length(flat_dataset, str(tmp_path / "port_fragments"), fragment_length=4)
    assert count == jax_splits.make_fixed_length(flat_dataset, str(tmp_path / "jax_fragments"), fragment_length=4)
    assert count == 6
    compare_trees(tmp_path / "port_fragments", tmp_path / "jax_fragments")
    fragment = port_video.MulticameraVideo().load(str(tmp_path / "port_fragments" / "00000"))
    assert fragment.frames_count == 4
    assert len(MulticameraVideoDataset(str(tmp_path / "port_fragments"), observations_count=2)) > 0


def fake_detector(frame):
    return np.asarray([[0.1, 0.2, 0.3, 0.6], [0.5, 0.2, 0.7, 0.6]], np.float32), np.asarray([0.8, 0.9], np.float32)


def test_annotated_boxes_of_an_injected_detector_match_jax(tmp_path, flat_dataset):
    for name, annotate in (("port", boxes.annotate_dataset_boxes), ("jax", jax_boxes.annotate_dataset_boxes)):
        shutil.copytree(flat_dataset, tmp_path / name)
        assert annotate(str(tmp_path / name), fake_detector, objects_count=3) == 27
    compare_trees(tmp_path / "port", tmp_path / "jax")
    camera = port_video.Video().load(str(tmp_path / "port" / "00000" / "00000"))
    np.testing.assert_allclose(np.asarray(camera.bounding_boxes[0])[:, 0], [0.5, 0.2, 0.7, 0.6], atol=1e-6)
    np.testing.assert_array_equal(camera.bounding_boxes_validity[0], [True, True, False])
    np.testing.assert_array_equal(np.asarray(camera.bounding_boxes[0])[:, 2], [0.25, 0.25, 0.75, 0.75])


def detectors(threshold):
    """JAX's detector at seeded values and the port's carried over with
    load_detector, each as its package's BoxDetectorFn (top 4)."""
    variables = jax_variables()
    trainer = jax_td.DetectorTrainer(jax_td.DetectorTrainingConfig(base_features=FEATURES))
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None,
                       step=jnp.zeros((), jnp.int32), tx=trainer.tx)
    port = td.DetectorTrainer(td.DetectorTrainingConfig(base_features=FEATURES), device="cpu")
    load_detector(port.model, variables)
    return (port, boxes.detector_boxes_fn(port, top_k=4, threshold=threshold),
            jax_boxes.detector_boxes_fn(trainer, state, top_k=4, threshold=threshold))


@pytest.fixture()
def player_dataset(tmp_path):
    root = make_synthetic_dataset(str(tmp_path / "players"), videos=2, frames=3, height=64, width=64,
                                  splits=("train",))
    return os.path.join(root, "train")


def test_detector_boxes_match_jax_on_carried_over_weights(tmp_path, player_dataset):
    """At a threshold the seeded heatmap crosses on some peaks and not on
    others, so both kept and padded slots are compared."""
    _, port_fn, jax_fn = detectors(threshold=0.195)
    frame = port_video.Video().load(os.path.join(player_dataset, "00000", "00000")).get_frame(0)
    (got_boxes, got_scores), (ref_boxes, ref_scores) = port_fn(frame), jax_fn(frame)
    np.testing.assert_allclose(got_scores, np.asarray(ref_scores), rtol=0, atol=BOX_ATOL)
    np.testing.assert_allclose(got_boxes, np.asarray(ref_boxes), rtol=0, atol=BOX_ATOL)
    for name, fn, annotate in (("port", port_fn, boxes.annotate_dataset_boxes),
                               ("jax", jax_fn, jax_boxes.annotate_dataset_boxes)):
        shutil.copytree(player_dataset, tmp_path / name)
        assert annotate(str(tmp_path / name), fn, objects_count=3) == 6
    compare_trees(tmp_path / "port", tmp_path / "jax", atol=BOX_ATOL)
    validity = [v for name in files(tmp_path / "port") if name.endswith("bounding_box_validity.pkl")
                for v in port_video._load_pickle(tmp_path / "port" / name)]
    assert any(v.any() for v in validity) and any(not v.all() for v in validity)


# ---------------------------------------------------------------------------
# Ingests end to end, and the CLI
# ---------------------------------------------------------------------------


def tennis_inputs(tmp_path):
    """tests/test_acquisition.py's tennis inputs: a 10 fps 64 x 48 mp4 of 30
    frames, the split-relative annotation YAML (two segments that merge,
    one apart) and the court keypoints of a known camera."""
    video = write_mp4(str(tmp_path / "match.mp4"), 30, (64, 48), 10,
                      lambda i: np.full((48, 64, 3), i * 8 % 255, np.uint8))
    annotations = str(tmp_path / "annotations.yaml")
    with open(annotations, "w") as f:
        yaml.safe_dump({"match_split_00000.mp4": [{"start": 0.0, "end": 0.8}, {"start": 1.0, "end": 1.6},
                                                  {"start": 2.2, "end": 2.9}]}, f)
    _, proj = court_view(np.asarray([1.2, 0.05, -0.02]), np.asarray([1.5, -25.0, 8.0]), 1400.0, (2560, 1440))
    points = str(tmp_path / "points.txt")
    with open(points, "w") as f:
        f.writelines(f"{x} {y}\n" for x, y in proj)
    return video, annotations, points


def test_tennis_ingest_end_to_end_writes_the_trees_jax_writes(tmp_path):
    """tennis -> calibrate -> boxes (an injected detector) -> split, each
    subcommand through the port's CLI and through JAX's, the trees compared
    after each step."""
    video, annotations, points = tennis_inputs(tmp_path)
    trees = {}
    for name, acquire, annotate in (("port", port_acquire, boxes.annotate_dataset_boxes),
                                    ("jax", jax_acquire, jax_boxes.annotate_dataset_boxes)):
        raw = str(tmp_path / name / "raw")
        acquire("tennis", "--video", video, "--annotations", annotations, "--splits_duration", "600",
                "--output", raw)
        trees.setdefault("raw", []).append(raw)
        acquire("calibrate", "--image_points", points, "--width", 2560, "--height", 1440, "--camera_dir",
                os.path.join(raw, "00000", "00000"))
        assert annotate(raw, fake_detector, objects_count=2) > 0
        acquire("split", "--root", raw, "--output", str(tmp_path / name / "dataset"), "--train", "0.5", "--val",
                "0.5")
        trees.setdefault("dataset", []).append(str(tmp_path / name / "dataset"))
    for got, ref in trees.values():
        compare_trees(got, ref)
    assert sorted(os.listdir(trees["raw"][0])) == ["00000", "00001"]  # the first two segments merged
    video0 = port_video.Video().load(os.path.join(trees["raw"][0], "00000", "00000"))
    assert video0.frames_count >= 10 and video0.get_frame(0).shape == (48, 64, 3)
    np.testing.assert_allclose(video0.cameras[0].rotation, [1.2, 0.05, -0.02], atol=1e-3)
    assert abs(video0.focals[0] - 1400.0) < 2.0
    found = [len(MulticameraVideoDataset(os.path.join(trees["dataset"][0], s), observations_count=1))
             for s in ("train", "val", "test") if os.listdir(os.path.join(trees["dataset"][0], s))]
    assert found and all(found)


def replay_video(tmp_path):
    def draw(i):
        frame = np.zeros((64, 96, 3), np.uint8)
        frame[:, (i * 12) % 96:(i * 12) % 96 + 12] = 200
        return frame

    return write_mp4(str(tmp_path / "replay.mp4"), 6, (96, 64), 2, draw)


def test_minecraft_ingest_end_to_end_trains_a_port_step(tmp_path):
    """The replay with its rendered video exported with frames by both
    packages (equal trees), then one phase-2 step of the port's cli/train.py
    on the CPU over the ingested data, as JAX's test runs its own CLI."""
    video = replay_video(tmp_path)
    ann, split_file = write_replay(str(tmp_path), frames=6, entities=1)
    written = replay_parser.ReplayRecording(ann, split_file, video_file=video).export(
        str(tmp_path / "port"), extract_frames=True)
    jax_replay.ReplayRecording(ann, split_file, video_file=video).export(str(tmp_path / "jax"), extract_frames=True)
    assert len(written) == 2
    names = compare_trees(tmp_path / "port", tmp_path / "jax")
    assert sum(n.endswith(".png") for n in names) == 6
    camera0 = port_video.Video().load(os.path.join(written[0], "00000"))
    assert camera0.frames_count == 4 and camera0.get_frame(0).shape == (64, 96, 3)

    data_root = tmp_path / "dataset"
    shutil.copytree(tmp_path / "port", data_root / "train")
    assert len(MulticameraVideoDataset(str(data_root / "train"), observations_count=2)) > 0
    with open(os.path.join(REPO, "configs", "synthetic_smoke.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg["data"]["data_root"] = str(data_root)
    cfg["logging"].update(output_root=str(tmp_path / "results"), checkpoints_root=str(tmp_path / "checkpoints"))
    cfg["training"].update(max_steps=1, save_freq=1, log_interval_steps=1)
    cfg["training"]["batching"]["batch_size"] = 2
    config_path = str(tmp_path / "minecraft_smoke.yaml")
    with open(config_path, "w") as f:
        yaml.safe_dump(cfg, f)
    os.environ.setdefault("WANDB_MODE", "disabled")
    from playableenvironments_tpu_torch.cli import train

    run_cli(train, "--config", config_path, "--device", "cpu")
    assert checkpointing.latest_checkpoint(str(tmp_path / "checkpoints" / "synthetic_smoke")) is not None


def test_acquire_subcommands_through_the_port_cli(tmp_path, player_dataset):
    """minecraft (with the video), boxes from a port detector checkpoint on
    the CPU, and fragment through the port's CLI, against the JAX package's
    functions on the same inputs (its CLI's boxes restores only its own
    checkpoints; the detector is the same carried-over weights). Without a
    card, boxes raises unless --device cpu."""
    video = replay_video(tmp_path)
    ann, split_file = write_replay(str(tmp_path), frames=6, entities=2)
    written = port_acquire("minecraft", "--annotations", ann, "--splits", split_file, "--video", video,
                           "--output", tmp_path / "replay_port", "--begin_index", 3)
    jax_acquire("minecraft", "--annotations", ann, "--splits", split_file, "--video", video,
                "--output", tmp_path / "replay_jax", "--begin_index", 3)
    assert [os.path.basename(w) for w in written] == ["00003", "00004"]
    compare_trees(tmp_path / "replay_port", tmp_path / "replay_jax")

    port, _, jax_fn = detectors(threshold=0.195)
    checkpoint = checkpointing.save_checkpoint(str(tmp_path / "detector"), port)
    shutil.copytree(player_dataset, tmp_path / "boxes_port")
    shutil.copytree(player_dataset, tmp_path / "boxes_jax")
    args = ("boxes", "--root", tmp_path / "boxes_port", "--detector_checkpoint", checkpoint, "--objects_count", 2,
            "--threshold", 0.195, "--base_features", FEATURES)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            port_acquire(*args)
    assert port_acquire(*args, "--device", "cpu") == 6
    jax_boxes.annotate_dataset_boxes(str(tmp_path / "boxes_jax"), jax_fn, objects_count=2)
    compare_trees(tmp_path / "boxes_port", tmp_path / "boxes_jax", atol=BOX_ATOL)

    assert port_acquire("fragment", "--root", player_dataset, "--output", tmp_path / "fragments_port",
                        "--length", 2) == 2
    jax_acquire("fragment", "--root", player_dataset, "--output", tmp_path / "fragments_jax", "--length", 2)
    compare_trees(tmp_path / "fragments_port", tmp_path / "fragments_jax")
