"""The port's data path against the JAX package's on the CPU: the synthetic
dataset writer, the on-disk format both ways (also in a process that
imports only the port), the windowed dataset sample by sample on the
native decode and on the Pillow fallback, the batch order of
`iterate_batches` (seeded shuffle, process sharding, drop_last off), the
prefetch thread of an abandoned iterator, `collate`'s dtypes and the
native codec's bytes. Everything is compared exactly: the two packages run
the same numpy code and the same native library."""

import inspect
import os
import pathlib
import subprocess
import sys
import textwrap
import threading
import time

import numpy as np
import pytest

from playableenvironments_tpu.data import batching as jbatching
from playableenvironments_tpu.data import native_loader as jnative
from playableenvironments_tpu.data import synthetic as jsynthetic
from playableenvironments_tpu.data import video as jvideo
from playableenvironments_tpu.data.dataset import MulticameraVideoDataset as JaxDataset
from playableenvironments_tpu_torch.data import batching, native_loader, synthetic, video
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent


def tree_files(root):
    return sorted(str(p.relative_to(root)) for p in pathlib.Path(root).rglob("*") if p.is_file())


@pytest.fixture(scope="module")
def datasets(tmp_path_factory):
    """The same seeded dataset (2 cameras, 2 videos of 8 frames, 16x24)
    written by each package."""
    roots = {}
    for name, module in (("jax", jsynthetic), ("port", synthetic)):
        root = str(tmp_path_factory.mktemp(name))
        module.make_synthetic_dataset(root, videos=2, frames=8, height=16, width=24, cameras=2, seed=3,
                                      splits=("train", "test"))
        roots[name] = root
    return roots


def unpickled(value):
    """A loaded annotation with the poses as (rotation, translation) lists."""
    if isinstance(value, list):
        return [unpickled(v) for v in value]
    if hasattr(value, "rotation"):
        return ("pose", value.rotation.tolist(), value.translation.tolist())
    if isinstance(value, np.ndarray):
        return (value.dtype.name, value.tolist())
    return value


def test_synthetic_datasets_are_the_same_files(datasets):
    """The same file names, frames byte for byte, the same annotations (the
    pickles' bytes differ: the second package to pickle a pose writes it
    through the first one's class at the shared path), decoded frames and
    poses."""
    files = tree_files(datasets["jax"])
    assert files == tree_files(datasets["port"]) and len(files) == 2 * 2 * 2 * (8 + 8)
    for name in files:
        a, b = pathlib.Path(datasets["jax"], name), pathlib.Path(datasets["port"], name)
        if name.endswith(".png"):
            assert a.read_bytes() == b.read_bytes(), name
        else:
            assert unpickled(video._load_pickle(str(b))) == unpickled(jvideo._load_pickle(str(a))), name
    jv = jvideo.Video().load(os.path.join(datasets["jax"], "train", "00001", "00001"))
    pv = video.Video().load(os.path.join(datasets["port"], "train", "00001", "00001"))
    for i in range(jv.frames_count):
        np.testing.assert_array_equal(pv.get_frame(i), jv.get_frame(i))
        np.testing.assert_array_equal(pv.bounding_boxes[i], jv.bounding_boxes[i])
        np.testing.assert_array_equal(pv.cameras[i].rotation, jv.cameras[i].rotation)
    assert pv.actions == jv.actions and pv.focals == jv.focals and pv.dones == jv.dones


def annotated_video(module, seed):
    rng = np.random.default_rng(seed)
    n = 3
    return module.Video().add_content(
        frames=[rng.random((6, 8, 3)).astype(np.float32) for _ in range(n)],
        actions=[1, 2, 0], rewards=[0.0, 0.5, 1.0], metadata=[{"k": i} for i in range(n)],
        dones=[False, False, True],
        cameras=[module.PoseParametersNumpy(rng.normal(size=3), rng.normal(size=3)) for _ in range(n)],
        focals=[300.0] * n, bounding_boxes=[rng.random((4, 2)).astype(np.float32) for _ in range(n)],
        bounding_boxes_validity=[np.asarray([True, i != 1]) for i in range(n)],
        object_poses=[{"pose": module.PoseParametersNumpy([0.1, 0.2, 0.3], [1.0, 2.0, 3.0])}] * n,
    )


def assert_same_video(a, b):
    assert a.frames_count == b.frames_count
    for i in range(a.frames_count):
        np.testing.assert_array_equal(a.get_frame(i), b.get_frame(i))
        np.testing.assert_array_equal(a.cameras[i].rotation, b.cameras[i].rotation)
        np.testing.assert_array_equal(a.cameras[i].translation, b.cameras[i].translation)
        np.testing.assert_array_equal(a.bounding_boxes_validity[i], b.bounding_boxes_validity[i])
        np.testing.assert_array_equal(a.object_poses[i]["pose"].translation, b.object_poses[i]["pose"].translation)
    assert a.metadata == b.metadata and a.rewards == b.rewards


def test_files_written_by_either_package_load_in_the_other(tmp_path):
    """Poses unpickle as the loading package's own class, whichever package
    registered the shared pickle path first."""
    for writer, reader, name in ((jvideo, video, "jax"), (video, jvideo, "port")):
        path = str(tmp_path / name)
        annotated_video(writer, 0).save(path)
        loaded = reader.Video().load(path)
        assert type(loaded.cameras[0]) is reader.PoseParametersNumpy
        assert type(loaded.object_poses[0]["pose"]) is reader.PoseParametersNumpy
        assert_same_video(loaded, writer.Video().load(path))
        assert b"utils.lib_3d.pose_parameters" in (pathlib.Path(path) / "cameras.pkl").read_bytes()


def test_files_load_in_a_process_that_imports_only_the_port(tmp_path):
    """A port-only process reads what JAX wrote and writes what JAX reads,
    and imports no JAX."""
    jax_dir, port_dir = str(tmp_path / "jax"), str(tmp_path / "port")
    annotated_video(jvideo, 1).save(jax_dir)
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        from playableenvironments_tpu_torch.data import video
        v = video.Video().load({jax_dir!r})
        assert type(v.cameras[0]) is video.PoseParametersNumpy
        v.save({port_dir!r})
        np.save({str(tmp_path / "rot.npy")!r}, np.stack([c.rotation for c in v.cameras]))
        bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "playableenvironments_tpu")]
        assert not bad, bad
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO)}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, cwd=str(tmp_path),
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    ref = jvideo.Video().load(jax_dir)
    np.testing.assert_array_equal(np.load(tmp_path / "rot.npy"), np.stack([c.rotation for c in ref.cameras]))
    assert_same_video(jvideo.Video().load(port_dir), ref)


def test_the_port_may_register_the_pickle_path_first(tmp_path):
    """In a process where the port pickles a pose before the JAX package
    does, the JAX package writes through the port's class, and both files
    load in both packages."""
    # The process imports the two video modules and this file's
    # annotated_video (its source, not this module and its imports).
    script = textwrap.dedent(f"""
        import sys
        import numpy as np
        from playableenvironments_tpu_torch.data import video
    """) + inspect.getsource(annotated_video) + textwrap.dedent(f"""
        annotated_video(video, 2).save({str(tmp_path / "port")!r})
        from playableenvironments_tpu.data import video as jvideo
        assert sys.modules["utils.lib_3d.pose_parameters"].PoseParametersNumpy is video.PoseParametersNumpy
        annotated_video(jvideo, 2).save({str(tmp_path / "jax")!r})
        print("ok")
    """)
    env = {**os.environ, "PYTHONPATH": str(REPO), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True, env=env, cwd=str(tmp_path),
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
    for reader in (video, jvideo):
        assert_same_video(reader.Video().load(str(tmp_path / "port")), reader.Video().load(str(tmp_path / "jax")))


def dataset_pair(root, **kwargs):
    path = os.path.join(root, "train")
    return JaxDataset(path, **kwargs), MulticameraVideoDataset(path, **kwargs)


WINDOWED = dict(observations_count=3, skip_frames=1, observation_stacking=2, allowed_cameras=[1], target_size=(12, 20))


@pytest.mark.parametrize("native", [True, False])
def test_every_sample_matches_jax(datasets, native, monkeypatch):
    """skip_frames 1, observation_stacking 2 (the max(frame - s, 0) clamp
    at each video's start), the second camera only and a resize, on the
    native batch decode and on the Pillow fallback."""
    if native:
        assert native_loader.available() and jnative.available()
    else:
        monkeypatch.setattr(native_loader, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    jds, pds = dataset_pair(datasets["jax"], **WINDOWED)
    assert len(pds) == len(jds) == 2 * (8 - 5 + 1)
    for i in range(len(pds)):
        ref, got = jds[i], pds[i]
        assert set(got) == set(ref)
        for key in ref:
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(ref[key]), err_msg=f"{i} {key}")
            assert np.asarray(got[key]).dtype == np.asarray(ref[key]).dtype, key
        assert got["observations"].shape == (3, 1, 12, 20, 6)
    pds.set_observations_count(2, window_stride=2)
    jds.set_observations_count(2, window_stride=2)
    assert pds._index == jds._index and pds.total_frames == jds.total_frames


def test_native_and_fallback_agree_at_the_frame_size(datasets, monkeypatch):
    _, pds = dataset_pair(datasets["port"], observations_count=2, observation_stacking=2)
    native = pds[3]["observations"]
    monkeypatch.setattr(native_loader, "available", lambda: False)
    np.testing.assert_allclose(pds[3]["observations"], native, atol=1e-6)
    assert video.png_codec().startswith("Pillow")


def test_collate_gives_the_jax_dtypes(datasets):
    jds, pds = dataset_pair(datasets["jax"], observations_count=2)
    samples = [pds[i] for i in (0, 5, 9)]
    got = batching.collate(samples)
    ref = jbatching.collate([jds[i] for i in (0, 5, 9)])
    for name in ("observations", "camera_rotations", "camera_translations", "focals", "bounding_boxes",
                 "bounding_boxes_validity", "global_frame_indexes", "video_frame_indexes", "video_indexes",
                 "actions"):
        value, expected = getattr(got, name), np.asarray(getattr(ref, name))
        assert value.device.type == "cpu"
        assert str(value.dtype).split(".")[-1] == {"bool": "bool"}.get(expected.dtype.name, expected.dtype.name), name
        np.testing.assert_array_equal(value.numpy(), expected, err_msg=name)
    assert got.keypoints is None and got.optical_flow is None
    moved = got.to("cpu")
    assert moved.observations.shape == (3, 2, 2, 16, 24, 3)


@pytest.mark.parametrize("process_index", [0, 1])
def test_iterate_batches_order_matches_jax(datasets, process_index):
    """The seeded shuffle, process sharding over 2 and drop_last off (a
    short last batch)."""
    jds, pds = dataset_pair(datasets["jax"], observations_count=2)
    kwargs = dict(shuffle=True, seed=5, drop_last=False, process_index=process_index, process_count=2)
    ref = list(jds.iterate_batches(3, **kwargs))
    got = list(pds.iterate_batches(3, **kwargs))
    assert len(got) == len(ref) == 3 and got[-1].batch_size == 1  # 14 windows, 7 a process
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.video_indexes.numpy(), r.video_indexes)
        np.testing.assert_array_equal(g.video_frame_indexes.numpy(), r.video_frame_indexes)
        np.testing.assert_array_equal(g.observations.numpy(), r.observations)


def test_an_abandoned_iterator_leaves_no_thread(datasets):
    _, pds = dataset_pair(datasets["port"], observations_count=1)
    before = threading.active_count()
    batches = pds.iterate_batches(1, prefetch=1)
    next(batches)
    assert threading.active_count() == before + 1
    batches.close()
    deadline = time.time() + 10
    while threading.active_count() > before and time.time() < deadline:
        time.sleep(0.05)
    assert threading.active_count() == before


@pytest.mark.parametrize("wait_s", [0.0, 0.2])
def test_a_closed_iterator_has_joined_its_producer(datasets, wait_s):
    """Closing the generator (a loop's `break`, `next` on a temporary)
    joins the prefetching thread before it returns, whether the thread is
    still collating (closed at once) or blocked on its full queue (closed
    after `wait_s`): none is left for the interpreter's exit to stop."""
    _, pds = dataset_pair(datasets["port"], observations_count=1)
    before = threading.active_count()
    batches = pds.iterate_batches(1, prefetch=1)
    next(batches)
    time.sleep(wait_s)
    assert threading.active_count() == before + 1
    batches.close()
    assert threading.active_count() == before


def test_native_codec_matches_jax_bit_for_bit(datasets, tmp_path):
    """The port's binding and the JAX package's over the same library:
    batch decode with and without a resize, and encode, byte for byte."""
    assert native_loader.available()
    frames_dir = os.path.join(datasets["port"], "test", "00000", "00000")
    paths = sorted(os.path.join(frames_dir, f) for f in os.listdir(frames_dir) if f.endswith(".png"))
    for size in ((16, 24), (10, 14)):
        np.testing.assert_array_equal(native_loader.decode_batch(paths, size), jnative.decode_batch(paths, size))
    assert native_loader.png_size(paths[0]) == jnative.png_size(paths[0]) == (16, 24)
    frames = np.random.default_rng(0).random((2, 9, 13, 3)).astype(np.float32)
    names = {}
    for name, module in (("jax", jnative), ("port", native_loader)):
        names[name] = [str(tmp_path / f"{name}_{i}.png") for i in range(2)]
        module.encode_batch(names[name], frames)
    native_loader.encode(str(tmp_path / "one.png"), frames[0])
    for a, b in zip(names["jax"], names["port"]):
        assert pathlib.Path(a).read_bytes() == pathlib.Path(b).read_bytes()
    assert pathlib.Path(tmp_path / "one.png").read_bytes() == pathlib.Path(names["jax"][0]).read_bytes()
    assert video.png_codec() == "native libpe_dataloader (libpng)"
