"""Shared scenes of the port's eval-mode tests on the CPU: the 2-player
tennis dataset (`write_two_player_dataset`), the tiny tennis scene with its
JAX variables carried into the port (`tennis_dict`, `tennis_setup`), the
configs/synthetic_smoke.yaml scene over data.synthetic's dataset
(`smoke_setup`), the module-scoped `roots` and `sessions` fixtures (both
datasets; the JAX and port play sessions on the tennis scene) and
`recorded` (a renderer whose frames are kept by (video, frame)). The
weights are made by the JAX package (jitted init), perturbed with seeded
numpy and carried over by compat/from_flax.py."""

import copy
import functools
import os
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.cli.play import InteractiveSession as JaxSession
from playableenvironments_tpu.data.batching import Batch as JaxBatch
from playableenvironments_tpu.models.autoencoder import MultiresAutoencoder as JaxAutoencoder
from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.render.playable_model import PlayableEnvironmentModel as JaxPlayable
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.cli import common
from playableenvironments_tpu_torch.cli.play import InteractiveSession
from playableenvironments_tpu_torch.compat.from_flax import load_environment_model
from playableenvironments_tpu_torch.data import synthetic
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.data.video import MulticameraVideo, PoseParametersNumpy, Video
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from test_torch_port_play import FOCAL_MULTIPLIER, IMAGE, STRIDES, _perturbed, jax_variables
from test_torch_port_play import port_modules as play_modules
from test_torch_port_play import tiny_tennis_dict

REPO = pathlib.Path(__file__).resolve().parent.parent
F32 = dict(rtol=1e-5, atol=1e-5)
TENNIS_CAMERA = ([1.35, 0.0, 0.0], [0.0, -26.0, 1.6])


class NoDraws:
    """A random-stream object that fails on any draw."""

    def __getattr__(self, name):
        raise AssertionError(f"the eval-mode encoding drew from the random streams ({name})")


def write_two_player_dataset(root, videos=2, frames=3, height=IMAGE[0], width=IMAGE[1], seed=0):
    """A test split of 1-camera videos at the tiny tennis camera (focal 300)
    with 2 players' boxes a frame (player 2 leaves one frame), smooth random
    frames and actions, written with Video.add_content."""
    rng = np.random.default_rng(seed)
    rows, cols = np.mgrid[0:height, 0:width] / max(height, width)
    for video_idx in range(videos):
        images, boxes, validity = [], [], []
        for frame_idx in range(frames):
            phase = rng.uniform(0, 2 * np.pi, 3)
            images.append(np.stack([0.5 + 0.4 * np.sin(7 * rows + 5 * cols + p) for p in phase], -1))
            # Box bottoms on the ground 16-19 m (player 1) and 0-20 m
            # (player 2, near the horizon) in front of the camera.
            left = rng.uniform([0.3, 0.5], [0.45, 0.7])
            bottom = rng.uniform([0.33, 0.1], [0.4, 0.13])
            boxes.append(np.stack([left, np.zeros(2), left + 0.1, bottom]).astype(np.float32))
            validity.append(np.asarray([True, not (video_idx == 1 and frame_idx == 1)]))
        camera = PoseParametersNumpy(*TENNIS_CAMERA)
        clip = Video().add_content(
            frames=images, actions=list(rng.integers(0, 3, frames)), rewards=[0.0] * frames,
            metadata=[{} for _ in range(frames)], dones=[False] * (frames - 1) + [True],
            cameras=[camera] * frames, focals=[300.0] * frames, bounding_boxes=boxes,
            bounding_boxes_validity=validity,
        )
        MulticameraVideo([clip]).save(os.path.join(root, "test", f"{video_idx:05}"))
    return root


ZEROED = "model.nerf_models.zeroed_ray_bender_model"


def tennis_dict():
    """test_torch_port_play.py's tiny tennis scene with its object encoders
    cut to its style/deformation widths and to small crops, and the players'
    ray benders zeroed.

    Why zeroed: the positional bender clamps each displacement into the box
    (p + clip(d, lo - p, hi - p)), and the fast path then masks on the bent
    position. A clamped sample lands on the face or one ulp outside it,
    depending on the last bit of p = o + t d, which XLA computes fused under
    jit and PyTorch does not; a ray's last sample is rendered with the 1e10
    distance, so that one ulp moves the ray's opacity between ~0.1 and 1.
    With data-derived poses (classic strategy, z = 0.01) 5 of the 6 frames
    of this dataset differed by up to 0.96 between the JAX package and the
    port for that reason alone (ROADMAP.md §C); the positional bender stays
    held by test_torch_port_render.py and test_torch_port_play.py."""
    d = tiny_tennis_dict()
    for block in d["model"]["object_encoders"]:
        v5 = block["architecture"].endswith("v5")
        block.update(style_features=8, deformation_features=4, input_size=[16, 32] if v5 else [16, 16])
    for block in d["model"]["object_models"]:
        block["ray_bender_model"] = {"architecture": ZEROED}
    return d


def without_benders(tree):
    """test_torch_port_play.jax_variables()'s environment with the players'
    ray-bender subtrees dropped (tennis_dict zeroes those benders)."""
    out = copy.deepcopy(tree)
    for kind in ("params", "batch_stats"):
        for name, model in out[kind].get("composer", {}).items():
            model.pop("ray_bender", None)
    return out


def jax_batch(batch):
    return JaxBatch(**{k: None if v is None else jnp.asarray(v.numpy()) for k, v in vars(batch).items()})


def encoder_variables(jmodel, batch, seed):
    """The object encoders' variables (params and batch_stats) from a jitted
    init, perturbed."""
    init = jax.jit(lambda key, *a: jmodel.init(key, *a, train=False, method=JaxEnvironmentModel.compute_scene_encoding))
    tree = jax.device_get(init(jax.random.PRNGKey(seed), *jax_batch(batch).environment_model_args()))
    rng = np.random.default_rng(seed + 10)
    return {name: _perturbed(value, rng) for name, value in tree.items()}


def init_with_composer(module, *args):
    encoding, _ = module.compute_scene_encoding(*args, train=False)
    directions = jnp.zeros(encoding.camera_rotations.shape[:3] + (4, 3)).at[..., 2].set(-1.0)
    return module.render_sampled_rays(encoding, directions, train=False)


@functools.lru_cache(maxsize=None)
def smoke_setup(root):
    """(JAX model, port model, variables, port dataset) of
    configs/synthetic_smoke.yaml over data.synthetic's dataset at `root`."""
    cfg = common.load_yaml(str(REPO / "configs" / "synthetic_smoke.yaml"))
    cfg["data"]["data_root"] = root
    dataset = common.build_dataset(cfg, "test")
    jmodel = JaxEnvironmentModel(jax_config.scene_from_dict(cfg["model"], cfg.get("playable_model")))
    batch = dataset_batch(dataset, 3)
    init = jax.jit(lambda key, *a: jmodel.init(key, *a, method=init_with_composer))
    tree = jax.device_get(init(jax.random.PRNGKey(0), *jax_batch(batch).environment_model_args()))
    rng = np.random.default_rng(7)
    variables = {name: _perturbed(value, rng) for name, value in tree.items()}
    model = common.build_environment_model(cfg, device="cpu")
    assert load_environment_model(model, variables) == []
    return jmodel, model, variables, dataset


@functools.lru_cache(maxsize=None)
def tennis_setup(root):
    """(JAX model, port model, port autoencoder, variables, port dataset) of
    the tiny tennis scene over the 2-player dataset at `root`."""
    d = tennis_dict()
    jscene = jax_config.scene_from_dict(d["model"], d["playable_model"])
    pscene = port_config.scene_from_dict(d["model"], d["playable_model"])
    dataset = MulticameraVideoDataset(os.path.join(root, "test"), observations_count=1)
    jmodel = JaxEnvironmentModel(jscene, focal_length_multiplier=FOCAL_MULTIPLIER)
    encoders = encoder_variables(jmodel, dataset_batch(dataset, 2), seed=1)
    env = without_benders(jax_variables()[0])
    variables = with_autoencoder_encoder(
        {kind: {**env[kind], **encoders[kind]} for kind in ("params", "batch_stats")}, jscene)
    model = EnvironmentModel(pscene, FOCAL_MULTIPLIER, device="cpu")
    assert load_environment_model(model, variables) == []
    return jmodel, model, model.autoencoder, variables, dataset


def with_autoencoder_encoder(tree, jscene):
    """`tree`, whose autoencoder holds a decoder only, with an encoder beside
    it (a jitted init of the whole autoencoder, perturbed): the port's
    model owns the full autoencoder and loads both halves."""
    ae = JaxAutoencoder(jscene.autoencoder)
    init = jax.jit(lambda k: ae.init(k, jnp.zeros((1, 16, 32, 3)), train=False))
    full = jax.device_get(init(jax.random.PRNGKey(5)))
    encoder = _perturbed({kind: full[kind]["encoder"] for kind in ("params", "batch_stats")}, np.random.default_rng(6))
    return {kind: {**tree[kind], "autoencoder": {**tree[kind]["autoencoder"], "encoder": encoder[kind]}}
            for kind in ("params", "batch_stats")}


def dataset_batch(dataset, size):
    return next(dataset.iterate_batches(size, shuffle=False))


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    smoke = str(tmp_path_factory.mktemp("smoke"))
    synthetic.make_synthetic_dataset(smoke, videos=2, frames=4, seed=2, splits=("test",))
    return {"smoke": smoke, "tennis": write_two_player_dataset(str(tmp_path_factory.mktemp("tennis")))}


@pytest.fixture(scope="module")
def sessions(roots):
    jmodel, model, autoencoder, variables, dataset = tennis_setup(roots["tennis"])
    _, play = jax_variables()
    _, _, playable = play_modules()  # the playable model only: its scene's benders do not reach it
    d = tennis_dict()
    jplayable = JaxPlayable(jax_config.scene_from_dict(d["model"], d["playable_model"]))
    jsession = JaxSession(jmodel, variables, jplayable, play, [], IMAGE, STRIDES)
    session = InteractiveSession(model.scene, model.composer, autoencoder, playable, IMAGE, STRIDES,
                                 FOCAL_MULTIPLIER, environment_model=model)
    return jsession, session, dataset


def recorded(renderer, store):
    """Wrap a renderer's encode/render so that each rendered frame is kept
    under its (video, frame) index."""
    encode, render = renderer.encode, renderer.render
    pending = []

    def encode_(batch):
        pending.append((np.asarray(batch.video_indexes), np.asarray(batch.video_frame_indexes)))
        return encode(batch)

    def render_(encoding):
        frames = render(encoding)
        videos, indexes = pending.pop(0)
        for i, frame in enumerate(np.asarray(frames.cpu() if torch.is_tensor(frames) else frames)):
            store[(int(videos[i]), int(indexes[i, 0]))] = frame[0, 0]
        return frames

    renderer.encode, renderer.render = encode_, render_
    return renderer
