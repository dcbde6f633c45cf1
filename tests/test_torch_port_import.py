"""Importing the reference's PyTorch checkpoints into the port, on the CPU:
compat/torch_import.py (a numpy copy of the JAX package's converters) and
cli/import_checkpoint.py, against the JAX package's converters and frames.

Reference-layout state dicts are made from seeded flax variable trees by
the test-side inverse of the converters (tests/torch_port_reference_layout.py,
no JAX). Three trees: the tiny tennis scene of test_torch_port_play.py (its
composer and autoencoder decoder from the JAX package's inits, perturbed;
its object encoders, the autoencoder's encoder and a camera-offset table of
3 frames from the port's seeded modules), the tiny Minecraft scene of
test_torch_port_minecraft.py (skybox NeRF, learned pose encoder; its v9
autoencoder is outside what the converters cover, as in the JAX package),
and a playable model of two animation models (one LSTM cell with both
reference biases, a masked batch norm with a running std).

Checked, bit for bit: JAX's converters take the inverse's output back to
the tree (this pins the inverse); the port's converters give JAX's trees
leaf for leaf. End to end: a reference `torch.save` checkpoint (with
DataParallel's `module.` prefixes) through the port's `import_checkpoint
--phase3 --device cpu`, then the imported environment and playable
checkpoints played by an InteractiveSession for frame 0 and one step,
within 1e-2 of JAX's render_frame_fast + interactive_step frames from the
same tree (the bound of test_torch_port_play.py's whole-slice frames).
"""

import importlib
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import torch_port_reference_layout as layout
from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.compat import torch_import as jax_import
from playableenvironments_tpu.render import fast as jax_fast
from playableenvironments_tpu.render import interactive as jax_interactive
from playableenvironments_tpu.render.playable_model import PlayableEnvironmentModel as JaxPlayable
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.cli.play import InteractiveSession
from playableenvironments_tpu_torch.compat import torch_import as port_import
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
from playableenvironments_tpu_torch.train import checkpointing
from test_torch_port_minecraft import tiny_minecraft_dict
from test_torch_port_play import (
    ACTIONS, FOCAL_MULTIPLIER, IMAGE, STRIDES, encoding_arrays, jax_encoding, jax_variables, port_encoding,
    tiny_tennis_dict,
)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

CAMERA_MEMORY = 3


def flax_tree(module, skip=()):
    """A port module's state as the flax variables it maps onto
    (layout.flax_variables), seeded values perturbed so that no norm scale
    or running statistic is a constant. Keys starting with one of `skip`
    are left out."""
    rng = np.random.default_rng(11)
    tree = layout.flax_variables(module.state_dict(), skip)

    def perturb(node, path=()):
        for name, value in node.items():
            if isinstance(value, dict):
                perturb(value, path + (name,))
            elif name == "scale":
                node[name] = rng.uniform(0.7, 1.3, value.shape).astype(np.float32)
            elif name == "mean" or (name == "bias" and path[-1].startswith(("bn", "down_bn", "up_bn", "initial_bn",
                                                                            "skip_bn"))):
                node[name] = (rng.normal(size=value.shape) * 0.2).astype(np.float32)
            elif name == "var":
                node[name] = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)

    perturb(tree)
    return tree


def tennis_dict():
    d = tiny_tennis_dict()
    d["model"].update(enable_camera_parameters_offsets=True, camera_parameters_memory_size=CAMERA_MEMORY)
    return d


def tennis_environment_tree():
    """The tiny tennis environment: composer and decoder from the JAX
    package's inits, object encoders, encoder and camera table from the
    port's seeded model."""
    d = tennis_dict()
    scene = port_config.scene_from_dict(d["model"], d["playable_model"])
    model = EnvironmentModel(scene, enable_camera_offsets=True, camera_memory_size=CAMERA_MEMORY, device="cpu", seed=4)
    tree = flax_tree(model, skip=("composer.", "autoencoder.decoder."))
    env, _ = jax_variables()
    for kind in ("params", "batch_stats"):
        tree[kind]["composer"] = env[kind]["composer"]
        tree[kind]["autoencoder"]["decoder"] = env[kind]["autoencoder"]["decoder"]
    tree["params"]["camera_offsets"]["storage"] = np.random.default_rng(5).normal(
        size=tree["params"]["camera_offsets"]["storage"].shape).astype(np.float32)
    return tree


def minecraft_environment_tree():
    d = tiny_minecraft_dict()
    scene = port_config.scene_from_dict(d["model"], d["playable_model"])
    return flax_tree(EnvironmentModel(scene, device="cpu", seed=6), skip=("autoencoder.",))


def playable_tree(d, dynamics=None):
    """Both animation models' trees (the action networks' variances made
    from a running std), their centroids; `dynamics` replaces the
    dynamics networks' subtrees."""
    scene = port_config.scene_from_dict(d["model"], d["playable_model"])
    tree = flax_tree(PlayableEnvironmentModel(scene, device="cpu", seed=8))
    rng = np.random.default_rng(9)
    for name, stats in tree["batch_stats"].items():
        for bn in stats["action_network"].values():
            bn["var"] = layout.std_variance(rng.uniform(0.3, 1.5, bn["var"].shape))
        if dynamics is not None:
            tree["params"][name]["dynamics_network"] = dynamics["params"][name]["dynamics_network"]
    for params in tree["params"].values():
        for gate in "ifgo":
            params["dynamics_network"]["lstm_0"][f"h{gate}"]["bias"] = rng.normal(size=16).astype(np.float32)
    centroids = [rng.normal(size=(3, 2)).astype(np.float32) for _ in tree["params"]]
    return tree, centroids


def assert_same_tree(got, ref, path=""):
    assert set(got) == set(ref), (path, sorted(set(got) ^ set(ref)))
    for key, value in ref.items():
        if isinstance(value, dict):
            assert_same_tree(got[key], value, f"{path}/{key}")
        else:
            assert np.asarray(got[key]).dtype == np.asarray(value).dtype, f"{path}/{key}"
            np.testing.assert_array_equal(np.asarray(got[key]), np.asarray(value), err_msg=f"{path}/{key}")


def environment_case(name):
    if name == "tennis":
        d, tree = tennis_dict(), tennis_environment_tree()
    else:
        d, tree = tiny_minecraft_dict(), minecraft_environment_tree()
    scene = jax_config.scene_from_dict(d["model"], d["playable_model"])
    return scene, tree, layout.environment_state_dict(tree, scene)


CASES = ("tennis", "minecraft", "playable")


def converted(module, case):
    """(module's conversion of the case's reference state dict, the tree
    it was made from)."""
    if case == "playable":
        d = tiny_tennis_dict()
        tree, centroids = playable_tree(d)
        state = layout.playable_state_dict(tree, centroids)
        scene = jax_config.scene_from_dict(d["model"], d["playable_model"])
        params, stats, got_centroids = module.convert_playable_model(state, scene.animation_models)
        return ({"params": params, "batch_stats": stats, "centroids": got_centroids},
                {**tree, "centroids": centroids})
    scene, tree, state = environment_case(case)
    params, stats = module.convert_environment_model(state, scene, cameras_count=1)
    return {"params": params, "batch_stats": stats}, tree


@pytest.mark.parametrize("case", CASES)
def test_jax_converters_take_the_reference_layout_back_to_the_tree(case):
    """Pins tests/torch_port_reference_layout.py: JAX's convert_* of its
    output is the tree, every leaf bit for bit (the LSTM's split biases sum
    back exactly, the running std gives back the variance exactly)."""
    got, tree = converted(jax_import, case)
    if case == "playable":
        assert_same_tree({str(i): c for i, c in enumerate(got.pop("centroids"))},
                         {str(i): c for i, c in enumerate(tree.pop("centroids"))})
    assert_same_tree(got, tree)
    if case == "tennis":
        assert "camera_offsets" in got["params"] and "encoder" in got["params"]["autoencoder"]
    if case == "minecraft":
        assert "parameters_encoder_2" in got["params"]
        assert "alpha_head" not in got["params"]["composer"]["object_model_1"]["nerf"]  # the skybox


@pytest.mark.parametrize("case", CASES)
def test_port_converters_give_jax_trees(case):
    got, _ = converted(port_import, case)
    ref, _ = converted(jax_import, case)
    if case == "playable":
        for a, b in zip(got.pop("centroids"), ref.pop("centroids")):
            np.testing.assert_array_equal(a, b)
    assert_same_tree(got, ref)


def run_cli(module, *args):
    argv = sys.argv
    sys.argv = [module] + list(args)
    try:
        return importlib.import_module(module).main()
    finally:
        sys.argv = argv


def test_import_cli_plays_jax_frames_from_the_same_tree(tmp_path):
    """The reference checkpoint of the tiny tennis scene (environment under
    `environment_model.`, DataParallel prefixes) imported with --phase3,
    both checkpoints restored into fresh port modules and played: frame 0
    and one step within 1e-2 of JAX's from the flax trees."""
    d = tennis_dict()
    config = tmp_path / "tiny_tennis.yaml"
    config.write_text(yaml.safe_dump(d))
    env_tree = tennis_environment_tree()
    _, jax_play = jax_variables()
    play_tree, centroids = playable_tree(d, dynamics=jax_play)
    jscene = jax_config.scene_from_dict(d["model"], d["playable_model"])
    state = layout.playable_state_dict(play_tree, centroids, environment=env_tree, scene=jscene)
    checkpoint = layout.torch_checkpoint(state, str(tmp_path / "reference.pth.tar"), data_parallel=True)
    run_cli("playableenvironments_tpu_torch.cli.import_checkpoint", "--config", str(config), "--torch_checkpoint",
            checkpoint, "--output", str(tmp_path / "imported"), "--phase3", "--device", "cpu")
    env_path = checkpointing.latest_checkpoint(str(tmp_path / "imported" / "environment"))
    play_path = checkpointing.latest_checkpoint(str(tmp_path / "imported" / "playable"))
    assert env_path.endswith("checkpoint_0") and play_path.endswith("checkpoint_0")
    saved = torch.load(os.path.join(play_path, checkpointing.STATE_FILE), weights_only=True)
    for got, ref in zip(saved["centroids"], centroids):
        np.testing.assert_array_equal(got.numpy(), ref)

    pscene = port_config.scene_from_dict(d["model"], d["playable_model"])
    env = checkpointing.restore_params(env_path, EnvironmentModel(
        pscene, FOCAL_MULTIPLIER, enable_camera_offsets=True, camera_memory_size=CAMERA_MEMORY, device="cpu", seed=1))
    np.testing.assert_array_equal(env.camera_offsets.storage.detach().numpy(),
                                  env_tree["params"]["camera_offsets"]["storage"])
    playable = checkpointing.restore_params(play_path, PlayableEnvironmentModel(pscene, device="cpu", seed=2))
    session = InteractiveSession(pscene, env.composer, env.autoencoder, playable.eval(), IMAGE, STRIDES,
                                 FOCAL_MULTIPLIER)
    arrays = encoding_arrays()
    render = jax.jit(lambda variables, enc: jax_fast.render_frame_fast(
        jscene, variables, enc, image_size=IMAGE, patch_strides=STRIDES, focal_length_multiplier=FOCAL_MULTIPLIER,
        interpret=True))
    jax_env = {kind: {"composer": env_tree[kind]["composer"],
                      "autoencoder": {"decoder": env_tree[kind]["autoencoder"]["decoder"]}}
               for kind in ("params", "batch_stats")}
    jplayable = JaxPlayable(jscene)
    jenc = jax_encoding(arrays)
    frames = [(session.start(port_encoding(arrays)), np.asarray(render(jax_env, jenc))[0, 0, 0])]
    one, var = jax_interactive.action_inputs(jplayable, ACTIONS[0])
    jenc, _ = jax_interactive.interactive_step(
        jplayable, {"params": {k: {"dynamics_network": v["dynamics_network"]} for k, v in play_tree["params"].items()}},
        jenc, jnp.asarray(arrays["object_style"]), [None, None], one, var)
    frames.append((session.step(ACTIONS[0]), np.asarray(render(jax_env, jenc))[0, 0, 0]))
    for port, ref in frames:
        assert port.shape == IMAGE + (3,) and np.isfinite(port).all()
        np.testing.assert_allclose(port, ref, atol=1e-2, rtol=0)
    assert np.abs(frames[1][1] - frames[0][1]).max() > 1e-3
