"""Phase 2 with the reference's options on the published decoder path, the
port against the JAX package on the CPU (tests/test_torch_port_options.py
holds the pieces and the direct-ray step; its docstring states the bounds
both files use):

- one decoder-path step with every option on (shared fine fields, both
  passes decoded, divergence 0.1, camera offsets at their own rate,
  perturbation and the style shuffle), the port's draws replayed into JAX;
- the same step with `remat` in the port, against the port's step without;
- the composer-based frame path of a `use_fine` decoder scene:
  `render_frame_from_scene_encoding` in tiles of `ray_tile` rays and
  `decode_rendered_grids` for both passes at 1e-5, and
  `FrameRenderer(use_fast=False)` against the JAX renderer's frames (the
  coarse pass, as the JAX renderer reads it);
- `decode_mixed_grids` (encoder features mixed with rendered samples) in
  eval and train mode, and `insert_samples_into_features` exactly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.render.sampling import insert_samples_into_features as insert_samples_into_features_jax
from playableenvironments_tpu.scene.encoding import SceneEncoding as JaxSceneEncoding
from playableenvironments_tpu_torch.compat.from_flax import load_environment_model
from playableenvironments_tpu_torch.eval.creators import FrameRenderer
from playableenvironments_tpu_torch.models.autoencoder import features_count_by_layer
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.render.sampling import insert_samples_into_features, sample_all_rays_strided_grid
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from test_torch_port_decoder import NO_OPT
from test_torch_port_options import (STRIDES, check_options_step, check_remat_step, close, initial_variables,
                                     path_scene, t, to_port)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)


def test_decoder_options_step_matches_jax():
    check_options_step("decoder", remat=False)


def test_decoder_remat_step_matches_the_plain_step():
    check_remat_step("decoder")


# ---- the composer-based frame path ---------------------------------------------------


def frame_encoding(scene, rng):
    b, tt, c = 1, 2, 1
    objects = len(scene.object_models)
    return dict(
        camera_rotations=np.tile(np.asarray([-0.6, 0.0, 0.0], np.float32), (b, tt, c, 1)),
        camera_translations=np.tile(np.asarray([0.0, 8.0, 10.0], np.float32), (b, tt, c, 1)),
        focals=np.full((b, tt, c), 80.0, np.float32),
        object_rotations=np.zeros((b, tt, objects, 3), np.float32),
        object_translations=rng.uniform(-0.5, 0.5, (b, tt, objects, 3)).astype(np.float32) * [1, 1, 0],
        object_style=rng.normal(size=(b, tt, objects, 8)).astype(np.float32),
        object_deformation=rng.normal(size=(b, tt, objects, 4)).astype(np.float32),
        object_in_scene=np.ones((b, tt, objects), bool),
    )


def test_frame_path_matches_jax():
    """A use_fine decoder scene's 48x64 frame on its strided grids in tiles
    of 100 rays (3 tiles, the last ragged), decoded for both passes, and
    the creator's renderer on the same encoding."""
    scene = path_scene("decoder")
    variables = initial_variables("decoder")
    variables["params"].pop("camera_offsets")
    encoding = frame_encoding(scene, np.random.default_rng(16))
    model = JaxEnvironmentModel(scene)
    jencoding = JaxSceneEncoding(**{k: jnp.asarray(v) for k, v in encoding.items()})

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def render(variables):
        out, _ = model.apply(variables, jencoding, (48, 64), list(STRIDES), 100, False,
                             method=JaxEnvironmentModel.render_frame_from_scene_encoding, mutable=["batch_stats"])
        out, _ = model.apply(variables, out, (48, 64), False, method=JaxEnvironmentModel.decode_rendered_grids,
                             mutable=["batch_stats"])
        return out

    ref = jax.device_get(render(variables))
    port = EnvironmentModel(to_port(scene), device="cpu")
    assert load_environment_model(port, variables) == []
    port.eval()
    pencoding = SceneEncoding(**{k: t(v) for k, v in encoding.items()})
    got = port.render_frame_from_scene_encoding(pencoding, (48, 64), STRIDES, ray_tile=100)
    got = port.decode_rendered_grids(got, (48, 64))
    assert got["coarse"]["global"]["integrated_features"].shape[-2] == 12 * 16 + 6 * 8
    close(got["positions"], ref["positions"])
    for pass_name in ("coarse", "fine"):
        for entry in ("object_0", "object_1", "global"):
            for name in ("integrated_features", "opacity", "depth"):
                close(got[pass_name][entry][name], ref[pass_name][entry][name], dict(rtol=1e-4, atol=1e-5),
                      err_msg=f"{pass_name} {entry} {name}")
        frames = got[pass_name]["global"]["reconstructed_observations"]
        assert frames.shape == (1, 2, 1, 48, 64, 3)
        close(frames, ref[pass_name]["global"]["reconstructed_observations"], err_msg=pass_name)
    renderer = FrameRenderer(port, port.autoencoder, (48, 64), STRIDES, ray_tile=100, use_fast=False)
    close(renderer.render(pencoding), np.clip(ref["coarse"]["global"]["reconstructed_observations"], 0.0, 1.0))


def test_decode_mixed_grids_matches_jax():
    """decode_mixed_grids (the encoder's level means with each pass's
    rendered strided-grid samples written in at their cells) on the
    decoder scene's 48x64 frames, both passes, in eval and train mode
    (the batch statistics the train-mode encoder and decoder leave
    included), at the bounds of test_frame_path_matches_jax."""
    scene = path_scene("decoder")
    variables = initial_variables("decoder")
    variables["params"].pop("camera_offsets")
    rng = np.random.default_rng(18)
    observations = rng.random((1, 2, 1, 48, 64, 3)).astype(np.float32)
    _, _, positions = sample_all_rays_strided_grid(torch.zeros(1, 2, 1, 48, 64, 3), t(observations), STRIDES)
    width = sum(features_count_by_layer(to_port(scene).autoencoder))
    features = {p: rng.normal(size=positions.shape[:-1] + (width,)).astype(np.float32) for p in ("coarse", "fine")}
    model = JaxEnvironmentModel(scene)

    for train in (False, True):
        results = {p: {"global": {"integrated_features": jnp.asarray(f)}} for p, f in features.items()}
        results["positions"] = jnp.asarray(positions.numpy())
        decode = jax.jit(functools.partial(model.apply, image_size=(48, 64), train=train,
                                           method=JaxEnvironmentModel.decode_mixed_grids, mutable=["batch_stats"]),
                         compiler_options=NO_OPT)
        ref, mutated = decode(variables, jnp.asarray(observations), results)
        port = EnvironmentModel(to_port(scene), device="cpu")
        assert load_environment_model(port, variables) == []
        got = port.decode_mixed_grids(t(observations), {**{p: {"global": {"integrated_features": t(f)}}
                                                           for p, f in features.items()}, "positions": positions},
                                      (48, 64), train=train)
        for pass_name in ("coarse", "fine"):
            frames = got[pass_name]["global"]["reconstructed_observations"]
            assert frames.shape == (1, 2, 1, 48, 64, 3)
            close(frames, ref[pass_name]["global"]["reconstructed_observations"], err_msg=f"{pass_name} {train}")
        if train:
            carried = EnvironmentModel(to_port(scene), device="cpu")
            load_environment_model(carried, {"params": variables["params"], "batch_stats": jax.device_get(mutated)[
                "batch_stats"]})
            for name, value in carried.autoencoder.state_dict().items():
                close(port.autoencoder.state_dict()[name], value.numpy(), err_msg=name)


def test_insert_samples_into_features_matches_jax():
    """Samples written at their cells of a 2x coarser grid, rounding at the
    cells' edges included, equal to JAX's, and gradients reaching both the
    grid (zero at the written cells) and the samples."""
    rng = np.random.default_rng(19)
    features = rng.normal(size=(2, 3, 6, 8, 5)).astype(np.float32)
    samples = rng.normal(size=(2, 3, 7, 5)).astype(np.float32)
    # Distinct cells per image, one position on a cell's edge.
    cells = np.stack([rng.permutation(48)[:7] for _ in range(6)]).reshape(2, 3, 7)
    positions = np.stack([(cells // 8 * 2 + rng.random(cells.shape)) / 12, (cells % 8 * 2 + 1.5) / 16], -1)
    positions[0, 0, 0, 1] = 2.5 / 16
    positions = positions.astype(np.float32)
    ref = insert_samples_into_features_jax(jnp.asarray(features), jnp.asarray(samples), jnp.asarray(positions),
                                           (12, 16))
    grid, values = t(features).requires_grad_(), t(samples).requires_grad_()
    got = insert_samples_into_features(grid, values, t(positions), (12, 16))
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(ref))
    got.sum().backward()
    assert (values.grad == 1).all() and int((grid.grad == 0).sum()) == 2 * 3 * 7 * 5
