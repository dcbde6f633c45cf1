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
  coarse pass, as the JAX renderer reads it).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np

from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.scene.encoding import SceneEncoding as JaxSceneEncoding
from playableenvironments_tpu_torch.compat.from_flax import load_environment_model
from playableenvironments_tpu_torch.eval.creators import FrameRenderer
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from test_torch_port_decoder import NO_OPT
from test_torch_port_options import (STRIDES, check_options_step, check_remat_step, close, initial_variables,
                                     path_scene, t, to_port)


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
