"""Minecraft's phase 2 on the decoder path (configs/minecraft.yaml's
training section: patch 48, the v9 autoencoder, the skybox and the overlap
fix in the training composer, the learned pose encoder in train mode), the
port against the JAX package on the CPU.

- One whole step of tests/test_torch_port_minecraft.py's tiny Minecraft
  scene (one animation model, which JAX builds) over a Minecraft-geometry
  batch of 4 x 2 frames at 32x48, patch 8 at strides (4, 8), the patch
  centre drawn by JAX and replayed, the players inside the background's
  slab so that the overlap fix masks background samples (counted here).
  Held as tests/test_torch_port_decoder.py holds the tennis step (its
  `check_synthesis_step`), with the gradients at 2e-1 of a tensor's
  largest (plus 2e-3 of its model's): this tiny scene is ill-conditioned
  in f32. Against the same step in float64 (the port with every dtype
  raised), the port's f32 gradients are off by up to 2.3e-2 of a tensor's
  largest (the player's NeRF, whose AdaIN statistics see few samples) and
  the JAX package's by up to 1.6e-1 (the object encoders' batch norms);
  the loss by 3e-6 and 1e-5 relative. The metrics are held at 2e-4 (the
  players' sharpness term, over few samples, is 6.7e-5 apart), the running
  statistics at 1e-4 absolute (the AdaIN means, 3e-5 apart).
- The sort-free composition of overlap-fixed samples (masked static samples
  at t = 0, alpha -10, no longer t-sorted) with the alpha noise on: the
  per-object and global integrals at 1e-5, as JAX's.
"""

import dataclasses
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.core import compositing as jcompositing
from playableenvironments_tpu.train import trainer_synthesis as jax_trainer
from playableenvironments_tpu_torch.compat.from_flax import load_environment_model
from playableenvironments_tpu_torch.core import compositing
from playableenvironments_tpu_torch.data import synthetic
from playableenvironments_tpu_torch.data.batching import Batch, collate
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.train import trainer_synthesis
import test_torch_port_decoder as decoder_tests
from test_torch_port_minecraft import FOCAL, IMAGE, MULTIPLIER, scenes
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

BS, T = 4, 2
PATCH, STRIDES = 8, (4, 8)
LEARNING_RATE = 5e-4
GRADIENT_RTOL = 2e-1
METRIC_RTOL = 2e-4
STATS_ATOL = 1e-4


def training_config(module):
    return module.SynthesisTrainingConfig(
        learning_rate=LEARNING_RATE, samples_per_image=0, patch_size=PATCH, patch_strides=STRIDES,
        perturb=False, shuffle_style=False, max_steps=300000, decode_patches=True,
        autoencoder_learning_rate=1e-4, frozen_autoencoder_steps=0,
        loss_weights=module.LossWeights(reconstruction=1.0, perceptual=0.1),
    )


@functools.lru_cache(maxsize=None)
def batch_arrays():
    import tempfile

    root = synthetic.make_two_player_dataset(
        tempfile.mkdtemp(prefix="minecraft_train"), videos=2, frames=6, height=IMAGE[0], width=IMAGE[1],
        focal=FOCAL, seed=5, splits=("test",), **synthetic.MINECRAFT_GEOMETRY,
    )
    dataset = MulticameraVideoDataset(str(pathlib.Path(root) / "test"), observations_count=T)
    batch = collate([dataset[i] for i in range(BS)])
    return {k: None if v is None else v.numpy() for k, v in vars(batch).items()}


@functools.lru_cache(maxsize=None)
def jax_run():
    jscene, _ = scenes(animation_models=1)
    return decoder_tests.jax_synthesis_steps(jscene, training_config(jax_trainer), batch_arrays(),
                                             [jax.random.PRNGKey(12)], seed=2, multiplier=MULTIPLIER)


def port_model(tree):
    _, pscene = scenes(animation_models=1)
    model = EnvironmentModel(pscene, MULTIPLIER, device="cpu")
    assert load_environment_model(model, tree) == []
    return model


@pytest.fixture(scope="module")
def port_run():
    initial, steps = jax_run()
    model = port_model(initial)
    trainer = trainer_synthesis.SynthesisTrainer(model, training_config(trainer_synthesis))
    batch = Batch(**{k: None if v is None else torch.from_numpy(v) for k, v in batch_arrays().items()})
    masked = []
    apply_overlap_fix = compositing.apply_overlap_fix

    def counting(*args):
        masked.append(int(args[-1].sum()))
        return apply_overlap_fix(*args)

    compositing.apply_overlap_fix = counting
    try:
        out = decoder_tests.port_synthesis_steps(model, trainer, batch, [steps[0][-1]])
    finally:
        compositing.apply_overlap_fix = apply_overlap_fix
    return out, masked


def test_minecraft_decoder_step_matches_jax(port_run):
    initial, steps = jax_run()
    (got,), masked = port_run
    assert [name for name, _ in steps[0][-1]] == ["uniform"]  # the patch centre
    assert len(masked) == 2 and masked[0] > 0  # the background's samples inside the players' intervals (then the skybox's)
    start, _ = decoder_tests.check_synthesis_step(port_model, got, steps[0], initial, LEARNING_RATE,
                                                  gradient_rtol=GRADIENT_RTOL, metric_rtol=METRIC_RTOL,
                                                  stats_atol=STATS_ATOL)
    loss, metrics, grads, state = got
    assert torch.isfinite(loss) and set(metrics) >= {"coarse_reconstruction_loss", "loss"}
    for prefix in ("composer.object_model_1.nerf.", "parameters_encoder_2.", "autoencoder.decoder."):
        names = [n for n in grads if n.startswith(prefix)]
        assert names and any(float(grads[n].abs().max()) > 0 for n in names), prefix
        assert any(not torch.equal(state[n], start[n]) for n in names), prefix


def test_sortfree_composition_of_overlap_fixed_samples_with_noise_matches_jax():
    """A static object of 6 samples and two dynamic ones whose t intervals
    cover some of them: the fix moves those to t = 0 with alpha -10 amid
    sorted samples; the composition with the alpha noise on."""
    rng = np.random.default_rng(9)
    t_static = np.sort(rng.uniform(1, 9, (3, 5, 6)).astype(np.float32), axis=-1)
    t_dynamic = [np.sort(rng.uniform(lo, lo + 2, (3, 5, 4)).astype(np.float32), axis=-1) for lo in (2.0, 5.0)]
    alphas = [rng.normal(size=(3, 5, s)).astype(np.float32) for s in (6, 4, 4)]
    feats = [rng.random((3, 5, s, 4)).astype(np.float32) for s in (6, 4, 4)]
    disp = [rng.normal(size=(3, 5, s, 3)).astype(np.float32) * 0.1 for s in (6, 4, 4)]
    div = [rng.normal(size=(3, 5, s)).astype(np.float32) for s in (6, 4, 4)]
    origins = rng.normal(size=(3, 3)).astype(np.float32)
    directions = rng.normal(size=(3, 5, 3)).astype(np.float32)
    positions = rng.normal(size=(3, 5, 6, 3)).astype(np.float32)
    key = jax.random.PRNGKey(2)

    @jax.jit
    def reference(t_static, t_dynamic, alphas, feats, disp, div, origins, directions, positions):
        mask = jcompositing.overlap_fix_mask(t_static, t_dynamic[0]) | jcompositing.overlap_fix_mask(
            t_static, t_dynamic[1])
        fixed = jcompositing.apply_overlap_fix(alphas[0], t_static, positions, disp[0], div[0],
                                               origins[..., None, :], mask)
        ref = jcompositing.compose_integrate_sortfree(
            feats, [fixed[0]] + alphas[1:], [fixed[1]] + t_dynamic, directions, [fixed[3]] + disp[1:],
            [fixed[4]] + div[1:], True, key)
        return mask, ref, jax.random.normal(key, (3, 5, 14), dtype=jnp.float32)

    mask, ref, noise = jax.device_get(reference(t_static, t_dynamic, alphas, feats, disp, div, origins, directions,
                                                positions))

    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    got_mask = compositing.overlap_fix_mask(t(t_static), t(t_dynamic[0])) | compositing.overlap_fix_mask(
        t(t_static), t(t_dynamic[1]))
    assert 0 < int(got_mask.sum()) < got_mask.numel()
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(mask))
    pfixed = compositing.apply_overlap_fix(t(alphas[0]), t(t_static), t(positions), t(disp[0]), t(div[0]),
                                           t(origins)[..., None, :], got_mask)
    got = compositing.compose_integrate_sortfree(
        [t(f) for f in feats], [pfixed[0]] + [t(a) for a in alphas[1:]], [pfixed[1]] + [t(v) for v in t_dynamic],
        t(directions), [pfixed[3]] + [t(v) for v in disp[1:]], [pfixed[4]] + [t(v) for v in div[1:]], t(noise))
    assert set(got) == set(ref)
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(ref[name]), rtol=1e-5, atol=1e-5, err_msg=name)
