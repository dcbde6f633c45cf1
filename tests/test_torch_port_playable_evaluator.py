"""The phase-3 evaluator, the port against the JAX package on the CPU, on
the tiny tennis scene of test_torch_port_encode.py (its 2-player dataset,
the environment's weights of tennis_setup) with both animation models'
weights seeded on jax.eval_shape's tree of the JAX trainer's init
(test_torch_port_phase3.seeded_tree; the action networks' batch norms
included), carried over by compat/from_flax.py:

- `infer_single_actions` (eval mode, JAX's action-sampling and gumbel draws
  replayed) and `rollout_single` (the whole-trajectory rollout of one
  player, plain B4 on the CPU): every output at 1e-5;
- PlayableModelEvaluator's action videos and re-enactment:
  tests/test_torch_port_playable_evaluator_videos.py, on this file's setup;
- its validation losses: JAX's draws of each validation batch replayed
  into the port (the port's step_streams stand-in), every `val_` mean at
  1e-5 relative; the centroids, MI matrices and running statistics
  unchanged.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.data.dataset import MulticameraVideoDataset as JaxDataset
from playableenvironments_tpu.eval import playable_evaluator as jax_evaluator
from playableenvironments_tpu.render.playable_model import PlayableEnvironmentModel as JaxPlayable
from playableenvironments_tpu.scene.encoding import SceneEncoding as JaxEncoding
from playableenvironments_tpu.train import trainer_playable as jtrainer
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.compat.from_flax import load_playable
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.eval import playable_evaluator
from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch.train import trainer_playable
from test_torch_port_composer import Replay, recorded_draws
from test_torch_port_decoder import NO_OPT
from torch_port_scenes import jax_batch, roots, tennis_dict, tennis_setup  # noqa: F401  (roots: a fixture)
from test_torch_port_phase3 import seeded_tree
from test_torch_port_play import IMAGE, STRIDES
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

T = 3  # observations a validation window (the dataset's videos hold 3 frames)
FRAMES = 3  # frames an action video


def training_config(module):
    return module.PlayableTrainingConfig(ground_truth_observations_start=1, ground_truth_observations_end=1,
                                         observations_count=T, observations_count_start=T)


def encoding_arrays(seed=0, bs=2, t=4):
    rng = np.random.default_rng(seed)
    normal = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa: E731
    in_scene = np.ones((bs, t, 4), bool)
    in_scene[1, 2:, 3] = False
    return dict(camera_rotations=normal(bs, t, 1, 3) * 0.1, camera_translations=normal(bs, t, 1, 3),
                focals=np.full((bs, t, 1), 300.0, np.float32), object_rotations=normal(bs, t, 4, 3) * 0.3,
                object_translations=normal(bs, t, 4, 3), object_style=normal(bs, t, 4, 8),
                object_deformation=normal(bs, t, 4, 4), object_in_scene=in_scene)


@pytest.fixture(scope="module")
def setup(roots):
    """The JAX trainer and state-like namespace, the port trainer holding
    the same weights and centroids, both datasets (torch_port_scenes's
    2-player test split; a module that takes this fixture imports `roots`
    too)."""
    root = roots["tennis"]
    jmodel, model, _, variables, _ = tennis_setup(root)
    d = tennis_dict()
    jscene = jax_config.scene_from_dict(d["model"], d["playable_model"])
    jtrain = jtrainer.PlayableTrainer(jmodel, JaxPlayable(jscene), training_config(jtrainer))
    encoding = JaxEncoding(**{k: jnp.asarray(v) for k, v in encoding_arrays().items()})
    shapes = jax.eval_shape(lambda e: jtrain.init_state_from_encoding(jax.random.PRNGKey(0), e, {}, {}), encoding)
    rng = np.random.default_rng(2)
    play = {"params": seeded_tree(shapes.params, rng), "batch_stats": seeded_tree(shapes.batch_stats, rng)}
    centroids = [rng.normal(size=(3, 2)).astype(np.float32) for _ in range(2)]
    extra = {"environment": variables, "centroids": {str(i): c for i, c in enumerate(centroids)},
             "mi_matrices": {str(i): np.full((3, 3), 1 / 9, np.float32) for i in range(2)}}
    state = types.SimpleNamespace(params=play["params"], batch_stats=play["batch_stats"], extra=extra,
                                  step=jnp.asarray(0, jnp.int32))

    playable = PlayableEnvironmentModel(model.scene, device="cpu")
    assert load_playable(playable, play) == []
    trainer = trainer_playable.PlayableTrainer(playable, training_config(trainer_playable), environment_model=model)
    trainer.centroids = [torch.from_numpy(c) for c in centroids]
    trainer.mi_matrices = [torch.full((3, 3), 1 / 9) for _ in range(2)]
    datasets = (JaxDataset(f"{root}/test", observations_count=T), MulticameraVideoDataset(f"{root}/test",
                                                                                          observations_count=T))
    return jscene, jtrain, state, trainer, datasets


def test_infer_single_actions_and_rollout_single_match_jax(setup):
    jscene, _, state, trainer, _ = setup
    arrays = encoding_arrays(seed=1)
    jenc = JaxEncoding(**{k: jnp.asarray(v) for k, v in arrays.items()})
    variables = {"params": state.params, "batch_stats": state.batch_stats}
    centroids = [jnp.asarray(state.extra["centroids"][str(i)]) for i in range(2)]
    names = []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def infer(variables, enc):
        with recorded_draws(("normal", "gumbel")) as draws:
            out = JaxPlayable(jscene).apply(variables, enc, centroids, method=JaxPlayable.infer_single_actions,
                                            rngs={"action_sampling": jax.random.PRNGKey(4),
                                                  "gumbel": jax.random.PRNGKey(5)})
        names[:] = [n for n, _ in draws]
        return [{k: v for k, v in o.items() if v is not None} for o in out], [v for _, v in draws]

    refs, values = jax.device_get(infer(variables, jenc))
    replay = Replay([(n, np.asarray(v)) for n, v in zip(names, values)])
    playable = trainer.playable_model
    before = {k: v.clone() for k, v in playable.state_dict().items()}
    with torch.no_grad():
        outs = playable.infer_single_actions(SceneEncoding(**{k: torch.from_numpy(v) for k, v in arrays.items()}),
                                             trainer.centroids, replay)
    assert not replay.draws and replay.streams == ["action_sampling", "action_sampling", "gumbel"] * 2
    for out, ref in zip(outs, refs):
        assert out.pop("action_variations") is None and set(out) == set(ref)
        for key, value in out.items():
            np.testing.assert_allclose(value.numpy(), ref[key], rtol=1e-5, atol=1e-5, err_msg=key)
    for key, value in playable.state_dict().items():
        assert torch.equal(value, before[key]), key

    rng = np.random.default_rng(6)
    for dynamic_idx in range(2):
        obj = 2 + dynamic_idx
        leaves = [arrays[f"object_{k}"][:, :, obj] for k in ("rotations", "translations", "style", "deformation")]
        actions = np.eye(3, dtype=np.float32)[rng.integers(0, 3, (2, 3))]
        variations = rng.normal(size=(2, 3, 2)).astype(np.float32)
        ref = jax.jit(lambda v, *a, d=dynamic_idx: JaxPlayable(jscene).apply(
            v, d, *a, 1, method=JaxPlayable.rollout_single), compiler_options=NO_OPT)(
            {"params": state.params}, *leaves, actions, variations)
        got = playable.rollout_single(dynamic_idx, *(torch.from_numpy(x) for x in leaves + [actions, variations]))
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def jitted_encode_batch(jtrain):
    """The JAX trainer's encode_batch as one jitted program (XLA's CPU
    optimization off): its eager form compiles every operation apart."""
    return jax.jit(jtrain.encode_batch, compiler_options=NO_OPT)


def evaluators(setup, tmp_path):
    _, jtrain, _, trainer, (jdataset, dataset) = setup
    common = dict(batch_size=2, val_batches=2, action_video_frames=FRAMES, patch_strides=STRIDES, seed=3)
    return (jax_evaluator.PlayableModelEvaluator(jtrain, jdataset, str(tmp_path / "jax"), **common),
            playable_evaluator.PlayableModelEvaluator(trainer, dataset, str(tmp_path / "port"), **common))


def test_validation_losses_match_jax(setup, tmp_path, monkeypatch):
    _, _, state, trainer, _ = setup
    jeval, evaluator = evaluators(setup, tmp_path)
    names, records = [], []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def val(params, stats, extra, encoding, key, step):
        with recorded_draws(("normal", "gumbel")) as draws:
            metrics = jeval._val_losses_impl(params, stats, extra, encoding, key, step)
        names[:] = [n for n, _ in draws]
        return metrics, [v for _, v in draws]

    def recording(*args):
        metrics, values = val(*args)
        records.append([(n, np.asarray(v)) for n, v in zip(names, values)])
        return metrics

    jeval._val_loss_fn = recording
    monkeypatch.setattr(jeval.trainer, "encode_batch", jitted_encode_batch(jeval.trainer))
    ref = jeval.validation_losses(state)
    assert len(records) == 1  # the split's 2 windows make one batch of 2
    replays = []

    def replayed(seed, batch_idx, device):
        assert seed == 3 + 7
        replays.append(Replay(records[batch_idx]))
        return replays[-1]

    monkeypatch.setattr(playable_evaluator, "step_streams", replayed)
    before = {k: v.clone() for k, v in trainer.playable_model.state_dict().items()}
    centroids = [c.clone() for c in trainer.centroids]
    got = evaluator.validation_losses()
    assert all(not r.draws for r in replays)
    assert set(got) == set(ref) and "val_loss" in got
    for name, value in got.items():
        np.testing.assert_allclose(value, float(ref[name]), rtol=1e-5, atol=1e-7, err_msg=name)
    for key, value in trainer.playable_model.state_dict().items():
        assert torch.equal(value, before[key]), key
    assert all(torch.equal(a, b) for a, b in zip(trainer.centroids, centroids))
