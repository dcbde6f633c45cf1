"""The training-time evaluators of phases 1 and 2, the port against the
JAX package on the CPU, on the same weights (carried over by
compat/from_flax.py):

- AutoencoderEvaluator: the eval-mode forward of a tiny autoencoder (v8,
  bottleneck 16, strides 2 and 4) on two 32x32 images, JAX's posterior
  noise (drawn from PRNGKey(0), one split a level) replayed into the port:
  reconstructions at 1e-5, every statistic (validation reconstruction
  loss, each level's KL, |mean| and variance means) at 1e-5 relative;
  the logged grid and metrics written;
- TrainingEvaluator: the tiny tennis scene of test_torch_port_encode.py on
  its 2-player dataset, rendered at a size that shrinks the 16x24 frames to
  8x12: the ground truth resized as jax.image.resize's antialiased
  bilinear (at 1e-6, also where it enlarges), the PSNR at 1e-3 absolute (the
  frames agree within 1e-2, test_torch_port_play.py's bound, and their MSE
  to 1e-4 relative here), the grid's panels.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.eval.autoencoder_evaluator import AutoencoderEvaluator as JaxAutoencoderEvaluator
from playableenvironments_tpu.eval.training_evaluator import TrainingEvaluator as JaxTrainingEvaluator
from playableenvironments_tpu.train import trainer_autoencoder as jtrainer
from playableenvironments_tpu.utils.logger import Logger as JaxLogger
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.compat.from_flax import load_autoencoder
from playableenvironments_tpu_torch.eval.autoencoder_evaluator import AutoencoderEvaluator
from playableenvironments_tpu_torch.eval.training_evaluator import TrainingEvaluator, resize_bilinear
from playableenvironments_tpu_torch.train import trainer_autoencoder
from playableenvironments_tpu_torch.utils.logger import Logger
from test_torch_port_composer import Replay, recorded_draws
from test_torch_port_decoder import AE, NO_OPT, autoencoder_variables
from torch_port_scenes import dataset_batch, jax_batch, tennis_setup, write_two_player_dataset
from test_torch_port_play import STRIDES
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)


def metrics_rows(directory):
    with open(os.path.join(directory, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_autoencoder_evaluator_matches_jax(tmp_path):
    jcfg = jax_config.AutoencoderConfig(**AE)
    variables = autoencoder_variables(jcfg, seed=3)
    images = np.random.default_rng(4).random((2, 32, 32, 3), np.float32)
    jeval = JaxAutoencoderEvaluator(jtrainer.AutoencoderTrainer(jcfg, jtrainer.AutoencoderTrainingConfig()), images)
    names = []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def forward(params, stats, images, key):
        with recorded_draws(("normal",)) as draws:
            out = jeval._forward_impl(params, stats, images, key)
        names[:] = [n for n, _ in draws]
        return out, [v for _, v in draws]

    (jrec, jstats), values = jax.device_get(forward(variables["params"], variables["batch_stats"],
                                                    jnp.asarray(images), jax.random.PRNGKey(0)))
    draws = [(n, np.asarray(v)) for n, v in zip(names, values)]
    assert names == ["normal", "normal"]  # one a level

    trainer = trainer_autoencoder.AutoencoderTrainer(port_config.AutoencoderConfig(**AE),
                                                     trainer_autoencoder.AutoencoderTrainingConfig(), device="cpu")
    load_autoencoder(trainer.model, variables)
    before = {k: v.clone() for k, v in trainer.model.state_dict().items()}
    replays = []

    def replay():
        replays.append(Replay(draws))
        return replays[-1]

    evaluator = AutoencoderEvaluator(trainer, images, rng_factory=replay)
    rec, stats = evaluator.statistics()
    assert not replays[-1].draws and replays[-1].streams == ["sampling", "sampling"]
    np.testing.assert_allclose(rec.numpy(), jrec, rtol=0, atol=1e-5)
    assert set(stats) == set(jstats)
    for name, value in stats.items():
        np.testing.assert_allclose(float(value), float(jstats[name]), rtol=1e-5, atol=1e-7, err_msg=name)
    for key, value in trainer.model.state_dict().items():  # eval mode: no running statistic moved
        assert torch.equal(value, before[key]), key

    logger = Logger(str(tmp_path), use_wandb=False)
    scalars = evaluator.evaluate(logger, 7)
    logger.close()
    assert os.listdir(tmp_path / "images") == ["00000007_autoencoder_reconstruction.png"]
    row = metrics_rows(tmp_path)[0]
    assert row["step"] == 7 and all(row[k] == pytest.approx(v) for k, v in scalars.items())


@pytest.mark.parametrize("size", [(8, 12), (24, 40)])
def test_ground_truth_resize_matches_jax(size):
    """jax.image.resize "bilinear" antialiases where it shrinks; the port's
    resize_bilinear matches it shrinking and enlarging."""
    images = np.random.default_rng(5).random((1, 2, 1, 16, 24, 3), np.float32)
    ref = jax.image.resize(jnp.asarray(images), images.shape[:-3] + size + (3,), "bilinear")
    got = resize_bilinear(torch.from_numpy(images), size)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-6)
    if size[0] < 16:
        plain = torch.nn.functional.interpolate(torch.from_numpy(images[0, :, 0]).permute(0, 3, 1, 2), size=size,
                                                mode="bilinear", align_corners=False)
        assert np.abs(plain.permute(0, 2, 3, 1).numpy() - np.asarray(ref)[0, :, 0]).max() > 1e-2


def test_training_evaluator_matches_jax(tmp_path):
    root = write_two_player_dataset(str(tmp_path / "data"))
    jmodel, model, _, variables, dataset = tennis_setup(root)
    batch = dataset_batch(dataset, 1)
    size = (8, 12)
    jlogger = JaxLogger(str(tmp_path / "jax"), use_wandb=False)
    jpsnr = JaxTrainingEvaluator(jmodel, size, patch_strides=STRIDES).evaluate(variables, jax_batch(batch), jlogger, 3)
    jlogger.close()
    logger = Logger(str(tmp_path / "port"), use_wandb=False)
    evaluator = TrainingEvaluator(model, size, patch_strides=STRIDES)
    psnr = evaluator.evaluate(batch, logger, 3)
    logger.close()
    jrow, row = metrics_rows(tmp_path / "jax")[0], metrics_rows(tmp_path / "port")[0]
    assert set(row) == set(jrow) and row["step"] == 3
    assert psnr == pytest.approx(row["eval_psnr"]) and abs(psnr - float(jpsnr)) <= 1e-3
    np.testing.assert_allclose(row["eval_mse"], jrow["eval_mse"], rtol=1e-4)
    # The grid: [ground truth | reconstruction | novel view], 8 x 36 x 3.
    from PIL import Image

    grids = [np.asarray(Image.open(tmp_path / which / "images" / "00000003_eval_render.png"), np.float32) / 255
             for which in ("port", "jax")]
    assert grids[0].shape == (8, 36, 3)
    np.testing.assert_allclose(grids[0], grids[1], rtol=0, atol=1e-2 + 1 / 255)
    assert np.abs(grids[0][:, 12:24] - grids[0][:, 24:]).max() > 1e-3  # the novel view moved
