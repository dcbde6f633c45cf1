"""Phase 3 from data, the port against the JAX package on the CPU:
- `PlayableTrainer.encode_batch` (the frozen environment model in eval
  mode) on a dataset batch, every field at 1e-5;
- one `step_with_batch` (encode, then the generator and discriminator
  passes) with JAX's own `normal`/`gumbel` draws replayed into the port, at
  test_torch_port_phase3.py's tolerances: the loss and every metric 1e-5
  relative; running statistics, u/sigma, centroids and MI matrices 1e-5;
  parameters within 2 lr + 1e-6 everywhere and 1e-6 + 1e-5 |ref| where the
  gradient's sign is clear;
- `init_state(batch)`: the state is built on the batch's frozen encoding,
  with the JAX trainer's shapes and MI matrices (the centroids are seeded
  draws, which the two packages make from different generators);
- `EncodingCache`: `windows`, `gather_windows` and
  `iterate_encoding_batches` (seeded order, process sharding and its
  balance) equal to the JAX package's; `build` over the dataset at 1e-5;
  caches saved by either package load in the other; the fingerprint of the
  carried-over weights isclose (rtol 1e-6) to JAX's of the same flax
  params, and a stale one raises.
The scene is test_torch_port_phase3.py's (2 players, discriminators, GAN,
ACMV and entropy on), its environment variables from a jitted JAX init,
perturbed, carried over by compat/from_flax.py; the dataset is
data.synthetic.make_two_player_dataset's at 16x24."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.data.dataset import MulticameraVideoDataset as JaxDataset
from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.render.playable_model import PlayableEnvironmentModel as JaxPlayable
from playableenvironments_tpu.scene.encoding import SceneEncoding as JaxEncoding
from playableenvironments_tpu.train import encoding_cache as jcache
from playableenvironments_tpu.train import trainer_playable as jtrainer
from playableenvironments_tpu_torch.compat.from_flax import load_environment_model, load_playable_extra
from playableenvironments_tpu_torch.data.batching import collate
from playableenvironments_tpu_torch.data.dataset import MulticameraVideoDataset
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch.train import encoding_cache, trainer_playable
from test_torch_port_composer import Replay, recorded_draws
from playableenvironments_tpu_torch.data.synthetic import make_two_player_dataset
from torch_port_scenes import init_with_composer, jax_batch
from test_torch_port_phase3 import LEARNING_RATE, gradient_tolerances, port_model, scene, seeded_tree, training_config
from test_torch_port_play import _perturbed
from test_torch_port_train import to_port
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

F32 = dict(rtol=1e-5, atol=1e-5)
BS, T = 4, 4
NO_OPT = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """A 2-player dataset (2 videos of 6 frames at 16x24, players within a
    few metres of the origin, so that the encoding is O(1) as the seeded
    weights expect): its path and the batch
    of the first BS windows of T frames."""
    root = make_two_player_dataset(str(tmp_path_factory.mktemp("data")), videos=2, frames=6, height=16, width=24,
                                   focal=20.0, seed=4, splits=("test",))
    path = os.path.join(root, "test")
    dataset = MulticameraVideoDataset(path, observations_count=T)
    return path, collate([dataset[i] for i in range(BS)])


@functools.lru_cache(maxsize=None)
def environment(path):
    """(JAX environment model, its variables, the port's model holding them)."""
    dataset = MulticameraVideoDataset(path, observations_count=T)
    jmodel = JaxEnvironmentModel(scene())
    init = jax.jit(lambda key, *a: jmodel.init(key, *a, method=init_with_composer))
    batch = collate([dataset[0]])
    tree = jax.device_get(init(jax.random.PRNGKey(0), *jax_batch(batch).environment_model_args()))
    rng = np.random.default_rng(11)
    variables = {name: _perturbed(value, rng) for name, value in tree.items()}
    model = EnvironmentModel(to_port(scene()), device="cpu")
    assert load_environment_model(model, variables) == []
    return jmodel, variables, model


@pytest.fixture(scope="module")
def jax_step(data):
    """The JAX trainer's state before the step (seeded values on
    jax.eval_shape's tree), the batch's frozen encoding, the state and
    metrics after step_with_batch and its recorded draws; all numpy."""
    path, batch = data
    jmodel, env, _ = environment(path)
    trainer = jtrainer.PlayableTrainer(jmodel, JaxPlayable(scene(), with_discriminators=True),
                                       training_config(jtrainer))
    jbatch = jax_batch(batch)
    shapes = jax.eval_shape(lambda b: trainer.init_state(jax.random.PRNGKey(0), b, env["params"], env["batch_stats"]),
                            jbatch)
    rng = np.random.default_rng(1)
    params = seeded_tree(shapes.params, rng)
    stats = seeded_tree(shapes.batch_stats, rng)
    extra = {"centroids": {str(i): rng.normal(size=(4, 3)).astype(np.float32) for i in range(2)},
             "mi_matrices": {str(i): np.full((4, 4), 1 / 16, np.float32) for i in range(2)},
             "environment": env, "disc_opt_state": trainer.tx_disc.init(params)}
    state = shapes.replace(params=params, batch_stats=stats, opt_state=shapes.tx.init(params), extra=extra,
                           step=jnp.asarray(0, jnp.int32))
    names = []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def run(state, batch, key):
        encoding = trainer.encode_batch(state.extra, batch, key)
        with recorded_draws(("normal", "gumbel")) as draws:
            after, metrics = trainer.step_with_batch(state, batch, key)
        names[:] = [name for name, _ in draws]
        keep = {"params": after.params, "batch_stats": after.batch_stats, "centroids": after.extra["centroids"],
                "mi_matrices": after.extra["mi_matrices"], "step": after.step}
        return encoding, metrics, keep, [v for _, v in draws]

    encoding, metrics, after, values = jax.device_get(run(state, jbatch, jax.random.PRNGKey(3)))
    before = {"params": params, "batch_stats": stats, "centroids": extra["centroids"],
              "mi_matrices": extra["mi_matrices"]}
    return before, encoding, metrics, after, [(n, np.asarray(v)) for n, v in zip(names, values)], shapes


def port_trainer(path, before):
    _, _, env_model = environment(path)
    model = port_model(before["params"], before["batch_stats"])
    trainer = trainer_playable.PlayableTrainer(model, training_config(trainer_playable), environment_model=env_model)
    load_playable_extra(trainer, before)
    return trainer


def test_encode_batch_matches_jax(data, jax_step):
    path, batch = data
    before, jencoding = jax_step[:2]
    trainer = port_trainer(path, before)
    assert not trainer.environment_model.training
    assert not any(p.requires_grad for p in trainer.environment_model.parameters())
    encoding = trainer.encode_batch(batch)
    assert not encoding.object_style.requires_grad
    for field in vars(encoding):
        got, ref = getattr(encoding, field).numpy(), np.asarray(getattr(jencoding, field))
        assert got.shape == ref.shape == (BS, T) + ref.shape[2:], field
        np.testing.assert_allclose(got, ref, **F32, err_msg=field)


def test_step_with_batch_matches_jax(data, jax_step):
    path, batch = data
    before, _, jmetrics, jafter, draws, _ = jax_step
    trainer = port_trainer(path, before)
    model = trainer.playable_model
    assert [n for n, _ in draws] == ["normal", "normal", "gumbel"] * 8
    grads = {}
    discriminator_step = trainer.discriminator_step

    def capture(*args):
        grads.update({n: p.grad.clone() for n, p in model.named_parameters() if not n.startswith("discriminator")})
        return discriminator_step(*args)

    trainer.discriminator_step = capture
    replay = Replay(draws)
    metrics = trainer.step_with_batch(batch, replay)
    assert not replay.draws and replay.streams == ["action_sampling", "action_sampling", "gumbel"] * 8
    grads.update({n: p.grad.clone() for n, p in model.named_parameters() if n.startswith("discriminator")})
    assert set(metrics) == set(jmetrics) and "discriminator_loss" in metrics
    for name, value in metrics.items():
        np.testing.assert_allclose(value.numpy(), np.asarray(jmetrics[name]), rtol=1e-5, atol=1e-7, err_msg=name)
    state = model.state_dict()
    ref = port_model(jafter["params"], jafter["batch_stats"]).state_dict()
    atol = gradient_tolerances(grads, grads)
    for name, grad in grads.items():
        diff = (state[name] - ref[name]).abs()
        clear = grad.abs() > max(1e-3 * grad.abs().max().item(), 2 * atol[name])
        assert bool((diff[clear] <= 1e-6 + 1e-5 * ref[name][clear].abs()).all()), name
        assert bool((diff <= 2 * LEARNING_RATE + 1e-6).all()), name
    for name in (n for n in state if n not in grads):
        np.testing.assert_allclose(state[name].numpy(), ref[name].numpy(), rtol=1e-5, atol=1e-6, err_msg=name)
    for key in ("centroids", "mi_matrices"):
        for i, value in enumerate(getattr(trainer, key)):
            np.testing.assert_allclose(value.numpy(), jafter[key][str(i)], rtol=1e-5, atol=1e-6, err_msg=key)
    assert trainer.step == int(jafter["step"]) == 1


def test_init_state_from_a_batch(data, jax_step):
    """The state is init_state_from_encoding of the batch's frozen encoding;
    its centroids and MI matrices have the JAX state's shapes, the MI
    matrices its values (1 / A^2)."""
    path, batch = data
    before, jencoding, *_, shapes = jax_step
    trainer = port_trainer(path, before)
    seen = []
    init_from_encoding = trainer.init_state_from_encoding
    trainer.init_state_from_encoding = lambda encoding, seed: (seen.append(encoding), init_from_encoding(encoding, seed))
    trainer.init_state(batch, seed=2)
    np.testing.assert_allclose(seen[0].object_style.numpy(), np.asarray(jencoding.object_style), **F32)
    for i, (centroids, mi) in enumerate(zip(trainer.centroids, trainer.mi_matrices)):
        assert tuple(centroids.shape) == shapes.extra["centroids"][str(i)].shape
        np.testing.assert_array_equal(mi.numpy(), np.full(shapes.extra["mi_matrices"][str(i)].shape, 1 / 16, np.float32))
    again = port_trainer(path, before)
    again.init_state_from_encoding(again.encode_batch(batch), seed=2)
    for a, b in zip(trainer.centroids, again.centroids):
        assert torch.equal(a, b)


def fake_caches(frames=11):
    """The same numpy cache in both packages: 2 videos of 6 and 5 frames."""
    rng = np.random.default_rng(0)
    leaves = dict(
        camera_rotations=rng.normal(size=(frames, 1, 3)), camera_translations=rng.normal(size=(frames, 1, 3)),
        focals=np.full((frames, 1), 300.0), object_rotations=rng.normal(size=(frames, 2, 3)),
        object_translations=rng.normal(size=(frames, 2, 3)), object_style=rng.normal(size=(frames, 2, 4)),
        object_deformation=rng.normal(size=(frames, 2, 2)),
    )
    leaves = {k: v.astype(np.float32) for k, v in leaves.items()}
    leaves["object_in_scene"] = rng.random((frames, 2)) > 0.2
    return (jcache.EncodingCache(JaxEncoding(**leaves), [(0, 6), (6, 5)], skip_frames=1),
            encoding_cache.EncodingCache(SceneEncoding(**leaves), [(0, 6), (6, 5)], skip_frames=1))


@pytest.mark.parametrize("process_count", [1, 2, 3])
def test_cache_windows_and_batches_match_jax(process_count):
    jax_cache, cache = fake_caches()
    for count in (1, 2, 3):
        np.testing.assert_array_equal(cache.windows(count), jax_cache.windows(count))
    starts = np.asarray([0, 6, 2])
    for field, leaf in vars(cache.gather_windows(starts, 2)).items():
        np.testing.assert_array_equal(leaf, getattr(jax_cache.gather_windows(starts, 2), field))
    counts = []
    for index in range(process_count):
        kwargs = dict(seed=3, process_index=index, process_count=process_count)
        for drop_last in (True, False):
            got = list(cache.iterate_encoding_batches(2, 2, drop_last=drop_last, device="cpu", **kwargs))
            ref = list(jax_cache.iterate_encoding_batches(2, 2, drop_last=drop_last, **kwargs))
            assert len(got) == len(ref) and len(ref) > 0
            for g, r in zip(got, ref):
                for field in vars(g):
                    assert getattr(g, field).device.type == "cpu"
                    np.testing.assert_array_equal(getattr(g, field).numpy(), np.asarray(getattr(r, field)))
        counts.append(len(got))
    # Windows of 2 with skip 1: 4 + 3 = 7, cut to a multiple of the
    # process count so that every process takes as many batches.
    assert len(set(counts)) == 1


def test_cache_build_and_files_match_jax(data, tmp_path):
    """build over the dataset at 1e-5; either package's npz loads in the
    other; the fingerprints of the same weights agree and a stale one
    raises."""
    path, _ = data
    jmodel, env, model = environment(path)
    encode = jax.jit(lambda b, k: jmodel.apply(env, *b.environment_model_args(), shuffle_style=False, train=False,
                                                method=JaxEnvironmentModel.compute_scene_encoding,
                                                mutable=["batch_stats"])[0][0])
    jdataset = JaxDataset(path, observations_count=T)
    reference = jcache.EncodingCache.build(encode, jdataset, jax.random.PRNGKey(0), batch_size=4)
    dataset = MulticameraVideoDataset(path, observations_count=T)
    seen = []

    def encode_fn(batch):
        seen.append(batch.batch_size)
        with torch.no_grad():
            return model.compute_scene_encoding(*batch.environment_model_args(), train=False)[0]

    cache = encoding_cache.EncodingCache.build(encode_fn, dataset, batch_size=4)
    assert seen == [4, 4, 4] and dataset.observations_count == T
    assert cache.video_slices == [tuple(s) for s in reference.video_slices] == [(0, 6), (6, 6)]
    for field, leaf in vars(cache.encoding).items():
        assert isinstance(leaf, np.ndarray) and leaf.shape[0] == 12
        np.testing.assert_allclose(leaf, np.asarray(getattr(reference.encoding, field)), **F32, err_msg=field)

    fingerprint = encoding_cache.params_fingerprint(model)
    jax_fingerprint = jcache.params_fingerprint(env["params"])
    assert np.isclose(fingerprint, jax_fingerprint, rtol=1e-6)
    # The same parameter set: every flax params leaf is one port parameter.
    assert sum(p.numel() for p in model.parameters()) == sum(
        np.asarray(leaf).size for leaf in jax.tree.leaves(env["params"]))
    written = {"jax": str(tmp_path / "jax.npz"), "port": str(tmp_path / "port.npz")}
    reference.save(written["jax"], fingerprint=jax_fingerprint)
    cache.save(written["port"], fingerprint=fingerprint)
    for loaded in (encoding_cache.EncodingCache.load(written["jax"], fingerprint=fingerprint),
                   jcache.EncodingCache.load(written["port"], fingerprint=jax_fingerprint)):
        assert [tuple(s) for s in loaded.video_slices] == cache.video_slices and loaded.skip_frames == 0
        for field, leaf in vars(cache.encoding).items():
            np.testing.assert_allclose(np.asarray(getattr(loaded.encoding, field)), leaf, **F32, err_msg=field)
    for load, path_ in ((encoding_cache.EncodingCache.load, written["jax"]), (jcache.EncodingCache.load, written["port"])):
        with pytest.raises(ValueError, match="different frozen env weights"):
            load(path_, fingerprint=fingerprint * 1.001)
