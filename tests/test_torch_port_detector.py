"""The player detector, the port against the JAX package on the CPU, at
base_features 8 on 2 x 64 x 64 images, JAX's variables carried over with
compat/from_flax.py::load_detector:

- the forward in train mode (outputs and the batch statistics it leaves)
  and in eval mode, within 1e-5 of each output's largest magnitude;
- splat_gaussian_targets (1e-6), the three losses (1e-6 relative) and
  decode_detections with ties among the peaks and at 0 after the NMS: the
  scores equal and the centers and boxes within 1e-6, entry for entry (a
  different index would move an entry by a whole cell, 1/16);
- one DetectorTrainer.train_step against JAX's jitted train_step: the
  losses (1e-5 relative), every parameter and running statistic after the
  AdamW step within 1e-5 of its tensor's largest magnitude, except the
  biases of `stem` and `down1`, which feed batch norms: their gradient is
  rounding noise, Adam's first step moves each entry by up to the rate in
  either direction, so they are held within 2 x the rate (and their
  gradient within 1e-5 of the largest gradient);
- evaluate_detection over two batches, equal results.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.models import detector as jdet
from playableenvironments_tpu.train import trainer_detector as jtd
from playableenvironments_tpu.train.state import TrainState
from playableenvironments_tpu_torch.compat.from_flax import load_detector
from playableenvironments_tpu_torch.models import detector as det
from playableenvironments_tpu_torch.train import trainer_detector as td
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

NO_OPT = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
FEATURES = 8
SIZE = 64


def jax_variables(seed=0):
    """CenterNetDetector variables from jax.eval_shape, filled with seeded
    values: He-scaled kernels, small biases, batch-norm scales near 1 and
    running statistics away from their initial 0 and 1."""
    model = jdet.CenterNetDetector(base_features=FEATURES)
    shapes = jax.eval_shape(functools.partial(model.init, train=False), jax.random.PRNGKey(0),
                            jnp.zeros((2, SIZE, SIZE, 3)))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = path[-1].key
        shape = leaf.shape
        if name == "kernel":
            value = rng.normal(scale=np.sqrt(2.0 / np.prod(shape[:-1])), size=shape)
        elif name == "var":
            value = 1.0 + np.abs(rng.normal(scale=0.2, size=shape))
        elif name == "scale":
            value = 1.0 + rng.normal(scale=0.05, size=shape)
        else:
            value = rng.normal(scale=0.1, size=shape)
        if path[0].key == "params" and path[1].key == "heatmap_head" and name == "bias":
            value = value + jdet.nn.initializers.constant(-2.19)(None, shape)
        return np.asarray(value, np.float32)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def scene(seed=1):
    """Two 64 x 64 images with colored boxes on a noisy background, ltrb
    boxes (2, 3, 4) and their validity (one box invalid)."""
    rng = np.random.default_rng(seed)
    boxes = np.asarray([[[0.5, 0.25, 0.75, 0.75], [0.1, 0.1, 0.3, 0.4], [0.6, 0.6, 0.9, 0.95]],
                        [[0.125, 0.375, 0.375, 0.9], [0.55, 0.05, 0.7, 0.35], [0.0, 0.0, 0.2, 0.2]]], np.float32)
    validity = np.asarray([[True, True, False], [True, True, True]])
    images = np.full((2, SIZE, SIZE, 3), 0.2, np.float32)
    for i in range(2):
        for o in range(3):
            if validity[i, o]:
                left, top, right, bottom = (boxes[i, o] * SIZE).astype(int)
                images[i, top:bottom, left:right] = rng.random(3)
    images += rng.normal(0, 0.02, images.shape).astype(np.float32)
    return images, boxes, validity


def port_detector(variables):
    net = det.CenterNetDetector(FEATURES, device="cpu")
    load_detector(net, variables)
    return net


def close_to_largest(got, ref, rel, what):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    assert got.shape == ref.shape, what
    bound = rel * max(np.abs(ref).max(), 1e-30)
    err = np.abs(got - ref).max()
    assert err <= bound, f"{what}: {err:.3e} > {bound:.3e}"


@pytest.mark.parametrize("train", [True, False])
def test_forward_matches_jax(train):
    """Outputs within 1e-5 of each one's largest magnitude; in train mode
    also the running statistics the batch statistics leave."""
    variables = jax_variables()
    images, _, _ = scene()
    model = jdet.CenterNetDetector(base_features=FEATURES)
    if train:
        ref, mutated = model.apply(variables, jnp.asarray(images), train=True, mutable=["batch_stats"])
    else:
        ref = model.apply(variables, jnp.asarray(images), train=False)
    net = port_detector(variables)
    with torch.no_grad():
        got = net(torch.from_numpy(images), train=train)
    assert got["heatmap"].shape == (2, SIZE // 4, SIZE // 4)
    for key in ("heatmap", "sizes", "offsets"):
        close_to_largest(got[key], ref[key], 1e-5, key)
    if train:
        after = port_detector({"params": variables["params"], "batch_stats": jax.device_get(mutated["batch_stats"])})
        for name, value in after.state_dict().items():
            close_to_largest(net.state_dict()[name], value, 1e-5, name)


def test_targets_losses_and_decode_match_jax():
    """Targets at 1e-6, losses at 1e-6 relative, and the decode entry for
    entry over a heatmap of plateaus (tied peaks) and more top-k entries
    than peaks (ties at 0)."""
    _, boxes, validity = scene()
    grid = (16, 16)
    ref = jdet.splat_gaussian_targets(jnp.asarray(boxes), jnp.asarray(validity), grid)
    got = det.splat_gaussian_targets(torch.from_numpy(boxes), torch.from_numpy(validity), grid)
    for key in ("heatmap", "sizes", "offsets", "weight"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(ref[key]), rtol=0, atol=1e-6, err_msg=key)

    rng = np.random.default_rng(2)
    outputs = {"heatmap": rng.integers(-3, 3, (2,) + grid).astype(np.float32),
               "sizes": rng.random((2,) + grid + (2,)).astype(np.float32),
               "offsets": rng.random((2,) + grid + (2,)).astype(np.float32)}
    jout = {k: jnp.asarray(v) for k, v in outputs.items()}
    tout = {k: torch.from_numpy(v) for k, v in outputs.items()}
    ref_losses = jdet.detection_loss(jout, ref)
    got_losses = det.detection_loss(tout, got)
    for key, value in ref_losses.items():
        np.testing.assert_allclose(float(got_losses[key]), float(value), rtol=1e-6, err_msg=key)

    top_k = 64
    ref_dec = jax.device_get(jdet.decode_detections(jout, top_k=top_k))
    got_dec = det.decode_detections(tout, top_k=top_k)
    scores = np.asarray(ref_dec["scores"])
    nonzero = scores[scores > 0]
    assert (scores == 0).any() and len(np.unique(nonzero)) < len(nonzero), "the decode should meet ties"
    np.testing.assert_array_equal(got_dec["scores"].numpy(), scores)
    for key in ("centers", "boxes"):
        np.testing.assert_allclose(got_dec[key].numpy(), np.asarray(ref_dec[key]), rtol=0, atol=1e-6, err_msg=key)


def test_train_step_matches_jax():
    """One train step from the same weights and batch (module docstring)."""
    variables = jax_variables()
    images, boxes, validity = scene()
    cfg = jtd.DetectorTrainingConfig(base_features=FEATURES)
    trainer = jtd.DetectorTrainer(cfg)
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"],
                       opt_state=trainer.tx.init(variables["params"]), step=jnp.zeros((), jnp.int32), tx=trainer.tx)
    step = jax.jit(trainer.train_step, compiler_options=NO_OPT)
    new_state, ref_losses = jax.device_get(step(state, jnp.asarray(images), jnp.asarray(boxes),
                                                jnp.asarray(validity)))

    port = td.DetectorTrainer(td.DetectorTrainingConfig(base_features=FEATURES), device="cpu")
    load_detector(port.model, variables)
    got_losses = port.train_step(torch.from_numpy(images), torch.from_numpy(boxes), torch.from_numpy(validity))
    assert port.step == 1
    for key, value in ref_losses.items():
        np.testing.assert_allclose(float(got_losses[key]), float(value), rtol=1e-5, err_msg=key)

    after = port_detector({"params": new_state.params, "batch_stats": new_state.batch_stats}).state_dict()
    for name, value in port.model.state_dict().items():
        if name in ("stem.bias", "down1.bias"):
            grad = port.model.get_parameter(name).grad
            assert grad.abs().max() <= 1e-5 * max(p.grad.abs().max() for p in port.model.parameters()), name
            assert (value - after[name]).abs().max() <= 2 * cfg.learning_rate, name
        else:
            close_to_largest(value, after[name], 1e-5, name)


def test_evaluate_detection_matches_jax():
    """MDR, ADD and detections a frame of the same weights on two batches,
    at a threshold the seeded heatmap crosses."""
    variables = jax_variables()
    images, boxes, validity = scene()
    batches = [(images, boxes, validity), (images[::-1].copy(), boxes[::-1].copy(), validity[::-1].copy())]
    trainer = jtd.DetectorTrainer(jtd.DetectorTrainingConfig(base_features=FEATURES))
    state = TrainState(params=variables["params"], batch_stats=variables["batch_stats"], opt_state=None,
                       step=jnp.zeros((), jnp.int32), tx=trainer.tx)
    ref = jtd.evaluate_detection(trainer, state, [tuple(map(jnp.asarray, b)) for b in batches], threshold=0.12,
                                 match_threshold=0.3)
    port = td.DetectorTrainer(td.DetectorTrainingConfig(base_features=FEATURES), device="cpu")
    load_detector(port.model, variables)
    got = td.evaluate_detection(port, [tuple(map(torch.from_numpy, b)) for b in batches], threshold=0.12,
                                match_threshold=0.3)
    assert set(got) == set(ref)
    assert ref["mean_detections_per_image"] > 0 and ref["missed_detection_rate"] < 1
    for key, value in ref.items():
        np.testing.assert_allclose(got[key], value, rtol=1e-6, err_msg=key)
