"""The port's phase-2 encoder stack against the JAX package on the CPU:
train-mode MaskedBatchNorm and AdaIN (outputs and running statistics),
avg_pool (including the window clamped to small inputs), the residual
block, the crops (crop_and_resize, roi_pool, expand_boxes), both object
encoders in train and eval mode (outputs and updated batch_stats) and the
pose strategies. All in f32; outputs at 1e-5 (1e-4 through the ~20
convolutions and batch norms of an encoder), running statistics at 1e-5.
Weights are made by the JAX package, perturbed with seeded numpy and
carried over by compat/from_flax.py."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.core.transforms3d import euler_translation_to_matrix, invert_rigid
from playableenvironments_tpu.models import layers as jlayers
from playableenvironments_tpu.models import object_encoders as jenc
from playableenvironments_tpu.models import parameter_encoders as jparam
from playableenvironments_tpu.ops import roi_crop as jroi
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.compat.from_flax import load_flax_tree
from playableenvironments_tpu_torch.models import layers, object_encoders, parameter_encoders
from playableenvironments_tpu_torch.ops import roi_crop
from test_torch_port_play import _perturbed

F32 = dict(rtol=1e-5, atol=1e-5)
DEEP = dict(rtol=1e-4, atol=1e-4)


def t(x):
    return torch.from_numpy(np.array(x, np.float32))


def close(got, ref, tol=F32, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol, err_msg=err_msg)


def variables(module, *args, seed=0, **kwargs):
    init = jax.jit(lambda key, *a: module.init(key, *a, **kwargs))
    tree = jax.device_get(init(jax.random.PRNGKey(seed), *args))
    rng = np.random.default_rng(seed + 10)
    return {name: _perturbed(value, rng) for name, value in tree.items()}


def test_masked_batch_norm_and_adain_train_mode():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 6, 8)).astype(np.float32) * 2 + 0.5
    mask = rng.random((3, 5, 6)) > 0.3
    style = rng.normal(size=(3, 1, 1, 4)).astype(np.float32)
    jmod = jlayers.AffineTransformAdaIn(8, 4)
    v = variables(jmod, jnp.asarray(x), jnp.asarray(style), jnp.asarray(mask))
    ref, mutated = jmod.apply(v, jnp.asarray(x), jnp.asarray(style), jnp.asarray(mask), mutable=["batch_stats"])
    mod = layers.AffineTransformAdaIn(8, 4)
    load_flax_tree(mod, v["params"], v["batch_stats"])
    got = mod(t(x), t(style), torch.from_numpy(mask))
    close(got, ref)
    close(mod.norm.mean, mutated["batch_stats"]["norm"]["mean"])
    close(mod.norm.var, mutated["batch_stats"]["norm"]["var"])
    # Eval mode reads the (updated) running statistics and changes nothing.
    ref_eval = jmod.apply({"params": v["params"], **mutated}, jnp.asarray(x), jnp.asarray(style),
                          jnp.asarray(mask), True)
    before = mod.norm.mean.clone()
    close(mod(t(x), t(style), torch.from_numpy(mask), use_running_average=True), ref_eval)
    assert torch.equal(mod.norm.mean, before)
    # Without a mask: plain biased moments.
    jm, jv = jlayers.masked_moments(jnp.asarray(x), None, (0, 1, 2))
    m, var = layers.masked_moments(t(x), None, (0, 1, 2))
    close(m, jm)
    close(var, jv)


@pytest.mark.parametrize("shape,factor", [((2, 8, 12, 3), 2), ((2, 1, 6, 3), 2), ((2, 3, 5, 3), 4), ((1, 4, 4, 2), 1)])
def test_avg_pool_matches_jax(shape, factor):
    x = np.random.default_rng(1).normal(size=shape).astype(np.float32)
    ref = jlayers.avg_pool(jnp.asarray(x), factor)
    got = layers.avg_pool(t(x).permute(0, 3, 1, 2), factor).permute(0, 2, 3, 1)
    close(got, ref)


@pytest.mark.parametrize("train", [True, False])
@pytest.mark.parametrize("cin,cout,df,drop", [(6, 6, 1, False), (6, 10, 2, True), (4, 4, 2, False)])
def test_residual_block_matches_jax(train, cin, cout, df, drop):
    x = np.random.default_rng(2).normal(size=(3, 6, 10, cin)).astype(np.float32)
    jmod = jlayers.ResidualBlock(cout, df, drop)
    v = variables(jmod, jnp.asarray(x), train=False)
    ref, mutated = jmod.apply(v, jnp.asarray(x), train, mutable=["batch_stats"])
    mod = layers.ResidualBlock(cin, cout, df, drop)
    load_flax_tree(mod, v["params"], v["batch_stats"])
    got = mod(t(x).permute(0, 3, 1, 2), train).permute(0, 2, 3, 1)
    close(got, ref)
    expected = layers.ResidualBlock(cin, cout, df, drop)
    load_flax_tree(expected, v["params"], mutated["batch_stats"])
    for name, buffer in mod.named_buffers():
        close(buffer, expected.get_buffer(name).numpy(), err_msg=name)


def boxes_and_images(n=3, h=20, w=28, seed=3):
    rng = np.random.default_rng(seed)
    images = rng.random((n, h, w, 3)).astype(np.float32)
    lt = rng.uniform(0.0, 0.5, (n, 2))
    rb = lt + rng.uniform(0.1, 0.5, (n, 2))
    boxes = np.concatenate([lt, np.minimum(rb, 1.0)], axis=-1).astype(np.float32)
    return images, boxes


def test_crops_match_jax():
    images, boxes = boxes_and_images()
    pixel = boxes * np.asarray([28, 20, 28, 20], np.float32)
    pixel[0] = [-3.0, 2.0, 40.0, 25.0]  # partly outside the image
    for out in ((6, 6), (5, 9)):
        close(roi_crop.crop_and_resize(t(images), t(pixel), out),
              jroi.crop_and_resize(jnp.asarray(images), jnp.asarray(pixel), out))
        close(roi_crop.roi_pool(t(images), t(pixel), out), jroi.roi_pool(jnp.asarray(images), jnp.asarray(pixel), out))
    close(roi_crop.expand_boxes(t(boxes), 0.3, 0.2), jroi.expand_boxes(jnp.asarray(boxes), 0.3, 0.2))


@pytest.mark.parametrize("kind,input_size,crop_mode", [("v4", (16, 16), "bilinear"), ("v5", (16, 32), "roi_pool"),
                                                      ("v5", (8, 16), "bilinear")])
@pytest.mark.parametrize("train", [True, False])
def test_object_encoders_match_jax(kind, input_size, crop_mode, train):
    jcfg = jax_config.ObjectEncoderConfig(kind=kind, input_size=input_size, style_features=8,
                                          deformation_features=4, expansion_rows=0.2, expansion_cols=0.1,
                                          crop_mode=crop_mode)
    cfg = port_config.ObjectEncoderConfig(**dataclasses.asdict(jcfg))
    images, boxes = boxes_and_images(n=4)
    rng = np.random.default_rng(4)
    rot, trans = (rng.normal(size=(4, 3)).astype(np.float32) for _ in range(2))
    jmod = (jenc.ObjectEncoderV4 if kind == "v4" else jenc.ObjectEncoderV5)(jcfg)
    args = [jnp.asarray(a) for a in (images, boxes, rot, trans)]
    v = variables(jmod, *args, train=False)
    refs, mutated = jax.jit(lambda v, *a: jmod.apply(v, *a, train=train, mutable=["batch_stats"]))(v, *args)
    mod = object_encoders.object_encoder(cfg)
    load_flax_tree(mod, v["params"], v["batch_stats"])
    gots = mod(*(t(a) for a in (images, boxes, rot, trans)), train=train)
    for name, got, ref in zip(("style", "deformation", "attention", "crops"), gots, refs):
        close(got, ref, DEEP, err_msg=name)
    expected = object_encoders.object_encoder(cfg)
    load_flax_tree(expected, v["params"], mutated["batch_stats"])
    for name, buffer in mod.named_buffers():
        close(buffer, expected.get_buffer(name).numpy(), DEEP, err_msg=name)


def test_pose_strategies_match_jax():
    rng = np.random.default_rng(5)
    shape = (2, 3)
    static = jax_config.ParameterEncoderConfig(
        kind="static", translation_range=(((0.0, 0.0), (20.0, 20.2), (0.0, 1.0)),),
        rotation_range=(((0.0, 0.2), (0.0, 0.0), (0.0, 0.0)),))
    for got, ref in zip(parameter_encoders.static_object_poses(port_config.ParameterEncoderConfig(**dataclasses.asdict(static)), shape),
                        jparam.static_object_poses(static, shape)):
        close(got, ref)
    classic = jax_config.ParameterEncoderConfig(
        kind="classic", objects_count=2,
        translation_range=(((-7.5, 7.5), (-20.0, 0.0), (0.01, 0.03)), ((-7.5, 7.5), (0.0, 20.0), (0.0, 0.0))),
        rotation_range=(((0.0, 0.0), (0.0, 0.0), (0.0, 0.4)),) * 2)
    pclassic = port_config.ParameterEncoderConfig(**dataclasses.asdict(classic))
    rotations = np.zeros(shape + (3,), np.float32)
    rotations[..., 0] = -0.65
    translations = np.zeros(shape + (3,), np.float32)
    translations[..., 1], translations[..., 2] = 18.0, 10.0
    w2c = np.asarray(invert_rigid(euler_translation_to_matrix(jnp.asarray(rotations), jnp.asarray(translations))))
    focals = np.full(shape, 300.0, np.float32)
    boxes = rng.uniform(0.2, 0.8, shape + (2, 4)).astype(np.float32)
    validity = rng.random(shape + (2,)) > 0.3
    for apply_ranges in (True, False):
        refs = jparam.classic_object_poses(classic, jnp.asarray(w2c), jnp.asarray(focals), jnp.asarray(boxes),
                                           jnp.asarray(validity), (288, 512), apply_ranges)
        gots = parameter_encoders.classic_object_poses(pclassic, t(w2c), t(focals), t(boxes),
                                                       torch.from_numpy(validity), (288, 512), apply_ranges)
        for got, ref in zip(gots, refs):
            close(got, ref, DEEP)
