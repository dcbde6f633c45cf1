"""The port's eval render path against the JAX package: render_rays_fast on
the tiny tennis scene (ray compaction below 1, hits beyond the budget)
against JAX render_rays_fast(interpret=True) at 5e-3, the decoder at 1e-4,
and the parity traps of this path pinned one by one: the stable hits-first
partition and its truncation, the (t, object index) tie order, the log-space
1 - alpha and the BIG / 1e10 sentinels, the bender's PE annealing at step 0,
and bilinear x2 upsampling at the edges."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.core import rays as jax_rays
from playableenvironments_tpu.core.transforms3d import euler_translation_to_matrix, invert_rigid
from playableenvironments_tpu.models.autoencoder import MultiresAutoencoder as JaxAutoencoder
from playableenvironments_tpu.render import fast as jax_fast
from playableenvironments_tpu.render import sampling as jax_sampling
from playableenvironments_tpu_torch.cli.play import InteractiveSession
from playableenvironments_tpu_torch.models.autoencoder import upsample2x_bilinear
from playableenvironments_tpu_torch.render import fast
from test_torch_port_play import (
    FOCAL_MULTIPLIER, IMAGE, STRIDES, encoding_arrays, jax_variables, port_encoding, port_modules, scenes,
)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

BF16_TOL = dict(atol=5e-3, rtol=5e-3)


def frame_rays(tied=False):
    """render_frame_fast's ray set for the tiny scene, as numpy arrays.
    `tied` puts player 2 exactly on player 1, so that every sample of one
    ties in t with a sample of the other and the tie order decides."""
    arrays = encoding_arrays()
    if tied:
        for field in ("object_rotations", "object_translations"):
            arrays[field][:, :, 3] = arrays[field][:, :, 2]
    enc = {k: jnp.asarray(v) for k, v in arrays.items()}
    directions, _, _ = jax_rays.camera_rays(*IMAGE, enc["focals"] * FOCAL_MULTIPLIER)
    sampled, _, _ = jax_sampling.sample_all_rays_strided_grid(directions, jnp.zeros(directions.shape), list(STRIDES))
    c2w = euler_translation_to_matrix(enc["camera_rotations"], enc["camera_translations"])
    origins = jnp.zeros(enc["camera_rotations"].shape)
    normals = origins.at[..., 2].set(-1.0)
    origins, directions, normals = jax_rays.transform_rays(origins, sampled, normals, c2w)
    w2o = invert_rigid(euler_translation_to_matrix(enc["object_rotations"], enc["object_translations"]))
    args = (origins, directions, normals, w2o[:, :, None], enc["object_style"][:, :, None],
            enc["object_deformation"][:, :, None], enc["object_in_scene"][:, :, None])
    return [np.array(a) for a in args]


@pytest.mark.parametrize("step,tied", [(0, False), (60, True)])
def test_render_rays_fast_matches_jax(step, tied):
    jscene, pscene = scenes()
    env, _ = jax_variables()
    composer, _, _ = port_modules()
    args = frame_rays(tied)
    arrays = encoding_arrays()
    if not tied:  # the port's own frame geometry gives the same rays
        for got, ref in zip(fast.frame_rays(port_encoding(arrays), IMAGE, STRIDES, FOCAL_MULTIPLIER), args):
            np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    ref = jax.jit(
        lambda *a: jax_fast.render_rays_fast(jscene, env, *a, step=step, interpret=True)
    )(*map(jnp.asarray, args))
    got = fast.render_rays_fast(pscene, composer, *map(torch.from_numpy, args), step=step)
    assert set(got["coarse"]) == set(ref["coarse"]) == {"global", "object_0", "object_1", "object_2", "object_3"}
    for part, fields in got["coarse"].items():
        for field, value in fields.items():
            np.testing.assert_allclose(
                value.numpy(), np.asarray(ref["coarse"][part][field]), **BF16_TOL, err_msg=f"{part}.{field}",
            )
    # The players are seen: their integrals are not all zero.
    assert got["coarse"]["object_3"]["opacity"].max() > 0.1


def test_hits_first_partition_is_stable_and_truncated(rng):
    """Hit rays first in ray order, then misses in ray order, cut at the
    budget: rays past it (hits included) get slot `budget` and vanish."""
    hit = rng.uniform(size=(3, 40)) < np.asarray([[0.2], [0.6], [0.95]])
    budget = 15
    order, inv = fast.hits_first_order(torch.from_numpy(hit), budget)
    expected = np.argsort(~hit, axis=-1, kind="stable")[:, :budget]
    np.testing.assert_array_equal(order.numpy(), expected)
    for row in range(3):
        slots = np.full(40, budget)
        slots[expected[row]] = np.arange(budget)
        np.testing.assert_array_equal(inv[row].numpy(), slots)
    assert hit[2].sum() > budget  # a row whose hits overflow the budget


def test_render_truncates_hits_like_jax():
    """In the tiny frame player 2 and the background have more hitting rays
    than their budgets (checked here), which the frame comparison in
    test_render_rays_fast_matches_jax then covers."""
    _, pscene = scenes()
    origins, directions, _, w2o, _, _, in_scene = (torch.from_numpy(a) for a in frame_rays())
    from playableenvironments_tpu_torch.core import bbox, rays

    rays_count = directions.shape[-2]
    overflowing = []
    for idx, cfg in enumerate(pscene.object_models):
        o, d, _ = rays.transform_rays(origins, directions, origins, w2o[..., idx, :, :])
        near, far = bbox.ray_aabb_bounds(o, d, torch.tensor(cfg.bounding_box), in_scene[..., idx])
        budget = max(int(rays_count * cfg.ray_compaction), 1)
        if cfg.ray_compaction < 1 and int((far > near).sum()) > budget:
            overflowing.append(cfg.name)
    assert "player_2" in overflowing and "background" in overflowing


def test_log_space_one_minus_alpha_and_sentinels():
    """log(1 - alpha + 1e-10) as logaddexp(-x, log 1e-10): at x = 23,
    1 - alpha rounds to 0 in f32 and the naive form loses exp(-23) ~ 1e-10,
    half the mass. A successor at BIG means the last interval, 1e10."""
    raw = torch.tensor([23.0, 0.0, 2.0, 5.0])
    t = torch.tensor([1.0, 1.0, 1.0, 1.0])
    next_t = torch.tensor([2.0, 2.0, fast.BIG, 1.5])
    alphas, log1m = fast.sample_alphas(raw, next_t, t, torch.tensor(1.0))
    expected = np.log(np.exp(-np.array([23.0, 0.0, 2.0 * 1e10, 2.5])) + 1e-10)
    np.testing.assert_allclose(log1m.numpy(), expected, rtol=1e-6)
    np.testing.assert_allclose(
        alphas.numpy(), 1 - np.exp(-np.array([23.0, 0.0, 2e10, 2.5])), rtol=1e-6,
    )
    assert abs(log1m[0].item() - np.log(1e-10)) > 0.5  # what the naive form would give
    assert fast.BIG == 3.0e38 and fast.LAST_DISTANCE == 1e10


def test_bender_anneals_from_step_zero():
    """At step 0 every PE octave of the bender is weighted 0 (only the raw
    position and the deformation code reach the MLP), as in JAX; later steps
    differ; and the frame path's default step is 0."""
    jscene, pscene = scenes()
    env, _ = jax_variables()
    composer, _, _ = port_modules()
    rng = np.random.default_rng(7)
    positions = rng.uniform(-0.7, 0.7, (5, 4, 3)).astype(np.float32)
    deformation = rng.normal(size=(5, 1, 4)).astype(np.float32)
    params = env["params"]["composer"]["object_model_2"]["ray_bender"]
    bender = composer.object_model(2).ray_bender
    results = {}
    for step in (0, 60):
        ref = jax_fast._bender_displacements(
            jscene.object_models[2], params, jnp.asarray(positions), jnp.asarray(deformation), step
        )
        with torch.no_grad():
            got = fast._bender_displacements(
                pscene.object_models[2], bender, torch.from_numpy(positions), torch.from_numpy(deformation), step
            )
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-5)
        results[step] = got
    assert not torch.allclose(results[0], results[60], atol=1e-5)
    for fn in (fast.render_frame_fast, fast.render_rays_fast):
        assert inspect.signature(fn).parameters["step"].default == 0
    assert "step" not in inspect.signature(InteractiveSession.render).parameters


def test_decoder_matches_jax(rng):
    """MultiresAutoencoder.decode in eval mode (running BN statistics,
    bilinear x2 upsampling, reflect padding), 1e-4."""
    jscene, pscene = scenes()
    env, _ = jax_variables()
    _, autoencoder, _ = port_modules()
    levels = [rng.normal(size=(2, 8, 12, 8)).astype(np.float32), rng.normal(size=(2, 4, 6, 16)).astype(np.float32)]
    ae_vars = {"params": env["params"]["autoencoder"], "batch_stats": env["batch_stats"]["autoencoder"]}
    ref = JaxAutoencoder(jscene.autoencoder).apply(
        ae_vars, [jnp.asarray(x) for x in levels], False, method=JaxAutoencoder.decode
    )
    got = autoencoder.decode([torch.from_numpy(x) for x in levels])
    assert got.shape == (2, 16, 24, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("shape", [(1, 3, 2, 2), (2, 5, 7, 4)])
def test_bilinear_upsample_equals_jax_resize_edges_included(rng, shape):
    x = rng.normal(size=shape).astype(np.float32)
    n, c, h, w = shape
    ref = jax.image.resize(jnp.asarray(x).transpose(0, 2, 3, 1), (n, 2 * h, 2 * w, c), method="bilinear")
    got = upsample2x_bilinear(torch.from_numpy(x)).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-6, rtol=1e-6)
