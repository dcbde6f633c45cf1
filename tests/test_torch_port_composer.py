"""The port's training render path against the JAX package on the CPU, with
the randomness on and both sides given the same draws: while the JAX
function is traced, jax.random.uniform / normal / permutation are wrapped
to collect what they return, the jitted function returns those draws too,
and the port replays them through its random-stream interface
(utils.random). Covered: the samplers (weight
image, inverse-CDF picks with the all-zero fallback, uniform picks), the
stratified jitter and alpha noise of the composer, the per-object and
sort-free global integrals, the style shuffle and the whole
EnvironmentModel.forward_from_observations in train mode with its running
statistics. All in f32 at 1e-5 (1e-4 and 5e-4 after the encoders, as
stated where they apply).
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.core import compositing as jcompositing
from playableenvironments_tpu.core import rays as jrays
from playableenvironments_tpu.render import sampling as jsampling
from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu_torch.compat.from_flax import load_environment_model
from playableenvironments_tpu_torch.core import compositing, rays
from playableenvironments_tpu_torch.render import sampling
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from test_torch_port_play import _perturbed
from test_torch_port_train import batch_arrays, fused_scene, to_port

F32 = dict(rtol=1e-5, atol=1e-5)


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, tol=F32, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol, err_msg=err_msg)


@contextlib.contextmanager
def recorded_draws(names=("uniform", "normal", "permutation")):
    """Record every result of the named jax.random functions, in call order."""
    draws = []
    originals = {name: getattr(jax.random, name) for name in names}

    def recorder(name):
        def draw(*args, **kwargs):
            out = originals[name](*args, **kwargs)
            draws.append((name, out))
            return out
        return draw

    for name in originals:
        setattr(jax.random, name, recorder(name))
    try:
        yield draws
    finally:
        for name, fn in originals.items():
            setattr(jax.random, name, fn)


class Replay:
    """The port's random-stream interface, returning recorded JAX draws in order."""

    def __init__(self, draws):
        self.draws = list(draws)
        self.streams = []

    def _next(self, kind, stream, shape=None):
        name, value = self.draws.pop(0)
        assert name == kind, (name, kind)
        if shape is not None:
            assert tuple(value.shape) == tuple(shape), (value.shape, shape)
        self.streams.append(stream)
        return torch.from_numpy(value.copy())

    def uniform(self, stream, shape):
        return self._next("uniform", stream, shape)

    def normal(self, stream, shape):
        return self._next("normal", stream, shape)

    def permutation(self, stream, n):
        return self._next("permutation", stream, (n,)).long()

    def gumbel(self, stream, shape):
        return self._next("gumbel", stream, shape)


def test_samplers_match_jax():
    rng = np.random.default_rng(0)
    boxes = rng.uniform(0, 1, (2, 3, 3, 4)).astype(np.float32)
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 0.05)
    boxes[1, 2] = [1.2, 1.2, 1.3, 1.3]  # every box off-screen: the uniform fallback
    weights = (0.5, 0.3, 0.2)
    image = sampling.build_weight_image(t(boxes), weights, 10, 14)
    close(image, jsampling.build_weight_image(jnp.asarray(boxes), weights, 10, 14))
    assert float(image[1, 2].sum()) == 0.0
    key = jax.random.PRNGKey(3)
    ref_idx = jsampling.sample_indices_from_weights(key, jnp.asarray(image.numpy()), 40)
    u = jax.random.uniform(key, (2, 3, 40), dtype=jnp.float32)
    idx = sampling.sample_indices_from_weights(image, t(u))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))

    directions = rng.normal(size=(2, 3, 10, 14, 3)).astype(np.float32)
    observations = rng.random((2, 3, 10, 14, 3)).astype(np.float32)
    refs = jsampling.sample_rays_weighted(key, jnp.asarray(directions), jnp.asarray(observations), 40,
                                          jnp.asarray(boxes), weights)
    gots = sampling.sample_rays_weighted(t(directions), t(observations), t(boxes), weights, t(u))
    for got, ref in zip(gots, refs):
        close(got, ref)
    refs = jsampling.sample_rays_uniform(key, jnp.asarray(directions), jnp.asarray(observations), 17)
    indices = jax.random.randint(key, (2, 3, 17), 0, 140)
    gots = sampling.sample_rays_uniform(t(directions), t(observations), t(indices).long())
    for got, ref in zip(gots, refs):
        close(got, ref)


def test_stratified_positions_and_integrals_match_jax():
    rng = np.random.default_rng(1)
    origins = rng.normal(size=(2, 3)).astype(np.float32)
    directions = rng.normal(size=(2, 5, 3)).astype(np.float32)
    z_near = rng.uniform(1, 2, (2, 5)).astype(np.float32)
    z_far = z_near + rng.uniform(0, 3, (2, 5)).astype(np.float32)
    z_far[0, 0] = z_near[0, 0]  # an empty interval
    key = jax.random.PRNGKey(1)
    ref = jrays.stratified_ray_positions(*(jnp.asarray(a) for a in (origins, directions, z_near, z_far)), 6, True, key)
    u = jax.random.uniform(key, (2, 5, 6), dtype=jnp.float32)
    got = rays.stratified_ray_positions(t(origins), t(directions), t(z_near), t(z_far), 6, t(u))
    for g, r in zip(got, ref):
        close(g, r)
    t_values = [np.sort(rng.uniform(1, 5, (2, 5, s)).astype(np.float32), axis=-1) for s in (3, 6)]
    t_values[1][0, 1, :3] = t_values[0][0, 1]  # exact ties across objects
    feats = [rng.random((2, 5, s, 3)).astype(np.float32) for s in (3, 6)]
    alphas = [rng.normal(size=(2, 5, s)).astype(np.float32) for s in (3, 6)]
    disp = [rng.normal(size=(2, 5, s, 3)).astype(np.float32) * 0.1 for s in (3, 6)]
    div = [rng.normal(size=(2, 5, s)).astype(np.float32) for s in (3, 6)]
    ref = jcompositing.integrate(*(jnp.asarray(a) for a in (feats[1], alphas[1], directions, t_values[1], disp[1], div[1])),
                                 True, key)
    noise = jax.random.normal(key, alphas[1].shape, dtype=jnp.float32)
    got = compositing.integrate(t(feats[1]), t(alphas[1]), t(directions), t(t_values[1]), t(disp[1]), t(div[1]), t(noise))
    assert set(got) == set(ref)
    for name in ref:
        close(got[name], ref[name], err_msg=name)
    ref = jcompositing.compose_integrate_sortfree(
        [jnp.asarray(f) for f in feats], [jnp.asarray(a) for a in alphas], [jnp.asarray(v) for v in t_values],
        jnp.asarray(directions), [jnp.asarray(d) for d in disp], [jnp.asarray(d) for d in div], True, key)
    noise = jax.random.normal(key, (2, 5, 9), dtype=jnp.float32)
    got = compositing.compose_integrate_sortfree(
        [t(f) for f in feats], [t(a) for a in alphas], [t(v) for v in t_values], t(directions),
        [t(d) for d in disp], [t(d) for d in div], t(noise))
    assert set(got) == set(ref)
    for name in ref:
        close(got[name], ref[name], err_msg=name)


def scene():
    """The tiny scene with test_torch_port_train.py's well-conditioned
    background encoder, on the unfused backbone path."""
    return fused_scene(use_fused_backbone=False)


@pytest.fixture(scope="module")
def jax_forward():
    """JAX forward_from_observations of the tiny scene in train mode, with
    weighted sampling, perturbation and the style shuffle, and its draws."""
    model = JaxEnvironmentModel(scene(), focal_length_multiplier=1.0)
    args = [jnp.asarray(v) for k, v in batch_arrays().items() if k not in ("video_frame_indexes", "video_indexes")]
    rngs = {name: jax.random.PRNGKey(i) for i, name in enumerate(
        ("params", "ray_sampling", "sampling", "alpha_noise", "style_shuffle"))}
    variables = jax.device_get(jax.jit(lambda r, *a: model.init(r, *a, samples_per_image=12))(rngs, *args))
    np_rng = np.random.default_rng(1)
    variables = {k: _perturbed(v, np_rng) for k, v in variables.items()}
    names = []

    @jax.jit
    def forward(variables, *args):
        with recorded_draws() as draws:
            out = model.apply(variables, *args, samples_per_image=12, perturb=True, shuffle_style=True,
                              step=30, train=True, rngs=rngs, mutable=["batch_stats"])
        names[:] = [name for name, _ in draws]
        return out, [value for _, value in draws]

    (results, mutated), values = jax.device_get(forward(variables, *args))
    return variables, results, mutated, [(n, np.asarray(v)) for n, v in zip(names, values)]


def test_forward_from_observations_with_the_same_draws_matches_jax(jax_forward):
    variables, ref, mutated, draws = jax_forward
    kinds = [name for name, _ in draws]
    # style shuffle per object, ray picks, stratified jitter per object,
    # alpha noise per object and for the composition.
    assert kinds == ["permutation"] * 2 + ["uniform"] + ["uniform"] * 2 + ["normal"] * 3, kinds
    model = EnvironmentModel(to_port(scene()), device="cpu")
    load_environment_model(model, variables)
    batch = {k: t(v) for k, v in batch_arrays().items()}
    replay = Replay(draws)
    got = model.forward_from_observations(
        *(batch[k] for k in ("observations", "camera_rotations", "camera_translations", "focals", "bounding_boxes",
                             "bounding_boxes_validity", "global_frame_indexes")),
        samples_per_image=12, perturb=True, shuffle_style=True, step=30, train=True, rng=replay,
    )
    assert not replay.draws
    assert replay.streams == ["style_shuffle"] * 2 + ["ray_sampling"] + ["sampling"] * 2 + ["alpha_noise"] * 3
    for name in ("observations", "positions", "ray_object_distances", "reconstructed_bounding_boxes",
                 "reconstructed_3d_bounding_boxes"):
        close(got[name], ref[name], err_msg=name)
    # The player's 8x8 crop leaves 1x1 maps, normalized over 4 values a
    # channel, in the V4 encoder's last blocks: its codes only to 5e-4.
    for name in ("object_style", "object_deformation", "object_translations"):
        close(getattr(got["scene_encoding"], name), getattr(ref["scene_encoding"], name), dict(rtol=1e-4, atol=5e-4),
              err_msg=name)
    for obj in ("global", "object_0", "object_1"):
        for name, value in ref["coarse"][obj].items():
            close(got["coarse"][obj][name], value, dict(rtol=1e-4, atol=1e-5), err_msg=f"{obj} {name}")
    for got_att, ref_att in zip(got["object_attention"], ref["object_attention"]):
        close(got_att, ref_att, dict(rtol=1e-4, atol=1e-5))
    expected = EnvironmentModel(to_port(scene()), device="cpu")
    load_environment_model(expected, {"params": variables["params"], "batch_stats": mutated["batch_stats"]})
    for name, buffer in model.named_buffers():
        close(buffer, expected.get_buffer(name).numpy(), dict(rtol=1e-4, atol=1e-5), err_msg=name)
