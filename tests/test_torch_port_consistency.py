"""Phase 2's consistency passes, the port against the JAX package on the
CPU, piece by piece (the whole step is in
tests/test_torch_port_consistency_step.py):

- `sample_at_positions`, the bilinear grid sample, at both `align_corners`
  settings, with positions on the corners and clamped beyond the edges, at
  1e-6;
- `sample_rays_at_object` and `sample_rays_at_keypoints` on JAX's own
  draws (the same key, its uniform values handed to the port), a
  zero-area box drawing over the whole image: pixel picks exact, values at
  1e-6;
- `expected_positions` at 1e-6, with no gradient into the weights and the
  positions' gradient as JAX's;
- the three losses at 1e-6 relative, with confidences on the threshold:
  the consistency gate keeps them (>=), the opacity gate drops them (>);
- `SceneComposer.forward_expected_positions` of one player with
  perturbation on (JAX's draws replayed) and off: positions and opacity at
  1e-5 on batch statistics, the running statistics untouched (JAX's call
  mutates them; its trainer discards them);
- `forward_pose_consistency` and `forward_keypoint_consistency` of the
  two-player scene of tests/test_torch_port_phase3.py on a numpy scene
  encoding, perturbation on, JAX's draws replayed in JAX's order: the
  expected positions (about a metre) at 1e-4 (f32 sums in another order
  through the field and the compositing move them by up to 2.7e-5 here),
  the opacity, confidence and 2D positions at 1e-5, the validity exact,
  the running statistics untouched.
Weights are seeded numpy values on the shapes of JAX's init
(`jax.eval_shape`), carried over by compat/from_flax.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.core import compositing as jcompositing
from playableenvironments_tpu.render import sampling as jsampling
from playableenvironments_tpu.render.composer import SceneComposer as JaxComposer
from playableenvironments_tpu.render.environment_model import EnvironmentModel as JaxEnvironmentModel
from playableenvironments_tpu.scene.encoding import SceneEncoding as JaxEncoding
from playableenvironments_tpu.train import losses as jlosses
from playableenvironments_tpu_torch.compat.from_flax import load_flax_tree
from playableenvironments_tpu_torch.core import compositing
from playableenvironments_tpu_torch.core.transforms3d import euler_translation_to_matrix, invert_rigid
from playableenvironments_tpu_torch.render import sampling
from playableenvironments_tpu_torch.render.composer import SceneComposer
from playableenvironments_tpu_torch.render.environment_model import EnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from playableenvironments_tpu_torch.train import losses
from test_torch_port_composer import Replay, recorded_draws
from test_torch_port_decoder import NO_OPT
from test_torch_port_phase3 import scene as two_player_scene
from test_torch_port_phase3 import seeded_tree
from test_torch_port_train import to_port
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

B, T, C, H, W = 2, 3, 1, 16, 24
STEP = 30
RNG_NAMES = ("params", "sampling", "alpha_noise", "divergence")


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, atol, rtol=0.0, err_msg=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=rtol, atol=atol, err_msg=err_msg)


# ---- samplers -----------------------------------------------------------------


@pytest.mark.parametrize("align_corners", [True, False])
def test_sample_at_positions_matches_jax(align_corners):
    rng = np.random.default_rng(0)
    grid = rng.normal(size=(2, 3, 5, 7, 4)).astype(np.float32)
    positions = rng.uniform(-0.2, 1.2, (2, 3, 9, 2)).astype(np.float32)
    positions[0, 0, :4] = [[0.0, 0.0], [1.0, 1.0], [0.0, 1.0], [1.0, 0.0]]
    positions[0, 1, :2] = [[-0.5, 0.5], [0.5, 1.5]]
    assert ((positions < 0) | (positions > 1)).sum() > 10  # clamped onto the edge pixels
    ref = jsampling.sample_at_positions(jnp.asarray(grid), jnp.asarray(positions), align_corners)
    got = sampling.sample_at_positions(t(grid), t(positions), align_corners)
    close(got, ref, 1e-6)
    if align_corners:  # the corners are the corner pixels themselves
        np.testing.assert_array_equal(got[0, 0, :2].numpy(), grid[0, 0][[0, -1], [0, -1]])


def sampler_inputs(seed=0):
    rng = np.random.default_rng(seed)
    directions = rng.normal(size=(2, 3, 1, 10, 14, 3)).astype(np.float32)
    flow = rng.normal(size=(2, 3, 1, 10, 14, 2)).astype(np.float32)
    boxes = rng.uniform(0.0, 0.5, (2, 3, 1, 4)).astype(np.float32)
    boxes[..., 2:] = boxes[..., :2] + 0.3
    boxes[1, 2, 0] = [0.5, 0.5, 0.5, 0.5]  # zero area: the draw covers the whole image
    return directions, flow, boxes


def test_sample_rays_at_object_matches_jax():
    directions, flow, boxes = sampler_inputs()
    key = jax.random.PRNGKey(3)
    ref = jsampling.sample_rays_at_object(key, jnp.asarray(directions), jnp.asarray(flow), 40, jnp.asarray(boxes))
    uniform = jax.random.uniform(key, (2, 3, 1, 40), dtype=jnp.float32)
    got = sampling.sample_rays_at_object(t(directions), t(flow), t(boxes), t(uniform))
    for value, reference in zip(got, ref):
        np.testing.assert_array_equal(value.numpy(), np.asarray(reference))
    rows = np.round(got[2][..., 0].numpy() * 10)
    inside = (rows >= np.floor(boxes[..., 1:2] * 10)) & (rows < np.ceil(boxes[..., 3:4] * 10))
    assert inside[0].all() and not inside[1, 2].all()


def test_sample_rays_at_keypoints_matches_jax():
    directions, _, _ = sampler_inputs(1)
    rng = np.random.default_rng(2)
    keypoints = rng.uniform(0.0, 1.0, (2, 3, 1, 17, 3)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    n = 21  # more samples than segments: the 17th onwards start the skeleton again
    ref = jsampling.sample_rays_at_keypoints(key, jnp.asarray(directions), jnp.asarray(keypoints), n)
    uniform = jax.random.uniform(key, (2, 1, 1, n, 1), dtype=jnp.float32)
    got = sampling.sample_rays_at_keypoints(t(directions), t(keypoints), t(uniform))
    for value, reference in zip(got, ref):
        close(value, reference, 1e-6)
    assert got[0].shape == (2, 3, 1, n, 3) and got[2].shape == (2, 3, 1, n)


# ---- expected positions and the losses ------------------------------------------


def test_expected_positions_match_jax_without_gradient_into_the_weights():
    rng = np.random.default_rng(5)
    positions = rng.normal(size=(2, 5, 6, 3)).astype(np.float32)
    displacements = rng.normal(size=(2, 5, 6, 3)).astype(np.float32) * 0.1
    weights = rng.uniform(0.0, 1.0, (2, 5, 6)).astype(np.float32)
    weights[1, 2] = 0.0  # a ray through empty space: eps keeps it at 0
    ref, ref_grad = jax.value_and_grad(
        lambda p, w: jnp.sum(jcompositing.expected_positions(p, jnp.asarray(displacements), w) ** 2),
        argnums=(0,))(jnp.asarray(positions), jnp.asarray(weights))
    p, w = t(positions).requires_grad_(True), t(weights).requires_grad_(True)
    got = compositing.expected_positions(p, t(displacements), w)
    close(got, jcompositing.expected_positions(jnp.asarray(positions), jnp.asarray(displacements),
                                               jnp.asarray(weights)), 1e-6)
    np.testing.assert_array_equal(got[1, 2].detach().numpy(), 0.0)
    (got ** 2).sum().backward()
    assert w.grad is None
    close(p.grad, ref_grad[0], 1e-5)
    np.testing.assert_allclose(float((got.detach() ** 2).sum()), float(ref), rtol=1e-6)


def test_consistency_losses_match_jax_at_the_gates():
    rng = np.random.default_rng(6)
    previous = rng.normal(size=(2, 3, 1, 6, 3)).astype(np.float32)
    following = rng.normal(size=(2, 3, 1, 6, 3)).astype(np.float32)
    both_valid = np.asarray([[[True], [False], [True]], [[True], [True], [False]]])
    expected = rng.normal(size=(2, 4, 1, 6, 3)).astype(np.float32)
    confidence = rng.choice(np.asarray([0.0, 0.29, 0.3, 0.31, 1.0], np.float32), (2, 4, 1, 6))
    opacity = rng.uniform(0.0, 1.0, (2, 4, 1, 6)).astype(np.float32)
    threshold = 0.3
    pairs = [
        (losses.pose_consistency_loss(t(previous), t(following), t(both_valid)),
         jlosses.pose_consistency_loss(previous, following, both_valid)),
        (losses.keypoint_consistency_loss(t(expected), t(confidence), threshold),
         jlosses.keypoint_consistency_loss(expected, confidence, threshold)),
        (losses.keypoint_opacity_loss(t(opacity), t(confidence), threshold),
         jlosses.keypoint_opacity_loss(opacity, confidence, threshold)),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    # On the threshold: a pair counts for the consistency (>=), not for the
    # opacity (>).
    on = np.full((1, 2, 1, 1), threshold, np.float32)
    points = np.asarray([[[[[0.0, 0.0, 0.0]]], [[[1.0, 0.0, 0.0]]]]], np.float32)
    assert float(losses.keypoint_consistency_loss(t(points), t(on), threshold)) > 0
    assert float(losses.keypoint_opacity_loss(torch.zeros(1, 2, 1, 1), t(on), threshold)) == 0.0
    assert float(jlosses.keypoint_consistency_loss(points, on, threshold)) > 0


# ---- the composer's expected positions ---------------------------------------------


def composer_args():
    """Rays from a camera 6 m in front of the players through both, three
    objects (background, two players); the second player sits at x = 0.3."""
    rng = np.random.default_rng(7)
    origins = np.tile(np.asarray([0.0, -6.0, 1.0], np.float32), (2, 1))
    directions = np.stack([rng.uniform(-0.1, 0.1, (2, 8)), np.ones((2, 8)), rng.uniform(-0.3, 0.05, (2, 8))],
                          axis=-1).astype(np.float32)
    normals = np.tile(np.asarray([0.0, 1.0, 0.0], np.float32), (2, 1))
    w2o = np.tile(np.eye(4, dtype=np.float32), (2, 3, 1, 1))
    w2o[:, 2, 0, 3] = -0.3
    style = rng.normal(size=(2, 3, 8)).astype(np.float32)
    deformation = rng.normal(size=(2, 3, 4)).astype(np.float32)
    in_scene = np.ones((2, 3), bool)
    in_scene[1, 2] = False
    return origins, directions, normals, w2o, style, deformation, in_scene


@functools.lru_cache(maxsize=None)
def composer_variables():
    module = JaxComposer(two_player_scene())
    rngs = {name: jax.random.PRNGKey(i) for i, name in enumerate(RNG_NAMES)}
    shapes = jax.eval_shape(lambda: module.init(rngs, *[jnp.asarray(a) for a in composer_args()]))
    return {kind: seeded_tree(shapes[kind], np.random.default_rng(8)) for kind in shapes}


def port_composer(variables, stats=None):
    composer = SceneComposer(to_port(two_player_scene()), device="cpu")
    load_flax_tree(composer, variables["params"], variables["batch_stats"] if stats is None else stats)
    return composer.train()


@pytest.mark.parametrize("perturb", [False, True])
def test_forward_expected_positions_matches_jax(perturb):
    origins, directions, normals, w2o, style, deformation, in_scene = composer_args()
    object_idx = 2
    args = [jnp.asarray(a) for a in (origins, directions, normals, w2o[:, object_idx], style[:, object_idx],
                                     deformation[:, object_idx], in_scene[:, object_idx])]
    variables = composer_variables()
    module = JaxComposer(two_player_scene())
    rngs = {name: jax.random.PRNGKey(i) for i, name in enumerate(RNG_NAMES)}
    names = []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def run(variables):
        with recorded_draws(("uniform", "normal")) as draws:
            out = module.apply(variables, object_idx, *args, perturb=perturb, step=jnp.asarray(STEP),
                               method=JaxComposer.forward_expected_positions, rngs=rngs, mutable=["batch_stats"])
        names[:] = [n for n, _ in draws]
        return out, [v for _, v in draws]

    (ref, mutated), values = jax.device_get(run(variables))
    draws = [(n, np.asarray(v)) for n, v in zip(names, values)]
    ported = [t(a) for a in (origins, directions, normals, w2o[:, object_idx], deformation[:, object_idx],
                             in_scene[:, object_idx])]
    composer = port_composer(variables)
    before = {k: v.clone() for k, v in composer.state_dict().items()}
    replay = Replay(draws)
    got = composer.forward_expected_positions(object_idx, *ported, perturb=perturb, rng=replay, step=STEP)
    assert not replay.draws and replay.streams == (["sampling", "alpha_noise"] if perturb else [])
    for value, reference in zip(got["coarse"], ref["coarse"]):
        close(value, reference, 1e-5)
    for name, value in composer.state_dict().items():
        assert torch.equal(value, before[name]), name
    # JAX's call would have moved the player's AdaIN statistics (it runs on
    # batch statistics); the port's leaves them, as the trainer discards them.
    moved = port_composer(variables, mutated["batch_stats"]).state_dict()
    assert any(not torch.equal(moved[name], before[name]) for name in before)
    opacity = got["coarse"][1].detach()
    assert float(opacity[0].max()) > 0.1 and float(opacity[1].abs().max()) == 0.0  # absent in row 1


# ---- the environment model's passes -----------------------------------------------


def encoding_arrays():
    """Two players 1.5 m either side of the origin, seen from the camera of
    tests/test_torch_port_train.py's batch; player 2 leaves in frame 2 of
    sequence 1."""
    rng = np.random.default_rng(9)
    rotations = np.zeros((B, T, C, 3), np.float32)
    rotations[..., 0] = -0.6
    translations = np.zeros((B, T, C, 3), np.float32)
    translations[..., 1], translations[..., 2] = 8.0, 10.0
    object_translations = np.zeros((B, T, 3, 3), np.float32)
    object_translations[..., 1, 0], object_translations[..., 2, 0] = -1.5, 1.5
    object_translations[..., 1:, :2] += rng.normal(size=(B, T, 2, 2)).astype(np.float32) * 0.1
    object_rotations = np.zeros((B, T, 3, 3), np.float32)
    object_rotations[..., 1:, 2] = rng.normal(size=(B, T, 2)).astype(np.float32) * 0.3
    in_scene = np.ones((B, T, 3), bool)
    in_scene[1, 2, 2] = False
    return dict(
        camera_rotations=rotations, camera_translations=translations, focals=np.full((B, T, C), 30.0, np.float32),
        object_rotations=object_rotations, object_translations=object_translations,
        object_style=rng.normal(size=(B, T, 3, 8)).astype(np.float32),
        object_deformation=rng.normal(size=(B, T, 3, 4)).astype(np.float32), object_in_scene=in_scene,
    )


def player_boxes(arrays):
    """The players' projected boxes (B, T, C, 2, 4), from the port's own
    projection."""
    model = EnvironmentModel(to_port(two_player_scene()), device="cpu")
    o2w = euler_translation_to_matrix(t(arrays["object_rotations"]), t(arrays["object_translations"]))
    w2c = invert_rigid(euler_translation_to_matrix(t(arrays["camera_rotations"]), t(arrays["camera_translations"])))
    boxes, _ = model.compute_object_bounding_boxes(o2w, w2c, t(arrays["focals"]), H, W)
    return boxes[..., 1:, :].numpy()


def pass_inputs():
    arrays = encoding_arrays()
    rng = np.random.default_rng(10)
    boxes = player_boxes(arrays)
    assert float((boxes[..., 2] - boxes[..., 0]).min()) > 0.05
    validity = arrays["object_in_scene"][:, :, None, 1:].copy()
    flow = (np.asarray([0.03, -0.02], np.float32) + rng.normal(size=(B, T, C, H, W, 2)) * 0.01).astype(np.float32)
    fractions = rng.uniform(0.1, 0.9, (B, T, C, 17, 2, 2)).astype(np.float32)
    rows = boxes[..., None, :, 1] + (boxes[..., None, :, 3] - boxes[..., None, :, 1]) * fractions[..., 0, :]
    cols = boxes[..., None, :, 0] + (boxes[..., None, :, 2] - boxes[..., None, :, 0]) * fractions[..., 1, :]
    confidence = rng.choice(np.asarray([0.1, 0.3, 0.9], np.float32), (B, T, C, 17, 2))
    keypoints = np.stack([rows, cols, confidence], axis=-2).astype(np.float32)  # (B, T, C, 17, 3, 2)
    keypoints_validity = validity.copy()
    keypoints_validity[0, 1, 0, 0] = False
    return arrays, flow, boxes, validity, keypoints, keypoints_validity


def run_pass(method, jax_args, port_args, samples):
    """The pass in JAX (jitted, its draws recorded) and in the port (the
    draws replayed): (JAX's outputs, the port's, the port's streams, the
    port's state before and after)."""
    arrays = pass_inputs()[0]
    composer = composer_variables()
    variables = {kind: {"composer": composer[kind]} for kind in composer}
    model = JaxEnvironmentModel(two_player_scene())
    rngs = {name: jax.random.PRNGKey(i) for i, name in enumerate(RNG_NAMES)}
    encoding = JaxEncoding(**{k: jnp.asarray(v) for k, v in arrays.items()})
    names = []

    @functools.partial(jax.jit, compiler_options=NO_OPT)
    def run(variables):
        with recorded_draws(("uniform", "normal")) as draws:
            out, _ = model.apply(variables, encoding, *[jnp.asarray(a) if isinstance(a, np.ndarray) else a
                                                          for a in jax_args], samples, perturb=True,
                                 step=jnp.asarray(STEP), train=True, method=getattr(JaxEnvironmentModel, method),
                                 rngs=rngs, mutable=["batch_stats"])
        names[:] = [n for n, _ in draws]
        return out, [v for _, v in draws]

    ref, values = jax.device_get(run(variables))
    port = EnvironmentModel(to_port(two_player_scene()), device="cpu")
    load_flax_tree(port.composer, composer["params"], composer["batch_stats"])
    port.train()
    before = {k: v.clone() for k, v in port.state_dict().items()}
    replay = Replay([(n, np.asarray(v)) for n, v in zip(names, values)])
    got = getattr(port, method)(SceneEncoding(**{k: t(v) for k, v in arrays.items()}), *port_args, samples,
                                perturb=True, rng=replay, step=STEP)
    assert not replay.draws
    return ref, got, replay.streams, before, port.state_dict()


def test_forward_pose_consistency_matches_jax():
    _, flow, boxes, validity, _, _ = pass_inputs()
    inputs = (flow, boxes, validity)
    ref, got, streams, before, after = run_pass("forward_pose_consistency", inputs, [t(a) for a in inputs], 6)
    # Per player: the box draw, then each frame's strata and alpha noise.
    assert streams == ["sampling", "sampling", "alpha_noise", "sampling", "alpha_noise"] * 2
    assert sorted(got["coarse"]) == ["dynamic_object_0", "dynamic_object_1"]
    for name, (previous, following, pair_valid) in got["coarse"].items():
        jprevious, jfollowing, jpair_valid = ref["coarse"][name]
        assert previous.shape == (B, T - 1, C, 6, 3)
        close(previous, jprevious, 1e-4, err_msg=name)
        close(following, jfollowing, 1e-4, err_msg=name)
        np.testing.assert_array_equal(pair_valid.numpy(), np.asarray(jpair_valid))
        assert float(previous.detach().abs().max()) > 0.1  # the rays hit the player
    assert not bool(got["coarse"]["dynamic_object_1"][2][1, 1])  # player 2 gone in frame 2
    for name, value in after.items():
        assert torch.equal(value, before[name]), name


def test_forward_keypoint_consistency_matches_jax():
    _, _, _, _, keypoints, keypoints_validity = pass_inputs()
    inputs = (keypoints, keypoints_validity)
    ref, got, streams, before, after = run_pass("forward_keypoint_consistency", inputs + ((H, W),),
                                                [t(a) for a in inputs] + [(H, W)], 20)
    # Per player: the fractions, then the strata and alpha noise.
    assert streams == ["sampling", "sampling", "alpha_noise"] * 2
    for name, outputs in got["coarse"].items():
        for value, reference, label in zip(outputs, ref["coarse"][name], ("expected", "confidence", "opacity",
                                                                          "positions")):
            close(value, reference, 1e-4 if label == "expected" else 1e-5, err_msg=f"{name} {label}")
        expected, confidence, opacity, _ = outputs
        assert expected.shape == (B, T, C, 20, 3)
        assert float(opacity.detach().max()) > 0.1
    assert float(got["coarse"]["dynamic_object_0"][1][0, 1].abs().max()) == 0.0  # invalid: confidence 0
    for name, value in after.items():
        assert torch.equal(value, before[name]), name
