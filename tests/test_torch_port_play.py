"""The PyTorch port's play loop against the JAX package: the dynamics network
and interactive_step (carries threaded, 1e-5) and the whole slice, a tiny
tennis-shaped scene (2 static + 2 bent objects) stepped through
InteractiveSession and compared frame by frame with JAX interactive_step +
render_frame_fast(interpret=True) (atol 1e-2). Weights are made by the JAX
package, perturbed with seeded numpy and carried over by compat/from_flax.

The tiny scene and its weights are shared with test_torch_port_render.py and
test_torch_port_nerf.py."""

import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import torch
import yaml

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.models.autoencoder import MultiresAutoencoder as JaxAutoencoder
from playableenvironments_tpu.render import fast as jax_fast
from playableenvironments_tpu.render import interactive as jax_interactive
from playableenvironments_tpu.render.composer import SceneComposer as JaxComposer
from playableenvironments_tpu.render.playable_model import PlayableEnvironmentModel as JaxPlayable
from playableenvironments_tpu.scene.encoding import SceneEncoding as JaxEncoding
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.cli.play import InteractiveSession
from playableenvironments_tpu_torch.compat import from_flax
from playableenvironments_tpu_torch.models.autoencoder import MultiresAutoencoder
from playableenvironments_tpu_torch.render import interactive
from playableenvironments_tpu_torch.render.composer import SceneComposer
from playableenvironments_tpu_torch.render.playable_model import PlayableEnvironmentModel
from playableenvironments_tpu_torch.scene.encoding import SceneEncoding
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

REPO = pathlib.Path(__file__).resolve().parent.parent
IMAGE = (16, 24)
STRIDES = (2, 4)
FOCAL_MULTIPLIER = 0.125
ACTIONS = [[1, 2], [0, 1]]


def tiny_tennis_dict():
    """configs/tennis.yaml with its widths cut: NeRF 3x32 (skip 2, 3 octaves,
    24 outputs), bender 2x16, style 8, deformation 4, AE bottleneck 16 at
    strides (2, 4) with one block, dynamics 16 wide, 3 actions."""
    d = yaml.safe_load((REPO / "configs" / "tennis.yaml").read_text())
    model = d["model"]
    model["autoencoder"].update(bottleneck_features=16, bottleneck_blocks=1, downsampling_layers_count=[1, 1])
    for block in model["object_models"]:
        block.update(style_features=8, deformation_features=4)
        block["nerf_model"].update(
            layers_width=32, backbone_layers_count=3, skip_layer_idx=2, output_features=24,
            position_encoder={"octaves": 3, "append_original": True},
        )
        if "positional" in block["ray_bender_model"]["architecture"]:
            block["ray_bender_model"].update(
                layers_width=16, layers_count=2, skip_layer_idx=1,
                position_encoder={"octaves": 2, "append_original": True, "num_steps": 100},
            )
    for block in d["playable_model"]["object_animation_models"]:
        block.update(style_features=8, deformation_features=4, actions_count=3, action_space_dimension=2)
        block["dynamics_network"]["output_features"] = 16
    return d


def scenes():
    d = tiny_tennis_dict()
    return (
        jax_config.scene_from_dict(d["model"], d["playable_model"]),
        port_config.scene_from_dict(d["model"], d["playable_model"]),
    )


def encoding_arrays(seed=0, objects=4, style=8, deformation=4):
    """A frame-0 scene state in numpy: the interactive benchmark's camera
    moved in so that the players cover many rays of a 16x24 frame."""
    rng = np.random.default_rng(seed)
    translations = np.zeros((1, 1, objects, 3), np.float32)
    translations[:, :, 2] = [-1.0, -16.0, 0.0]
    translations[:, :, 3] = [1.2, -19.0, 0.0]
    return dict(
        camera_rotations=np.asarray([[[[1.35, 0.0, 0.0]]]], np.float32),
        camera_translations=np.asarray([[[[0.0, -26.0, 1.6]]]], np.float32),
        focals=np.full((1, 1, 1), 300.0, np.float32),
        object_rotations=rng.uniform(-0.3, 0.3, (1, 1, objects, 3)).astype(np.float32),
        object_translations=translations,
        object_style=rng.normal(size=(1, 1, objects, style)).astype(np.float32),
        object_deformation=rng.normal(size=(1, 1, objects, deformation)).astype(np.float32),
        object_in_scene=np.ones((1, 1, objects), bool),
    )


def _perturbed(tree, rng, path=()):
    """Seeded non-trivial values for what flax initializes to constants:
    BN/AdaIN running statistics, BN scale/bias, the bender's near-zero
    output head and the LSTM's zero initial state."""
    out = {}
    for name, value in tree.items():
        if hasattr(value, "items"):
            out[name] = _perturbed(value, rng, path + (name,))
            continue
        value = np.array(value, np.float32)
        in_bn = any("bn" in p for p in path)
        if name == "mean" or (in_bn and name == "bias"):
            value = value + rng.normal(size=value.shape).astype(np.float32) * 0.2
        elif name == "var":
            value = rng.uniform(0.5, 1.5, value.shape).astype(np.float32)
        elif in_bn and name == "scale":
            value = rng.uniform(0.7, 1.3, value.shape).astype(np.float32)
        elif "output_head" in path or name.startswith("initial_"):
            value = rng.normal(size=value.shape).astype(np.float32) * 0.3
        out[name] = value
    return out


@functools.lru_cache(maxsize=None)
def jax_variables():
    """(environment variables, playable variables) of the tiny scene as
    nested dicts of numpy arrays."""
    jscene, _ = scenes()
    key = jax.random.PRNGKey(0)
    n = 4
    enc = encoding_arrays()
    composer_vars = jax.jit(JaxComposer(jscene).init)(
        key, jnp.zeros((1, 1, 1, 3)), jax.random.normal(key, (1, 1, 1, 16, 3)),
        jnp.zeros((1, 1, 1, 3)).at[..., 2].set(-1.0),
        jnp.broadcast_to(jnp.eye(4), (1, 1, 1, n, 4, 4)),
        jnp.asarray(enc["object_style"])[:, :, None],
        jnp.asarray(enc["object_deformation"])[:, :, None],
        jnp.asarray(enc["object_in_scene"])[:, :, None],
    )
    ae = JaxAutoencoder(jscene.autoencoder)
    levels = [jnp.zeros((1, IMAGE[0] // 2, IMAGE[1] // 2, 8)), jnp.zeros((1, IMAGE[0] // 4, IMAGE[1] // 4, 16))]
    ae_vars = jax.jit(lambda k: ae.init(k, levels, False, method=JaxAutoencoder.decode))(key)
    rng = np.random.default_rng(1)
    env = _perturbed({
        "params": {"composer": composer_vars["params"], "autoencoder": ae_vars["params"]},
        "batch_stats": {"composer": composer_vars["batch_stats"], "autoencoder": ae_vars["batch_stats"]},
    }, rng)

    playable = JaxPlayable(jscene)
    one_hots, variations = jax_interactive.action_inputs(playable, ACTIONS[0])

    def init_both(module):
        for dyn in range(2):
            module.dynamics_step(
                dyn, None, jnp.asarray(enc["object_rotations"][:, 0, 2 + dyn]),
                jnp.asarray(enc["object_translations"][:, 0, 2 + dyn]),
                jnp.asarray(enc["object_style"][:, 0, 2 + dyn]),
                jnp.asarray(enc["object_deformation"][:, 0, 2 + dyn]),
                one_hots[dyn], variations[dyn],
            )
        return 0

    play = jax.jit(lambda k: playable.init(k, method=init_both))(jax.random.PRNGKey(2))
    play = _perturbed(dict(play), rng)
    return env, play


def port_modules():
    """SceneComposer, MultiresAutoencoder and PlayableEnvironmentModel on
    the CPU holding the JAX weights."""
    _, pscene = scenes()
    env, play = jax_variables()
    composer = SceneComposer(pscene, device="cpu")
    autoencoder = MultiresAutoencoder(pscene.autoencoder, device="cpu")
    from_flax.load_environment(composer, autoencoder, env)
    playable = PlayableEnvironmentModel(pscene, device="cpu")
    from_flax.load_playable(playable, play)
    return composer, autoencoder, playable


def jax_encoding(arrays):
    return JaxEncoding(**{k: jnp.asarray(v) for k, v in arrays.items()})


def port_encoding(arrays):
    return SceneEncoding(**{k: torch.from_numpy(np.array(v)) for k, v in arrays.items()})


def test_dynamics_steps_match_with_carries_threaded():
    """Two interactive steps (carries threaded from the learnable initial
    state) through the port's interactive_step and the JAX one, 1e-5."""
    jscene, pscene = scenes()
    _, play = jax_variables()
    _, _, playable = port_modules()
    jplayable = JaxPlayable(jscene)
    arrays = encoding_arrays()
    jenc, penc = jax_encoding(arrays), port_encoding(arrays)
    jcarries, pcarries = [None, None], [None, None]
    for actions in ACTIONS:
        jone, jvar = jax_interactive.action_inputs(jplayable, actions)
        pone, pvar = interactive.action_inputs(playable, actions)
        for j, p in zip(jone + jvar, pone + pvar):
            np.testing.assert_array_equal(p.numpy(), np.asarray(j))
        jenc, jcarries = jax_interactive.interactive_step(
            jplayable, play, jenc, jnp.asarray(arrays["object_style"]), jcarries, jone, jvar,
        )
        penc, pcarries = interactive.interactive_step(
            playable, penc, torch.from_numpy(arrays["object_style"]), pcarries, pone, pvar,
        )
        for field in ("object_rotations", "object_translations", "object_style", "object_deformation"):
            np.testing.assert_allclose(
                getattr(penc, field).numpy(), np.asarray(getattr(jenc, field)), atol=1e-5, rtol=1e-5,
                err_msg=field,
            )
        for jc, pc in zip(jcarries, pcarries):
            for (jc_c, jc_h), (pc_c, pc_h) in zip(jc, pc):
                np.testing.assert_allclose(pc_c.numpy(), np.asarray(jc_c), atol=1e-5, rtol=1e-5)
                np.testing.assert_allclose(pc_h.numpy(), np.asarray(jc_h), atol=1e-5, rtol=1e-5)


def test_use_initial_style_false_takes_the_dynamics_style():
    jscene, _ = scenes()
    _, play = jax_variables()
    _, _, playable = port_modules()
    arrays = encoding_arrays()
    jone, jvar = jax_interactive.action_inputs(JaxPlayable(jscene), ACTIONS[0])
    jenc, _ = jax_interactive.interactive_step(
        JaxPlayable(jscene), play, jax_encoding(arrays), None, [None, None], jone, jvar,
        use_initial_style=False,
    )
    pone, pvar = interactive.action_inputs(playable, ACTIONS[0])
    penc, _ = interactive.interactive_step(
        playable, port_encoding(arrays), None, [None, None], pone, pvar, use_initial_style=False,
    )
    np.testing.assert_allclose(penc.object_style.numpy(), np.asarray(jenc.object_style), atol=1e-5, rtol=1e-5)
    assert not np.allclose(penc.object_style.numpy(), arrays["object_style"])


def test_lstm_cell_layout_is_flax_optimized_lstm():
    """No input-projection bias, hidden projections with one, carry (c, h):
    a carry whose c and h differ gives the flax cell's result only in that
    order."""
    import flax.linen as fnn

    from playableenvironments_tpu_torch.models.dynamics import OptimizedLSTMCell

    rng = np.random.default_rng(3)
    cell = OptimizedLSTMCell(5, 4)
    for gate in "ifgo":
        assert getattr(cell, f"i{gate}").bias is None
        assert getattr(cell, f"h{gate}").bias is not None
    x = rng.normal(size=(2, 5)).astype(np.float32)
    c, h = rng.normal(size=(2, 2, 4)).astype(np.float32)
    jcell = fnn.OptimizedLSTMCell(4)
    variables = jcell.init(jax.random.PRNGKey(0), (jnp.asarray(c), jnp.asarray(h)), jnp.asarray(x))
    variables = _perturbed(dict(variables), rng)
    for gate in "ifgo":
        variables["params"][f"h{gate}"]["bias"] = rng.normal(size=4).astype(np.float32)
    from_flax.load_flax_tree(cell, variables["params"])
    (jc, jh), _ = jcell.apply(variables, (jnp.asarray(c), jnp.asarray(h)), jnp.asarray(x))
    (pc, ph), _ = cell((torch.from_numpy(c), torch.from_numpy(h)), torch.from_numpy(x))
    np.testing.assert_allclose(pc.detach().numpy(), np.asarray(jc), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(ph.detach().numpy(), np.asarray(jh), atol=1e-5, rtol=1e-5)
    (sc, _), _ = cell((torch.from_numpy(h), torch.from_numpy(c)), torch.from_numpy(x))
    assert not np.allclose(sc.detach().numpy(), np.asarray(jc), atol=1e-3)


def test_whole_slice_frames_match_jax():
    """The tiny tennis scene through the port's InteractiveSession and
    through JAX interactive_step + render_frame_fast(interpret=True): frame
    0 and two scripted steps, atol 1e-2."""
    jscene, pscene = scenes()
    env, play = jax_variables()
    composer, autoencoder, playable = port_modules()
    session = InteractiveSession(
        pscene, composer, autoencoder, playable, IMAGE, STRIDES, FOCAL_MULTIPLIER,
    )
    arrays = encoding_arrays()
    jplayable = JaxPlayable(jscene)
    jenc = jax_encoding(arrays)
    initial_style = jenc.object_style
    carries = [None, None]

    render = jax.jit(functools.partial(
        jax_fast.render_frame_fast, jscene, image_size=IMAGE, patch_strides=STRIDES,
        focal_length_multiplier=FOCAL_MULTIPLIER, interpret=True,
    ))

    def jax_frame(enc):
        return np.asarray(render(env, enc))[0, 0, 0]

    frames = [(session.start(port_encoding(arrays)), jax_frame(jenc))]
    for actions in ACTIONS:
        one, var = jax_interactive.action_inputs(jplayable, actions)
        jenc, carries = jax_interactive.interactive_step(
            jplayable, play, jenc, initial_style, carries, one, var,
        )
        frames.append((session.step(actions), jax_frame(jenc)))
    for port, ref in frames:
        assert port.shape == IMAGE + (3,) and np.isfinite(port).all()
        np.testing.assert_allclose(port, ref, atol=1e-2, rtol=0)
    # The frames move with the players, so the comparison is not vacuous.
    assert np.abs(frames[2][1] - frames[0][1]).max() > 1e-3
