"""The phase-3 evaluator's action videos and re-enactment, the port against
the JAX package on the CPU, on test_torch_port_playable_evaluator.py's tiny
tennis scene and weights (its `setup`; a file of its own so that the JAX
renderer's compile lands on another worker): every action's video (3
frames, the action clamped to each player's count) within 1e-2 of JAX's
(test_torch_port_play.py's frame bound), and the re-enactment (eval mode,
zero variations) within 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np

from test_torch_port_playable_evaluator import (  # noqa: F401  (setup: a fixture)
    FRAMES, evaluators, jitted_encode_batch, setup,
)
from test_torch_port_play import IMAGE
from torch_port_scenes import roots  # noqa: F401  (setup's fixture)
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)


def test_action_videos_and_reenactment_match_jax(setup, tmp_path):
    _, jtrain, state, trainer, (jdataset, dataset) = setup
    jeval, evaluator = evaluators(setup, tmp_path)
    jbatch = next(jdataset.iterate_batches(1, shuffle=False, drop_last=False))
    batch = next(dataset.iterate_batches(1, shuffle=False, drop_last=False))
    renderer = jeval._renderer(state, IMAGE)
    jenc = jitted_encode_batch(jtrain)(state.extra, jbatch, jax.random.PRNGKey(0))
    port_renderer = evaluator._renderer(IMAGE)
    encoding = trainer.encode_batch(batch)
    moved = 0.0
    for action_idx in range(3):
        ref = jeval.generate_action_video(state, jenc, action_idx, renderer)
        got = evaluator.generate_action_video(encoding, action_idx, port_renderer)
        assert got.shape == (FRAMES,) + IMAGE + (3,) and np.isfinite(got).all()
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2, err_msg=f"action {action_idx}")
        moved = max(moved, float(np.abs(ref[-1] - ref[0]).max()))
    assert moved > 1e-3
    ref = np.asarray(renderer.render(_jax_reenacted(jeval, state, jenc)))[0, :, 0]
    got = port_renderer.render(evaluator.reenacted_encoding(encoding))[0, :, 0].numpy()
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-2)


def _jax_reenacted(jeval, state, encoding):
    """The re-enacted encoding of JAX's reenact_sequence, before its render."""
    captured = {}

    class Capture:
        def render(self, enc):
            captured["encoding"] = enc
            return jnp.zeros((1, 1, 1) + IMAGE + (3,))

    jeval.reenact_sequence(state, encoding, Capture())
    return captured["encoding"]
