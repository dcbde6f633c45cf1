"""The port's fused dynamics rollout (ops/fused_rollout.py) against the JAX
package on the CPU, at the sizes of tests/test_fused_rollout.py (BS 3, T 6,
F 16, S 8, D 4, A 4, V 3, 2 layers), in the three branch combinations of
that file (rotation axis, rotations forced to zero or not, the axis
translation forced or free):
- `plain_rollout_fwd` against `_forward_core`: outputs and every residual;
- `plain_rollout_bwd` against the hand-derived `_backward_core` on the same
  residuals and cotangents, and against torch.autograd of
  `plain_rollout_fwd`;
- one case against the Pallas kernels `fused_rollout_pallas.forward` and
  `backward` in interpret mode;
- the torch.autograd.Function `fused_rollout` against both.
Tolerances are the JAX package's own for this op: 2e-5 for values,
5e-4 + 1e-3 |ref| for gradients (f32 sums in another order through T-1
steps of two LSTM layers).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.ops import fused_rollout as jfr
from playableenvironments_tpu.ops import fused_rollout_pallas
from playableenvironments_tpu_torch.compat.from_flax import load_flax_tree
from playableenvironments_tpu_torch.models.dynamics import DynamicsNetwork
from playableenvironments_tpu_torch.ops import fused_rollout as fr
from test_fused_rollout import BOX, BS, A, D, S, T, V, make_cfg
from test_torch_port_train import to_port
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

# The JAX references are compiled once each; XLA's CPU backend optimization
# only slows their compile down here.
FAST_COMPILE = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
VALUES = dict(rtol=0, atol=2e-5)
GRADS = dict(rtol=1e-3, atol=5e-4)
# (force_rotations_zero, force_axis_translation, rotation_axis, gt_count):
# test_fused_rollout.py's three branch combinations.
CASES = [(True, True, 2, 3), (False, False, 1, 1), (False, True, 0, 0)]


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, ref, tol, name=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), **tol, err_msg=name)


def port_params(packed) -> fr.PackedParams:
    return fr.PackedParams(*(tuple(t(v) for v in field) if isinstance(field, tuple) else t(field)
                             for field in packed))


def jax_setup(force_rot, force_z, axis, seed):
    """test_fused_rollout.py's `setup` (the same draws from the same keys),
    jitted: (variables, RolloutConfig, packed parameters, inputs)."""
    from playableenvironments_tpu.models.dynamics import DynamicsNetwork as JaxDynamics

    dyn = JaxDynamics(make_cfg(force_rot, force_z, axis), BOX,
                      force_rotation_axis_translation=0.01 if force_z else None)

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def build(key):
        keys = jax.random.split(key, 8)
        rot = jax.random.normal(keys[0], (BS, T, 3)) * 0.3
        trans = jax.random.normal(keys[1], (BS, T, 3))
        style = jax.random.normal(keys[2], (BS, T, S))
        deform = jax.random.normal(keys[3], (BS, T, D))
        actions = jax.nn.one_hot(jax.random.randint(keys[4], (BS, T - 1), 0, A), A)
        variations = jax.random.normal(keys[5], (BS, T - 1, V)) * 0.1
        variables = dyn.init(keys[6], None, rot[:, 0], trans[:, 0], style[:, 0], deform[:, 0], actions[:, 0],
                             variations[:, 0])
        return variables, jfr.pack_dynamics_params(variables["params"]), (rot, trans, style, deform, actions,
                                                                          variations)

    variables, packed, inputs = build(jax.random.PRNGKey(seed))
    cfg = jfr.RolloutConfig(rotation_axis=axis, force_rotations_zero=force_rot,
                            force_axis_translation=0.01 if force_z else None,
                            box_size=tuple(hi - lo for lo, hi in BOX))
    return variables, cfg, packed, inputs


@functools.lru_cache(maxsize=None)
def case(force_rot, force_z, axis, gt_count, seed=0):
    """JAX setup, the core's forward with residuals, seeded cotangents and
    the core's backward on them, all numpy."""
    variables, cfg, packed, inputs = jax_setup(force_rot, force_z, axis, seed)
    rng = np.random.default_rng(seed)
    cots = tuple(rng.normal(size=(BS, T, w)).astype(np.float32) for w in (3, 3, S, D))

    @functools.partial(jax.jit, static_argnums=(0,), compiler_options=FAST_COMPILE)
    def run(cfg, packed, inputs, gt, cots):
        out, res = jfr._forward_core(cfg, packed, *inputs, gt, collect_residuals=True)
        grads = jfr._backward_core(cfg, packed, *inputs, gt, res, cots)
        return out, res, grads

    out, res, grads = jax.device_get(run(cfg, packed, inputs, jnp.asarray(gt_count), cots))
    return (jax.device_get(variables), cfg, jax.device_get(packed), jax.device_get(inputs), cots, out, res,
            grads)


def port_cfg(cfg):
    return fr.RolloutConfig(cfg.rotation_axis, cfg.force_rotations_zero, cfg.force_axis_translation, cfg.box_size)


def check_grads(got, ref, tol=GRADS):
    """got: port (PackedParams, 6 input gradients); ref: JAX's."""
    g_params, ref_params = got[0], ref[0]
    for name, g, r in zip(fr.PackedParams._fields, g_params, ref_params):
        for k, (gg, rr) in enumerate(zip(g, r) if isinstance(g, tuple) else [(g, r)]):
            close(gg, rr, tol, f"{name}[{k}]")
    for name, g, r in zip(("rot", "trans", "style", "deform", "actions", "variations"), got[1:], ref[1:]):
        close(g, r, tol, name)


@pytest.mark.parametrize("force_rot,force_z,axis,gt_count", CASES)
def test_plain_forward_matches_jax_core(force_rot, force_z, axis, gt_count):
    variables, cfg, packed, inputs, _, out, res, _ = case(force_rot, force_z, axis, gt_count)
    # The port's DynamicsNetwork holding the same weights packs to the same tensors.
    dyn = DynamicsNetwork(to_port(make_cfg(force_rot, force_z, axis)), BOX, device="cpu")
    load_flax_tree(dyn, variables["params"])
    packed_port = fr.pack_dynamics_params(dyn)
    for name, g, r in zip(fr.PackedParams._fields, packed_port, port_params(packed)):
        for gg, rr in (zip(g, r) if isinstance(g, tuple) else [(g, r)]):
            assert torch.equal(gg.detach(), rr), name
    got, got_res = fr.plain_rollout_fwd(port_cfg(cfg), packed_port, *(t(x) for x in inputs), gt_count, True)
    for name, g, r in zip(("rot", "trans", "style", "deform"), got, out):
        close(g, r, VALUES, name)
    assert set(got_res) == set(res)
    for name in res:
        close(got_res[name], res[name], VALUES, name)


@pytest.mark.parametrize("force_rot,force_z,axis,gt_count", CASES)
def test_plain_backward_matches_jax_core(force_rot, force_z, axis, gt_count):
    _, cfg, packed, inputs, cots, _, res, grads = case(force_rot, force_z, axis, gt_count)
    got = fr.plain_rollout_bwd(port_cfg(cfg), port_params(packed), gt_count, {k: t(v) for k, v in res.items()},
                               [t(c) for c in cots], inputs[4].shape[-1])
    check_grads(got, grads)


def autograd_grads(cfg, params, inputs, gt_count, cots, fn):
    leaves = [x.clone().requires_grad_() for x in fr.param_list(params) + list(inputs)]
    p = fr.params_from_list(leaves[:len(fr.param_list(params))], len(params.wx))
    out = fn(cfg, p, *leaves[len(fr.param_list(params)):], gt_count)
    torch.autograd.backward(list(out), list(cots))
    grads = [leaf.grad for leaf in leaves]
    n = len(fr.param_list(params))
    return (fr.params_from_list(grads[:n], len(params.wx)),) + tuple(grads[n:])


@pytest.mark.parametrize("force_rot,force_z,axis,gt_count", CASES)
def test_plain_backward_and_the_autograd_function_match_autograd(force_rot, force_z, axis, gt_count):
    _, cfg, packed, inputs, cots, _, _, grads = case(force_rot, force_z, axis, gt_count)
    cfg, params = port_cfg(cfg), port_params(packed)
    inputs, cots = [t(x) for x in inputs], [t(c) for c in cots]
    auto = autograd_grads(cfg, params, inputs, gt_count, cots,
                          lambda c, p, *a: fr.plain_rollout_fwd(c, p, *a[:-1], a[-1], False)[0])
    _, res = fr.plain_rollout_fwd(cfg, params, *inputs, gt_count, True)
    plain = fr.plain_rollout_bwd(cfg, params, gt_count, res, cots, inputs[4].shape[-1])
    before = (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches)
    function = autograd_grads(cfg, params, inputs, gt_count, cots, fr.fused_rollout)
    assert (fr.fused_rollout_fwd.launches, fr.fused_rollout_bwd.launches) == before  # no kernel on the CPU
    check_grads(plain, [auto[0]] + [a.numpy() for a in auto[1:]])
    check_grads(function, [plain[0]] + [a.numpy() for a in plain[1:]], dict(rtol=0, atol=0))
    check_grads(function, grads)
    with torch.no_grad():
        out = fr.fused_rollout(cfg, params, *inputs, gt_count)
    for g, r in zip(out, fr.plain_rollout_fwd(cfg, params, *inputs, gt_count, False)[0]):
        assert torch.equal(g, r)


def test_plain_versions_match_the_pallas_kernels_in_interpret_mode():
    force_rot, force_z, axis, gt_count = CASES[1]
    _, cfg, packed, inputs, cots, _, res, _ = case(force_rot, force_z, axis, gt_count, seed=5)

    @functools.partial(jax.jit, static_argnums=(0,), compiler_options=FAST_COMPILE)
    def run(cfg, packed, inputs, gt, cots):
        out, res = fused_rollout_pallas.forward(cfg, packed, *inputs, gt, True)
        return out, res, fused_rollout_pallas.backward(cfg, packed, *inputs, gt, res, cots)

    out, pres, grads = jax.device_get(run(cfg, packed, inputs, jnp.asarray(gt_count), cots))
    got, got_res = fr.plain_rollout_fwd(port_cfg(cfg), port_params(packed), *(t(x) for x in inputs), gt_count, True)
    for name, g, r in zip(("rot", "trans", "style", "deform"), got, out):
        close(g, r, VALUES, name)
    for name in pres:
        close(got_res[name], pres[name], VALUES, name)
    got = fr.plain_rollout_bwd(port_cfg(cfg), port_params(packed), gt_count, {k: t(v) for k, v in pres.items()},
                               [t(c) for c in cots], inputs[4].shape[-1])
    check_grads(got, grads)


def test_kernel_wrappers_refuse_other_devices():
    _, cfg, packed, inputs, cots, _, res, _ = case(*CASES[0])
    meta = [torch.empty(x.shape, device="meta") for x in inputs]
    with pytest.raises(ValueError, match="cuda or cpu"):
        fr.fused_rollout_fwd(port_cfg(cfg), port_params(packed), *meta, 3, False)


# (s, c) where the reference's atan formula and atan2 part: s = -0.0 with
# c < 0 (pi, not -pi), c negative but below 1e-20 in magnitude (the formula
# swaps it for +1e-20, then adds pi), and ordinary values.
ATAN2_EDGES = ((-0.0, -1.0), (1.0, -1e-25), (-1.0, -1e-25), (1.0, 0.0), (0.0, 0.0), (0.5, -2.0), (-0.5, 3.0))


def edge_params(packed, axis):
    """One copy of `packed` per edge pair: the head's rotation columns
    zeroed, so that every step's rotation (sin, cos) is exactly the head's
    bias, which holds the pair."""
    out = []
    for s, c in ATAN2_EDGES:
        whead = np.array(packed.whead)
        whead[:, 2 * axis:2 * axis + 2] = 0.0
        bhead = np.array(packed.bhead)
        bhead[0, 2 * axis], bhead[0, 2 * axis + 1] = s, c
        out.append(packed._replace(whead=jnp.asarray(whead), bhead=jnp.asarray(bhead)))
    return out


def test_atan2_edges_match_jax_core():
    s, c = (np.array(v, np.float32) for v in zip(*ATAN2_EDGES))
    got = fr._atan2(t(s), t(c))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfr._atan2(jnp.asarray(s), jnp.asarray(c))))
    assert got[0].item() == np.float32(np.pi) and torch.atan2(t(s), t(c))[0].item() == -np.float32(np.pi)
    _, cfg, packed, inputs, _, _, _, _ = case(*CASES[1])
    run = jax.jit(lambda p, x: jfr._forward_core(cfg, p, *x, jnp.asarray(1), collect_residuals=False)[0],
                  compiler_options=FAST_COMPILE)
    for params in edge_params(packed, cfg.rotation_axis):
        ref = jax.device_get(run(params, inputs))
        got, _ = fr.plain_rollout_fwd(port_cfg(cfg), port_params(jax.device_get(params)), *(t(x) for x in inputs),
                                      1, False)
        close(got[0], ref[0], VALUES, "rotations")


def test_kernel_shape_checks_accept_the_rollout_and_refuse_a_mismatch():
    """check_shapes, which the kernel wrappers run before a launch, passes
    the shapes the plain versions produce and names a mismatched one."""
    _, cfg, packed, inputs, cots, _, res, _ = case(*CASES[0])
    params = port_params(packed)
    names = ("rotations", "translations", "style", "deformation", "actions", "variations")
    tensors = {**dict(zip(names, (t(x) for x in inputs))), **{k: t(v) for k, v in res.items()},
               **{f"d_{n}": t(c) for n, c in zip(names, cots)}}
    sizes = (BS, T, S, D, A, V)
    fr.check_shapes(params, *sizes, tensors)
    with pytest.raises(ValueError, match="translations has shape"):
        fr.check_shapes(params, *sizes, dict(tensors, translations=torch.zeros(BS + 1, T, 3)))
    with pytest.raises(ValueError, match="gates_1 has shape"):
        fr.check_shapes(params, *sizes, dict(tensors, gates_1=torch.zeros(T - 1, BS, 16)))
    with pytest.raises(ValueError, match="whead has shape"):
        fr.check_shapes(params._replace(whead=torch.zeros(16, 9)), *sizes, tensors)
