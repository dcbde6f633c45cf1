"""The wide rollout kernels (csrc/fused_rollout.cu: rollout_fwd_wide_kernel,
rollout_bwd_wide_recurrence_kernel) and the wide envelope of the port's
rollout, on the CPU.

Above 256 features or 4 layers (`fr.rollout_is_wide`) B4/B5 run kernels
that exchange h, y and the head (forward) and d_y, dz and d_x0 (backward)
through a per-tile global scratch (`fr.wide_scratch`: k-major [rows][16]
blocks, h by step parity, dz by layer parity, each CTA writing its own
rows) and stream the backward's (4F, W) segments as four (F, W) gate
blocks. Checked here:
- the weight images at 512 x 2, 768 x 1 and 128 x 16 read back weight for
  weight through the kernels' index arithmetic (vectorized copies of
  test_torch_port_rollout_layout.py's);
- the forward run CTA by CTA as the wide kernel runs it, every exchange
  through a copy of its scratch (filled with NaN first, so that a block
  read before it is written shows), equals plain_rollout_fwd; the
  backward's products through the scratch and the gate blocks equal the
  plain backward's;
- the wide shared-memory mirror fits the card at every corner of the
  envelope, and no term of it grows with the layers;
- JAX's fused_rollout (XLA path) against the port's plain forward and
  backward at 512 x 2 and 128 x 16, and the Pallas kernels in interpret
  mode at 320 x 5, on the same packed weights (tolerances: the JAX
  package's own for this op, as test_torch_port_rollout.py states them);
- the wrappers take 768 features and 16 layers and refuse 800 and 17 (meta
  tensors: the checks run before any launch).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.ops import fused_rollout as jfr
from playableenvironments_tpu.ops import fused_rollout_pallas
from playableenvironments_tpu_torch.ops import fused_rollout as fr
from test_torch_port_rollout import FAST_COMPILE, GRADS, VALUES, check_grads, close, port_params
from test_torch_port_rollout_layout import random_params
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

S, D, A, V = 8, 4, 4, 3
IN0, HEAD = 9 + S + D + A + V, 9 + S + D
WIDE = [(512, 2), (768, 1), (128, 16)]
CFG = fr.RolloutConfig(1, False, None, (1.5, 1.0, 2.15))


def wide_layout(features, layers):
    layout = fr.rollout_layout(features, layers, IN0, HEAD)
    assert fr.rollout_is_wide(layout, True) and fr.rollout_is_wide(layout, False)
    return layout


def segment_views(image, segments, n):
    views, offset = [], 0
    for K, W in segments:
        views.append(image[:, offset:offset + K * W].reshape(n, K, W))
        offset += K * W
    assert offset == image.shape[1]
    return views


def streamed_segments(layout):
    """backward_segments_wide: the backward's image as the wide kernel
    streams it, each layer's (4F, W) segment as four (F, W) gate blocks."""
    out = fr.rollout_segments(layout, False)[:2]
    for K, W in fr.rollout_segments(layout, False)[2:]:
        out += [(K // 4, W)] * 4
    return out


def grid(layout, K, W):
    q = torch.arange(layout.cluster)[:, None, None]
    return q, torch.arange(K)[None, :, None], torch.arange(W)[None, None, :]


def read_back(view, weight, rows, cols, valid, seen):
    """view[q, k, c] is weight[rows, cols] where valid, else 0; count each
    weight element it names."""
    rows, cols, valid = torch.broadcast_tensors(rows, cols, valid)
    assert not view[~valid].any()
    assert torch.equal(view[valid], weight[rows[valid], cols[valid]])
    seen[id(weight)].index_put_((rows[valid], cols[valid]), torch.tensor(1), accumulate=True)


@pytest.mark.parametrize("features,layers", WIDE)
def test_wide_images_read_back_weight_for_weight(features, layers):
    """Forward: per layer wh then wx, column c = unit q U + c // 4 of gate
    c % 4; wb's columns q U + c; whead's q HU + c (zero past H). Backward,
    in the wide kernel's gate blocks: whead's and wb's rows q U + c, then
    per layer, top down, gate block j of dz's rows, wh's rows of the CTA's
    units beside wx's (layer 0 its XU input rows, zero past in0). Every
    weight element named exactly once."""
    params = random_params(features, layers, S, D, A, V, seed=features + layers)
    layout = wide_layout(features, layers)
    n, U, F, L, HU, XU = (layout.cluster, layout.units, features, layers, layout.head_cols, layout.in_cols)
    weights = list(params.wx) + list(params.wh) + [params.wb, params.whead]
    image, bias = fr.rollout_fwd_image(params, layout)
    seen = {id(w): torch.zeros(w.shape, dtype=torch.int64) for w in weights}
    views = segment_views(image, fr.rollout_segments(layout, True), n)
    ones = torch.tensor(True)
    for l in range(L):
        for j, w in enumerate((params.wh[l], params.wx[l])):
            q, k, c = grid(layout, w.shape[0], 4 * U)
            read_back(views[2 * l + j], w, k, (c % 4) * F + q * U + c // 4, ones, seen)
    q, k, c = grid(layout, F, U)
    read_back(views[-2], params.wb, k, q * U + c, ones, seen)
    q, k, c = grid(layout, F, HU)
    col = q * HU + c
    read_back(views[-1], params.whead, k, col.clamp(max=HEAD - 1), col < HEAD, seen)
    assert all(bool((s == 1).all()) for s in seen.values())
    c = torch.arange(4 * U)
    for q in range(n):
        for l in range(L):
            assert torch.equal(bias[q, 4 * U * l:4 * U * (l + 1)], params.bh[l][0, (c % 4) * F + q * U + c // 4])

    seen = {id(w): torch.zeros(w.shape, dtype=torch.int64) for w in weights}
    views = segment_views(fr.rollout_bwd_image(params, layout), streamed_segments(layout), n)
    q, k, c = grid(layout, HEAD, U)
    read_back(views[0], params.whead, q * U + c, k, ones, seen)
    q, k, c = grid(layout, F, U)
    read_back(views[1], params.wb, q * U + c, k, ones, seen)
    for i, l in enumerate(range(L - 1, -1, -1)):
        W = U + (U if l > 0 else XU)
        for gate in range(4):
            view = views[2 + 4 * i + gate]
            q, k, c = grid(layout, F, W)
            k = k + gate * F
            read_back(view[:, :, :U], params.wh[l], q * U + c[..., :U], k, ones, seen)
            row = q * (U if l > 0 else XU) + c[..., U:] - U
            rows_of = params.wx[l].shape[0]
            read_back(view[:, :, U:], params.wx[l], row.clamp(max=rows_of - 1), k, row < rows_of, seen)
    assert all(bool((s == 1).all()) for s in seen.values())


def inputs_for(batch, T, seed):
    g = torch.Generator().manual_seed(seed)
    inputs = [torch.randn(batch, T, 3, generator=g) * 0.3, torch.randn(batch, T, 3, generator=g),
              torch.randn(batch, T, S, generator=g), torch.randn(batch, T, D, generator=g),
              torch.randn(batch, T - 1, A, generator=g), torch.randn(batch, T - 1, V, generator=g)]
    cots = [torch.randn(batch, T, w, generator=g) for w in (3, 3, S, D)]
    return inputs, cots


def wide_forward(cfg, params, layout, inputs, gt_count):
    """plain_rollout_fwd's rollout as rollout_fwd_wide_kernel runs one tile
    of 16 rows (rows past the batch zero): per layer each CTA's gate
    columns from its image segments and biases, its cell on its units with
    c kept in the scratch, h published into the scratch block of the step's
    parity and gathered back from it (h_init at step 0); y and the head
    likewise."""
    rotations, translations, style, deform, actions, variations = inputs
    n, U, HU, F, L = layout.cluster, layout.units, layout.head_cols, layout.features, layout.layers
    image, bias = fr.rollout_fwd_image(params, layout)
    views = segment_views(image, fr.rollout_segments(layout, True), n)
    x = fr.wide_scratch(layout, True)
    scratch = torch.full((x["per_tile"],), float("nan"))
    block = lambda offset, rows: scratch[offset:offset + rows * 16].view(rows, 16)  # noqa: E731
    h = lambda parity, l: block(x["h"] + (parity * L + l) * F * 16, F)  # noqa: E731
    for l in range(L):
        block(x["c"] + l * F * 16, F).copy_(params.c_init[l][0][:, None].expand(F, 16))
    batch, T = rotations.shape[:2]
    pad = lambda t: torch.nn.functional.pad(t, (0, 0, 0, 16 - batch))  # noqa: E731
    state = tuple(pad(s[:, 0]) for s in (rotations, translations, style, deform))
    outs = [state]
    for t in range(T - 1):
        if t < gt_count:
            state = tuple(pad(s[:, t]) for s in (rotations, translations, style, deform))
        x0 = torch.cat([fr._encode_rotation_2d(state[0]), state[1] * fr._inv_box(cfg, state[1]), state[2], state[3],
                        pad(actions[:, t]), pad(variations[:, t])], dim=-1)
        cur, nxt = t % 2, 1 - t % 2
        for l in range(L):
            h_prev = params.h_init[l][0][:, None].expand(F, 16) if t == 0 else h(cur, l).clone()
            x_in = x0 if l == 0 else h(nxt, l - 1).t()
            for q in range(n):
                z = (h_prev.t() @ views[2 * l][q] + x_in @ views[2 * l + 1][q]
                     + bias[q, 4 * U * l:4 * U * (l + 1)]).reshape(16, U, 4)
                i, f, g, o = torch.sigmoid(z[..., 0]), torch.sigmoid(z[..., 1]), torch.tanh(z[..., 2]), \
                    torch.sigmoid(z[..., 3])
                cell = block(x["c"] + l * F * 16, F)[q * U:(q + 1) * U]
                c_new = f * cell.t() + i * g
                cell.copy_(c_new.t())
                h(nxt, l)[q * U:(q + 1) * U] = (o * torch.tanh(c_new)).t()
        top = h(nxt, L - 1).t()
        for q in range(n):
            block(x["y"] + q * U * 16, U).copy_(torch.relu(top @ views[-2][q] + bias[q, 4 * U * L:4 * U * L + U]).t())
        y = block(x["y"], F).t()
        for q in range(n):
            block(x["head"] + q * HU * 16, HU).copy_((y @ views[-1][q] + bias[q, 4 * U * L + U:]).t())
        head = block(x["head"], n * HU).t()[:, :layout.head].clone()  # the state keeps it past the next step
        rot, trans = state[0], state[1]
        axis = cfg.rotation_axis
        if not cfg.force_rotations_zero:
            rot = rot + fr._with_axis(axis, rot, fr._atan2(head[:, 2 * axis:2 * axis + 1],
                                                             head[:, 2 * axis + 1:2 * axis + 2]))
        theta = state[0][:, axis:axis + 1]
        trans = trans + fr._rotate(axis, torch.cos(theta), torch.sin(theta), head[:, 6:9])
        if cfg.force_axis_translation is not None:
            trans = trans.clone()
            trans[:, axis] = cfg.force_axis_translation
        state = (rot, trans, head[:, 9:9 + S], head[:, 9 + S:])
        outs.append(state)
    return tuple(torch.stack([o[k][:batch] for o in outs], dim=1) for k in range(4))


@pytest.mark.parametrize("features,layers", WIDE)
@pytest.mark.parametrize("cfg", [fr.RolloutConfig(2, True, 0.0, (1.5, 1.0, 2.15)), CFG])
def test_wide_forward_through_the_scratch_matches_plain(features, layers, cfg):
    params = random_params(features, layers, S, D, A, V, seed=features * layers)
    inputs, _ = inputs_for(5, 4, seed=layers)
    got = wide_forward(cfg, params, wide_layout(features, layers), inputs, gt_count=2)
    ref, _ = fr.plain_rollout_fwd(cfg, params, *inputs, 2, False)
    for a, b in zip(got, ref):
        assert bool(torch.isfinite(a).all())
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("features,layers", WIDE)
def test_wide_backward_products_through_the_scratch_match_plain(features, layers):
    """rollout_bwd_wide_recurrence_kernel's products of one step: d_y on each
    CTA's backbone columns published into the scratch's d_y block; the top
    layer's d_h from it; per layer, top down, each CTA's dz published into
    the dz block of the layer's parity at rows gate F + q U, then
    [d_h_prev | d_x] on its units (its XU input columns on layer 0) summed
    over the four gate blocks in turn; d_x0 gathered from every CTA's XU
    rows. Against the plain backward's products; the carries' block holds
    each CTA's units of d_h."""
    params = random_params(features, layers, S, D, A, V, seed=3 + layers)
    layout = wide_layout(features, layers)
    n, U, XU, F, L = layout.cluster, layout.units, layout.in_cols, features, layers
    views = segment_views(fr.rollout_bwd_image(params, layout), streamed_segments(layout), n)
    x = fr.wide_scratch(layout, False)
    scratch = torch.full((x["per_tile"],), float("nan"))
    block = lambda offset, rows: scratch[offset:offset + rows * 16].view(rows, 16)  # noqa: E731
    g = torch.Generator().manual_seed(4)
    d_head = torch.randn(16, HEAD, generator=g)
    dzs = [torch.randn(16, 4 * F, generator=g) for _ in range(L)]
    own = lambda t, q: t[:, q * U:(q + 1) * U]  # noqa: E731
    for q in range(n):
        block(x["dy"] + q * U * 16, U).copy_((d_head @ views[0][q]).t())
    d_y = block(x["dy"], F).t()
    torch.testing.assert_close(d_y, d_head @ params.whead.t(), rtol=1e-5, atol=1e-5)
    for q in range(n):
        torch.testing.assert_close(d_y @ views[1][q], own(d_y @ params.wb.t(), q), rtol=1e-5, atol=1e-5)
    for i, l in enumerate(range(L - 1, -1, -1)):
        xdz = x["dz"] + (l % 2) * 4 * F * 16
        for q in range(n):
            for gate in range(4):
                block(xdz + (gate * F + q * U) * 16, U).copy_(dzs[l][:, gate * F + q * U:gate * F + (q + 1) * U].t())
        for q in range(n):
            out = sum(block(xdz + gate * F * 16, F).t() @ views[2 + 4 * i + gate][q] for gate in range(4))
            block(x["carry"] + (l * F + q * U) * 16, U).copy_(out[:, :U].t())
            torch.testing.assert_close(out[:, :U], own(dzs[l] @ params.wh[l].t(), q), rtol=1e-4, atol=1e-4)
            d_x = dzs[l] @ params.wx[l].t()
            if l > 0:
                torch.testing.assert_close(out[:, U:], own(d_x, q), rtol=1e-4, atol=1e-4)
            else:
                block(x["dx0"] + q * XU * 16, XU).copy_(out[:, U:].t())
        torch.testing.assert_close(block(x["carry"] + l * F * 16, F).t(), dzs[l] @ params.wh[l].t(), rtol=1e-4,
                                   atol=1e-4)
    d_x0 = block(x["dx0"], n * XU).t()[:, :IN0]
    torch.testing.assert_close(d_x0, dzs[0] @ params.wx[0].t(), rtol=1e-4, atol=1e-4)
    assert x["carry"] + 2 * L * F * 16 == x["per_tile"]


CORNERS = [(features, layers, dims) for features in (32, 64, 256, 512, 768) for layers in (1, 4, 5, 16)
           for dims in ((8, 4, 4, 3), (64, 32, 7, 5))]


@pytest.mark.parametrize("features,layers,dims", CORNERS)
def test_wide_shared_memory_fits_at_the_envelopes_corners(features, layers, dims):
    """Each direction's kernel at these sizes (synthetic_smoke's dynamics
    dims and the tennis phase-3 ones) leaves 2 to 8 ring slots within the
    card's 232,448 bytes; the wide one's shared memory does not grow with
    the layers, and every segment the kernel streams is at most 256 floats
    wide, a multiple of 4."""
    S_, D_, A_, V_ = dims
    layout = fr.rollout_layout(features, layers, 9 + S_ + D_ + A_ + V_, 9 + S_ + D_)
    for fwd in (True, False):
        stages = fr._stages(layout, fwd)
        assert 2 <= stages <= fr._MAX_STAGES and fr._smem_bytes(layout, stages, fwd) <= fr._MAX_SMEM
        wide = fr.rollout_is_wide(layout, fwd)
        assert wide == (features > 256 or layers > 4 or fr._narrow_smem_bytes(layout, 2, fwd) > fr._MAX_SMEM)
        one_layer = layout._replace(layers=1)
        assert fr._wide_smem_bytes(layout, 2, fwd) == fr._wide_smem_bytes(one_layer, 2, fwd)
        assert all(W % 4 == 0 and W <= fr._CONSUMERS for _, W in fr.rollout_segments(layout, fwd))


def test_kernel_features_keep_16_cta_clusters_above_512():
    """Above 512 features the kernels run at the next multiple of 64, so
    that the cluster is 16 CTAs and a CTA's 4U gate columns (192 at 768)
    fit its 256 consumer threads; 300 runs at 320."""
    assert [fr.kernel_features(f) for f in (16, 256, 288, 300, 512, 513, 544, 700, 768, 800)] == [
        32, 256, 288, 320, 512, 576, 576, 704, 768, 800]
    for features in range(520, 769, 8):
        layout = fr.rollout_layout(fr.kernel_features(features), 1, 117, 105)
        assert layout.cluster == 16 and 4 * layout.units <= fr._CONSUMERS


def jax_case(features, layers, batch, T, seed):
    """Seeded packed weights (numpy), inputs and cotangents, gt_count 1."""
    params = random_params(features, layers, S, D, A, V, seed=seed)
    scale = [1.0 / np.sqrt(p.shape[0]) if p.shape[0] > 1 else 1.0 for p in fr.param_list(params)]
    values = [(p * s * 5.0).numpy() for p, s in zip(fr.param_list(params), scale)]
    inputs, cots = inputs_for(batch, T, seed)
    jpacked = jfr.PackedParams(*fr.params_from_list([jnp.asarray(v) for v in values], layers))
    return jpacked, [x.numpy() for x in inputs], [c.numpy() for c in cots]


def jax_cfg():
    return jfr.RolloutConfig(rotation_axis=CFG.rotation_axis, force_rotations_zero=CFG.force_rotations_zero,
                             force_axis_translation=CFG.force_axis_translation, box_size=CFG.box_size)


@pytest.mark.parametrize("features,layers", [(512, 2), (128, 16)])
def test_plain_versions_match_jax_fused_rollout_at_wide_shapes(features, layers):
    """JAX's fused_rollout on its XLA path (the custom VJP's _backward_core)
    against plain_rollout_fwd and plain_rollout_bwd, batch 2, T 3."""
    jpacked, inputs, cots = jax_case(features, layers, 2, 3, seed=features + layers)

    @jax.jit
    def run(packed, inputs, cots):
        out, vjp = jax.vjp(lambda p, *x: jfr.fused_rollout(jax_cfg(), p, *x, jnp.asarray(1)), packed, *inputs)
        return out, vjp(tuple(cots))

    out, grads = jax.device_get(run(jpacked, inputs, cots))
    params = port_params(jax.device_get(jpacked))
    got, res = fr.plain_rollout_fwd(CFG, params, *(torch.from_numpy(x) for x in inputs), 1, True)
    for name, g, r in zip(("rot", "trans", "style", "deform"), got, out):
        close(g, r, VALUES, name)
    got = fr.plain_rollout_bwd(CFG, params, 1, res, [torch.from_numpy(c) for c in cots], A)
    check_grads(got, (port_params(grads[0]),) + tuple(grads[1:]))


def test_plain_versions_match_the_pallas_kernels_at_320_x_5():
    """fused_rollout_pallas.forward/backward in interpret mode at 320 x 5
    (batch 2, T 3) against the port's plain versions: the outputs, every
    residual, every gradient."""
    jpacked, inputs, cots = jax_case(320, 5, 2, 3, seed=7)

    @functools.partial(jax.jit, compiler_options=FAST_COMPILE)
    def run(packed, inputs, cots):
        out, res = fused_rollout_pallas.forward(jax_cfg(), packed, *inputs, jnp.asarray(1), True)
        return out, res, fused_rollout_pallas.backward(jax_cfg(), packed, *inputs, jnp.asarray(1), res, cots)

    out, pres, jgrads = jax.device_get(run(jpacked, inputs, cots))
    params = port_params(jax.device_get(jpacked))
    got, got_res = fr.plain_rollout_fwd(CFG, params, *(torch.from_numpy(x) for x in inputs), 1, True)
    for name, g, r in zip(("rot", "trans", "style", "deform"), got, out):
        close(g, r, VALUES, name)
    for name in pres:
        close(got_res[name], pres[name], VALUES, name)
    got = fr.plain_rollout_bwd(CFG, params, 1, {k: torch.tensor(v) for k, v in pres.items()},
                               [torch.from_numpy(c) for c in cots], A)
    check_grads(got, jgrads, GRADS)


def meta_case(features, layers):
    params = fr.params_from_list([torch.empty(p.shape, device="meta") for p in fr.param_list(
        random_params(32, layers, S, D, A, V))], layers)
    F = features
    params = params._replace(
        wx=tuple(torch.empty(IN0 if l == 0 else F, 4 * F, device="meta") for l in range(layers)),
        wh=tuple(torch.empty(F, 4 * F, device="meta") for _ in range(layers)),
        bh=tuple(torch.empty(1, 4 * F, device="meta") for _ in range(layers)),
        h_init=tuple(torch.empty(1, F, device="meta") for _ in range(layers)),
        c_init=tuple(torch.empty(1, F, device="meta") for _ in range(layers)),
        wb=torch.empty(F, F, device="meta"), bb=torch.empty(1, F, device="meta"),
        whead=torch.empty(F, HEAD, device="meta"))
    batch, T = 3, 4
    inputs = [torch.empty(batch, T, w, device="meta") for w in (3, 3, S, D)]
    inputs += [torch.empty(batch, T - 1, w, device="meta") for w in (A, V)]
    residuals = {k: torch.empty(T - 1, batch, w, device="meta") for k, w in (
        ("cur_rot", 3), ("cur_trans", 3), ("cur_style", S), ("cur_deform", D), ("x0", IN0), ("y", F),
        ("head", HEAD))}
    for l in range(layers):
        residuals.update({f"gates_{l}": torch.empty(T - 1, batch, 4 * F, device="meta"),
                          f"c_{l}": torch.empty(T - 1, batch, F, device="meta"),
                          f"h_{l}": torch.empty(T - 1, batch, F, device="meta")})
    return params, inputs, residuals, [torch.empty(batch, T, w, device="meta") for w in (3, 3, S, D)]


@pytest.mark.parametrize("features,layers,match", [(768, 16, "cuda or cpu"), (736, 16, "cuda or cpu"),
                                                   (800, 1, "at most 768"), (512, 17, "layers 17 must be 1 to 16")])
def test_wrappers_take_the_envelope_and_refuse_beyond_it(features, layers, match):
    """On meta tensors the wrappers check the shape before the device: 768
    x 16 (and 736, run at 768) pass the shape checks and stop at the
    device; 800 features and 17 layers raise naming the limit. Inside the
    envelope the plan takes the wide kernels, both directions."""
    params, inputs, residuals, cots = meta_case(features, layers)
    with pytest.raises(ValueError, match=match):
        fr.fused_rollout_fwd(CFG, params, *inputs, 1, False)
    with pytest.raises(ValueError, match=match):
        fr.fused_rollout_bwd(CFG, params, 1, residuals, cots, A)
    if match == "cuda or cpu":
        for fwd in (True, False):
            plan = fr._plan(CFG, fwd, True, 3, 4, S, D, A, V, fr.kernel_features(features), layers, 1)
            assert fr.rollout_is_wide(plan.layout, fwd) and plan.layout.cluster == 16
            assert plan.scratch.parts[-1][0] == (1, fr.wide_scratch(plan.layout, fwd)["per_tile"])
