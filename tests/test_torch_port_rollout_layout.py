"""The weight images of the cluster rollout kernels (csrc/fused_rollout.cu),
read on the CPU through Python copies of the kernels' index arithmetic.

A CTA q of a cluster streams its run of the image segment by segment, each
segment K rows of W floats, k-major. The forward reads per layer wh, then
wx: the element at row k, column c of such a segment is the weight of gate
c % 4 of hidden unit q U + c // 4; then the backbone segment's column c is
wb's column q U + c, the head segment's is whead's column q HU + c (zero
past H). The backward reads its segments as rows of whead, wb, wh and wx
(see `forward_source` and `backward_source`).
Checked: every image element is what that arithmetic names, and gathering
every CTA's slices back reproduces every weight and bias, column for column;
the forward run CTA by CTA from the image, as the kernel splits it, gives
the plain rollout; the backward's products from its image give the plain
backward's d_y, d_h and d_x. A wrong layout shows on the card only as wrong
numbers, so these run here at the phase-3 and play widths.
"""

import pytest
import torch

from playableenvironments_tpu_torch.ops import fused_rollout as fr
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

# (features, layers, S, D, A, V): the phase-3 dynamics, the play loop's,
# a width that takes 8-CTA clusters, and a small one for the simulations.
LAYOUT_CASES = [(256, 2, 64, 32, 7, 5), (128, 1, 64, 32, 7, 5), (96, 2, 8, 4, 4, 3), (64, 2, 8, 4, 4, 3)]
# Shapes the wide kernels run (rollout_is_wide): the widest and deepest
# corners, 300 as it runs (at 320), and 256 x 4, which the kernels above
# leave no room for two ring slots at the tennis dims.
WIDE_LAYOUT_CASES = [(768, 1, 64, 32, 7, 5), (512, 2, 64, 32, 7, 5), (320, 2, 8, 4, 4, 3), (128, 16, 8, 4, 4, 3),
                     (256, 4, 64, 32, 7, 5)]


def random_params(features, layers, S, D, A, V, seed=0):
    g = torch.Generator().manual_seed(seed)
    in0, head = 9 + S + D + A + V, 9 + S + D
    randn = lambda *shape: torch.randn(*shape, generator=g) * 0.2  # noqa: E731
    return fr.PackedParams(
        wx=tuple(randn(in0 if layer == 0 else features, 4 * features) for layer in range(layers)),
        wh=tuple(randn(features, 4 * features) for _ in range(layers)),
        bh=tuple(randn(1, 4 * features) for _ in range(layers)),
        h_init=tuple(randn(1, features) for _ in range(layers)),
        c_init=tuple(randn(1, features) for _ in range(layers)),
        wb=randn(features, features).t(),  # a transposed view, as pack_dynamics_params gives it
        bb=randn(1, features), whead=randn(features, head), bhead=randn(1, head),
    )


def forward_source(layout, params, segment, q, k, c):
    """(weight, row, column, valid) the forward kernel reads at row k,
    column c of CTA q's segment (forward_segments, rollout_fwd_kernel)."""
    U, F = layout.units, layout.features
    if segment < 2 * layout.layers:
        layer, which = divmod(segment, 2)
        weight = (params.wh if which == 0 else params.wx)[layer]
        return weight, k, (c % 4) * F + q * U + c // 4, torch.ones_like(k, dtype=torch.bool)
    if segment == 2 * layout.layers:
        return params.wb, k, q * U + c, torch.ones_like(k, dtype=torch.bool)
    col = q * layout.head_cols + c
    return params.whead, k, col, col < layout.head


def forward_bias_source(layout, params, q, c):
    """(bias, column, valid) of the bias image's column c for CTA q (the
    kernel's `bias` block: L x 4U gate-interleaved, then U, then HU)."""
    U, F, L = layout.units, layout.features, layout.layers
    if c < 4 * U * L:
        layer, cc = divmod(c, 4 * U)
        return params.bh[layer], (cc % 4) * F + q * U + cc // 4, True
    if c < 4 * U * L + U:
        return params.bb, q * U + c - 4 * U * L, True
    col = q * layout.head_cols + c - 4 * U * L - U
    return params.bhead, col, col < layout.head


def backward_source(layout, params, segment, q, k, c):
    """(weight, row, column, valid) the backward recurrence reads at row k,
    column c of CTA q's segment (backward_segments): whead and wb rows of
    its units over their columns, then per layer, top down, over the 4F
    gate columns, wh's rows of its units beside wx's (its XU input rows on
    layer 0)."""
    U = layout.units
    ones = torch.ones_like(k, dtype=torch.bool)
    if segment == 0:
        return params.whead, q * U + c, k, ones
    if segment == 1:
        return params.wb, q * U + c, k, ones
    layer = layout.layers - 1 - (segment - 2)
    if isinstance(c, int) and c < U:
        return params.wh[layer], q * U + c, k, ones
    i = c - U
    if layer > 0:
        return params.wx[layer], q * U + i, k, ones
    row = q * layout.in_cols + i
    return params.wx[0], row, k, row < layout.in0


def segment_views(layout, image, fwd):
    views, offset = [], 0
    for K, W in fr.rollout_segments(layout, fwd):
        views.append(image[:, offset:offset + K * W].reshape(layout.cluster, K, W))
        offset += K * W
    assert offset == image.shape[1]
    return views


def check_image(layout, params, image, fwd):
    """Each element as the source arithmetic names it; each weight element
    named exactly once (the padding, which names none, zero)."""
    seen = {id(p): torch.zeros(p.shape, dtype=torch.int64) for p in fr.param_list(params)}
    source = forward_source if fwd else backward_source
    for s, view in enumerate(segment_views(layout, image, fwd)):
        n, K, W = view.shape
        k = torch.arange(K)
        for q in range(n):
            for c in range(W):
                weight, row, col, valid = source(layout, params, s, q, k, c)
                row, col = torch.broadcast_to(torch.as_tensor(row), (K,)), torch.broadcast_to(torch.as_tensor(col), (K,))
                valid = torch.broadcast_to(torch.as_tensor(valid), (K,))
                got = view[q, :, c]
                assert not got[~valid].any(), (s, q, c)
                assert torch.equal(got[valid], weight[row[valid], col[valid]]), (s, q, c)
                seen[id(weight)].index_put_((row[valid], col[valid]), torch.tensor(1), accumulate=True)
    return seen


@pytest.mark.parametrize("features,layers,S,D,A,V", LAYOUT_CASES)
def test_weight_images_follow_the_kernels_index_arithmetic(features, layers, S, D, A, V):
    params = random_params(features, layers, S, D, A, V)
    in0, head = 9 + S + D + A + V, 9 + S + D
    layout = fr.rollout_layout(features, layers, in0, head)
    assert layout.cluster == (16 if features % 64 == 0 else 8) and layout.units * layout.cluster == features
    assert layout.units % 4 == 0 and layout.head_cols * layout.cluster >= head and layout.in_cols * layout.cluster >= in0

    image, bias = fr.rollout_fwd_image(params, layout)
    seen = check_image(layout, params, image, True)
    for w in list(params.wx) + list(params.wh) + [params.wb, params.whead]:
        assert torch.equal(seen[id(w)], torch.ones_like(seen[id(w)]))  # every column gathered back once
    bias_seen = {id(b): torch.zeros(b.shape[1], dtype=torch.int64) for b in list(params.bh) + [params.bb, params.bhead]}
    for q in range(layout.cluster):
        for c in range(bias.shape[1]):
            b, col, valid = forward_bias_source(layout, params, q, c)
            assert bias[q, c].item() == (b[0, col].item() if valid else 0.0), (q, c)
            if valid:
                bias_seen[id(b)][col] += 1
    assert all(bool((v == 1).all()) for v in bias_seen.values())

    image = fr.rollout_bwd_image(params, layout)
    seen = check_image(layout, params, image, False)
    for w in list(params.wx) + list(params.wh) + [params.wb, params.whead]:
        assert torch.equal(seen[id(w)], torch.ones_like(seen[id(w)]))


def split_forward(cfg, params, layout, rotations, translations, style, deform, actions, variations, gt_count):
    """plain_rollout_fwd's rollout as the forward kernel splits it: per
    layer each CTA's gate columns from its image segments and biases, its
    cell on its units, h gathered from every CTA; y and the head likewise."""
    n, U, HU, F, L = layout.cluster, layout.units, layout.head_cols, layout.features, layout.layers
    views = segment_views(layout, fr.rollout_fwd_image(params, layout)[0], True)
    bias = fr.rollout_fwd_image(params, layout)[1]
    batch, T = rotations.shape[:2]
    hs = [params.h_init[layer].expand(batch, F) for layer in range(L)]
    cs = [params.c_init[layer].expand(batch, F) for layer in range(L)]
    state = (rotations[:, 0], translations[:, 0], style[:, 0], deform[:, 0])
    outs = [state]
    for t in range(T - 1):
        if t < gt_count:
            state = (rotations[:, t], translations[:, t], style[:, t], deform[:, t])
        x = torch.cat([fr._encode_rotation_2d(state[0]), state[1] * fr._inv_box(cfg, state[1]), state[2], state[3],
                       actions[:, t], variations[:, t]], dim=-1)
        for layer in range(L):
            h_cols, c_cols = [], []
            for q in range(n):
                z = hs[layer] @ views[2 * layer][q] + x @ views[2 * layer + 1][q] + bias[q, 4 * U * layer:4 * U * (layer + 1)]
                z = z.reshape(batch, U, 4)
                i, f, g, o = torch.sigmoid(z[..., 0]), torch.sigmoid(z[..., 1]), torch.tanh(z[..., 2]), torch.sigmoid(z[..., 3])
                c_new = f * cs[layer][:, q * U:(q + 1) * U] + i * g
                c_cols.append(c_new)
                h_cols.append(o * torch.tanh(c_new))
            cs[layer], hs[layer] = torch.cat(c_cols, dim=1), torch.cat(h_cols, dim=1)
            x = hs[layer]
        y = torch.cat([torch.relu(x @ views[-2][q] + bias[q, 4 * U * L:4 * U * L + U]) for q in range(n)], dim=1)
        head = torch.cat([y @ views[-1][q] + bias[q, 4 * U * L + U:] for q in range(n)], dim=1)[:, :layout.head]
        rot, trans = state[0], state[1]
        axis = cfg.rotation_axis
        if not cfg.force_rotations_zero:
            rot = rot + fr._with_axis(axis, rot, fr._atan2(head[:, 2 * axis:2 * axis + 1], head[:, 2 * axis + 1:2 * axis + 2]))
        theta = state[0][:, axis:axis + 1]
        trans = trans + fr._rotate(axis, torch.cos(theta), torch.sin(theta), head[:, 6:9])
        if cfg.force_axis_translation is not None:
            trans = trans.clone()
            trans[:, axis] = cfg.force_axis_translation
        S = style.shape[-1]
        state = (rot, trans, head[:, 9:9 + S], head[:, 9 + S:])
        outs.append(state)
    return tuple(torch.stack([o[k] for o in outs], dim=1) for k in range(4))


@pytest.mark.parametrize("features,layers", [(64, 2), (128, 1)])
@pytest.mark.parametrize("cfg", [fr.RolloutConfig(2, True, 0.0, (1.5, 1.0, 2.15)),
                                 fr.RolloutConfig(1, False, None, (1.5, 1.0, 2.15))])
def test_forward_split_over_the_cluster_matches_plain(features, layers, cfg):
    S, D, A, V = 8, 4, 4, 3
    params = random_params(features, layers, S, D, A, V, seed=1)
    layout = fr.rollout_layout(features, layers, 9 + S + D + A + V, 9 + S + D)
    g = torch.Generator().manual_seed(2)
    batch, T = 5, 6
    inputs = [torch.randn(batch, T, 3, generator=g) * 0.3, torch.randn(batch, T, 3, generator=g),
              torch.randn(batch, T, S, generator=g), torch.randn(batch, T, D, generator=g),
              torch.randn(batch, T - 1, A, generator=g), torch.randn(batch, T - 1, V, generator=g)]
    got = split_forward(cfg, params, layout, *inputs, gt_count=2)
    ref, _ = fr.plain_rollout_fwd(cfg, params, *inputs, 2, False)
    for a, b in zip(got, ref):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("features,layers", [(64, 2), (128, 1), (96, 2), (768, 1), (128, 16)])
def test_backward_products_from_the_image_match_plain(features, layers):
    """Each CTA's products over its backward segments: d_y on its backbone
    columns (d_head whead^T), the top layer's d_h on its units (d_y wb^T),
    and per layer [d_h_prev | d_x] on its units (dz wh^T, dz wx^T; on
    layer 0 its XU input columns of dz wx^T), against the plain backward's
    products."""
    S, D, A, V = 8, 4, 4, 3
    params = random_params(features, layers, S, D, A, V, seed=3)
    in0, head = 9 + S + D + A + V, 9 + S + D
    layout = fr.rollout_layout(features, layers, in0, head)
    n, U, XU = layout.cluster, layout.units, layout.in_cols
    views = segment_views(layout, fr.rollout_bwd_image(params, layout), False)
    g = torch.Generator().manual_seed(4)
    d_head, d_y, dz = (torch.randn(16, w, generator=g) for w in (head, features, 4 * features))
    own = lambda x, q: x[:, q * U:(q + 1) * U]  # noqa: E731
    for q in range(n):
        torch.testing.assert_close(d_head @ views[0][q], own(d_head @ params.whead.t(), q), rtol=1e-5, atol=1e-5)
        torch.testing.assert_close(d_y @ views[1][q], own(d_y @ params.wb.t(), q), rtol=1e-5, atol=1e-5)
        for i, layer in enumerate(range(layers - 1, -1, -1)):
            out = dz @ views[2 + i][q]
            torch.testing.assert_close(out[:, :U], own(dz @ params.wh[layer].t(), q), rtol=1e-5, atol=1e-5)
            d_x = dz @ params.wx[layer].t()
            if layer > 0:
                torch.testing.assert_close(out[:, U:], own(d_x, q), rtol=1e-5, atol=1e-5)
            else:
                ref = torch.nn.functional.pad(d_x, (0, n * XU - in0))[:, q * XU:(q + 1) * XU]
                torch.testing.assert_close(out[:, U:], ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("features,layers,S,D,A,V", LAYOUT_CASES + WIDE_LAYOUT_CASES)
def test_shared_memory_fits_and_mirrors_the_kernels(features, layers, S, D, A, V):
    """The ring takes 2 to 8 slots beside the rest, within the card's
    227 KB; each segment's rows fit a slot, and every width is a multiple
    of 4 that leaves each 4 x 4 output tile at least one consumer thread.
    The published shapes take the kernels that keep whole activations in
    each CTA, the wide shapes the wide kernels."""
    in0, head = 9 + S + D + A + V, 9 + S + D
    layout = fr.rollout_layout(features, layers, in0, head)
    wide = (features, layers, S, D, A, V) in WIDE_LAYOUT_CASES
    for fwd in (True, False):
        assert fr.rollout_is_wide(layout, fwd) == wide
        stages = fr._stages(layout, fwd)
        assert 2 <= stages <= 8 and fr._smem_bytes(layout, stages, fwd) <= fr._MAX_SMEM
        for K, W in fr.rollout_segments(layout, fwd):
            assert W % 4 == 0 and W <= fr._CONSUMERS and fr._SLOT_FLOATS // W >= 1
