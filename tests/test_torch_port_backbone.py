"""The port's trainable fused backbone (ops/fused_nerf.py::fused_backbone)
against the JAX package's custom-VJP `fused_backbone`, whose forward and
backward Pallas kernels run in interpret mode here: outputs and the vjp of
random cotangents (d_encoded and every weight and bias gradient), with a
ragged point count, in f32 (1e-5 relative to each output's largest
magnitude: the same products, summed in another order) and in bf16 (5e-3,
as B1's: the same bf16 operand rounding, and another f32 summation order
can flip an occasional bf16 rounding). The kernels' flat layouts are checked
on the CPU by reading them as csrc/fused_backbone.cu does; the kernels
themselves run only on a card (test_torch_port_cuda.py)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu import config as jax_config
from playableenvironments_tpu.ops import fused_nerf as jax_fused
from playableenvironments_tpu_torch import config as port_config
from playableenvironments_tpu_torch.ops import fused_nerf

KW = dict(layers_width=32, backbone_layers_count=4, skip_layer_idx=2, output_features=3,
          position_encoder=dict(octaves=2))


def configs(compute_dtype):
    kw = dict(KW, compute_dtype=compute_dtype, use_fused_backbone=True)
    pe = kw.pop("position_encoder")
    return (jax_config.NerfMLPConfig(position_encoder=jax_config.PositionalEncoderConfig(**pe), **kw),
            port_config.NerfMLPConfig(position_encoder=port_config.PositionalEncoderConfig(**pe), **kw))


def inputs(cfg, n, pe=15, seed=0):
    rng = np.random.default_rng(seed)
    packed = {}
    for i, w_in in enumerate(fused_nerf._backbone_sizes(cfg, pe)):
        packed[f"w{i}"] = (rng.normal(size=(w_in, cfg.layers_width)) / np.sqrt(w_in)).astype(np.float32)
        packed[f"b{i}"] = (rng.normal(size=(cfg.layers_width,)) * 0.1).astype(np.float32)
    packed["w_alpha"] = (rng.normal(size=(cfg.layers_width, 1)) * 0.2).astype(np.float32)
    packed["b_alpha"] = np.asarray([0.1], np.float32)
    encoded = rng.uniform(-1, 1, (n, pe)).astype(np.float32)
    g_h = rng.normal(size=(n, cfg.layers_width)).astype(np.float32)
    g_alpha = rng.normal(size=(n,)).astype(np.float32)
    return packed, encoded, g_h, g_alpha


def relative_close(got, ref, tol, name):
    ref = np.asarray(ref).reshape(np.shape(got))
    scale = np.abs(ref).max()
    assert scale > 0, name
    np.testing.assert_allclose(np.asarray(got), ref, rtol=0, atol=tol * scale, err_msg=name)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
@pytest.mark.parametrize("n", [700, 64])
def test_fused_backbone_and_its_vjp_match_jax(compute_dtype, tol, n):
    """700 points: two 512-point JAX blocks, the last one ragged."""
    jcfg, cfg = configs(compute_dtype)
    packed, encoded, g_h, g_alpha = inputs(cfg, n)
    jpacked = {k: jnp.asarray(v) for k, v in packed.items()}
    (jh, ja), vjp = jax.vjp(lambda p, e: jax_fused.fused_backbone(jcfg, p, e, 512, True), jpacked, jnp.asarray(encoded))
    jd_packed, jd_encoded = vjp((jnp.asarray(g_h), jnp.asarray(g_alpha)))

    tpacked = {k: torch.tensor(v, requires_grad=True) for k, v in packed.items()}
    tencoded = torch.tensor(encoded, requires_grad=True)
    h, alpha = fused_nerf.fused_backbone(cfg, tpacked, tencoded)
    torch.autograd.backward([h, alpha], [torch.from_numpy(g_h), torch.from_numpy(g_alpha)])
    relative_close(h.detach(), jh, tol, "h")
    relative_close(alpha.detach(), ja, tol, "alpha")
    relative_close(tencoded.grad, jd_encoded, tol, "d_encoded")
    for name, value in tpacked.items():
        relative_close(value.grad, jd_packed[name], tol, name)


def test_plain_backward_is_the_gradient_of_the_plain_forward():
    """In f32 the explicit backward equals autograd through the forward."""
    _, cfg = configs("float32")
    packed, encoded, g_h, g_alpha = inputs(cfg, 50, seed=1)
    tpacked = {k: torch.tensor(v, requires_grad=True) for k, v in packed.items()}
    tencoded = torch.tensor(encoded, requires_grad=True)
    h, alpha = fused_nerf.plain_backbone_fwd(cfg, tpacked, tencoded)
    torch.autograd.backward([h, alpha], [torch.from_numpy(g_h), torch.from_numpy(g_alpha)])
    grads, d_encoded = fused_nerf.plain_backbone_bwd(
        cfg, {k: torch.from_numpy(v) for k, v in packed.items()}, torch.from_numpy(encoded),
        torch.from_numpy(g_h), torch.from_numpy(g_alpha))
    torch.testing.assert_close(d_encoded, tencoded.grad, rtol=1e-5, atol=1e-6)
    for name, value in tpacked.items():
        torch.testing.assert_close(grads[name].reshape(value.shape), value.grad, rtol=1e-5, atol=1e-6)


def test_sizes_and_weight_list_match_jax():
    jcfg, cfg = configs("bfloat16")
    assert fused_nerf._backbone_sizes(cfg, 15) == jax_fused._backbone_sizes(jcfg, 15) == [15, 32, 47, 32]
    packed, *_ = inputs(cfg, 4)
    jlist = jax_fused._weight_list(jcfg, {k: jnp.asarray(v) for k, v in packed.items()})
    tlist = fused_nerf._weight_list(cfg, {k: torch.from_numpy(v) for k, v in packed.items()})
    assert [tuple(w.shape) for w in tlist] == [tuple(w.shape) for w in jlist]
    for w, jw in zip(tlist, jlist):
        np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


LAYOUT_CASES = [(4, 64, 2, 15), (8, 256, 4, 63), (3, 128, 1, 64), (8, 192, 4, 63)]


def weight_offset(cfg, layer, row, col):
    """Element offsets in the weight image (`backbone_buffers`) of the
    layer's weights (row, col), rows in the JAX layout (in_i, W), as
    csrc/fused_backbone.cu addresses them: layer by layer, each 64-row slot
    W/64 swizzled 64 x 64 blocks, the skip layer's encoding rows in its last
    slot."""
    width = cfg.layers_width
    first = sum(len(s) for s in fused_nerf._layer_slots(cfg)[:layer])
    if layer == 0:
        slot, r = torch.full_like(row, first), row
    else:
        enc = row >= width
        slot = first + torch.where(enc, width // 64, row // 64)
        r = torch.where(enc, row - width, row % 64)
    return slot * 64 * width + (col // 64) * 64 * 64 + fused_nerf.swizzled(r, col % 64)


def scratch_offset(point, block_column, col, columns):
    """Element offset of (point, feature col < 64 of column block
    `block_column`) in the backward's X or G scratch as the kernels address
    it: block (point // 64, block_column) at ((point // 64) * columns +
    block_column) * 4096, swizzled within."""
    return ((point // 64) * columns + block_column) * 64 * 64 + fused_nerf.swizzled(point % 64, col)


def layout_inputs(layers, width, skip, pe, n=40):
    cfg = port_config.NerfMLPConfig(layers_width=width, backbone_layers_count=layers, skip_layer_idx=skip,
                                    compute_dtype="bfloat16", use_fused_backbone=True)
    packed, encoded, g_h, g_alpha = inputs(cfg, n, pe=pe, seed=2)
    return (cfg, {k: torch.from_numpy(v) for k, v in packed.items()},
            *(torch.from_numpy(np.asarray(x)) for x in (encoded, g_h, g_alpha)))


@pytest.mark.parametrize("layers,width,skip,pe", LAYOUT_CASES)
def test_kernel_layouts(layers, width, skip, pe):
    """The swizzled weight image, read through csrc/fused_backbone.cu's
    address arithmetic (`weight_offset`): every weight at a
    unique in-bounds offset, read back exactly; the forward run slot by slot
    as the kernel runs it gives the plain forward; the kernels' flat
    gradient output, written in its padded row order, unpacks to the plain
    gradients."""
    cfg, packed, encoded, g_h, g_alpha = layout_inputs(layers, width, skip, pe)
    weights, biases = fused_nerf.backbone_buffers(cfg, packed)
    slots = fused_nerf._layer_slots(cfg)
    slot_elems = 64 * width
    assert weights.numel() == sum(map(len, slots)) * slot_elems + width
    offsets = []
    for i in range(layers):
        w = packed[f"w{i}"]
        row, col = torch.meshgrid(torch.arange(w.shape[0]), torch.arange(width), indexing="ij")
        off = weight_offset(cfg, i, row, col)
        assert torch.equal(weights[off], w.to(torch.bfloat16)), i
        offsets.append(off.reshape(-1))
    offsets = torch.cat(offsets)
    assert offsets.unique().numel() == offsets.numel() and 0 <= offsets.min() and offsets.max() < weights.numel() - width
    padding = torch.ones(weights.numel() - width, dtype=torch.bool)
    padding[offsets] = False
    assert not weights[:-width][padding].any() and torch.equal(weights[-width:], packed["w_alpha"][:, 0].to(torch.bfloat16))

    # The kernel's forward: each slot's 64 x W matrix read through the
    # swizzle, A its columns of the bf16 activation tile or the encodings.
    r, c = torch.meshgrid(torch.arange(64), torch.arange(width), indexing="ij")
    slot_index = (c // 64) * 64 * 64 + fused_nerf.swizzled(r, c % 64)
    w = weights.float()
    enc = torch.zeros(40, 64)
    enc[:, :pe] = encoded.to(torch.bfloat16).float()
    act, s = None, 0
    for i in range(layers):
        h = biases[i * width : (i + 1) * width].expand(40, width).clone()
        for j, (first, rows) in enumerate(slots[i]):
            lhs = enc if i == 0 or first == width else act[:, first : first + 64]
            h += lhs @ w[s * slot_elems + slot_index]
            s += 1
        h = torch.relu(h)
        act = h.to(torch.bfloat16).float()
    alpha = act @ w[s * slot_elems :] + biases[layers * width]
    assert biases.numel() == layers * width + 1
    ref_h, ref_alpha = fused_nerf.plain_backbone_fwd(cfg, packed, encoded)
    torch.testing.assert_close(h, ref_h, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(alpha, ref_alpha, rtol=1e-4, atol=1e-4)

    grads, _ = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
    assert fused_nerf._backbone_grad_rows(cfg) == 64 * sum(map(len, slots))
    rows = []
    for i in range(layers):
        dw = grads[f"w{i}"]
        if i == 0:
            rows.append(fused_nerf._padded(dw, 64, width))
        elif i == skip:
            rows += [dw[:width], fused_nerf._padded(dw[width:], 64, width)]
        else:
            rows.append(dw)
    flat = torch.cat([torch.cat(rows).reshape(-1)] + [grads[f"b{i}"] for i in range(layers)]
                     + [grads["w_alpha"].reshape(-1), grads["b_alpha"]])
    unpacked = fused_nerf._unpack_backbone_grads(cfg, flat, pe)
    assert set(unpacked) == set(grads)
    for name, value in grads.items():
        assert torch.equal(unpacked[name].reshape(value.shape), value), name


@pytest.mark.parametrize("layers,width,skip,pe", LAYOUT_CASES)
@pytest.mark.parametrize("n", [37, 300])
def test_scratch_layouts(layers, width, skip, pe, n):
    """The backward's X and G scratch as the wrapper sizes it, addressed as
    the kernels address it (`scratch_offset`): every (point,
    feature) at a unique in-bounds offset, and the weight-gradient kernel's
    tiling (fused_nerf.backbone_x_columns, 64 padded rows per X block) over
    those blocks gives X_in^T G of every layer in the padded row order."""
    cfg = port_config.NerfMLPConfig(layers_width=width, backbone_layers_count=layers, skip_layer_idx=skip,
                                    compute_dtype="bfloat16", use_fused_backbone=True)
    shapes = fused_nerf.backbone_scratch_shapes(cfg, n, 132)
    points = shapes["x"][0] * 64
    assert points >= n and points % 128 == 0 and shapes["tile_part"][0] == 2 * min(points // 128, 132)
    assert fused_nerf.backbone_grid(n, 132) == shapes["tile_part"][0] // 2 and fused_nerf.backbone_grid(n, 2) == min(points // 128, 2)
    assert 1 <= shapes["partial"][0] <= shapes["x"][0]
    gen = torch.Generator().manual_seed(n)
    scratch, logical = {}, {}
    for name in ("x", "g"):
        columns = shapes[name][1]
        logical[name] = torch.randint(-4, 5, (points, columns * 64), generator=gen).float()  # exact sums
        p, f = torch.meshgrid(torch.arange(points), torch.arange(columns * 64), indexing="ij")
        off = scratch_offset(p, f // 64, f % 64, columns).reshape(-1)
        size = math.prod(shapes[name])
        assert off.unique().numel() == off.numel() == size and off.min() == 0 and off.max() == size - 1
        scratch[name] = torch.empty(size)
        scratch[name][off] = logical[name].reshape(-1)
    x_blocks = scratch["x"].reshape(shapes["x"])
    g_blocks = scratch["g"].reshape(shapes["g"])
    unswizzle = fused_nerf.swizzled(*torch.meshgrid(torch.arange(64), torch.arange(64), indexing="ij"))

    def block(blocks, column):  # (points, 64) logical values of one column block
        return blocks[:, column].reshape(-1, 64 * 64)[:, unswizzle.reshape(-1)].reshape(points, 64)

    nb = width // 64
    dw, start = torch.zeros(fused_nerf._backbone_grad_rows(cfg), width), 0
    for layer, columns in enumerate(fused_nerf.backbone_x_columns(cfg)):
        g = torch.cat([block(g_blocks, layer * nb + j) for j in range(nb)], dim=1)
        for b, column in enumerate(columns):
            dw[start + 64 * b : start + 64 * b + 64] = block(x_blocks, column).t() @ g
        x_in = (logical["x"][:, :64] if layer == 0 else
                logical["x"][:, 64 * (1 + (layer - 1) * nb) : 64 * (1 + layer * nb)])
        if layer == skip:
            x_in = torch.cat([x_in, logical["x"][:, :64]], dim=1)
        ref = x_in.t() @ logical["g"][:, layer * width : (layer + 1) * width]
        assert torch.equal(dw[start : start + ref.shape[0]], ref), layer
        start += 64 * len(columns)
    assert start == dw.shape[0]


def test_wrappers_reject_what_the_kernels_do_not_take():
    _, cfg = configs("bfloat16")
    packed, encoded, g_h, g_alpha = inputs(cfg, 8)
    meta = {k: torch.from_numpy(v).to("meta") for k, v in packed.items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_nerf.fused_backbone_fwd(cfg, meta, torch.from_numpy(encoded).to("meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_nerf.fused_backbone_bwd(cfg, meta, *(torch.from_numpy(x).to("meta") for x in (encoded, g_h, g_alpha)))
