"""The kernels' wrappers at the narrow widths the Pallas kernels take and
the port's kernels take only zero-padded (ops/fused_nerf.py::padded_weights,
ops/fused_rollout.py::padded_params): B1 at W 32 (run at 128) and 192 (at
256), B2/B3 at W 32 (bf16 and f32 at 64) and 96, B4/B5 at F 16 (at 32),
configs/synthetic_smoke.yaml's widths.

- The padded plain computations against the unpadded ones: outputs within
  1e-6 of each output's largest magnitude (the same f32 products, the
  padded ones exactly 0, summed in another order), the padded units' own
  outputs exactly 0, gradients cut back to the parameters' shapes within the
  same bound, through the same pad-run-cut code the card's wrappers run
  (`padded_backbone_fwd`/`_bwd`, `padded_rollout_fwd`/`_bwd`) with the plain
  versions in place of the launches.
- The padded weight images read through the layout copies of
  test_torch_port_nerf.py (B1), test_torch_port_backbone.py (bf16 B2/B3),
  test_torch_port_backbone_f32.py (f32 B2/B3) and
  test_torch_port_rollout_layout.py (B4/B5): every weight where the kernels
  read it, zeros in the padding.
- The JAX package's Pallas kernels in interpret mode at W 32 and F 16
  against the port's padded plain versions, at the tolerances of
  test_torch_port_nerf.py (bf16 operands: 5e-3), test_torch_port_backbone.py
  (f32 1e-5, bf16 5e-3 of each output's largest magnitude) and
  test_torch_port_rollout.py (2e-5 values, 5e-4 + 1e-3 |ref| gradients).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.config import NerfMLPConfig as JaxNerfMLPConfig
from playableenvironments_tpu.config import PositionalEncoderConfig as JaxPositionalEncoderConfig
from playableenvironments_tpu.ops import fused_nerf as jax_fused
from playableenvironments_tpu.ops import fused_rollout_pallas
from playableenvironments_tpu_torch.config import NerfMLPConfig, PositionalEncoderConfig
from playableenvironments_tpu_torch.ops import fused_nerf
from playableenvironments_tpu_torch.ops import fused_rollout as fr
from test_torch_port_backbone import configs as backbone_configs
from test_torch_port_backbone import inputs as backbone_inputs
from test_torch_port_backbone import relative_close, weight_offset
from test_torch_port_backbone_f32 import in_pad, rows_before, slot_matrix
from test_torch_port_nerf import _read_image
from test_torch_port_rollout import (CASES, FAST_COMPILE, GRADS, VALUES, case, check_grads, close, port_cfg,
                                     port_params, t)
from test_torch_port_rollout_layout import check_image, random_params
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

EXACT = 1e-6  # of each output's largest magnitude


def near(got, ref, name):
    got, ref = got.detach().double(), ref.detach().double().reshape(got.shape)
    scale = ref.abs().max().item()
    assert (got - ref).abs().max().item() <= EXACT * max(scale, 1e-30), name


def nerf_case(width, layers=3, skip=1, octaves=4, out=3, rays=24, samples=4, seed=0):
    """A seeded AdaIN-NeRF MLP in the packed layout and its per-ray inputs."""
    cfg = NerfMLPConfig(layers_width=width, backbone_layers_count=layers, skip_layer_idx=skip, output_features=out,
                        position_encoder=PositionalEncoderConfig(octaves=octaves))
    pe = 3 + 6 * octaves
    rng = np.random.default_rng(seed)

    def normal(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32))

    packed = {}
    for i, w_in in enumerate(fused_nerf._backbone_sizes(cfg, pe)):
        packed[f"w{i}"] = normal(w_in, width, scale=w_in ** -0.5)
        packed[f"b{i}"] = normal(width, scale=0.1)
    packed.update(w_alpha=normal(width, 1, scale=0.2), b_alpha=normal(1, scale=0.1),
                  w_f0=normal(width, width, scale=width ** -0.5), w_f1=normal(width, width // 2, scale=width ** -0.5),
                  w_out=normal(width // 2, out, scale=0.3), b_out=normal(out, scale=0.1))
    encoded = torch.from_numpy(rng.uniform(-1, 1, (rays * samples, pe)).astype(np.float32))
    mods = [normal(rays, c, scale=0.5) for c in (width, width, width // 2, width // 2)]
    return cfg, packed, encoded, mods, samples


# ---------------------------------------------------------------------------
# B1
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("width,kernel", [(32, 128), (192, 256)])
def test_padded_adain_mlp_equals_the_unpadded_one(width, kernel):
    cfg, packed, encoded, mods, samples = nerf_case(width)
    assert fused_nerf.adain_kernel_width(width) == kernel
    kcfg, kpacked = fused_nerf.padded_weights(cfg, packed, kernel)
    item = fused_nerf.padded_modulation(
        fused_nerf.AdaInNerfItem(None, encoded, *mods, samples), kernel)
    assert item.scale0.shape[1] == kernel and item.bias1.shape[1] == kernel // 2
    with torch.no_grad():
        ref = fused_nerf.plain_adain_nerf(cfg, packed, encoded, *mods, samples)
        got = fused_nerf.plain_adain_nerf(kcfg, kpacked, encoded, *item[2:6], samples)
    for name, g, r in zip(("features", "alpha"), got, ref):
        assert g.shape == r.shape
        near(g, r, name)
    for name, value in packed.items():  # the same weights, zeros around them
        assert int((kpacked[name] != 0).sum()) == int((value != 0).sum()), name


def test_padded_adain_image_reads_back_through_the_kernels_layout():
    """W 32 built at 128: test_kernel_weight_layout's reading of B1's image
    gives the 32-wide weights in the top-left corners (the skip layer's
    encoding rows after 128 zero-padded h rows) and zeros elsewhere; the
    biases as the kernel's weights carry them on the card."""
    cfg, packed, _, _, _ = nerf_case(32, layers=4, skip=2, octaves=3, out=24)
    pe, kernel = packed["w0"].shape[0], 128
    image = fused_nerf.adain_image(cfg, packed)
    mats, used = _read_image(image, dataclasses.replace(cfg, layers_width=kernel), pe, 24)
    assert used == image.numel()
    for name, got in mats.items():
        w = packed[name].to(torch.bfloat16)
        want = torch.zeros_like(got)
        if name == "w2":  # the skip layer: h's 32 rows, then the encoding's after row 128
            want[:32, :32] = w[:32]
            want[kernel : kernel + pe, :32] = w[32:]
        else:
            want[: w.shape[0], : w.shape[1]] = w
        assert torch.equal(got, want), name
    # The card's kernel_weights pads the biases with the image.
    _, kpacked = fused_nerf.padded_weights(cfg, packed, kernel)
    assert torch.equal(kpacked["b1"][:32], packed["b1"]) and not kpacked["b1"][32:].any()


def test_b1_pallas_kernel_at_width_32_matches_the_padded_plain_version():
    """The JAX kernel in interpret mode at W 32 (whole weights of any
    width) against the port's plain version at 128 on the padded weights
    (bf16 operands: 5e-3, as test_torch_port_nerf.py)."""
    cfg, packed, encoded, mods, samples = nerf_case(32, rays=16, samples=8, seed=3)
    jcfg = JaxNerfMLPConfig(layers_width=32, backbone_layers_count=3, skip_layer_idx=1, output_features=3,
                            position_encoder=JaxPositionalEncoderConfig(octaves=4))
    ref = jax_fused.fused_adain_nerf(jcfg, {k: jnp.asarray(v.numpy()) for k, v in packed.items()},
                                     jnp.asarray(encoded.numpy()), *(jnp.asarray(m.numpy()) for m in mods),
                                     samples_per_ray=samples, block_points=64, interpret=True)
    kcfg, kpacked = fused_nerf.padded_weights(cfg, packed, 128)
    item = fused_nerf.padded_modulation(fused_nerf.AdaInNerfItem(None, encoded, *mods, samples), 128)
    with torch.no_grad():
        got = fused_nerf.plain_adain_nerf(kcfg, kpacked, encoded, *item[2:6], samples)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), atol=5e-3, rtol=5e-3)


# ---------------------------------------------------------------------------
# B2/B3
# ---------------------------------------------------------------------------


def backbone_case(width, compute_dtype, n=300, seed=0):
    cfg = NerfMLPConfig(layers_width=width, backbone_layers_count=4, skip_layer_idx=2, output_features=3,
                        compute_dtype=compute_dtype, use_fused_backbone=True,
                        position_encoder=PositionalEncoderConfig(octaves=2))
    packed, encoded, g_h, g_alpha = backbone_inputs(cfg, n, seed=seed)
    return (cfg, {k: torch.from_numpy(v) for k, v in packed.items()},
            *(torch.from_numpy(np.asarray(x)) for x in (encoded, g_h, g_alpha)))


@pytest.mark.parametrize("compute_dtype,width,kernel", [("bfloat16", 32, 64), ("float32", 32, 64),
                                                        ("bfloat16", 96, 128), ("float32", 160, 256)])
def test_padded_backbone_and_its_backward_equal_the_unpadded_ones(compute_dtype, width, kernel):
    cfg, packed, encoded, g_h, g_alpha = backbone_case(width, compute_dtype)
    kcfg, kpacked = fused_nerf.kernel_backbone(cfg, packed)
    assert kcfg.layers_width == fused_nerf.backbone_kernel_width(cfg) == kernel
    h_padded, _ = fused_nerf.plain_backbone_fwd(kcfg, kpacked, encoded)
    assert not h_padded[:, width:].any()  # the padded units' ReLU outputs are exactly 0
    got = fused_nerf.padded_backbone_fwd(cfg, packed, encoded, fused_nerf.plain_backbone_fwd)
    for name, g, r in zip(("h", "alpha"), got, fused_nerf.plain_backbone_fwd(cfg, packed, encoded)):
        assert g.shape == r.shape
        near(g, r, name)
    grads, d_encoded = fused_nerf.padded_backbone_bwd(cfg, packed, encoded, g_h, g_alpha,
                                                      fused_nerf.plain_backbone_bwd)
    ref_grads, ref_d_encoded = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
    near(d_encoded, ref_d_encoded, "d_encoded")
    assert set(grads) == set(ref_grads)
    for name, ref in ref_grads.items():
        assert grads[name].shape == ref.shape, name
        near(grads[name], ref, name)


def test_padded_bf16_backbone_image_reads_back_through_the_kernels_layout():
    """W 32 built at 64: each 32-wide weight at the offset
    csrc/fused_backbone.cu reads it from at width 64 (test_kernel_layouts'
    `weight_offset`), every other element of the image zero."""
    cfg, packed, _, _, _ = backbone_case(32, "bfloat16")
    weights, biases = fused_nerf.backbone_buffers(cfg, packed)
    kcfg = dataclasses.replace(cfg, layers_width=64)
    assert weights.numel() == sum(map(len, fused_nerf._layer_slots(kcfg))) * 64 * 64 + 64
    seen = torch.zeros(weights.numel(), dtype=torch.bool)
    for i in range(cfg.backbone_layers_count):
        w = packed[f"w{i}"]
        row, col = torch.meshgrid(torch.arange(w.shape[0]), torch.arange(32), indexing="ij")
        padded_row = torch.where(row >= 32, row + 32, row) if i == cfg.skip_layer_idx else row
        off = weight_offset(kcfg, i, padded_row, col)
        assert torch.equal(weights[off], w.to(torch.bfloat16)), i
        seen[off.reshape(-1)] = True
    seen[-64:-32] = True
    assert torch.equal(weights[-64:-32], packed["w_alpha"][:, 0].to(torch.bfloat16))
    assert not weights[~seen].any()
    assert biases.numel() == 4 * 64 + 1 and not biases[32:64].any() and torch.equal(biases[:32], packed["b0"])


def test_padded_f32_backbone_images_read_back_through_the_kernels_layout():
    """W 32 built at 64 (plain_backbone_f32_buffers, the card's pack
    kernel's plain version): each forward slot, read as the tensor cores
    read B, holds the padded weight's 3xTF32 halves, whose first 32 columns
    are the weight's own split and the rest zero."""
    cfg, packed, _, _, _ = backbone_case(32, "float32")
    buffers = fused_nerf.plain_backbone_f32_buffers(cfg, packed)
    width, layers, skip = 64, cfg.backbone_layers_count, cfg.skip_layer_idx
    assert buffers.fwd.numel() == 2 * rows_before(layers, width, skip) * width
    order = torch.tensor(tuple(2 * (k % 4) + k // 4 for k in range(8)))
    kcfg, kpacked = fused_nerf.kernel_backbone(cfg, packed)
    for i, w in enumerate(fused_nerf.backbone_f32_weights(kcfg, kpacked)):
        own = packed[f"w{i}"]
        h_rows = 0 if i == 0 else 32
        assert torch.equal(w[:h_rows, :32], own[:h_rows]) and not w[:, 32:].any() and not w[h_rows:64 if i else 0].any()
        enc_first = 0 if i == 0 else 64
        if i in (0, skip):
            assert torch.equal(w[enc_first : enc_first + own.shape[0] - h_rows, :32], own[h_rows:])
        big_ref, small_ref = fused_nerf.tf32_split(w)
        base = 2 * width * rows_before(i, width, skip)
        for s in range(in_pad(i, width, skip) // 8):
            big, small = slot_matrix(buffers.fwd, base + s * 16 * width, width)
            assert torch.equal(big, big_ref[8 * s + order]) and torch.equal(small, small_ref[8 * s + order]), (i, s)
    assert torch.equal(buffers.w_alpha[:32], packed["w_alpha"].reshape(-1)) and not buffers.w_alpha[32:].any()


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 5e-3)])
def test_backbone_pallas_kernels_at_width_32_match_the_padded_plain_versions(compute_dtype, tol):
    """The JAX package's custom-VJP fused_backbone (forward and backward
    Pallas kernels in interpret mode) at W 32 against the port's plain
    versions run at 64 through padded_backbone_fwd/_bwd."""
    jcfg, cfg = backbone_configs(compute_dtype)
    assert cfg.layers_width == 32
    packed, encoded, g_h, g_alpha = backbone_inputs(cfg, 200, seed=4)
    jpacked = {k: jnp.asarray(v) for k, v in packed.items()}
    (jh, ja), vjp = jax.vjp(lambda p, e: jax_fused.fused_backbone(jcfg, p, e, 128, True), jpacked,
                            jnp.asarray(encoded))
    jd_packed, jd_encoded = vjp((jnp.asarray(g_h), jnp.asarray(g_alpha)))
    tpacked = {k: torch.from_numpy(v) for k, v in packed.items()}
    h, alpha = fused_nerf.padded_backbone_fwd(cfg, tpacked, torch.from_numpy(encoded), fused_nerf.plain_backbone_fwd)
    grads, d_encoded = fused_nerf.padded_backbone_bwd(cfg, tpacked, torch.from_numpy(encoded), torch.from_numpy(g_h),
                                                      torch.from_numpy(g_alpha), fused_nerf.plain_backbone_bwd)
    relative_close(h, jh, tol, "h")
    relative_close(alpha, ja, tol, "alpha")
    relative_close(d_encoded, jd_encoded, tol, "d_encoded")
    for name, value in grads.items():
        relative_close(value.reshape(packed[name].shape), jd_packed[name], tol, name)


# ---------------------------------------------------------------------------
# B4/B5
# ---------------------------------------------------------------------------


def plain_fwd(cfg, params, inputs, gt_count, collect):
    return fr.plain_rollout_fwd(cfg, params, *inputs, gt_count, collect)


def plain_bwd(cfg, params, gt_count, residuals, cotangents, actions_dim):
    return fr.plain_rollout_bwd(cfg, params, gt_count, residuals, cotangents, actions_dim)


@pytest.mark.parametrize("features,layers", [(16, 1), (16, 2), (40, 2)])
def test_padded_rollout_and_its_backward_equal_the_unpadded_ones(features, layers):
    S, D, A, V, batch, T, gt = 8, 4, 4, 3, 3, 6, 2
    params = random_params(features, layers, S, D, A, V, seed=features + layers)
    cfg = fr.RolloutConfig(1, False, None, (1.5, 1.0, 2.15))
    g = torch.Generator().manual_seed(7)
    inputs = [torch.randn(batch, T, w, generator=g) * 0.5 for w in (3, 3, S, D)]
    inputs += [torch.randn(batch, T - 1, w, generator=g) for w in (A, V)]
    cots = [torch.randn(batch, T, w, generator=g) for w in (3, 3, S, D)]
    padded = fr.kernel_features(features)
    assert padded == -(-features // 32) * 32

    out, res = fr.padded_rollout_fwd(cfg, params, inputs, gt, True, plain_fwd)
    ref_out, ref_res = fr.plain_rollout_fwd(cfg, params, *inputs, gt, True)
    for k, (o, r) in enumerate(zip(out, ref_out)):
        near(o, r, f"output {k}")
    assert set(res) == set(ref_res)
    for key, r in ref_res.items():
        assert res[key].shape == r.shape, key
        near(res[key], r, key)
    # The padded units' residuals as padded_residuals fills them: what the
    # padded forward computes there, exactly.
    _, full = fr.plain_rollout_fwd(cfg, fr.padded_params(params, padded), *inputs, gt, True)
    refilled = fr.padded_residuals(fr.unpadded_residuals(full, features, padded), features, padded)
    for key, value in full.items():
        assert torch.equal(refilled[key], value), key

    grads = fr.padded_rollout_bwd(cfg, params, gt, ref_res, cots, A, plain_bwd)
    ref_grads = fr.plain_rollout_bwd(cfg, params, gt, ref_res, cots, A)
    for name, got, ref in zip(fr.PackedParams._fields, grads[0], ref_grads[0]):
        for k, (gg, rr) in enumerate(zip(got, ref) if isinstance(got, tuple) else [(got, ref)]):
            assert gg.shape == rr.shape, name
            near(gg, rr, f"{name}[{k}]")
    for k, (got, ref) in enumerate(zip(grads[1:], ref_grads[1:])):
        near(got, ref, f"input gradient {k}")


def test_padded_rollout_images_read_back_through_the_kernels_index_arithmetic():
    """F 16 at 32 (8-CTA clusters of 4 units): the forward and backward
    images of the padded parameters, read through the kernels' index
    arithmetic (test_torch_port_rollout_layout.py's `check_image`), hold
    every padded weight once; the 16-wide network's own weights sit in each
    gate block's first 16 columns."""
    S, D, A, V = 8, 4, 4, 3
    params = random_params(16, 2, S, D, A, V, seed=3)
    padded = fr.padded_params(params, 32)
    layout = fr.rollout_layout(32, 2, 9 + S + D + A + V, 9 + S + D)
    assert layout.cluster == 8 and layout.units == 4
    for fwd in (True, False):
        image = fr.rollout_fwd_image(padded, layout)[0] if fwd else fr.rollout_bwd_image(padded, layout)
        seen = check_image(layout, padded, image, fwd)
        for w in list(padded.wx) + list(padded.wh) + [padded.wb, padded.whead]:
            assert torch.equal(seen[id(w)], torch.ones_like(seen[id(w)]))
    for own, wide in zip(params.wh, padded.wh):
        blocks = wide.reshape(32, 4, 32)
        assert torch.equal(blocks[:16, :, :16], own.reshape(16, 4, 16)) and not blocks[16:].any()
        assert not blocks[:, :, 16:].any()


def test_rollout_pallas_kernels_at_features_16_match_the_padded_plain_versions():
    """fused_rollout_pallas.forward/backward in interpret mode at F 16
    (test_torch_port_rollout.py's case) against the port's plain versions
    run at 32 through padded_rollout_fwd/_bwd."""
    force_rot, force_z, axis, gt_count = CASES[0]
    _, cfg, packed, inputs, cots, _, _, _ = case(force_rot, force_z, axis, gt_count, seed=5)
    assert packed.wb.shape[0] == 16

    @functools.partial(jax.jit, static_argnums=(0,), compiler_options=FAST_COMPILE)
    def run(cfg, packed, inputs, gt, cots):
        out, res = fused_rollout_pallas.forward(cfg, packed, *inputs, gt, True)
        return out, res, fused_rollout_pallas.backward(cfg, packed, *inputs, gt, res, cots)

    out, pres, jgrads = jax.device_get(run(cfg, packed, inputs, jnp.asarray(gt_count), cots))
    params = port_params(packed)
    got, got_res = fr.padded_rollout_fwd(port_cfg(cfg), params, [t(x) for x in inputs], gt_count, True, plain_fwd)
    for name, g, r in zip(("rot", "trans", "style", "deform"), got, out):
        close(g, r, VALUES, name)
    for name in pres:
        close(got_res[name], pres[name], VALUES, name)
    grads = fr.padded_rollout_bwd(port_cfg(cfg), params, gt_count, {k: t(v) for k, v in pres.items()},
                                  [t(c) for c in cots], inputs[4].shape[-1], plain_bwd)
    check_grads(grads, jgrads, GRADS)
