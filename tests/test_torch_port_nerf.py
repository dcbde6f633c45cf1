"""The port's AdaIN-NeRF MLP module (ops/fused_nerf.py) against the JAX
package: the bf16-emulating plain version against JAX fused_adain_nerf
(interpret mode) and fused_object_field_eval at 5e-3 (identical bf16 operand
rounding, but another f32 summation order can flip an occasional bf16
rounding), the encoding and the modulation folding at 1e-5. The
kernel's swizzled weight image is checked on the CPU by reading it the way
csrc/fused_nerf.cu does; the kernel itself runs only on a card
(test_torch_port_cuda.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from playableenvironments_tpu.ops import fused_nerf as jax_fused
from playableenvironments_tpu_torch.config import NerfMLPConfig, PositionalEncoderConfig
from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP
from playableenvironments_tpu_torch.ops import fused_nerf
from test_torch_port_play import jax_variables, port_modules, scenes
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

BF16_TOL = dict(atol=5e-3, rtol=5e-3)
F32_TOL = dict(atol=1e-5, rtol=1e-5)
MODEL = 2  # a player: bent, 32 samples


@pytest.fixture(scope="module")
def setup():
    jscene, pscene = scenes()
    env, _ = jax_variables()
    composer, _, _ = port_modules()
    cfg = pscene.object_models[MODEL]
    return dict(
        jcfg=jscene.object_models[MODEL],
        cfg=cfg,
        params=env["params"]["composer"][f"object_model_{MODEL}"]["nerf"],
        stats=env["batch_stats"]["composer"][f"object_model_{MODEL}"]["nerf"],
        nerf=composer.object_model(MODEL).nerf,
    )


def inputs(setup, rays=24, samples=8, seed=0):
    rng = np.random.default_rng(seed)
    box = np.asarray(setup["cfg"].bounding_box, np.float32)
    positions = rng.uniform(box[:, 0] - 0.2, box[:, 1] + 0.2, (rays, samples, 3)).astype(np.float32)
    style = rng.normal(size=(rays, setup["cfg"].style_features)).astype(np.float32)
    return positions, style


def test_encoding_folded_modulation_and_packing_match(setup):
    positions, style = inputs(setup)
    jcfg, cfg = setup["jcfg"], setup["cfg"]
    pe = cfg.nerf.position_encoder
    box = np.asarray(cfg.bounding_box, np.float32)
    flat = positions.reshape(-1, 3) / (box[:, 1] - box[:, 0])
    jenc = jax_fused._positional_encoding(jnp.asarray(flat), pe.octaves, pe.append_original)
    from playableenvironments_tpu_torch.models.encoding import positional_encoding

    enc = positional_encoding(torch.from_numpy(flat), pe.octaves, pe.append_original)
    np.testing.assert_allclose(enc.numpy(), np.asarray(jenc), **F32_TOL)

    point_style = np.repeat(style, positions.shape[1], axis=0)
    jmods, mods = [], []
    for k in (0, 1):
        jmods += jax_fused.fold_adain_stats(
            setup["params"][f"adain_{k}"], setup["stats"][f"adain_{k}"], jnp.asarray(point_style)
        )
        with torch.no_grad():
            mods += fused_nerf.fold_adain_stats(getattr(setup["nerf"], f"adain_{k}"), torch.from_numpy(point_style))
    for m, jm in zip(mods, jmods):
        np.testing.assert_allclose(m.numpy(), np.asarray(jm), **F32_TOL)

    jpacked = jax_fused.pack_nerf_params(jcfg.nerf, setup["params"])
    packed = fused_nerf.pack_nerf_params(cfg.nerf, setup["nerf"])
    assert set(packed) == set(jpacked)
    for name, value in packed.items():
        np.testing.assert_array_equal(value.detach().numpy(), np.asarray(jpacked[name]), err_msg=name)


def test_plain_matches_jax_fused_kernel_in_interpret_mode(setup):
    """Per-ray modulation over 8 samples; JAX runs several blocks."""
    positions, style = inputs(setup)
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    samples = positions.shape[1]
    pe = cfg.nerf.position_encoder
    rng = np.random.default_rng(5)
    enc = rng.uniform(-1, 1, (positions.shape[0] * samples, 3 + 6 * pe.octaves)).astype(np.float32)
    jmods = [
        m for k in (0, 1)
        for m in jax_fused.fold_adain_stats(setup["params"][f"adain_{k}"], setup["stats"][f"adain_{k}"], jnp.asarray(style))
    ]
    ref = jax_fused.fused_adain_nerf(
        jcfg.nerf, jax_fused.pack_nerf_params(jcfg.nerf, setup["params"]), jnp.asarray(enc), *jmods,
        samples_per_ray=samples, block_points=64, interpret=True,
    )
    with torch.no_grad():
        got = fused_nerf.fused_adain_nerf(
            cfg.nerf, setup["nerf"].kernel_weights(), torch.from_numpy(enc),
            *(torch.from_numpy(np.array(m)) for m in jmods), samples_per_ray=samples,
        )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **BF16_TOL)


def test_object_field_eval_matches_jax(setup):
    positions, style = inputs(setup)
    cfg, jcfg = setup["cfg"], setup["jcfg"]
    ref = jax_fused.fused_object_field_eval(
        jcfg.nerf, jcfg.bounding_box, setup["params"], setup["stats"], jnp.asarray(positions),
        jnp.asarray(style)[:, None], jcfg.empty_space_alpha, block_points=64, interpret=True,
    )
    with torch.no_grad():
        got = fused_nerf.fused_object_field_eval(
            cfg.nerf, cfg.bounding_box, setup["nerf"], torch.from_numpy(positions),
            torch.from_numpy(style)[:, None], cfg.empty_space_alpha,
        )
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **BF16_TOL)
    outside = (got[1] == cfg.empty_space_alpha).numpy()
    assert outside.any() and not outside.all()


def _slot_element(slot_offset, k, n):
    """Element offset of (row k, column n) of a 64-row weight slot that
    starts `slot_offset` elements into the image: column block n // 64 of
    64 x 64, each row 128 bytes whose 16-byte chunks are XOR-ed with k % 8
    (the MN-major B operand of csrc/fused_nerf.cu's wgmma)."""
    return slot_offset + (n // 64) * 4096 + k * 64 + (((n % 64) // 8) ^ (k % 8)) * 8 + n % 8


def _read_image(image, cfg, pe, out):
    """Every weight matrix read back from B1's image with the slot offsets
    csrc/fused_nerf.cu streams (in elements): backbone slots of 64 W, then
    w_alpha (W), then W_f0's columns [0, W/2) and [W/2, W), each W/64 slots
    of 32 W, W_f1's W/64 slots of 32 W and W_out's W/128 slots of 64 NO, NO
    = out rounded up to 64. Returns ({name: (rows, columns) matrix, padding
    included}, elements read)."""
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, cfg.skip_layer_idx
    nb, no = width // 64, -(-out // 64) * 64
    k = torch.arange(64)[:, None]

    def slot(offset, cols):
        return image[_slot_element(offset, k, torch.arange(cols)[None, :])]

    mats, offset = {}, 0
    for i in range(layers):
        slots = 1 if i == 0 else nb + (i == skip)
        mats[f"w{i}"] = torch.cat([slot(offset + j * 64 * width, width) for j in range(slots)])
        offset += slots * 64 * width
    mats["w_alpha"] = image[offset : offset + width].reshape(width, 1)
    offset += width
    for name, slots, cols in (("w_f0_lo", nb, width // 2), ("w_f0_hi", nb, width // 2), ("w_f1", nb, width // 2),
                              ("w_out", nb // 2, no)):
        mats[name] = torch.cat([slot(offset + j * 64 * cols, cols) for j in range(slots)])
        offset += slots * 64 * cols
    mats["w_f0"] = torch.cat([mats.pop("w_f0_lo"), mats.pop("w_f0_hi")], dim=1)
    return mats, offset


@pytest.mark.parametrize("shape", [(3, 128, 2, 21, 24), (8, 256, 4, 63, 192), (5, 256, 9, 27, 40),
                                   (6, 128, 3, 63, 250)])
def test_kernel_weight_layout(shape):
    """Layers, width, skip, encoding width, outputs: B1's weight image, read
    back element by element with the kernel's slot and swizzle arithmetic,
    holds exactly the bf16 weights, zero where the kernel pads (the
    encoding rows to 64, W_out's columns to a multiple of 64), and nothing
    else."""
    layers, width, skip, pe, out = shape
    octaves = (pe - 3) // 6
    cfg = NerfMLPConfig(
        layers_width=width, backbone_layers_count=layers, output_features=out, skip_layer_idx=skip,
        position_encoder=PositionalEncoderConfig(octaves=octaves),
    )
    nerf = initialize_(AdaInNerfMLP(cfg, 8, device="cpu"), torch.Generator().manual_seed(1))
    weights = nerf.kernel_weights()
    mats, used = _read_image(weights.image, cfg, pe, out)
    assert used == weights.image.numel()
    assert weights.image.dtype == torch.bfloat16
    for name, got in mats.items():
        want = weights.packed[name].to(torch.bfloat16)
        if name == "w0" or (name == f"w{skip}" and skip < layers):
            # The encoding's rows, zero-padded to 64.
            h = 0 if name == "w0" else width
            want = torch.cat([want[:h], want[h:], want.new_zeros(64 - pe, width)])
        elif name == "w_out":
            want = torch.cat([want, want.new_zeros(width // 2, got.shape[1] - out)], dim=1)
        assert torch.equal(got, want), name
    biases = torch.cat([weights.packed[f"b{i}"] for i in range(layers)]
                       + [weights.packed["b_alpha"], weights.packed["b_out"]])
    assert torch.equal(weights.biases, biases)


def test_kernel_weights_follow_parameter_updates(setup):
    nerf = AdaInNerfMLP(setup["cfg"].nerf, setup["cfg"].style_features, device="cpu")
    first = nerf.kernel_weights()
    assert nerf.kernel_weights() is first
    state = nerf.state_dict()
    state["feat_out.bias"] = state["feat_out.bias"] + 1.0
    nerf.load_state_dict(state)
    second = nerf.kernel_weights()
    assert second is not first
    assert torch.equal(second.biases[-second.packed["b_out"].numel():], state["feat_out.bias"])


def test_wrapper_rejects_what_the_kernel_does_not_take(setup):
    cfg = setup["cfg"].nerf
    weights = setup["nerf"].kernel_weights()
    pe = weights.pe
    w = cfg.layers_width
    enc = torch.zeros(8, pe)
    good = [torch.zeros(2, w), torch.zeros(2, w), torch.zeros(2, w // 2), torch.zeros(2, w // 2)]
    fused_nerf.fused_adain_nerf(cfg, weights, enc, *good, samples_per_ray=4)
    with pytest.raises(ValueError, match="not divisible"):
        fused_nerf.fused_adain_nerf(cfg, weights, enc, *good, samples_per_ray=3)
    with pytest.raises(ValueError, match="scale1"):
        fused_nerf.fused_adain_nerf(cfg, weights, enc, *good[:2], torch.zeros(2, w), good[3], samples_per_ray=4)
    with pytest.raises(ValueError, match="encoding width"):
        fused_nerf.fused_adain_nerf(cfg, weights, torch.zeros(8, pe + 1), *good, samples_per_ray=4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_nerf.fused_adain_nerf(cfg, weights, enc.to("meta"), *(m.to("meta") for m in good), samples_per_ray=4)
    for bad in (dict(skip_layer_idx=0), dict(position_encoder=PositionalEncoderConfig(octaves=11)),
                dict(output_features=257)):
        bad_cfg = NerfMLPConfig(**{**dict(layers_width=128, backbone_layers_count=3, output_features=8,
                                          skip_layer_idx=1), **bad})
        with pytest.raises(ValueError):
            AdaInNerfMLP(bad_cfg, 4, device="cpu").kernel_weights()
    # The image's feature-head slots take W 128 or 256; other widths run only
    # the plain version (on the CPU) and have no image.
    assert weights.image is None and cfg.layers_width not in (128, 256)
    for width in (48, 64, 192, 512):
        narrow = NerfMLPConfig(layers_width=width, backbone_layers_count=3, output_features=8, skip_layer_idx=1)
        nerf = AdaInNerfMLP(narrow, 4, device="cpu")
        assert nerf.kernel_weights().image is None
        with pytest.raises(ValueError, match="takes"):
            fused_nerf.adain_image(narrow, fused_nerf.pack_nerf_params(narrow, nerf))
