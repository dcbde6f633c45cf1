"""The port's AdaIN-NeRF MLP module (ops/fused_nerf.py) against the JAX
package: the bf16-emulating plain version against JAX fused_adain_nerf
(interpret mode) and fused_object_field_eval at 5e-3 (identical bf16 operand
rounding, but another f32 summation order can flip an occasional bf16
rounding), the encoding and the modulation folding at 1e-5. The
kernel's flat weight layout is checked on the CPU by reading it the way
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


def _kernel_on_cpu(weights, cfg, encoded, mods, samples):
    """The kernel's arithmetic read from its flat buffers with the offsets
    csrc/fused_nerf.cu walks (padded K, encoding at columns [W, W + pe_pad)),
    in torch on the CPU."""
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, cfg.skip_layer_idx
    n, pe = encoded.shape
    pe_pad = (pe + 15) // 16 * 16
    out = weights.packed["w_out"].shape[1]
    out_pad = (out + 15) // 16 * 16
    w = weights.weights.float()
    b = weights.biases
    a = torch.zeros(n, width + pe_pad)
    a[:, width : width + pe] = encoded.to(torch.bfloat16).float()
    wo = bo = 0

    def take(k, cols):
        nonlocal wo
        m = w[wo : wo + k * cols].reshape(k, cols)
        wo += k * cols
        return m

    for i in range(layers):
        k = pe_pad if i == 0 else (width + pe_pad if i == skip else width)
        lhs = a[:, width : width + pe_pad] if i == 0 else a[:, :k]
        a[:, :width] = torch.relu(lhs @ take(k, width) + b[bo : bo + width]).to(torch.bfloat16).float()
        bo += width
    alpha = a[:, :width] @ take(1, width)[0] + b[bo]
    bo += 1
    per_point = [m.repeat_interleave(samples, dim=0) for m in mods]
    f = torch.relu((a[:, :width] @ take(width, width)) * per_point[0] + per_point[1])
    f = torch.relu((f.to(torch.bfloat16).float() @ take(width, width // 2)) * per_point[2] + per_point[3])
    features = f.to(torch.bfloat16).float() @ take(width // 2, out_pad)
    assert wo == w.numel()
    return features[:, :out] + b[bo:], alpha


@pytest.mark.parametrize("shape", [(3, 32, 2, 21, 24), (8, 256, 4, 63, 192), (5, 64, 9, 27, 40)])
def test_kernel_weight_layout(shape):
    """Layers, width, skip, encoding width, outputs: the flat buffers hold
    exactly the weights, zero-padded where the kernel pads."""
    layers, width, skip, pe, out = shape
    octaves = (pe - 3) // 6
    cfg = NerfMLPConfig(
        layers_width=width, backbone_layers_count=layers, output_features=out, skip_layer_idx=skip,
        position_encoder=PositionalEncoderConfig(octaves=octaves),
    )
    nerf = initialize_(AdaInNerfMLP(cfg, 8, device="cpu"), torch.Generator().manual_seed(1))
    weights = nerf.kernel_weights()
    g = torch.Generator().manual_seed(2)
    samples, rays = 4, 5
    encoded = torch.rand(rays * samples, pe, generator=g) * 2 - 1
    mods = [torch.randn(rays, c, generator=g) for c in (width, width, width // 2, width // 2)]
    with torch.no_grad():
        plain = fused_nerf.plain_adain_nerf(cfg, weights.packed, encoded, *mods, samples)
        emulated = _kernel_on_cpu(weights, cfg, encoded, mods, samples)
    for e, p in zip(emulated, plain):
        np.testing.assert_allclose(e.numpy(), p.numpy(), atol=1e-4, rtol=1e-4)


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
    for bad in (dict(layers_width=48), dict(layers_width=512), dict(skip_layer_idx=0),
                dict(position_encoder=PositionalEncoderConfig(octaves=11))):
        bad_cfg = NerfMLPConfig(**{**dict(layers_width=32, backbone_layers_count=3, output_features=8,
                                          skip_layer_idx=1), **bad})
        with pytest.raises(ValueError):
            AdaInNerfMLP(bad_cfg, 4, device="cpu").kernel_weights()
