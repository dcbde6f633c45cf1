"""The f32 backbone kernels' layouts and wiring, on the CPU (the kernels,
csrc/fused_backbone_f32.cu, run only on the card; tests/test_torch_port_cuda.py
and chip_smoke.py phase 14a hold them against the plain versions there).

- The weight images (`backbone_f32_buffers`) read through a Python copy of
  the kernels' layer offsets: each layer's padded weight, its transpose
  at the same offset, w_alpha and the biases, exactly.
- The backward's scratch and row blocks: X and G of a point as the tile
  kernel writes them, read back through the weight-gradient kernel's row
  block table (`backbone_f32_row_blocks`) and summed over splits and
  chunks of points as the kernels do, then unpacked as the wrapper does,
  against `plain_backbone_bwd`, in float64 at 1e-10.
- The wiring: with the launches replaced by stubs, the autograd Function
  keeps the f32 encodings for an f32 configuration (their bf16 rounding for
  bf16 operands), and a tensor off the CPU with an f32 configuration
  reaches the f32 wrappers.
"""

import numpy as np
import pytest
import torch

from playableenvironments_tpu_torch.config import NerfMLPConfig, PositionalEncoderConfig
from playableenvironments_tpu_torch.models.encoding import positional_encoding
from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP
from playableenvironments_tpu_torch.ops import fused_nerf

CONFIGS = {
    "tennis": NerfMLPConfig(layers_width=256, backbone_layers_count=8, skip_layer_idx=4, output_features=3,
                            compute_dtype="float32", position_encoder=PositionalEncoderConfig(octaves=10)),
    "narrow": NerfMLPConfig(layers_width=128, backbone_layers_count=6, skip_layer_idx=3, output_features=3,
                            compute_dtype="float32", position_encoder=PositionalEncoderConfig(octaves=10)),
    "no_skip": NerfMLPConfig(layers_width=64, backbone_layers_count=4, skip_layer_idx=0, output_features=3,
                             compute_dtype="float32", position_encoder=PositionalEncoderConfig(octaves=4)),
}
PE = 64  # the kernels' padded encoding (kPe)


def packed_weights(cfg, dtype=torch.float32, seed=0):
    nerf = initialize_(AdaInNerfMLP(cfg, 8, device="cpu"), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for i in range(cfg.backbone_layers_count):
            getattr(nerf, f"backbone_{i}").bias.copy_(torch.randn(cfg.layers_width, generator=g) * 0.1)
    return {k: v.detach().to(dtype).contiguous() for k, v in nerf.backbone_params().items()}


def kernel_skip(cfg):
    return cfg.skip_layer_idx or cfg.backbone_layers_count


def rows_of(layer, width, skip):
    """csrc/fused_backbone_f32.cu::rows_of."""
    return PE if layer == 0 else (width + PE if layer == skip else width)


def layer_offset(layer, width, skip):
    """csrc/fused_backbone_f32.cu::layer_offset."""
    return sum(rows_of(i, width, skip) * width for i in range(layer))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_weight_images_follow_the_kernel_layout(name):
    cfg = CONFIGS[name]
    packed = packed_weights(cfg)
    fwd, bwd, biases = fused_nerf.backbone_f32_buffers(cfg, packed)
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, kernel_skip(cfg)
    for i in range(layers):
        rows = rows_of(i, width, skip)
        block = fwd[layer_offset(i, width, skip):][: rows * width].reshape(rows, width)
        w = packed[f"w{i}"]
        if i == 0:
            expected = torch.cat([w, torch.zeros(PE - w.shape[0], width)])
        elif i == skip:
            enc = w[width:]
            expected = torch.cat([w[:width], enc, torch.zeros(PE - enc.shape[0], width)])
        else:
            expected = w
        assert torch.equal(block, expected), i
        transposed = bwd[layer_offset(i, width, skip):][: rows * width].reshape(width, rows)
        assert torch.equal(transposed, expected.t()), i
    end = layer_offset(layers, width, skip)
    assert fwd.numel() == end + width and bwd.numel() == end
    assert torch.equal(fwd[end:], packed["w_alpha"].reshape(-1))
    assert torch.equal(biases, torch.cat([packed[f"b{i}"] for i in range(layers)] + [packed["b_alpha"]]))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_weight_gradient_blocks_read_the_scratch_layout(name):
    """X and G as the tile kernel stores them, dW as the weight-gradient
    kernel forms it from the row block table over splits of chunks of
    points, the small sums as the reduction adds them: the wrapper's unpack
    of that gives plain_backbone_bwd's gradients."""
    cfg = CONFIGS[name]
    width, layers = cfg.layers_width, cfg.backbone_layers_count
    packed = packed_weights(cfg, torch.float64)
    g = torch.Generator().manual_seed(3)
    n = 150
    octaves = cfg.position_encoder.octaves
    encoded = positional_encoding(torch.rand(n, 3, generator=g) * 2 - 1, octaves, True).double()
    pe = encoded.shape[1]
    g_h = torch.randn(n, width, generator=g, dtype=torch.float64)
    g_alpha = torch.randn(n, generator=g, dtype=torch.float64)
    ref_grads, _ = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)

    # The tile kernel's view: activations and masked cotangents.
    acts, h = [], encoded
    for i in range(layers):
        if i == cfg.skip_layer_idx and i != 0:
            h = torch.cat([h, encoded], dim=-1)
        h = torch.relu(h @ packed[f"w{i}"] + packed[f"b{i}"])
        acts.append(h)
    cotangents = [None] * layers
    grad = g_h + g_alpha[:, None] * packed["w_alpha"][:, 0]
    for i in range(layers - 1, -1, -1):
        grad = grad * (acts[i] > 0)
        cotangents[i] = grad
        grad_in = grad @ packed[f"w{i}"].t()
        grad = grad_in[:, :width]
    shapes = fused_nerf.backbone_f32_scratch_shapes(cfg, n, sm_count=4)
    x_ld, g_ld = shapes["x"][1], shapes["g"][1]
    assert x_ld == PE + (layers - 1) * width and g_ld == layers * width + PE
    x = torch.zeros(n, x_ld, dtype=torch.float64)
    x[:, :pe] = encoded
    for i in range(layers - 1):
        x[:, PE + i * width : PE + (i + 1) * width] = acts[i]
    gs = torch.zeros(n, g_ld, dtype=torch.float64)
    for i in range(layers):
        gs[:, i * width : (i + 1) * width] = cotangents[i]

    rows_pad = fused_nerf._backbone_grad_rows(cfg)
    splits = shapes["partial"][0]
    partial = torch.zeros(splits, rows_pad, width, dtype=torch.float64)
    chunk = 64  # points a chunk here, so that several chunks and splits take part
    for first in range(0, n, chunk):
        rows = min(chunk, n - first)
        per_split = -(-rows // splits)
        for split in range(splits):
            pts = slice(first + split * per_split, first + min((split + 1) * per_split, rows))
            for out_row, xa, xb, layer in fused_nerf.backbone_f32_row_blocks(cfg):
                for half, xcol in enumerate((xa, xb)):
                    if xcol < 0:
                        continue
                    block = x[pts, xcol : xcol + 64].t() @ gs[pts, layer * width : (layer + 1) * width]
                    partial[split, out_row + 64 * half : out_row + 64 * half + 64] += block
    sums = torch.cat([c.sum(dim=0) for c in cotangents] + [(acts[-1] * g_alpha[:, None]).sum(dim=0),
                                                           g_alpha.sum().reshape(1)])
    flat = torch.cat([partial.sum(dim=0).reshape(-1), sums])
    got = fused_nerf._unpack_backbone_grads(cfg, flat, pe)
    assert set(got) == set(ref_grads)
    for key, ref in ref_grads.items():
        np.testing.assert_allclose(got[key].reshape(ref.shape).numpy(), ref.numpy(), rtol=1e-10, atol=1e-10,
                                   err_msg=key)


def test_scratch_stays_bounded_and_fills_the_card():
    cfg = CONFIGS["tennis"]
    shapes = fused_nerf.backbone_f32_scratch_shapes(cfg, 2_621_440, sm_count=132)
    assert shapes["x"][0] == shapes["g"][0] == 64 * fused_nerf._F32_CHUNK_TILES
    blocks = len(fused_nerf.backbone_f32_row_blocks(cfg)) * 2
    assert shapes["tile_part"][0] == 132 and shapes["partial"][0] * blocks <= 132
    small = fused_nerf.backbone_f32_scratch_shapes(cfg, 37, sm_count=132)
    assert small["x"][0] == 64 and small["tile_part"][0] == 1 and small["partial"][0] == 2


@pytest.mark.parametrize("dtype,kept", [("float32", torch.float32), ("bfloat16", torch.bfloat16)])
def test_autograd_function_keeps_f32_encodings_for_the_f32_kernels(monkeypatch, dtype, kept):
    """The launches replaced by stubs that record what they get and run the
    plain versions: the backward receives the encodings as the kernels of
    the configuration's operand dtype read them."""
    cfg = NerfMLPConfig(layers_width=64, backbone_layers_count=3, skip_layer_idx=2, output_features=3,
                        compute_dtype=dtype, use_fused_backbone=True, position_encoder=PositionalEncoderConfig(octaves=4))
    packed = {k: v.requires_grad_() for k, v in packed_weights(cfg).items()}
    encoded = positional_encoding(torch.rand(20, 3, generator=torch.Generator().manual_seed(4)), 4, True)
    seen = {}

    def fwd(cfg, packed, encoded, buffers=None):
        seen["fwd"] = (encoded.dtype, buffers)
        return fused_nerf.plain_backbone_fwd(cfg, packed, encoded)

    def bwd(cfg, packed, encoded, g_h, g_alpha, buffers=None):
        seen["bwd"] = (encoded.dtype, buffers)
        return fused_nerf.plain_backbone_bwd(cfg, packed, encoded.to(torch.float32), g_h, g_alpha)

    monkeypatch.setattr(fused_nerf, "_runs_kernels", lambda encoded: True)
    monkeypatch.setattr(fused_nerf, "kernel_buffers", lambda cfg, packed: "image")
    monkeypatch.setattr(fused_nerf, "fused_backbone_fwd", fwd)
    monkeypatch.setattr(fused_nerf, "fused_backbone_bwd", bwd)
    h, alpha = fused_nerf.fused_backbone(cfg, packed, encoded.requires_grad_())
    (h.sum() + alpha.sum()).backward()
    assert seen["fwd"] == (torch.float32, "image") and seen["bwd"] == (kept, "image")
    assert encoded.grad is not None and packed["w0"].grad is not None


def test_f32_configurations_reach_the_f32_wrappers(monkeypatch):
    """Off the CPU, fused_backbone_fwd/bwd hand an f32 configuration to
    backbone_f32_fwd/bwd (a meta tensor stands in for the card's)."""
    cfg = CONFIGS["narrow"]
    calls = []
    monkeypatch.setattr(fused_nerf, "backbone_f32_fwd", lambda *args: calls.append("fwd") or "f32 forward")
    monkeypatch.setattr(fused_nerf, "backbone_f32_bwd", lambda *args: calls.append("bwd") or "f32 backward")
    encoded = torch.empty(10, 63, device="meta")
    packed = {k: v.to("meta") for k, v in packed_weights(cfg).items()}
    assert fused_nerf.fused_backbone_fwd(cfg, packed, encoded) == "f32 forward"
    assert fused_nerf.fused_backbone_bwd(cfg, packed, encoded, encoded, encoded) == "f32 backward"
    assert calls == ["fwd", "bwd"]
    with pytest.raises(ValueError, match="cuda or cpu"):  # the bf16 path's checks, on a device that is neither
        fused_nerf.fused_backbone_fwd(CONFIGS["narrow"].__class__(compute_dtype="bfloat16"), packed, encoded)
