"""The f32 backbone kernels' layouts, numerics and wiring, on the CPU (the
kernels, csrc/fused_backbone_f32.cu, run only on the card;
tests/test_torch_port_cuda.py and chip_smoke.py phase 14a hold them against
the plain versions there).

- The 3xTF32 weight images (`plain_backbone_f32_buffers`, the plain version
  of the card's pack kernel) read through a Python copy of the kernels'
  address arithmetic: each slot's big and small halves in wgmma's K-major
  layout, the K rows of a k-step in the kernels' order, and a layer's
  product formed from the accumulator fragments the way the tensor cores
  read them, against the layer's own product.
- The backward's scratch: X and G of a point stored feature-major in
  swizzled blocks of 32 points as the tile kernel stores them, read back
  through the weight-gradient kernel's row block table
  (`backbone_f32_row_blocks`) and its stage arithmetic, summed over splits
  and chunks of points as the kernels do, then unpacked as the wrapper
  does, against `plain_backbone_bwd`, in float64 at 1e-10.
- The numerics: the forward and backward with every product emulated in
  3xTF32 (operands split by integer bit operations) against the plain f32
  versions at chip_smoke.py's F32_KERNEL_REL and F32_KERNEL_MEAN.
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
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

CONFIGS = {
    "tennis": NerfMLPConfig(layers_width=256, backbone_layers_count=8, skip_layer_idx=4, output_features=3,
                            compute_dtype="float32", position_encoder=PositionalEncoderConfig(octaves=10)),
    "narrow": NerfMLPConfig(layers_width=128, backbone_layers_count=6, skip_layer_idx=3, output_features=3,
                            compute_dtype="float32", position_encoder=PositionalEncoderConfig(octaves=10)),
    # skip_layer_idx 0 is no skip on the fused backbone's path, whose module
    # declares w0 (pe, W) (fused_nerf._backbone_sizes); without it the
    # module's layer 0 reads [encoding, encoding].
    "no_skip": NerfMLPConfig(layers_width=64, backbone_layers_count=4, skip_layer_idx=0, output_features=3,
                             compute_dtype="float32", use_fused_backbone=True,
                             position_encoder=PositionalEncoderConfig(octaves=4)),
}
PE = 64  # the kernels' padded encoding (kPe)
# chip_smoke.py's bounds for B2/B3-f32 against the plain versions: of each
# output's largest magnitude, at most and in the mean; and on their ReLU
# pattern against the f64 forward's (relu_pattern_check): within 2^-16 of
# the rounding scale, at most 1 unit on the other side a million of a
# layer's, 4 at least.
F32_KERNEL_REL, F32_KERNEL_MEAN = 2e-5, 5e-6
F32_RELU_BAND = 2.0 ** -16
F32_RELU_FLIPS, F32_RELU_FLIPS_FLOOR = 1.0, 4


def packed_weights(cfg, dtype=torch.float32, seed=0):
    nerf = initialize_(AdaInNerfMLP(cfg, 8, device="cpu"), torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for i in range(cfg.backbone_layers_count):
            getattr(nerf, f"backbone_{i}").bias.copy_(torch.randn(cfg.layers_width, generator=g) * 0.1)
    return {k: v.detach().to(dtype).contiguous() for k, v in nerf.backbone_params().items()}


# The kernels' order of the 8 K rows of a k-step: logical k reads physical
# row K_ORDER[k] (csrc/fused_backbone_f32.cu: pi(k) = 2 (k % 4) + k / 4).
K_ORDER = tuple(2 * (k % 4) + k // 4 for k in range(8))


def scratch_offset(feats, point, feature):
    """csrc/fused_backbone_f32.cu::store_transposed: the float offset of
    (point of the chunk, feature) in an X or G scratch of `feats` features,
    blocks of 32 points, each feature's 16-byte chunks XOR-ed with its
    index % 8."""
    c = point % 32
    return ((point // 32) * feats + feature) * 32 + ((c // 4) ^ (feature % 8)) * 4 + c % 4


def kernel_skip(cfg):
    return cfg.skip_layer_idx or cfg.backbone_layers_count


def in_pad(layer, width, skip):
    """csrc/fused_backbone_f32.cu::in_pad: a layer's padded input rows."""
    return PE if layer == 0 else (width + PE if layer == skip else width)


def rows_before(layer, width, skip):
    return sum(in_pad(i, width, skip) for i in range(layer))


def slot_matrix(image, offset, n_rows):
    """One slot of an image as the tensor cores read B: (8 logical k, n)
    big and small, at `offset` (csrc/fused_backbone_f32.cu::plain_desc:
    core matrices of 8 n x 4 k floats, the two of a k-step 32 floats apart,
    groups of 8 n 64 apart)."""
    n, k = torch.meshgrid(torch.arange(n_rows), torch.arange(8), indexing="ij")
    at = (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4
    return image[offset + at].t(), image[offset + 8 * n_rows + at].t()


def fragments_times_slots(acts, image, offset, steps, n_rows, slot_floats):
    """A layer's product as the kernels form it for one warpgroup's 64
    rows: each thread's accumulator-layout values (rows g, g + 8; columns
    8 j + 2 q + {0, 1}) staged as (v[4j], v[4j + 2], v[4j + 1], v[4j + 3]),
    read by the tensor cores as the A fragment of k-step j (a0 row g k q, a1
    row g + 8 k q, a2 row g k q + 4, a3 row g + 8 k q + 4), times each
    slot's big + small."""
    rows = acts.shape[0]
    a = torch.zeros(rows, 8 * steps, dtype=acts.dtype)
    for t in range(128):
        warp, lane = t // 32, t % 32
        g, q = 16 * warp + lane // 4, lane % 4
        if g >= rows:
            continue
        for j in range(steps):
            v = [acts[g, 8 * j + 2 * q], acts[g, 8 * j + 2 * q + 1]]
            v8 = [acts[g + 8, 8 * j + 2 * q], acts[g + 8, 8 * j + 2 * q + 1]] if g + 8 < rows else [0.0, 0.0]
            staged = (v[0], v8[0], v[1], v8[1])  # (v[4j], v[4j + 2], v[4j + 1], v[4j + 3])
            a[g, 8 * j + q], a[g, 8 * j + q + 4] = staged[0], staged[2]
            if g + 8 < rows:
                a[g + 8, 8 * j + q], a[g + 8, 8 * j + q + 4] = staged[1], staged[3]
    b = torch.cat([sum(slot_matrix(image, offset + s * slot_floats, n_rows)) for s in range(steps)])
    return a.double() @ b.double()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_weight_images_follow_the_kernel_layout(name):
    cfg = CONFIGS[name]
    packed = packed_weights(cfg)
    buffers = fused_nerf.backbone_f32_buffers(cfg, packed)
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, kernel_skip(cfg)
    rows_pad = rows_before(layers, width, skip)
    assert buffers.fwd.numel() == buffers.bwd.numel() == 2 * rows_pad * width
    order = torch.tensor(K_ORDER)
    assert sorted(K_ORDER) == list(range(8)) and all(fused_nerf._logical_k(K_ORDER[k]) == k for k in range(8))
    for i, w in enumerate(fused_nerf.backbone_f32_weights(cfg, packed)):
        base = 2 * width * rows_before(i, width, skip)
        big_ref, small_ref = fused_nerf.tf32_split(w)
        assert bool(((big_ref + small_ref - w).abs() <= 2.0 ** -22 * w.abs()).all())
        # fwd: slot s holds padded input rows 8 s + order[k] by W columns.
        for s in range(in_pad(i, width, skip) // 8):
            big, small = slot_matrix(buffers.fwd, base + s * 16 * width, width)
            assert torch.equal(big, big_ref[8 * s + order]) and torch.equal(small, small_ref[8 * s + order]), (i, s)
        # bwd: the encoding rows' slots first (layer 0, the skip layer), then the activation rows'.
        groups = []
        if i == 0 or i == skip:
            groups.append((PE, width if i == skip else 0))
        if i > 0:
            groups.append((width, 0))
        offset = base
        for n_rows, first_row in groups:
            for s in range(width // 8):
                big, small = slot_matrix(buffers.bwd, offset + s * 16 * n_rows, n_rows)
                cols = 8 * s + order
                assert torch.equal(big, big_ref[first_row : first_row + n_rows, cols].t()), (i, s)
                assert torch.equal(small, small_ref[first_row : first_row + n_rows, cols].t()), (i, s)
            offset += (width // 8) * 16 * n_rows
        assert offset == base + 2 * in_pad(i, width, skip) * width
    assert torch.equal(buffers.biases, torch.cat([packed[f"b{i}"] for i in range(layers)] + [packed["b_alpha"]]))
    assert torch.equal(buffers.w_alpha, packed["w_alpha"].reshape(-1))


@pytest.mark.parametrize("name", ["tennis", "no_skip"])
def test_accumulator_fragments_feed_the_next_product(name):
    """A layer's activations, staged from the accumulator layout and read
    as A fragments, times the next layer's fwd slots (and the encoding's at
    the skip layer), and a cotangent times the bwd slots: each equals the
    product of the plain matrices in 3xTF32 (big + small) up to f64
    rounding."""
    cfg = CONFIGS[name]
    width, skip = cfg.layers_width, kernel_skip(cfg)
    packed = packed_weights(cfg, seed=5)
    buffers = fused_nerf.backbone_f32_buffers(cfg, packed)
    weights = fused_nerf.backbone_f32_weights(cfg, packed)
    g = torch.Generator().manual_seed(6)
    rows = 56  # a ragged warpgroup: rows 56-63 empty
    acts = torch.rand(rows, width, generator=g)
    i = 1 if skip == cfg.backbone_layers_count else skip
    w = weights[i]
    big, small = fused_nerf.tf32_split(w)
    got = fragments_times_slots(acts, buffers.fwd, 2 * width * rows_before(i, width, skip), width // 8, width,
                                16 * width)
    ref = acts.double() @ (big.double() + small.double())[:width]
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)
    cot = torch.randn(rows, width, generator=g)
    offset = 2 * width * rows_before(i, width, skip) + ((width // 8) * 16 * PE if i == skip else 0)
    got = fragments_times_slots(cot, buffers.bwd, offset, width // 8, width, 16 * width)
    ref = cot.double() @ (big.double() + small.double())[:width].t()
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_weight_gradient_blocks_read_the_scratch_layout(name):
    """X and G as the tile kernel stores them, dW as the weight-gradient
    kernel forms it from the row block table and its stages over splits of
    chunks of points, the small sums as the reduction adds them: the
    wrapper's unpack of that gives plain_backbone_bwd's gradients."""
    cfg = CONFIGS[name]
    width, layers = cfg.layers_width, cfg.backbone_layers_count
    packed = packed_weights(cfg, torch.float64)
    g = torch.Generator().manual_seed(3)
    n = 300
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

    shapes = fused_nerf.backbone_f32_scratch_shapes(cfg, n, sm_count=132)
    x_feats, g_feats, block = shapes["x"][1], shapes["g"][1], shapes["x"][2]
    assert x_feats == PE + (layers - 1) * width and g_feats == layers * width and block == 32
    chunk_tiles = 2  # tiles of 64 points a chunk here, so that several chunks and splits take part
    chunk = chunk_tiles * 64
    splits = shapes["partial"][0]
    nb = fused_nerf.backbone_f32_dw_columns(cfg)
    rows_pad = fused_nerf._backbone_grad_rows(cfg)
    partial = torch.zeros(splits, rows_pad, width, dtype=torch.float64)
    for first in range(0, n, chunk):
        # The tile kernel's stores: whole tiles, zero beyond n.
        x_scr = torch.zeros(chunk * x_feats, dtype=torch.float64)
        g_scr = torch.zeros(chunk * g_feats, dtype=torch.float64)
        points = torch.arange(min(chunk, n - first))
        x_rows = torch.zeros(len(points), x_feats, dtype=torch.float64)
        x_rows[:, :pe] = encoded[first + points]
        for i in range(layers - 1):
            x_rows[:, PE + i * width : PE + (i + 1) * width] = acts[i][first + points]
        g_rows = torch.cat([c[first + points] for c in cotangents], dim=1)
        p, f = torch.meshgrid(points, torch.arange(x_feats), indexing="ij")
        x_scr[scratch_offset(x_feats, p, f)] = x_rows
        p, f = torch.meshgrid(points, torch.arange(g_feats), indexing="ij")
        g_scr[scratch_offset(g_feats, p, f)] = g_rows
        # The dW kernel: stages of 32 points; per_split blocks a split.
        blocks = chunk // 32
        per_split = -(-blocks // splits)
        c = torch.arange(32)
        for split in range(splits):
            for b in range(split * per_split, min((split + 1) * per_split, blocks)):
                for out_row, xa, xb, layer in fused_nerf.backbone_f32_row_blocks(cfg):
                    for cb in range(width // nb):
                        gf = torch.arange(nb)[:, None]  # stage row = G feature - (layer W + cb nb)
                        g_stage = g_scr[(b * g_feats + layer * width + cb * nb) * 32
                                        + gf * 32 + (((c // 4) ^ (gf % 8)) * 4 + c % 4)]
                        for half, xcol in enumerate((xa, xb)):
                            if xcol < 0:
                                continue
                            xf = torch.arange(64)[:, None]
                            x_stage = x_scr[(b * x_feats + xcol) * 32 + xf * 32 + (((c // 4) ^ (xf % 8)) * 4 + c % 4)]
                            rows = slice(out_row + 64 * half, out_row + 64 * half + 64)
                            partial[split, rows, cb * nb : (cb + 1) * nb] += x_stage @ g_stage.t()
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
    assert shapes["x"][0] * 32 == shapes["g"][0] * 32 == 64 * fused_nerf._F32_CHUNK_TILES == 65_536
    scratch_bytes = 4 * (np.prod(shapes["x"]) + np.prod(shapes["g"]))
    assert 0.9e9 < scratch_bytes < 1.1e9
    dw_ctas = len(fused_nerf.backbone_f32_row_blocks(cfg)) * 2
    assert shapes["tile_part"][0] == 2 * 132 and shapes["masks"][:2] == (132, 8)
    assert shapes["partial"][0] * dw_ctas <= 132 < (shapes["partial"][0] + 1) * dw_ctas
    small = fused_nerf.backbone_f32_scratch_shapes(cfg, 37, sm_count=132)
    assert small["x"][0] == 2 and small["tile_part"][0] == 2 and small["masks"][0] == 1


@pytest.mark.parametrize("x,rounded", [
    (1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10),            # a tie rounds away from zero
    (-(1.0 + 2.0 ** -11), -(1.0 + 2.0 ** -10)),
    (1.0 + 2.0 ** -11 - 2.0 ** -23, 1.0),            # below the tie
    (1.0 + 2.0 ** -10 + 2.0 ** -11, 1.0 + 2.0 ** -9),  # the carry moves up a mantissa bit
    (3.0, 3.0),
])
def test_tf32_rounding_is_nearest_ties_away(x, rounded):
    got = fused_nerf.tf32_round(torch.tensor([x], dtype=torch.float32))
    assert got.item() == rounded
    big, small = fused_nerf.tf32_split(torch.tensor([x], dtype=torch.float32))
    assert big.item() == rounded and abs(big.item() + small.item() - np.float32(x)) <= 2.0 ** -22 * abs(x)


def mm_3xtf32(a, b):
    """a @ b as the f32 kernels form it: each operand split into TF32 big
    and small halves, small·big + big·small + big·big, f32 sums."""
    a_big, a_small = fused_nerf.tf32_split(a)
    b_big, b_small = fused_nerf.tf32_split(b)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def mm_1xtf32(a, b):
    """a @ b with TF32 operands alone (the small halves dropped)."""
    return fused_nerf.tf32_round(a) @ fused_nerf.tf32_round(b)


def emulated_fwd(cfg, packed, encoded, mm=mm_3xtf32):
    acts, h = [], encoded
    for i in range(cfg.backbone_layers_count):
        if i == cfg.skip_layer_idx and i != 0:
            h = torch.cat([h, encoded], dim=-1)
        h = torch.relu(mm(h, packed[f"w{i}"]) + packed[f"b{i}"])
        acts.append(h)
    return acts, (acts[-1] @ packed["w_alpha"] + packed["b_alpha"])[:, 0]


def emulated_bwd(cfg, packed, encoded, g_h, g_alpha):
    """plain_backbone_bwd's algorithm with the kernels' products: the
    recompute, dX and dW in 3xTF32, the alpha head and the sums in f32."""
    width = cfg.layers_width
    acts, _ = emulated_fwd(cfg, packed, encoded)
    grads = {"w_alpha": acts[-1].t() @ g_alpha[:, None], "b_alpha": g_alpha.sum().reshape(1)}
    g = g_h + g_alpha[:, None] * packed["w_alpha"][:, 0]
    d_encoded = torch.zeros_like(encoded)
    for i in range(cfg.backbone_layers_count - 1, -1, -1):
        g = g * (acts[i] > 0)
        if i == 0:
            layer_in = encoded
        elif i == cfg.skip_layer_idx:
            layer_in = torch.cat([acts[i - 1], encoded], dim=-1)
        else:
            layer_in = acts[i - 1]
        grads[f"w{i}"] = mm_3xtf32(layer_in.t(), g)
        grads[f"b{i}"] = g.sum(dim=0)
        g_in = mm_3xtf32(g, packed[f"w{i}"].t())
        if i == 0:
            d_encoded = d_encoded + g_in
        elif i == cfg.skip_layer_idx:
            d_encoded = d_encoded + g_in[:, width:]
            g = g_in[:, :width]
        else:
            g = g_in
    return grads, d_encoded


def seeded_inputs(cfg, n=2048):
    packed = packed_weights(cfg, seed=7)
    rng = np.random.default_rng(8)
    encoded = positional_encoding(torch.from_numpy(rng.uniform(-1, 1, (n, 3)).astype(np.float32)),
                                  cfg.position_encoder.octaves, True)
    g_h = torch.from_numpy(rng.normal(size=(n, cfg.layers_width)).astype(np.float32))
    g_alpha = torch.from_numpy(rng.normal(size=(n,)).astype(np.float32))
    return packed, encoded, g_h, g_alpha


@pytest.mark.parametrize("name", ["tennis", "narrow"])
def test_relu_pattern_check_passes_3xtf32_and_fails_tf32(name):
    """relu_pattern_check, which chip_smoke.py 14a and the card tests hold
    the kernels' ReLU pattern with: the 3xTF32 forward's pre-activations
    and units on the other side of f64's ReLU lie within F32_RELU_BAND of
    their rounding scale, in no more than F32_RELU_FLIPS units a million;
    the same forward with TF32 operands alone (a split that lost its small
    halves) lies far outside, and its pattern differs from f64's."""
    cfg = CONFIGS[name]
    packed, encoded, _, _ = seeded_inputs(cfg)
    limit = max(F32_RELU_FLIPS_FLOOR, F32_RELU_FLIPS * encoded.shape[0] * cfg.layers_width / 1e6)
    masks, rows = fused_nerf.relu_pattern_check(cfg, packed, encoded, emulated_fwd(cfg, packed, encoded)[0])
    assert len(masks) == len(rows) == cfg.backbone_layers_count
    for layer, r in enumerate(rows):
        assert r["flips"] <= limit and r["flip_ratio"] <= F32_RELU_BAND, (layer, r)
        assert 0 < r["error_ratio"] <= F32_RELU_BAND, (layer, r)
    _, rows = fused_nerf.relu_pattern_check(cfg, packed, encoded, emulated_fwd(cfg, packed, encoded, mm_1xtf32)[0])
    assert max(r["error_ratio"] for r in rows) > 16 * F32_RELU_BAND
    assert max(r["flip_ratio"] for r in rows) > F32_RELU_BAND


def test_plain_backward_takes_a_given_relu_pattern():
    """plain_backbone_bwd at its own ReLU pattern is its default; at a
    pattern with one unit turned off, only that point's gradient to the
    encoding moves."""
    cfg = CONFIGS["narrow"]
    packed, encoded, g_h, g_alpha = seeded_inputs(cfg, n=64)
    acts = fused_nerf._plain_backbone_acts(cfg, packed, encoded, lambda x: x)
    masks = [a > 0 for a in acts]
    grads, d_encoded = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
    at, d_at = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha, masks)
    assert torch.equal(d_encoded, d_at) and all(torch.equal(grads[k], at[k]) for k in grads)
    point, unit = masks[2].nonzero()[0].tolist()
    masks[2][point, unit] = False
    _, d_off = fused_nerf.plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha, masks)
    moved = (d_off != d_encoded).any(dim=1)
    assert moved[point] and int(moved.sum()) == 1


@pytest.mark.parametrize("name", ["tennis", "narrow"])
def test_3xtf32_products_hold_the_card_bounds(name):
    """The kernels' split of every product, emulated in plain torch (the
    tensor cores' own accumulation order aside), stays within 14a's bounds
    of the plain forward and backward on the same seeded inputs. The plain
    versions run in f64 here: in f32 they take a ReLU of the tennis case
    whose input lies within f32 rounding of 0 on the other side, which
    moves d_encoded far more than these bounds from the f64 result."""
    cfg = CONFIGS[name]
    packed, encoded, g_h, g_alpha = seeded_inputs(cfg)
    acts, alpha = emulated_fwd(cfg, packed, encoded)
    grads, d_encoded = emulated_bwd(cfg, packed, encoded, g_h, g_alpha)
    packed64 = {k: v.double() for k, v in packed.items()}
    ref_h, ref_alpha = fused_nerf.plain_backbone_fwd(cfg, packed64, encoded.double())
    ref_grads, ref_d_encoded = fused_nerf.plain_backbone_bwd(cfg, packed64, encoded.double(), g_h.double(),
                                                             g_alpha.double())
    outputs = [("h", acts[-1], ref_h), ("alpha", alpha, ref_alpha), ("d_encoded", d_encoded, ref_d_encoded)]
    for key, got, ref in outputs + [(k, grads[k], ref_grads[k]) for k in ref_grads]:
        scale = ref.abs().max().item()
        diff = (got.double().reshape(ref.shape) - ref).abs()
        assert diff.max().item() <= F32_KERNEL_REL * scale, key
        assert diff.mean().item() <= F32_KERNEL_MEAN * scale, key


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
