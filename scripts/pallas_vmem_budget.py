#!/usr/bin/env python3
"""The VMEM the JAX package's Pallas calls ask for at a shape, from their
block specs. Pure arithmetic on shapes; imports nothing.

NeRF (playableenvironments_tpu/ops/fused_nerf.py): B1 (`fused_adain_nerf`,
every weight whole in bf16, biases f32, blocks of `block_points` points and
their rays), B2 (`_run_fwd_backbone`, every weight whole in f32) and B3
(`_fused_backbone_bwd`, the weights whole in f32 and their gradients whole
in f32 as outputs), each block counted once and, as a pipeline that
double-buffers every block holds it, twice.

Rollout (playableenvironments_tpu/ops/fused_rollout_pallas.py): B4
(`forward`, pallas_call :175) and B5 (`backward`, :313) take every array
whole in VMEM with no grid, so each is held once. B4: the 5 L + 4
parameters, the six inputs, the four (B, T, .) outputs and, when it
collects them, the residuals (T-1, B, .): the current state, x0, y, the
head, and per layer the gates (4F), c and h. B5: the parameters, the
residuals, the four cotangents, the parameter gradients (each its
parameter's shape) and the six input gradients. Counted two ways: the
elements the specs name, and each array padded to the (8, 128) f32 tiles
of its last two dimensions, as VMEM lays it out.

    python3 scripts/pallas_vmem_budget.py

Prints one line a shape: MiB against 16 MiB (a v5e's default scoped VMEM)
and 32 MiB (a v6e's).
"""

MIB = 2 ** 20
LIMITS = (16 * MIB, 32 * MIB)


def fits(nbytes):
    return " / ".join(f"{'fits' if nbytes <= limit else 'over'} {limit // MIB}" for limit in LIMITS)


def backbone_params(width, layers, skip, pe, concat_at_zero):
    """(weight elements, bias elements) of the backbone and alpha head."""
    weights = biases = 0
    for i in range(layers):
        rows = pe * (2 if i == 0 and concat_at_zero else 1) if i == 0 else width + (pe if i == skip else 0)
        weights += rows * width
        biases += width
    return weights + width, biases + 1


def budgets(width, layers, skip, pe, out, samples=2, b1_points=1024, bb_points=512):
    """{kernel: (weight bytes, block bytes)} at these shapes."""
    w, b = backbone_params(width, layers, skip, pe, concat_at_zero=skip == 0)
    head = width * width + width * (width // 2) + (width // 2) * out
    rays = max(b1_points // samples, 1)
    b1_weights = 2 * (w + head) + 4 * (b + out)
    b1_blocks = 2 * b1_points * pe + 4 * rays * (2 * width + width) + 4 * b1_points * (out + 1)
    w_nb, b_nb = backbone_params(width, layers, skip, pe, concat_at_zero=False)  # skip 0: no skip (_backbone_sizes)
    bb = 4 * (w_nb + b_nb)
    b2_blocks = 4 * bb_points * (pe + width + 1)
    b3_blocks = 4 * bb_points * (pe + width + 1) + 4 * bb_points * pe
    return {"B1": (b1_weights, b1_blocks), "B2": (bb, b2_blocks), "B3": (2 * bb, b3_blocks)}


NERF_SHAPES = [  # (width, layers, skip, pe, outputs)
    # the published tennis NeRF and the envelope the port's kernels take
    (256, 8, 4, 63, 192),
    (512, 8, 4, 123, 320),
    (512, 12, 6, 123, 320),
    (512, 16, 8, 128, 512),
    (512, 4, 0, 123, 512),
    # beyond it: widths 576-768, encodings above 128, more than 16 layers
    # (at W 256 to 64: the depth B2 holds once), B1 above 512 outputs, and
    # chip_smoke.py phase 21's widest CLI NeRF (640 x 8, 256 columns)
    (576, 8, 4, 123, 320),
    (640, 8, 4, 123, 320),
    (768, 8, 4, 123, 320),
    (768, 16, 8, 123, 320),
    (512, 8, 4, 192, 320),
    (512, 8, 4, 256, 320),
    (256, 8, 4, 256, 192),
    (256, 24, 12, 63, 192),
    (256, 32, 16, 63, 192),
    (256, 40, 20, 63, 192),
    (256, 64, 32, 63, 192),
    (640, 8, 4, 256, 3),
    (512, 20, 10, 123, 320),
    (512, 24, 12, 123, 320),
    (512, 8, 4, 123, 640),
    (512, 8, 4, 123, 1024),
]


def elements(shape):
    n = 1
    for d in shape:
        n *= d
    return n


def tiled(shape):
    """Elements of an f32 array padded to (8, 128) tiles of its last two dimensions."""
    *lead, rows, cols = (1,) * max(0, 2 - len(shape)) + tuple(shape)
    n = -(-rows // 8) * 8 * -(-cols // 128) * 128
    for d in lead:
        n *= d
    return n


def rollout_arrays(features, layers, batch, T, S, D, A, V):
    """{kernel: [array shapes]} of B4 (collecting residuals) and B5."""
    F, in0, H = features, 9 + S + D + A + V, 9 + S + D
    params = []
    for layer in range(layers):
        params += [(in0 if layer == 0 else F, 4 * F), (F, 4 * F), (1, 4 * F), (1, F), (1, F)]
    params += [(F, F), (1, F), (F, H), (1, H)]
    states = [(batch, T, w) for w in (3, 3, S, D)]
    inputs = states + [(batch, T - 1, A), (batch, T - 1, V)]
    residuals = [(T - 1, batch, w) for w in (3, 3, S, D, in0, F, H)]
    for _ in range(layers):
        residuals += [(T - 1, batch, 4 * F), (T - 1, batch, F), (T - 1, batch, F)]
    return {"B4": params + inputs + states + residuals,
            "B5": params + residuals + states + params + inputs}


# (features, layers): the published 256 x 2, LSTMs beyond the 256 features
# and 4 layers that the port's first rollout kernels hold in shared
# memory, and the corners of the envelope its wide kernels take (768
# features, 16 layers), at the tennis phase-3 batch (16 x 9; S 64, D 32,
# A 7, V 5: in0 117, head 105).
ROLLOUT_SHAPES = [(256, 2), (512, 1), (640, 1), (768, 1), (512, 2), (384, 2), (256, 5), (256, 6), (128, 12),
                  (128, 16), (768, 2), (512, 4), (256, 16), (768, 16)]
ROLLOUT_DIMS = dict(batch=16, T=9, S=64, D=32, A=7, V=5)


def main() -> int:
    for shape in NERF_SHAPES:
        parts = []
        for kernel, (weights, blocks) in budgets(*shape).items():
            once, twice = weights + blocks, 2 * (weights + blocks)
            parts.append(f"{kernel} weights {weights / MIB:.2f} MiB, all {once / MIB:.2f} MiB once ({fits(once)}), "
                         f"{twice / MIB:.2f} MiB double-buffered ({fits(twice)})")
        print(f"NeRF W {shape[0]} x {shape[1]} layers, skip {shape[2]}, pe {shape[3]}, {shape[4]} outputs: "
              + "; ".join(parts))
    for features, layers in ROLLOUT_SHAPES:
        parts = []
        for kernel, arrays in rollout_arrays(features, layers, **ROLLOUT_DIMS).items():
            named = 4 * sum(elements(a) for a in arrays)
            padded = 4 * sum(tiled(a) for a in arrays)
            parts.append(f"{kernel} {named / MIB:.2f} MiB named ({fits(named)}), {padded / MIB:.2f} MiB in "
                         f"(8, 128) tiles ({fits(padded)})")
        print(f"rollout F {features} x {layers} layers (batch {ROLLOUT_DIMS['batch']} x {ROLLOUT_DIMS['T']}): "
              + "; ".join(parts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
