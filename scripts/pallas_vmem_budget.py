#!/usr/bin/env python3
"""The VMEM the JAX package's NeRF Pallas calls ask for at a shape, from
their block specs (playableenvironments_tpu/ops/fused_nerf.py): B1
(`fused_adain_nerf`, every weight whole in bf16, biases f32, blocks of
`block_points` points and their rays), B2 (`_run_fwd_backbone`, every
weight whole in f32) and B3 (`_fused_backbone_bwd`, the weights whole in
f32 and their gradients whole in f32 as outputs), each block counted once
and, as a pipeline that double-buffers every block holds it, twice. Pure
arithmetic on shapes; imports nothing.

    python3 scripts/pallas_vmem_budget.py

Prints one line a shape: MB of weights and of all blocks, once and twice,
against the 16 MiB of scoped VMEM the kernels' docstrings budget.
"""

SCOPED = 16 * 2 ** 20


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


SHAPES = [  # (width, layers, skip, pe, outputs): the published tennis NeRF and the wide envelope's corners
    (256, 8, 4, 63, 192),
    (512, 8, 4, 123, 320),
    (512, 12, 6, 123, 320),
    (512, 16, 8, 128, 512),
    (512, 4, 0, 123, 512),
]


def main() -> int:
    for shape in SHAPES:
        parts = []
        for kernel, (weights, blocks) in budgets(*shape).items():
            once, twice = weights + blocks, 2 * (weights + blocks)
            parts.append(f"{kernel} weights {weights / 1e6:.2f} MB, all {once / 1e6:.2f} MB once, "
                         f"{twice / 1e6:.2f} MB double-buffered ({'fits' if twice <= SCOPED else 'over' if once > SCOPED else 'fits once only'})")
        print(f"W {shape[0]} x {shape[1]} layers, skip {shape[2]}, pe {shape[3]}, {shape[4]} outputs: " + "; ".join(parts))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
