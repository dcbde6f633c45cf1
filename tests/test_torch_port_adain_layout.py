"""B1's grouped launch on the CPU (no JAX, no card): the pair table the host
builds (ops/fused_nerf.py::adain_pair_table), walked with a copy of
csrc/fused_nerf.cu's object and row arithmetic, the grouped plain path, and
the build digest that names the kernel libraries. B1's weight image is
read back in test_torch_port_nerf.py::test_kernel_weight_layout."""

import shutil

import pytest
import torch

from playableenvironments_tpu_torch.config import NerfMLPConfig, PositionalEncoderConfig
from playableenvironments_tpu_torch.models.layers import initialize_
from playableenvironments_tpu_torch.models.nerf import AdaInNerfMLP
from playableenvironments_tpu_torch.ops import fused_nerf
from torch_port_threads import one_torch_thread  # noqa: F401  (autouse: one PyTorch thread)

TILE = 128


def pair_tile(table, pair, rank, ctas):
    """(object, first row) of the tile that CTA `rank` of a cluster takes for
    `pair`: csrc/fused_nerf.cu's object_of and row arithmetic."""
    o = 0
    while o + 2 < len(table) and pair >= table[o + 1]:
        o += 1
    return o, ((pair - table[o]) * ctas + rank) * TILE


@pytest.mark.parametrize("ctas", [1, 2])
@pytest.mark.parametrize("n_points", [
    [17280, 46080, 46080, 46080],  # the tennis frame: 135 tiles (odd) then 360 each
    [1000, 129, 1, 256, 383],      # ragged ends, odd and even tile counts, a one-point object
    [37],
])
def test_pair_table_covers_every_point_once(n_points, ctas):
    """Every point of every object is in exactly one tile; the tiles of a
    pair belong to one object; only an object's last pair may hold a tile
    past its end (all rows masked), and only when its tile count is odd; the
    clusters' walk c, c + clusters, ... takes every pair once."""
    table = fused_nerf.adain_pair_table(n_points, ctas)
    assert table[0] == 0 and len(table) == len(n_points) + 1
    covered = [torch.zeros(n, dtype=torch.int64) for n in n_points]
    for pair in range(table[-1]):
        objects = set()
        for rank in range(ctas):
            o, row0 = pair_tile(table, pair, rank, ctas)
            objects.add(o)
            assert table[o] <= pair < table[o + 1]
            n = n_points[o]
            if row0 >= n:  # the masked partner tile of an odd tile count
                tiles = -(-n // TILE)
                assert ctas == 2 and rank == 1 and tiles % 2 == 1 and pair == table[o + 1] - 1
                continue
            covered[o][row0 : min(row0 + TILE, n)] += 1
        assert len(objects) == 1
    for o, c in enumerate(covered):
        assert bool((c == 1).all()), f"object {o}: points covered {c.min().item()}..{c.max().item()} times"
    for clusters in (1, 5, 66):
        walked = sorted(p for c in range(clusters) for p in range(c, table[-1], clusters))
        assert walked == list(range(table[-1]))


def test_pair_table_of_the_tennis_frame():
    """17,280 + 3 x 46,080 points: 135 + 3 x 360 tiles in 68 + 3 x 180 pairs."""
    assert fused_nerf.adain_pair_table([17280, 46080, 46080, 46080]) == [0, 68, 248, 428, 608]
    assert fused_nerf.adain_pair_table([17280, 46080, 46080, 46080], ctas=1) == [0, 135, 495, 855, 1215]


def _objects(cfg, specs, seed=0):
    """AdaInNerfItems of objects with their own seeded weights: (rays, samples)."""
    g = torch.Generator().manual_seed(seed)
    items = []
    for i, (rays, samples) in enumerate(specs):
        nerf = initialize_(AdaInNerfMLP(cfg, 8, device="cpu"), torch.Generator().manual_seed(10 + i))
        pe = nerf.kernel_weights().pe
        mods = [torch.randn(rays, c, generator=g)
                for c in (cfg.layers_width, cfg.layers_width, cfg.layers_width // 2, cfg.layers_width // 2)]
        encoded = torch.rand(rays * samples, pe, generator=g) * 2 - 1
        items.append(fused_nerf.AdaInNerfItem(nerf.kernel_weights(), encoded, *mods, samples))
    return items


@pytest.mark.parametrize("width", [32, 128])
def test_grouped_plain_path_matches_per_object_calls(width):
    """On the CPU the group runs plain_adain_nerf object by object: exactly
    the per-object fused_adain_nerf results, empty objects included, and no
    launch counted."""
    cfg = NerfMLPConfig(layers_width=width, backbone_layers_count=3, skip_layer_idx=2, output_features=24,
                        position_encoder=PositionalEncoderConfig(octaves=3))
    items = _objects(cfg, [(5, 4), (3, 32), (0, 4), (7, 1)])
    launches = fused_nerf.fused_adain_nerf.launches
    with torch.no_grad():
        grouped = fused_nerf.fused_adain_nerf_group(cfg, items)
        single = [fused_nerf.fused_adain_nerf(cfg, *item) for item in items]
    assert fused_nerf.fused_adain_nerf.launches == launches
    assert len(grouped) == len(items)
    for item, (features, alpha), (ref_features, ref_alpha) in zip(items, grouped, single):
        n = item.encoded.shape[0]
        assert features.shape == (n, 24) and alpha.shape == (n,)
        assert torch.equal(features, ref_features) and torch.equal(alpha, ref_alpha)


def test_group_checks_every_item():
    cfg = NerfMLPConfig(layers_width=32, backbone_layers_count=3, skip_layer_idx=2, output_features=24,
                        position_encoder=PositionalEncoderConfig(octaves=3))
    good, bad = _objects(cfg, [(5, 4), (3, 4)])
    with pytest.raises(ValueError, match="bias1"):
        fused_nerf.fused_adain_nerf_group(cfg, [good, bad._replace(bias1=torch.zeros(2, 16))])
    with pytest.raises(ValueError, match="not divisible"):
        fused_nerf.fused_adain_nerf_group(cfg, [good, bad._replace(samples_per_ray=5)])
    assert fused_nerf.fused_adain_nerf_group(cfg, []) == []


def test_library_digest_covers_included_headers(tmp_path):
    """A library is named by its source, every csrc/*.cuh it includes and
    its defines, so an edited header builds anew instead of loading a stale
    library. No nvcc needed."""
    csrc = tmp_path / "csrc"
    shutil.copytree(fused_nerf._CSRC, csrc)
    sources = {name: csrc / name for name in ("fused_nerf.cu", "fused_backbone.cu", "fused_rollout.cu")}
    assert [h.name for h in fused_nerf._included_headers(sources["fused_nerf.cu"])] == ["nerf_wgmma.cuh"]
    assert [h.parent for h in fused_nerf._included_headers(sources["fused_backbone.cu"])] == [csrc]
    before = {name: fused_nerf._library_path(path) for name, path in sources.items()}
    header = csrc / "nerf_wgmma.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {name: fused_nerf._library_path(path) for name, path in sources.items()}
    assert after["fused_nerf.cu"] != before["fused_nerf.cu"]
    assert after["fused_backbone.cu"] != before["fused_backbone.cu"]
    assert after["fused_rollout.cu"] == before["fused_rollout.cu"]  # includes no header
    variant = fused_nerf._library_path(sources["fused_nerf.cu"], ("ADAIN_CLUSTER=1",))
    assert variant != after["fused_nerf.cu"]
    assert all(p.parent == fused_nerf._BUILD_DIR and p.suffix == ".so" for p in (*after.values(), variant))
