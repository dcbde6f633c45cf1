"""The AdaIN-NeRF MLP's hand-written CUDA kernels.

Port of playableenvironments_tpu/ops/fused_nerf.py:
- the inference half, `fused_adain_nerf`: the per-point pipeline 8x256
  backbone with mid skip -> alpha head + AdaIN-modulated feature head, over
  pre-encoded points, with eval-mode BN statistics folded into a per-ray
  scale/bias (csrc/fused_nerf.cu). `fused_adain_nerf_group` runs several
  objects of one MLP configuration in one launch; `fused_adain_nerf` keeps
  the JAX function's per-object interface as a group of one;
- the trainable backbone, `fused_backbone`: backbone + alpha head as a
  torch.autograd.Function whose forward (`fused_backbone_fwd`) and backward
  (`fused_backbone_bwd`) are kernels: csrc/fused_backbone.cu for bf16
  operands, csrc/fused_backbone_f32.cu (`backbone_f32_fwd`,
  `backbone_f32_bwd`) for an f32 `compute_dtype`.
All are sm_90a tensor-core kernels with f32 accumulation that share
csrc/nerf_wgmma.cuh; the f32 ones split each f32 operand into two TF32
halves and run three TF32 products a multiply-add (3xTF32). All are built
with nvcc at first use and loaded with ctypes.

Each wrapper launches its kernel for CUDA tensors. For CPU tensors it runs
the plain PyTorch version of the same function (`plain_adain_nerf`,
`plain_backbone_fwd`, `plain_backbone_bwd`: matmul operands rounded to the
compute dtype, products and sums in f32), which is what the CPU tests
compare against the JAX package and what the card compares the kernels with.

Like the Pallas kernels, the wrappers take every shape whose blocks the
Pallas kernels hold in a v6e's 32 MiB of VMEM (scripts/pallas_vmem_budget.py):
widths up to 640, encodings up to 256 columns, any number of backbone layers
(B1 up to 1,024 outputs, and a skip into layer 0). Within the published
shapes (width 256, encoding 64, 8 layers; B1 256 outputs and skip > 0) the
128-point kernels run; beyond them the wide kernels (nerf_wgmma.cuh's column
split, 64-point tiles) at width 256, 512 or 640. On the card a narrower MLP
runs zero-padded to the nearest width its kernel takes (`padded_weights`; B1
128 or 256, bf16 B2/B3 a multiple of 64, f32 B2/B3 64, 128 or 256; the wide
kernels 256, 512 or 640: 576 runs at 640). A padded hidden unit has zero
incoming weights, bias and modulation, so its ReLU output is exactly 0 and
its zero outgoing rows add nothing; the outputs and gradients are cut back
to the MLP's own width. Beyond the wide kernels' limits every wrapper raises
ValueError.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from playableenvironments_tpu_torch.config import NerfMLPConfig
from playableenvironments_tpu_torch.core.bbox import aabb_contains, aabb_size
from playableenvironments_tpu_torch.models.encoding import positional_encoding

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_SOURCE = _CSRC / "fused_nerf.cu"
_BACKBONE_SOURCE = _CSRC / "fused_backbone.cu"
_BACKBONE_F32_SOURCE = _CSRC / "fused_backbone_f32.cu"
_ROLLOUT_SOURCE = _CSRC / "fused_rollout.cu"  # B4/B5, wrapped in ops/fused_rollout.py
_BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"

# Limits of the B1 kernel's layout (csrc/fused_nerf.cu): the widths whose
# feature-head slots it takes, the encoding columns and outputs it pads to,
# the objects of one launch.
_ADAIN_WIDTHS = (128, 256)
_MAX_PE = 64
_MAX_OUT = 256
_ADAIN_MAX_OBJECTS = 16
_MAX_WIDTH = 256  # the backbone kernels' widest layer (csrc/fused_backbone.cu)
# The wide kernels (nerf_wgmma.cuh's column split; B1, bf16 and f32 B2/B3):
# their widths, the encoding columns and outputs (B1) they take, and the
# points of a tile. Depth is a runtime loop bound in every wide kernel.
_WIDE_WIDTHS = (256, 512, 640)
_WIDE_MAX_PE = 256
_WIDE_MAX_OUT = 1024
_WIDE_TILE = 64


_TRACING = 0


@contextlib.contextmanager
def tracing():
    """Inside the `with` (serve.export_function's torch.export), each NeRF
    builds its kernel weights from its parameters in the traced graph
    instead of taking them from its cache, which is keyed by storage
    pointers that a traced tensor has not."""
    global _TRACING
    _TRACING += 1
    try:
        yield
    finally:
        _TRACING -= 1


def is_tracing() -> bool:
    return _TRACING > 0


def fold_adain_stats(adain, style: torch.Tensor, eps: float = 1e-5):
    """Fold eval-mode BN running stats into the AdaIN affine:
    scale' = scale * rsqrt(var + eps), bias' = bias - mean * scale'.

    :param adain: models.layers.AffineTransformAdaIn.
    :param style: (..., style_features).
    :return: ((..., features) scale', (..., features) bias').
    """
    encoded = style @ adain.affine.weight.t() + adain.affine.bias
    scale, bias = torch.chunk(encoded, 2, dim=-1)
    scale_eff = scale * torch.rsqrt(adain.norm.var + eps)
    bias_eff = bias - adain.norm.mean * scale_eff
    return scale_eff, bias_eff


def pack_nerf_params(cfg: NerfMLPConfig, nerf) -> Dict[str, torch.Tensor]:
    """The AdaInNerfMLP's weights in the JAX package's packed layout:
    w{i}/b{i}, w_alpha/b_alpha, w_f0, w_f1, w_out/b_out, each weight (in, out)."""
    packed = {}
    for i in range(cfg.backbone_layers_count):
        layer = getattr(nerf, f"backbone_{i}")
        packed[f"w{i}"] = layer.weight.t()
        packed[f"b{i}"] = layer.bias
    packed["w_alpha"] = nerf.alpha_head.weight.t()
    packed["b_alpha"] = nerf.alpha_head.bias
    packed["w_f0"] = nerf.feat_0.weight.t()
    packed["w_f1"] = nerf.feat_1.weight.t()
    packed["w_out"] = nerf.feat_out.weight.t()
    packed["b_out"] = nerf.feat_out.bias
    return packed


def _bf16(x: torch.Tensor) -> torch.Tensor:
    """x rounded to bf16, in f32 (in f64 for an f64 x: a reference with f64
    sums)."""
    return x.to(torch.bfloat16).to(torch.float64 if x.dtype == torch.float64 else torch.float32)


def plain_adain_nerf(
    cfg: NerfMLPConfig,
    packed: Dict[str, torch.Tensor],
    encoded: torch.Tensor,
    scale0: torch.Tensor,
    bias0: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    samples_per_ray: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's function in plain PyTorch: every matmul operand rounded
    to bf16, products and sums in f32 (in f64 where every input is f64),
    modulation per ray (rows of scale*/bias* broadcast over
    `samples_per_ray` consecutive points).

    :return: ((N, output_features) features, (N,) raw alpha).
    """

    def mm(x, w):
        return _bf16(x) @ _bf16(w)

    def per_point(mod):
        return mod.repeat_interleave(samples_per_ray, dim=0)

    encoded = _bf16(encoded if encoded.dtype == torch.float64 else encoded.float())
    h = encoded
    for i in range(cfg.backbone_layers_count):
        if i == cfg.skip_layer_idx:
            h = torch.cat([h, encoded], dim=-1)
        h = torch.relu(mm(h, packed[f"w{i}"]) + packed[f"b{i}"])
    alpha = (mm(h, packed["w_alpha"]) + packed["b_alpha"])[..., 0]
    f = torch.relu(mm(h, packed["w_f0"]) * per_point(scale0) + per_point(bias0))
    f = torch.relu(mm(f, packed["w_f1"]) * per_point(scale1) + per_point(bias1))
    return mm(f, packed["w_out"]) + packed["b_out"], alpha


@dataclass(frozen=True)
class NerfKernelWeights:
    """One object's MLP weights: `packed` in the JAX layout (what the plain
    version reads), the kernel's bf16 weight image (`adain_image`; None for
    a width above the kernel's, and on the CPU for a width it takes only
    padded, which then run only the plain version), its f32 biases b_0 ..
    b_{L-1}, b_alpha, b_out, and the width the image holds (`width`: the
    MLP's own, or the padded one)."""

    packed: Dict[str, torch.Tensor]
    image: Optional[torch.Tensor]
    biases: torch.Tensor
    pe: int
    width: int


def _swizzled_blocks(w: torch.Tensor) -> torch.Tensor:
    """(64 a, 64 b) -> a x b unswizzled 64 x 64 blocks, slot-major: block
    (i, j) holds rows 64 i .. and columns 64 j .. of `w`."""
    rows, cols = w.shape
    return w.reshape(rows // _BLOCK, _BLOCK, cols // _BLOCK, _BLOCK).permute(0, 2, 1, 3).reshape(-1, _BLOCK * _BLOCK)


def padded_weights(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor],
                   width: int) -> Tuple[NerfMLPConfig, Dict[str, torch.Tensor]]:
    """`cfg` at `width` hidden units and `packed` zero-padded to it: every
    backbone layer's columns and its rows from the layer before (at the skip
    layer the zero rows go between h's rows and the encoding's), the biases,
    w_alpha's rows and, where `packed` has the feature head, w_f0 (W', W'),
    w_f1 (W', W' / 2) and w_out's rows (W' / 2). The padded MLP computes the
    same outputs in the first W columns and zeros past them: a padded unit's
    pre-activation is exactly 0. (cfg, packed) themselves at their own width."""
    old = cfg.layers_width
    if width == old:
        return cfg, packed
    pad, extra, extra_half = torch.nn.functional.pad, width - old, width // 2 - old // 2
    out = dict(packed)
    for i in range(cfg.backbone_layers_count):
        w = packed[f"w{i}"]
        if i == 0:
            out[f"w{i}"] = pad(w, (0, extra))
        elif i == cfg.skip_layer_idx:
            out[f"w{i}"] = torch.cat([pad(w[:old], (0, extra, 0, extra)), pad(w[old:], (0, extra))])
        else:
            out[f"w{i}"] = pad(w, (0, extra, 0, extra))
        out[f"b{i}"] = pad(packed[f"b{i}"], (0, extra))
    out["w_alpha"] = pad(packed["w_alpha"], (0, 0, 0, extra))
    if "w_f0" in packed:
        out["w_f0"] = pad(packed["w_f0"], (0, extra, 0, extra))
        out["w_f1"] = pad(packed["w_f1"], (0, extra_half, 0, extra))
        out["w_out"] = pad(packed["w_out"], (0, 0, 0, extra_half))
    return replace(cfg, layers_width=width), out


def adain_is_wide(width: int, pe: int, out: int, skip: int) -> bool:
    """Whether B1 runs an MLP of these shapes in its wide kernel (width above
    256, encoding above 64 columns, more than 256 outputs, or a skip into
    layer 0) rather than the 128-point one."""
    return width > _ADAIN_WIDTHS[-1] or pe > _MAX_PE or out > _MAX_OUT or skip == 0


def adain_kernel_width(width: int, wide: bool = False) -> Optional[int]:
    """The width B1 runs a `width`-wide MLP at: the narrowest of its
    widths (128, 256; the wide kernel's 256, 512, 640) that holds it; None
    above the widest."""
    return next((w for w in (_WIDE_WIDTHS if wide else _ADAIN_WIDTHS) if width <= w), None)


def adain_encoding_width(cfg, packed: Dict[str, torch.Tensor]) -> int:
    """The encoding columns of an AdaIN-NeRF MLP: w0's rows, or at
    skip_layer_idx 0, where layer 0 reads [encoding, encoding] (JAX's
    _fused_kernel), the configuration's encoding of 3 coordinates, whose
    double w0 must have. Raises for a w0 of other rows there (a model of the
    fused backbone's path, which declares no skip at 0: JAX's B1 takes no
    such weights either)."""
    rows = packed["w0"].shape[0]
    if cfg.skip_layer_idx != 0:
        return rows
    pe_cfg = cfg.position_encoder
    pe = 6 * pe_cfg.octaves + (3 if pe_cfg.append_original else 0)
    if rows != 2 * pe:
        raise ValueError(f"skip_layer_idx 0: layer 0 reads [encoding, encoding], 2 x {pe} rows, but w0 has {rows}")
    return pe


def adain_kernel(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> Tuple[int, bool]:
    """(width, wide): the width B1 runs cfg's MLP at and whether in its wide
    kernel. Raises ValueError, naming the shape and the limit, for what
    neither kernel takes."""
    width, pe, out = cfg.layers_width, adain_encoding_width(cfg, packed), packed["w_out"].shape[1]
    wide = adain_is_wide(width, pe, out, cfg.skip_layer_idx)
    kernel = adain_kernel_width(width, wide)
    if kernel is None:
        raise ValueError(f"layers_width {width}: the AdaIN-NeRF kernel takes widths up to {_WIDE_WIDTHS[-1]}")
    if pe > _WIDE_MAX_PE:
        raise ValueError(f"encoding width {pe} exceeds the AdaIN-NeRF kernel's {_WIDE_MAX_PE}")
    if out > _WIDE_MAX_OUT:
        raise ValueError(f"output_features {out} exceeds the AdaIN-NeRF kernel's {_WIDE_MAX_OUT}")
    return kernel, wide


def adain_image(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> torch.Tensor:
    """B1's bf16 weight image as csrc/fused_nerf.cu reads it: the backbone
    image of `backbone_buffers` (slots, then w_alpha; at skip 0 layer 0's
    two encoding segments), then the feature head's 64-row slots, each its
    64 x 64 blocks in wgmma's 128-byte swizzle: for the 128-point kernel
    W_f0's columns [0, W / 2), its columns [W / 2, W) (the kernel runs f0 in
    two passes), W_f1 (W, W / 2), W_out (W / 2, outputs rounded up to 64,
    zero-padded); for the wide kernel W_f0 (W, W), W_f1 and W_out. Built on
    the weights' device by gathers. W is `adain_kernel`'s, to which a
    narrower MLP's weights are zero-padded (`padded_weights`). Raises for a
    configuration the kernels do not take."""
    pe, out = adain_encoding_width(cfg, packed), packed["w_out"].shape[1]
    kernel, wide = adain_kernel(cfg, packed)
    cfg, packed = padded_weights(cfg, packed, kernel)
    half = kernel // 2
    with torch.no_grad():
        backbone, _ = backbone_buffers(cfg, packed, pe=pe, pad=False)
        w_out = _padded(packed["w_out"], half, -(-out // _BLOCK) * _BLOCK)
        mats = ([packed["w_f0"], packed["w_f1"], w_out] if wide else
                [packed["w_f0"][:, :half], packed["w_f0"][:, half:], packed["w_f1"], w_out])
        blocks = torch.cat([_swizzled_blocks(m.to(torch.bfloat16)) for m in mats])
        head = blocks[:, _unswizzle(blocks.device)]
        return torch.cat([backbone, head.reshape(-1)])


def _padded(w: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """`w` in the top-left corner of a (rows, cols) zero matrix."""
    z = w.new_zeros((rows, cols))
    z[: w.shape[0], : w.shape[1]] = w
    return z


def kernel_weights(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> NerfKernelWeights:
    """Build the kernel's buffers from `packed` once (on the weights'
    device): the image for the widths the kernels take, and on the card for
    a narrower width zero-padded to one they take (raising for a width,
    encoding or output count beyond the wide kernel's), the biases always
    (padded with the image)."""
    pe = adain_encoding_width(cfg, packed)
    if packed["w0"].device.type == "cuda":
        width = adain_kernel(cfg, packed)[0]
    else:
        width = adain_kernel_width(cfg.layers_width,
                                   adain_is_wide(cfg.layers_width, pe, packed["w_out"].shape[1], cfg.skip_layer_idx))
        width = width if width == cfg.layers_width else None
    with torch.no_grad():
        image = adain_image(cfg, packed) if width is not None else None
        padded = padded_weights(cfg, packed, width)[1] if width is not None else packed
        biases = torch.cat(
            [padded[f"b{i}"] for i in range(cfg.backbone_layers_count)] + [padded["b_alpha"], padded["b_out"]]
        ).to(torch.float32).contiguous()
    return NerfKernelWeights(packed={k: v.detach() for k, v in packed.items()}, image=image, biases=biases, pe=pe,
                             width=width or cfg.layers_width)


def adain_pair_table(n_points: Sequence[int], ctas: int = 2, tile: int = 128) -> List[int]:
    """The pair prefix table of one grouped launch: object o's pairs (units
    of `ctas` tiles of `tile` points, one tile per CTA of a cluster; the
    wide kernel's are single 64-point tiles) are [table[o], table[o + 1]); a
    pair never holds two objects' points."""
    table = [0]
    for n in n_points:
        tiles = -(-n // tile)
        table.append(table[-1] + -(-tiles // ctas))
    return table


def _included_headers(source: Path) -> List[Path]:
    """The csrc/*.cuh files `source` includes (#include "x.cuh"), looked up
    beside it, then in csrc/."""
    headers = []
    for line in source.read_text().splitlines():
        parts = line.split('"')
        if line.startswith("#include") and len(parts) == 3 and parts[1].endswith(".cuh"):
            header = source.with_name(parts[1])
            headers.append(header if header.exists() else _CSRC / parts[1])
    return headers


def _library_path(source: Path, defines: Tuple[str, ...] = ()) -> Path:
    """The library built from `source` with `defines`, named by a digest of
    the source, every header it includes and the defines."""
    digest = hashlib.sha1(source.read_bytes())
    for header in _included_headers(source):
        digest.update(header.read_bytes())
    for define in defines:
        digest.update(define.encode())
    return _BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:12]}.so"


def build_kernels(sources: Tuple[Path, ...] = (_SOURCE, _BACKBONE_SOURCE, _BACKBONE_F32_SOURCE, _ROLLOUT_SOURCE),
                  defines: Tuple[str, ...] = ()) -> Dict[str, str]:
    """Compile each CUDA source with nvcc for sm_90a into the build
    directory, once per content (the source, its headers from csrc/ and the
    `defines`, each NAME=VALUE); the nvcc processes run together.

    :return: {source name: nvcc's report (registers, shared memory, spills)},
        "" for a library that was already built.
    """
    todo = [s for s in sources if not _library_path(s, defines).exists()]
    if not todo:
        return {s.name: "" for s in sources}
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    nvcc = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the port's kernels")
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for source in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
            "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", str(_CSRC),
            *(f"-D{d}" for d in defines), "-o", tmp, str(source),
        ]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((source, tmp, proc))
    reports, failures = {s.name: "" for s in sources}, []
    for source, tmp, proc in jobs:
        output, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"nvcc failed on {source.name}:\n{output}")
        else:
            os.replace(tmp, _library_path(source, defines))
            reports[source.name] = output
    if failures:
        raise RuntimeError("\n".join(failures))
    return reports


def _load(source: Path, defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    build_kernels((source,), defines)
    return ctypes.CDLL(str(_library_path(source, defines)))


def adain_library(defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """csrc/fused_nerf.cu built with `defines` and loaded, its functions
    typed (the port's own build has none; scripts/ablate_adain_nerf.py
    loads variants)."""
    lib = _load(_SOURCE, defines)
    lib.fused_adain_nerf_group_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    )
    lib.fused_adain_nerf_group_launch.restype = ctypes.c_int
    lib.fused_adain_nerf_max_clusters.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.fused_adain_nerf_max_clusters.restype = ctypes.c_int
    lib.fused_adain_nerf_cluster_size.argtypes = []
    lib.fused_adain_nerf_cluster_size.restype = ctypes.c_int
    lib.fused_adain_wide_group_launch.argtypes = lib.fused_adain_nerf_group_launch.argtypes
    lib.fused_adain_wide_group_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """The built B1 kernel library, loaded once per process. Reached only
    when a CUDA tensor reaches the kernel."""
    return adain_library()


@functools.lru_cache(maxsize=None)
def _backbone_library() -> ctypes.CDLL:
    """csrc/fused_backbone.cu, built and loaded once per process."""
    lib = _load(_BACKBONE_SOURCE)
    lib.fused_backbone_fwd_launch.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.fused_backbone_bwd_launch.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                                              + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)])
    lib.fused_backbone_wide_fwd_launch.argtypes = lib.fused_backbone_fwd_launch.argtypes
    lib.fused_backbone_wide_bwd_launch.argtypes = ([ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                                                   + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)])
    for fn in (lib.fused_backbone_fwd_launch, lib.fused_backbone_bwd_launch, lib.fused_backbone_wide_fwd_launch,
               lib.fused_backbone_wide_bwd_launch):
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _backbone_f32_library() -> ctypes.CDLL:
    """csrc/fused_backbone_f32.cu, built and loaded once per process."""
    lib = _load(_BACKBONE_F32_SOURCE)
    lib.backbone_f32_pack_launch.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_void_p] * 5
                                             + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.backbone_f32_fwd_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.backbone_f32_bwd_launch.argtypes = ([ctypes.c_void_p] * 15 + [ctypes.c_int] * 9
                                            + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)])
    lib.backbone_f32_wide_fwd_launch.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.backbone_f32_wide_bwd_launch.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 9
                                                 + [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)])
    for fn in (lib.backbone_f32_pack_launch, lib.backbone_f32_fwd_launch, lib.backbone_f32_bwd_launch,
               lib.backbone_f32_wide_fwd_launch, lib.backbone_f32_wide_bwd_launch):
        fn.restype = ctypes.c_int
    return lib


class AdaInNerfItem(NamedTuple):
    """One object of a grouped launch: its weights, (N, pe) encodings, per-ray
    modulation (N / samples_per_ray rows; scale0/bias0 W columns,
    scale1/bias1 W // 2) and samples per ray (N = rays * samples_per_ray,
    ray-major)."""

    weights: NerfKernelWeights
    encoded: torch.Tensor
    scale0: torch.Tensor
    bias0: torch.Tensor
    scale1: torch.Tensor
    bias1: torch.Tensor
    samples_per_ray: int = 1


def _check_item(cfg: NerfMLPConfig, item: AdaInNerfItem) -> None:
    n, pe = item.encoded.shape
    width, samples = cfg.layers_width, item.samples_per_ray
    if samples < 1 or n % samples:
        raise ValueError(f"point count {n} not divisible by samples {samples}")
    rays = n // samples
    for name, cols in (("scale0", width), ("bias0", width), ("scale1", width // 2), ("bias1", width // 2)):
        t = getattr(item, name)
        if tuple(t.shape) != (rays, cols):
            raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {(rays, cols)}")
    if pe != item.weights.pe:
        raise ValueError(f"encoding width {pe} != the weights' {item.weights.pe}")


def _packed_names(layers: int) -> List[str]:
    """The order of an object's `packed` weights in the operator's list."""
    return [n for i in range(layers) for n in (f"w{i}", f"b{i}")] + ["w_alpha", "b_alpha", "w_f0", "w_f1", "w_out",
                                                                     "b_out"]


class _MLPShape(NamedTuple):
    """What plain_adain_nerf reads of a NerfMLPConfig."""

    backbone_layers_count: int
    skip_layer_idx: int


_OP = "playableenvironments_torch::fused_adain_nerf_group"


@torch.library.custom_op(_OP, mutates_args=(), device_types="cuda")
def _adain_group_op(encoded: List[torch.Tensor], scale0: List[torch.Tensor], bias0: List[torch.Tensor],
                    scale1: List[torch.Tensor], bias1: List[torch.Tensor], images: List[torch.Tensor],
                    biases: List[torch.Tensor], packed: List[torch.Tensor], samples_per_ray: List[int],
                    width: int, layers: int, skip: int, out_features: int) -> List[torch.Tensor]:
    """B1 as a registered operator, so that torch.export records one node
    for it (the ctypes launch cannot be traced): per object its (N, pe)
    encodings, per-ray modulation, weight image and biases, and its
    `packed` weights (2 L + 6 tensors an object, `_packed_names` order);
    the outputs are [features_0, alpha_0, features_1, ...]. This is the
    CUDA implementation: one kernel launch for up to 16 objects (objects
    without points take none), walking the pair table of
    `adain_pair_table`; each launch adds 1 to `fused_adain_nerf.launches`
    and its objects to `fused_adain_nerf.objects`."""
    device = encoded[0].device
    pe = encoded[0].shape[1]
    wide = adain_is_wide(width, pe, out_features, skip)
    if width not in (_WIDE_WIDTHS if wide else _ADAIN_WIDTHS) or any(image.numel() == 0 for image in images):
        raise ValueError(f"layers_width {width}: the AdaIN-NeRF kernel takes widths up to {_WIDE_WIDTHS[-1]}")
    for group in (encoded, scale0, bias0, scale1, bias1, images, biases):
        for t in group:
            if t.device != device:
                raise ValueError(f"all inputs must be on {device}, got one on {t.device}")
    for group in (scale0, bias0, scale1, bias1):
        for t in group:
            if t.dtype != torch.float32:
                raise ValueError(f"modulation must be float32, got {t.dtype}")
    # An operator's outputs may not alias one another: one allocation each.
    counts = [e.shape[0] for e in encoded]
    features = [torch.empty((n, out_features), dtype=torch.float32, device=device) for n in counts]
    alphas = [torch.empty((n,), dtype=torch.float32, device=device) for n in counts]
    # Objects with points; the kernel reads modulation rows with their stride
    # (fold_adain_stats' scale and bias are column halves of one array), in
    # aligned pairs of floats.
    launch = [i for i, n in enumerate(counts) if n]
    lib = _library()
    ctas, tile = (1, _WIDE_TILE) if wide else (lib.fused_adain_nerf_cluster_size(), _BACKBONE_TILE)
    launch_group = lib.fused_adain_wide_group_launch if wide else lib.fused_adain_nerf_group_launch
    stream = torch.cuda.current_stream(device).cuda_stream
    for first in range(0, len(launch), _ADAIN_MAX_OBJECTS):
        chunk = launch[first : first + _ADAIN_MAX_OBJECTS]
        ptrs, ints, keep = [], [], []  # keep: the temporaries stay alive until the launch is enqueued
        for i in chunk:
            e = encoded[i].to(torch.bfloat16).contiguous()
            keep.append(e)
            ptrs.append(e.data_ptr())
            ints += [counts[i], samples_per_ray[i]]
            for t in (scale0[i], bias0[i], scale1[i], bias1[i]):
                stride, ptr = t.stride(), t.data_ptr()
                if stride[1] != 1 or stride[0] % 2 or ptr % 8:
                    t = t.contiguous()
                    keep.append(t)
                    stride, ptr = t.stride(), t.data_ptr()
                ptrs.append(ptr)
                ints.append(stride[0])
            ptrs += [images[i].data_ptr(), biases[i].data_ptr(), features[i].data_ptr(), alphas[i].data_ptr()]
        table = adain_pair_table([counts[i] for i in chunk], ctas, tile)
        err = launch_group(
            len(chunk), (ctypes.c_void_p * len(ptrs))(*ptrs), (ctypes.c_int * len(ints))(*ints),
            (ctypes.c_int * len(table))(*table), pe, width, layers, skip, out_features, stream,
        )
        if err != 0:
            raise RuntimeError(f"fused_adain_nerf kernel launch failed with CUDA error {err}")
        fused_adain_nerf.launches += 1
        fused_adain_nerf.objects += len(chunk)
    return [t for pair in zip(features, alphas) for t in pair]


@_adain_group_op.register_kernel("cpu")
def _adain_group_cpu(encoded, scale0, bias0, scale1, bias1, images, biases, packed, samples_per_ray, width, layers,
                     skip, out_features):
    """The CPU implementation: plain_adain_nerf object by object."""
    names, shape, outputs = _packed_names(layers), _MLPShape(layers, skip), []
    for i, e in enumerate(encoded):
        weights = dict(zip(names, packed[i * len(names) : (i + 1) * len(names)]))
        outputs += plain_adain_nerf(shape, weights, e, scale0[i], bias0[i], scale1[i], bias1[i], samples_per_ray[i])
    return outputs


@_adain_group_op.register_fake
def _adain_group_fake(encoded, scale0, bias0, scale1, bias1, images, biases, packed, samples_per_ray, width, layers,
                      skip, out_features):
    """The outputs' shapes: (N, out_features) features and (N,) raw alpha,
    f32, an object."""
    return [t for e in encoded for t in (e.new_empty((e.shape[0], out_features), dtype=torch.float32),
                                         e.new_empty((e.shape[0],), dtype=torch.float32))]


def fused_adain_nerf_group(cfg: NerfMLPConfig, items: Sequence[AdaInNerfItem]) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """The MLP over several objects of one configuration, each with its own
    weights, encodings and modulation: [((N, output_features) f32 features,
    (N,) f32 raw alpha)] in the order of `items`, through the registered
    operator `playableenvironments_torch::fused_adain_nerf_group`
    (`_adain_group_op`).

    CPU tensors take `plain_adain_nerf` object by object. CUDA tensors run
    one kernel launch for up to 16 objects (objects without points take
    none), walking the pair table of `adain_pair_table`; each launch adds 1
    to `fused_adain_nerf.launches` and its objects to
    `fused_adain_nerf.objects`. On the card an MLP narrower than the kernel
    takes runs at its weights' padded width (`NerfKernelWeights.width`), its
    modulation zero-padded to it (`padded_modulation`). Any other device, a
    width above the kernel's, or a failed build or launch raises.
    """
    for item in items:
        _check_item(cfg, item)
    if not items:
        return []
    device = items[0].encoded.device
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused_adain_nerf runs on cuda or cpu tensors, not {device}")
    out_features = items[0].weights.packed["w_out"].shape[1]
    if any(it.weights.packed["w_out"].shape[1] != out_features for it in items):
        raise ValueError("the objects of one group must have the same output_features")
    width = cfg.layers_width
    if device.type == "cuda":
        width = items[0].weights.width
        if any(it.weights.width != width for it in items):
            raise ValueError("the objects of one group must have weights of one width")
        items = [padded_modulation(it, width) for it in items]
    names = _packed_names(cfg.backbone_layers_count)
    outputs = _adain_group_op(
        [it.encoded for it in items], [it.scale0 for it in items], [it.bias0 for it in items],
        [it.scale1 for it in items], [it.bias1 for it in items],
        [it.weights.image if it.weights.image is not None else it.weights.biases.new_empty((0,)) for it in items],
        [it.weights.biases for it in items], [it.weights.packed[n] for it in items for n in names],
        [it.samples_per_ray for it in items], width, cfg.backbone_layers_count, cfg.skip_layer_idx,
        out_features,
    )
    return list(zip(outputs[0::2], outputs[1::2]))


def padded_modulation(item: AdaInNerfItem, width: int) -> AdaInNerfItem:
    """`item` with scale0/bias0 zero-padded to `width` columns and
    scale1/bias1 to `width` // 2 (a padded feature-head unit's product is 0
    and so is its modulated output); the item itself at its own width."""
    have = item.scale0.shape[1]
    if have == width:
        return item
    pad = torch.nn.functional.pad
    extra, extra_half = width - have, width // 2 - item.scale1.shape[1]
    return item._replace(scale0=pad(item.scale0, (0, extra)), bias0=pad(item.bias0, (0, extra)),
                         scale1=pad(item.scale1, (0, extra_half)), bias1=pad(item.bias1, (0, extra_half)))


def fused_adain_nerf(
    cfg: NerfMLPConfig,
    weights: NerfKernelWeights,
    encoded: torch.Tensor,
    scale0: torch.Tensor,
    bias0: torch.Tensor,
    scale1: torch.Tensor,
    bias1: torch.Tensor,
    samples_per_ray: int = 1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The MLP over one object's pre-encoded points, ray-major (N = rays *
    samples_per_ray): `fused_adain_nerf_group` of one item.

    :param encoded: (N, pe) encodings (rounded to bf16 on the card).
    :param scale0/bias0: (N / samples_per_ray, W) f32 per-ray modulation;
        scale1/bias1 (N / samples_per_ray, W // 2).
    :return: ((N, output_features) f32 features, (N,) f32 raw alpha).
    """
    item = AdaInNerfItem(weights, encoded, scale0, bias0, scale1, bias1, samples_per_ray)
    return fused_adain_nerf_group(cfg, [item])[0]


fused_adain_nerf.launches = 0
fused_adain_nerf.objects = 0


class ObjectField(NamedTuple):
    """One object's eval-mode field query for `fused_object_field_eval_group`:
    its bounding box, models.nerf.AdaInNerfMLP, (..., rays, samples, 3)
    object-frame points, (..., rays, 1, style_features) style (constant
    along each ray) and the alpha of empty space."""

    bounding_box: object
    nerf: object
    positions: torch.Tensor
    style: torch.Tensor
    empty_space_alpha: float


def fused_object_field_eval_group(
    cfg: NerfMLPConfig, fields: Sequence[ObjectField]
) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Eval-mode object fields of one NeRF configuration through one grouped
    MLP call: bbox mask, bbox normalization, positional encoding and the
    AdaIN fold here per object, the MLP in the kernel, empty-space masking
    after.

    :return: per field, ((..., rays, samples, F) features, (..., rays,
        samples) raw alphas).
    """
    items, masks = [], []
    for f in fields:
        positions = f.positions
        box = torch.as_tensor(f.bounding_box, dtype=positions.dtype, device=positions.device)
        masks.append(aabb_contains(box, positions))
        ray_shape = positions.shape[:-2]
        style_rays = f.style[..., 0, :].expand(ray_shape + f.style.shape[-1:])
        flat_style = style_rays.reshape(-1, f.style.shape[-1])
        pe_cfg = cfg.position_encoder
        encoded = positional_encoding(positions.reshape(-1, 3) / aabb_size(box), pe_cfg.octaves,
                                      pe_cfg.append_original)
        scale0, bias0 = fold_adain_stats(f.nerf.adain_0, flat_style)
        scale1, bias1 = fold_adain_stats(f.nerf.adain_1, flat_style)
        items.append(AdaInNerfItem(f.nerf.kernel_weights(), encoded, scale0, bias0, scale1, bias1,
                                   positions.shape[-2]))

    results = []
    for f, mask, (features, alpha) in zip(fields, masks, fused_adain_nerf_group(cfg, items)):
        batch_shape = f.positions.shape[:-1]
        features = features.reshape(batch_shape + (features.shape[-1],))
        alpha = alpha.reshape(batch_shape)
        results.append((torch.where(mask[..., None], features, 0.0),
                        torch.where(mask, alpha, float(f.empty_space_alpha))))
    return results


def fused_object_field_eval(
    cfg: NerfMLPConfig,
    bounding_box,
    nerf,
    positions: torch.Tensor,
    style: torch.Tensor,
    empty_space_alpha: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One object's eval-mode field through the fused MLP
    (`fused_object_field_eval_group` of one field).

    :param nerf: models.nerf.AdaInNerfMLP.
    :param positions: (..., rays, samples, 3) object-frame points.
    :param style: (..., rays, 1, style_features), constant along each ray.
    :return: ((..., rays, samples, F) features, (..., rays, samples) raw alphas).
    """
    field = ObjectField(bounding_box, nerf, positions, style, empty_space_alpha)
    return fused_object_field_eval_group(cfg, [field])[0]


# ---------------------------------------------------------------------------
# Trainable fused backbone (the JAX package's custom-VJP `fused_backbone`)
# ---------------------------------------------------------------------------

# The 128-point backbone kernels pad the encoding to this many columns, work
# on tiles of this many points, and keep the ReLU masks of at most this many
# layers in shared memory (csrc/fused_backbone.cu: kPe, kTile, kMaxLayers);
# the wide ones (_WIDE_*) pad it to 64 or 128 and keep the masks in a global
# scratch. Weights and scratch are arrays of 64 x 64 bf16 blocks in wgmma's
# 128-byte swizzle.
_BACKBONE_PE = 64
_BACKBONE_TILE = 128
_BACKBONE_MAX_LAYERS = 8
_BLOCK = 64


def _backbone_sizes(cfg: NerfMLPConfig, encoded_size: int) -> List[int]:
    """Input width of each backbone layer (the skip layer takes h ++ encoding)."""
    widths_in = []
    for i in range(cfg.backbone_layers_count):
        w_in = encoded_size if i == 0 else cfg.layers_width
        if i == cfg.skip_layer_idx and i != 0:
            w_in += encoded_size
        widths_in.append(w_in)
    return widths_in


def _backbone_names(cfg: NerfMLPConfig) -> List[str]:
    names = []
    for i in range(cfg.backbone_layers_count):
        names += [f"w{i}", f"b{i}"]
    return names + ["w_alpha", "b_alpha"]


def _weight_list(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """[w0, b0 (1, W), ..., w_alpha (W, 1), b_alpha (1, 1)], the JAX kernels'
    argument order."""
    return [
        packed[name].reshape(1, -1) if name.startswith("b") else packed[name]
        for name in _backbone_names(cfg)
    ]


def _operand_rounding(cfg: NerfMLPConfig):
    """x -> x rounded to the matmul operand dtype, kept in x's dtype (f32,
    or f64 for a reference with f64 sums)."""
    if cfg.compute_dtype == "float32":
        return lambda x: x
    dtype = getattr(torch, cfg.compute_dtype)
    return lambda x: x.to(dtype).to(x.dtype)


def _plain_backbone_acts(cfg, packed, encoded, rnd) -> List[torch.Tensor]:
    acts, h = [], encoded
    for i in range(cfg.backbone_layers_count):
        if i == cfg.skip_layer_idx and i != 0:
            h = torch.cat([h, encoded], dim=-1)
        h = torch.relu(rnd(h) @ rnd(packed[f"w{i}"]) + packed[f"b{i}"])
        acts.append(h)
    return acts


def plain_backbone_fwd(
    cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backbone + alpha head in plain PyTorch, as the TPU forward kernel
    computes it: matmul operands rounded to `compute_dtype`, everything else
    f32.

    :param packed: w{i} (in_i, W), b{i} (W,), w_alpha (W, 1), b_alpha (1,).
    :param encoded: (N, E) f32 encodings.
    :return: ((N, W) post-ReLU h, (N,) raw alpha).
    """
    rnd = _operand_rounding(cfg)
    h = _plain_backbone_acts(cfg, packed, encoded, rnd)[-1]
    alpha = rnd(h) @ rnd(packed["w_alpha"]) + packed["b_alpha"]
    return h, alpha[:, 0]


def plain_backbone_bwd(
    cfg: NerfMLPConfig,
    packed: Dict[str, torch.Tensor],
    encoded: torch.Tensor,
    g_h: torch.Tensor,
    g_alpha: torch.Tensor,
    masks: Optional[Sequence[torch.Tensor]] = None,
    magnitudes: bool = False,
    acts: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The TPU backward kernel's explicit backward in plain PyTorch (not
    autograd): recompute the activations, back-propagate through the ReLU
    chain, split the skip layer's input gradient.

    :param g_h: (N, W) cotangent of h; :param g_alpha: (N,) of alpha.
    :param masks: each layer's (N, W) ReLU pattern to take the derivative
        at; by default the recomputed activations' own (> 0).
    :param magnitudes: return each output's rounding scale instead: the
        backward's products over the magnitudes of their rounded operands,
        so that a weight gradient's element is sum_n |x_n| |g_n| with |g|
        carried back through |W| from |g_h| and |g_alpha|. An
        implementation's rounding error is a small part of this scale,
        also where the gradient itself is a sum that cancels to far less.
    :param acts: each layer's (N, W) post-ReLU output as some
        implementation computed it (backbone_layer_outputs), to take the
        layer inputs and the ReLU pattern from; by default recomputed here.
    :return: ({name: gradient in that weight's shape}, (N, E) d_encoded).
    """
    rnd = _operand_rounding(cfg)
    layers, width = cfg.backbone_layers_count, cfg.layers_width
    acts = list(acts) if acts is not None else _plain_backbone_acts(cfg, packed, encoded, rnd)
    if magnitudes:
        rnd = (lambda round_: lambda x: round_(x).abs())(rnd)
        g_h, g_alpha = g_h.abs(), g_alpha.abs()
    g_alpha = g_alpha[:, None]
    grads = {
        "w_alpha": rnd(acts[-1]).t() @ rnd(g_alpha),
        "b_alpha": g_alpha.sum(dim=0),
    }
    g = g_h + rnd(g_alpha) @ rnd(packed["w_alpha"]).t()
    d_encoded = torch.zeros_like(encoded)
    for i in range(layers - 1, -1, -1):
        g = g * (acts[i] > 0.0 if masks is None else masks[i])
        if i == 0:
            layer_in = encoded
        elif i == cfg.skip_layer_idx:
            layer_in = torch.cat([acts[i - 1], encoded], dim=-1)
        else:
            layer_in = acts[i - 1]
        grads[f"w{i}"] = rnd(layer_in).t() @ rnd(g)
        grads[f"b{i}"] = g.sum(dim=0)
        g_in = rnd(g) @ rnd(packed[f"w{i}"]).t()
        if i == 0:
            d_encoded = d_encoded + g_in
        elif i == cfg.skip_layer_idx:
            d_encoded = d_encoded + g_in[:, width:]
            g = g_in[:, :width]
        else:
            g = g_in
    return grads, d_encoded


def rounding_error_ratio(got: torch.Tensor, ref: torch.Tensor, scale: torch.Tensor) -> Tuple[float, float]:
    """|got - ref| / scale element-wise in f64, as (max, mean), for a
    rounding scale from plain_backbone_bwd(magnitudes=True). Where a scale
    is 0 every term was 0; it stands there at 2^-24 of the largest scale
    (at 1e-300 where all are 0, so that anything but 0 reads as huge)."""
    err = (got.double() - ref.double().reshape(got.shape)).abs()
    scale = scale.double().reshape(got.shape)
    ratio = err / scale.clamp_min(max(scale.max().item() * 2.0 ** -24, 1e-300))
    return ratio.max().item(), ratio.mean().item()


def relu_pattern_check(
    cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor, layer_outputs
) -> Tuple[List[torch.Tensor], List[Dict[str, float]]]:
    """Holds each layer's post-ReLU output, as some implementation computes
    it, against the f64 forward (its own ReLUs, f64 products and sums).

    Each unit's pre-activation z is measured in units of its rounding scale
    s = sum_k |x_k w_kj| + |b_j| (f64 inputs x): an implementation with f32
    sums is off by a few f32 ulps of s, and takes a ReLU on the other side
    of f64's only where |z| lies within that.

    :param layer_outputs: an iterable of the (N, W) outputs of layers 0, 1,
        ..., consumed one at a time (a generator keeps one on the card).
    :return: (each layer's ReLU pattern, output > 0; for each layer
        {"flips": units whose pattern differs from f64's, "flip_ratio": the
        largest |z| / s among them (0 without one), "error_ratio": the
        largest |output - z| / s where both are positive}).
    """
    p = {k: v.double() for k, v in packed.items()}
    enc = encoded.double()
    h, masks, rows = enc, [], []
    for i, out in zip(range(cfg.backbone_layers_count), layer_outputs):
        if i == cfg.skip_layer_idx and i != 0:
            h = torch.cat([h, enc], dim=-1)
        scale = h.abs() @ p[f"w{i}"].abs() + p[f"b{i}"].abs()
        z = h @ p[f"w{i}"] + p[f"b{i}"]
        mask = out > 0
        positive = z > 0
        flipped = mask != positive
        both = mask & positive
        rows.append({
            "flips": int(flipped.sum()),
            "flip_ratio": (z.abs() / scale)[flipped].max().item() if bool(flipped.any()) else 0.0,
            "error_ratio": ((out.double() - z).abs() / scale)[both].max().item() if bool(both.any()) else 0.0,
        })
        masks.append(mask)
        h = torch.relu(z)
        del scale, z, positive, flipped, both, out
    return masks, rows


def _encoding_blocks(pe: int) -> int:
    """The 64-column blocks the kernels pad a `pe`-column encoding to: 1
    (the 128-point kernels' 64 columns) to 4."""
    return max(1, -(-pe // _BLOCK))


def _layer_slots(cfg: NerfMLPConfig, pe: int = _BACKBONE_PE, concat: bool = False) -> List[List[Tuple[int, int]]]:
    """For each layer, its slots of the weight image in order, each as
    (first weight row, rows): 64 input rows of the layer's (in, W) matrix,
    the encoding's `pe` rows zero-padded to 64 `_encoding_blocks(pe)`
    (csrc/fused_backbone.cu), twice in layer 0 with `concat` (B1's skip 0:
    layer 0 reads [encoding, encoding])."""
    width, skip = cfg.layers_width, cfg.skip_layer_idx

    def encoding(first):
        return [(first + r, min(_BLOCK, pe - r)) for r in range(0, _BLOCK * _encoding_blocks(pe), _BLOCK)]

    layers = []
    for i in range(cfg.backbone_layers_count):
        if i == 0:
            layers.append(encoding(0) + (encoding(pe) if concat else []))
        else:
            slots = [(r, _BLOCK) for r in range(0, width, _BLOCK)]
            if i == skip:
                slots += encoding(width)
            layers.append(slots)
    return layers


def swizzled(row, col):
    """Element offset of (row, col) in a 64 x 64 bf16 block of wgmma's
    128-byte swizzle: row r holds 128 bytes whose 16-byte chunks are XOR-ed
    with r % 8."""
    return row * _BLOCK + ((col // 8) ^ (row % 8)) * 8 + col % 8


def backbone_buffers(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], pe: Optional[int] = None,
                     pad: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """The backbone's weights as csrc/fused_backbone.cu (and B1, which
    shares its backbone) reads them, whatever the configuration's
    `compute_dtype`: the bf16 weight image (every layer's 64-row slots,
    each W/64 swizzled 64 x 64 blocks, then w_alpha) and the f32 biases
    b_0 .. b_{L-1}, b_alpha, W the width the bf16 kernels run it at (the
    weights zero-padded to it, `padded_weights`; B1 pads them itself and
    passes `pad=False`). `pe`: the encoding's columns, w0's rows by default;
    fewer than w0's rows for B1 at skip 0, whose layer 0 then takes both
    halves of its rows. A handful of small kernels a launch: the slots' rows
    in one cat, one cast, one gather for the swizzle."""
    pe = packed["w0"].shape[0] if pe is None else pe
    if pad:
        cfg, packed = padded_weights(cfg, packed, backbone_kernel_width(replace(cfg, compute_dtype="bfloat16"), pe))
    width = cfg.layers_width
    with torch.no_grad():
        rows = []
        for i, layer in enumerate(_layer_slots(cfg, pe, concat=packed["w0"].shape[0] > pe)):
            w = packed[f"w{i}"]
            for first, count in layer:
                block = w[first : first + count]  # fewer than 64 rows only for the encoding's
                pad = _BLOCK - block.shape[0]
                rows.append(torch.nn.functional.pad(block, (0, 0, 0, pad)) if pad else block)
        slots = torch.cat(rows).to(torch.bfloat16).reshape(-1, _BLOCK, width // _BLOCK, _BLOCK)
        blocks = slots.permute(0, 2, 1, 3).reshape(-1, _BLOCK * _BLOCK)
        image = blocks[:, _unswizzle(blocks.device)]
        weights = torch.cat([image.reshape(-1), packed["w_alpha"].reshape(-1).to(torch.bfloat16)])
        biases = torch.cat(
            [packed[f"b{i}"].reshape(-1) for i in range(cfg.backbone_layers_count)]
            + [packed["b_alpha"].reshape(-1)]
        ).to(torch.float32).contiguous()
    return weights, biases


@functools.lru_cache(maxsize=None)
def _unswizzle(device: torch.device) -> torch.Tensor:
    """For each element of a swizzled 64 x 64 block, the row-major index of
    the element it holds (the inverse of `swizzled`)."""
    r, c = torch.meshgrid(torch.arange(_BLOCK), torch.arange(_BLOCK), indexing="ij")
    index = torch.empty(_BLOCK * _BLOCK, dtype=torch.int64)
    index[swizzled(r, c).reshape(-1)] = torch.arange(_BLOCK * _BLOCK)
    return index.to(device)


def _kernel_skip(cfg: NerfMLPConfig) -> int:
    """The skip layer as the kernels take it: skip_layer_idx 0 means no
    skip (as in _backbone_sizes), which the kernels read as `layers`."""
    return cfg.skip_layer_idx or cfg.backbone_layers_count


def backbone_is_wide(cfg: NerfMLPConfig, pe: int) -> bool:
    """Whether the backbone kernels run cfg over a `pe`-column encoding in
    their wide versions (width above 256, encoding above 64 columns, more
    than 8 layers) rather than the 128-point (bf16) or 256-wide (f32) ones."""
    return cfg.layers_width > _MAX_WIDTH or pe > _BACKBONE_PE or cfg.backbone_layers_count > _BACKBONE_MAX_LAYERS


def backbone_kernel_width(cfg: NerfMLPConfig, pe: int = _BACKBONE_PE) -> int:
    """The width the backbone kernels of cfg's `compute_dtype` run it at
    over a `pe`-column encoding: in the wide kernels (`backbone_is_wide`)
    256, 512 or 640; otherwise for float32 operands the narrowest of 64, 128 and
    256 that holds it, for bfloat16 the next multiple of 64; above 512, the
    width itself (the kernels refuse it)."""
    width = cfg.layers_width
    if backbone_is_wide(cfg, pe):
        return next((w for w in _WIDE_WIDTHS if width <= w), width)
    if cfg.compute_dtype == "float32":
        return next(w for w in _F32_WIDTHS if width <= w)
    return -(-width // _BLOCK) * _BLOCK


def kernel_backbone(cfg: NerfMLPConfig,
                    packed: Dict[str, torch.Tensor]) -> Tuple[NerfMLPConfig, Dict[str, torch.Tensor]]:
    """(cfg, packed) at `backbone_kernel_width`, zero-padded (`padded_weights`)."""
    return padded_weights(cfg, packed, backbone_kernel_width(cfg, packed["w0"].shape[0]))


def unpadded_backbone_grads(cfg: NerfMLPConfig, grads: Dict[str, torch.Tensor],
                            width: int) -> Dict[str, torch.Tensor]:
    """The gradients of cfg's backbone padded to `width` (`padded_weights`)
    cut back to its own weights' shapes: the padded rows and columns go (at
    the skip layer the rows between h's and the encoding's)."""
    old = cfg.layers_width
    if width == old:
        return grads
    out = {}
    for i in range(cfg.backbone_layers_count):
        g = grads[f"w{i}"]
        if i == 0:
            out[f"w{i}"] = g[:, :old]
        elif i == cfg.skip_layer_idx:
            out[f"w{i}"] = torch.cat([g[:old, :old], g[width:, :old]])
        else:
            out[f"w{i}"] = g[:old, :old]
        out[f"b{i}"] = grads[f"b{i}"][..., :old]
    out["w_alpha"] = grads["w_alpha"][:old]
    out["b_alpha"] = grads["b_alpha"]
    return out


def padded_backbone_fwd(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor, run,
                        *args) -> Tuple[torch.Tensor, torch.Tensor]:
    """`run`(cfg', packed', encoded, *args), a forward of the backbone, at
    the kernels' width (`kernel_backbone`), h cut back to cfg's width."""
    kcfg, kpacked = kernel_backbone(cfg, packed)
    h, alpha = run(kcfg, kpacked, encoded, *args)
    return h[:, : cfg.layers_width], alpha


def padded_backbone_bwd(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor,
                        g_h: torch.Tensor, g_alpha: torch.Tensor, run, *args):
    """`run`(cfg', packed', encoded, g_h', g_alpha, *args), a backward of the
    backbone, at the kernels' width: g_h zero-padded to it, the weights'
    gradients cut back to cfg's shapes (`unpadded_backbone_grads`)."""
    kcfg, kpacked = kernel_backbone(cfg, packed)
    g_h = torch.nn.functional.pad(g_h, (0, kcfg.layers_width - cfg.layers_width))
    grads, d_encoded = run(kcfg, kpacked, encoded, g_h, g_alpha, *args)
    return unpadded_backbone_grads(cfg, grads, kcfg.layers_width), d_encoded


def _backbone_kernel_checks(cfg: NerfMLPConfig, encoded: torch.Tensor, tensors) -> None:
    """Raises for what the kernels do not take (`cfg` at its kernel width,
    `kernel_backbone`): `tensors` must be f32 on the card of `encoded`. The
    kernels follow `compute_dtype`: bfloat16 operands
    (csrc/fused_backbone.cu, widths multiple of 64 up to 256) or float32
    (csrc/fused_backbone_f32.cu, widths 64, 128 and 256), both with wide
    versions at widths 256, 512 and 640, encodings up to 256 columns and
    any number of layers."""
    width, pe = cfg.layers_width, encoded.shape[1]
    if cfg.compute_dtype not in ("float32", "bfloat16"):
        raise NotImplementedError(
            f"the backbone kernels take bfloat16 or float32 operands, not compute_dtype {cfg.compute_dtype!r}"
        )
    if width > _WIDE_WIDTHS[-1]:
        raise ValueError(f"layers_width {width}: the backbone kernels take widths up to {_WIDE_WIDTHS[-1]}")
    if pe > _WIDE_MAX_PE:
        raise ValueError(f"encoding width {pe} exceeds the backbone kernels' {_WIDE_MAX_PE}")
    widths = (_F32_WIDTHS if cfg.compute_dtype == "float32" else range(64, _MAX_WIDTH + 1, 64))
    if width not in (_WIDE_WIDTHS if backbone_is_wide(cfg, pe) else widths):
        raise ValueError(f"layers_width {width}: the backbone kernels take it padded "
                         f"(`kernel_backbone`, to {backbone_kernel_width(cfg, pe)})")
    if encoded.device.type != "cuda":
        raise ValueError(f"the fused backbone runs on cuda or cpu tensors, not {encoded.device}")
    for t in tensors:
        if t.device != encoded.device or t.dtype != torch.float32:
            raise ValueError(f"inputs must be float32 on {encoded.device}, got {t.dtype} on {t.device}")


def fused_backbone_fwd(
    cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor, buffers=None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone + alpha head over (N, E) f32 encodings -> ((N, W) h, (N,) alpha).

    CPU tensors take `plain_backbone_fwd`. CUDA tensors launch the forward
    kernel (counted in `fused_backbone_fwd.launches`) on `buffers`, the
    (weights, biases) of `backbone_buffers`, built here when not given, at
    the kernel's width (`padded_backbone_fwd`); any other device, an
    unsupported configuration, or a failed build or launch raises.
    """
    if encoded.device.type == "cpu":
        return plain_backbone_fwd(cfg, packed, encoded)
    if cfg.compute_dtype == "float32":
        return backbone_f32_fwd(cfg, packed, encoded, buffers)
    return padded_backbone_fwd(cfg, packed, encoded, _backbone_fwd, buffers)


def _backbone_fwd(cfg, packed, encoded, buffers):
    """One launch of the bf16 forward kernel, `cfg` at a width it takes."""
    _backbone_kernel_checks(cfg, encoded, [encoded] + list(packed.values()))
    n, pe = encoded.shape
    width = cfg.layers_width
    weights, biases = buffers if buffers is not None else backbone_buffers(cfg, packed)
    encoded = encoded.contiguous()
    h = torch.empty((n, width), dtype=torch.float32, device=encoded.device)
    alpha = torch.empty((n,), dtype=torch.float32, device=encoded.device)
    if n == 0:
        return h, alpha
    lib = _backbone_library()
    wide = backbone_is_wide(cfg, pe)
    launch = lib.fused_backbone_wide_fwd_launch if wide else lib.fused_backbone_fwd_launch
    err = launch(
        encoded.data_ptr(), weights.data_ptr(), biases.data_ptr(), h.data_ptr(), alpha.data_ptr(),
        n, pe, width, cfg.backbone_layers_count, _kernel_skip(cfg),
        backbone_grid(n, _sm_count(encoded.device), _WIDE_TILE if wide else _BACKBONE_TILE),
        torch.cuda.current_stream(encoded.device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_backbone_fwd kernel launch failed with CUDA error {err}")
    fused_backbone_fwd.launches += 1
    return h, alpha


fused_backbone_fwd.launches = 0


def _backbone_grad_rows(cfg: NerfMLPConfig, pe: int = _BACKBONE_PE) -> int:
    """Rows of the kernel's padded weight-gradient matrix (the encoding's
    `pe` rows padded to 64 `_encoding_blocks(pe)`)."""
    width, skip, pe_pad = cfg.layers_width, cfg.skip_layer_idx, _BLOCK * _encoding_blocks(pe)
    rows = 0
    for i in range(cfg.backbone_layers_count):
        rows += pe_pad if i == 0 else (width + pe_pad if i == skip else width)
    return rows


def _unpack_backbone_grads(cfg: NerfMLPConfig, grads_out: torch.Tensor, pe: int) -> Dict[str, torch.Tensor]:
    """The backward kernels' flat f32 output -> {name: gradient}: the weight
    gradients as (rows, W) in the padded row order of backbone_buffers, then
    db_0 .. db_{L-1}, dW_alpha (W), db_alpha (1)."""
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, cfg.skip_layer_idx
    rows_pad, pe_pad = _backbone_grad_rows(cfg, pe), _BLOCK * _encoding_blocks(pe)
    dw = grads_out[: rows_pad * width].view(rows_pad, width)
    small = grads_out[rows_pad * width :]
    grads, start = {}, 0
    for i in range(layers):
        if i == 0:
            grads["w0"] = dw[:pe]
            start = pe_pad
        elif i == skip:
            grads[f"w{i}"] = torch.cat([dw[start : start + width], dw[start + width : start + width + pe]])
            start += width + pe_pad
        else:
            grads[f"w{i}"] = dw[start : start + width]
            start += width
        grads[f"b{i}"] = small[i * width : (i + 1) * width]
    grads["w_alpha"] = small[layers * width : layers * width + width].reshape(width, 1)
    grads["b_alpha"] = small[layers * width + width :]
    return grads


def backbone_x_columns(cfg: NerfMLPConfig, ps: int = 1) -> List[List[int]]:
    """For each layer, the X column blocks (`backbone_scratch_shapes`) that
    feed its rows of the padded weight gradient, 64 rows each, in order: the
    encoding (blocks 0 .. ps - 1, `ps` its 64-column blocks) for layer 0;
    layer i's input, layer i - 1's activation (blocks ps + (i - 1) W/64 +
    j), then at the skip layer the encoding again. The weight-gradient
    kernel pairs them into 128-row output tiles within each layer."""
    nb = cfg.layers_width // _BLOCK
    columns = []
    for i in range(cfg.backbone_layers_count):
        if i == 0:
            columns.append(list(range(ps)))
        else:
            columns.append([ps + (i - 1) * nb + j for j in range(nb)]
                           + (list(range(ps)) if i == cfg.skip_layer_idx else []))
    return columns


def backbone_grid(n: int, sm_count: int, tile: int = _BACKBONE_TILE) -> int:
    """CTAs of the persistent kernels (the forward and the backward's
    per-tile kernel) for n points on a card of `sm_count` SMs: one per SM,
    at most one per tile (128 points; the wide kernels' 64)."""
    return min(-(-n // tile), sm_count)


def backbone_scratch_shapes(cfg: NerfMLPConfig, n: int, sm_count: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the backward's scratch for n points on a card of
    `sm_count` SMs: x (bf16 X blocks), g (bf16 G blocks), tile_part (f32
    column sums, one row per warpgroup of the per-tile kernel's
    `backbone_grid` CTAs), partial (f32 weight-gradient slabs, one per
    point chunk of the dW product, as many chunks as fill the SMs once).
    X[p, c] and G[p, c] hold points 64 p .. 64 p + 63 of feature columns
    64 c .. 64 c + 63 as a 64 x 64 block in `swizzled` order."""
    width, layers = cfg.layers_width, cfg.backbone_layers_count
    point_blocks = 2 * -(-n // _BACKBONE_TILE)
    dw_tiles = sum(-(-len(c) // 2) for c in backbone_x_columns(cfg))
    chunks = max(1, min(point_blocks, sm_count // dw_tiles))
    nb = width // _BLOCK
    return {
        "x": (point_blocks, 1 + (layers - 1) * nb, _BLOCK, _BLOCK),
        "g": (point_blocks, layers * nb, _BLOCK, _BLOCK),
        "tile_part": (2 * backbone_grid(n, sm_count), layers * width + width + 1),
        "partial": (chunks, _backbone_grad_rows(cfg), width),
    }


def backbone_wide_scratch_shapes(cfg: NerfMLPConfig, n: int, sm_count: int, pe: int) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the wide backward's scratch for n points over a `pe`-column
    encoding: as `backbone_scratch_shapes` with 64-point tiles (one X and G
    point block a tile), the encoding's ps = `_encoding_blocks(pe)` column
    blocks first in X, one tile_part row per CTA (each warpgroup sums its
    own columns), the dW product's chunks over its column parts
    (`backbone_wide_dw_columns` each), and masks (int32 for u32): each
    tile-kernel thread's ReLU bits, W / 128 words a layer, per CTA."""
    width, layers, ps = cfg.layers_width, cfg.backbone_layers_count, _encoding_blocks(pe)
    tiles = -(-n // _WIDE_TILE)
    grid = backbone_grid(n, sm_count, _WIDE_TILE)
    dw_tiles = sum(-(-len(c) // 2) for c in backbone_x_columns(cfg, ps))
    parts = width // backbone_wide_dw_columns(width)
    nb = width // _BLOCK
    return {
        "x": (tiles, ps + (layers - 1) * nb, _BLOCK, _BLOCK),
        "g": (tiles, layers * nb, _BLOCK, _BLOCK),
        "tile_part": (grid, layers * width + width + 1),
        "partial": (max(1, min(tiles, sm_count // (parts * dw_tiles))), _backbone_grad_rows(cfg, pe), width),
        "masks": (grid, layers, width // 128, 256),
    }


def backbone_wide_dw_columns(width: int) -> int:
    """Output columns of one CTA of the wide backward's weight-gradient
    product (csrc/fused_backbone.cu::wide_dw_columns): half the width, or
    128 at 640, whose half (320) is more than one wgmma product's 256."""
    return width // 2 if width % 256 == 0 else 128


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _backbone_bwd(cfg, packed, encoded, g_h, g_alpha, buffers, ms):
    """Launches the backward kernels on the bf16 rounding of `encoded`, all
    they read of it, at their width (`padded_backbone_bwd`); `ms`, a ctypes
    array of 3 floats or None, receives the three kernels' times (the call
    then waits for them)."""
    return padded_backbone_bwd(cfg, packed, encoded, g_h, g_alpha, _backbone_bwd_launch, buffers, ms)


def _backbone_bwd_launch(cfg, packed, encoded, g_h, g_alpha, buffers, ms):
    _backbone_kernel_checks(cfg, encoded, [g_h, g_alpha] + list(packed.values()))
    n, pe = encoded.shape
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, _kernel_skip(cfg)
    device = encoded.device
    weights, biases = buffers if buffers is not None else backbone_buffers(cfg, packed)
    encoded = encoded.to(torch.bfloat16).contiguous()
    g_h, g_alpha = g_h.contiguous(), g_alpha.contiguous()
    d_encoded = torch.empty((n, pe), dtype=torch.float32, device=device)
    grads_out = torch.empty((_backbone_grad_rows(cfg, pe) * width + layers * width + width + 1,),
                            dtype=torch.float32, device=device)
    if n == 0:
        return _unpack_backbone_grads(cfg, grads_out.zero_(), pe), d_encoded
    stream, lib = torch.cuda.current_stream(device).cuda_stream, _backbone_library()
    dtypes = {"x": torch.bfloat16, "g": torch.bfloat16, "masks": torch.int32}
    if backbone_is_wide(cfg, pe):
        shapes = backbone_wide_scratch_shapes(cfg, n, _sm_count(device), pe)
        scratch = {k: torch.empty(v, dtype=dtypes.get(k, torch.float32), device=device) for k, v in shapes.items()}
        err = lib.fused_backbone_wide_bwd_launch(
            encoded.data_ptr(), g_h.data_ptr(), g_alpha.data_ptr(), weights.data_ptr(), biases.data_ptr(),
            d_encoded.data_ptr(), *(scratch[k].data_ptr() for k in ("x", "g", "tile_part", "partial", "masks")),
            grads_out.data_ptr(), n, pe, width, layers, skip, shapes["tile_part"][0], shapes["partial"][0],
            stream, ms,
        )
    else:
        shapes = backbone_scratch_shapes(cfg, n, _sm_count(device))
        scratch = {k: torch.empty(v, dtype=dtypes.get(k, torch.float32), device=device) for k, v in shapes.items()}
        err = lib.fused_backbone_bwd_launch(
            encoded.data_ptr(), g_h.data_ptr(), g_alpha.data_ptr(), weights.data_ptr(), biases.data_ptr(),
            d_encoded.data_ptr(), *(scratch[k].data_ptr() for k in ("x", "g", "tile_part", "partial")),
            grads_out.data_ptr(), n, pe, width, layers, skip, shapes["tile_part"][0] // 2, shapes["partial"][0],
            stream, ms,
        )
    if err != 0:
        raise RuntimeError(f"fused_backbone_bwd kernel launch failed with CUDA error {err}")
    return _unpack_backbone_grads(cfg, grads_out, pe), d_encoded


def fused_backbone_bwd(
    cfg: NerfMLPConfig,
    packed: Dict[str, torch.Tensor],
    encoded: torch.Tensor,
    g_h: torch.Tensor,
    g_alpha: torch.Tensor,
    buffers=None,
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    """The backbone's backward: ({name: gradient}, (N, E) f32 d_encoded) for
    the cotangents g_h (N, W) and g_alpha (N,). On the card the kernels
    read only the bf16 rounding of `encoded` (f32 or bf16, as the autograd
    Function saves it).

    CPU tensors take `plain_backbone_bwd`. CUDA tensors launch the backward
    kernels (one call counted in `fused_backbone_bwd.launches`) on
    `buffers` as in `fused_backbone_fwd`; the gradients are bit-identical
    from run to run on one card.
    """
    if encoded.device.type == "cpu":
        return plain_backbone_bwd(cfg, packed, encoded, g_h, g_alpha)
    if cfg.compute_dtype == "float32":
        return backbone_f32_bwd(cfg, packed, encoded, g_h, g_alpha, buffers)
    out = _backbone_bwd(cfg, packed, encoded, g_h, g_alpha, buffers, None)
    if encoded.shape[0]:
        fused_backbone_bwd.launches += 1
    return out


fused_backbone_bwd.launches = 0


def backbone_bwd_breakdown(cfg, packed, encoded, g_h, g_alpha) -> Dict[str, float]:
    """One backward on the card, timed by CUDA events around its three
    kernels (a measurement entry, not counted in the launches): ms of the
    per-tile kernel, the weight-gradient GEMM and the reduction."""
    ms = (ctypes.c_float * 3)()
    _backbone_bwd(cfg, packed, encoded, g_h, g_alpha, None, ms)
    return {"tile_ms": ms[0], "dw_ms": ms[1], "reduce_ms": ms[2]}


# ---- the f32 backbone kernels (csrc/fused_backbone_f32.cu) -------------------

# Widths the f32 kernels take, points a tile, and tiles of points the
# backward walks at a time (its X and G scratch hold one chunk).
_F32_WIDTHS = (64, 128, 256)
_F32_TILE = 64
_F32_CHUNK_TILES = 1024
_F32_BLOCK_POINTS = 32  # points of a scratch block: one 128-byte feature row


class F32Buffers(NamedTuple):
    """The f32 kernels' weights (csrc/fused_backbone_f32.cu): the `fwd` and
    `bwd` 3xTF32 images (2 x rows_pad x W floats each), the biases b_0 ..
    b_{L-1}, b_alpha and w_alpha (W), f32."""

    fwd: torch.Tensor
    bwd: torch.Tensor
    biases: torch.Tensor
    w_alpha: torch.Tensor


def backbone_f32_weights(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> List[torch.Tensor]:
    """Each layer's weight as the f32 kernels pad it, (rows_i, W): the
    encoding's rows zero-padded to 64 `_encoding_blocks` (layer 0, and after
    the activation rows at the skip layer), the rows of
    `_backbone_grad_rows`' order."""
    width, skip = cfg.layers_width, cfg.skip_layer_idx
    pe_pad = _BLOCK * _encoding_blocks(packed["w0"].shape[0])
    out = []
    for i in range(cfg.backbone_layers_count):
        w = packed[f"w{i}"].to(torch.float32)
        if i == 0:
            out.append(torch.nn.functional.pad(w, (0, 0, 0, pe_pad - w.shape[0])))
        elif i == skip:
            enc = w[width:]
            out.append(torch.cat([w[:width], torch.nn.functional.pad(enc, (0, 0, 0, pe_pad - enc.shape[0]))]))
        else:
            out.append(w)
    return out


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """f32 `x` rounded to TF32 (10 mantissa bits; nearest, ties away from
    zero: PTX's cvt.rna.tf32.f32), kept in f32."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x = big + small as the f32 kernels split an operand: big = x rounded
    to TF32, small = the rest rounded the same way."""
    big = tf32_round(x)
    return big, tf32_round(x.to(torch.float32) - big)


def f32_fragment_offset(n, k):
    """Float offset of (n, k) in one half of a slot: wgmma's K-major layout
    without swizzle, core matrices of 8 n x 4 k floats (128 bytes), the two
    of a k-step 32 floats apart, groups of 8 n 64 floats apart."""
    return (n // 8) * 64 + (k // 4) * 32 + (n % 8) * 4 + k % 4


def _logical_k(m):
    """The logical k that reads physical row m of a k-step: the kernels take
    the 8 K rows of a k-step in the order pi(k) = 2 (k % 4) + k / 4, so that
    an accumulator fragment is the next product's A fragment."""
    return (m // 2) + 4 * (m % 2)


def backbone_f32_pass(width: int) -> int:
    """The columns of one pass of the f32 kernels' products (csrc/
    fused_backbone_f32.cu::f32_pass): the width up to 256, then 256, or 128
    where 256 does not divide it (640)."""
    return width if width <= 256 else (256 if width % 256 == 0 else 128)


def plain_backbone_f32_buffers(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> F32Buffers:
    """The f32 kernels' weights built in plain PyTorch, the plain version of
    csrc/fused_backbone_f32.cu::backbone_f32_pack_kernel, bit for bit, at
    the kernels' width (`kernel_backbone`), in slots of np =
    `backbone_f32_pass(W)` columns or rows (one pass; two at W 512, five of
    128 at W 640, the wide kernels'). Layer i
    starts at float 2 W (padded rows before it) in both images:
    - fwd: for each pass c, its in_i / 8 slots (k-steps of its padded input
      rows, taken in `_logical_k`'s order), each big then small of (n = the
      output columns [np c, np (c + 1))) x 8 at `f32_fragment_offset`;
    - bwd: W / 8 slots for each 64-row group of its encoding rows as n
      (layer 0, and first at the skip layer), then (layers > 0) W / 8 slots
      for each np-row group of its W activation rows, k over the output
      columns in the same order."""
    cfg, packed = kernel_backbone(cfg, packed)
    width, skip = cfg.layers_width, _kernel_skip(cfg)
    np_, pe_pad = backbone_f32_pass(width), _BLOCK * _encoding_blocks(packed["w0"].shape[0])
    device = packed["w0"].device
    fwd, bwd = [], []
    with torch.no_grad():
        for i, w in enumerate(backbone_f32_weights(cfg, packed)):
            rows = w.shape[0]
            big, small = tf32_split(w)
            rr, c = torch.meshgrid(torch.arange(rows, device=device), torch.arange(width, device=device), indexing="ij")
            f = torch.empty(2 * rows * width, dtype=torch.float32, device=device)
            dst = ((c // np_) * (rows // 8) + rr // 8) * 16 * np_ + f32_fragment_offset(c % np_, _logical_k(rr % 8))
            f[dst] = big
            f[dst + 8 * np_] = small
            b = torch.empty_like(f)
            n_rows = torch.full_like(rr, np_)
            nn, base = rr % np_, (rr // np_) * (width // 8) * 16 * np_
            if i == 0 or i == skip:
                enc = rr >= width if i else torch.ones_like(rr, dtype=torch.bool)
                e = rr - width if i else rr
                n_rows[enc] = _BLOCK
                nn[enc] = e[enc] % _BLOCK
                base[enc] = (e[enc] // _BLOCK) * (width // 8) * 16 * _BLOCK
                base[~enc] += (pe_pad // _BLOCK) * (width // 8) * 16 * _BLOCK
            dst = base + (c // 8) * 16 * n_rows + f32_fragment_offset(nn, _logical_k(c % 8))
            b[dst] = big
            b[dst + 8 * n_rows] = small
            fwd.append(f)
            bwd.append(b)
        biases = torch.cat([packed[f"b{i}"].reshape(-1) for i in range(cfg.backbone_layers_count)]
                           + [packed["b_alpha"].reshape(-1)]).to(torch.float32)
        w_alpha = packed["w_alpha"].reshape(-1).to(torch.float32)
    return F32Buffers(torch.cat(fwd), torch.cat(bwd), biases.contiguous(), w_alpha.contiguous())


def backbone_f32_buffers(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> F32Buffers:
    """The f32 kernels' weights (`F32Buffers`, layouts in
    `plain_backbone_f32_buffers`). CPU tensors take the plain version; on
    the card one launch of backbone_f32_pack_kernel builds them from the
    packed weights as they lie (strided views included), counted in
    `backbone_f32_buffers.launches`. Raises for what the kernels do not
    take."""
    device = packed["w0"].device
    if device.type == "cpu":
        return plain_backbone_f32_buffers(cfg, packed)
    cfg, packed = kernel_backbone(cfg, packed)
    width, layers, pe = cfg.layers_width, cfg.backbone_layers_count, packed["w0"].shape[0]
    _backbone_kernel_checks(cfg, packed["w0"].new_empty((0, pe)), list(packed.values()))
    rows = _backbone_grad_rows(cfg, pe)
    fwd = torch.empty(2 * rows * width, dtype=torch.float32, device=device)
    bwd = torch.empty_like(fwd)
    biases = torch.empty(layers * width + 1, dtype=torch.float32, device=device)
    w_alpha = torch.empty(width, dtype=torch.float32, device=device)
    ws = [packed[f"w{i}"] for i in range(layers)]
    bs = [packed[f"b{i}"] for i in range(layers)]
    err = _backbone_f32_library().backbone_f32_pack_launch(
        (ctypes.c_void_p * layers)(*(w.data_ptr() for w in ws)),
        (ctypes.c_longlong * (2 * layers))(*(s for w in ws for s in w.stride())),
        (ctypes.c_void_p * layers)(*(b.data_ptr() for b in bs)),
        (ctypes.c_longlong * layers)(*(b.stride()[-1] for b in bs)),
        packed["w_alpha"].data_ptr(), packed["w_alpha"].stride()[0], packed["b_alpha"].data_ptr(),
        fwd.data_ptr(), bwd.data_ptr(), biases.data_ptr(), w_alpha.data_ptr(), width, layers, _kernel_skip(cfg), pe,
        _BLOCK * _encoding_blocks(pe), torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"backbone_f32_pack kernel launch failed with CUDA error {err}")
    backbone_f32_buffers.launches += 1
    return F32Buffers(fwd, bwd, biases, w_alpha)


backbone_f32_buffers.launches = 0


def backbone_f32_row_blocks(cfg: NerfMLPConfig, pe: int = _BACKBONE_PE) -> List[Tuple[int, int, int, int]]:
    """The f32 weight-gradient kernel's row blocks: (first padded row, X
    feature of its first 64 rows, of its second 64 rows or -1, layer). X
    holds the encoding (features 0 .. pe_pad - 1, `pe` columns padded to 64
    `_encoding_blocks`), then the activations of layers 0 .. L-2 (W each);
    layer i reads its input's 64-feature halves in its padded row order (the
    encoding for layer 0; layer i - 1's activation, then the encoding at the
    skip layer), two a block."""
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, _kernel_skip(cfg)
    encoding = [_BLOCK * e for e in range(_encoding_blocks(pe))]
    table, out_row = [], 0
    for i in range(layers):
        if i == 0:
            halves = encoding
        else:
            halves = [len(encoding) * _BLOCK + (i - 1) * width + _BLOCK * j for j in range(width // _BLOCK)]
            halves += encoding if i == skip else []
        for k in range(0, len(halves), 2):
            table.append((out_row + _BLOCK * k, halves[k], halves[k + 1] if k + 1 < len(halves) else -1, i))
        out_row += _BLOCK * len(halves)
    return table


def backbone_f32_dw_columns(cfg: NerfMLPConfig) -> int:
    """Output columns of one weight-gradient CTA: min(W, 128)."""
    return min(cfg.layers_width, 128)


def backbone_f32_scratch_shapes(cfg: NerfMLPConfig, n: int, sm_count: int,
                                pe: int = _BACKBONE_PE) -> Dict[str, Tuple[int, ...]]:
    """Shapes of the f32 backward's buffers for n points on a card of
    `sm_count` SMs. x and g: the X and G scratch of one chunk of points
    (`_F32_CHUNK_TILES` tiles of 64), feature-major in blocks of 32 points,
    X[b, f, swizzled(f, p % 32)] for point p = 32 b + p % 32 of the chunk,
    the 16-byte chunks of a feature's 128-byte row XOR-ed with f % 8 (X:
    the encoding, then the activations of layers 0 .. L-2; G: G_0 ..
    G_{L-1}). tile_part: the tile kernel's column sums, a row per warpgroup
    of its CTAs (as many as SMs, at most one per tile). partial: one
    weight-gradient slab per split of a chunk's points, as many splits as
    fill the SMs once. masks: each tile-kernel thread's ReLU mask bits
    (W / 4 of them in two words; int32 for u32), per CTA and layer. The wide
    kernels (`backbone_is_wide`; `pe` the encoding's columns, padded to
    pe_pad = 64 ps, ps = `_encoding_blocks(pe)`, in X) keep W / 128 words
    a layer and add `stash`: each tile-kernel thread's share of a layer's
    output, then the encoding's fragments, (grid, W / 8 + 8 ps, 128, 4) f32."""
    width, layers = cfg.layers_width, cfg.backbone_layers_count
    chunk_tiles = min(-(-n // _F32_TILE), _F32_CHUNK_TILES)
    grid = min(chunk_tiles, sm_count)
    blocks = chunk_tiles * _F32_TILE // _F32_BLOCK_POINTS
    dw_ctas = len(backbone_f32_row_blocks(cfg, pe)) * (width // backbone_f32_dw_columns(cfg))
    shapes = {
        "x": (blocks, _BLOCK * _encoding_blocks(pe) + (layers - 1) * width, _F32_BLOCK_POINTS),
        "g": (blocks, layers * width, _F32_BLOCK_POINTS),
        "tile_part": (2 * grid, layers * width + width + 1),
        "partial": (max(1, min(blocks, sm_count // dw_ctas)), _backbone_grad_rows(cfg, pe), width),
        "masks": (grid, layers, 2, 256),
    }
    if backbone_is_wide(cfg, pe):
        shapes.update(masks=(grid, layers, width // 128, 256), stash=backbone_f32_stash_shape(width, grid, pe))
    return shapes


def backbone_f32_stash_shape(width: int, grid: int, pe: int) -> Tuple[int, int, int, int]:
    """The f32 wide kernels' per-CTA global scratch: W / 8 k-steps of a
    layer's outputs, then the encoding's 8 ps, each a float4 per thread of a
    warpgroup."""
    return (grid, width // 8 + 8 * _encoding_blocks(pe), 128, 4)


@functools.lru_cache(maxsize=None)
def _row_block_table(layers: int, width: int, skip: int, pe: int, device: torch.device) -> torch.Tensor:
    cfg = NerfMLPConfig(layers_width=width, backbone_layers_count=layers, skip_layer_idx=skip)
    return torch.tensor(backbone_f32_row_blocks(cfg, pe), dtype=torch.int32).reshape(-1).to(device)


def backbone_f32_fwd(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor,
                     buffers: Optional[F32Buffers] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The f32 forward kernel (B2 for f32 operands) on the card over (N, E)
    f32 encodings -> ((N, W) h, (N,) alpha), one launch counted in
    `backbone_f32_fwd.launches` at the kernel's width
    (`padded_backbone_fwd`); `buffers` as backbone_f32_buffers gives them,
    built here when not given. Raises for what it does not take."""
    return padded_backbone_fwd(cfg, packed, encoded, _backbone_f32_fwd, buffers)


def _backbone_f32_fwd(cfg, packed, encoded, buffers):
    _backbone_kernel_checks(cfg, encoded, [encoded] + list(packed.values()))
    n, pe = encoded.shape
    width = cfg.layers_width
    buffers = buffers if buffers is not None else backbone_f32_buffers(cfg, packed)
    encoded = encoded.contiguous()
    h = torch.empty((n, width), dtype=torch.float32, device=encoded.device)
    alpha = torch.empty((n,), dtype=torch.float32, device=encoded.device)
    if n == 0:
        return h, alpha
    lib, grid = _backbone_f32_library(), min(-(-n // _F32_TILE), _sm_count(encoded.device))
    head = (encoded.data_ptr(), buffers.fwd.data_ptr(), buffers.biases.data_ptr(), buffers.w_alpha.data_ptr(),
            h.data_ptr(), alpha.data_ptr())
    tail = (n, pe, width, cfg.backbone_layers_count, _kernel_skip(cfg), grid,
            torch.cuda.current_stream(encoded.device).cuda_stream)
    if backbone_is_wide(cfg, pe):
        stash = torch.empty(backbone_f32_stash_shape(width, grid, pe), dtype=torch.float32, device=encoded.device)
        err = lib.backbone_f32_wide_fwd_launch(*head, stash.data_ptr(), *tail)
    else:
        err = lib.backbone_f32_fwd_launch(*head, *tail)
    if err != 0:
        raise RuntimeError(f"backbone_f32_fwd kernel launch failed with CUDA error {err}")
    backbone_f32_fwd.launches += 1
    return h, alpha


backbone_f32_fwd.launches = 0


def backbone_layer_outputs(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor):
    """Yields the (N, W) post-ReLU output of layers 0, 1, ... as the kernels
    of `compute_dtype` compute it: B2 (or B2-f32) over the first i + 1
    layers, whose slots, tiles and sums are B3's (B3-f32's) recompute's. One
    launch a layer, counted as a forward launch."""
    for i in range(cfg.backbone_layers_count):
        skip = cfg.skip_layer_idx if cfg.skip_layer_idx <= i else 0
        part = replace(cfg, backbone_layers_count=i + 1, skip_layer_idx=skip)
        yield fused_backbone_fwd(part, {k: packed[k] for k in _backbone_names(part)}, encoded)[0]


def _backbone_f32_bwd(cfg, packed, encoded, g_h, g_alpha, buffers, ms):
    """Launches the f32 backward kernels at their width
    (`padded_backbone_bwd`); `ms`, a ctypes array of 3 floats or None,
    receives the tile, weight-gradient and reduction kernels' milliseconds
    (the call then waits for each launch)."""
    return padded_backbone_bwd(cfg, packed, encoded, g_h, g_alpha, _backbone_f32_bwd_launch, buffers, ms)


def _backbone_f32_bwd_launch(cfg, packed, encoded, g_h, g_alpha, buffers, ms):
    _backbone_kernel_checks(cfg, encoded, [encoded, g_h, g_alpha] + list(packed.values()))
    n, pe = encoded.shape
    width, layers, skip = cfg.layers_width, cfg.backbone_layers_count, _kernel_skip(cfg)
    device = encoded.device
    buffers = buffers if buffers is not None else backbone_f32_buffers(cfg, packed)
    encoded, g_h, g_alpha = encoded.contiguous(), g_h.contiguous(), g_alpha.contiguous()
    d_encoded = torch.empty((n, pe), dtype=torch.float32, device=device)
    grads_out = torch.empty((_backbone_grad_rows(cfg, pe) * width + layers * width + width + 1,),
                            dtype=torch.float32, device=device)
    if n == 0:
        return _unpack_backbone_grads(cfg, grads_out.zero_(), pe), d_encoded
    shapes = backbone_f32_scratch_shapes(cfg, n, _sm_count(device), pe)
    scratch = {k: torch.empty(v, dtype=torch.int32 if k == "masks" else torch.float32, device=device)
               for k, v in shapes.items()}
    table = _row_block_table(layers, width, cfg.skip_layer_idx, pe, device)
    wide = backbone_is_wide(cfg, pe)
    names = ("x", "g", "tile_part", "partial", "masks") + (("stash",) if wide else ())
    lib = _backbone_f32_library()
    err = (lib.backbone_f32_wide_bwd_launch if wide else lib.backbone_f32_bwd_launch)(
        encoded.data_ptr(), g_h.data_ptr(), g_alpha.data_ptr(), buffers.fwd.data_ptr(), buffers.bwd.data_ptr(),
        buffers.biases.data_ptr(), buffers.w_alpha.data_ptr(), d_encoded.data_ptr(),
        *(scratch[k].data_ptr() for k in names), table.data_ptr(),
        grads_out.data_ptr(), table.numel() // 4, n, pe, width, layers, skip, shapes["masks"][0],
        shapes["x"][0] * _F32_BLOCK_POINTS // _F32_TILE, shapes["partial"][0],
        torch.cuda.current_stream(device).cuda_stream, ms,
    )
    if err != 0:
        raise RuntimeError(f"backbone_f32_bwd kernel launch failed with CUDA error {err}")
    backbone_f32_bwd.launches += 1
    return _unpack_backbone_grads(cfg, grads_out, pe), d_encoded


def backbone_f32_bwd(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor,
                     g_h: torch.Tensor, g_alpha: torch.Tensor, buffers: Optional[F32Buffers] = None):
    """The f32 backward kernels (B3 for f32 operands) on the card: ({name:
    gradient}, (N, E) d_encoded), one call counted in
    `backbone_f32_bwd.launches`, bit-identical from run to run."""
    return _backbone_f32_bwd(cfg, packed, encoded, g_h, g_alpha, buffers, None)


backbone_f32_bwd.launches = 0


def backbone_f32_bwd_breakdown(cfg, packed, encoded, g_h, g_alpha, buffers=None) -> Dict[str, float]:
    """One f32 backward on the card, timed by CUDA events around each of
    its launches (counted in `backbone_f32_bwd.launches` as one call): ms
    of the tile kernels, the weight-gradient kernels and the reduction."""
    ms = (ctypes.c_float * 3)()
    _backbone_f32_bwd(cfg, packed, encoded, g_h, g_alpha, buffers, ms)
    return {"tile_ms": ms[0], "dw_ms": ms[1], "reduce_ms": ms[2]}


def kernel_buffers(cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor]) -> Tuple[torch.Tensor, ...]:
    """The weight buffers of the backbone kernels of `cfg`'s operand dtype:
    `backbone_f32_buffers` for float32, `backbone_buffers` for bf16."""
    if cfg.compute_dtype == "float32":
        return backbone_f32_buffers(cfg, packed)
    return backbone_buffers(cfg, packed)


def _runs_kernels(encoded: torch.Tensor) -> bool:
    """Whether the fused backbone launches its kernels for `encoded` (a
    tensor on the card) or runs its plain version (on the CPU)."""
    return encoded.device.type != "cpu"


def _saved_encoding(cfg: NerfMLPConfig, encoded: torch.Tensor) -> torch.Tensor:
    """What the autograd Function keeps of the encodings for the backward
    kernels: their bf16 rounding for bf16 operands (all B3 reads of them,
    half the memory), the f32 encodings themselves for f32 ones."""
    return encoded.to(torch.bfloat16) if cfg.compute_dtype == "bfloat16" else encoded


class _FusedBackbone(torch.autograd.Function):
    """Forward: fused_backbone_fwd; backward: fused_backbone_bwd on the saved
    (encoded, weights), as the JAX custom VJP saves (packed, encoded). On
    the card the forward's weight images are built once and kept for the
    backward, and the encodings as `_saved_encoding` keeps them."""

    @staticmethod
    def forward(ctx, cfg, encoded, *tensors):
        packed = dict(zip(_backbone_names(cfg), tensors))
        ctx.cfg = cfg
        if _runs_kernels(encoded):
            ctx.buffers = kernel_buffers(cfg, packed)
            ctx.save_for_backward(_saved_encoding(cfg, encoded), *tensors)
        else:
            ctx.buffers = None
            ctx.save_for_backward(encoded, *tensors)
        return fused_backbone_fwd(cfg, packed, encoded, ctx.buffers)

    @staticmethod
    def backward(ctx, g_h, g_alpha):
        encoded, *tensors = ctx.saved_tensors
        names = _backbone_names(ctx.cfg)
        packed = dict(zip(names, tensors))
        if g_h is None:
            g_h = torch.zeros(encoded.shape[0], ctx.cfg.layers_width, device=encoded.device)
        if g_alpha is None:
            g_alpha = torch.zeros(encoded.shape[0], device=encoded.device)
        grads, d_encoded = fused_backbone_bwd(ctx.cfg, packed, encoded, g_h, g_alpha, ctx.buffers)
        ctx.buffers = None
        return (None, d_encoded) + tuple(grads[k].reshape(packed[k].shape) for k in names)


def fused_backbone(
    cfg: NerfMLPConfig, packed: Dict[str, torch.Tensor], encoded: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused backbone + alpha head over already-encoded points, differentiable
    in `packed` ({w0..wL-1, b0..bL-1, w_alpha, b_alpha}) and `encoded`
    ((N, E) f32), with both directions in kernels on the card.

    :return: ((N, layers_width) final activation, (N,) raw alpha).
    """
    names = _backbone_names(cfg)
    return _FusedBackbone.apply(cfg, encoded, *(packed[k] for k in names))
