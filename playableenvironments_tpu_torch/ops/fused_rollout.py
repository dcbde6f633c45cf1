"""The phase-3 dynamics rollout: the whole teacher-forced autoregressive LSTM
rollout over T steps as one differentiable op, with hand-written CUDA
kernels for its forward (B4) and backward (B5).

Port of playableenvironments_tpu/ops/fused_rollout.py (the math cores
`_forward_core` / `_step_forward` and the hand-derived reverse pass
`_backward_core` / `_step_backward`) and of the Pallas kernels in
ops/fused_rollout_pallas.py. The forward matches flax's OptimizedLSTMCell
(gate order i, f, g, o; bias-free input projections, biased hidden
projections; new_c = f c + i g, new_h = o tanh(new_c)) followed by
DynamicsNetwork's backbone and heads.

Each wrapper (`fused_rollout_fwd`, `fused_rollout_bwd`) launches its kernel
(csrc/fused_rollout.cu) for CUDA tensors and runs the plain PyTorch version
(`plain_rollout_fwd`, `plain_rollout_bwd`) for CPU tensors. The plain
backward is the hand-derived reverse pass, not autograd, so that the
kernel's backward has a plain twin to be held against. `fused_rollout` is
the torch.autograd.Function over both; it collects residuals only when
autograd needs them. All functions are single-object; the caller loops
over objects (they have distinct parameters and may have distinct configs).

The kernels split each 16-row tile over a thread-block cluster
(`rollout_layout`) and stream per-CTA slices of a weight image that the
launchers gather on the card at every call; `rollout_fwd_image` and
`rollout_bwd_image` are that gather's plain versions, which the tests read
through a copy of the kernels' index arithmetic.

The kernels take features that are multiples of 32 (above 512, of 64);
like the Pallas kernels, whose only limit is their VMEM, the wrappers take
any up to 768 and up to 16 layers: on the card a network runs zero-padded to
the kernels' next width (`kernel_features`, `padded_params`, each gate
block on its own). A padded unit has zero weights, bias and initial state,
so its gates are (1/2, 1/2, 0, 1/2), its cell and hidden state stay exactly
0 and so does its backbone output; the residuals and gradients are cut back
to the network's own width. Up to 256 features and 4 layers, where their
shared memory holds them, kernels that keep whole activations in each CTA
run; beyond, wide kernels that exchange them through a global scratch
(`rollout_is_wide`).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from playableenvironments_tpu_torch.ops import fused_nerf

GATES = ("i", "f", "g", "o")

_SOURCE = fused_nerf._ROLLOUT_SOURCE
# Limits of csrc/fused_rollout.cu: batch rows per cluster, CTAs per cluster
# (non-portable size; 8 where F is not a multiple of 64), consumer threads
# per CTA, floats per ring slot, ring slots, layers, features, the features
# and layers above which the wide kernels run, and the shared memory one CTA
# may take on an H100 (the exchange and ring barriers take _BAR_BYTES of it).
_TILE = 16
_CLUSTER = 16
_CONSUMERS = 256
_SLOT_FLOATS = 4096
_MAX_STAGES = 8
_BAR_BYTES = (2 * _MAX_STAGES + 1) * 8
_MAX_LAYERS = 16
_MAX_FEATURES = 768
_NARROW_LAYERS = 4
_NARROW_FEATURES = 256
_MAX_SMEM = 232448


class RolloutConfig(NamedTuple):
    """Static per-object rollout configuration."""

    rotation_axis: int
    force_rotations_zero: bool
    force_axis_translation: Optional[float]  # None = axis free
    box_size: Tuple[float, float, float]


class PackedParams(NamedTuple):
    """DynamicsNetwork parameters in the JAX package's packed layout: each
    weight (in, out), gates packed (i, f, g, o), biases and initial states
    kept 2D (1, n)."""

    wx: Tuple[torch.Tensor, ...]  # per layer (in_features_l, 4F)
    wh: Tuple[torch.Tensor, ...]  # per layer (F, 4F)
    bh: Tuple[torch.Tensor, ...]  # per layer (1, 4F)
    h_init: Tuple[torch.Tensor, ...]  # per layer (1, F)
    c_init: Tuple[torch.Tensor, ...]  # per layer (1, F)
    wb: torch.Tensor  # backbone (F, F)
    bb: torch.Tensor  # (1, F)
    whead: torch.Tensor  # (F, 6 + 3 + S + D) = [rotation|translation|style|deformation]
    bhead: torch.Tensor  # (1, 6 + 3 + S + D)


def pack_dynamics_params(dynamics) -> PackedParams:
    """models.dynamics.DynamicsNetwork -> PackedParams. A torch Linear
    weight is (out, in), so each is transposed; the concatenations are
    differentiable, so gradients flow back to the modules' parameters."""
    wx, wh, bh, h_init, c_init = [], [], [], [], []
    for layer in range(dynamics.cfg.dynamics.layers_count):
        cell = getattr(dynamics, f"lstm_{layer}")
        wx.append(torch.cat([getattr(cell, f"i{g}").weight.t() for g in GATES], dim=1))
        wh.append(torch.cat([getattr(cell, f"h{g}").weight.t() for g in GATES], dim=1))
        bh.append(torch.cat([getattr(cell, f"h{g}").bias for g in GATES])[None])
        h_init.append(getattr(dynamics, f"initial_hidden_{layer}")[None])
        c_init.append(getattr(dynamics, f"initial_cell_{layer}")[None])
    heads = (dynamics.rotation_head, dynamics.translation_head, dynamics.style_head, dynamics.deformation_head)
    return PackedParams(
        wx=tuple(wx), wh=tuple(wh), bh=tuple(bh), h_init=tuple(h_init), c_init=tuple(c_init),
        wb=dynamics.backbone.weight.t(), bb=dynamics.backbone.bias[None],
        whead=torch.cat([h.weight.t() for h in heads], dim=1),
        bhead=torch.cat([h.bias for h in heads])[None],
    )


def param_list(params: PackedParams) -> List[torch.Tensor]:
    """[wx, wh, bh, h_init, c_init] per layer, then wb, bb, whead, bhead."""
    out = []
    for layer in range(len(params.wx)):
        out += [params.wx[layer], params.wh[layer], params.bh[layer], params.h_init[layer], params.c_init[layer]]
    return out + [params.wb, params.bb, params.whead, params.bhead]


def params_from_list(values: Sequence[torch.Tensor], layers: int) -> PackedParams:
    per = [values[5 * layer:5 * layer + 5] for layer in range(layers)]
    wb, bb, whead, bhead = values[5 * layers:]
    return PackedParams(*(tuple(p[k] for p in per) for k in range(5)), wb=wb, bb=bb, whead=whead, bhead=bhead)


def residual_keys(layers: int) -> List[str]:
    keys = ["cur_rot", "cur_trans", "cur_style", "cur_deform", "x0", "y", "head"]
    for layer in range(layers):
        keys += [f"gates_{layer}", f"c_{layer}", f"h_{layer}"]
    return keys


# ---------------------------------------------------------------------------
# Plain PyTorch versions (the JAX package's 2D-value cores)
# ---------------------------------------------------------------------------


def _inv_box(cfg: RolloutConfig, like: torch.Tensor) -> torch.Tensor:
    """1 / box per column, as the JAX cores form it (in double, then cast)."""
    return torch.tensor([1.0 / b for b in cfg.box_size], dtype=like.dtype, device=like.device)


def _encode_rotation_2d(rot: torch.Tensor) -> torch.Tensor:
    """(B, 3) -> (B, 6) interleaved (sin, cos) pairs."""
    return torch.stack([torch.sin(rot), torch.cos(rot)], dim=-1).reshape(rot.shape[0], 6)


def _rotate(axis: int, cos_t, sin_t, vec):
    """R_axis(theta) @ vec; cos_t/sin_t (B, 1), vec (B, 3)."""
    x, y, z = vec[:, 0:1], vec[:, 1:2], vec[:, 2:3]
    if axis == 0:
        return torch.cat([x, cos_t * y - sin_t * z, sin_t * y + cos_t * z], dim=-1)
    if axis == 1:
        return torch.cat([cos_t * x + sin_t * z, y, -sin_t * x + cos_t * z], dim=-1)
    return torch.cat([cos_t * x - sin_t * y, sin_t * x + cos_t * y, z], dim=-1)


def _rotate_dtheta(axis: int, cos_t, sin_t, vec, d_out):
    """sum(dR/dtheta @ vec * d_out) -> (B, 1)."""
    x, y, z = vec[:, 0:1], vec[:, 1:2], vec[:, 2:3]
    zeros = torch.zeros_like(x)
    if axis == 0:
        d = torch.cat([zeros, -sin_t * y - cos_t * z, cos_t * y - sin_t * z], dim=-1)
    elif axis == 1:
        d = torch.cat([-sin_t * x + cos_t * z, zeros, -cos_t * x - sin_t * z], dim=-1)
    else:
        d = torch.cat([-sin_t * x - cos_t * y, cos_t * x - sin_t * y, zeros], dim=-1)
    return torch.sum(d * d_out, dim=-1, keepdim=True)


def _atan2(s, c):
    """The JAX core's atan2 from atan: atan(s / c) + pi sign(s) [c < 0], with
    |c| < 1e-20 replaced by 1e-20 (it differs from torch.atan2 at c = 0 and
    at s = -0.0)."""
    safe_c = torch.where(c.abs() < 1e-20, torch.full_like(c, 1e-20), c)
    base = torch.atan(s / safe_c)
    sign_s = torch.where(s >= 0.0, torch.ones_like(s), -torch.ones_like(s))
    return base + torch.where(c < 0.0, sign_s * torch.pi, torch.zeros_like(s))


def _with_axis(axis: int, vec: torch.Tensor, column: torch.Tensor) -> torch.Tensor:
    """`column` (B, 1) at `axis`, zeros elsewhere, as a (B, 3) tensor."""
    zeros = torch.zeros_like(vec[:, :1])
    return torch.cat([column if k == axis else zeros for k in range(3)], dim=-1)


def _step_forward(cfg: RolloutConfig, params: PackedParams, carry, state, action, variation):
    """One dynamics step; carry = (cs, hs) per layer. Returns (new carry,
    new state, (x0, gates per layer, cs, hs, y, head))."""
    cs, hs = carry
    rot, trans, style, deform = state
    x = torch.cat([_encode_rotation_2d(rot), trans * _inv_box(cfg, trans), style, deform, action, variation], dim=-1)
    x0 = x
    features = params.wb.shape[0]
    new_cs, new_hs, gates_all = [], [], []
    for layer in range(len(params.wx)):
        z = x @ params.wx[layer] + hs[layer] @ params.wh[layer]
        z = z + params.bh[layer]
        i = torch.sigmoid(z[:, :features])
        f = torch.sigmoid(z[:, features:2 * features])
        g = torch.tanh(z[:, 2 * features:3 * features])
        o = torch.sigmoid(z[:, 3 * features:])
        c_new = f * cs[layer] + i * g
        h_new = o * torch.tanh(c_new)
        new_cs.append(c_new)
        new_hs.append(h_new)
        gates_all.append(torch.cat([i, f, g, o], dim=-1))
        x = h_new
    y = torch.relu(x @ params.wb + params.bb)
    head = y @ params.whead + params.bhead
    style_dim = style.shape[-1]
    enc_rot = head[:, :6]
    delta_trans = head[:, 6:9]
    new_style = head[:, 9:9 + style_dim]
    new_deform = head[:, 9 + style_dim:]

    axis = cfg.rotation_axis
    if cfg.force_rotations_zero:
        new_rot = rot
    else:
        delta_axis = _atan2(enc_rot[:, 2 * axis:2 * axis + 1], enc_rot[:, 2 * axis + 1:2 * axis + 2])
        new_rot = rot + _with_axis(axis, rot, delta_axis)
    theta = rot[:, axis:axis + 1]
    new_trans = trans + _rotate(axis, torch.cos(theta), torch.sin(theta), delta_trans)
    if cfg.force_axis_translation is not None:
        new_trans = torch.cat([
            torch.full_like(new_trans[:, k:k + 1], cfg.force_axis_translation) if k == axis else new_trans[:, k:k + 1]
            for k in range(3)
        ], dim=-1)
    residuals = (x0, tuple(gates_all), tuple(new_cs), tuple(new_hs), y, head)
    return (tuple(new_cs), tuple(new_hs)), (new_rot, new_trans, new_style, new_deform), residuals


def plain_rollout_fwd(cfg: RolloutConfig, params: PackedParams, rotations, translations, style, deform,
                      actions, variations, gt_count: int, collect_residuals: bool):
    """The rollout in plain PyTorch. Shapes: rotations (B, T, 3), actions
    (B, T-1, A). Step t takes the ground truth as its input state while
    t < gt_count, else the previous step's output.

    :return: (four (B, T, .) outputs, residuals {name: (T-1, B, .)} or None).
    """
    batch, T = rotations.shape[0], rotations.shape[1]
    features = params.wb.shape[0]
    layers = len(params.wx)
    cs = tuple(params.c_init[layer].expand(batch, features) for layer in range(layers))
    hs = tuple(params.h_init[layer].expand(batch, features) for layer in range(layers))
    rec = [(rotations[:, 0], translations[:, 0], style[:, 0], deform[:, 0])]
    steps = []
    carry = (cs, hs)
    for t in range(T - 1):
        use_gt = 1.0 if t < gt_count else 0.0
        gt_state = (rotations[:, t], translations[:, t], style[:, t], deform[:, t])
        current = tuple(use_gt * gt + (1.0 - use_gt) * prev for gt, prev in zip(gt_state, rec[-1]))
        carry, state, step_res = _step_forward(cfg, params, carry, current, actions[:, t], variations[:, t])
        rec.append(state)
        if collect_residuals:
            steps.append((current, step_res))
    out = tuple(torch.stack([r[k] for r in rec], dim=1) for k in range(4))
    if not collect_residuals:
        return out, None
    residuals = {
        "cur_rot": torch.stack([s[0][0] for s in steps]),
        "cur_trans": torch.stack([s[0][1] for s in steps]),
        "cur_style": torch.stack([s[0][2] for s in steps]),
        "cur_deform": torch.stack([s[0][3] for s in steps]),
        "x0": torch.stack([s[1][0] for s in steps]),
        "y": torch.stack([s[1][4] for s in steps]),
        "head": torch.stack([s[1][5] for s in steps]),
    }
    for layer in range(layers):
        residuals[f"gates_{layer}"] = torch.stack([s[1][1][layer] for s in steps])
        residuals[f"c_{layer}"] = torch.stack([s[1][2][layer] for s in steps])
        residuals[f"h_{layer}"] = torch.stack([s[1][3][layer] for s in steps])
    return out, residuals


def _step_backward(cfg: RolloutConfig, params: PackedParams, step_res: Dict, d_in, d_cs, d_hs):
    """Reverse pass of one step: (parameter gradient increments, new d_cs,
    new d_hs, d_current_state tuple, d_action_and_variation)."""
    features = params.wb.shape[0]
    layers = len(params.wx)
    axis = cfg.rotation_axis
    d_rot, d_trans, d_sty, d_def = d_in
    cur_rot, x0, y, head = step_res["cur_rot"], step_res["x0"], step_res["y"], step_res["head"]

    # Translations: the forced axis blocks the gradient through the sum.
    d_sum = d_trans
    if cfg.force_axis_translation is not None:
        d_sum = torch.cat([torch.zeros_like(d_trans[:, k:k + 1]) if k == axis else d_trans[:, k:k + 1]
                           for k in range(3)], dim=-1)
    theta = cur_rot[:, axis:axis + 1]
    cos_t, sin_t = torch.cos(theta), torch.sin(theta)
    delta_trans = head[:, 6:9]
    d_delta_trans = _rotate(axis, cos_t, -sin_t, d_sum)  # R^T = R(-theta)
    d_theta = _rotate_dtheta(axis, cos_t, sin_t, delta_trans, d_sum)

    # Rotations.
    d_cur_rot = d_rot + _with_axis(axis, d_rot, d_theta)
    if cfg.force_rotations_zero:
        d_enc_rot = torch.zeros_like(head[:, :6])
    else:
        d_axis_col = d_rot[:, axis:axis + 1]
        s_a = head[:, 2 * axis:2 * axis + 1]
        c_a = head[:, 2 * axis + 1:2 * axis + 2]
        denom = s_a * s_a + c_a * c_a + 1e-20
        zeros = torch.zeros_like(s_a)
        pieces = [zeros] * 6
        pieces[2 * axis] = d_axis_col * c_a / denom
        pieces[2 * axis + 1] = -d_axis_col * s_a / denom
        d_enc_rot = torch.cat(pieces, dim=-1)

    # Heads and backbone.
    d_head = torch.cat([d_enc_rot, d_delta_trans, d_sty, d_def], dim=-1)
    inc = {"whead": y.t() @ d_head, "bhead": d_head.sum(dim=0, keepdim=True)}
    d_y_pre = (d_head @ params.whead.t()) * (y > 0).to(d_head.dtype)
    inc["wb"] = step_res[f"h_{layers - 1}"].t() @ d_y_pre
    inc["bb"] = d_y_pre.sum(dim=0, keepdim=True)
    d_x = d_y_pre @ params.wb.t()

    # LSTM layers, top down.
    g_wx, g_wh, g_bh = [None] * layers, [None] * layers, [None] * layers
    new_d_cs, new_d_hs = list(d_cs), list(d_hs)
    for layer in range(layers - 1, -1, -1):
        gates = step_res[f"gates_{layer}"]
        i = gates[:, :features]
        f = gates[:, features:2 * features]
        g = gates[:, 2 * features:3 * features]
        o = gates[:, 3 * features:]
        tanh_c = torch.tanh(step_res[f"c_{layer}"])
        d_h = d_x + d_hs[layer]
        d_o = d_h * tanh_c
        d_c = d_cs[layer] + d_h * o * (1.0 - tanh_c * tanh_c)
        d_f = d_c * step_res[f"c_prev_{layer}"]
        d_i = d_c * g
        d_g = d_c * i
        new_d_cs[layer] = d_c * f
        dz = torch.cat([d_i * i * (1.0 - i), d_f * f * (1.0 - f), d_g * (1.0 - g * g), d_o * o * (1.0 - o)], dim=-1)
        x_in = x0 if layer == 0 else step_res[f"h_{layer - 1}"]
        g_wx[layer] = x_in.t() @ dz
        g_wh[layer] = step_res[f"h_prev_{layer}"].t() @ dz
        g_bh[layer] = dz.sum(dim=0, keepdim=True)
        new_d_hs[layer] = dz @ params.wh[layer].t()
        d_x = dz @ params.wx[layer].t()
    inc.update(wx=g_wx, wh=g_wh, bh=g_bh)

    # Input assembly.
    style_dim, deform_dim = d_sty.shape[-1], d_def.shape[-1]
    d_enc_in = d_x[:, :6]
    enc = torch.cat([d_enc_in[:, 2 * k:2 * k + 1] * torch.cos(cur_rot[:, k:k + 1])
                     - d_enc_in[:, 2 * k + 1:2 * k + 2] * torch.sin(cur_rot[:, k:k + 1]) for k in range(3)], dim=-1)
    d_cur_rot = d_cur_rot + enc
    d_cur_trans = d_sum + d_x[:, 6:9] * _inv_box(cfg, d_x)
    d_style_in = d_x[:, 9:9 + style_dim]
    d_deform_in = d_x[:, 9 + style_dim:9 + style_dim + deform_dim]
    return inc, new_d_cs, new_d_hs, (d_cur_rot, d_cur_trans, d_style_in, d_deform_in), d_x[:, 9 + style_dim + deform_dim:]


def plain_rollout_bwd(cfg: RolloutConfig, params: PackedParams, gt_count: int, residuals: Dict[str, torch.Tensor],
                      cotangents: Sequence[torch.Tensor], actions_dim: int):
    """The hand-derived reverse pass in plain PyTorch. `cotangents` are the
    gradients of the four (B, T, .) outputs.

    :return: (parameter gradients as PackedParams, then the gradients of
        rotations, translations, style, deformation (B, T, .), actions and
        variations (B, T-1, .)). Index T-1 of the state gradients is zero;
        the initial-carry gradients are summed over the batch.
    """
    d_rot_out, d_trans_out, d_style_out, d_deform_out = cotangents
    batch, T = d_rot_out.shape[0], d_rot_out.shape[1]
    features = params.wb.shape[0]
    layers = len(params.wx)
    zeros = lambda p: torch.zeros_like(p)  # noqa: E731
    g = {"wx": [zeros(w) for w in params.wx], "wh": [zeros(w) for w in params.wh],
         "bh": [zeros(b) for b in params.bh], "wb": zeros(params.wb), "bb": zeros(params.bb),
         "whead": zeros(params.whead), "bhead": zeros(params.bhead)}
    d_cs = [d_rot_out.new_zeros(batch, features) for _ in range(layers)]
    d_hs = [d_rot_out.new_zeros(batch, features) for _ in range(layers)]
    d_state = tuple(c.new_zeros(batch, c.shape[-1]) for c in cotangents)
    per_t = [None] * (T - 1)
    act_var = [None] * (T - 1)
    for t in range(T - 2, -1, -1):
        step_res = {k: residuals[k][t] for k in ("cur_rot", "cur_trans", "x0", "y", "head")}
        for layer in range(layers):
            for name in ("gates", "c", "h"):
                step_res[f"{name}_{layer}"] = residuals[f"{name}_{layer}"][t]
            if t == 0:
                step_res[f"c_prev_{layer}"] = params.c_init[layer].expand(batch, features)
                step_res[f"h_prev_{layer}"] = params.h_init[layer].expand(batch, features)
            else:
                step_res[f"c_prev_{layer}"] = residuals[f"c_{layer}"][t - 1]
                step_res[f"h_prev_{layer}"] = residuals[f"h_{layer}"][t - 1]
        d_in = tuple(d_state[k] + cotangents[k][:, t + 1] for k in range(4))
        inc, d_cs, d_hs, d_cur, act_var[t] = _step_backward(cfg, params, step_res, d_in, d_cs, d_hs)
        for name in ("wx", "wh", "bh"):
            g[name] = [a + b for a, b in zip(g[name], inc[name])]
        for name in ("wb", "bb", "whead", "bhead"):
            g[name] = g[name] + inc[name]
        use_gt = 1.0 if t < gt_count else 0.0
        if t == 0:
            per_t[0] = tuple(d + cotangents[k][:, 0] for k, d in enumerate(d_cur))
        else:
            per_t[t] = tuple(use_gt * d for d in d_cur)
            d_state = tuple((1.0 - use_gt) * d for d in d_cur)
    states = tuple(
        torch.stack([p[k] for p in per_t] + [torch.zeros_like(per_t[0][k])], dim=1) for k in range(4)
    )
    g_params = PackedParams(
        wx=tuple(g["wx"]), wh=tuple(g["wh"]), bh=tuple(g["bh"]),
        h_init=tuple(d.sum(dim=0, keepdim=True) for d in d_hs),
        c_init=tuple(d.sum(dim=0, keepdim=True) for d in d_cs),
        wb=g["wb"], bb=g["bb"], whead=g["whead"], bhead=g["bhead"],
    )
    d_actions = torch.stack([a[:, :actions_dim] for a in act_var], dim=1)
    d_variations = torch.stack([a[:, actions_dim:] for a in act_var], dim=1)
    return (g_params,) + states + (d_actions, d_variations)


# ---------------------------------------------------------------------------
# The kernels (csrc/fused_rollout.cu)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    """csrc/fused_rollout.cu, built and loaded once per process."""
    lib = fused_nerf._load(_SOURCE)
    lib.fused_rollout_fwd_launch.argtypes = [ctypes.c_void_p] * 17 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.fused_rollout_bwd_launch.argtypes = [ctypes.c_void_p] * 24
    lib.fused_rollout_image_launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] + [ctypes.c_void_p] * 3
    lib.fused_rollout_max_clusters.argtypes = [ctypes.c_int] * 4
    for fn in (lib.fused_rollout_fwd_launch, lib.fused_rollout_bwd_launch, lib.fused_rollout_image_launch,
               lib.fused_rollout_max_clusters):
        fn.restype = ctypes.c_int
    return lib


def _pointers(tensors: Sequence[torch.Tensor]) -> ctypes.c_void_p:
    """A host array of the tensors' device pointers, as the C launchers
    take it (the caller keeps the tensors alive for the call)."""
    array = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    return ctypes.cast(array, ctypes.c_void_p)  # the cast keeps a reference to the array


class RolloutLayout(NamedTuple):
    """How csrc/fused_rollout.cu splits one 16-row tile over a cluster of
    CTAs: CTA q owns hidden units [q U, (q + 1) U) of every gate and layer
    (and the same backbone columns), head columns [q HU, (q + 1) HU) in the
    forward and input-gradient columns [q XU, (q + 1) XU) in the backward."""

    cluster: int  # n, CTAs per 16-row tile
    units: int  # U = F / n
    head_cols: int  # HU = ceil(H / n), rounded up to 4
    in_cols: int  # XU = ceil(in0 / n), rounded up to 4
    features: int
    layers: int
    in0: int
    head: int


def _round4(x: int) -> int:
    return -(-x // 4) * 4


@functools.lru_cache(maxsize=None)
def rollout_layout(features: int, layers: int, in0: int, head: int) -> RolloutLayout:
    """The cluster split for these sizes: 16 CTAs where F is a multiple of
    64, else 8, so that each CTA's U units are a multiple of 4 (16-byte
    rows of the weight image)."""
    n = _CLUSTER if features % (4 * _CLUSTER) == 0 else _CLUSTER // 2
    return RolloutLayout(n, features // n, _round4(-(-head // n)), _round4(-(-in0 // n)), features, layers, in0,
                         head)


def rollout_segments(layout: RolloutLayout, fwd: bool) -> List[Tuple[int, int]]:
    """The (K rows, W floats per row) segments of one CTA's weight image, in
    the order the kernel streams them each step (forward_segments /
    backward_segments in the source; the wide backward streams each layer's
    (4F, W) segment as four (F, W) gate blocks, backward_segments_wide)."""
    F, U = layout.features, layout.units
    if fwd:
        segments = []
        for layer in range(layout.layers):
            segments += [(F, 4 * U), (layout.in0 if layer == 0 else F, 4 * U)]
        return segments + [(F, U), (F, layout.head_cols)]
    return [(layout.head, U), (F, U)] + [
        (4 * F, U + (U if layer > 0 else layout.in_cols)) for layer in range(layout.layers - 1, -1, -1)]


def _image(layout: RolloutLayout, fwd: bool, like: torch.Tensor) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """An empty (n, per-CTA floats) image and each segment's (n, K, W) view of it."""
    segments = rollout_segments(layout, fwd)
    image = like.new_empty(layout.cluster, sum(k * w for k, w in segments))
    views, offset = [], 0
    for k, w in segments:
        views.append(image[:, offset:offset + k * w].view(layout.cluster, k, w))
        offset += k * w
    return image, views


def rollout_fwd_image(params: PackedParams, layout: RolloutLayout) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's per-call weight image (a gather, no product): for CTA q,
    each layer's wh then wx restricted to its units' gate columns, k-major,
    column u * 4 + gate; then wb's columns [q U, (q + 1) U) and whead's
    columns [q HU, (q + 1) HU) (zero past H). And the biases in the same
    column orders: (n, L 4U + U + HU)."""
    n, U, HU, F = layout.cluster, layout.units, layout.head_cols, layout.features
    image, views = _image(layout, True, params.wb)
    for layer in range(layout.layers):
        for j, w in enumerate((params.wh[layer], params.wx[layer])):
            views[2 * layer + j].view(n, w.shape[0], U, 4).copy_(w.reshape(w.shape[0], 4, n, U).permute(2, 0, 3, 1))
    views[-2].copy_(params.wb.reshape(F, n, U).permute(1, 0, 2))
    pad = n * HU - layout.head
    views[-1].copy_(torch.nn.functional.pad(params.whead, (0, pad)).reshape(F, n, HU).permute(1, 0, 2))
    bias = torch.cat([b.reshape(4, n, U).permute(1, 2, 0).reshape(n, 4 * U) for b in params.bh]
                     + [params.bb.reshape(n, U), torch.nn.functional.pad(params.bhead, (0, pad)).reshape(n, HU)], dim=1)
    return image, bias


def rollout_bwd_image(params: PackedParams, layout: RolloutLayout) -> torch.Tensor:
    """The backward's per-call weight image (a gather, no product): for CTA
    q, whead's rows [q U, (q + 1) U) and wb's, each k-major over their
    columns; then per layer, top down, over the 4F gate columns c: wh[own
    units, c] beside wx[own units, c] (layer 0: wx's input rows
    [q XU, (q + 1) XU), zero past in0)."""
    n, U, XU, F = layout.cluster, layout.units, layout.in_cols, layout.features
    image, views = _image(layout, False, params.wb)
    views[0].copy_(params.whead.reshape(n, U, layout.head).permute(0, 2, 1))
    views[1].copy_(params.wb.reshape(n, U, F).permute(0, 2, 1))
    for i, layer in enumerate(range(layout.layers - 1, -1, -1)):
        view = views[2 + i]
        view[:, :, :U].copy_(params.wh[layer].reshape(n, U, 4 * F).permute(0, 2, 1))
        wx = params.wx[layer]
        if layer == 0:
            wx = torch.nn.functional.pad(wx, (0, 0, 0, n * XU - layout.in0))
        view[:, :, U:].copy_(wx.reshape(n, -1, 4 * F).permute(0, 2, 1))
    return image


def _narrow_smem_bytes(layout: RolloutLayout, stages: int, fwd: bool) -> int:
    """Dynamic shared memory of one CTA of the kernels that keep whole
    activations in it (fwd_smem / bwd_smem in the source)."""
    n, U, HU, XU, F, L = (layout.cluster, layout.units, layout.head_cols, layout.in_cols, layout.features,
                          layout.layers)
    t, SW = _TILE, layout.head - 3
    floats = stages * _SLOT_FLOATS + _CONSUMERS * t + _round4(t * SW)  # ring, k-group partials, state
    if fwd:
        floats += (2 * L * F * t + F * t + n * HU * t + layout.in0 * t + _round4(t * (layout.in0 - 3))
                   + t * max(U, HU) + L * U * t + _round4(L * 4 * U + U + HU))
    else:
        prefetch = _round4(12 + U + 6 * L * U + SW)
        floats += (4 * F * t + F * t + n * XU * t + layout.head * t + 6 * t + 2 * L * U * t + 2 * t * prefetch
                   + t * (U + max(U, XU)) + t * max(4 * U, XU))
    return 4 * floats + _BAR_BYTES


def rollout_is_wide(layout: RolloutLayout, fwd: bool) -> bool:
    """Whether the wide kernel runs this direction at these sizes: above 256
    features or 4 layers, or where the kernel that keeps every layer's h
    (forward) or the full dz (backward) in each CTA leaves no room for two
    ring slots. Every shape that kernel takes, it runs."""
    return (layout.features > _NARROW_FEATURES or layout.layers > _NARROW_LAYERS
            or _narrow_smem_bytes(layout, 2, fwd) > _MAX_SMEM)


def wide_operand_rows(layout: RolloutLayout, fwd: bool) -> int:
    """Rows of the wide kernels' operand buffer (wide_operand_rows in the
    source): the widest block a product or the step's small math reads."""
    return max(layout.features, layout.cluster * (layout.head_cols if fwd else layout.in_cols))


def wide_scratch(layout: RolloutLayout, fwd: bool) -> Dict[str, int]:
    """Offsets in floats of the wide kernels' per-tile global scratch and its
    size, `per_tile` (wide_scratch in the source); each block k-major
    [rows][16]. Forward: h [2 (step parity)][L][F], c [L][F], y [F], head
    [n HU]; backward: d_y [F], dz [2 (layer parity)][4F], d_x0 [n XU], the
    carries d_h and d_c [2][L][F]."""
    block, t = layout.features * _TILE, _TILE
    if fwd:
        out = {"h": 0, "c": 2 * layout.layers * block}
        out["y"] = out["c"] + layout.layers * block
        out["head"] = out["y"] + block
        out["per_tile"] = out["head"] + layout.cluster * layout.head_cols * t
    else:
        out = {"dy": 0, "dz": block}
        out["dx0"] = out["dz"] + 8 * block
        out["carry"] = out["dx0"] + layout.cluster * layout.in_cols * t
        out["per_tile"] = out["carry"] + 2 * layout.layers * block
    return out


def _wide_smem_bytes(layout: RolloutLayout, stages: int, fwd: bool) -> int:
    """Dynamic shared memory of one CTA of the wide kernels (wide_fwd_smem /
    wide_bwd_smem in the source): no term grows with the layers."""
    U, HU, XU = layout.units, layout.head_cols, layout.in_cols
    t, SW = _TILE, layout.head - 3
    floats = stages * _SLOT_FLOATS + _CONSUMERS * t + wide_operand_rows(layout, fwd) * t  # ring, partials, operand
    if fwd:
        floats += layout.in0 * t + _round4(t * SW) + _round4(t * (layout.in0 - 3)) + t * max(U, HU)
    else:
        floats += (layout.head * t + _round4(t * SW) + 6 * t + 2 * t * _round4(12 + U + SW)
                   + t * (U + max(U, XU)) + t * max(4 * U, XU))
    return 4 * floats + _BAR_BYTES


def _smem_bytes(layout: RolloutLayout, stages: int, fwd: bool) -> int:
    """Dynamic shared memory of one CTA of the kernel that runs this
    direction (`rollout_is_wide`)."""
    return (_wide_smem_bytes if rollout_is_wide(layout, fwd) else _narrow_smem_bytes)(layout, stages, fwd)


@functools.lru_cache(maxsize=None)
def _stages(layout: RolloutLayout, fwd: bool) -> int:
    """Ring slots: as many as fit beside the rest, at most 8; at least 2."""
    spare = _MAX_SMEM - _smem_bytes(layout, 0, fwd)
    stages = min(_MAX_STAGES, spare // (4 * _SLOT_FLOATS))
    if stages < 2:
        raise ValueError(f"the rollout {'forward' if fwd else 'backward'} needs {_smem_bytes(layout, 2, fwd)} "
                         f"bytes of shared memory per CTA, more than the card's {_MAX_SMEM}")
    if max(w for _, w in rollout_segments(layout, fwd)) > _CONSUMERS:
        raise ValueError(f"the rollout's input width {layout.in0} is too wide for its cluster split")
    return stages


def kernel_features(features: int) -> int:
    """The features the kernels run a network of `features` at: the next
    multiple of 32, above 512 of 64 (16-CTA clusters, so that a CTA's 4U
    gate columns fit its consumer threads); above 768, the count itself (the
    kernels refuse it)."""
    if features > _MAX_FEATURES:
        return features
    step = 64 if features > 512 else 32
    return -(-features // step) * step


def _pad_gates(x: torch.Tensor, features: int, padded: int, values=(0.0, 0.0, 0.0, 0.0)) -> torch.Tensor:
    """(..., 4F) gate columns [i|f|g|o] -> (..., 4F'), each block padded on
    its own with its entry of `values`."""
    blocks = x.reshape(*x.shape[:-1], 4, features)
    pad = [torch.nn.functional.pad(blocks[..., k, :], (0, padded - features), value=v) for k, v in enumerate(values)]
    return torch.stack(pad, dim=-2).reshape(*x.shape[:-1], 4 * padded)


def padded_params(params: PackedParams, padded: int) -> PackedParams:
    """`params` zero-padded from F to `padded` features: each gate block of
    wx, wh and bh, the rows that read the hidden state (wx above layer 0,
    wh, wb, whead), wb's and bb's columns, h_init and c_init. The network
    computes the same outputs, its padded units' states exactly 0. `params`
    itself at its own width."""
    features = params.wb.shape[0]
    if padded == features:
        return params
    extra = padded - features
    pad = torch.nn.functional.pad

    def gates(w, rows):
        return pad(_pad_gates(w, features, padded), (0, 0, 0, rows))

    return PackedParams(
        wx=tuple(gates(w, extra if layer else 0) for layer, w in enumerate(params.wx)),
        wh=tuple(gates(w, extra) for w in params.wh), bh=tuple(gates(b, 0) for b in params.bh),
        h_init=tuple(pad(h, (0, extra)) for h in params.h_init), c_init=tuple(pad(c, (0, extra)) for c in params.c_init),
        wb=pad(params.wb, (0, extra, 0, extra)), bb=pad(params.bb, (0, extra)),
        whead=pad(params.whead, (0, 0, 0, extra)), bhead=params.bhead,
    )


def unpadded_grads(params: PackedParams, grads: PackedParams) -> PackedParams:
    """Gradients of `params` padded to more features (`padded_params`) cut
    back to the shapes of `params`."""
    features, padded = params.wb.shape[0], grads.wb.shape[0]
    if padded == features:
        return grads

    def gates(g, rows):
        return g[:rows].reshape(rows, 4, padded)[..., :features].reshape(rows, 4 * features)

    return PackedParams(
        wx=tuple(gates(g, w.shape[0]) for g, w in zip(grads.wx, params.wx)),
        wh=tuple(gates(g, features) for g in grads.wh), bh=tuple(gates(g, 1) for g in grads.bh),
        h_init=tuple(g[:, :features] for g in grads.h_init), c_init=tuple(g[:, :features] for g in grads.c_init),
        wb=grads.wb[:features, :features], bb=grads.bb[:, :features], whead=grads.whead[:features],
        bhead=grads.bhead,
    )


# A padded unit's gates: sigmoid(0), sigmoid(0), tanh(0), sigmoid(0).
_PADDED_GATES = (0.5, 0.5, 0.0, 0.5)


def padded_residuals(residuals: Dict[str, torch.Tensor], features: int, padded: int) -> Dict[str, torch.Tensor]:
    """The forward's residuals of a network padded to `padded` features, from
    those of its own width: a padded unit's gates are (1/2, 1/2, 0, 1/2), its
    c, h and backbone output y 0."""
    if padded == features:
        return residuals
    out = dict(residuals)
    for key, value in residuals.items():
        if key.startswith("gates_"):
            out[key] = _pad_gates(value, features, padded, _PADDED_GATES)
        elif key == "y" or key.startswith(("c_", "h_")):
            out[key] = torch.nn.functional.pad(value, (0, padded - features))
    return out


def unpadded_residuals(residuals: Dict[str, torch.Tensor], features: int, padded: int) -> Dict[str, torch.Tensor]:
    """The residuals of a network padded to `padded` features cut back to
    its own `features`."""
    if padded == features:
        return residuals
    out = dict(residuals)
    for key, value in residuals.items():
        if key.startswith("gates_"):
            out[key] = value.reshape(*value.shape[:-1], 4, padded)[..., :features].reshape(
                *value.shape[:-1], 4 * features)
        elif key == "y" or key.startswith(("c_", "h_")):
            out[key] = value[..., :features]
    return out


def _kernel_checks(cfg: RolloutConfig, params: PackedParams, tensors: Sequence[torch.Tensor], T: int) -> None:
    features, layers = params.wb.shape[0], len(params.wx)
    if features % 32 or not 32 <= features <= _MAX_FEATURES or (features > 512 and features % 64):
        raise ValueError(f"features {features} must be a multiple of 32 (above 512, of 64), at most {_MAX_FEATURES} "
                         "(narrower ones are padded to one)")
    if not 1 <= layers <= _MAX_LAYERS:
        raise ValueError(f"layers {layers} must be 1 to {_MAX_LAYERS}")
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"the fused rollout runs on cuda or cpu tensors, not {device}")
    for t in list(tensors) + param_list(params):
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"inputs must be float32 on {device}, got {t.dtype} on {t.device}")
    if cfg.rotation_axis not in (0, 1, 2):
        raise ValueError(f"rotation_axis {cfg.rotation_axis} must be 0, 1 or 2")
    if T < 2:
        raise ValueError(f"the rollout needs at least 2 observations, got {T}")


def check_shapes(params: PackedParams, batch: int, T: int, S: int, D: int, A: int, V: int,
                 tensors: Dict[str, torch.Tensor]) -> None:
    """Raise unless every parameter, and each tensor in `tensors` (named as
    the rollout's inputs, their cotangents `d_*`, or residual_keys), has the
    shape the kernels read for these sizes."""
    F, H, in0 = params.wb.shape[0], 9 + S + D, 9 + S + D + A + V
    names = [f"{k}_{layer}" for layer in range(len(params.wx)) for k in ("wx", "wh", "bh", "h_init", "c_init")]
    got = dict(zip(names + ["wb", "bb", "whead", "bhead"], param_list(params)))
    expected = {"wb": (F, F), "bb": (1, F), "whead": (F, H), "bhead": (1, H)}
    for layer in range(len(params.wx)):
        expected.update({f"wx_{layer}": (in0 if layer == 0 else F, 4 * F), f"wh_{layer}": (F, 4 * F),
                         f"bh_{layer}": (1, 4 * F), f"h_init_{layer}": (1, F), f"c_init_{layer}": (1, F)})
    states = {"rotations": 3, "translations": 3, "style": S, "deformation": D}
    residuals = {"cur_rot": 3, "cur_trans": 3, "cur_style": S, "cur_deform": D, "x0": in0, "y": F, "head": H}
    for name, tensor in tensors.items():
        if name.removeprefix("d_") in states:
            expected[name] = (batch, T, states[name.removeprefix("d_")])
        elif name in ("actions", "variations"):
            expected[name] = (batch, T - 1, A if name == "actions" else V)
        else:
            expected[name] = (T - 1, batch, residuals.get(name, 4 * F if name.startswith("gates_") else F))
        got[name] = tensor
    for name, shape in expected.items():
        if tuple(got[name].shape) != shape:
            raise ValueError(f"{name} has shape {tuple(got[name].shape)}, the kernels need {shape}")


# Signatures (config, sizes, and every tensor's shape, type and device) that
# passed _kernel_checks and check_shapes; a wrapper call checks again only
# what it has not seen.
_VALIDATED = set()


def _validate(cfg: RolloutConfig, params: PackedParams, T: int, sizes: Tuple[int, ...],
              named: Dict[str, torch.Tensor]) -> None:
    """_kernel_checks and check_shapes (sizes: batch, S, D, A, V), once per signature."""
    tensors = list(named.values()) + param_list(params)
    key = (cfg, T, sizes, tuple(named), tuple((t.shape, t.dtype, t.device) for t in tensors))
    if key in _VALIDATED:
        return
    _kernel_checks(cfg, params, list(named.values()), T)
    batch, S, D, A, V = sizes
    check_shapes(params, batch, T, S, D, A, V, named)
    _VALIDATED.add(key)


def _launch_args(cfg: RolloutConfig, layout: RolloutLayout, batch: int, T: int, S: int, D: int, A: int, V: int,
                 gt_count: int, stages: int):
    """The launchers' int and float arrays (make_dims in the source)."""
    forced = cfg.force_axis_translation
    ints = [batch, T, layout.features, layout.layers, S, D, A, V, gt_count, cfg.rotation_axis,
            int(cfg.force_rotations_zero), int(forced is not None), layout.cluster, layout.units, layout.head_cols,
            layout.in_cols, stages]
    floats = [float(forced or 0.0)] + [1.0 / b for b in cfg.box_size]
    return (ctypes.c_int * len(ints))(*ints), (ctypes.c_float * len(floats))(*floats)


def _weights(params: PackedParams):
    """The parameters in param_list order, as the launchers read them, and
    their (row, column) strides: the weights as they lie (pack_dynamics_params's
    wb is a transposed view), the vectors (1, n) with a unit column stride."""
    weights, strides = [], []
    for p in param_list(params):
        stride = p.stride()
        if p.shape[0] == 1 and stride[1] != 1:
            p = p.contiguous()
            stride = p.stride()
        weights.append(p)
        strides += stride
    return weights, (ctypes.c_int * len(strides))(*strides)


class _Block(NamedTuple):
    """Tensors laid out in one allocation: (shape, strides, offset) each,
    every offset 16-byte aligned (the kernels copy rows 16 bytes at a
    time), and the allocation's size in floats."""

    parts: Tuple[Tuple[Tuple[int, ...], Tuple[int, ...], int], ...]
    floats: int


def _block(shapes: Sequence[Sequence[int]]) -> _Block:
    parts, offset = [], 0
    for shape in shapes:
        strides = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * shape[i + 1]
        parts.append((tuple(shape), tuple(strides), offset))
        offset += _round4(math.prod(shape))
    return _Block(tuple(parts), offset)


def _carve(block: _Block, device) -> List[torch.Tensor]:
    """The block's tensors, views of one new allocation."""
    buffer = torch.empty(block.floats, device=device)
    return [buffer.as_strided(shape, strides, offset) for shape, strides, offset in block.parts]


def _scratch(block: _Block, device) -> Tuple[torch.Tensor, List[int]]:
    """One new allocation (keep it alive for the launch) and the device
    address of each of the block's parts in it."""
    buffer = torch.empty(block.floats, device=device)
    base = buffer.data_ptr()
    return buffer, [base + 4 * offset for _, _, offset in block.parts]


def _image_shapes(layout: RolloutLayout, fwd: bool) -> List[Tuple[int, int]]:
    """The weight image (n, per-CTA floats), and for the forward its biases."""
    shapes = [(layout.cluster, sum(k * w for k, w in rollout_segments(layout, fwd)))]
    if fwd:
        shapes.append((layout.cluster, layout.layers * 4 * layout.units + layout.units + layout.head_cols))
    return shapes


class _Plan(NamedTuple):
    """What a launch of these sizes and this configuration needs besides
    the tensors: the split, the ring, the launchers' arguments and the
    layouts of the buffers it allocates."""

    layout: RolloutLayout
    ints: ctypes.Array
    floats: ctypes.Array
    outputs: Optional[_Block]  # forward: the four states
    extra: Optional[_Block]  # forward: the residuals; backward: state, action and variation gradients
    scratch: _Block  # the weight image (and biases), the backward's dz, dy, dhead and d_final; for a wide kernel its scratch


@functools.lru_cache(maxsize=64)
def _plan(cfg: RolloutConfig, fwd: bool, collect: bool, batch: int, T: int, S: int, D: int, A: int, V: int,
          features: int, layers: int, gt_count: int) -> _Plan:
    in0, head = 9 + S + D + A + V, 9 + S + D
    layout = rollout_layout(features, layers, in0, head)
    ints, floats = _launch_args(cfg, layout, batch, T, S, D, A, V, gt_count, _stages(layout, fwd))
    steps, F = T - 1, features
    exchange = [(-(-batch // _TILE), wide_scratch(layout, fwd)["per_tile"])] if rollout_is_wide(layout, fwd) else []
    if fwd:
        outputs = _block([(batch, T, w) for w in (3, 3, S, D)])
        widths = {"cur_rot": 3, "cur_trans": 3, "cur_style": S, "cur_deform": D, "x0": in0, "y": F, "head": head}
        for layer in range(layers):
            widths.update({f"gates_{layer}": 4 * F, f"c_{layer}": F, f"h_{layer}": F})
        extra = _block([(steps, batch, widths[k]) for k in residual_keys(layers)]) if collect else None
        scratch = _block(_image_shapes(layout, True) + exchange)
    else:
        outputs = None
        extra = _block([(batch, T, w) for w in (3, 3, S, D)] + [(batch, steps, A), (batch, steps, V)])
        scratch = _block(_image_shapes(layout, False) + [(layers, steps, batch, 4 * F), (steps, batch, F),
                                                         (steps, batch, head), (2, layers, batch, F)] + exchange)
    return _Plan(layout, ints, floats, outputs, extra, scratch)


def card_image(params: PackedParams, S: int, D: int, A: int, V: int, fwd: bool):
    """The weight image (and for the forward its biases) as the launchers
    gather it on the card: held against rollout_fwd_image / rollout_bwd_image,
    its plain versions, by the smoke run."""
    F, L = params.wb.shape[0], len(params.wx)
    layout = rollout_layout(F, L, 9 + S + D + A + V, 9 + S + D)
    images = _carve(_block(_image_shapes(layout, fwd)), params.wb.device)
    ints, floats = _launch_args(RolloutConfig(0, False, None, (1.0, 1.0, 1.0)), layout, 1, 2, S, D, A, V, 0, 2)
    weights, strides = _weights(params)
    err = _library().fused_rollout_image_launch(
        ctypes.addressof(ints), ctypes.addressof(floats), _pointers(weights), ctypes.addressof(strides), int(fwd),
        images[0].data_ptr(), images[1].data_ptr() if fwd else None,
        torch.cuda.current_stream(images[0].device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"the rollout's image gather failed with CUDA error {err}")
    return tuple(images) if fwd else images[0]


def max_active_clusters(params: PackedParams, fwd: bool) -> Tuple[int, int, int]:
    """(CTAs per cluster, shared memory bytes per CTA, clusters the card
    holds at once: cudaOccupancyMaxActiveClusters) for the rollout kernel at
    these sizes; a measurement entry for the smoke run."""
    layout = rollout_layout(params.wb.shape[0], len(params.wx), params.wx[0].shape[0], params.whead.shape[1])
    smem = _smem_bytes(layout, _stages(layout, fwd), fwd)
    clusters = _library().fused_rollout_max_clusters(int(fwd), layout.cluster, smem, int(rollout_is_wide(layout, fwd)))
    if clusters < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed with CUDA error {-clusters}")
    return layout.cluster, smem, clusters


def padded_rollout_fwd(cfg: RolloutConfig, params: PackedParams, inputs: Sequence[torch.Tensor], gt_count: int,
                       collect_residuals: bool, run, *args):
    """`run`(cfg, params', inputs, gt_count, collect_residuals, *args), a
    rollout forward, at the kernels' features (`padded_params`), the
    residuals cut back to the network's own."""
    features = params.wb.shape[0]
    padded = kernel_features(features)
    out, residuals = run(cfg, padded_params(params, padded), inputs, gt_count, collect_residuals, *args)
    return out, (unpadded_residuals(residuals, features, padded) if residuals is not None else None)


def _rollout_fwd(cfg: RolloutConfig, params: PackedParams, inputs: Sequence[torch.Tensor], gt_count: int,
                 collect_residuals: bool, ms=None):
    """B4 at the kernel's features (`padded_rollout_fwd`)."""
    return padded_rollout_fwd(cfg, params, inputs, gt_count, collect_residuals, _rollout_fwd_launch, ms)


def _rollout_fwd_launch(cfg: RolloutConfig, params: PackedParams, inputs: Sequence[torch.Tensor], gt_count: int,
                        collect_residuals: bool, ms=None):
    rotations, style, deform, actions, variations = inputs[0], inputs[2], inputs[3], inputs[4], inputs[5]
    batch, T = rotations.shape[0], rotations.shape[1]
    S, D, A, V = style.shape[-1], deform.shape[-1], actions.shape[-1], variations.shape[-1]
    _validate(cfg, params, T, (batch, S, D, A, V), dict(zip(
        ("rotations", "translations", "style", "deformation", "actions", "variations"), inputs)))
    layers = len(params.wx)
    plan = _plan(cfg, True, collect_residuals, batch, T, S, D, A, V, params.wb.shape[0], layers, gt_count)
    inputs = [t.contiguous() for t in inputs]
    device = rotations.device
    out = _carve(plan.outputs, device)
    residuals = dict(zip(residual_keys(layers), _carve(plan.extra, device))) if collect_residuals else None
    scratch, (image, bias, *wide) = _scratch(plan.scratch, device)  # scratch alive until the launch is enqueued
    weights, strides = _weights(params)
    res_array = _pointers(list(residuals.values())) if residuals else None
    err = _library().fused_rollout_fwd_launch(
        ctypes.addressof(plan.ints), ctypes.addressof(plan.floats), _pointers(weights), ctypes.addressof(strides),
        image, bias, *(t.data_ptr() for t in inputs), *(t.data_ptr() for t in out), res_array,
        int(collect_residuals), None if ms is None else ctypes.addressof(ms),
        torch.cuda.current_stream(device).cuda_stream, wide[0] if wide else None,
    )
    if err != 0:
        raise RuntimeError(f"fused_rollout_fwd kernel launch failed with CUDA error {err}")
    return tuple(out), residuals


def fused_rollout_fwd(cfg: RolloutConfig, params: PackedParams, rotations, translations, style, deform, actions,
                      variations, gt_count: int, collect_residuals: bool):
    """The rollout forward: (four (B, T, .) outputs, residuals or None).

    CPU tensors take `plain_rollout_fwd`. CUDA tensors launch B4 on clusters
    of CTAs (counted in `fused_rollout_fwd.launches`) after the gather of
    this call's weight image, at the kernel's features (`kernel_features`),
    the wide kernel where `rollout_is_wide`; any other device, a shape
    beyond 768 features or 16 layers, a cluster the card cannot place, or a
    failed build or launch raises.
    """
    gt_count = int(gt_count)
    inputs = [rotations, translations, style, deform, actions, variations]
    if rotations.device.type == "cpu":
        return plain_rollout_fwd(cfg, params, *inputs, gt_count, collect_residuals)
    result = _rollout_fwd(cfg, params, inputs, gt_count, collect_residuals)
    fused_rollout_fwd.launches += 1
    return result


def rollout_fwd_breakdown(cfg: RolloutConfig, params: PackedParams, inputs: Sequence[torch.Tensor], gt_count: int,
                          collect_residuals: bool) -> Dict[str, float]:
    """One forward on the card, timed by CUDA events around its two launches
    (a measurement entry, not counted in the launches): ms of the image
    gather and of the rollout kernel."""
    ms = (ctypes.c_float * 2)()
    _rollout_fwd(cfg, params, list(inputs), int(gt_count), collect_residuals, ms)
    return {"image_ms": ms[0], "kernel_ms": ms[1]}


fused_rollout_fwd.launches = 0


def padded_rollout_bwd(cfg: RolloutConfig, params: PackedParams, gt_count: int, residuals: Dict[str, torch.Tensor],
                       cotangents: Sequence[torch.Tensor], actions_dim: int, run, *args):
    """`run`(cfg, params', gt_count, residuals', cotangents, actions_dim,
    *args), a rollout backward, at the kernels' features: the parameters
    and residuals padded (`padded_params`, `padded_residuals`), the
    parameters' gradients cut back to their shapes."""
    features = params.wb.shape[0]
    padded = kernel_features(features)
    grads = run(cfg, padded_params(params, padded), gt_count, padded_residuals(residuals, features, padded),
                cotangents, actions_dim, *args)
    return (unpadded_grads(params, grads[0]),) + tuple(grads[1:])


def _rollout_bwd(cfg: RolloutConfig, params: PackedParams, gt_count: int, residuals: Dict[str, torch.Tensor],
                 cotangents: Sequence[torch.Tensor], actions_dim: int, ms=None):
    """B5 at the kernel's features (`padded_rollout_bwd`)."""
    return padded_rollout_bwd(cfg, params, gt_count, residuals, cotangents, actions_dim, _rollout_bwd_launch, ms)


def _rollout_bwd_launch(cfg: RolloutConfig, params: PackedParams, gt_count: int,
                        residuals: Dict[str, torch.Tensor], cotangents: Sequence[torch.Tensor], actions_dim: int,
                        ms=None):
    batch, T = cotangents[0].shape[0], cotangents[0].shape[1]
    layers = len(params.wx)
    res_list = [residuals[k] for k in residual_keys(layers)]
    features, in0, head = params.wb.shape[0], params.wx[0].shape[0], params.whead.shape[1]
    S, D = cotangents[2].shape[-1], cotangents[3].shape[-1]
    V = in0 - 9 - S - D - actions_dim
    names = ("d_rotations", "d_translations", "d_style", "d_deformation")
    _validate(cfg, params, T, (batch, S, D, actions_dim, V), {**dict(zip(names, cotangents)), **residuals})
    plan = _plan(cfg, False, True, batch, T, S, D, actions_dim, V, features, layers, gt_count)
    device = cotangents[0].device
    cotangents = [c.contiguous() for c in cotangents]
    # The recurrence copies residual rows 16 bytes at a time.
    res_list = [r.contiguous() for r in res_list]
    res_list = [r if r.data_ptr() % 16 == 0 else r.clone() for r in res_list]
    # Contiguous whatever the parameters' layout (pack_dynamics_params's wb is a
    # transposed view): the kernel writes each gradient row-major.
    grads = [torch.empty(p.shape, device=device) for p in param_list(params)]
    *g_states, g_actions, g_variations = _carve(plan.extra, device)
    scratch, (image, dz, dy, dhead, d_final, *wide) = _scratch(plan.scratch, device)  # alive until enqueued
    weights, strides = _weights(params)
    err = _library().fused_rollout_bwd_launch(
        ctypes.addressof(plan.ints), ctypes.addressof(plan.floats), _pointers(weights), ctypes.addressof(strides),
        image, _pointers(res_list), *(c.data_ptr() for c in cotangents), _pointers(grads),
        *(g.data_ptr() for g in g_states), g_actions.data_ptr(), g_variations.data_ptr(), dz, dy, dhead, d_final,
        None if ms is None else ctypes.addressof(ms), torch.cuda.current_stream(device).cuda_stream,
        wide[0] if wide else None,
    )
    if err != 0:
        raise RuntimeError(f"fused_rollout_bwd kernel launch failed with CUDA error {err}")
    return (params_from_list(grads, layers),) + tuple(g_states) + (g_actions, g_variations)


def fused_rollout_bwd(cfg: RolloutConfig, params: PackedParams, gt_count: int, residuals: Dict[str, torch.Tensor],
                      cotangents: Sequence[torch.Tensor], actions_dim: int):
    """The rollout backward, as `plain_rollout_bwd` returns it.

    CPU tensors take `plain_rollout_bwd`. CUDA tensors launch B5 (the
    gather of this call's weight image, the reverse recurrence on the
    forward's clusters, the wide one where `rollout_is_wide`, then the
    weight-gradient kernel; one call counted in
    `fused_rollout_bwd.launches`); the gradients are bit-identical from run
    to run.
    """
    gt_count = int(gt_count)
    if cotangents[0].device.type == "cpu":
        return plain_rollout_bwd(cfg, params, gt_count, residuals, cotangents, actions_dim)
    grads = _rollout_bwd(cfg, params, gt_count, residuals, cotangents, actions_dim)
    fused_rollout_bwd.launches += 1
    return grads


fused_rollout_bwd.launches = 0


def rollout_bwd_breakdown(cfg: RolloutConfig, params: PackedParams, gt_count: int,
                          residuals: Dict[str, torch.Tensor], cotangents: Sequence[torch.Tensor],
                          actions_dim: int) -> Dict[str, float]:
    """One backward on the card, timed by CUDA events around its three
    launches (a measurement entry, not counted in the launches): ms of the
    image gather, the reverse recurrence and the weight-gradient kernel."""
    ms = (ctypes.c_float * 3)()
    _rollout_bwd(cfg, params, int(gt_count), residuals, cotangents, actions_dim, ms)
    return {"image_ms": ms[0], "recurrence_ms": ms[1], "wgrad_ms": ms[2]}


# ---------------------------------------------------------------------------
# The differentiable op
# ---------------------------------------------------------------------------


class _FusedRollout(torch.autograd.Function):
    """Forward: fused_rollout_fwd with residuals; backward: fused_rollout_bwd
    on them, as the JAX custom VJP saves them."""

    @staticmethod
    def forward(ctx, cfg, gt_count, layers, rotations, translations, style, deform, actions, variations, *weights):
        params = params_from_list(weights, layers)
        out, residuals = fused_rollout_fwd(cfg, params, rotations, translations, style, deform, actions,
                                           variations, gt_count, collect_residuals=True)
        ctx.cfg, ctx.gt_count, ctx.layers, ctx.actions_dim = cfg, gt_count, layers, actions.shape[-1]
        ctx.save_for_backward(*weights, *(residuals[k] for k in residual_keys(layers)))
        return out

    @staticmethod
    def backward(ctx, *cotangents):
        saved = ctx.saved_tensors
        n = 5 * ctx.layers + 4
        params = params_from_list(saved[:n], ctx.layers)
        residuals = dict(zip(residual_keys(ctx.layers), saved[n:]))
        batch, steps = residuals["cur_rot"].shape[1], residuals["cur_rot"].shape[0]
        widths = (3, 3, residuals["cur_style"].shape[-1], residuals["cur_deform"].shape[-1])
        cotangents = [
            c if c is not None else params.wb.new_zeros(batch, steps + 1, w) for c, w in zip(cotangents, widths)
        ]
        grads = fused_rollout_bwd(ctx.cfg, params, ctx.gt_count, residuals, cotangents, ctx.actions_dim)
        g_params, rest = grads[0], grads[1:]
        return (None, None, None) + tuple(rest) + tuple(param_list(g_params))


def fused_rollout(cfg: RolloutConfig, params: PackedParams, rotations, translations, style, deform, actions,
                  variations, gt_count: int):
    """Teacher-forced dynamics rollout: (rotations, translations, style,
    deformation), each (B, T, .); step t reads the ground truth while t <
    gt_count (a host int). Differentiable in every tensor argument; the
    residuals are collected only when autograd needs them."""
    tensors = [rotations, translations, style, deform, actions, variations] + param_list(params)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _FusedRollout.apply(cfg, int(gt_count), len(params.wx), *tensors)
    out, _ = fused_rollout_fwd(cfg, params, rotations, translations, style, deform, actions, variations,
                               gt_count, collect_residuals=False)
    return out
