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
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

from playableenvironments_tpu_torch.ops import fused_nerf

GATES = ("i", "f", "g", "o")

_SOURCE = fused_nerf._ROLLOUT_SOURCE
# Limits of csrc/fused_rollout.cu: batch rows per CTA, layers, features and
# the shared memory one CTA may take on an H100.
_TILE = 16
_MAX_LAYERS = 4
_MAX_FEATURES = 256
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
    lib.fused_rollout_fwd_launch.argtypes = (
        [ctypes.c_void_p] * 12 + [ctypes.c_int] * 13 + [ctypes.c_float] * 4 + [ctypes.c_void_p])
    lib.fused_rollout_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 17 + [ctypes.c_int] * 12 + [ctypes.c_float] * 3 + [ctypes.c_void_p])
    lib.fused_rollout_fwd_launch.restype = ctypes.c_int
    lib.fused_rollout_bwd_launch.restype = ctypes.c_int
    return lib


def _pointers(tensors: Sequence[torch.Tensor]) -> ctypes.c_void_p:
    """A host array of the tensors' device pointers, as the C launchers
    take it (the caller keeps the tensors alive for the call)."""
    array = (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])
    return ctypes.cast(array, ctypes.c_void_p)  # the cast keeps a reference to the array


def _smem_bytes(features, layers, in0, head, state_width, fwd) -> int:
    """Dynamic shared memory of one CTA (csrc/fused_rollout.cu's layout)."""
    z_width = max(4 * features, features + head)
    if fwd:
        floats = _TILE * (state_width + in0 + 2 * layers * features + z_width)
    else:
        floats = _TILE * (state_width + 6 + 2 * layers * features + z_width + max(in0, features))
    return 4 * floats


def _kernel_checks(cfg: RolloutConfig, params: PackedParams, tensors: Sequence[torch.Tensor], T: int) -> None:
    device = tensors[0].device
    if device.type != "cuda":
        raise ValueError(f"the fused rollout runs on cuda or cpu tensors, not {device}")
    for t in list(tensors) + param_list(params):
        if t.device != device or t.dtype != torch.float32:
            raise ValueError(f"inputs must be float32 on {device}, got {t.dtype} on {t.device}")
    features, layers = params.wb.shape[0], len(params.wx)
    if features % 32 or not 32 <= features <= _MAX_FEATURES:
        raise ValueError(f"features {features} must be a multiple of 32, at most {_MAX_FEATURES}")
    if not 1 <= layers <= _MAX_LAYERS:
        raise ValueError(f"layers {layers} must be 1 to {_MAX_LAYERS}")
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


def _dims(params: PackedParams, style: torch.Tensor, deform: torch.Tensor):
    features, layers = params.wb.shape[0], len(params.wx)
    in0 = params.wx[0].shape[0]
    head = params.whead.shape[1]
    state_width = 6 + style.shape[-1] + deform.shape[-1]
    return features, layers, in0, head, state_width


def _check_smem(params, style, deform, fwd: bool) -> None:
    features, layers, in0, head, state_width = _dims(params, style, deform)
    need = _smem_bytes(features, layers, in0, head, state_width, fwd)
    if need > _MAX_SMEM:
        raise ValueError(f"the rollout {'forward' if fwd else 'backward'} needs {need} bytes of shared memory "
                         f"per CTA, more than the card's {_MAX_SMEM}")


def _config_args(cfg: RolloutConfig):
    forced = cfg.force_axis_translation
    return [cfg.rotation_axis, int(cfg.force_rotations_zero), int(forced is not None)], [
        float(forced or 0.0)] + [1.0 / b for b in cfg.box_size]


def fused_rollout_fwd(cfg: RolloutConfig, params: PackedParams, rotations, translations, style, deform, actions,
                      variations, gt_count: int, collect_residuals: bool):
    """The rollout forward: (four (B, T, .) outputs, residuals or None).

    CPU tensors take `plain_rollout_fwd`. CUDA tensors launch B4 (counted in
    `fused_rollout_fwd.launches`); any other device, an unsupported shape,
    or a failed build or launch raises.
    """
    gt_count = int(gt_count)
    if rotations.device.type == "cpu":
        return plain_rollout_fwd(cfg, params, rotations, translations, style, deform, actions, variations,
                                 gt_count, collect_residuals)
    inputs = [rotations, translations, style, deform, actions, variations]
    batch, T = rotations.shape[0], rotations.shape[1]
    _kernel_checks(cfg, params, inputs, T)
    _check_smem(params, style, deform, True)
    features, layers, in0, head, _ = _dims(params, style, deform)
    A, V = actions.shape[-1], variations.shape[-1]
    check_shapes(params, batch, T, style.shape[-1], deform.shape[-1], A, V, dict(zip(
        ("rotations", "translations", "style", "deformation", "actions", "variations"), inputs)))
    inputs = [t.contiguous() for t in inputs]
    weights = [p.contiguous() for p in param_list(params)]
    device = rotations.device
    out = [torch.empty(batch, T, t.shape[-1], device=device) for t in inputs[:4]]
    residuals = None
    if collect_residuals:
        S, D = style.shape[-1], deform.shape[-1]
        widths = {"cur_rot": 3, "cur_trans": 3, "cur_style": S, "cur_deform": D, "x0": in0, "y": features,
                  "head": head}
        for layer in range(layers):
            widths.update({f"gates_{layer}": 4 * features, f"c_{layer}": features, f"h_{layer}": features})
        residuals = {k: torch.empty(T - 1, batch, widths[k], device=device) for k in residual_keys(layers)}
    ints, floats = _config_args(cfg)
    weight_array = _pointers(weights)
    res_array = _pointers([residuals[k] for k in residual_keys(layers)]) if residuals else None
    err = _library().fused_rollout_fwd_launch(
        weight_array, *(t.data_ptr() for t in inputs), *(t.data_ptr() for t in out), res_array,
        batch, T, features, layers, style.shape[-1], deform.shape[-1], A, V, gt_count, *ints,
        int(residuals is not None), *floats, torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_rollout_fwd kernel launch failed with CUDA error {err}")
    fused_rollout_fwd.launches += 1
    return tuple(out), residuals


fused_rollout_fwd.launches = 0


def fused_rollout_bwd(cfg: RolloutConfig, params: PackedParams, gt_count: int, residuals: Dict[str, torch.Tensor],
                      cotangents: Sequence[torch.Tensor], actions_dim: int):
    """The rollout backward, as `plain_rollout_bwd` returns it.

    CPU tensors take `plain_rollout_bwd`. CUDA tensors launch B5 (its
    reverse recurrence, then its weight-gradient kernel; one call counted in
    `fused_rollout_bwd.launches`); the gradients are bit-identical from run
    to run.
    """
    gt_count = int(gt_count)
    if cotangents[0].device.type == "cpu":
        return plain_rollout_bwd(cfg, params, gt_count, residuals, cotangents, actions_dim)
    batch, T = cotangents[0].shape[0], cotangents[0].shape[1]
    layers = len(params.wx)
    res_list = [residuals[k] for k in residual_keys(layers)]
    _kernel_checks(cfg, params, list(cotangents) + res_list, T)
    _check_smem(params, cotangents[2], cotangents[3], False)
    features, layers, in0, head, _ = _dims(params, cotangents[2], cotangents[3])
    S, D = cotangents[2].shape[-1], cotangents[3].shape[-1]
    V = in0 - 9 - S - D - actions_dim
    names = ("d_rotations", "d_translations", "d_style", "d_deformation")
    check_shapes(params, batch, T, S, D, actions_dim, V, {**dict(zip(names, cotangents)), **residuals})
    device = cotangents[0].device
    cotangents = [c.contiguous() for c in cotangents]
    res_list = [r.contiguous() for r in res_list]
    # The recurrence reads W^T (each weight transposed once, a copy, no product).
    transposed = []
    for layer in range(layers):
        transposed += [params.wx[layer].t().contiguous(), params.wh[layer].t().contiguous(),
                       params.c_init[layer].contiguous(), params.h_init[layer].contiguous()]
    transposed += [params.wb.t().contiguous(), params.whead.t().contiguous()]
    # Contiguous whatever the parameters' layout (pack_dynamics_params's wb is a
    # transposed view): the kernel writes each gradient row-major.
    grads = [torch.empty(p.shape, device=device) for p in param_list(params)]
    g_states = [torch.empty(batch, T, c.shape[-1], device=device) for c in cotangents]
    g_actions = torch.empty(batch, T - 1, actions_dim, device=device)
    g_variations = torch.empty(batch, T - 1, V, device=device)
    steps = T - 1
    dz = torch.empty(layers, steps, batch, 4 * features, device=device)
    dy = torch.empty(steps, batch, features, device=device)
    dhead = torch.empty(steps, batch, head, device=device)
    d_final = torch.empty(2, layers, batch, features, device=device)
    ints, floats = _config_args(cfg)
    arrays = [_pointers(transposed), _pointers(res_list), _pointers(grads)]
    err = _library().fused_rollout_bwd_launch(
        arrays[0], arrays[1], *(c.data_ptr() for c in cotangents), arrays[2],
        *(g.data_ptr() for g in g_states), g_actions.data_ptr(), g_variations.data_ptr(),
        dz.data_ptr(), dy.data_ptr(), dhead.data_ptr(), d_final.data_ptr(),
        batch, T, features, layers, S, D, actions_dim, V, gt_count, *ints, *floats[1:],
        torch.cuda.current_stream(device).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fused_rollout_bwd kernel launch failed with CUDA error {err}")
    fused_rollout_bwd.launches += 1
    g_params = params_from_list(grads, layers)
    return (g_params,) + tuple(g_states) + (g_actions, g_variations)


fused_rollout_bwd.launches = 0


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
