"""Euler-angle rotations and rigid-body transforms as plain tensor functions.

Port of playableenvironments_tpu/core/transforms3d.py (rotation conventions,
z->x->y composition order). All functions broadcast over leading dimensions.
"""

from __future__ import annotations

import torch


def _rows(rows) -> torch.Tensor:
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotation_x(radians: torch.Tensor) -> torch.Tensor:
    """(...) angles -> (..., 3, 3) rotations about x."""
    c, s = torch.cos(radians), torch.sin(radians)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rows([[o, z, z], [z, c, -s], [z, s, c]])


def rotation_y(radians: torch.Tensor) -> torch.Tensor:
    """(...) angles -> (..., 3, 3) rotations about y."""
    c, s = torch.cos(radians), torch.sin(radians)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rows([[c, z, s], [z, o, z], [-s, z, c]])


def rotation_z(radians: torch.Tensor) -> torch.Tensor:
    """(...) angles -> (..., 3, 3) rotations about z."""
    c, s = torch.cos(radians), torch.sin(radians)
    o, z = torch.ones_like(c), torch.zeros_like(c)
    return _rows([[c, -s, z], [s, c, z], [z, z, o]])


def _homogeneous(top: torch.Tensor) -> torch.Tensor:
    bottom = top.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(top.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def euler_translation_to_matrix(
    rotations: torch.Tensor, translations: torch.Tensor
) -> torch.Tensor:
    """Euler (x, y, z) angles + translation -> (..., 4, 4) homogeneous
    matrices, R = Ry @ (Rx @ Rz)."""
    rx = rotation_x(rotations[..., 0])
    ry = rotation_y(rotations[..., 1])
    rz = rotation_z(rotations[..., 2])
    rotation = ry @ (rx @ rz)
    return _homogeneous(torch.cat([rotation, translations[..., :, None]], dim=-1))


def invert_rigid(matrix: torch.Tensor) -> torch.Tensor:
    """[R t]^-1 = [R^T, -R^T t] for (..., 4, 4) rigid transforms."""
    rot_t = matrix[..., :3, :3].transpose(-1, -2)
    trans = -(rot_t @ matrix[..., :3, 3:4])
    return _homogeneous(torch.cat([rot_t, trans], dim=-1))
