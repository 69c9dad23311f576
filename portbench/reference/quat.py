"""Quaternions (w, x, y, z), body to global, batched over rows."""

from __future__ import annotations

import torch


def cross(a, b):
    return torch.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                        a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                        a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], dim=1)


def rotate(q, v):
    """The rotation matrix of unit q applied to v."""
    w, x, y, z = q.unbind(1)
    r00 = 1 - 2 * (y * y + z * z)
    r01 = 2 * (x * y - w * z)
    r02 = 2 * (x * z + w * y)
    r10 = 2 * (x * y + w * z)
    r11 = 1 - 2 * (x * x + z * z)
    r12 = 2 * (y * z - w * x)
    r20 = 2 * (x * z - w * y)
    r21 = 2 * (y * z + w * x)
    r22 = 1 - 2 * (x * x + y * y)
    vx, vy, vz = v.unbind(1)
    return torch.stack([r00 * vx + r01 * vy + r02 * vz,
                        r10 * vx + r11 * vy + r12 * vz,
                        r20 * vx + r21 * vy + r22 * vz], dim=1)


def rotate_inv(q, v):
    return rotate(torch.cat([q[:, :1], -q[:, 1:]], dim=1), v)


def integrate(q, omega_body, h):
    """normalize(q * (1, omega_body h / 2)), the body-frame update."""
    a = 0.5 * h * omega_body
    w1, x1, y1, z1 = q.unbind(1)
    x2, y2, z2 = a.unbind(1)
    out = torch.stack([w1 - x1 * x2 - y1 * y2 - z1 * z2,
                       x1 + w1 * x2 + y1 * z2 - z1 * y2,
                       y1 + w1 * y2 - x1 * z2 + z1 * x2,
                       z1 + w1 * z2 + x1 * y2 - y1 * x2], dim=1)
    return out / torch.sqrt((out * out).sum(1, keepdim=True))
