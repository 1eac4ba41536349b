"""Skeleton preprocessing (the port's own numpy copy of
``litemkd_tpu/data/skeleton.py``; the reference's NTU pipeline,
``teacher/code/scripts/{preprocess,rotation}.py``): null-frame padding,
spine-centring and rotation normalisation (hip axis → z, shoulder axis →
x), which prepare the skeleton modality for the S3D expert.
``tests/test_torch_port_heads.py`` holds it ``np.array_equal`` to the
JAX package's.
"""
from __future__ import annotations

import numpy as np


def pad_null_frames(data: np.ndarray) -> np.ndarray:
    """(N, C, T, V, M): replay each body's frames to fill trailing null frames
    (reference preprocess.py pad loop)."""
    out = data.copy()
    n, c, t, v, m = out.shape
    for i in range(n):
        for person in range(m):
            body = out[i, :, :, :, person]          # (C, T, V)
            if body.sum() == 0:
                continue
            if body[:, 0].sum() == 0:               # leading nulls: shift up
                valid = (body.sum(axis=(0, 2)) != 0)
                first = int(np.argmax(valid))
                body = np.concatenate([body[:, first:], np.zeros_like(body[:, :first])], axis=1)
            valid = (body.sum(axis=(0, 2)) != 0)
            n_valid = int(valid.sum())
            if 0 < n_valid < t:
                reps = -(-t // n_valid)
                body = np.concatenate([body[:, :n_valid]] * reps, axis=1)[:, :t]
            out[i, :, :, :, person] = body
    return out


def center_spine(data: np.ndarray, spine_joint: int = 1) -> np.ndarray:
    """Subtract the first body's spine-joint trajectory from all joints
    (reference preprocess.py 'sub the center joint')."""
    out = data.copy()
    mask = (out.sum(axis=1, keepdims=True) != 0)     # (N,1,T,V,M)
    center = out[:, :, :, spine_joint:spine_joint + 1, 0:1]  # (N,C,T,1,1)
    out = (out - center) * mask
    return out


def _rotation_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues rotation matrix (reference rotation.py:5-21)."""
    axis = np.asarray(axis, np.float64)
    n = np.linalg.norm(axis)
    if n < 1e-6:
        return np.eye(3)
    axis = axis / n
    a = np.cos(angle / 2.0)
    b, c, d = -axis * np.sin(angle / 2.0)
    aa, bb, cc, dd = a * a, b * b, c * c, d * d
    bc, ad, ac, ab, bd, cd = b * c, a * d, a * c, a * b, b * d, c * d
    return np.array([
        [aa + bb - cc - dd, 2 * (bc + ad), 2 * (bd - ac)],
        [2 * (bc - ad), aa + cc - bb - dd, 2 * (cd + ab)],
        [2 * (bd + ac), 2 * (cd - ab), aa + dd - bb - cc]])


def _angle_between(v1, v2):
    n1, n2 = np.linalg.norm(v1), np.linalg.norm(v2)
    if n1 < 1e-6 or n2 < 1e-6:
        return 0.0
    return float(np.arccos(np.clip(np.dot(v1 / n1, v2 / n2), -1.0, 1.0)))


def rotate_to_canonical(data: np.ndarray, hip_joints=(0, 1),
                        shoulder_joints=(8, 4)) -> np.ndarray:
    """Rotate so the bottom→top spine bone aligns with z and the shoulder
    line with x, per sequence (reference preprocess.py 'parallel the bone')."""
    out = data.copy()
    n, c, t, v, m = out.shape
    z = np.array([0.0, 0.0, 1.0])
    x = np.array([1.0, 0.0, 0.0])
    for i in range(n):
        first = out[i, :, 0, :, 0]                   # (C, V)
        bone = first[:, hip_joints[1]] - first[:, hip_joints[0]]
        axis = np.cross(bone, z)
        R1 = _rotation_matrix(axis, _angle_between(bone, z))
        sh = R1 @ (first[:, shoulder_joints[0]] - first[:, shoulder_joints[1]])
        R2 = _rotation_matrix(z, _angle_between(sh, x))
        R = R2 @ R1
        flat = out[i].reshape(c, -1)
        out[i] = (R @ flat).reshape(c, t, v, m)
    return out


def preprocess_skeleton(data: np.ndarray) -> np.ndarray:
    """Full NTU-style normalization: pad → center → rotate."""
    return rotate_to_canonical(center_spine(pad_null_frames(data)))
