"""SE(3) rigid transforms as (quaternion, translation) pytrees.

Batched JAX replacement for the reference's minkindr `QuatTransformation`
(reference: mapper_emvs_stereo/include/mapper_emvs_stereo/geometry_utils.hpp:9,
trajectory.hpp:92-127).  Everything here is pure jnp, shape-polymorphic over
leading batch dimensions, and safe under `jit`/`vmap`.

Conventions:
  - Quaternions are (w, x, y, z), unit norm, representing rotation R(q).
  - A transform T = (q, t) maps points as  p' = R(q) @ p + t.
  - Composition (T1 * T2) applies T2 first:  R = R1 R2,  t = R1 t2 + t1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp


class SE3(NamedTuple):
    """Batched rigid transform; q: (..., 4) wxyz unit quaternion, t: (..., 3)."""

    q: jnp.ndarray
    t: jnp.ndarray

    @property
    def batch_shape(self):
        return self.q.shape[:-1]


def identity(batch_shape=(), dtype=jnp.float32) -> SE3:
    q = jnp.broadcast_to(
        jnp.array([1.0, 0.0, 0.0, 0.0], dtype=dtype), batch_shape + (4,)
    )
    t = jnp.zeros(batch_shape + (3,), dtype=dtype)
    return SE3(q, t)


# ---------------------------------------------------------------------------
# Quaternion algebra
# ---------------------------------------------------------------------------


def quat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    aw, ax, ay, az = jnp.moveaxis(a, -1, 0)
    bw, bx, by, bz = jnp.moveaxis(b, -1, 0)
    return jnp.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def quat_conj(q: jnp.ndarray) -> jnp.ndarray:
    return q * jnp.array([1.0, -1.0, -1.0, -1.0], dtype=q.dtype)


def quat_normalize(q: jnp.ndarray) -> jnp.ndarray:
    return q / jnp.linalg.norm(q, axis=-1, keepdims=True)


def quat_rotate(q: jnp.ndarray, v: jnp.ndarray) -> jnp.ndarray:
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qvec = q[..., 1:]
    uv = jnp.cross(qvec, v)
    uuv = jnp.cross(qvec, uv)
    return v + 2.0 * (q[..., :1] * uv + uuv)


def quat_to_matrix(q: jnp.ndarray) -> jnp.ndarray:
    w, x, y, z = jnp.moveaxis(q, -1, 0)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = jnp.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        axis=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def matrix_to_quat(m: jnp.ndarray) -> jnp.ndarray:
    """Rotation matrix (..., 3, 3) -> wxyz quaternion, branch-free (Shepperd)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    # Four candidate constructions; pick the numerically best by max pivot.
    qw = jnp.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22,
         1.0 - m00 - m11 + m22],
        axis=-1,
    )
    qw = jnp.sqrt(jnp.maximum(qw, 1e-12)) * 0.5
    case = jnp.argmax(qw, axis=-1)

    w0, x0 = qw[..., 0], (m21 - m12) / (4 * qw[..., 0])
    y0, z0 = (m02 - m20) / (4 * qw[..., 0]), (m10 - m01) / (4 * qw[..., 0])

    x1, w1 = qw[..., 1], (m21 - m12) / (4 * qw[..., 1])
    y1, z1 = (m01 + m10) / (4 * qw[..., 1]), (m02 + m20) / (4 * qw[..., 1])

    y2, w2 = qw[..., 2], (m02 - m20) / (4 * qw[..., 2])
    x2, z2 = (m01 + m10) / (4 * qw[..., 2]), (m12 + m21) / (4 * qw[..., 2])

    z3, w3 = qw[..., 3], (m10 - m01) / (4 * qw[..., 3])
    x3, y3 = (m02 + m20) / (4 * qw[..., 3]), (m12 + m21) / (4 * qw[..., 3])

    cands = jnp.stack(
        [
            jnp.stack([w0, x0, y0, z0], axis=-1),
            jnp.stack([w1, x1, y1, z1], axis=-1),
            jnp.stack([w2, x2, y2, z2], axis=-1),
            jnp.stack([w3, x3, y3, z3], axis=-1),
        ],
        axis=-2,
    )
    q = jnp.take_along_axis(cands, case[..., None, None].astype(jnp.int32), axis=-2)
    q = q[..., 0, :]
    # Canonicalize sign (w >= 0) and normalize.
    q = jnp.where(q[..., :1] < 0, -q, q)
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# SE(3) group operations
# ---------------------------------------------------------------------------


def compose(a: SE3, b: SE3) -> SE3:
    """a * b  (apply b first)."""
    return SE3(quat_normalize(quat_mul(a.q, b.q)), quat_rotate(a.q, b.t) + a.t)


def inverse(a: SE3) -> SE3:
    qi = quat_conj(a.q)
    return SE3(qi, -quat_rotate(qi, a.t))


def transform_points(a: SE3, p: jnp.ndarray) -> jnp.ndarray:
    return quat_rotate(a.q, p) + a.t


def to_matrix(a: SE3) -> jnp.ndarray:
    """(..., 4, 4) homogeneous matrix."""
    R = quat_to_matrix(a.q)
    top = jnp.concatenate([R, a.t[..., :, None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=a.q.dtype), a.batch_shape + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def from_matrix(m: jnp.ndarray) -> SE3:
    return SE3(matrix_to_quat(m[..., :3, :3]), m[..., :3, 3])


# ---------------------------------------------------------------------------
# exp / log maps (twist = [omega, v], rotation-first to match kindr usage)
# ---------------------------------------------------------------------------


def _sinc(x):
    """sin(x)/x, stable at 0."""
    x2 = x * x
    small = jnp.abs(x) < 1e-4
    return jnp.where(small, 1.0 - x2 / 6.0, jnp.sin(x) / jnp.where(small, 1.0, x))


def so3_exp(omega: jnp.ndarray) -> jnp.ndarray:
    """Axis-angle (..., 3) -> quaternion."""
    theta = jnp.linalg.norm(omega, axis=-1, keepdims=True)
    half = 0.5 * theta
    w = jnp.cos(half)
    xyz = omega * 0.5 * _sinc(half[..., 0])[..., None]
    return jnp.concatenate([w, xyz], axis=-1)


def so3_log(q: jnp.ndarray) -> jnp.ndarray:
    """Quaternion -> axis-angle (..., 3); takes the short path."""
    q = jnp.where(q[..., :1] < 0, -q, q)
    w = jnp.clip(q[..., 0], -1.0, 1.0)
    vnorm = jnp.linalg.norm(q[..., 1:], axis=-1)
    theta = 2.0 * jnp.arctan2(vnorm, w)
    scale = jnp.where(vnorm < 1e-9, 2.0, theta / jnp.where(vnorm < 1e-9, 1.0, vnorm))
    return q[..., 1:] * scale[..., None]


def _skew(w):
    wx, wy, wz = jnp.moveaxis(w, -1, 0)
    z = jnp.zeros_like(wx)
    m = jnp.stack([z, -wz, wy, wz, z, -wx, -wy, wx, z], axis=-1)
    return m.reshape(w.shape[:-1] + (3, 3))


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """3x3 matmul at HIGHEST precision: a reduced-precision f32 product
    (bf16 passes, or TF32 on a GPU) corrupts pose Jacobians (and through
    them every packet's homography) at the ~0.4 % level; these products
    are tiny, exactness is free."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _left_jacobian(omega: jnp.ndarray) -> jnp.ndarray:
    """SO(3) left Jacobian J(omega) such that exp twist trans = J @ v."""
    theta = jnp.linalg.norm(omega, axis=-1)
    W = _skew(omega)
    W2 = _mm(W, W)
    t2 = theta * theta
    small = theta < 1e-4
    safe = jnp.where(small, 1.0, theta)
    A = jnp.where(small, 0.5 - t2 / 24.0, (1.0 - jnp.cos(theta)) / (safe * safe))
    B = jnp.where(small, 1.0 / 6.0 - t2 / 120.0, (safe - jnp.sin(safe)) / (safe ** 3))
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye + A[..., None, None] * W + B[..., None, None] * W2


def _left_jacobian_inv(omega: jnp.ndarray) -> jnp.ndarray:
    theta = jnp.linalg.norm(omega, axis=-1)
    W = _skew(omega)
    W2 = _mm(W, W)
    t2 = theta * theta
    small = theta < 1e-4
    safe = jnp.where(small, 1.0, theta)
    # 1/t^2 - (1+cos t)/(2 t sin t)
    cot_term = jnp.where(
        small,
        1.0 / 12.0 + t2 / 720.0,
        (1.0 / (safe * safe))
        - (1.0 + jnp.cos(safe)) / (2.0 * safe * jnp.sin(safe)),
    )
    eye = jnp.broadcast_to(jnp.eye(3, dtype=omega.dtype), W.shape)
    return eye - 0.5 * W + cot_term[..., None, None] * W2


def se3_exp(twist: jnp.ndarray) -> SE3:
    """Twist (..., 6) = [omega, v] -> SE3.  t = J_l(omega) @ v."""
    omega, v = twist[..., :3], twist[..., 3:]
    q = so3_exp(omega)
    t = _mm(_left_jacobian(omega), v[..., :, None])[..., 0]
    return SE3(q, t)


def se3_log(a: SE3) -> jnp.ndarray:
    omega = so3_log(a.q)
    v = _mm(_left_jacobian_inv(omega), a.t[..., :, None])[..., 0]
    return jnp.concatenate([omega, v], axis=-1)


def interpolate(T0: SE3, T1: SE3, alpha: jnp.ndarray) -> SE3:
    """Linear interpolation on SE(3): T0 * exp(alpha * log(T0^-1 * T1)).

    Matches the reference trajectory lerp
    (mapper_emvs_stereo/include/mapper_emvs_stereo/trajectory.hpp:122-126).
    alpha broadcasts against the batch shape.
    """
    rel = compose(inverse(T0), T1)
    tw = se3_log(rel)
    return compose(T0, se3_exp(jnp.asarray(alpha)[..., None] * tw))
