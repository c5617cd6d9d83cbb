"""Batched 3-vector math (the reference's Vec3 layer, re-shaped for batches).

The reference (`raytracer/src/vec3.rs`) defines a scalar f64 ``Vec3`` with
operator overloads. Here the equivalent is: vectors are ``(..., 3)`` jnp
arrays, operations broadcast over leading batch dims, and everything is f32
by default (f64 opt-in via ``jax.config.update("jax_enable_x64", True)`` for
validation runs).

Parity notes (reference file:line):
- dot as ``Mul`` operator              vec3.rs:335-341  -> :func:`dot`
- ``elemul``                           vec3.rs:66       -> plain ``*``
- ``cross``                            vec3.rs:74       -> :func:`cross`
- ``unit`` (panics on zero)            vec3.rs:86-91    -> :func:`unit` (guarded)
- ``is_near_zero`` (1e-8)              vec3.rs:93-96    -> :func:`near_zero`
- ``reflect``                          vec3.rs:163-165  -> :func:`reflect`
- ``refract``                          vec3.rs:167-172  -> :func:`refract`
- 4x4 point/dir transform (nalgebra)   vec3.rs:174-184
  -> :func:`transform_point` / :func:`transform_dir`
- gamma-2 encode to Rgb<u8>            vec3.rs:223-231  -> :func:`to_rgb8`
- gamma-2 decode from Rgb<u8>          vec3.rs:233-245  -> :func:`from_rgb8`
"""

from __future__ import annotations

import jax.numpy as jnp

NEAR_ZERO_EPS = 1e-8


def vec3(x, y, z, dtype=jnp.float32):
    """Build a (3,) vector (or batched from broadcastable components)."""
    return jnp.stack(jnp.broadcast_arrays(
        jnp.asarray(x, dtype), jnp.asarray(y, dtype), jnp.asarray(z, dtype)), axis=-1)


def dot(a, b):
    """Batched dot product over the trailing axis. vec3.rs:335-341."""
    return jnp.sum(a * b, axis=-1)


def cross(a, b):
    """Batched cross product. vec3.rs:74-80."""
    return jnp.cross(a, b)


def squared_length(v):
    return dot(v, v)


def length(v):
    return jnp.sqrt(squared_length(v))


def unit(v, eps=0.0):
    """Normalize; guarded against zero length (the reference panics,
    vec3.rs:88 — here we return 0 instead of NaN and rely on callers'
    validity masks)."""
    l2 = squared_length(v)
    inv = jnp.where(l2 > eps, 1.0 / jnp.sqrt(jnp.maximum(l2, 1e-30)), 0.0)
    return v * inv[..., None]


def near_zero(v):
    """All components < 1e-8 in magnitude. vec3.rs:93-96."""
    return jnp.all(jnp.abs(v) < NEAR_ZERO_EPS, axis=-1)


def reflect(v_in, n):
    """v - 2(v.n)n. vec3.rs:163-165."""
    return v_in - 2.0 * dot(v_in, n)[..., None] * n


def refract(uv, n, etai_over_etat):
    """Snell refraction of a *unit* incoming dir. vec3.rs:167-172."""
    cos_theta = jnp.minimum(dot(-uv, n), 1.0)
    eta = jnp.asarray(etai_over_etat)
    if eta.ndim < cos_theta.ndim:
        eta = jnp.broadcast_to(eta, cos_theta.shape)
    r_out_perp = eta[..., None] * (uv + cos_theta[..., None] * n)
    r_out_parallel = -jnp.sqrt(jnp.abs(1.0 - squared_length(r_out_perp)))[..., None] * n
    return r_out_perp + r_out_parallel


def transform_point(p, mat4):
    """Apply a 4x4 homogeneous transform to points. vec3.rs:174-178."""
    return p @ mat4[:3, :3].T + mat4[:3, 3]


def transform_dir(d, mat4):
    """Apply a 4x4 transform to directions (w=0). vec3.rs:180-184."""
    return d @ mat4[:3, :3].T


def gamma2_encode(color):
    """sqrt + clamp to [0,1] (gamma-2 encode). vec3.rs:226-228."""
    return jnp.clip(jnp.sqrt(jnp.maximum(color, 0.0)), 0.0, 1.0)


def to_rgb8(color):
    """Vec3 -> Rgb<u8>: floor(sqrt(c).clamp(0,1) * 255). vec3.rs:223-231."""
    return jnp.floor(gamma2_encode(color) * 255.0).astype(jnp.uint8)


def from_rgb8(rgb):
    """Rgb<u8> -> linear-ish Vec3 in [0,1] (no de-gamma, matching
    vec3.rs:233-238 which divides by 255 only)."""
    return rgb.astype(jnp.float32) / 255.0
