"""Batched photon emission from the light table (light.rs:61-235).

``AllLights::emit`` picks one light ∝ power then delegates (light.rs:220-225).
Batched: one categorical draw per photon. NOTE the reference does NOT divide
photon power by the pick probability (no importance correction) — preserved,
single-light scenes are unaffected.

Per-kind emission:
- SphereDiffuseLight (light.rs:98-103): surface normal ~ uniform sphere,
  origin = center + norm*(r + 1e-4), dir ~ uniform hemisphere around norm,
  power = flux * scale.
- XZRectLight (light.rs:158-166): origin uniform on the rect, dir ~ uniform
  hemisphere around (0,-1,0), power = flux * scale * max(0, -w.y).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer.ops import sampling, vec
from raytracer.scene.types import LIGHT_SPHERE, Lights


class PhotonBatch(NamedTuple):
    origin: jnp.ndarray  # (N, 3)
    dir: jnp.ndarray     # (N, 3)
    power: jnp.ndarray   # (N, 3)
    norm: jnp.ndarray    # (N, 3) emitting-surface normal


def emit_photons(lights: Lights, key, n: int) -> PhotonBatch:
    k_pick, k_sphere, k_hemi, k_uv = jax.random.split(key, 4)
    idx = jax.random.categorical(k_pick, lights.log_prob, shape=(n,))
    kind = lights.kind[idx]
    p0 = lights.p0[idx]
    p1 = lights.p1[idx]
    r0 = lights.r0[idx]
    base_power = lights.flux[idx] * lights.scale[idx][:, None]

    # sphere lights
    s_norm = sampling.uniform_sphere(k_sphere, (n,))
    s_origin = p0 + s_norm * (r0 + 1e-4)[:, None]

    # xz-rect lights
    uv = jax.random.uniform(k_uv, (n, 2))
    r_origin = jnp.stack([
        p0[:, 0] + (p1[:, 0] - p0[:, 0]) * uv[:, 0],
        p0[:, 1],
        p0[:, 2] + (p1[:, 2] - p0[:, 2]) * uv[:, 1],
    ], axis=-1)
    down = jnp.broadcast_to(jnp.array([0.0, -1.0, 0.0]), (n, 3))
    r_norm = down

    is_sphere = (kind == LIGHT_SPHERE)[:, None]
    norm = jnp.where(is_sphere, s_norm, r_norm)
    origin = jnp.where(is_sphere, s_origin, r_origin)
    # one hemisphere draw around the selected normal serves both kinds
    w = sampling.uniform_hemisphere(k_hemi, norm)
    cos_term = jnp.maximum(vec.dot(down, w), 0.0)
    power = jnp.where(is_sphere, base_power, base_power * cos_term[:, None])
    return PhotonBatch(origin, w, power, norm)
