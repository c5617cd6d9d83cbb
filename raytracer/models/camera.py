"""Batched camera ray generation (camera.rs:57-64 + the per-sample jitter
and y-flip of camera.rs:97-99 / photon_mapper.rs:191-193).

Pure function of (camera params, pixel ids, rng key) — the reference's
``get_ray`` called in a pixel loop becomes one vectorized call per sample
batch."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer.ops import sampling
from raytracer.scene.types import Camera


def camera_rays(cam: Camera, key, pixel_ids, width: int, height: int):
    """Generate one jittered primary ray per entry of ``pixel_ids``.

    pixel_ids: (N,) int32 flat ids (y * width + x). Returns (o, d) each (N,3).
    Matches: u = (x + U)/ (w-1), v = (y + U)/(h-1), ray = get_ray(u, 1-v)
    (camera.rs:97-99), thin-lens offset via lens-disk sample (camera.rs:57-64).
    """
    k_jx, k_jy, k_lens = jax.random.split(key, 3)
    n = pixel_ids.shape[0]
    x = (pixel_ids % width).astype(jnp.float32)
    y = (pixel_ids // width).astype(jnp.float32)
    u = (x + jax.random.uniform(k_jx, (n,))) / (width - 1)
    v = (y + jax.random.uniform(k_jy, (n,))) / (height - 1)
    s = u
    t = 1.0 - v  # y axis is reverted (camera.rs:99)

    rd = cam.lens_radius * sampling.uniform_disk(k_lens, (n,))
    offset = cam.u[None] * rd[:, :1] + cam.v[None] * rd[:, 1:2]
    origin = cam.origin[None] + offset
    direction = (cam.lower_left_corner[None]
                 + s[:, None] * cam.horizontal[None]
                 + t[:, None] * cam.vertical[None]
                 - cam.origin[None] - offset)
    return origin, direction
