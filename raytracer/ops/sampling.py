"""Closed-form, branch-free random sampling (replaces vec3.rs rejection loops).

The reference uses rejection sampling under ``thread_rng`` (vec3.rs:111-162).
In a batched wavefront, rejection loops are poison (data-dependent trip
counts under vmap),
so every sampler here is closed-form over threefry uniforms — identical
*distributions*, different (deterministic, counter-based) sample streams.

A subtle but load-bearing parity fact: the reference's
``random_in_unit_sphere`` (vec3.rs:111-138) maps a uniform point of the unit
*disk* through (2u√(1-r²), 2v√(1-r²), 1-2r²), which always has unit length —
i.e. it samples uniformly ON the sphere, not inside it. Every consumer
(Lambertian scatter material.rs:93, metal fuzz material.rs:132, hemisphere
emission light.rs:101,160) therefore sees uniform sphere-surface directions,
and :func:`uniform_sphere` reproduces exactly that distribution.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer.ops import vec

TWO_PI = 6.283185307179586


def uniform_sphere(key, shape=()):
    """Uniform direction on the unit sphere. Distribution-equivalent to
    vec3.rs:111-138 (see module docstring)."""
    k1, k2 = jax.random.split(key)
    z = 1.0 - 2.0 * jax.random.uniform(k1, shape)          # cos(theta) ~ U(-1,1)
    phi = TWO_PI * jax.random.uniform(k2, shape)
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_sphere_from(u1, u2):
    """uniform_sphere from two prepared uniforms (rows of a batched
    per-step draw; same z/phi construction). (N,) uniforms -> (N, 3)."""
    z = 1.0 - 2.0 * u1
    phi = TWO_PI * u2
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi), z], axis=-1)


def uniform_hemisphere(key, normal):
    """Uniform sphere dir flipped into the hemisphere around ``normal``.
    vec3.rs:144-151."""
    d = uniform_sphere(key, normal.shape[:-1])
    sign = jnp.where(vec.dot(d, normal) > 0.0, 1.0, -1.0)
    return d * sign[..., None]


def uniform_disk(key, shape=()):
    """Uniform point in the unit disk (closed-form polar; same distribution
    as the rejection loop at vec3.rs:153-162). Returns (..., 2)."""
    k1, k2 = jax.random.split(key)
    r = jnp.sqrt(jax.random.uniform(k1, shape))
    phi = TWO_PI * jax.random.uniform(k2, shape)
    return jnp.stack([r * jnp.cos(phi), r * jnp.sin(phi)], axis=-1)


def lambertian_dir(key, normal):
    """``normal + random_unit_vector`` with the near-zero fallback to the
    normal itself. material.rs:92-98. Returns an (unnormalized) direction,
    matching the reference, which never unitizes scatter directions."""
    d = normal + uniform_sphere(key, normal.shape[:-1])
    return jnp.where(vec.near_zero(d)[..., None], normal, d)


def cosine_hemisphere(key, normal):
    """Cosine-weighted hemisphere direction (normalized lambertian_dir).
    Used by importance-sampling paths; same angular distribution as
    ``normal + unit_sphere`` which is cosine-weighted."""
    return vec.unit(lambertian_dir(key, normal))
