"""Constant-density participating media (medium.rs:26-53).

The reference's ``ConstantMedium`` wraps an arbitrary boundary Hitable and,
inside ``hit``, performs a double boundary intersection plus an exponential
free-flight sample ``hit_distance = -1/density * ln(U)`` (medium.rs:37-49).
It is compiled but unused by the only scene; we ship it for capability
parity (SURVEY.md §2.12).

Design: media are a separate table with *analytic* sphere or box
boundaries (the only shapes the book ever wraps). After the deterministic
geometry hit, ``apply_media`` computes each medium's stochastic scattering
distance and overrides the hit when the medium event happens first — the
phase function is the Isotropic material (uniform sphere scatter,
material.rs:213-231). The dummy normal (1,0,0) of medium.rs:45 is kept.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer.ops import vec
from raytracer.ops.intersect import HitAttrs

MEDIUM_SPHERE = 0
MEDIUM_BOX = 1


class Media(NamedTuple):
    kind: jnp.ndarray             # (K,) int32
    p0: jnp.ndarray               # (K, 3) center / box min
    p1: jnp.ndarray               # (K, 3) unused / box max
    r0: jnp.ndarray               # (K,) radius / unused
    neg_inv_density: jnp.ndarray  # (K,) = -1/density (medium.rs:21)
    mat_id: jnp.ndarray           # (K,) isotropic phase material


def empty_media() -> Media:
    z3 = jnp.zeros((0, 3), jnp.float32)
    z = jnp.zeros((0,), jnp.float32)
    return Media(jnp.zeros((0,), jnp.int32), z3, z3, z, z,
                 jnp.zeros((0,), jnp.int32))


def _boundary_window(media: Media, o, d):
    """Entry/exit params (t_enter, t_exit) of each ray with each boundary.
    Shapes: o (N,3) -> (N,K)."""
    big = jnp.float32(3e38)
    # sphere roots
    oc = o[:, None, :] - media.p0[None]                 # (N,K,3) K is tiny
    a = vec.dot(d, d)[:, None]
    half_b = jnp.sum(oc * d[:, None, :], axis=-1)
    c = jnp.sum(oc * oc, axis=-1) - (media.r0 * media.r0)[None]
    disc = half_b * half_b - a * c
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    s_enter = (-half_b - sq) / a
    s_exit = (-half_b + sq) / a
    s_ok = disc > 0.0
    # box slabs
    inv_d = jnp.where(jnp.abs(d) > 1e-20, 1.0 / d, jnp.sign(d) * big + big)
    t0 = (media.p0[None] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (media.p1[None] - o[:, None, :]) * inv_d[:, None, :]
    b_enter = jnp.max(jnp.minimum(t0, t1), axis=-1)
    b_exit = jnp.min(jnp.maximum(t0, t1), axis=-1)
    b_ok = b_exit > b_enter

    is_sphere = (media.kind == MEDIUM_SPHERE)[None]
    enter = jnp.where(is_sphere, s_enter, b_enter)
    exit_ = jnp.where(is_sphere, s_exit, b_exit)
    ok = jnp.where(is_sphere, s_ok, b_ok)
    return enter, exit_, ok


def apply_media(media: Media, key, o, d, attrs: HitAttrs,
                t_min: float) -> HitAttrs:
    """Override the geometric hit wherever a medium scattering event occurs
    first (medium.rs:26-53 semantics, batched)."""
    if media.kind.shape[0] == 0:
        return attrs
    n = o.shape[0]
    k = media.kind.shape[0]
    enter, exit_, ok = _boundary_window(media, o, d)
    # clamp like the reference: rec1.t >= t_min, rec2.t <= geometric hit
    t_geom = jnp.where(attrs.valid, attrs.t, jnp.inf)[:, None]
    enter = jnp.maximum(enter, t_min)
    exit_ = jnp.minimum(exit_, t_geom)
    ok = ok & (exit_ > enter)

    d_len = jnp.sqrt(vec.dot(d, d))[:, None]
    dist_inside = (exit_ - enter) * d_len
    u = jax.random.uniform(key, (n, k), minval=1e-12, maxval=1.0)
    hit_dist = media.neg_inv_density[None] * jnp.log(u)   # medium.rs:41
    scatters = ok & (hit_dist < dist_inside)
    t_med = enter + hit_dist / jnp.maximum(d_len, 1e-20)
    t_med = jnp.where(scatters, t_med, jnp.inf)

    # nearest medium event per ray
    j = jnp.argmin(t_med, axis=1)
    t_best = jnp.take_along_axis(t_med, j[:, None], axis=1)[:, 0]
    use = jnp.isfinite(t_best)

    p = o + t_best[:, None] * d
    dummy_n = jnp.broadcast_to(jnp.array([1.0, 0.0, 0.0]), (n, 3))
    return HitAttrs(
        valid=attrs.valid | use,
        t=jnp.where(use, t_best, attrs.t),
        p=jnp.where(use[:, None], p, attrs.p),
        normal=jnp.where(use[:, None], dummy_n, attrs.normal),
        front_face=jnp.where(use, True, attrs.front_face),
        uv=jnp.where(use[:, None], 0.0, attrs.uv),
        mat_id=jnp.where(use, media.mat_id[j], attrs.mat_id),
    )


def apply_media_soa(scene, key, ox, oy, oz, dx, dy, dz, t, ty, data,
                    t_min: float):
    """Media override on the SoA winner rows — the wavefront fast path's
    twin of ``apply_media`` (medium.rs:26-53). Wherever a medium's
    exponential free-flight event precedes the geometric hit, the winner
    becomes a PRIM_MEDIA record whose feature slots carry the medium's
    isotropic material (attrs_soa then yields the dummy (1,0,0) normal of
    medium.rs:45 and uv=(0,0)). Draws the SAME (n, K) uniforms from the
    same fold-29 key as the AoS loop, so media events are stream-identical
    across the two implementations.

    Returns overridden (t, ty, data)."""
    from raytracer.scene.types import PRIM_MEDIA
    from raytracer.ops.closest_hit import N_GEO_SLOTS, feature_rows
    media: Media = scene.media
    n = ox.shape[0]
    k_m = media.kind.shape[0]
    o = jnp.stack([ox, oy, oz], -1)
    d = jnp.stack([dx, dy, dz], -1)
    enter, exit_, ok = _boundary_window(media, o, d)
    t_geom = jnp.where(jnp.isfinite(t), t, jnp.inf)[:, None]
    enter = jnp.maximum(enter, t_min)
    exit_ = jnp.minimum(exit_, t_geom)
    ok = ok & (exit_ > enter)

    d_len = jnp.sqrt(vec.dot(d, d))[:, None]
    dist_inside = (exit_ - enter) * d_len
    u = jax.random.uniform(key, (n, k_m), minval=1e-12, maxval=1.0)
    hit_dist = media.neg_inv_density[None] * jnp.log(u)   # medium.rs:41
    scatters = ok & (hit_dist < dist_inside)
    t_med = jnp.where(scatters, enter + hit_dist / jnp.maximum(d_len, 1e-20),
                      jnp.inf)
    j = jnp.argmin(t_med, axis=1)                         # nearest medium
    t_best = jnp.take_along_axis(t_med, j[:, None], axis=1)[:, 0]
    use = jnp.isfinite(t_best)   # t_med < exit_ <= t_geom by construction

    feat = feature_rows(scene, media.mat_id)             # (12, K)
    featsel = feat[:, j]                                  # (12, N)
    geo = jnp.zeros((N_GEO_SLOTS, n), data.dtype)
    t2 = jnp.where(use, t_best, t)
    ty2 = jnp.where(use, PRIM_MEDIA, ty)
    data2 = jnp.where(use[None], jnp.concatenate([geo, featsel], 0), data)
    return t2, ty2, data2
