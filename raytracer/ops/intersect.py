"""Batched ray–primitive intersection (replaces hit.rs/sphere.rs/
rectangle.rs/mesh.rs virtual-dispatch ``hit`` methods).

Design: the reference resolves the closest hit by walking an object tree
with per-object early returns (hit.rs:56-67 shrinks ``closest_so_far``).
Here the closest hit is a *reduction*: each primitive type has a function
that produces hit distances for a (rays × prim-chunk) tile, and a
``lax.scan`` over primitive chunks carries the running (best_t, best_idx).
Every (N, C) quantity is an elementwise broadcast, so XLA fuses a chunk's
tests with its min-reduction instead of materializing a (N_rays × N_prims)
matrix; every op is branch-free (misses are +inf). This is the plain XLA
closest hit: the CPU path, the reference, and the baseline the GPU kernel
(ops/pallas_intersect.py) is timed against.

All kernels take rays as SoA: ``o`` (N,3) origins, ``d`` (N,3) directions
(NOT normalized — the reference never normalizes ray dirs, and sphere/rect
math is exact for any scale). ``t_min``/``t_max`` broadcast as scalars or (N,).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer.ops import vec
from raytracer.scene.types import (
    PRIM_RECT, PRIM_SPHERE, PRIM_TRIANGLE, Rects, Scene, Spheres, Triangles,
)

INF = jnp.float32(jnp.inf)
PI = 3.141592653589793


class Hit(NamedTuple):
    """Winner of the closest-hit reduction (ids, not pointers)."""
    t: jnp.ndarray          # (N,) +inf on miss
    prim_type: jnp.ndarray  # (N,) int32, -1 on miss
    prim_idx: jnp.ndarray   # (N,) int32 index into the per-type table


class HitAttrs(NamedTuple):
    """The reference's HitRecord (hit.rs:7-14) as SoA, material by id."""
    valid: jnp.ndarray       # (N,) bool
    t: jnp.ndarray           # (N,)
    p: jnp.ndarray           # (N, 3)
    normal: jnp.ndarray      # (N, 3) unit, flipped against the ray
    front_face: jnp.ndarray  # (N,) bool
    uv: jnp.ndarray          # (N, 2)
    mat_id: jnp.ndarray      # (N,) int32


def _in_range(t, t_min, t_max):
    return (t >= t_min) & (t <= t_max)


def _dot_rows(x, h):
    """(N, C) dot products of (N, 3) rays with (C, 3) table rows, as a
    broadcast that XLA fuses (a K=3 matmul would go to a GEMM library and
    write every (N, C) product to memory)."""
    return (x[:, 0:1] * h[None, :, 0] + x[:, 1:2] * h[None, :, 1]
            + x[:, 2:3] * h[None, :, 2])


def _pad_chunk(arr, chunk, pad_value):
    n = arr.shape[0]
    k = -(-n // chunk)
    pad = k * chunk - n
    if pad:
        widths = [(0, pad)] + [(0, 0)] * (arr.ndim - 1)
        arr = jnp.pad(arr, widths, constant_values=pad_value)
    return arr.reshape((k, chunk) + arr.shape[1:])


def _chunk_scan(tile_fn, tables, n_prims, o, chunk):
    """Scan ``tile_fn(chunked_tables, base) -> (N, C) t-matrix`` over chunks,
    reducing to per-ray (best_t, best_global_idx)."""
    n_rays = o.shape[0]
    k = -(-n_prims // chunk)
    bases = jnp.arange(k, dtype=jnp.int32) * chunk

    def body(carry, xs):
        best_t, best_i = carry
        tabs, base = xs
        ts = tile_fn(tabs)                                  # (N, C)
        ci = jnp.argmin(ts, axis=1)                          # (N,)
        ct = jnp.take_along_axis(ts, ci[:, None], axis=1)[:, 0]
        better = ct < best_t
        best_t = jnp.where(better, ct, best_t)
        best_i = jnp.where(better, base + ci.astype(jnp.int32), best_i)
        return (best_t, best_i), None

    init = (jnp.full((n_rays,), INF), jnp.full((n_rays,), -1, jnp.int32))
    if k == 1:
        (bt, bi), _ = body(init, (jax.tree_util.tree_map(lambda a: a[0], tables), bases[0]))
        return bt, bi
    (bt, bi), _ = jax.lax.scan(body, init, (tables, bases))
    return bt, bi


# ---------------------------------------------------------------- spheres

def sphere_ts(o, d, center, radius, valid, t_min, t_max,
              velocity=None, time=None):
    """Quadratic sphere hit, half-b form, nearest-root-in-range
    (sphere.rs:24-55). Returns (N, C) distances, +inf on miss.

    Direct oc = o - center(t) formulation: the expanded
    |o|^2 - 2 o.c + |c|^2 - r^2 form cancels catastrophically at |o| ~ 1e3
    coordinates (grazing phantom hits/misses on the 64k sphere field that
    an f64 oracle rejects).
    """
    a = vec.dot(d, d)[:, None]                        # (N, 1)
    ocx = o[:, 0:1] - center[None, :, 0]              # (N, C)
    ocy = o[:, 1:2] - center[None, :, 1]
    ocz = o[:, 2:3] - center[None, :, 2]
    if velocity is not None and time is not None:
        # motion blur: center(t) = c + v*t, subtracted directly
        tcol = time[:, None]
        ocx = ocx - tcol * velocity[None, :, 0]
        ocy = ocy - tcol * velocity[None, :, 1]
        ocz = ocz - tcol * velocity[None, :, 2]
    half_b = d[:, 0:1] * ocx + d[:, 1:2] * ocy + d[:, 2:3] * ocz
    inv_a = 1.0 / a
    # disc = half_b^2 - a (|oc|^2 - r^2), evaluated as a (r^2 - |l|^2) with
    # l = oc - (half_b / a) d, the ray's perpendicular offset from the
    # center: the direct difference cancels catastrophically for grazing
    # rays from far away, the perpendicular form does not
    k = half_b * inv_a
    lx = ocx - k * d[:, 0:1]
    ly = ocy - k * d[:, 1:2]
    lz = ocz - k * d[:, 2:3]
    disc = a * ((radius * radius)[None] - (lx * lx + ly * ly + lz * lz))
    sqrt_d = jnp.sqrt(jnp.maximum(disc, 0.0))
    r1 = (-half_b - sqrt_d) * inv_a
    r2 = (-half_b + sqrt_d) * inv_a
    tmin = jnp.asarray(t_min)[..., None] if jnp.ndim(t_min) else t_min
    tmax = jnp.asarray(t_max)[..., None] if jnp.ndim(t_max) else t_max
    ok1 = _in_range(r1, tmin, tmax)
    ok2 = _in_range(r2, tmin, tmax)
    t = jnp.where(ok1, r1, jnp.where(ok2, r2, INF))
    return jnp.where((disc >= 0.0) & valid[None], t, INF)


def sphere_closest(o, d, spheres: Spheres, t_min, t_max, chunk=512,
                   time=None):
    n = spheres.radius.shape[0]
    moving = spheres.motion_marker.shape[0] and time is not None
    tables = (
        _pad_chunk(spheres.center, chunk, 0.0),
        _pad_chunk(spheres.radius, chunk, 0.0),
        _pad_chunk(spheres.mat_id >= 0, chunk, False),
        _pad_chunk(spheres.velocity if moving else spheres.center[:, :0],
                   chunk, 0.0),
    )
    return _chunk_scan(
        lambda tabs: sphere_ts(o, d, tabs[0], tabs[1], tabs[2], t_min, t_max,
                               velocity=tabs[3] if moving else None,
                               time=time if moving else None),
        tables, n, o, chunk)


# ------------------------------------------------------------------ rects

def rect_ts(o, d, axis, k, a0, a1, b0, b1, valid, t_min, t_max):
    """Axis-rect plane solve + bounds test (rectangle.rs:15-34,53-72,90-109).
    ``axis`` is the plane-normal axis; in-plane axes are the other two in
    ascending order."""
    eye = jnp.eye(3, dtype=o.dtype)
    n_hot = eye[axis]                                  # (C, 3)
    ax_a = jnp.where(axis == 0, 1, 0)                  # first in-plane axis
    ax_b = jnp.where(axis == 2, 1, 2)                  # second in-plane axis
    a_hot = eye[ax_a]
    b_hot = eye[ax_b]

    # The hit point is never materialized as (N,C,3):
    # pa = o.a_hot + t * d.a_hot.
    d_n = _dot_rows(d, n_hot)
    o_n = _dot_rows(o, n_hot)
    safe = jnp.abs(d_n) > 1e-12
    t = (k[None] - o_n) / jnp.where(safe, d_n, 1.0)
    pa = _dot_rows(o, a_hot) + t * _dot_rows(d, a_hot)
    pb = _dot_rows(o, b_hot) + t * _dot_rows(d, b_hot)
    inb = (pa >= a0[None]) & (pa <= a1[None]) & (pb >= b0[None]) & (pb <= b1[None])
    tmin = jnp.asarray(t_min)[..., None] if jnp.ndim(t_min) else t_min
    tmax = jnp.asarray(t_max)[..., None] if jnp.ndim(t_max) else t_max
    ok = safe & inb & _in_range(t, tmin, tmax) & valid[None]
    return jnp.where(ok, t, INF)


def rect_closest(o, d, rects: Rects, t_min, t_max, chunk=512):
    n = rects.k.shape[0]
    tables = tuple(
        _pad_chunk(x, chunk, pad) for x, pad in (
            (rects.axis, 0), (rects.k, 0.0), (rects.a0, 0.0), (rects.a1, 0.0),
            (rects.b0, 0.0), (rects.b1, 0.0), (rects.mat_id >= 0, False)))
    return _chunk_scan(
        lambda t_: rect_ts(o, d, *t_[:6], t_[6], t_min, t_max),
        tables, n, o, chunk)


# -------------------------------------------------------------- triangles

def triangle_ts(o, d, v0, e1, e2, valid, t_min, t_max):
    """Möller–Trumbore with the reference's bound checks (mesh.rs:57-98):
    b1 in [0,1]; b2 >= 0 and b1+b2 <= 1; t in range; div == 0 -> miss.

    Each MT dot product is a scalar triple product, so with per-triangle
    precomputed cross products the whole test becomes five (N,3).(C,3)
    row products + an (N,C) elementwise chain (no (N,C,3) intermediates):
        div   = (d x e2).e1          = d.(e2 x e1)
        b1*div = ((o-v0) x d).e2     = (o x d).e2 - d.(e2 x v0)
        b2*div = d.((o-v0) x e1)     = -(o x d).e1 + d.(e1 x v0)
        t*div  = (o-v0).(e1 x e2)    = o.n - v0.n,   n = e1 x e2
    """
    n_geo = jnp.cross(e1, e2)                          # (C, 3)
    e2xv0 = jnp.cross(e2, v0)                          # (C, 3)
    e1xv0 = jnp.cross(e1, v0)                          # (C, 3)
    v0_n = jnp.sum(v0 * n_geo, axis=-1)                # (C,)
    oxd = jnp.cross(o, d)                              # (N, 3)

    div = -_dot_rows(d, n_geo)                         # d.(e2 x e1) = -d.n
    safe = div != 0.0
    inv = 1.0 / jnp.where(safe, div, 1.0)
    b1 = (_dot_rows(oxd, e2) - _dot_rows(d, e2xv0)) * inv
    b2 = (-_dot_rows(oxd, e1) + _dot_rows(d, e1xv0)) * inv
    t = (_dot_rows(o, n_geo) - v0_n[None]) * inv
    tmin = jnp.asarray(t_min)[..., None] if jnp.ndim(t_min) else t_min
    tmax = jnp.asarray(t_max)[..., None] if jnp.ndim(t_max) else t_max
    ok = (safe & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
          & _in_range(t, tmin, tmax) & valid[None])
    return jnp.where(ok, t, INF)


def triangle_closest(o, d, tris: Triangles, t_min, t_max, chunk=128):
    n = tris.mat_id.shape[0]
    tables = (
        _pad_chunk(tris.v0, chunk, 0.0),
        _pad_chunk(tris.e1, chunk, 0.0),
        _pad_chunk(tris.e2, chunk, 0.0),
        _pad_chunk(tris.mat_id >= 0, chunk, False),
    )
    return _chunk_scan(
        lambda t_: triangle_ts(o, d, t_[0], t_[1], t_[2], t_[3], t_min, t_max),
        tables, n, o, chunk)


# ------------------------------------------------------------------ AABB

def aabb_hit(o, inv_d, bmin, bmax, t_min, t_max):
    """Slab test (aabb.rs:15-32). Broadcasts rays against boxes; returns
    (hit_mask, t_enter). Matches the reference's strict ``max <= min`` miss."""
    t0 = (bmin - o) * inv_d
    t1 = (bmax - o) * inv_d
    lo = jnp.minimum(t0, t1)
    hi = jnp.maximum(t0, t1)
    enter = jnp.maximum(jnp.max(lo, axis=-1), t_min)
    leave = jnp.minimum(jnp.min(hi, axis=-1), t_max)
    return leave > enter, enter


# ------------------------------------------------- unified closest hit

def intersect_bruteforce(scene: Scene, o, d, t_min, t_max,
                         time=None) -> Hit:
    """Closest hit over all primitive tables by linear reduction (the
    semantics of hit.rs:56-67 without the tree)."""
    best_t = jnp.full(o.shape[:1], INF)
    best_type = jnp.full(o.shape[:1], -1, jnp.int32)
    best_idx = jnp.full(o.shape[:1], -1, jnp.int32)

    def consider(t, i, code):
        nonlocal best_t, best_type, best_idx
        better = t < best_t
        best_t = jnp.where(better, t, best_t)
        best_type = jnp.where(better, code, best_type)
        best_idx = jnp.where(better, i, best_idx)

    if scene.spheres.radius.shape[0]:
        consider(*sphere_closest(o, d, scene.spheres, t_min, t_max, time=time),
                 PRIM_SPHERE)
    if scene.rects.k.shape[0]:
        consider(*rect_closest(o, d, scene.rects, t_min, t_max), PRIM_RECT)
    if scene.triangles.mat_id.shape[0]:
        consider(*triangle_closest(o, d, scene.triangles, t_min, t_max), PRIM_TRIANGLE)
    return Hit(best_t, best_type, best_idx)


# ------------------------------------------------------- hit attributes

def sphere_uv(n_out):
    """Spherical UV from the outward unit normal (sphere.rs:16-21)."""
    theta = jnp.arccos(jnp.clip(-n_out[..., 1], -1.0, 1.0))
    phi = jnp.arctan2(-n_out[..., 2], n_out[..., 0]) + PI
    return jnp.stack([phi / (2.0 * PI), theta / PI], axis=-1)


def hit_attributes(scene: Scene, o, d, hit: Hit, time=None) -> HitAttrs:
    """Compute the HitRecord fields for the winning primitive of each ray
    (hit.rs:24-30 front-face logic; per-type normal/uv math)."""
    n = o.shape[0]
    valid = jnp.isfinite(hit.t)
    t = jnp.where(valid, hit.t, 0.0)
    p = o + t[:, None] * d

    n_out = jnp.zeros((n, 3), o.dtype)
    uv = jnp.zeros((n, 2), o.dtype)
    mat_id = jnp.zeros((n,), jnp.int32)

    if scene.spheres.radius.shape[0]:
        i = jnp.clip(hit.prim_idx, 0, scene.spheres.radius.shape[0] - 1)
        c = scene.spheres.center[i]
        if scene.spheres.motion_marker.shape[0] and time is not None:
            c = c + scene.spheres.velocity[i] * time[:, None]
        r = scene.spheres.radius[i]
        no = (p - c) / r[:, None]
        sel = hit.prim_type == PRIM_SPHERE
        n_out = jnp.where(sel[:, None], no, n_out)
        uv = jnp.where(sel[:, None], sphere_uv(no), uv)
        mat_id = jnp.where(sel, scene.spheres.mat_id[i], mat_id)

    if scene.rects.k.shape[0]:
        i = jnp.clip(hit.prim_idx, 0, scene.rects.k.shape[0] - 1)
        axis = scene.rects.axis[i]
        eye = jnp.eye(3, dtype=o.dtype)
        no = eye[axis]
        ax_a = jnp.where(axis == 0, 1, 0)
        ax_b = jnp.where(axis == 2, 1, 2)
        pa = jnp.take_along_axis(p, ax_a[:, None], axis=1)[:, 0]
        pb = jnp.take_along_axis(p, ax_b[:, None], axis=1)[:, 0]
        a0, a1 = scene.rects.a0[i], scene.rects.a1[i]
        b0, b1 = scene.rects.b0[i], scene.rects.b1[i]
        ruv = jnp.stack([(pa - a0) / (a1 - a0), (pb - b0) / (b1 - b0)], axis=-1)
        sel = hit.prim_type == PRIM_RECT
        n_out = jnp.where(sel[:, None], no, n_out)
        uv = jnp.where(sel[:, None], ruv, uv)
        mat_id = jnp.where(sel, scene.rects.mat_id[i], mat_id)

    if scene.triangles.mat_id.shape[0]:
        i = jnp.clip(hit.prim_idx, 0, scene.triangles.mat_id.shape[0] - 1)
        tr = scene.triangles
        v0, e1, e2 = tr.v0[i], tr.e1[i], tr.e2[i]
        # Recompute barycentrics for the single winning triangle (cheap; the
        # scan discards them). mesh.rs:69-104.
        s0 = jnp.cross(d, e2)
        div = jnp.sum(s0 * e1, axis=-1)
        inv = 1.0 / jnp.where(div != 0.0, div, 1.0)
        dv = o - v0
        b1 = jnp.sum(dv * s0, axis=-1) * inv
        s1 = jnp.cross(dv, e1)
        b2 = jnp.sum(d * s1, axis=-1) * inv
        b0 = 1.0 - b1 - b2
        no = vec.unit(b0[:, None] * tr.n0[i] + b1[:, None] * tr.n1[i]
                      + b2[:, None] * tr.n2[i])
        sel = hit.prim_type == PRIM_TRIANGLE
        n_out = jnp.where(sel[:, None], no, n_out)
        # UV hardcoded (0,0) — mesh.rs:130-136
        uv = jnp.where(sel[:, None], jnp.zeros_like(uv), uv)
        mat_id = jnp.where(sel, tr.mat_id[i], mat_id)

    front_face = vec.dot(d, n_out) < 0.0
    normal = vec.unit(jnp.where(front_face[:, None], n_out, -n_out))
    return HitAttrs(valid, hit.t, p, normal, front_face, uv, mat_id)
