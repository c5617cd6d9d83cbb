"""Closest-hit kernel for NVIDIA GPUs: a Pallas kernel on the Triton route.

Each program owns a block of BLOCK rays, held in registers, and walks every
primitive table in chunks of CHUNK primitives. Before a chunk's tests run,
the block slab-tests the chunk's bounding box against each ray's segment
[t_min, min(best_t, t_max)]; a chunk that no ray of the block can reach is
skipped. Spheres and triangles are packed in Morton order, so chunks are
spatially compact and the cull skips most of a large table. That is work
the XLA brute force (ops/intersect.py) cannot skip.

The kernel returns only (t, prim_type, prim_idx); ops/closest_hit.py gathers
the winner's attributes in XLA. All arithmetic is f32 with no tensor-core
product, so t matches the XLA reference up to the order of operations.

Tables are (rows, n_pad) component rows, n_pad a multiple of CHUNK:
- spheres: cx, cy, cz, r^2 [, vx, vy, vz on moving-sphere scenes]
  (padding: r^2 = -BIG, so the discriminant is negative);
- rects: n one-hot (3), a one-hot (3), b one-hot (3), k, a0, a1, b0, b1
  (padding: a0 > a1);
- tris: n_geo, e1, e2, e2 x v0, e1 x v0 (3 rows each), v0 . n_geo
  (padding: zeros, so the determinant is 0).
Each table comes with a (6, n_chunks) box table [lo xyz; hi xyz]. Boxes of
moving spheres cover the whole camera shutter.

The kernel has no CPU lowering. Off a GPU it runs only with
``interpret=True``, which the tests pass explicitly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytracer.ops.intersect import Hit
from raytracer.scene.types import (
    PRIM_RECT, PRIM_SPHERE, PRIM_TRIANGLE, Scene,
)

# one warp per program, one ray per thread: the fastest setting of the
# sweep in PERF.md on every scene timed (H100)
BLOCK = 32       # rays per program
CHUNK = 32       # primitives per culled chunk
NUM_WARPS = 1
NUM_STAGES = 1
BIG = 3.0e38     # python float: a jnp scalar would be a captured constant
SPH_VEL_ROW = 4  # first velocity row of a moving-sphere table


class Tables(NamedTuple):
    """Packed tables; None where the scene has no primitive of that type.
    ``*_order`` maps a packed column back to the scene's primitive index."""
    sph: object
    sph_box: object
    sph_order: object
    rect: object
    rect_box: object
    tri: object
    tri_box: object
    tri_order: object


# ----------------------------------------------------------- table packing

def _morton_order(centers):
    """Z-order permutation, so consecutive chunks are spatially compact."""
    lo = centers.min(0)
    hi = centers.max(0)
    q = jnp.clip(((centers - lo) / jnp.maximum(hi - lo, 1e-9) * 1023.0)
                 .astype(jnp.uint32), 0, 1023)

    def spread(x):
        x = (x | (x << 16)) & 0x030000FF
        x = (x | (x << 8)) & 0x0300F00F
        x = (x | (x << 4)) & 0x030C30C3
        x = (x | (x << 2)) & 0x09249249
        return x

    code = (spread(q[:, 0]) << 2) | (spread(q[:, 1]) << 1) | spread(q[:, 2])
    return jnp.argsort(code)


def _pad_cols(a, fill):
    c = a.shape[1]
    cp = -(-c // CHUNK) * CHUNK
    return jnp.pad(a, [(0, 0), (0, cp - c)], constant_values=fill)


def _chunk_boxes(lo, hi):
    """(6, n_chunks) boxes from per-primitive (3, n) corners. Boxes grow by
    a relative 1e-5 so that rounding in the slab test never culls a chunk
    whose exact test would hit."""
    eps = 1e-5 * jnp.maximum(jnp.abs(lo), jnp.abs(hi)) + 1e-6
    lo = _pad_cols(lo - eps, BIG)
    hi = _pad_cols(hi + eps, -BIG)
    k = lo.shape[1] // CHUNK
    return jnp.concatenate([lo.reshape(3, k, CHUNK).min(2),
                            hi.reshape(3, k, CHUNK).max(2)], 0)


def _pack_spheres(scene: Scene, motion: bool):
    s = scene.spheres
    n = s.radius.shape[0]
    order = _morton_order(s.center.astype(jnp.float32))
    c = s.center[order].T.astype(jnp.float32)
    r = s.radius[order].astype(jnp.float32)
    rows = [c, (r * r)[None]]
    lo = c - jnp.abs(r)
    hi = c + jnp.abs(r)
    if motion:
        v = s.velocity[order].T.astype(jnp.float32)
        t0 = jnp.asarray(scene.camera.time0, jnp.float32)
        t1 = jnp.asarray(scene.camera.time1, jnp.float32)
        rows.append(v)
        lo = lo + jnp.minimum(v * t0, v * t1)
        hi = hi + jnp.maximum(v * t0, v * t1)
    tab = _pad_cols(jnp.concatenate(rows, 0), 0.0).at[3, n:].set(-BIG)
    return tab, _chunk_boxes(lo, hi), order


def _pack_rects(scene: Scene):
    rc = scene.rects
    n = rc.k.shape[0]
    eye = jnp.eye(3, dtype=jnp.float32)
    n_hot = eye[rc.axis].T
    a_hot = eye[jnp.where(rc.axis == 0, 1, 0)].T
    b_hot = eye[jnp.where(rc.axis == 2, 1, 2)].T
    k, a0, a1, b0, b1 = (x.astype(jnp.float32)[None]
                         for x in (rc.k, rc.a0, rc.a1, rc.b0, rc.b1))
    tab = jnp.concatenate([n_hot, a_hot, b_hot, k, a0, a1, b0, b1], 0)
    tab = _pad_cols(tab, 0.0).at[10, n:].set(1.0).at[11, n:].set(-1.0)
    lo = n_hot * k + a_hot * a0 + b_hot * b0
    hi = n_hot * k + a_hot * a1 + b_hot * b1
    return tab, _chunk_boxes(jnp.minimum(lo, hi), jnp.maximum(lo, hi))


def _pack_tris(scene: Scene):
    tr = scene.triangles
    order = _morton_order((tr.v0 + (tr.e1 + tr.e2) / 3.0).astype(jnp.float32))
    v0 = tr.v0[order].astype(jnp.float32)
    e1 = tr.e1[order].astype(jnp.float32)
    e2 = tr.e2[order].astype(jnp.float32)
    n_geo = jnp.cross(e1, e2)
    tab = jnp.concatenate([
        n_geo.T, e1.T, e2.T, jnp.cross(e2, v0).T, jnp.cross(e1, v0).T,
        jnp.sum(v0 * n_geo, -1)[None]], 0)
    lo = jnp.minimum(jnp.minimum(v0, v0 + e1), v0 + e2).T
    hi = jnp.maximum(jnp.maximum(v0, v0 + e1), v0 + e2).T
    return _pad_cols(tab, 0.0), _chunk_boxes(lo, hi), order


def pack_tables(scene: Scene, motion: bool = False) -> Tables:
    """Pack the scene's primitive tables for the kernel (traceable: every
    shape is static)."""
    sph = rect = tri = (None, None, None)
    if scene.spheres.radius.shape[0]:
        sph = _pack_spheres(scene, motion)
    if scene.rects.k.shape[0]:
        rect = _pack_rects(scene) + (None,)
    if scene.triangles.mat_id.shape[0]:
        tri = _pack_tris(scene)
    return Tables(*sph, *rect[:2], *tri)


# ----------------------------------------------------------------- kernel

class _Rays(NamedTuple):
    """One block's rays, each component a (BLOCK, 1) column, with the
    per-ray terms every chunk reuses."""
    ox: object
    oy: object
    oz: object
    dx: object
    dy: object
    dz: object
    tmin: object
    tmax: object
    time: object
    a: object        # d . d
    inv_a: object
    inv_d: tuple     # 1 / d per axis (1e30 where d is ~0)


def _cols(ref, j0, rows):
    """(1, CHUNK) rows ``rows`` of table columns [j0, j0 + CHUNK)."""
    return [ref[r, pl.ds(j0, CHUNK)][None, :] for r in rows]


def _in_range(t, r: _Rays):
    return (t >= r.tmin) & (t <= r.tmax)


def _sphere_t(r: _Rays, tab, j0):
    """sphere.rs:24-55 in the direct oc = o - c form of intersect.sphere_ts
    (the expanded |o|^2 - 2 o.c + |c|^2 form cancels at large
    coordinates)."""
    cx, cy, cz, rsq = _cols(tab, j0, range(4))
    ocx, ocy, ocz = r.ox - cx, r.oy - cy, r.oz - cz
    if r.time is not None:
        # center(t) = c + v t, subtracted in intersect.sphere_ts's order
        vx, vy, vz = _cols(tab, j0, range(SPH_VEL_ROW, SPH_VEL_ROW + 3))
        ocx, ocy, ocz = (ocx - r.time * vx, ocy - r.time * vy,
                         ocz - r.time * vz)
    half_b = r.dx * ocx + r.dy * ocy + r.dz * ocz
    # the perpendicular-offset discriminant of intersect.sphere_ts
    k = half_b * r.inv_a
    lx, ly, lz = ocx - k * r.dx, ocy - k * r.dy, ocz - k * r.dz
    disc = r.a * (rsq - (lx * lx + ly * ly + lz * lz))
    sq = jnp.sqrt(jnp.maximum(disc, 0.0))
    r1 = (-half_b - sq) * r.inv_a
    r2 = (-half_b + sq) * r.inv_a
    t = jnp.where(_in_range(r1, r), r1, jnp.where(_in_range(r2, r), r2, BIG))
    return jnp.where(disc >= 0.0, t, BIG)


def _rect_t(r: _Rays, tab, j0):
    """rectangle.rs plane solve + bounds test (intersect.rect_ts)."""
    (nx, ny, nz, ax, ay, az, bx, by, bz,
     k, a0, a1, b0, b1) = _cols(tab, j0, range(14))
    d_n = r.dx * nx + r.dy * ny + r.dz * nz
    o_n = r.ox * nx + r.oy * ny + r.oz * nz
    safe = jnp.abs(d_n) > 1e-12
    t = (k - o_n) / jnp.where(safe, d_n, 1.0)
    pa = (r.ox * ax + r.oy * ay + r.oz * az) + t * (r.dx * ax + r.dy * ay
                                                     + r.dz * az)
    pb = (r.ox * bx + r.oy * by + r.oz * bz) + t * (r.dx * bx + r.dy * by
                                                     + r.dz * bz)
    ok = (safe & (pa >= a0) & (pa <= a1) & (pb >= b0) & (pb <= b1)
          & _in_range(t, r))
    return jnp.where(ok, t, BIG)


def _tri_t(r: _Rays, tab, j0):
    """mesh.rs:57-98 Möller–Trumbore in the scalar-triple-product form of
    intersect.triangle_ts."""
    (ngx, ngy, ngz, e1x, e1y, e1z, e2x, e2y, e2z,
     w2x, w2y, w2z, w1x, w1y, w1z, v0n) = _cols(tab, j0, range(16))
    oxd_x = r.oy * r.dz - r.oz * r.dy
    oxd_y = r.oz * r.dx - r.ox * r.dz
    oxd_z = r.ox * r.dy - r.oy * r.dx
    div = -(r.dx * ngx + r.dy * ngy + r.dz * ngz)
    safe = div != 0.0
    inv = 1.0 / jnp.where(safe, div, 1.0)
    b1 = ((oxd_x * e2x + oxd_y * e2y + oxd_z * e2z)
          - (r.dx * w2x + r.dy * w2y + r.dz * w2z)) * inv
    b2 = (-(oxd_x * e1x + oxd_y * e1y + oxd_z * e1z)
          + (r.dx * w1x + r.dy * w1y + r.dz * w1z)) * inv
    t = ((r.ox * ngx + r.oy * ngy + r.oz * ngz) - v0n) * inv
    ok = (safe & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
          & _in_range(t, r))
    return jnp.where(ok, t, BIG)


def _block_reaches(r: _Rays, box, j, best_t):
    """True if any ray's segment [t_min, min(best_t, t_max)] enters box j."""
    inv = r.inv_d
    org = (r.ox, r.oy, r.oz)
    enter = r.tmin
    leave = jnp.minimum(best_t, r.tmax)
    for ax in range(3):
        t0 = (box[ax, j] - org[ax]) * inv[ax]
        t1 = (box[ax + 3, j] - org[ax]) * inv[ax]
        enter = jnp.maximum(enter, jnp.minimum(t0, t1))
        leave = jnp.minimum(leave, jnp.maximum(t0, t1))
    # Triton has no boolean any-reduction: reduce a 0/1 float instead
    return jnp.max(jnp.where(enter <= leave, 1.0, 0.0)) > 0.0


def _stage(carry, r: _Rays, tab, box, n_chunks: int, test, code: int):
    """Fold one table's chunks into the running (best_t, type, index)."""

    def chunk(j, carry):
        def run(carry):
            best_t, best_ty, best_ix = carry
            j0 = pl.multiple_of(j * CHUNK, CHUNK)
            t = test(r, tab, j0)                          # (BLOCK, CHUNK)
            m = jnp.min(t, axis=1)
            col = jax.lax.broadcasted_iota(jnp.int32, t.shape, 1)
            arg = jnp.min(jnp.where(t <= m[:, None], col, CHUNK), axis=1)
            better = m < best_t
            return (jnp.where(better, m, best_t),
                    jnp.where(better, code, best_ty),
                    jnp.where(better, arg + j0, best_ix))

        return jax.lax.cond(_block_reaches(r, box, j, carry[0][:, None]),
                            run, lambda c: c, carry)

    return jax.lax.fori_loop(0, n_chunks, chunk, carry)


def _kernel(*refs, n_sph: int, n_rect: int, n_tri: int, motion: bool):
    refs = list(refs)
    ray = [refs.pop(0)[...][:, None] for _ in range(8)]
    time = refs.pop(0)[...][:, None] if motion else None
    dx, dy, dz = ray[3:6]
    a = dx * dx + dy * dy + dz * dz
    r = _Rays(*ray, time, a, 1.0 / a,
              tuple(jnp.where(jnp.abs(c) > 1e-30, 1.0 / c, 1e30)
                    for c in (dx, dy, dz)))
    # running winner per ray, as (BLOCK,) vectors
    carry = (jnp.full((BLOCK,), BIG, jnp.float32),
             jnp.full((BLOCK,), -1, jnp.int32),
             jnp.full((BLOCK,), -1, jnp.int32))
    for n_ch, test, code in ((n_sph, _sphere_t, PRIM_SPHERE),
                             (n_rect, _rect_t, PRIM_RECT),
                             (n_tri, _tri_t, PRIM_TRIANGLE)):
        if n_ch:
            tab, box = refs.pop(0), refs.pop(0)
            carry = _stage(carry, r, tab, box, n_ch, test, code)
    t_out, ty_out, ix_out = refs
    best_t, best_ty, best_ix = carry
    t_out[...] = best_t
    ty_out[...] = best_ty
    ix_out[...] = best_ix


def intersect_pallas(scene: Scene, o, d, t_min, t_max, alive=None,
                     time=None, *, interpret: bool = False) -> Hit:
    """Closest hit via the kernel. ``alive`` (N,) bool marks lanes whose
    result is not needed (they do no work and report a miss). ``time``
    (N,) enables motion blur on moving-sphere scenes (c + v*t).
    ``interpret=True`` runs the kernel in the Pallas interpreter: tests
    only. Without it the kernel lowers for the GPU alone."""
    n = o.shape[0]
    motion = bool(scene.spheres.motion_marker.shape[0]) and time is not None
    tabs = pack_tables(scene, motion)
    n_pad = -(-n // BLOCK) * BLOCK
    pad = n_pad - n
    tmin = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), (n,))
    tmax = jnp.broadcast_to(
        jnp.minimum(jnp.asarray(t_max, jnp.float32), BIG), (n,))
    if alive is not None:
        tmax = jnp.where(alive, tmax, -BIG)   # dead lanes reach nothing
    cols = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], tmin,
            tmax]
    if motion:
        cols.append(jnp.broadcast_to(jnp.asarray(time, jnp.float32), (n,)))
    cols = [jnp.pad(c.astype(jnp.float32), (0, pad)) for c in cols]
    cols[7] = cols[7].at[n:].set(-BIG)            # padding lanes are dead

    tables = []
    counts = {}
    for name, tab, box in (("n_sph", tabs.sph, tabs.sph_box),
                           ("n_rect", tabs.rect, tabs.rect_box),
                           ("n_tri", tabs.tri, tabs.tri_box)):
        counts[name] = 0 if tab is None else box.shape[1]
        if tab is not None:
            tables += [tab, box]

    row = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = [pl.BlockSpec(a.shape, lambda i: (0, 0)) for a in tables]
    kernel = functools.partial(_kernel, motion=motion, **counts)
    t, ty, ix = pl.pallas_call(
        kernel,
        grid=(n_pad // BLOCK,),
        in_specs=[row] * len(cols) + whole,
        out_specs=[row] * 3,
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32),
                   jax.ShapeDtypeStruct((n_pad,), jnp.int32)],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=NUM_STAGES),
        interpret=interpret,
        name="closest_hit",
    )(*cols, *tables)
    t, ty, ix = t[:n], ty[:n], ix[:n]
    # packed column -> scene primitive index (spheres and tris are Morton
    # ordered; rects keep their order)
    for code, order in ((PRIM_SPHERE, tabs.sph_order),
                        (PRIM_TRIANGLE, tabs.tri_order)):
        if order is not None:
            orig = order[jnp.clip(ix, 0, order.shape[0] - 1)]
            ix = jnp.where(ty == code, orig.astype(jnp.int32), ix)
    return Hit(jnp.where(ty < 0, jnp.inf, t), ty, ix)
