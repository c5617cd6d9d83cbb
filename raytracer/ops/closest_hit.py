"""Closest hit plus winner data: the seam between intersection and the SoA
wavefront (models/wavefront_soa.py).

``closest_hit`` returns ``(t, prim_type, prim_idx, data)`` where ``data``
is an ``(N_SLOTS, N)`` block of component rows describing each ray's
winning primitive. The closest hit itself comes from whichever intersector
dispatch resolved (the GPU kernel in ops/pallas_intersect.py or the XLA
brute force in ops/intersect.py); the winner rows are always gathered here
in XLA from the scene tables by ``(prim_type, prim_idx)``. A gather per ray
is cheap on a GPU, so no intersector has to carry winner geometry.

Winner slots (decoded by wavefront_soa.attrs_soa):
- slots 0..15, geometry by type:
  sphere [cx, cy, cz, r^2] (effective center c + v*t for moving spheres);
  rect [n one-hot (3), a one-hot (3), b one-hot (3), k, a0, a1, b0, b1];
  tri [b1, b2, n0 (3), n1 (3), n2 (3)];
- slots 16..27, the winner's material features: kind, fuzz, ir, tex_kind,
  color0 (3), color1 (3), image_id, mat_id (see ``feature_rows``).
"""

from __future__ import annotations

import jax.numpy as jnp

from raytracer.ops.intersect import Hit
from raytracer.scene.types import (
    PRIM_RECT, PRIM_SPHERE, PRIM_TRIANGLE, Scene,
)

N_GEO_SLOTS = 16
N_FEAT = 12
N_SLOTS = N_GEO_SLOTS + N_FEAT


def feature_rows(scene: Scene, mat_id):
    """(12, K) material+texture feature rows for a (K,) mat_id vector (the
    feature-slot order above)."""
    m = scene.materials
    t = scene.textures
    tex = m.tex_id[mat_id]
    rows = [
        m.kind[mat_id][None], m.fuzz[mat_id][None], m.ir[mat_id][None],
        t.kind[tex][None],
        t.color0[tex].T, t.color1[tex].T,
        t.image_id[tex][None], mat_id[None],
    ]
    return jnp.concatenate([x.astype(jnp.float32) for x in rows], 0)


def winner_data(scene: Scene, o, d, hit: Hit, time=None):
    """Gather the (N_SLOTS, N) winner rows for ``hit`` from the scene
    tables (the per-type math of intersect.hit_attributes, left undecoded
    so the SoA wavefront can decode it component-wise)."""
    n = o.shape[0]
    geo = jnp.zeros((N_GEO_SLOTS, n), jnp.float32)
    mat_id = jnp.zeros((n,), jnp.int32)

    def fill(geo, rows, sel):
        rows = jnp.concatenate(
            [rows, jnp.zeros((N_GEO_SLOTS - rows.shape[0], n), jnp.float32)],
            0)
        return jnp.where(sel[None], rows, geo)

    sp = scene.spheres
    if sp.radius.shape[0]:
        i = jnp.clip(hit.prim_idx, 0, sp.radius.shape[0] - 1)
        c = sp.center[i]
        if sp.motion_marker.shape[0] and time is not None:
            c = c + sp.velocity[i] * jnp.asarray(time, jnp.float32)[:, None]
        r = sp.radius[i]
        sel = hit.prim_type == PRIM_SPHERE
        geo = fill(geo, jnp.concatenate([c.T, (r * r)[None]], 0), sel)
        mat_id = jnp.where(sel, sp.mat_id[i], mat_id)

    rc = scene.rects
    if rc.k.shape[0]:
        i = jnp.clip(hit.prim_idx, 0, rc.k.shape[0] - 1)
        axis = rc.axis[i]
        eye = jnp.eye(3, dtype=jnp.float32)
        rows = jnp.concatenate([
            eye[axis].T, eye[jnp.where(axis == 0, 1, 0)].T,
            eye[jnp.where(axis == 2, 1, 2)].T,
            jnp.stack([rc.k[i], rc.a0[i], rc.a1[i], rc.b0[i], rc.b1[i]])], 0)
        sel = hit.prim_type == PRIM_RECT
        geo = fill(geo, rows, sel)
        mat_id = jnp.where(sel, rc.mat_id[i], mat_id)

    tr = scene.triangles
    if tr.mat_id.shape[0]:
        i = jnp.clip(hit.prim_idx, 0, tr.mat_id.shape[0] - 1)
        v0, e1, e2 = tr.v0[i], tr.e1[i], tr.e2[i]
        # barycentrics of the winning triangle (mesh.rs:69-104)
        s0 = jnp.cross(d, e2)
        div = jnp.sum(s0 * e1, axis=-1)
        inv = 1.0 / jnp.where(div != 0.0, div, 1.0)
        dv = o - v0
        b1 = jnp.sum(dv * s0, axis=-1) * inv
        b2 = jnp.sum(d * jnp.cross(dv, e1), axis=-1) * inv
        rows = jnp.concatenate([b1[None], b2[None], tr.n0[i].T, tr.n1[i].T,
                                tr.n2[i].T], 0)
        sel = hit.prim_type == PRIM_TRIANGLE
        geo = fill(geo, rows, sel)
        mat_id = jnp.where(sel, tr.mat_id[i], mat_id)

    if scene.materials.kind.shape[0]:
        feats = feature_rows(scene, mat_id)
    else:
        feats = jnp.zeros((N_FEAT, n), jnp.float32)
    return jnp.concatenate([geo, feats], 0)


def closest_hit(scene: Scene, o, d, t_min, t_max, method: str,
                alive=None, time=None):
    """Closest hit by the resolved ``method`` plus its gathered winner rows.
    Returns (t, prim_type, prim_idx, data (N_SLOTS, N))."""
    from raytracer.ops.dispatch import intersect_scene
    hit = intersect_scene(scene, o, d, t_min, t_max, method, time=time,
                          alive=alive)
    return (hit.t, hit.prim_type, hit.prim_idx,
            winner_data(scene, o, d, hit, time=time))
