"""Flat-array BVH: host-side build + batched stack traversal.

The reference's BVH is an ``Arc<dyn Hitable>`` binary tree built by median
split on a uniformly random axis (bvh.rs:60-83) and traversed recursively
with virtual dispatch (bvh.rs:87-101). The batched replacement:

- **Build (host, numpy or C++)**: median split on the *largest-extent*
  axis (a strictly better builder; the reference's random axis is not a
  fidelity target — SURVEY.md §7 P3) into flat arrays. Leaves store a
  contiguous range of the reordered primitive list, so the reference's
  leaf-of-1-duplicates-child quirk (bvh.rs:66) has no analog here.
- **Traversal (device)**: per-ray short-stack ``lax.while_loop``, vmapped
  over the wavefront. Ordered descent: the nearer child is popped first and
  the running best-t shrinks the slab window (the semantics of
  bvh.rs:91-101's ``t_max`` shrink). A Pallas kernel version lives in
  ops/pallas_bvh.py (used when available).

Mixed primitive types share one tree: the unified list is
(prim_type, prim_idx) pairs; leaf tests dispatch branchlessly on type.
"""

from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np

from raytracer.ops import vec
from raytracer.ops.intersect import Hit
from raytracer.scene.types import (
    BVH, PRIM_RECT, PRIM_SPHERE, PRIM_TRIANGLE, Scene,
)

MAX_STACK = 48
LEAF_SIZE = 4
INF = jnp.float32(jnp.inf)


# ----------------------------------------------------------------- build

def primitive_aabbs(scene: Scene):
    """Conservative world-space AABBs for every primitive, in unified order
    [spheres | rects | triangles]. Rect/triangle flat dims are padded like
    the reference (rectangle.rs:36-40 ±1e-4; mesh.rs uses ±0.1 but any
    conservative pad is valid — we scale with the scene)."""
    mins, maxs, types, idxs = [], [], [], []
    pad = 1e-4 * max(1.0, float(np.asarray(scene.scale)))

    s = scene.spheres
    if s.radius.shape[0]:
        c = np.asarray(s.center, np.float64)
        r = np.abs(np.asarray(s.radius, np.float64))[:, None]
        mins.append(c - r)
        maxs.append(c + r)
        types.append(np.full(len(c), PRIM_SPHERE, np.int32))
        idxs.append(np.arange(len(c), dtype=np.int32))

    rct = scene.rects
    if rct.k.shape[0]:
        n = rct.k.shape[0]
        axis = np.asarray(rct.axis)
        k = np.asarray(rct.k, np.float64)
        a0, a1 = np.asarray(rct.a0, np.float64), np.asarray(rct.a1, np.float64)
        b0, b1 = np.asarray(rct.b0, np.float64), np.asarray(rct.b1, np.float64)
        lo = np.zeros((n, 3))
        hi = np.zeros((n, 3))
        for i in range(n):
            ax = int(axis[i])
            aa, bb = ((1, 2), (0, 2), (0, 1))[ax]
            lo[i, ax], hi[i, ax] = k[i] - pad, k[i] + pad
            lo[i, aa], hi[i, aa] = a0[i], a1[i]
            lo[i, bb], hi[i, bb] = b0[i], b1[i]
        mins.append(lo)
        maxs.append(hi)
        types.append(np.full(n, PRIM_RECT, np.int32))
        idxs.append(np.arange(n, dtype=np.int32))

    t = scene.triangles
    if t.mat_id.shape[0]:
        v0 = np.asarray(t.v0, np.float64)
        v1 = v0 + np.asarray(t.e1, np.float64)
        v2 = v0 + np.asarray(t.e2, np.float64)
        lo = np.minimum(np.minimum(v0, v1), v2) - pad
        hi = np.maximum(np.maximum(v0, v1), v2) + pad
        mins.append(lo)
        maxs.append(hi)
        types.append(np.full(len(v0), PRIM_TRIANGLE, np.int32))
        idxs.append(np.arange(len(v0), dtype=np.int32))

    if not mins:
        raise ValueError("cannot build a BVH over an empty scene")
    return (np.concatenate(mins).astype(np.float32),
            np.concatenate(maxs).astype(np.float32),
            np.concatenate(types), np.concatenate(idxs))


def _build_flat_python(pmin: np.ndarray, pmax: np.ndarray, leaf_size: int):
    """Iterative median-split build (numpy fallback; C++ fast path in
    native/rt_native.cpp shares this layout)."""
    n = pmin.shape[0]
    centroid = (pmin + pmax) * 0.5
    order = np.arange(n, dtype=np.int32)

    node_min, node_max = [], []
    left, right, is_leaf = [], [], []

    def alloc():
        node_min.append(None)
        node_max.append(None)
        left.append(0)
        right.append(0)
        is_leaf.append(False)
        return len(left) - 1

    root = alloc()
    stack = [(root, 0, n)]
    while stack:
        nid, s, e = stack.pop()
        seg = order[s:e]
        node_min[nid] = pmin[seg].min(axis=0)
        node_max[nid] = pmax[seg].max(axis=0)
        if e - s <= leaf_size:
            left[nid], right[nid], is_leaf[nid] = s, e - s, True
            continue
        ext = centroid[seg].max(axis=0) - centroid[seg].min(axis=0)
        axis = int(np.argmax(ext))
        mid = (e - s) // 2
        part = np.argpartition(centroid[seg, axis], mid)
        order[s:e] = seg[part]
        l_id, r_id = alloc(), alloc()
        left[nid], right[nid], is_leaf[nid] = l_id, r_id, False
        stack.append((r_id, s + mid, e))
        stack.append((l_id, s, s + mid))

    return (np.asarray(node_min, np.float32), np.asarray(node_max, np.float32),
            np.asarray(left, np.int32), np.asarray(right, np.int32),
            np.asarray(is_leaf, bool), order)


def build_bvh(scene: Scene, leaf_size: int = LEAF_SIZE,
              use_native: bool = True) -> Scene:
    """Build the flat BVH host-side and attach it to the scene."""
    pmin, pmax, ptype, pidx = primitive_aabbs(scene)
    built = None
    if use_native:
        try:
            from raytracer.native import runtime as native_rt
            built = native_rt.bvh_build(pmin, pmax, leaf_size)
        except Exception:
            built = None
    if built is None:
        built = _build_flat_python(pmin, pmax, leaf_size)
    node_min, node_max, left, right, is_leaf, order = built
    bvh = BVH(
        node_min=jnp.asarray(node_min), node_max=jnp.asarray(node_max),
        left=jnp.asarray(left), right=jnp.asarray(right),
        is_leaf=jnp.asarray(is_leaf),
        prim_type=jnp.asarray(ptype[order]), prim_idx=jnp.asarray(pidx[order]),
    )
    return scene._replace(bvh=bvh)


# ------------------------------------------------------------- traversal

def _leaf_prim_t(scene: Scene, ptype, pidx, o, d, t_min, t_max):
    """Distance to one primitive identified by (type, idx); +inf on miss.
    Branchless type dispatch over gathered records (scalar per lane)."""
    t_out = INF

    if scene.spheres.radius.shape[0]:
        i = jnp.clip(pidx, 0, scene.spheres.radius.shape[0] - 1)
        c = scene.spheres.center[i]
        r = scene.spheres.radius[i]
        oc = o - c
        a = vec.dot(d, d)
        half_b = vec.dot(oc, d)
        cc = vec.dot(oc, oc) - r * r
        disc = half_b * half_b - a * cc
        sq = jnp.sqrt(jnp.maximum(disc, 0.0))
        r1 = (-half_b - sq) / a
        r2 = (-half_b + sq) / a
        ts = jnp.where((r1 >= t_min) & (r1 <= t_max), r1,
                       jnp.where((r2 >= t_min) & (r2 <= t_max), r2, INF))
        ts = jnp.where(disc >= 0.0, ts, INF)
        t_out = jnp.where(ptype == PRIM_SPHERE, ts, t_out)

    if scene.rects.k.shape[0]:
        i = jnp.clip(pidx, 0, scene.rects.k.shape[0] - 1)
        axis = scene.rects.axis[i]
        eye = jnp.eye(3, dtype=o.dtype)
        n_hot = eye[axis]
        d_n = vec.dot(d, n_hot)
        o_n = vec.dot(o, n_hot)
        safe = jnp.abs(d_n) > 1e-12
        tt = (scene.rects.k[i] - o_n) / jnp.where(safe, d_n, 1.0)
        p = o + tt[..., None] * d
        ax_a = jnp.where(axis == 0, 1, 0)
        ax_b = jnp.where(axis == 2, 1, 2)
        pa = vec.dot(p, eye[ax_a])
        pb = vec.dot(p, eye[ax_b])
        inb = ((pa >= scene.rects.a0[i]) & (pa <= scene.rects.a1[i])
               & (pb >= scene.rects.b0[i]) & (pb <= scene.rects.b1[i]))
        ok = safe & inb & (tt >= t_min) & (tt <= t_max)
        t_out = jnp.where(ptype == PRIM_RECT, jnp.where(ok, tt, INF), t_out)

    if scene.triangles.mat_id.shape[0]:
        tr = scene.triangles
        i = jnp.clip(pidx, 0, tr.mat_id.shape[0] - 1)
        v0, e1, e2 = tr.v0[i], tr.e1[i], tr.e2[i]
        s0 = jnp.cross(d, e2)
        div = vec.dot(s0, e1)
        safe = div != 0.0
        inv = 1.0 / jnp.where(safe, div, 1.0)
        dv = o - v0
        b1 = vec.dot(dv, s0) * inv
        s1 = jnp.cross(dv, e1)
        b2 = vec.dot(d, s1) * inv
        tt = vec.dot(e2, s1) * inv
        ok = (safe & (b1 >= 0.0) & (b1 <= 1.0) & (b2 >= 0.0) & (b1 + b2 <= 1.0)
              & (tt >= t_min) & (tt <= t_max))
        t_out = jnp.where(ptype == PRIM_TRIANGLE, jnp.where(ok, tt, INF), t_out)

    return t_out


def intersect_bvh(scene: Scene, o, d, t_min, t_max,
                  leaf_size: int = LEAF_SIZE) -> Hit:
    """Closest hit via per-ray short-stack traversal, vmapped."""
    bvh = scene.bvh
    n_prims = bvh.prim_type.shape[0]
    tmax0 = jnp.broadcast_to(jnp.asarray(t_max, jnp.float32), o.shape[:1])
    tmin0 = jnp.broadcast_to(jnp.asarray(t_min, jnp.float32), o.shape[:1])

    def one_ray(o1, d1, tmin1, tmax1):
        inv_d = jnp.where(jnp.abs(d1) > 1e-20, 1.0 / d1,
                          jnp.sign(d1) * 1e20 + 1e20)

        def slab(node):
            t0 = (bvh.node_min[node] - o1) * inv_d
            t1 = (bvh.node_max[node] - o1) * inv_d
            lo = jnp.minimum(t0, t1)
            hi = jnp.maximum(t0, t1)
            return jnp.max(lo), jnp.min(hi)

        def cond(c):
            sp, stack, best_t, best_ty, best_ix = c
            return sp > 0

        def body(c):
            sp, stack, best_t, best_ty, best_ix = c
            node = stack[sp - 1]
            sp = sp - 1
            enter, leave = slab(node)
            hit_box = (jnp.maximum(enter, tmin1) <
                       jnp.minimum(leave, jnp.minimum(best_t, tmax1)))
            leaf = bvh.is_leaf[node]

            # --- leaf: test up to leaf_size prims (bounded fori, masked)
            start = bvh.left[node]
            count = bvh.right[node]

            def leaf_body(i, acc):
                bt, bty, bix = acc
                valid = i < count
                slot = jnp.clip(start + i, 0, n_prims - 1)
                pty = bvh.prim_type[slot]
                pix = bvh.prim_idx[slot]
                t = _leaf_prim_t(scene, pty, pix, o1, d1, tmin1,
                                 jnp.minimum(bt, tmax1))
                better = valid & (t < bt)
                return (jnp.where(better, t, bt),
                        jnp.where(better, pty, bty),
                        jnp.where(better, pix, bix))

            do_leaf = hit_box & leaf
            lt, lty, lix = jax.lax.fori_loop(
                0, leaf_size, leaf_body, (best_t, best_ty, best_ix))
            best_t = jnp.where(do_leaf, lt, best_t)
            best_ty = jnp.where(do_leaf, lty, best_ty)
            best_ix = jnp.where(do_leaf, lix, best_ix)

            # --- interior: push children, nearer last (popped first)
            push = hit_box & ~leaf
            l_child, r_child = bvh.left[node], bvh.right[node]
            l_enter, _ = slab(l_child)
            r_enter, _ = slab(r_child)
            near = jnp.where(l_enter <= r_enter, l_child, r_child)
            far = jnp.where(l_enter <= r_enter, r_child, l_child)
            stack = stack.at[jnp.where(push, sp, MAX_STACK - 1)].set(
                jnp.where(push, far, stack[MAX_STACK - 1]))
            sp = sp + jnp.where(push, 1, 0)
            stack = stack.at[jnp.where(push, sp, MAX_STACK - 1)].set(
                jnp.where(push, near, stack[MAX_STACK - 1]))
            sp = sp + jnp.where(push, 1, 0)
            return sp, stack, best_t, best_ty, best_ix

        stack0 = jnp.zeros((MAX_STACK,), jnp.int32)
        init = (jnp.int32(1), stack0, tmax1, jnp.int32(-1), jnp.int32(-1))
        sp, stack, best_t, best_ty, best_ix = jax.lax.while_loop(cond, body, init)
        best_t = jnp.where(best_ty >= 0, best_t, INF)
        return best_t, best_ty, best_ix

    t, ty, ix = jax.vmap(one_ray)(o, d, tmin0, tmax0)
    return Hit(t, ty, ix)
