"""SoA (structure-of-arrays) wavefront bounce loops.

This module keeps ALL wavefront state and shading math as separate (N,)
component arrays — (N,3) exists only at the closest-hit boundary
(ops/closest_hit.py) and at rare texture-fallback stacks. Every loop
regenerates: a lane whose path retires spawns its pixel's next sample.

Semantics are IDENTICAL to models/path_tracer.py::trace_radiance — the
same jax.random keys drive distribution-identical draws (the samplers
below mirror ops/sampling.py stream-for-stream) and the same reference
quirks apply (emit at every hit, DiffuseLight emit-AND-scatter, metal
absorb-below-surface, Schlick/TIR). Eligibility is decided statically by
the caller: the SoA path serves the intersectors in
dispatch.SOA_METHODS; the others take the (N,3) reference loops.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer.ops.closest_hit import N_GEO_SLOTS, closest_hit
from raytracer.scene.types import (
    INTER_ABSORB, INTER_DIFFUSE, INTER_REFLECT, INTER_REFRACT,
    INTER_SPECULAR, MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC,
    MAT_LAMBERTIAN, MAT_METAL, PRIM_MEDIA, PRIM_RECT, PRIM_SPHERE, Scene,
    TEX_CHECKER, TEX_IMAGE, TEX_NOISE,
)

PI = 3.141592653589793
TWO_PI = 6.283185307179586
FRAC_1_PI = 0.3183098861837907


def _unit3(x, y, z):
    inv = jax.lax.rsqrt(jnp.maximum(x * x + y * y + z * z, 1e-30))
    return x * inv, y * inv, z * inv


def _uniform_sphere(key, n):
    """Component-wise ops/sampling.py::uniform_sphere — same key splits,
    same draws, same distribution."""
    k1, k2 = jax.random.split(key)
    z = 1.0 - 2.0 * jax.random.uniform(k1, (n,))
    phi = TWO_PI * jax.random.uniform(k2, (n,))
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return r * jnp.cos(phi), r * jnp.sin(phi), z


def _sphere_from(u1, u2):
    """Uniform sphere point from two prepared uniforms (rows of the
    per-step batched draw; same z/phi construction as _uniform_sphere)."""
    z = 1.0 - 2.0 * u1
    phi = TWO_PI * u2
    r = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    return r * jnp.cos(phi), r * jnp.sin(phi), z


# Per-bounce-step RNG: ONE jax.random.uniform(fold_in(key, step), (R, n))
# call instead of a separate threefry draw per consumer (each
# jax.random call pays fixed fusion overhead; the bits themselves are
# cheap).
# Material kinds are exclusive per lane, so ONE unit-sphere pair (rows
# 0-1) is shared by the diffuse bounce, the metal fuzz offset, and the
# isotropic phase draw. Row layout (all consumers index with these):
U_SPH1, U_SPH2, U_DIEL, U_RR = 0, 1, 2, 3
U_TRACE_ROWS = 4                    # trace-only loops stop here
U_JX, U_JY, U_LR, U_LPHI = 4, 5, 6, 7   # regen respawn camera rows
U_REGEN_ROWS = 8                    # +1 row (shutter time) when moving
U_TIME = 8


def _uni_rows(rng, rows: int, n: int):
    """Accept either a PRNG key (draw (rows, n) uniforms here — still one
    batched call) or an already-drawn (>=rows, n) f32 matrix (hot loops
    pass one per-step draw through every consumer)."""
    if hasattr(rng, "dtype") and rng.dtype == jnp.float32:
        return rng
    return jax.random.uniform(rng, (rows, n))


class HitSoA(NamedTuple):
    """hit_attributes as (N,) components (hit.rs:24-30 semantics)."""
    valid: jnp.ndarray
    t: jnp.ndarray
    px: jnp.ndarray
    py: jnp.ndarray
    pz: jnp.ndarray
    nx: jnp.ndarray
    ny: jnp.ndarray
    nz: jnp.ndarray
    front: jnp.ndarray
    u: jnp.ndarray
    v: jnp.ndarray


class FeatSoA(NamedTuple):
    """Winner material features as (N,) components."""
    kind: jnp.ndarray
    fuzz: jnp.ndarray
    ir: jnp.ndarray
    tex_kind: jnp.ndarray
    c0r: jnp.ndarray
    c0g: jnp.ndarray
    c0b: jnp.ndarray
    c1r: jnp.ndarray
    c1g: jnp.ndarray
    c1b: jnp.ndarray
    image_id: jnp.ndarray


def attrs_soa(ox, oy, oz, dx, dy, dz, t, ty, data):
    """HitAttrs + features from the winner data of ops/closest_hit.py
    (``data``: (N_SLOTS, N) component ROWS — each slot a contiguous (N,)
    slice), all (N,) components (the math of intersect.hit_attributes)."""
    valid = jnp.isfinite(t)
    tt = jnp.where(valid, t, 0.0)
    px = ox + tt * dx
    py = oy + tt * dy
    pz = oz + tt * dz

    # sphere: slots [cx, cy, cz, r^2]
    cx, cy, cz = data[0], data[1], data[2]
    inv_r = jax.lax.rsqrt(jnp.maximum(data[3], 1e-20))
    snx, sny, snz = (px - cx) * inv_r, (py - cy) * inv_r, (pz - cz) * inv_r

    # rect: slots [n(3), a_hot(3), b_hot(3), k, a0, a1, b0, b1]
    rnx, rny, rnz = data[0], data[1], data[2]
    pa = px * data[3] + py * data[4] + pz * data[5]
    pb = px * data[6] + py * data[7] + pz * data[8]
    a0, a1 = data[10], data[11]
    b0, b1 = data[12], data[13]
    rect_u = (pa - a0) / jnp.where(a1 != a0, a1 - a0, 1.0)
    rect_v = (pb - b0) / jnp.where(b1 != b0, b1 - b0, 1.0)

    # triangle: slots [b1, b2, n0(3), n1(3), n2(3)]
    tb1, tb2 = data[0], data[1]
    tb0 = 1.0 - tb1 - tb2
    tnx = tb0 * data[2] + tb1 * data[5] + tb2 * data[8]
    tny = tb0 * data[3] + tb1 * data[6] + tb2 * data[9]
    tnz = tb0 * data[4] + tb1 * data[7] + tb2 * data[10]
    tnx, tny, tnz = _unit3(tnx, tny, tnz)

    is_s = ty == PRIM_SPHERE
    is_r = ty == PRIM_RECT
    is_m = ty == PRIM_MEDIA   # medium event: dummy normal (medium.rs:45)
    nox = jnp.where(is_s, snx, jnp.where(is_r, rnx,
                    jnp.where(is_m, 1.0, tnx)))
    noy = jnp.where(is_s, sny, jnp.where(is_r, rny,
                    jnp.where(is_m, 0.0, tny)))
    noz = jnp.where(is_s, snz, jnp.where(is_r, rnz,
                    jnp.where(is_m, 0.0, tnz)))
    # sphere UV (sphere.rs:16-21); media uv = (0,0) like triangles
    theta = jnp.arccos(jnp.clip(-sny, -1.0, 1.0))
    phi = jnp.arctan2(-snz, snx) + PI
    u = jnp.where(is_s, phi / TWO_PI, jnp.where(is_r, rect_u, 0.0))
    v = jnp.where(is_s, theta / PI, jnp.where(is_r, rect_v, 0.0))

    front = (dx * nox + dy * noy + dz * noz) < 0.0
    sgn = jnp.where(front, 1.0, -1.0)
    nx, ny, nz = _unit3(nox * sgn, noy * sgn, noz * sgn)

    fb = N_GEO_SLOTS
    feats = FeatSoA(
        kind=jnp.round(data[fb + 0]).astype(jnp.int32),
        fuzz=data[fb + 1], ir=jnp.maximum(data[fb + 2], 1e-6),
        tex_kind=jnp.round(data[fb + 3]).astype(jnp.int32),
        c0r=data[fb + 4], c0g=data[fb + 5], c0b=data[fb + 6],
        c1r=data[fb + 7], c1g=data[fb + 8], c1b=data[fb + 9],
        image_id=jnp.round(data[fb + 10]).astype(jnp.int32))
    return HitSoA(valid, t, px, py, pz, nx, ny, nz, front, u, v), feats


def eval_texture_soa(scene: Scene, f: FeatSoA, h: HitSoA):
    """eval_texture_from, component-wise. Image/noise textures fall back to
    small stacked fetches (rare; their gathers need (N,3)/(N,2) forms)."""
    sines = (jnp.sin(10.0 * h.px) * jnp.sin(10.0 * h.py)
             * jnp.sin(10.0 * h.pz))
    neg = sines < 0.0
    chk = f.tex_kind == TEX_CHECKER
    ar = jnp.where(chk & ~neg, f.c1r, f.c0r)
    ag = jnp.where(chk & ~neg, f.c1g, f.c0g)
    ab = jnp.where(chk & ~neg, f.c1b, f.c0b)
    if scene.images.shape[0]:
        img_id = jnp.maximum(f.image_id, 0)
        wh = scene.image_wh[img_id]
        w = wh[:, 0].astype(jnp.float32)
        ht = wh[:, 1].astype(jnp.float32)
        uu = jnp.clip(h.u, 0.0, 1.0)
        vv = 1.0 - jnp.clip(h.v, 0.0, 1.0)
        x = jnp.clip(jnp.floor(w * uu).astype(jnp.int32), 0, wh[:, 0] - 1)
        y = jnp.clip(jnp.floor(ht * vv).astype(jnp.int32), 0, wh[:, 1] - 1)
        img = scene.images[img_id, y, x]                     # (N, 3)
        is_img = f.tex_kind == TEX_IMAGE
        ar = jnp.where(is_img, img[:, 0], ar)
        ag = jnp.where(is_img, img[:, 1], ag)
        ab = jnp.where(is_img, img[:, 2], ab)
    if scene.textures.noise_marker.shape[0]:
        from raytracer.ops import noise as noise_ops
        p3 = jnp.stack([h.px, h.py, h.pz], -1)
        marble = noise_ops.marble(p3, f.c0r)
        is_noise = f.tex_kind == TEX_NOISE
        ar = jnp.where(is_noise, marble, ar)
        ag = jnp.where(is_noise, marble, ag)
        ab = jnp.where(is_noise, marble, ab)
    return ar, ag, ab


class ScatterSoA(NamedTuple):
    interaction: jnp.ndarray  # (N,) int32
    dx: jnp.ndarray
    dy: jnp.ndarray
    dz: jnp.ndarray
    ar: jnp.ndarray           # attenuation rgb
    ag: jnp.ndarray
    ab: jnp.ndarray
    er: jnp.ndarray           # emitted rgb
    eg: jnp.ndarray
    eb: jnp.ndarray


def scatter_soa(scene: Scene, rng, dx, dy, dz, h: HitSoA,
                f: FeatSoA) -> ScatterSoA:
    """materials.scatter, component-wise, stream-identical draws
    (material.rs:92-212 semantics; same uniforms as ops/materials.py).
    ``rng``: PRNG key or prepared (>=3, n) uniform rows (see U_SPH1...)."""
    n = dx.shape[0]
    uni = _uni_rows(rng, 3, n)
    alr, alg, alb = eval_texture_soa(scene, f, h)

    # Lambertian / DiffuseLight: n + unit_sphere, near-zero guard. The
    # sphere pair is SHARED with the metal fuzz draw below — kinds are
    # exclusive per lane, so each lane consumes it once.
    sx, sy, sz = _sphere_from(uni[U_SPH1], uni[U_SPH2])
    ldx, ldy, ldz = h.nx + sx, h.ny + sy, h.nz + sz
    small = (ldx * ldx + ldy * ldy + ldz * ldz) < 1e-16
    ldx = jnp.where(small, h.nx, ldx)
    ldy = jnp.where(small, h.ny, ldy)
    ldz = jnp.where(small, h.nz, ldz)

    # Metal: reflect(unit_d) + fuzz * unit_sphere; absorb below surface
    ux, uy, uz = _unit3(dx, dy, dz)
    dn = ux * h.nx + uy * h.ny + uz * h.nz
    rfx = ux - 2.0 * dn * h.nx
    rfy = uy - 2.0 * dn * h.ny
    rfz = uz - 2.0 * dn * h.nz
    mdx = rfx + f.fuzz * sx
    mdy = rfy + f.fuzz * sy
    mdz = rfz + f.fuzz * sz
    metal_ok = (mdx * h.nx + mdy * h.ny + mdz * h.nz) > 0.0

    # Dielectric: Schlick + TIR + stochastic reflect/refract
    ratio = jnp.where(h.front, 1.0 / f.ir, f.ir)
    cos_t = jnp.minimum(-(ux * h.nx + uy * h.ny + uz * h.nz), 1.0)
    sin_t = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_t * cos_t))
    cannot = ratio * sin_t > 1.0
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    refl = r0 + (1.0 - r0) * (1.0 - cos_t) ** 5
    do_refl = cannot | (refl > uni[U_DIEL])
    ppx = ratio * (ux + cos_t * h.nx)
    ppy = ratio * (uy + cos_t * h.ny)
    ppz = ratio * (uz + cos_t * h.nz)
    par = -jnp.sqrt(jnp.abs(1.0 - (ppx * ppx + ppy * ppy + ppz * ppz)))
    rex = ppx + par * h.nx
    rey = ppy + par * h.ny
    rez = ppz + par * h.nz
    ddx = jnp.where(do_refl, rfx, rex)
    ddy = jnp.where(do_refl, rfy, rey)
    ddz = jnp.where(do_refl, rfz, rez)

    is_lam = f.kind == MAT_LAMBERTIAN
    is_met = f.kind == MAT_METAL
    is_die = f.kind == MAT_DIELECTRIC
    is_lgt = f.kind == MAT_DIFFUSE_LIGHT
    is_iso = f.kind == MAT_ISOTROPIC
    diffish = is_lam | is_lgt

    # isotropic phase (material.rs:213-231): the raw unit-sphere draw —
    # shares the sphere pair, kinds are exclusive per lane (ops/materials)
    odx = jnp.where(diffish, ldx, jnp.where(is_met, mdx,
                    jnp.where(is_iso, sx, ddx)))
    ody = jnp.where(diffish, ldy, jnp.where(is_met, mdy,
                    jnp.where(is_iso, sy, ddy)))
    odz = jnp.where(diffish, ldz, jnp.where(is_met, mdz,
                    jnp.where(is_iso, sz, ddz)))
    ar = jnp.where(is_lgt, FRAC_1_PI, alr)
    ag = jnp.where(is_lgt, FRAC_1_PI, alg)
    ab = jnp.where(is_lgt, FRAC_1_PI, alb)
    inter = jnp.where(diffish, INTER_DIFFUSE,
            jnp.where(is_met,
                      jnp.where(metal_ok, INTER_SPECULAR, INTER_ABSORB),
            jnp.where(is_die,
                      jnp.where(do_refl, INTER_REFLECT, INTER_REFRACT),
                      INTER_DIFFUSE)))
    inter = jnp.where(h.valid, inter, INTER_ABSORB).astype(jnp.int32)
    lit = is_lgt & h.valid
    er = jnp.where(lit, alr, 0.0)
    eg = jnp.where(lit, alg, 0.0)
    eb = jnp.where(lit, alb, 0.0)
    return ScatterSoA(inter, odx, ody, odz, ar, ag, ab, er, eg, eb)


RR_START_BOUNCE = 3


class Bounce(NamedTuple):
    """One bounce's full outcome as (N,) components: interaction code,
    attenuation, emission, candidate next ray (spawn-offset origin +
    scattered direction), hit point and shading normal. Emission/interaction
    are already miss-masked (invalid -> ABSORB, er=0), so loop bodies only
    combine with ``alive``."""
    inter: jnp.ndarray
    ar: jnp.ndarray
    ag: jnp.ndarray
    ab: jnp.ndarray
    er: jnp.ndarray
    eg: jnp.ndarray
    eb: jnp.ndarray
    nox: jnp.ndarray
    noy: jnp.ndarray
    noz: jnp.ndarray
    ndx: jnp.ndarray
    ndy: jnp.ndarray
    ndz: jnp.ndarray
    px: jnp.ndarray
    py: jnp.ndarray
    pz: jnp.ndarray
    nx: jnp.ndarray
    ny: jnp.ndarray
    nz: jnp.ndarray


def block_order(width: int, height: int, bs: int = 16):
    """Static lane->pixel permutation putting a bs x bs pixel block into
    each group of bs*bs consecutive lanes. Row-major lane order would make
    a kernel ray block a thin 1-row strip whose frustum sweeps the whole
    scene; pixel blocks keep both the primary-ray frustum and the
    bounce-origin patch spatially tight, so the kernel's per-chunk box
    cull rejects chunks.
    Returns (perm, inv): numpy arrays, perm[lane_slot] = pixel id."""
    import numpy as np
    ys, xs = np.meshgrid(np.arange(height), np.arange(width), indexing="ij")
    nbx = -(-width // bs)
    key_ = (((ys // bs) * nbx + (xs // bs)) * (bs * bs)
            + (ys % bs) * bs + (xs % bs))
    perm = np.argsort(key_.reshape(-1), kind="stable").astype(np.int32)
    inv = np.argsort(perm, kind="stable").astype(np.int32)
    return perm, inv


def use_sort(scene: Scene, intersector: str) -> bool:
    """Morton ray sorting around the kernel call: OFF by default (its
    per-step argsort and gathers are not measured on the GPU yet);
    RAYTRACER_RAY_SORT=1 turns it on for A/B runs."""
    env = os.environ.get("RAYTRACER_RAY_SORT", "auto")
    if intersector != "pallas":
        return False
    return env == "1"


def _sort_perm(ox, oy, oz, alive):
    """(perm, inv): permutation Morton-ordering ALIVE lanes by origin
    (dead lanes pushed to the back, so trailing all-dead ray tiles take the
    kernels' whole-tile skip). Quantizes against the alive-origin AABB of
    THIS wavefront — no scene knowledge needed, adapts per bounce."""
    n = ox.shape[0]
    inf = jnp.float32(jnp.inf)

    def lo_hi(c):
        return (jnp.min(jnp.where(alive, c, inf)),
                jnp.max(jnp.where(alive, c, -inf)))

    def quant(c, lo, hi):
        s = jnp.where(hi > lo, 1023.0 / (hi - lo), 0.0)
        return jnp.clip((c - lo) * s, 0.0, 1023.0).astype(jnp.uint32)

    def spread(x):  # 10 -> 30 bits (same scheme as pallas_intersect)
        x = (x | (x << 16)) & jnp.uint32(0x030000FF)
        x = (x | (x << 8)) & jnp.uint32(0x0300F00F)
        x = (x | (x << 4)) & jnp.uint32(0x030C30C3)
        x = (x | (x << 2)) & jnp.uint32(0x09249249)
        return x

    code = jnp.uint32(0)
    for i, c in enumerate((ox, oy, oz)):
        lo, hi = lo_hi(c)
        code = code | (spread(quant(c, lo, hi)) << i)
    key = jnp.where(alive, code, jnp.uint32(0xFFFFFFFF))
    perm = jnp.argsort(key)
    inv = jnp.zeros_like(perm).at[perm].set(
        jnp.arange(n, dtype=perm.dtype))
    return perm, inv


def bounce_step(scene: Scene, rng, ox, oy, oz, dx, dy, dz, alive, *,
                t_min: float, spawn_eps, intersector: str, time=None,
                sort: bool = False, media_key=None) -> Bounce:
    """Advance one bounce: closest hit + winner data (ops/closest_hit.py),
    then attrs_soa + scatter_soa. ``rng``: PRNG key or prepared (>=3, n)
    uniform rows.

    ``sort`` (use_sort): permute lanes into Morton-of-origin order around
    the call and inverse-permute the outputs. Lanes are independent and
    their uniform rows travel with them, so results are BIT-IDENTICAL to
    the unsorted call — the permutation only tightens per-ray-tile alive
    AABBs (better near-to-far walk order + reach culling on big scenes)
    and compacts dead lanes into whole skippable tiles."""
    n = ox.shape[0]
    uni = _uni_rows(rng, 3, n)
    if sort:
        perm, inv = _sort_perm(ox, oy, oz, alive)
        tsub = time
        if time is not None and getattr(time, "ndim", 0) >= 1:
            tsub = jnp.take(time, perm, axis=0)
        esub = spawn_eps
        if getattr(spawn_eps, "ndim", 0) >= 1:
            esub = jnp.take(spawn_eps, perm, axis=0)
        # NOTE: with media, the sorted call is statistically equivalent but
        # not bit-identical to unsorted (free-flight uniforms are drawn by
        # lane POSITION inside apply_media_soa); sort is A/B-only anyway
        b = bounce_step(
            scene, uni[:, perm],
            jnp.take(ox, perm), jnp.take(oy, perm), jnp.take(oz, perm),
            jnp.take(dx, perm), jnp.take(dy, perm), jnp.take(dz, perm),
            jnp.take(alive, perm), t_min=t_min, spawn_eps=esub,
            intersector=intersector, time=tsub, sort=False,
            media_key=media_key)
        return Bounce(*(jnp.take(f, inv, axis=0) for f in b))
    o3 = jnp.stack([ox, oy, oz], -1)
    d3 = jnp.stack([dx, dy, dz], -1)
    # moving-sphere winners come back with EFFECTIVE centers (c + v*t), so
    # attrs_soa is motion-agnostic
    t, ty, _ix, data = closest_hit(scene, o3, d3, t_min, jnp.inf,
                                   intersector, alive=alive, time=time)
    if (media_key is not None and scene.media is not None
            and scene.media.kind.shape[0]):
        # volumetric media ride the SoA path: override the geometric
        # winner wherever a free-flight event lands first (same fold-29
        # key stream as the AoS loop — ops/media.py)
        from raytracer.ops.media import apply_media_soa
        t, ty, data = apply_media_soa(
            scene, jax.random.fold_in(media_key, 29), ox, oy, oz,
            dx, dy, dz, t, ty, data, t_min)
    h, f = attrs_soa(ox, oy, oz, dx, dy, dz, t, ty, data)
    sc = scatter_soa(scene, uni, dx, dy, dz, h, f)
    side = jnp.sign(sc.dx * h.nx + sc.dy * h.ny + sc.dz * h.nz) * spawn_eps
    return Bounce(sc.interaction,
                  sc.ar, sc.ag, sc.ab, sc.er, sc.eg, sc.eb,
                  h.px + h.nx * side, h.py + h.ny * side, h.pz + h.nz * side,
                  sc.dx, sc.dy, sc.dz,
                  h.px, h.py, h.pz, h.nx, h.ny, h.nz)


def _mis_bounce(scene: Scene, k, b: Bounce, diffuse_now, spawn_eps,
                time=None) -> Bounce:
    """``--mis`` on the SoA paths: resample diffuse-vertex directions
    through the 50/50 cosine/light mixture and reweight attenuation by
    pdf_cos/pdf_mix (ops/mis.py — all elementwise math plus 8 light-table
    gathers; no extra ray casts, so the fast path stays one
    intersect per bounce). Key stream matches the XLA wavefront's
    (fold 61 off the step key), and the spawn origin is re-offset against
    the possibly light-facing replacement direction."""
    from raytracer.ops.mis import mixture_reweight
    p3 = jnp.stack([b.px, b.py, b.pz], -1)
    n3 = jnp.stack([b.nx, b.ny, b.nz], -1)
    d3 = jnp.stack([b.ndx, b.ndy, b.ndz], -1)
    d_new, w = mixture_reweight(scene, jax.random.fold_in(k, 61), p3, n3,
                                d3, diffuse_now, time=time)
    side = jnp.sign(d_new[:, 0] * b.nx + d_new[:, 1] * b.ny
                    + d_new[:, 2] * b.nz) * spawn_eps
    rep = diffuse_now
    return b._replace(
        ar=jnp.where(rep, b.ar * w, b.ar),
        ag=jnp.where(rep, b.ag * w, b.ag),
        ab=jnp.where(rep, b.ab * w, b.ab),
        nox=jnp.where(rep, b.px + b.nx * side, b.nox),
        noy=jnp.where(rep, b.py + b.ny * side, b.noy),
        noz=jnp.where(rep, b.pz + b.nz * side, b.noz),
        ndx=jnp.where(rep, d_new[:, 0], b.ndx),
        ndy=jnp.where(rep, d_new[:, 1], b.ndy),
        ndz=jnp.where(rep, d_new[:, 2], b.ndz))


def trace_radiance_soa(scene: Scene, o, d, key, *, max_depth: int,
                       t_min: float, spawn_eps, intersector: str,
                       russian_roulette: bool = True, nee: bool = False,
                       mis: bool = False, time=None):
    """SoA twin of path_tracer.trace_radiance for the SOA_METHODS
    intersectors (media via the per-bounce apply_media_soa override;
    motion blur via per-lane ``time`` — constant across a lane's bounces,
    so it rides the closure, not the carry).
    Returns (radiance (N,3), rays ()). Dead lanes stay in place; the
    kernel's alive masking skips their work."""
    n = o.shape[0]
    sort = use_sort(scene, intersector)

    def cond(s):
        return (s[0] < max_depth) & jnp.any(s[14])

    def body(s):
        (step, ox, oy, oz, dx, dy, dz, tr, tg, tb,
         rr_, rg_, rb_, prev_diff, alive, rays) = s
        k = jax.random.fold_in(key, step)
        U = jax.random.uniform(k, (U_TRACE_ROWS, n))
        b = bounce_step(scene, U, ox, oy, oz, dx, dy, dz, alive,
                        t_min=t_min, spawn_eps=spawn_eps,
                        intersector=intersector, time=time, sort=sort,
                        media_key=k)

        # b.er/inter are miss-masked, so `alive` alone gates accumulation
        emit_ok = alive & ~prev_diff
        rr_ = rr_ + jnp.where(emit_ok, tr * b.er, 0.0)
        rg_ = rg_ + jnp.where(emit_ok, tg * b.eg, 0.0)
        rb_ = rb_ + jnp.where(emit_ok, tb * b.eb, 0.0)

        diffuse_now = alive & (b.inter == INTER_DIFFUSE)
        if mis:
            b = _mis_bounce(scene, k, b, diffuse_now, spawn_eps, time=time)
        if nee:
            from raytracer.ops.nee import direct_light
            p3 = jnp.stack([b.px, b.py, b.pz], -1)
            n3 = jnp.stack([b.nx, b.ny, b.nz], -1)
            a3 = jnp.stack([b.ar, b.ag, b.ab], -1)
            dl = direct_light(scene, jax.random.fold_in(k, 53), p3, n3, a3,
                              diffuse_now, intersector=intersector,
                              alive=alive, time=time)
            rr_ = rr_ + jnp.where(diffuse_now, tr * dl[:, 0], 0.0)
            rg_ = rg_ + jnp.where(diffuse_now, tg * dl[:, 1], 0.0)
            rb_ = rb_ + jnp.where(diffuse_now, tb * dl[:, 2], 0.0)

        cont = alive & (b.inter != INTER_ABSORB)
        tr2 = jnp.where(cont, tr * b.ar, tr)
        tg2 = jnp.where(cont, tg * b.ag, tg)
        tb2 = jnp.where(cont, tb * b.ab, tb)
        if russian_roulette:
            p_surv = jnp.clip(jnp.maximum(tr2, jnp.maximum(tg2, tb2)),
                              0.05, 1.0)
            do_rr = step >= RR_START_BOUNCE
            u = U[U_RR]
            survive = ~do_rr | (u < p_surv)
            scale = jnp.where(do_rr & cont & survive, 1.0 / p_surv, 1.0)
            tr2, tg2, tb2 = tr2 * scale, tg2 * scale, tb2 * scale
            cont = cont & survive
        ox2 = jnp.where(cont, b.nox, ox)
        oy2 = jnp.where(cont, b.noy, oy)
        oz2 = jnp.where(cont, b.noz, oz)
        dx2 = jnp.where(cont, b.ndx, dx)
        dy2 = jnp.where(cont, b.ndy, dy)
        dz2 = jnp.where(cont, b.ndz, dz)
        prev2 = diffuse_now if nee else prev_diff
        return (step + 1, ox2, oy2, oz2, dx2, dy2, dz2, tr2, tg2, tb2,
                rr_, rg_, rb_, prev2, cont, rays + jnp.sum(alive))

    one = jnp.ones_like(o[:, 0])
    zero = jnp.zeros_like(one)
    alive0 = o[:, 0] == o[:, 0]
    init = (jnp.int32(0), o[:, 0], o[:, 1], o[:, 2],
            d[:, 0], d[:, 1], d[:, 2], one, one * 1.0, one * 1.0,
            zero, zero * 1.0, zero * 1.0, ~alive0, alive0,
            jnp.sum(jnp.zeros_like(o[:, 0], jnp.int32)))
    s = jax.lax.while_loop(cond, body, init)
    return jnp.stack([s[10], s[11], s[12]], -1), s[15]


def camera_rays_soa(cam, key, px, py, width: int, height: int, uni=None):
    """Component-wise models/camera.py::camera_rays (camera.rs:57-64 +
    the jitter/y-flip of camera.rs:97-99): same draws, no (N,3) stacks.
    ``px, py`` are (N,) f32 pixel coordinates. Returns 6 (N,) components.
    ``uni``: optional 4 prepared uniform rows (jx, jy, lens_r, lens_phi) —
    the regen loops pass slices of their per-step batched draw instead of
    paying 4 separate threefry calls per respawn."""
    n = px.shape[0]
    if uni is None:
        k_jx, k_jy, k_lens = jax.random.split(key, 3)
        k1, k2 = jax.random.split(k_lens)
        uni = jnp.stack([
            jax.random.uniform(k_jx, (n,)), jax.random.uniform(k_jy, (n,)),
            jax.random.uniform(k1, (n,)), jax.random.uniform(k2, (n,))], 0)
    u = (px + uni[0]) / (width - 1)
    v = (py + uni[1]) / (height - 1)
    t = 1.0 - v  # y axis is reverted (camera.rs:99)
    r = jnp.sqrt(uni[2]) * cam.lens_radius
    phi = TWO_PI * uni[3]
    rdx = r * jnp.cos(phi)
    rdy = r * jnp.sin(phi)
    ox = cam.origin[0] + cam.u[0] * rdx + cam.v[0] * rdy
    oy = cam.origin[1] + cam.u[1] * rdx + cam.v[1] * rdy
    oz = cam.origin[2] + cam.u[2] * rdx + cam.v[2] * rdy
    dx = (cam.lower_left_corner[0] + u * cam.horizontal[0]
          + t * cam.vertical[0] - ox)
    dy = (cam.lower_left_corner[1] + u * cam.horizontal[1]
          + t * cam.vertical[1] - oy)
    dz = (cam.lower_left_corner[2] + u * cam.horizontal[2]
          + t * cam.vertical[2] - oz)
    return ox, oy, oz, dx, dy, dz


# Drain compaction cascade (render_regen_soa / gather_regen_soa): each time
# the live lane count falls below half the current wavefront width, the
# survivors are compacted ONCE per level (an alive-first argsort + gather
# outside the hot loop) into a half-width wavefront, down to a
# DRAIN_MIN_LANES floor. The regen loop runs to the SLOWEST lane's step
# count, and every drain step still pays the fixed full-wavefront shading
# cost over all n lanes. Exactly unbiased: pure state reorganization, every
# sample completes under the identical per-sample law; only the threefry
# stream assignment of post-compaction draws changes.
DRAIN_MIN_LANES = 32768


def _drain_sizes(n: int):
    """Cascade level widths: n, n/2, ..., floor (256-aligned). The
    monotonic guard matters: 256-rounding can fail to shrink near small
    floors (e.g. floor 64 -> round256(128) = 256 forever)."""
    sizes = [n]
    while sizes[-1] > DRAIN_MIN_LANES:
        nxt = max(DRAIN_MIN_LANES, -(-(sizes[-1] // 2) // 256) * 256)
        if nxt >= sizes[-1]:
            break
        sizes.append(nxt)
    return sizes


def render_regen_soa(scene: Scene, key, *, width: int, height: int,
                     lanes_per_pixel: int, samples_per_lane: int,
                     max_depth: int, t_min: float, spawn_eps,
                     intersector: str, russian_roulette: bool = True,
                     nee: bool = False, mis: bool = False,
                     pixel_slots=None):
    """Path-REGENERATION wavefront renderer: when a lane's sample retires
    (miss, absorb, RR kill, or depth cap) the lane immediately spawns its
    pixel's NEXT sample — a fresh camera ray, throughput 1, depth 0 — with
    no permutation or scatter (the `where` on the retire mask is the whole
    mechanism). Lane l serves pixel l % npix for ``samples_per_lane``
    sequential samples, so per-pixel spp = lanes_per_pixel *
    samples_per_lane and the final accumulation is a plain reshape-sum.

    This replaces render_fn's fori_loop of fixed-depth wavefronts, whose
    occupancy decays with depth (far worse at the reference's depth-50
    cap, photon_mapper.rs:334) — dead lanes now do the next
    sample's work instead of idling; the straggler drain is finished in a
    compacted small wavefront (see DRAIN_MIN_LANES above). Estimator semantics
    are IDENTICAL to trace_radiance_soa per sample (emit at every hit, RR
    after bounce 3, per-sample depth cap; camera.rs:91-101's per-pixel
    independent samples are exactly what regeneration preserves); only the
    (deterministic) threefry stream assignment differs, as each regenerated
    sample draws from the step-indexed keys of the steps it happens to
    occupy.

    ``pixel_slots``: optional (n_out,) array of actual pixel ids to serve
    instead of the whole image (the pixel-shard case — parallel/render.py
    passes its block-permuted shard); output is then in SLOT order (the
    caller unpermutes). Without it the whole image is rendered and the
    output is pixel-ordered.

    Returns ((n_out, 3) radiance SUM over all samples, rays traced,
    loop steps executed)."""
    if pixel_slots is None:
        perm, inv = block_order(width, height)
        slots = jnp.asarray(perm)
    else:
        inv = None
        slots = pixel_slots
    n_out = slots.shape[0]
    n = n_out * lanes_per_pixel
    sort = use_sort(scene, intersector)
    slot_id = jnp.arange(n, dtype=jnp.int32) % n_out
    pix = slots[slot_id]
    quota = jnp.int32(samples_per_lane)
    # motion blur: each SAMPLE owns one shutter time (camera.rs has no
    # analog — reference Ray is timeless), drawn at spawn from the spawn
    # key (fold 13; independent of camera_rays_soa's splits) and carried
    # per lane. Static scenes carry no time state — identical programs.
    motion = bool(scene.spheres.motion_marker.shape[0])

    def spawn_times(k, nl):
        cam = scene.camera
        return cam.time0 + jax.random.uniform(
            jax.random.fold_in(k, 13), (nl,)) * (cam.time1 - cam.time0)

    def make_body(px_, py_, nl):
        def body(s):
            (step, ox, oy, oz, dx, dy, dz, tr, tg, tb, sr, sg, sb,
             ar, ag, ab, alive, depth, done, prev_diff, rays) = s[:21]
            time = s[21] if motion else None
            k = jax.random.fold_in(key, step)
            U = jax.random.uniform(
                k, (U_REGEN_ROWS + (1 if motion else 0), nl))
            b = bounce_step(scene, U, ox, oy, oz, dx, dy, dz, alive,
                            t_min=t_min, spawn_eps=spawn_eps,
                            intersector=intersector, time=time, sort=sort,
                            media_key=k)

            emit_ok = alive & ~prev_diff
            sr = sr + jnp.where(emit_ok, tr * b.er, 0.0)
            sg = sg + jnp.where(emit_ok, tg * b.eg, 0.0)
            sb = sb + jnp.where(emit_ok, tb * b.eb, 0.0)

            diffuse_now = alive & (b.inter == INTER_DIFFUSE)
            if mis:
                b = _mis_bounce(scene, k, b, diffuse_now, spawn_eps,
                                time=time)
            if nee:
                from raytracer.ops.nee import direct_light
                p3 = jnp.stack([b.px, b.py, b.pz], -1)
                n3 = jnp.stack([b.nx, b.ny, b.nz], -1)
                a3 = jnp.stack([b.ar, b.ag, b.ab], -1)
                dl = direct_light(scene, jax.random.fold_in(k, 53), p3, n3,
                                  a3, diffuse_now, intersector=intersector,
                                  alive=alive, time=time)
                sr = sr + jnp.where(diffuse_now, tr * dl[:, 0], 0.0)
                sg = sg + jnp.where(diffuse_now, tg * dl[:, 1], 0.0)
                sb = sb + jnp.where(diffuse_now, tb * dl[:, 2], 0.0)

            cont = alive & (b.inter != INTER_ABSORB)
            tr2 = jnp.where(cont, tr * b.ar, tr)
            tg2 = jnp.where(cont, tg * b.ag, tg)
            tb2 = jnp.where(cont, tb * b.ab, tb)
            if russian_roulette:
                p_surv = jnp.clip(jnp.maximum(tr2, jnp.maximum(tg2, tb2)),
                                  0.05, 1.0)
                do_rr = depth >= RR_START_BOUNCE  # per-lane sample depth
                u = U[U_RR]
                survive = ~do_rr | (u < p_surv)
                scale = jnp.where(do_rr & cont & survive, 1.0 / p_surv, 1.0)
                tr2, tg2, tb2 = tr2 * scale, tg2 * scale, tb2 * scale
                cont = cont & survive
            depth2 = depth + 1
            cont = cont & (depth2 < max_depth)

            retire = alive & ~cont
            ar = ar + jnp.where(retire, sr, 0.0)
            ag = ag + jnp.where(retire, sg, 0.0)
            ab = ab + jnp.where(retire, sb, 0.0)
            done2 = done + retire.astype(jnp.int32)
            regen = retire & (done2 < quota)

            cox, coy, coz, cdx, cdy, cdz = camera_rays_soa(
                scene.camera, None, px_, py_, width, height,
                uni=U[U_JX:U_LPHI + 1])
            ox2 = jnp.where(regen, cox, jnp.where(cont, b.nox, ox))
            oy2 = jnp.where(regen, coy, jnp.where(cont, b.noy, oy))
            oz2 = jnp.where(regen, coz, jnp.where(cont, b.noz, oz))
            dx2 = jnp.where(regen, cdx, jnp.where(cont, b.ndx, dx))
            dy2 = jnp.where(regen, cdy, jnp.where(cont, b.ndy, dy))
            dz2 = jnp.where(regen, cdz, jnp.where(cont, b.ndz, dz))
            tr3 = jnp.where(regen, 1.0, tr2)
            tg3 = jnp.where(regen, 1.0, tg2)
            tb3 = jnp.where(regen, 1.0, tb2)
            sr2 = jnp.where(regen, 0.0, sr)
            sg2 = jnp.where(regen, 0.0, sg)
            sb2 = jnp.where(regen, 0.0, sb)
            depth3 = jnp.where(regen, 0, depth2)
            prev2 = (diffuse_now if nee else prev_diff) & ~regen
            alive2 = (alive & cont) | regen
            out = (step + 1, ox2, oy2, oz2, dx2, dy2, dz2, tr3, tg3, tb3,
                   sr2, sg2, sb2, ar, ag, ab, alive2, depth3, done2, prev2,
                   rays + jnp.sum(alive))
            if motion:
                cam = scene.camera
                t_new = cam.time0 + U[U_TIME] * (cam.time1 - cam.time0)
                out = out + (jnp.where(regen, t_new, time),)
            return out
        return body

    px = (pix % width).astype(jnp.float32)
    py = (pix // width).astype(jnp.float32)
    ox0, oy0, oz0, dx0, dy0, dz0 = camera_rays_soa(
        scene.camera, jax.random.fold_in(jax.random.fold_in(key, 7), 0),
        px, py, width, height)
    one = jnp.ones_like(ox0)
    zero = jnp.zeros_like(one)
    alive0 = ox0 == ox0
    izero = jnp.zeros_like(pix)
    init = (jnp.int32(0), ox0, oy0, oz0, dx0, dy0, dz0,
            one, one * 1.0, one * 1.0, zero, zero * 1.0, zero * 1.0,
            zero * 1.0, zero * 1.0, zero * 1.0, alive0, izero,
            izero * 1, ~alive0, jnp.sum(izero))
    if motion:
        init = init + (spawn_times(
            jax.random.fold_in(jax.random.fold_in(key, 7), 0), n),)

    sizes = _drain_sizes(n)
    LANE_STATE = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 16, 17, 18, 19)
    if motion:
        LANE_STATE = LANE_STATE + (21,)
    s, cur_px, cur_py, cur_slot = init, px, py, slot_id
    tails = []  # (slot_ids, accum (m,3)) per compacted-away level
    lvl0_accum = None
    for nxt in sizes[1:]:
        s = jax.lax.while_loop(lambda s: jnp.sum(s[16]) > nxt,
                               make_body(cur_px, cur_py, cur_px.shape[0]), s)
        idx = jnp.argsort(~s[16])[:nxt]
        if lvl0_accum is None:  # level-0 keeps its static lane->slot map
            lvl0_accum = jnp.stack([s[13], s[14], s[15]], -1)
        else:
            tails.append((cur_slot, jnp.stack([s[13], s[14], s[15]], -1)))
        s = tuple(x[idx] if i in LANE_STATE
                  else (jnp.zeros((nxt,), jnp.float32) if i in (13, 14, 15)
                        else x)
                  for i, x in enumerate(s))
        cur_px, cur_py, cur_slot = cur_px[idx], cur_py[idx], cur_slot[idx]
    s = jax.lax.while_loop(lambda s: jnp.any(s[16]),
                           make_body(cur_px, cur_py, cur_px.shape[0]), s)
    if lvl0_accum is None:
        accum = jnp.stack([s[13], s[14], s[15]], -1)
        accum = accum.reshape(lanes_per_pixel, n_out, 3).sum(axis=0)
    else:
        tails.append((cur_slot, jnp.stack([s[13], s[14], s[15]], -1)))
        accum = lvl0_accum.reshape(lanes_per_pixel, n_out, 3).sum(axis=0)
        for t_slot, t_acc in tails:  # one-off scatter-adds, tiny rows
            accum = accum.at[t_slot].add(t_acc)
    if inv is not None:
        accum = accum[jnp.asarray(inv)]
    return accum, s[20], s[0]


def gather_regen_soa(scene: Scene, est, key, *, width: int, height: int,
                     lanes_per_pixel: int, samples_per_lane: int,
                     max_depth: int, t_min: float, spawn_eps,
                     intersector: str, pixel_slots=None):
    """Path-regeneration twin of gather_walk_soa for the SPPM final gather
    (sample_ray, photon_mapper.rs:326-365 with the depth-50 cap): Le at
    every hit, the pixel's density estimate at the first Diffuse hit,
    specular chains multiply throughput. The depth-50 specular walk retires
    most lanes within a few bounces, so regeneration converts the ~idle
    tail into fresh samples.

    Without ``pixel_slots``: ``est`` is (npix, 3) pixel-ordered, the whole
    image is gathered, output pixel-ordered. With ``pixel_slots`` (n_out,)
    actual pixel ids (the pixel-shard case): ``est`` must be (n_out, 3) in
    SLOT order and the output is slot-ordered.
    Returns ((n_out, 3) radiance SUM, rays, steps)."""
    if pixel_slots is None:
        perm, inv = block_order(width, height)
        slots = jnp.asarray(perm)
        est_slots = est[slots]
    else:
        inv = None
        slots = pixel_slots
        est_slots = est
    n_out = slots.shape[0]
    n = n_out * lanes_per_pixel
    sort = use_sort(scene, intersector)
    slot_id = jnp.arange(n, dtype=jnp.int32) % n_out
    pix = slots[slot_id]
    quota = jnp.int32(samples_per_lane)

    def make_body(px_, py_, er_, eg_, eb_):
        nl_ = px_.shape[0]

        def body(s):
            (step, ox, oy, oz, dx, dy, dz, tr, tg, tb, sr, sg, sb,
             ar, ag, ab, alive, depth, done, rays) = s
            U = jax.random.uniform(jax.random.fold_in(key, step),
                                   (U_REGEN_ROWS, nl_))
            b = bounce_step(scene, U, ox, oy, oz, dx, dy, dz, alive,
                            t_min=t_min, spawn_eps=spawn_eps,
                            intersector=intersector, sort=sort)
            sr = sr + jnp.where(alive, tr * b.er, 0.0)
            sg = sg + jnp.where(alive, tg * b.eg, 0.0)
            sb = sb + jnp.where(alive, tb * b.eb, 0.0)
            diffuse_now = alive & (b.inter == INTER_DIFFUSE)
            sr = sr + jnp.where(diffuse_now, tr * er_, 0.0)
            sg = sg + jnp.where(diffuse_now, tg * eg_, 0.0)
            sb = sb + jnp.where(diffuse_now, tb * eb_, 0.0)
            cont = alive & ~diffuse_now & (b.inter != INTER_ABSORB)
            tr2 = jnp.where(cont, tr * b.ar, tr)
            tg2 = jnp.where(cont, tg * b.ag, tg)
            tb2 = jnp.where(cont, tb * b.ab, tb)
            depth2 = depth + 1
            cont = cont & (depth2 < max_depth)

            retire = alive & ~cont
            ar = ar + jnp.where(retire, sr, 0.0)
            ag = ag + jnp.where(retire, sg, 0.0)
            ab = ab + jnp.where(retire, sb, 0.0)
            done2 = done + retire.astype(jnp.int32)
            regen = retire & (done2 < quota)

            cox, coy, coz, cdx, cdy, cdz = camera_rays_soa(
                scene.camera, None, px_, py_, width, height,
                uni=U[U_JX:U_LPHI + 1])
            ox2 = jnp.where(regen, cox, jnp.where(cont, b.nox, ox))
            oy2 = jnp.where(regen, coy, jnp.where(cont, b.noy, oy))
            oz2 = jnp.where(regen, coz, jnp.where(cont, b.noz, oz))
            dx2 = jnp.where(regen, cdx, jnp.where(cont, b.ndx, dx))
            dy2 = jnp.where(regen, cdy, jnp.where(cont, b.ndy, dy))
            dz2 = jnp.where(regen, cdz, jnp.where(cont, b.ndz, dz))
            tr3 = jnp.where(regen, 1.0, tr2)
            tg3 = jnp.where(regen, 1.0, tg2)
            tb3 = jnp.where(regen, 1.0, tb2)
            sr2 = jnp.where(regen, 0.0, sr)
            sg2 = jnp.where(regen, 0.0, sg)
            sb2 = jnp.where(regen, 0.0, sb)
            depth3 = jnp.where(regen, 0, depth2)
            alive2 = (alive & cont) | regen
            return (step + 1, ox2, oy2, oz2, dx2, dy2, dz2, tr3, tg3, tb3,
                    sr2, sg2, sb2, ar, ag, ab, alive2, depth3, done2,
                    rays + jnp.sum(alive))
        return body

    px = (pix % width).astype(jnp.float32)
    py = (pix // width).astype(jnp.float32)
    er_ = est_slots[:, 0][slot_id]
    eg_ = est_slots[:, 1][slot_id]
    eb_ = est_slots[:, 2][slot_id]
    ox0, oy0, oz0, dx0, dy0, dz0 = camera_rays_soa(
        scene.camera, jax.random.fold_in(jax.random.fold_in(key, 17), 0),
        px, py, width, height)
    one = jnp.ones_like(ox0)
    zero = jnp.zeros_like(one)
    alive0 = ox0 == ox0
    izero = jnp.zeros_like(pix)
    init = (jnp.int32(0), ox0, oy0, oz0, dx0, dy0, dz0,
            one, one * 1.0, one * 1.0, zero, zero * 1.0, zero * 1.0,
            zero * 1.0, zero * 1.0, zero * 1.0, alive0, izero,
            izero * 1, jnp.sum(izero))

    sizes = _drain_sizes(n)
    LANE_STATE = (1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 16, 17, 18)
    s, cur = init, (px, py, er_, eg_, eb_, slot_id)
    tails = []
    lvl0_accum = None
    for nxt in sizes[1:]:
        s = jax.lax.while_loop(lambda s: jnp.sum(s[16]) > nxt,
                               make_body(*cur[:5]), s)
        idx = jnp.argsort(~s[16])[:nxt]
        if lvl0_accum is None:  # level-0 keeps its static lane->slot map
            lvl0_accum = jnp.stack([s[13], s[14], s[15]], -1)
        else:
            tails.append((cur[5], jnp.stack([s[13], s[14], s[15]], -1)))
        s = tuple(x[idx] if i in LANE_STATE
                  else (jnp.zeros((nxt,), jnp.float32) if i in (13, 14, 15)
                        else x)
                  for i, x in enumerate(s))
        cur = tuple(a[idx] for a in cur)
    s = jax.lax.while_loop(lambda s: jnp.any(s[16]), make_body(*cur[:5]), s)
    if lvl0_accum is None:
        accum = jnp.stack([s[13], s[14], s[15]], -1)
        accum = accum.reshape(lanes_per_pixel, n_out, 3).sum(axis=0)
    else:
        tails.append((cur[5], jnp.stack([s[13], s[14], s[15]], -1)))
        accum = lvl0_accum.reshape(lanes_per_pixel, n_out, 3).sum(axis=0)
        for t_slot, t_acc in tails:
            accum = accum.at[t_slot].add(t_acc)
    if inv is not None:
        accum = accum[jnp.asarray(inv)]
    return accum, s[19], s[0]


def gather_walk_soa(scene: Scene, o, d, est, k_walk, *, max_depth: int,
                    t_min: float, spawn_eps, intersector: str):
    """SoA twin of models/sppm.py::gather_walk (sample_ray,
    photon_mapper.rs:326-365): Le at every hit, the lane's density estimate
    at the first Diffuse hit, specular chains multiply throughput. ``est``
    is (N, 3). Returns (radiance (N,3), rays ())."""
    sort = use_sort(scene, intersector)
    er_, eg_, eb_ = est[:, 0], est[:, 1], est[:, 2]

    def cond(s):
        return (s[0] < max_depth) & jnp.any(s[13])

    def body(s):
        (step, ox, oy, oz, dx, dy, dz, tr, tg, tb, rr_, rg_, rb_,
         alive, rays) = s
        k = jax.random.fold_in(k_walk, step)
        b = bounce_step(scene, k, ox, oy, oz, dx, dy, dz, alive,
                        t_min=t_min, spawn_eps=spawn_eps,
                        intersector=intersector, sort=sort)
        rr_ = rr_ + jnp.where(alive, tr * b.er, 0.0)
        rg_ = rg_ + jnp.where(alive, tg * b.eg, 0.0)
        rb_ = rb_ + jnp.where(alive, tb * b.eb, 0.0)
        diffuse_now = alive & (b.inter == INTER_DIFFUSE)
        rr_ = rr_ + jnp.where(diffuse_now, tr * er_, 0.0)
        rg_ = rg_ + jnp.where(diffuse_now, tg * eg_, 0.0)
        rb_ = rb_ + jnp.where(diffuse_now, tb * eb_, 0.0)
        cont = alive & ~diffuse_now & (b.inter != INTER_ABSORB)
        tr2 = jnp.where(cont, tr * b.ar, tr)
        tg2 = jnp.where(cont, tg * b.ag, tg)
        tb2 = jnp.where(cont, tb * b.ab, tb)
        ox2 = jnp.where(cont, b.nox, ox)
        oy2 = jnp.where(cont, b.noy, oy)
        oz2 = jnp.where(cont, b.noz, oz)
        dx2 = jnp.where(cont, b.ndx, dx)
        dy2 = jnp.where(cont, b.ndy, dy)
        dz2 = jnp.where(cont, b.ndz, dz)
        return (step + 1, ox2, oy2, oz2, dx2, dy2, dz2, tr2, tg2, tb2,
                rr_, rg_, rb_, cont, rays + jnp.sum(alive))

    one = jnp.ones_like(o[:, 0])
    zero = jnp.zeros_like(one)
    alive0 = o[:, 0] == o[:, 0]
    init = (jnp.int32(0), o[:, 0], o[:, 1], o[:, 2],
            d[:, 0], d[:, 1], d[:, 2], one, one * 1.0, one * 1.0,
            zero, zero * 1.0, zero * 1.0, alive0,
            jnp.sum(jnp.zeros_like(o[:, 0], jnp.int32)))
    s = jax.lax.while_loop(cond, body, init)
    return jnp.stack([s[10], s[11], s[12]], -1), s[14]


def measurement_soa(scene: Scene, o, d, *, k_walk, max_depth: int,
                    t_min: float, spawn_eps, intersector: str):
    """SoA twin of models/sppm.py::measurement_pass (update_sppm's specular
    walk to the first Diffuse hit, photon_mapper.rs:277-300). Returns
    (valid (N,), p (N,3), normal (N,3), bsdf (N,3))."""
    sort = use_sort(scene, intersector)

    def cond(s):
        return (s[0] < max_depth) & jnp.any(s[7])

    def body(s):
        (step, ox, oy, oz, dx, dy, dz, alive,
         ov, opx, opy, opz, onx, ony, onz, obr, obg, obb) = s
        k = jax.random.fold_in(k_walk, step)
        b = bounce_step(scene, k, ox, oy, oz, dx, dy, dz, alive,
                        t_min=t_min, spawn_eps=spawn_eps,
                        intersector=intersector, sort=sort)
        diffuse_now = alive & (b.inter == INTER_DIFFUSE)
        # bsdf color = albedo, 1/pi for diffuse lights (material.rs bsdf) —
        # exactly scatter's attenuation; no second texture evaluation
        ov2 = ov | diffuse_now
        opx2 = jnp.where(diffuse_now, b.px, opx)
        opy2 = jnp.where(diffuse_now, b.py, opy)
        opz2 = jnp.where(diffuse_now, b.pz, opz)
        onx2 = jnp.where(diffuse_now, b.nx, onx)
        ony2 = jnp.where(diffuse_now, b.ny, ony)
        onz2 = jnp.where(diffuse_now, b.nz, onz)
        obr2 = jnp.where(diffuse_now, b.ar, obr)
        obg2 = jnp.where(diffuse_now, b.ag, obg)
        obb2 = jnp.where(diffuse_now, b.ab, obb)
        cont = alive & ~diffuse_now & (b.inter != INTER_ABSORB)
        ox2 = jnp.where(cont, b.nox, ox)
        oy2 = jnp.where(cont, b.noy, oy)
        oz2 = jnp.where(cont, b.noz, oz)
        dx2 = jnp.where(cont, b.ndx, dx)
        dy2 = jnp.where(cont, b.ndy, dy)
        dz2 = jnp.where(cont, b.ndz, dz)
        return (step + 1, ox2, oy2, oz2, dx2, dy2, dz2, cont,
                ov2, opx2, opy2, opz2, onx2, ony2, onz2, obr2, obg2, obb2)

    zero = jnp.zeros_like(o[:, 0])
    alive0 = o[:, 0] == o[:, 0]
    init = (jnp.int32(0), o[:, 0], o[:, 1], o[:, 2],
            d[:, 0], d[:, 1], d[:, 2], alive0,
            ~alive0, zero, zero * 1.0, zero * 1.0,
            zero * 1.0, zero * 1.0, zero * 1.0,
            zero * 1.0, zero * 1.0, zero * 1.0)
    s = jax.lax.while_loop(cond, body, init)
    return (s[8], jnp.stack([s[9], s[10], s[11]], -1),
            jnp.stack([s[12], s[13], s[14]], -1),
            jnp.stack([s[15], s[16], s[17]], -1))


def emit_photons_soa(lights, key, n: int):
    """Component-wise ops/lights.py::emit_photons (light.rs:98-103,158-166,
    220-225 semantics): categorical power-weighted light pick, surface-point
    emission, hemisphere direction (cosine-weighted power for rect lights).
    Same draw structure as the AoS version; no (N,3) stacks. Returns 9 (N,)
    components (ox, oy, oz, dx, dy, dz, wr, wg, wb) — the emission normal is
    not returned (deposits store the *hit* normal, photon_mapper.rs:248)."""
    from raytracer.scene.types import LIGHT_SPHERE
    k_pick, k_sphere, k_hemi, k_uv = jax.random.split(key, 4)
    idx = jax.random.categorical(k_pick, lights.log_prob, shape=(n,))
    kind = lights.kind[idx]
    p0x, p0y, p0z = (lights.p0[:, 0][idx], lights.p0[:, 1][idx],
                     lights.p0[:, 2][idx])
    p1x, p1z = lights.p1[:, 0][idx], lights.p1[:, 2][idx]
    r0 = lights.r0[idx]
    sc_ = lights.scale[idx]
    bwr = lights.flux[:, 0][idx] * sc_
    bwg = lights.flux[:, 1][idx] * sc_
    bwb = lights.flux[:, 2][idx] * sc_

    # sphere lights: uniform surface normal, origin = center + n*(r+eps)
    snx, sny, snz = _uniform_sphere(k_sphere, n)
    sox = p0x + snx * (r0 + 1e-4)
    soy = p0y + sny * (r0 + 1e-4)
    soz = p0z + snz * (r0 + 1e-4)

    # xz-rect lights: area point, downward normal
    uv = jax.random.uniform(k_uv, (n, 2))
    rox = p0x + (p1x - p0x) * uv[:, 0]
    roz = p0z + (p1z - p0z) * uv[:, 1]

    is_sph = kind == LIGHT_SPHERE
    nx = jnp.where(is_sph, snx, 0.0)
    ny = jnp.where(is_sph, sny, -1.0)
    nz = jnp.where(is_sph, snz, 0.0)
    ox = jnp.where(is_sph, sox, rox)
    oy = jnp.where(is_sph, soy, p0y)
    oz = jnp.where(is_sph, soz, roz)
    # one hemisphere draw around the selected normal serves both kinds
    hx, hy, hz = _uniform_sphere(k_hemi, n)
    sgn = jnp.where(hx * nx + hy * ny + hz * nz > 0.0, 1.0, -1.0)
    dx, dy, dz = hx * sgn, hy * sgn, hz * sgn
    cos_term = jnp.maximum(-dy, 0.0)  # dot(down, w)
    w_scale = jnp.where(is_sph, 1.0, cos_term)
    return ox, oy, oz, dx, dy, dz, bwr * w_scale, bwg * w_scale, bwb * w_scale


def trace_photon_deposits_regen_soa(scene: Scene, key, n_photons: int,
                                    max_bounces: int, t_min: float,
                                    spawn_eps, intersector: str,
                                    lanes: int = 16384,
                                    return_spawned: bool = False,
                                    spawn_window: int = None):
    """Path-REGENERATION photon pass (the trace_photon_deposits_soa twin of
    render_regen_soa): a fixed wavefront of ``min(lanes, n_photons)`` lanes
    traces photons; when a photon dies (RR absorb, miss, or the
    ``max_bounces`` per-path cap) its lane immediately emits the NEXT photon
    from a global spawn budget of ``n_photons``. Two structural wins over
    the plain scan (500k lanes x 16 steps at Cornell scale):

    - the deposit buffer shrinks ~2x (steps*lanes ~ 3.7M slots vs 8M), so
      the grid builds' argsort+gathers halve;
    - dead lanes do the next photon's work instead of idling (the photon
      RR kills ~40%/bounce, so plain-scan occupancy collapses after 2-3
      steps) — fewer, fuller kernel steps.

    The lane count trades occupancy against the deposit buffer (and grid
    sort) size, which shrinks with S*L; the default is not yet measured on
    the GPU.

    Budgeting: a per-step prefix sum over the retire mask admits exactly
    ``n_photons`` spawns; spawning stops ``max_bounces`` steps before the
    static step count S so every admitted photon gets its full bounce
    allowance, then the wavefront drains. If the spawn window closes before
    the budget is used (pathologically long mean path length), the deposit
    powers are scaled by n_photons/actual — exactly unbiased, since photon
    flux normalization divides by the NOMINAL count downstream
    (photon_mapper.rs:117-119 divides by photon_per_iter * iters).

    Per-photon semantics are IDENTICAL to trace_photon_deposits_soa
    (scatter + RR renormalization material.rs:27-45, deposit-before-
    renormalize photon_mapper.rs:248, caustic = first-diffuse-after-
    specular-only prefix photon_mapper.rs:249-251); only the threefry
    stream assignment differs (each photon draws from the step-indexed
    keys of the steps it occupies).

    Returns the same 11 flat component arrays, of length S*lanes."""
    B = int(n_photons)
    L = min(B, int(lanes))
    # spawn-rate model: ~L/E[len] retire per step (E[len] ~ 2.5 with RR);
    # 4x(B-L)/L steps admits the remaining budget with ~1.6x margin.
    # ``spawn_window`` overrides the model (tests force the window-closed-
    # early rescale path with it).
    if spawn_window is not None:
        window = spawn_window
    else:
        window = 0 if B <= L else -(-4 * (B - L) // L)
    S = window + max_bounces
    sort = use_sort(scene, intersector)
    k_emit = jax.random.fold_in(key, 29)

    def emit(step_i):
        return emit_photons_soa(scene.lights,
                                jax.random.fold_in(k_emit, step_i), L)

    def step(s, _):
        (step_i, ox, oy, oz, dx, dy, dz, wr, wg, wb,
         alive, has_spec, has_diff, depth, counter) = s
        U = jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(key, 13), step_i),
            (U_TRACE_ROWS, L))
        b = bounce_step(scene, U, ox, oy, oz, dx, dy, dz, alive,
                        t_min=t_min, spawn_eps=spawn_eps,
                        intersector=intersector, sort=sort)
        # photon Russian roulette with power renormalization
        # (material.rs:27-45)
        hmax = jnp.maximum(b.ar, jnp.maximum(b.ag, b.ab))
        survive = U[U_RR] <= hmax
        inter = jnp.where(survive, b.inter, INTER_ABSORB).astype(jnp.int32)
        inv_h = 1.0 / jnp.maximum(hmax, 1e-12)

        diffuse_now = alive & (inter == INTER_DIFFUSE)
        deposit = (b.px, b.py, b.pz, wr, wg, wb, b.nx, b.ny, b.nz,
                   diffuse_now, diffuse_now & has_spec & ~has_diff)

        cont = alive & (inter != INTER_ABSORB)
        depth2 = depth + 1
        cont = cont & (depth2 < max_bounces)  # per-path cap, not scan length
        specular_now = cont & ~diffuse_now

        retire = alive & ~cont
        can_spawn = step_i < window
        rank = jnp.cumsum(retire.astype(jnp.int32))
        spawn = retire & can_spawn & (counter + rank <= B)
        counter2 = counter + jnp.where(can_spawn,
                                       jnp.minimum(rank[-1], B - counter), 0)

        eox, eoy, eoz, edx, edy, edz, ewr, ewg, ewb = emit(step_i + 1)

        def sel(fresh, advanced, old):
            return jnp.where(spawn, fresh, jnp.where(cont, advanced, old))

        ox2 = sel(eox, b.nox, ox)
        oy2 = sel(eoy, b.noy, oy)
        oz2 = sel(eoz, b.noz, oz)
        dx2 = sel(edx, b.ndx, dx)
        dy2 = sel(edy, b.ndy, dy)
        dz2 = sel(edz, b.ndz, dz)
        wr2 = sel(ewr, wr * jnp.where(survive, b.ar * inv_h, 1.0), wr)
        wg2 = sel(ewg, wg * jnp.where(survive, b.ag * inv_h, 1.0), wg)
        wb2 = sel(ewb, wb * jnp.where(survive, b.ab * inv_h, 1.0), wb)
        has_spec2 = (has_spec | specular_now) & ~spawn
        has_diff2 = (has_diff | diffuse_now) & ~spawn
        depth3 = jnp.where(spawn, 0, depth2)
        alive2 = (alive & cont) | spawn
        return ((step_i + 1, ox2, oy2, oz2, dx2, dy2, dz2, wr2, wg2, wb2,
                 alive2, has_spec2, has_diff2, depth3, counter2), deposit)

    eox, eoy, eoz, edx, edy, edz, ewr, ewg, ewb = emit(0)
    lane = jnp.arange(L, dtype=jnp.int32)
    alive0 = lane < B
    init = (jnp.int32(0), eox, eoy, eoz, edx, edy, edz, ewr, ewg, ewb,
            alive0, jnp.zeros_like(alive0), jnp.zeros_like(alive0),
            jnp.zeros_like(lane), jnp.int32(min(L, B)))
    final, dep = jax.lax.scan(step, init, None, length=S)
    spawned = final[14]
    # window-closed-early correction (no-op when the budget was used)
    scale = jnp.float32(B) / jnp.maximum(spawned, 1).astype(jnp.float32)
    flat = [a.reshape(-1) for a in dep]
    flat[3] = flat[3] * scale
    flat[4] = flat[4] * scale
    flat[5] = flat[5] * scale
    if return_spawned:
        return tuple(flat), spawned
    return tuple(flat)


def trace_photon_deposits_soa(scene: Scene, key, n_photons: int,
                              max_bounces: int, t_min: float, spawn_eps,
                              intersector: str):
    """SoA twin of models/sppm.py::trace_photon_deposits. Deposits come
    back as flat (n_photons*max_bounces,) COMPONENT arrays — the AoS
    version's (bounces, N, 3) scan stacks were (8,128)-tile padded 42x.
    Returns (px, py, pz, wr, wg, wb, nx, ny, nz, valid, caustic)."""
    from raytracer.ops.lights import emit_photons
    ph = emit_photons(scene.lights, key, n_photons)
    sort = use_sort(scene, intersector)

    def step(s, _):
        (ox, oy, oz, dx, dy, dz, wr, wg, wb,
         alive, has_spec, has_diff, b_) = s
        U = jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(key, 13), b_),
            (U_TRACE_ROWS, n_photons))
        b = bounce_step(scene, U, ox, oy, oz, dx, dy, dz, alive,
                        t_min=t_min, spawn_eps=spawn_eps,
                        intersector=intersector, sort=sort)
        # photon Russian roulette with power renormalization
        # (material.rs:27-45)
        hmax = jnp.maximum(b.ar, jnp.maximum(b.ag, b.ab))
        survive = U[U_RR] <= hmax
        inter = jnp.where(survive, b.inter, INTER_ABSORB).astype(jnp.int32)
        inv_h = 1.0 / jnp.maximum(hmax, 1e-12)
        pr = jnp.where(survive, b.ar * inv_h, 1.0)
        pg = jnp.where(survive, b.ag * inv_h, 1.0)
        pb = jnp.where(survive, b.ab * inv_h, 1.0)

        diffuse_now = alive & (inter == INTER_DIFFUSE)
        # deposit carries the power BEFORE this bounce's renormalization
        # (photon_mapper.rs:248 pushes `power`, then updates it)
        deposit = (b.px, b.py, b.pz, wr, wg, wb, b.nx, b.ny, b.nz,
                   diffuse_now, diffuse_now & has_spec & ~has_diff)

        cont = alive & (inter != INTER_ABSORB)
        specular_now = cont & ~diffuse_now
        ox2 = jnp.where(cont, b.nox, ox)
        oy2 = jnp.where(cont, b.noy, oy)
        oz2 = jnp.where(cont, b.noz, oz)
        dx2 = jnp.where(cont, b.ndx, dx)
        dy2 = jnp.where(cont, b.ndy, dy)
        dz2 = jnp.where(cont, b.ndz, dz)
        wr2 = jnp.where(cont, wr * pr, wr)
        wg2 = jnp.where(cont, wg * pg, wg)
        wb2 = jnp.where(cont, wb * pb, wb)
        return ((ox2, oy2, oz2, dx2, dy2, dz2, wr2, wg2, wb2, cont,
                 has_spec | specular_now, has_diff | diffuse_now, b_ + 1),
                deposit)

    alive0 = ph.origin[:, 0] == ph.origin[:, 0]
    init = (ph.origin[:, 0], ph.origin[:, 1], ph.origin[:, 2],
            ph.dir[:, 0], ph.dir[:, 1], ph.dir[:, 2],
            ph.power[:, 0], ph.power[:, 1], ph.power[:, 2],
            alive0, ~alive0, ~alive0, jnp.int32(0))
    _, dep = jax.lax.scan(step, init, None, length=max_bounces)
    return tuple(a.reshape(-1) for a in dep)
