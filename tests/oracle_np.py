"""Independent f64 numpy implementation of the reference's transport, used
as a cross-implementation parity oracle (tests/test_reference_parity.py).

The Rust reference cannot be built in this environment (no rustc/cargo), so
this module provides the strongest available substitute for "compare against
the reference binary's image": a from-scratch scalar-semantics
implementation in f64 numpy, written directly from the reference behavior
documented in SURVEY.md (sphere.rs/rectangle.rs/mesh.rs intersections,
material.rs scatter rules, light.rs emission, photon_mapper.rs SPPM with a
TRUE kNN radius init — no grid, no cell caps). It shares scene DATA with
the production code (the compiled tables are inputs) but none of its math
or code paths: everything below is numpy f64, rejection sampling, and
brute-force queries.

Also used to quantify the production SPPM's density-based radius init
against the reference's unbounded kNN init: run
:func:`sppm_render` with ``init="knn"`` (reference) vs ``init="density"``
(production scheme) and compare images.
"""

from __future__ import annotations

import numpy as np

PI = np.pi
INF = np.inf

# interaction codes (local to the oracle)
DIFFUSE, SPECULAR, ABSORB, REFLECT, REFRACT = range(5)


class NpScene:
    """Numpy f64 views of a compiled Scene pytree (data only)."""

    def __init__(self, scene):
        s = scene
        self.sph_c = np.asarray(s.spheres.center, np.float64)
        self.sph_r = np.asarray(s.spheres.radius, np.float64)
        self.sph_m = np.asarray(s.spheres.mat_id)
        self.rect_axis = np.asarray(s.rects.axis)
        self.rect_k = np.asarray(s.rects.k, np.float64)
        self.rect_a0 = np.asarray(s.rects.a0, np.float64)
        self.rect_a1 = np.asarray(s.rects.a1, np.float64)
        self.rect_b0 = np.asarray(s.rects.b0, np.float64)
        self.rect_b1 = np.asarray(s.rects.b1, np.float64)
        self.rect_m = np.asarray(s.rects.mat_id)
        self.tri_v0 = np.asarray(s.triangles.v0, np.float64)
        self.tri_e1 = np.asarray(s.triangles.e1, np.float64)
        self.tri_e2 = np.asarray(s.triangles.e2, np.float64)
        self.tri_n0 = np.asarray(s.triangles.n0, np.float64)
        self.tri_n1 = np.asarray(s.triangles.n1, np.float64)
        self.tri_n2 = np.asarray(s.triangles.n2, np.float64)
        self.tri_m = np.asarray(s.triangles.mat_id)
        self.mat_kind = np.asarray(s.materials.kind)
        self.mat_fuzz = np.asarray(s.materials.fuzz, np.float64)
        self.mat_ir = np.asarray(s.materials.ir, np.float64)
        self.mat_tex = np.asarray(s.materials.tex_id)
        self.tex_color0 = np.asarray(s.textures.color0, np.float64)
        self.lights_kind = np.asarray(s.lights.kind)
        self.lights_p0 = np.asarray(s.lights.p0, np.float64)
        self.lights_p1 = np.asarray(s.lights.p1, np.float64)
        self.lights_flux = np.asarray(s.lights.flux, np.float64)
        self.lights_scale = np.asarray(s.lights.scale, np.float64)
        self.cam_origin = np.asarray(s.camera.origin, np.float64)
        self.cam_llc = np.asarray(s.camera.lower_left_corner, np.float64)
        self.cam_h = np.asarray(s.camera.horizontal, np.float64)
        self.cam_v = np.asarray(s.camera.vertical, np.float64)

    def albedo(self, mat_id):
        return self.tex_color0[self.mat_tex[mat_id]]


# -------------------------------------------------------------- intersection

def intersect(sc: NpScene, o, d, t_min=1e-3):
    """Closest hit over all primitives, vectorized over N rays.
    Returns (t, p, normal(front-flipped), front_face, mat_id, valid)."""
    n = o.shape[0]
    best_t = np.full(n, INF)
    best_n = np.zeros((n, 3))
    best_m = np.zeros(n, np.int64)

    def consider(t, nrm, mid):
        better = t < best_t
        best_t[better] = t[better]
        best_n[better] = nrm[better]
        best_m[better] = mid

    for i in range(len(sc.sph_r)):
        c, r = sc.sph_c[i], sc.sph_r[i]
        oc = o - c
        a = (d * d).sum(1)
        hb = (oc * d).sum(1)
        ct = (oc * oc).sum(1) - r * r
        disc = hb * hb - a * ct
        sq = np.sqrt(np.maximum(disc, 0))
        t1 = (-hb - sq) / a
        t2 = (-hb + sq) / a
        t = np.where(t1 > t_min, t1, np.where(t2 > t_min, t2, INF))
        t = np.where((disc > 0) & (t < best_t), t, INF)
        p = o + t[:, None] * d
        consider(t, (p - c) / r, sc.sph_m[i])

    for i in range(len(sc.rect_k)):
        ax = int(sc.rect_axis[i])
        aa, bb = ((1, 2), (0, 2), (0, 1))[ax]
        dn = d[:, ax]
        safe = np.abs(dn) > 1e-12
        t = np.where(safe, (sc.rect_k[i] - o[:, ax]) / np.where(safe, dn, 1), INF)
        pa = o[:, aa] + t * d[:, aa]
        pb = o[:, bb] + t * d[:, bb]
        ok = ((t > t_min) & (pa >= sc.rect_a0[i]) & (pa <= sc.rect_a1[i])
              & (pb >= sc.rect_b0[i]) & (pb <= sc.rect_b1[i]))
        t = np.where(ok, t, INF)
        nrm = np.zeros((n, 3))
        nrm[:, ax] = 1.0
        consider(t, nrm, sc.rect_m[i])

    for i in range(len(sc.tri_m)):
        v0, e1, e2 = sc.tri_v0[i], sc.tri_e1[i], sc.tri_e2[i]
        # standard Möller–Trumbore in f64
        pvec = np.cross(d, e2)
        det = (pvec * e1).sum(1)
        safe = np.abs(det) > 1e-15
        inv = 1.0 / np.where(safe, det, 1)
        oc = o - v0
        b1 = (oc * pvec).sum(1) * inv
        qvec = np.cross(oc, e1)
        b2 = (d * qvec).sum(1) * inv
        t = (qvec * e2).sum(1) * inv
        ok = (safe & (b1 >= 0) & (b1 <= 1) & (b2 >= 0) & (b1 + b2 <= 1)
              & (t > t_min))
        t = np.where(ok, t, INF)
        nrm = ((1 - b1 - b2)[:, None] * sc.tri_n0[i] + b1[:, None] * sc.tri_n1[i]
               + b2[:, None] * sc.tri_n2[i])
        ln = np.linalg.norm(nrm, axis=1, keepdims=True)
        nrm = nrm / np.maximum(ln, 1e-12)
        consider(t, nrm, sc.tri_m[i])

    valid = np.isfinite(best_t)
    t = np.where(valid, best_t, 0.0)
    p = o + t[:, None] * d
    front = (d * best_n).sum(1) < 0
    nrm = np.where(front[:, None], best_n, -best_n)
    ln = np.linalg.norm(nrm, axis=1, keepdims=True)
    nrm = nrm / np.maximum(ln, 1e-12)
    return best_t, p, nrm, front, best_m, valid


# ------------------------------------------------------------------ sampling

def unit_sphere(rng, n):
    """Rejection-sampled points in the unit ball, normalized on use sites
    that need unit vectors (vec3.rs:111-138 semantics)."""
    out = np.empty((n, 3))
    need = np.arange(n)
    while len(need):
        cand = rng.uniform(-1, 1, (len(need), 3))
        ok = (cand * cand).sum(1) < 1
        out[need[ok]] = cand[ok]
        need = need[~ok]
    return out


def unit_vector(rng, n):
    v = unit_sphere(rng, n)
    return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)


def hemisphere(rng, normals):
    v = unit_vector(rng, len(normals))
    flip = (v * normals).sum(1) < 0
    v[flip] = -v[flip]
    return v


def reflect(d, n):
    return d - 2 * (d * n).sum(1)[:, None] * n


def refract(uv, n, ratio):
    cos = np.minimum((-uv * n).sum(1), 1.0)
    perp = ratio[:, None] * (uv + cos[:, None] * n)
    par = -np.sqrt(np.abs(1 - (perp * perp).sum(1)))[:, None] * n
    return perp + par


# ------------------------------------------------------------------- scatter

def scatter(sc: NpScene, rng, d_in, p, nrm, front, mat_id, valid):
    """material.rs scatter rules. Returns (interaction, direction,
    attenuation, emitted)."""
    n = len(d_in)
    kind = sc.mat_kind[mat_id]
    albedo = sc.albedo(mat_id)
    inter = np.full(n, ABSORB)
    direction = d_in.copy()
    atten = albedo.copy()
    emitted = np.zeros((n, 3))

    unit_d = d_in / np.maximum(np.linalg.norm(d_in, axis=1, keepdims=True),
                               1e-12)
    lam = valid & ((kind == 0) | (kind == 3))
    diff_dir = nrm + unit_vector(rng, n)
    small = np.linalg.norm(diff_dir, axis=1) < 1e-8
    diff_dir[small] = nrm[small]
    inter[lam] = DIFFUSE
    direction[lam] = diff_dir[lam]
    is_light = valid & (kind == 3)
    atten[is_light] = 1.0 / PI
    emitted[is_light] = albedo[is_light]

    met = valid & (kind == 1)
    refl = reflect(unit_d, nrm)
    mdir = refl + sc.mat_fuzz[mat_id][:, None] * unit_sphere(rng, n)
    mok = (mdir * nrm).sum(1) > 0
    inter[met & mok] = SPECULAR
    inter[met & ~mok] = ABSORB
    direction[met] = mdir[met]

    die = valid & (kind == 2)
    ir = np.maximum(sc.mat_ir[mat_id], 1e-6)
    ratio = np.where(front, 1.0 / ir, ir)
    cos = np.minimum((-unit_d * nrm).sum(1), 1.0)
    sin = np.sqrt(np.maximum(0, 1 - cos * cos))
    cannot = ratio * sin > 1
    r0 = ((1 - ratio) / (1 + ratio)) ** 2
    refl_p = r0 + (1 - r0) * (1 - cos) ** 5
    do_refl = cannot | (refl_p > rng.random(n))
    ddir = np.where(do_refl[:, None], refl, refract(unit_d, nrm, ratio))
    inter[die & do_refl] = REFLECT
    inter[die & ~do_refl] = REFRACT
    direction[die] = ddir[die]
    return inter, direction, atten, emitted


def bsdf_color(sc: NpScene, mat_id):
    """material.rs bsdf: albedo for lambertian/metal/dielectric, 1/pi for
    diffuse lights."""
    c = sc.albedo(mat_id).copy()
    c[sc.mat_kind[mat_id] == 3] = 1.0 / PI
    return c


# ---------------------------------------------------------------- the walks

def camera_rays(sc: NpScene, rng, w, h, spp):
    xs, ys = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    px = np.tile(xs.reshape(-1), spp).astype(np.float64)
    py = np.tile(ys.reshape(-1), spp).astype(np.float64)
    s = (px + rng.random(len(px))) / (w - 1)
    t = (py + rng.random(len(py))) / (h - 1)
    t = 1.0 - t  # y-flip, camera.rs:99
    o = np.broadcast_to(sc.cam_origin, (len(s), 3)).copy()
    d = sc.cam_llc + s[:, None] * sc.cam_h + t[:, None] * sc.cam_v - o
    return o, d


def pt_render(scene, w, h, spp, max_depth, seed=0):
    """Plain path trace (the framework's pt mode semantics: Le at every hit,
    continue at diffuse, no RR). Returns (h, w, 3) linear image."""
    sc = NpScene(scene)
    rng = np.random.default_rng(seed)
    o, d = camera_rays(sc, rng, w, h, spp)
    n = len(o)
    radiance = np.zeros((n, 3))
    throughput = np.ones((n, 3))
    alive = np.ones(n, bool)
    for _ in range(max_depth):
        if not alive.any():
            break
        t, p, nrm, front, mid, valid = intersect(sc, o, d)
        inter, ndir, atten, emitted = scatter(sc, rng, d, p, nrm, front,
                                              mid, valid)
        live = alive & valid
        radiance[live] += throughput[live] * emitted[live]
        cont = live & (inter != ABSORB)
        throughput[cont] *= atten[cont]
        off = np.sign((ndir * nrm).sum(1))[:, None] * nrm * 0.05
        o = np.where(cont[:, None], p + off, o)
        d = np.where(cont[:, None], ndir, d)
        alive = cont
    img = radiance.reshape(spp, h * w, 3).mean(0)
    return img.reshape(h, w, 3)


# ------------------------------------------------------------------- SPPM

def emit_photons(sc: NpScene, rng, n):
    """Single-light XZ rect emission (light.rs:158-166 / ops/lights.py):
    uniform rect origin, uniform hemisphere around (0,-1,0), power =
    flux*scale*cos."""
    assert len(sc.lights_kind) == 1 and sc.lights_kind[0] == 1
    p0, p1 = sc.lights_p0[0], sc.lights_p1[0]
    uv = rng.random((n, 2))
    origin = np.stack([p0[0] + (p1[0] - p0[0]) * uv[:, 0],
                       np.full(n, p0[1]),
                       p0[2] + (p1[2] - p0[2]) * uv[:, 1]], 1)
    down = np.broadcast_to(np.array([0.0, -1.0, 0.0]), (n, 3))
    w = hemisphere(rng, down)
    power = (sc.lights_flux[0] * sc.lights_scale[0])[None] \
        * np.maximum(0, -w[:, 1])[:, None]
    return origin, w, power, down


def trace_photons(scene, rng, n, max_bounces):
    """Photon pass: RR walk depositing at diffuse hits
    (photon_mapper.rs:239-253 + material.rs:27-45)."""
    sc = NpScene(scene)
    o, d, power, _ = emit_photons(sc, rng, n)
    alive = np.ones(n, bool)
    has_spec = np.zeros(n, bool)
    has_diff = np.zeros(n, bool)
    P, W, NRM, CAU = [], [], [], []
    for _ in range(max_bounces):
        if not alive.any():
            break
        t, p, nrm, front, mid, valid = intersect(sc, o, d, t_min=1e-4)
        inter, ndir, atten, _ = scatter(sc, rng, d, p, nrm, front, mid, valid)
        live = alive & valid
        # Reference RR order (material.rs:34-41): scatter_photon applies
        # Russian roulette FIRST and returns Absorb on failure, so an
        # RR-killed photon deposits NOTHING even at a diffuse hit (the
        # photon walk, photon_mapper.rs:244-256, breaks on Absorb before
        # pushing). This oracle originally deposited pre-RR — that
        # overcounted deposit flux by ~(1-mean albedo) ~ 25% on Cornell.
        h = atten.max(1)
        surv = rng.random(n) < h
        inter = np.where(surv, inter, ABSORB)
        dep = live & (inter == DIFFUSE)
        P.append(p[dep])
        W.append(power[dep])
        NRM.append(nrm[dep])
        CAU.append((has_spec & ~has_diff)[dep])
        # RR continuation with power renormalization
        cont = live & (inter != ABSORB)
        power = np.where(cont[:, None],
                         power * atten / np.maximum(h, 1e-12)[:, None], power)
        spec_now = cont & ~dep
        has_spec |= spec_now
        has_diff |= dep & cont
        off = np.sign((ndir * nrm).sum(1))[:, None] * nrm * 0.05
        o = np.where(cont[:, None], p + off, o)
        d = np.where(cont[:, None], ndir, d)
        alive = cont
    return (np.concatenate(P), np.concatenate(W), np.concatenate(NRM),
            np.concatenate(CAU))


def _query(ph_p, ph_w, ph_n, pts, r):
    """Within-radius flux/count with the (1-disk) weight, per point."""
    flux = np.zeros((len(pts), 3))
    cnt = np.zeros(len(pts))
    for i, (q, ri) in enumerate(zip(pts, r)):
        delta = ph_p - q
        d2 = (delta * delta).sum(1)
        sel = d2 <= ri * ri
        if not sel.any():
            continue
        dl = delta[sel]
        un = dl / np.maximum(np.linalg.norm(dl, axis=1, keepdims=True), 1e-12)
        disk = np.abs((ph_n[sel] * un).sum(1))
        flux[i] = ((1 - disk)[:, None] * ph_w[sel]).sum(0)
        cnt[i] = sel.sum()
    return flux, cnt


def _knn_init(ph_p, ph_w, ph_n, pts, k):
    """TRUE unbounded kNN init (photon_mapper.rs:82-99): radius = distance
    to the k-th nearest photon; flux from exactly those k."""
    r2 = np.zeros(len(pts))
    flux = np.zeros((len(pts), 3))
    for i, q in enumerate(pts):
        delta = ph_p - q
        d2 = (delta * delta).sum(1)
        kk = min(k, len(d2))
        if kk == 0:
            continue
        idx = np.argpartition(d2, kk - 1)[:kk]
        r2[i] = d2[idx].max()
        dl = delta[idx]
        un = dl / np.maximum(np.linalg.norm(dl, axis=1, keepdims=True), 1e-12)
        disk = np.abs((ph_n[idx] * un).sum(1))
        flux[i] = ((1 - disk)[:, None] * ph_w[idx]).sum(0)
    return flux, r2


def sppm_render(scene, w, h, n_iters, photons_per_iter, spp, max_depth=16,
                alpha=0.7, k_global=100, k_caustic=50, seed=0,
                init="knn", init_cap=None):
    """Full SPPM (photon_mapper.rs structure) with brute-force queries.
    ``init="knn"`` = the reference's unbounded kNN radius init;
    ``init="density"`` = the production scheme's capped density init
    (r0^2 = cap^2 * k/m within cap; requires ``init_cap``)."""
    sc = NpScene(scene)
    rng = np.random.default_rng(seed)
    npix = w * h
    halves = {}
    for name, k_init in (("glob", k_global), ("caus", k_caustic)):
        halves[name] = dict(flux=np.zeros((npix, 3)), r2=np.zeros(npix),
                            nph=np.zeros(npix), k=k_init)

    for it in range(n_iters):
        ph_p, ph_w, ph_n, ph_c = trace_photons(scene, rng, photons_per_iter,
                                               max_bounces=max_depth)
        # measurement pass: one jittered ray per pixel to first diffuse
        o, d = camera_rays(sc, rng, w, h, 1)
        alive = np.ones(npix, bool)
        m_valid = np.zeros(npix, bool)
        m_p = np.zeros((npix, 3))
        m_b = np.zeros((npix, 3))
        for _ in range(max_depth):
            if not alive.any():
                break
            t, p, nrm, front, mid, valid = intersect(sc, o, d)
            inter, ndir, atten, _ = scatter(sc, rng, d, p, nrm, front, mid,
                                            valid)
            live = alive & valid
            dn = live & (inter == DIFFUSE)
            m_valid |= dn
            m_p[dn] = p[dn]
            m_b[dn] = bsdf_color(sc, mid)[dn]
            cont = live & ~dn & (inter != ABSORB)
            off = np.sign((ndir * nrm).sum(1))[:, None] * nrm * 0.05
            o = np.where(cont[:, None], p + off, o)
            d = np.where(cont[:, None], ndir, d)
            alive = cont

        for name, sel in (("glob", np.ones(len(ph_p), bool)), ("caus", ph_c)):
            H = halves[name]
            pp, ww, nn = ph_p[sel], ph_w[sel], ph_n[sel]
            first = m_valid & (H["nph"] == 0)
            upd = m_valid & ~first
            if first.any():
                if init == "knn":
                    flux0, r20 = _knn_init(pp, ww, nn, m_p[first], H["k"])
                    H["flux"][first] = m_b[first] * flux0
                    H["r2"][first] = r20
                    H["nph"][first] = H["k"]
                else:
                    cap = float(init_cap)
                    fluxc, m = _query(pp, ww, nn, m_p[first],
                                      np.full(first.sum(), cap))
                    has = m > 0
                    r20 = np.where(
                        has, np.minimum(cap * cap * H["k"] / np.maximum(m, 1),
                                        cap * cap), 0.0)
                    H["flux"][first] = (m_b[first] * fluxc
                                        * np.minimum(1, H["k"] / np.maximum(m, 1))[:, None])
                    H["r2"][first] = r20
                    H["nph"][first] = np.where(has, H["k"], 0.0)
            if upd.any():
                r = np.sqrt(H["r2"][upd])
                fl, m = _query(pp, ww, nn, m_p[upd], r)
                n_new = H["nph"][upd] + alpha * m
                frac = n_new / np.maximum(H["nph"][upd] + m, 1)
                H["r2"][upd] *= frac
                H["flux"][upd] = (H["flux"][upd] + m_b[upd] * fl) * frac[:, None]
                H["nph"][upd] = n_new

    # final gather
    n_total = n_iters * photons_per_iter
    est = np.zeros((npix, 3))
    for name in ("glob", "caus"):
        H = halves[name]
        has = H["nph"] > 0
        est[has] += H["flux"][has] / (PI * np.maximum(H["r2"][has], 1e-12)[:, None]) / n_total

    o, d = camera_rays(sc, rng, w, h, spp)
    est_rep = np.tile(est, (spp, 1))
    n = len(o)
    radiance = np.zeros((n, 3))
    throughput = np.ones((n, 3))
    alive = np.ones(n, bool)
    for _ in range(max_depth):
        if not alive.any():
            break
        t, p, nrm, front, mid, valid = intersect(sc, o, d)
        inter, ndir, atten, emitted = scatter(sc, rng, d, p, nrm, front, mid,
                                              valid)
        live = alive & valid
        radiance[live] += throughput[live] * emitted[live]
        dn = live & (inter == DIFFUSE)
        radiance[dn] += throughput[dn] * est_rep[dn]
        cont = live & ~dn & (inter != ABSORB)
        throughput[cont] *= atten[cont]
        off = np.sign((ndir * nrm).sum(1))[:, None] * nrm * 0.05
        o = np.where(cont[:, None], p + off, o)
        d = np.where(cont[:, None], ndir, d)
        alive = cont
    img = radiance.reshape(spp, npix, 3).mean(0)
    return img.reshape(h, w, 3)
