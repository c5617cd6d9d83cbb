"""SPPM integrator — the reference's render algorithm, wavefront-style.

Reference structure (photon_mapper.rs): 50 iterations of {photon pass ->
kd-tree build -> per-pixel measurement update}, then a 256-spp final gather.
Wavefront design:

- photon pass: one wavefront of ``photons_per_iter`` photons advanced by a
  ``lax.scan`` over bounce steps with Russian roulette
  (material.rs:27-45); every surviving Diffuse interaction deposits the
  photon's *incoming* power (photon_mapper.rs:244-252), and photons whose
  path was specular-only-so-far also deposit into the caustic set
  (photon_mapper.rs:249-251);
- photon maps: sorted uniform grids (ops/photon_grid.py) instead of
  kd-trees;
- measurement pass (update_sppm, photon_mapper.rs:277-300): one jittered
  camera ray per pixel walks the specular chain to its first Diffuse hit;
  per-pixel {flux, radius^2, photons} stats update with the alpha=0.7
  radius shrink (photon_mapper.rs:49-63) — pure elementwise math on (npix,)
  arrays, no locks;
- final gather (sample_ray, photon_mapper.rs:326-365): standard specular
  walk accumulating throughput*Le at EVERY hit, and at the first Diffuse
  hit adds the pixel's caustic+global density estimates
  flux/(pi r^2 N_total) (photon_mapper.rs:117-119,344-351).

State is a pytree of (npix,) arrays -> checkpointable between iterations
(SURVEY.md §5.4), and every pass is sharded over pixels/photons by the
parallel layer.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp

from raytracer.models.camera import camera_rays
from raytracer.models.path_tracer import hit_and_attrs, spawn_origin
from raytracer.ops import materials as mat_ops
from raytracer.ops import photon_grid as pg
from raytracer.ops.lights import emit_photons
from raytracer.scene.types import (
    INTER_ABSORB, INTER_DIFFUSE, Scene,
)
from raytracer.utils.config import RenderConfig, SPPMConfig

PI = 3.141592653589793


class SPPMHalf(NamedTuple):
    """Per-pixel stats for one map (global or caustic). SPPM struct,
    photon_mapper.rs:33-40."""
    flux: jnp.ndarray     # (npix, 3)
    radius2: jnp.ndarray  # (npix,)
    photons: jnp.ndarray  # (npix,) float (ref uses usize; alpha makes it real)


class SPPMState(NamedTuple):
    glob: SPPMHalf
    caustic: SPPMHalf
    iteration: jnp.ndarray  # () int32


def init_state(npix: int) -> SPPMState:
    def half():
        return SPPMHalf(jnp.zeros((npix, 3), jnp.float32),
                        jnp.zeros((npix,), jnp.float32),
                        jnp.zeros((npix,), jnp.float32))
    return SPPMState(half(), half(), jnp.int32(0))


# ------------------------------------------------------------ photon pass

def trace_photon_deposits(scene: Scene, key, n_photons: int, max_bounces: int,
                          t_min: float, spawn_eps, intersector: str):
    """Emit + bounce photons; returns flat deposit arrays of length
    n_photons * max_bounces: (pos, power, norm, valid, caustic)."""
    ph = emit_photons(scene.lights, key, n_photons)

    class S(NamedTuple):
        o: jnp.ndarray
        d: jnp.ndarray
        power: jnp.ndarray
        alive: jnp.ndarray
        has_spec: jnp.ndarray
        has_diff: jnp.ndarray
        bounce: jnp.ndarray

    def step(s: S, _):
        k = jax.random.fold_in(jax.random.fold_in(key, 13), s.bounce)
        U = jax.random.uniform(k, (4, s.d.shape[0]))
        attrs = hit_and_attrs(scene, k, s.o, s.d, t_min, intersector,
                              alive=s.alive)
        sc, new_power = mat_ops.scatter_photon(scene, U, s.d, attrs, s.power)

        live = s.alive & attrs.valid
        diffuse_now = live & (sc.interaction == INTER_DIFFUSE)
        # deposit carries the power BEFORE this bounce's renormalization
        # (photon_mapper.rs:248 pushes `power`, then updates it)
        deposit = (attrs.p, s.power, attrs.normal, diffuse_now,
                   diffuse_now & s.has_spec & ~s.has_diff)

        cont = live & (sc.interaction != INTER_ABSORB)
        specular_now = cont & ~diffuse_now
        o2 = jnp.where(cont[:, None],
                       spawn_origin(attrs.p, attrs.normal, sc.direction,
                                    spawn_eps), s.o)
        d2 = jnp.where(cont[:, None], sc.direction, s.d)
        p2 = jnp.where(cont[:, None], new_power, s.power)
        return S(o2, d2, p2, cont,
                 s.has_spec | specular_now, s.has_diff | diffuse_now,
                 s.bounce + 1), deposit

    init = S(ph.origin, ph.dir, ph.power,
             ph.origin[:, 0] == ph.origin[:, 0],
             ph.origin[:, 0] != ph.origin[:, 0],
             ph.origin[:, 0] != ph.origin[:, 0],
             jnp.int32(0))
    _, (pos, power, norm, valid, caustic) = jax.lax.scan(
        step, init, None, length=max_bounces)
    flat = lambda a: a.reshape((-1,) + a.shape[2:])
    return flat(pos), flat(power), flat(norm), flat(valid), flat(caustic)


# ------------------------------------------------------- measurement pass

class MeasurePoints(NamedTuple):
    valid: jnp.ndarray   # (npix,)
    p: jnp.ndarray       # (npix, 3)
    normal: jnp.ndarray  # (npix, 3)
    bsdf: jnp.ndarray    # (npix, 3) the point's bsdf color (albedo or 1/pi)


def measurement_pass(scene: Scene, key, pixel_ids, width, height, max_depth,
                     t_min, spawn_eps, intersector) -> MeasurePoints:
    """update_sppm's specular walk to the first Diffuse hit
    (photon_mapper.rs:277-300). No emission, no throughput."""
    k_cam, k_walk = jax.random.split(key)
    o, d = camera_rays(scene.camera, k_cam, pixel_ids, width, height)
    n = o.shape[0]

    if _soa_eligible(scene, intersector):
        from raytracer.models.wavefront_soa import measurement_soa
        from raytracer.ops.dispatch import _resolve
        method = _resolve(scene, intersector)
        valid, p, normal, bsdf = measurement_soa(
            scene, o, d, k_walk=k_walk, max_depth=max_depth, t_min=t_min,
            spawn_eps=spawn_eps, intersector=method)
        return MeasurePoints(valid, p, normal, bsdf)

    class S(NamedTuple):
        o: jnp.ndarray
        d: jnp.ndarray
        alive: jnp.ndarray
        bounce: jnp.ndarray
        out_valid: jnp.ndarray
        out_p: jnp.ndarray
        out_n: jnp.ndarray
        out_bsdf: jnp.ndarray

    def cond(s):
        return (s.bounce < max_depth) & jnp.any(s.alive)

    def body(s: S):
        k = jax.random.fold_in(k_walk, s.bounce)
        attrs = hit_and_attrs(scene, k, s.o, s.d, t_min, intersector,
                              alive=s.alive)
        sc = mat_ops.scatter(scene, jax.random.uniform(
            k, (3, s.d.shape[0])), s.d, attrs)
        live = s.alive & attrs.valid
        diffuse_now = live & (sc.interaction == INTER_DIFFUSE)
        bsdf_color = mat_ops.bsdf(scene, attrs.mat_id, attrs.p, attrs.uv)

        out_valid = s.out_valid | diffuse_now
        out_p = jnp.where(diffuse_now[:, None], attrs.p, s.out_p)
        out_n = jnp.where(diffuse_now[:, None], attrs.normal, s.out_n)
        out_b = jnp.where(diffuse_now[:, None], bsdf_color, s.out_bsdf)

        cont = live & ~diffuse_now & (sc.interaction != INTER_ABSORB)
        o2 = jnp.where(cont[:, None],
                       spawn_origin(attrs.p, attrs.normal, sc.direction,
                                    spawn_eps), s.o)
        d2 = jnp.where(cont[:, None], sc.direction, s.d)
        return S(o2, d2, cont, s.bounce + 1, out_valid, out_p, out_n, out_b)

    alive0 = o[:, 0] == o[:, 0]
    init = S(o, d, alive0, jnp.int32(0), ~alive0,
             jnp.zeros((n, 3)), jnp.zeros((n, 3)), jnp.zeros((n, 3)))
    out = jax.lax.while_loop(cond, body, init)
    return MeasurePoints(out.out_valid, out.out_p, out.out_n, out.out_bsdf)


# ---------------------------------------------------------------- queries

def _soa_eligible(scene: Scene, intersector: str) -> bool:
    from raytracer.ops.dispatch import SOA_METHODS, _resolve
    return (_resolve(scene, intersector) in SOA_METHODS
            and (scene.media is None or not scene.media.kind.shape[0]))


def _photon_maps(scene: Scene, k_ph, *, n_photons, max_photon_bounces,
                 grid_res, photon_t_min, spawn_eps, intersector, query_impl):
    """Photon pass + both photon maps (PhotonGrid pytrees)."""
    if _soa_eligible(scene, intersector):
        # SoA photon pass with path REGENERATION (dead lanes emit the next
        # photon from the budget): fewer deposit slots for the grid builds
        # to sort and fuller steps than the plain n_photons x max_bounces
        # scan (see trace_photon_deposits_regen_soa). Components stack to
        # (P,3) only at the grid boundary.
        from raytracer.models.wavefront_soa import (
            trace_photon_deposits_regen_soa)
        from raytracer.ops.dispatch import _resolve
        comps = trace_photon_deposits_regen_soa(
            scene, k_ph, n_photons, max_photon_bounces, photon_t_min,
            spawn_eps, _resolve(scene, intersector))
        (px, py, pz, wr, wg, wb, nx, ny, nz, valid, caustic) = comps
        pos = jnp.stack([px, py, pz], -1)
        power = jnp.stack([wr, wg, wb], -1)
        norm = jnp.stack([nx, ny, nz], -1)
    else:
        pos, power, norm, valid, caustic = trace_photon_deposits(
            scene, k_ph, n_photons, max_photon_bounces, photon_t_min,
            spawn_eps, intersector)
    g = pg.build_grid(pos, power, norm, valid,
                      scene.bounds_min, scene.bounds_max, grid_res,
                      compact=True)
    # a path deposits into the caustic set at most ONCE (first diffuse
    # after a specular-only prefix, photon_mapper.rs:249-251), so
    # n_photons statically bounds the caustic map size — the build's
    # gathers shrink from all deposit slots (~3.7M) to n_photons
    c = pg.build_grid(pos, power, norm, valid & caustic,
                      scene.bounds_min, scene.bounds_max, grid_res,
                      compact=True, max_valid=n_photons)
    return g, c


def _sorted_dual_query(g_grid, c_grid, grid_res, pts_p, rg, cap_g, rc,
                       cap_c, bounds_min, bounds_max, k_per_cell,
                       query_chunk, impl: str):
    """Run both map queries with the points CELL-SORTED (one shared sort):
    image-ordered points put silhouette-boundary pixels in the same kernel
    tile, whose AABB then reaches most photon chunks — cell order keeps
    tiles spatially tight. Results are unsorted back. Identical sums."""
    n = pts_p.shape[0]
    extent = jnp.maximum(bounds_max - bounds_min, 1e-6)
    inv_cell = jnp.asarray(grid_res, jnp.float32) / extent
    ci = jnp.clip(jnp.floor((pts_p - bounds_min) * inv_cell).astype(jnp.int32),
                  0, jnp.asarray(grid_res, jnp.int32) - 1)
    cid = (ci[:, 0] * grid_res[1] + ci[:, 1]) * grid_res[2] + ci[:, 2]
    order = jnp.argsort(cid)
    inv = jnp.zeros((n,), jnp.int32).at[order].set(
        jnp.arange(n, dtype=jnp.int32))
    p_s = pts_p[order]

    def unsort(q):
        return pg.QueryResult(*(jnp.take(x, inv, axis=0) for x in q))

    qg = _query(g_grid, grid_res, p_s, rg[order], cap_g[order], k_per_cell,
                query_chunk, impl)
    qc = _query(c_grid, grid_res, p_s, rc[order], cap_c[order], k_per_cell,
                query_chunk, impl)
    return unsort(qg), unsort(qc)


def _query(grid, grid_res, points, radius, cap_radius, k_per_cell,
           query_chunk, impl: str) -> pg.QueryResult:
    """Dual-radius photon query. "dense" = exact within-radius sums
    (reference kd-tree semantics, photon_mapper.rs:102-114): the GPU kernel
    on a GPU (it beat the plain XLA form end to end, PERF.md), else the
    plain XLA form; "grid" = XLA 27-cell
    gather (capped)."""
    if impl == "dense":
        from raytracer.ops import pallas_photon
        valid = jnp.arange(grid.pos.shape[0], dtype=jnp.int32) < grid.n_valid
        query = pallas_photon.query_photons_xla
        if jax.default_backend() == "gpu":
            query = pallas_photon.query_photons
        return query(grid.pos, grid.power.astype(jnp.float32),
                     grid.norm.astype(jnp.float32), valid, points, radius,
                     cap_radius)
    return pg.query_grid_chunked(grid, grid_res, points, radius, cap_radius,
                                 k_per_cell, query_chunk)


# ------------------------------------------------------------ stat update

def _update_half(half: SPPMHalf, pts: MeasurePoints, q: pg.QueryResult,
                 k_init: float, alpha: float, cap_radius) -> SPPMHalf:
    """Branchless init-or-update (photon_mapper.rs:49-63). The kNN init is
    density-based: r0^2 = h^2 * k/m from the count m within the cap radius
    (see ops/photon_grid.py docstring)."""
    first = pts.valid & (half.photons == 0.0)

    # ---- init path
    m_cap = q.count_cap
    has_any = m_cap > 0.0
    r0_2 = jnp.where(has_any,
                     jnp.minimum(cap_radius * cap_radius * k_init
                                 / jnp.maximum(m_cap, 1.0),
                                 cap_radius * cap_radius),
                     0.0)
    flux0 = (pts.bsdf * q.flux_cap
             * jnp.minimum(1.0, k_init / jnp.maximum(m_cap, 1.0))[:, None])
    n0 = jnp.where(has_any, k_init, 0.0)

    # ---- update path (photon_mapper.rs:55-62)
    m = q.count_r
    n_new = half.photons + alpha * m
    frac = n_new / jnp.maximum(half.photons + m, 1.0)
    r2_new = half.radius2 * frac
    flux_new = (half.flux + pts.bsdf * q.flux_r) * frac[:, None]

    upd = pts.valid & ~first
    flux = jnp.where(first[:, None], flux0,
                     jnp.where(upd[:, None], flux_new, half.flux))
    radius2 = jnp.where(first, r0_2, jnp.where(upd, r2_new, half.radius2))
    photons = jnp.where(first, n0, jnp.where(upd, n_new, half.photons))
    return SPPMHalf(flux, radius2, photons)


# -------------------------------------------------------------- iteration

@functools.partial(jax.jit, static_argnames=(
    "n_photons", "max_photon_bounces", "grid_res", "intersector",
    "query_impl"))
def photon_grids(scene: Scene, key, iteration, *, n_photons,
                 max_photon_bounces, grid_res, photon_t_min, spawn_eps_rel,
                 intersector="auto", query_impl="dense"):
    """Photon pass + both photon maps as ONE device dispatch (fast)."""
    spawn_eps = spawn_eps_rel * scene.scale
    k_ph = jax.random.split(jax.random.fold_in(key, iteration))[0]
    return _photon_maps(
        scene, k_ph, n_photons=n_photons,
        max_photon_bounces=max_photon_bounces, grid_res=grid_res,
        photon_t_min=photon_t_min, spawn_eps=spawn_eps,
        intersector=intersector, query_impl=query_impl)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "max_camera_bounces", "grid_res", "k_per_cell",
    "intersector", "query_chunk", "query_impl"))
def measure_update_block(scene: Scene, glob: SPPMHalf, caus: SPPMHalf,
                         g_grid, c_grid, pixel_ids, key, iteration, *,
                         width, height, max_camera_bounces, grid_res,
                         k_per_cell, alpha, k_global, k_caustic, t_min,
                         spawn_eps_rel, intersector="auto",
                         query_chunk=2048, query_impl="dense"):
    """Measurement + stat update for one pixel block (one dispatch, which
    keeps single-dispatch time and memory bounded for large images)."""
    spawn_eps = spawn_eps_rel * scene.scale
    k_meas = jax.random.split(jax.random.fold_in(key, iteration))[1]
    k_meas = jax.random.fold_in(k_meas, pixel_ids[0])
    pts = measurement_pass(scene, k_meas, pixel_ids, width, height,
                           max_camera_bounces, t_min, spawn_eps, intersector)
    extent = jnp.maximum(scene.bounds_max - scene.bounds_min, 1e-6)
    cap_radius = jnp.min(extent / jnp.asarray(grid_res, jnp.float32))
    # the cap-radius sums only feed the FIRST-touch density init
    # (_update_half's `first` branch); for initialized pixels pass their own
    # (shrinking) radius as the cap so the dense query's chunk cull tightens
    # every iteration — identical results, far fewer live chunks
    rg = jnp.minimum(jnp.sqrt(jnp.maximum(glob.radius2, 0.0)), cap_radius)
    rg = jnp.where(glob.photons > 0, rg, cap_radius)
    cap_g = jnp.where(glob.photons > 0, rg, cap_radius)
    rc = jnp.minimum(jnp.sqrt(jnp.maximum(caus.radius2, 0.0)), cap_radius)
    rc = jnp.where(caus.photons > 0, rc, cap_radius)
    cap_c = jnp.where(caus.photons > 0, rc, cap_radius)
    qg, qc = _sorted_dual_query(
        g_grid, c_grid, grid_res, pts.p, rg, cap_g, rc, cap_c,
        scene.bounds_min, scene.bounds_max, k_per_cell, query_chunk,
        query_impl)
    glob = _update_half(glob, pts, qg, k_global, alpha, cap_radius)
    caus = _update_half(caus, pts, qc, k_caustic, alpha, cap_radius)
    return glob, caus


def sppm_iteration_blocked(scene: Scene, state: SPPMState, key, *,
                           pixel_block: int, **kw) -> SPPMState:
    """Host-orchestrated iteration: one photon dispatch + one dispatch per
    pixel block. Numerically identical state evolution to sppm_iteration up
    to the per-block measurement keys."""
    width, height = kw["width"], kw["height"]
    npix = width * height
    g_grid, c_grid = photon_grids(
        scene, key, state.iteration, n_photons=kw["n_photons"],
        max_photon_bounces=kw["max_photon_bounces"], grid_res=kw["grid_res"],
        photon_t_min=kw["photon_t_min"], spawn_eps_rel=kw["spawn_eps_rel"],
        intersector=kw.get("intersector", "auto"),
        query_impl=kw.get("query_impl", "dense"))
    glob, caus = state.glob, state.caustic
    mu_kw = dict(width=width, height=height,
                 max_camera_bounces=kw["max_camera_bounces"],
                 grid_res=kw["grid_res"], k_per_cell=kw["k_per_cell"],
                 alpha=kw["alpha"], k_global=kw["k_global"],
                 k_caustic=kw["k_caustic"], t_min=kw["t_min"],
                 spawn_eps_rel=kw["spawn_eps_rel"],
                 intersector=kw.get("intersector", "auto"),
                 query_chunk=kw.get("query_chunk", 2048),
                 query_impl=kw.get("query_impl", "dense"))
    # pad so every block has the same (static) width
    blocks = [(lo, min(lo + pixel_block, npix))
              for lo in range(0, npix, pixel_block)]
    g_parts, c_parts = [], []
    for lo, hi in blocks:
        ids = jnp.arange(lo, lo + pixel_block, dtype=jnp.int32)
        ids = jnp.minimum(ids, npix - 1)  # tail pad repeats the last pixel
        gb = SPPMHalf(*[x[lo:lo + pixel_block] if x.shape[0] >= lo + pixel_block
                        else jnp.pad(x[lo:], [(0, lo + pixel_block - npix)]
                                     + [(0, 0)] * (x.ndim - 1))
                        for x in glob])
        cb = SPPMHalf(*[x[lo:lo + pixel_block] if x.shape[0] >= lo + pixel_block
                        else jnp.pad(x[lo:], [(0, lo + pixel_block - npix)]
                                     + [(0, 0)] * (x.ndim - 1))
                        for x in caus])
        gb2, cb2 = measure_update_block(
            scene, gb, cb, g_grid, c_grid, ids, key, state.iteration, **mu_kw)
        g_parts.append(jax.tree_util.tree_map(lambda x: x[:hi - lo], gb2))
        c_parts.append(jax.tree_util.tree_map(lambda x: x[:hi - lo], cb2))
    glob = SPPMHalf(*[jnp.concatenate(xs) for xs in zip(*g_parts)])
    caus = SPPMHalf(*[jnp.concatenate(xs) for xs in zip(*c_parts)])
    return SPPMState(glob, caus, state.iteration + 1)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "n_photons", "max_photon_bounces",
    "max_camera_bounces", "grid_res", "k_per_cell", "intersector",
    "query_chunk", "query_impl"))
def sppm_iteration(scene: Scene, state: SPPMState, key, *, width, height,
                   n_photons, max_photon_bounces, max_camera_bounces,
                   grid_res, k_per_cell, alpha, k_global, k_caustic,
                   t_min, photon_t_min, spawn_eps_rel, intersector="auto",
                   query_chunk=2048, query_impl="dense") -> SPPMState:
    npix = width * height
    spawn_eps = spawn_eps_rel * scene.scale
    k_ph, k_meas = jax.random.split(jax.random.fold_in(key, state.iteration))

    # 1+2. photon pass + maps (SoA components + plane packing on the
    #      dense path; PhotonGrid on the grid path)
    g_grid, c_grid = _photon_maps(
        scene, k_ph, n_photons=n_photons,
        max_photon_bounces=max_photon_bounces, grid_res=grid_res,
        photon_t_min=photon_t_min, spawn_eps=spawn_eps,
        intersector=intersector, query_impl=query_impl)

    # 3. measurement pass
    pixel_ids = jnp.arange(npix, dtype=jnp.int32)
    pts = measurement_pass(scene, k_meas, pixel_ids, width, height,
                           max_camera_bounces, t_min, spawn_eps, intersector)

    # 4. stat updates; query radius capped at one grid cell
    extent = jnp.maximum(scene.bounds_max - scene.bounds_min, 1e-6)
    cap_radius = jnp.min(extent / jnp.asarray(grid_res, jnp.float32))
    # per-point cap = own radius once initialized (cap sums only feed the
    # first-touch init; tightens the query's chunk cull every iteration)
    rg = jnp.minimum(jnp.sqrt(jnp.maximum(state.glob.radius2, 0.0)), cap_radius)
    rg = jnp.where(state.glob.photons > 0, rg, cap_radius)
    rc = jnp.minimum(jnp.sqrt(jnp.maximum(state.caustic.radius2, 0.0)), cap_radius)
    rc = jnp.where(state.caustic.photons > 0, rc, cap_radius)
    qg, qc = _sorted_dual_query(
        g_grid, c_grid, grid_res, pts.p, rg,
        jnp.where(state.glob.photons > 0, rg, cap_radius), rc,
        jnp.where(state.caustic.photons > 0, rc, cap_radius),
        scene.bounds_min, scene.bounds_max, k_per_cell, query_chunk,
        query_impl)
    glob = _update_half(state.glob, pts, qg, k_global, alpha, cap_radius)
    caus = _update_half(state.caustic, pts, qc, k_caustic, alpha,
                        cap_radius)

    return SPPMState(glob, caus, state.iteration + 1)


# ----------------------------------------------------------- final gather

def density_estimates(state: SPPMState, n_total_photons) -> jnp.ndarray:
    """Per-pixel caustic+global radiance estimates flux/(pi r^2 N_total)
    (photon_mapper.rs:117-119). (npix, 3)."""
    inv = 1.0 / jnp.float32(n_total_photons)
    rad_g = state.glob.flux / (
        PI * jnp.maximum(state.glob.radius2, 1e-12)[:, None]) * inv
    rad_c = state.caustic.flux / (
        PI * jnp.maximum(state.caustic.radius2, 1e-12)[:, None]) * inv
    rad_g = jnp.where((state.glob.photons > 0)[:, None], rad_g, 0.0)
    rad_c = jnp.where((state.caustic.photons > 0)[:, None], rad_c, 0.0)
    return rad_g + rad_c


def gather_walk(scene: Scene, o, d, est_rep, k_walk, *, max_depth, t_min,
                spawn_eps, intersector):
    """The sample_ray specular walk (photon_mapper.rs:326-365) for one
    wavefront: Le at EVERY hit, the lane's density estimate at the first
    Diffuse hit, Reflect/Refract/Specular chains multiply throughput.
    Returns (radiance (N,3), rays ())."""
    if _soa_eligible(scene, intersector):
        from raytracer.models.wavefront_soa import gather_walk_soa
        from raytracer.ops.dispatch import _resolve
        return gather_walk_soa(scene, o, d, est_rep, k_walk,
                               max_depth=max_depth, t_min=t_min,
                               spawn_eps=spawn_eps,
                               intersector=_resolve(scene, intersector))

    class S(NamedTuple):
        o: jnp.ndarray
        d: jnp.ndarray
        throughput: jnp.ndarray
        radiance: jnp.ndarray
        alive: jnp.ndarray
        bounce: jnp.ndarray
        rays: jnp.ndarray

    def cond(s):
        return (s.bounce < max_depth) & jnp.any(s.alive)

    def body(s: S):
        k = jax.random.fold_in(k_walk, s.bounce)
        attrs = hit_and_attrs(scene, k, s.o, s.d, t_min, intersector,
                              alive=s.alive)
        sc = mat_ops.scatter(scene, jax.random.uniform(
            k, (3, s.d.shape[0])), s.d, attrs)
        live = s.alive & attrs.valid
        # Le at every hit (photon_mapper.rs:341)
        radiance = s.radiance + jnp.where(
            live[:, None], s.throughput * sc.emitted, 0.0)
        diffuse_now = live & (sc.interaction == INTER_DIFFUSE)
        # density estimates at the first diffuse hit, then stop
        radiance = radiance + jnp.where(
            diffuse_now[:, None], s.throughput * est_rep, 0.0)
        cont = live & ~diffuse_now & (sc.interaction != INTER_ABSORB)
        throughput = jnp.where(cont[:, None],
                               s.throughput * sc.attenuation,
                               s.throughput)
        o2 = jnp.where(cont[:, None],
                       spawn_origin(attrs.p, attrs.normal, sc.direction,
                                    spawn_eps), s.o)
        d2 = jnp.where(cont[:, None], sc.direction, s.d)
        return S(o2, d2, throughput, radiance, cont, s.bounce + 1,
                 s.rays + jnp.sum(s.alive))

    alive0 = o[:, 0] == o[:, 0]
    init = S(o, d, jnp.ones_like(o), jnp.zeros_like(o), alive0,
             jnp.int32(0), jnp.sum(jnp.zeros_like(o[:, 0], jnp.int32)))
    out = jax.lax.while_loop(cond, body, init)
    # out.rays already counts bounce-0 intersections (= the primaries)
    return out.radiance, out.rays


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "spp", "spp_chunk", "max_depth", "intersector"))
def gather_fn(scene: Scene, state: SPPMState, key, *, width, height, spp,
              spp_chunk, max_depth, t_min, spawn_eps_rel, n_total_photons,
              intersector="auto"):
    """Final render using the accumulated per-pixel stats (sample_ray,
    photon_mapper.rs:326-365)."""
    npix = width * height
    spawn_eps = spawn_eps_rel * scene.scale
    est = density_estimates(state, n_total_photons)

    n_chunks = -(-spp // spp_chunk)
    pixel_ids = jnp.broadcast_to(
        jnp.arange(npix, dtype=jnp.int32)[None], (spp_chunk, npix)).reshape(-1)
    est_rep = jnp.broadcast_to(est[None], (spp_chunk, npix, 3)).reshape(-1, 3)

    # Path-regeneration fast path (see wavefront_soa.gather_regen_soa):
    # the depth-50 specular walk retires most lanes after a few bounces;
    # regeneration refills them with the pixel's next sample.
    if _soa_eligible(scene, intersector):
        from raytracer.models.wavefront_soa import gather_regen_soa
        from raytracer.ops.dispatch import _resolve
        accum, rays, _steps = gather_regen_soa(
            scene, est, key, width=width, height=height,
            lanes_per_pixel=spp_chunk, samples_per_lane=n_chunks,
            max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
            intersector=_resolve(scene, intersector))
        img = accum / (n_chunks * spp_chunk)
        return img.reshape(height, width, 3), rays

    def chunk(i, carry):
        accum, rays = carry
        k_cam = jax.random.fold_in(jax.random.fold_in(key, 17), i)
        k_walk = jax.random.fold_in(jax.random.fold_in(key, 19), i)
        o, d = camera_rays(scene.camera, k_cam, pixel_ids, width, height)
        radiance, r = gather_walk(scene, o, d, est_rep, k_walk,
                                  max_depth=max_depth, t_min=t_min,
                                  spawn_eps=spawn_eps, intersector=intersector)
        rad = radiance.reshape(spp_chunk, npix, 3).sum(axis=0)
        return accum + rad, rays + r

    accum, rays = jax.lax.fori_loop(
        0, n_chunks, chunk, (jnp.zeros((npix, 3), jnp.float32), jnp.int32(0)))
    img = accum / (n_chunks * spp_chunk)
    return img.reshape(height, width, 3), rays


# -------------------------------------------------------------- top level

def gather_batching(config: "RenderConfig", npix: int):
    """(host_spp_batch, spp_chunk budget) for the final gather — shared by
    render, warm_render_programs, and the breakdown harness so they drive
    identical static shapes. ``batch`` is the largest divisor of
    samples_per_pixel under both the host cap and a ~16M-lane budget per
    dispatch (a non-divisor would cost a second full gather compile for the
    remainder dispatch); the chunk budget caps a wavefront at ~1.5M lanes.
    Both lane budgets are not yet measured on the GPU."""
    total = config.samples_per_pixel
    lane_budget = max(1, 16_000_000 // npix)
    batch = max(1, min(config.host_spp_batch, total, lane_budget))
    for d in range(batch, 0, -1):
        if total % d == 0:
            batch = d
            break
    return batch, max(1, 1_500_000 // npix)


def warm_render_programs(scene: Scene, config: RenderConfig, key):
    """Compile-warm the EXACT programs ``render`` dispatches (blocked or
    unblocked iteration + one final-gather batch at render's static
    shapes) against a throwaway state. Benchmarks call this so the
    full-workload number measures sustained throughput, not the one-time
    XLA compiles the reference binary has no analog of."""
    sp: SPPMConfig = config.sppm
    npix = config.width * config.height
    grid_res, _ = pg.choose_grid_resolution(
        scene.bounds_min, scene.bounds_max, sp.photons_per_iter, sp.k_global)
    kw = dict(
        width=config.width, height=config.height,
        n_photons=sp.photons_per_iter,
        max_photon_bounces=sp.max_photon_bounces,
        max_camera_bounces=sp.max_camera_bounces,
        grid_res=grid_res, k_per_cell=sp.max_photons_per_cell,
        alpha=sp.alpha, k_global=sp.k_global, k_caustic=sp.k_caustic,
        t_min=config.t_min, photon_t_min=1e-4,
        spawn_eps_rel=config.spawn_eps_rel,
        intersector=config.intersector, query_impl=sp.query_impl)
    st = init_state(npix)
    if npix > sp.pixel_block:
        st = sppm_iteration_blocked(scene, st, key,
                                    pixel_block=sp.pixel_block, **kw)
    else:
        st = sppm_iteration(scene, st, key, **kw)
    jax.block_until_ready(st.glob.flux)
    batch, chunk_budget = gather_batching(config, npix)
    spp = min(batch, config.samples_per_pixel)
    img, _ = gather_fn(
        scene, st, key, width=config.width, height=config.height, spp=spp,
        spp_chunk=max(1, min(config.spp_chunk, spp, chunk_budget)),
        max_depth=config.max_depth, t_min=config.t_min,
        spawn_eps_rel=config.spawn_eps_rel,
        n_total_photons=sp.n_iterations * sp.photons_per_iter,
        intersector=config.intersector)
    jax.block_until_ready(img)


def render(scene: Scene, config: RenderConfig, key,
           state: Optional[SPPMState] = None,
           checkpoint_cb=None) -> Tuple:
    """Full SPPM render: iterations + final gather. ``checkpoint_cb(state)``
    (if given) is called after every iteration with the current state."""
    sp: SPPMConfig = config.sppm
    if scene.lights.kind.shape[0] == 0:
        raise ValueError(
            "SPPM requires at least one light in the scene (photon emission "
            "has nothing to sample); use --integrator pt for light-free "
            "scenes")
    if scene.spheres.motion_marker.shape[0]:
        raise ValueError(
            "SPPM does not support motion blur (photon/visible-point maps "
            "have no shutter-time dimension — the whole iteration would "
            "silently freeze at t=0); use --integrator pt, which draws "
            "per-sample shutter times")
    npix = config.width * config.height
    if state is None:
        state = init_state(npix)
    grid_res, _ = pg.choose_grid_resolution(
        scene.bounds_min, scene.bounds_max, sp.photons_per_iter, sp.k_global)

    kw = dict(
        width=config.width, height=config.height,
        n_photons=sp.photons_per_iter,
        max_photon_bounces=sp.max_photon_bounces,
        max_camera_bounces=sp.max_camera_bounces,
        grid_res=grid_res, k_per_cell=sp.max_photons_per_cell,
        alpha=sp.alpha, k_global=sp.k_global, k_caustic=sp.k_caustic,
        t_min=config.t_min, photon_t_min=1e-4,
        spawn_eps_rel=config.spawn_eps_rel,
        intersector=config.intersector, query_impl=sp.query_impl)
    blocked = npix > sp.pixel_block
    start = int(state.iteration)
    from raytracer.utils.timing import Progress
    prog = Progress(total=sp.n_iterations, label="sppm iter")
    if start:
        prog.tick(start)  # resumed from a checkpoint
    for _ in range(start, sp.n_iterations):
        if blocked:
            state = sppm_iteration_blocked(scene, state, key,
                                           pixel_block=sp.pixel_block, **kw)
        else:
            state = sppm_iteration(scene, state, key, **kw)
        if checkpoint_cb is not None:
            checkpoint_cb(state)
        if prog.enabled or checkpoint_cb is not None:
            # sync only when someone observes per-iteration timing; piped
            # runs keep async dispatch pipelined across iterations
            jax.block_until_ready(state.glob.flux)
        prog.tick(1)

    # final gather, host-batched like path_tracer.render. The depth-50
    # specular walk is long-tailed, so the per-dispatch lane count is
    # bounded too (gather_batching).
    n_total = sp.n_iterations * sp.photons_per_iter
    total = config.samples_per_pixel
    batch, chunk_budget = gather_batching(config, npix)
    done, i, rays_total, accum = 0, 0, 0, None
    prog = Progress(total=total, label="gather spp")
    while done < total:
        spp = min(batch, total - done)
        img, rays = gather_fn(
            scene, state, jax.random.fold_in(jax.random.fold_in(key, 23), i),
            width=config.width, height=config.height, spp=spp,
            spp_chunk=max(1, min(config.spp_chunk, spp, chunk_budget)),
            max_depth=config.max_depth, t_min=config.t_min,
            spawn_eps_rel=config.spawn_eps_rel, n_total_photons=n_total,
            intersector=config.intersector)
        w = spp / total
        accum = img * w if accum is None else accum + img * w
        rays_total += int(rays)
        done += spp
        i += 1
        prog.tick(spp, rays=int(rays))
    return accum, rays_total, state
