"""Wavefront path tracer — the framework's flagship integrator.

The reference's per-pixel recursive walk (photon_mapper.rs:326-365, depth cap
50) becomes a batched ``lax.while_loop`` over a dense ray wavefront: every
live lane advances one bounce per iteration, dead lanes are masked (on a
lockstep vector machine masking is free; compaction would force dynamic
shapes). Radiance/throughput are per-lane registers.

Semantics:
- emission is accumulated at EVERY hit (radiance += throughput * Le), the
  reference's behavior at photon_mapper.rs:341;
- Reflect/Refract/Specular multiply throughput by the scatter attenuation
  and continue (photon_mapper.rs:353-357);
- Diffuse: in "pt" mode the walk continues (standard path tracing — used
  for the data/*.json scenes the reference ships but cannot load); in SPPM
  mode the walk is terminated by the caller (see models/sppm.py);
- Absorb/miss kills the lane; background is black (the reference adds
  nothing on miss — its loop just ends).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer.models.camera import camera_rays
from raytracer.ops import materials as mat_ops
from raytracer.ops import vec
from raytracer.scene.types import INTER_ABSORB, INTER_DIFFUSE, Scene
from raytracer.utils.config import RenderConfig


class TraceResult(NamedTuple):
    radiance: jnp.ndarray    # (N, 3)
    rays_traced: jnp.ndarray  # () total executed ray-bounce intersections


def spawn_origin(p, normal, new_dir, eps):
    """Offset the next ray origin along the geometric normal to avoid f32
    self-intersection (the reference leans on f64 + t_min=1e-3 instead;
    see SURVEY.md §7 hard-part 4)."""
    side = jnp.sign(vec.dot(new_dir, normal))
    return p + normal * (eps * side)[:, None]


def hit_and_attrs(scene: Scene, key, o, d, t_min, intersector: str,
                  time=None, alive=None):
    """Geometry hit + attributes + stochastic medium override (one bounce's
    deterministic-then-volumetric intersection; medium.rs semantics)."""
    from raytracer.ops.dispatch import intersect_and_attrs
    _, attrs = intersect_and_attrs(scene, o, d, t_min, jnp.inf, intersector,
                                   time=time, alive=alive)
    if scene.media is not None and scene.media.kind.shape[0]:
        from raytracer.ops.media import apply_media
        attrs = apply_media(scene.media, jax.random.fold_in(key, 29), o, d,
                            attrs, t_min)
    return attrs


RR_START_BOUNCE = 3  # Russian roulette kicks in after this many bounces


def trace_radiance(scene: Scene, o, d, key, *, max_depth: int, t_min: float,
                   spawn_eps, intersector: str = "auto",
                   time=None, russian_roulette: bool = True,
                   nee: bool = False, mis: bool = False) -> TraceResult:
    """Trace a wavefront of rays to completion; returns per-ray radiance.
    ``time`` (N,) enables motion blur: scattered rays inherit their primary
    ray's shutter time (book-2 semantics).

    ``russian_roulette``: unbiased path termination with survival
    probability max(throughput) after RR_START_BOUNCE bounces (the
    reference's PT-analog walk has no RR and relies on the depth cap,
    photon_mapper.rs:334 — RR preserves the image in expectation while
    cutting dead-weight lanes on deep paths, a large wavefront win).

    ``nee``: next-event estimation — at every diffuse vertex a shadow ray
    samples each light directly (ops/nee.py::direct_light), and emission is
    skipped on rays that left a diffuse vertex so light is counted exactly
    once. Same mean as plain PT, lower variance on direct-lit scenes
    (light.rs:107-124 is the reference's never-called analog).

    Retired lanes stay in place but are passed to the intersection kernel
    as ``alive`` so they contribute no traversal work.

    ``mis``: book-3 mixture-PDF importance sampling (extension; see
    ops/mis.py) — diffuse vertices sample a 50/50 cosine/light-direction
    mixture and reweight throughput by pdf_cos/pdf_mix. Mutually exclusive
    with ``nee`` (both are variance reducers for direct light); runs on
    the SoA fast path too (wavefront_soa._mis_bounce — the reweight is
    elementwise, so ``--mis`` keeps the production regen wavefront)."""
    if mis and nee:
        raise ValueError("--mis and --nee are mutually exclusive")
    n = o.shape[0]

    # SoA fast path: all wavefront state as (N,) components
    # (models/wavefront_soa.py). Same semantics, same key streams; media
    # ride it too (the free-flight override is elementwise).
    from raytracer.ops.dispatch import SOA_METHODS, _resolve
    method = _resolve(scene, intersector, has_time=time is not None)
    if method in SOA_METHODS:
        from raytracer.models.wavefront_soa import trace_radiance_soa
        radiance, rays = trace_radiance_soa(
            scene, o, d, key, max_depth=max_depth, t_min=t_min,
            spawn_eps=spawn_eps, intersector=method,
            russian_roulette=russian_roulette, nee=nee, mis=mis, time=time)
        return TraceResult(radiance, rays)

    class S(NamedTuple):
        bounce: jnp.ndarray
        o: jnp.ndarray
        d: jnp.ndarray
        throughput: jnp.ndarray
        radiance: jnp.ndarray
        alive: jnp.ndarray
        prev_diffuse: jnp.ndarray
        rays: jnp.ndarray

    def cond(s: S):
        return (s.bounce < max_depth) & jnp.any(s.alive)

    def body(s: S):
        k = jax.random.fold_in(key, s.bounce)
        # one batched uniform draw per step: rows 0-2 scatter, row 3 RR
        # (same layout as wavefront_soa's trace loop — the stream-identity
        # pair). hit_and_attrs keeps k for the media free-flight draws.
        U = jax.random.uniform(k, (4, n))
        attrs = hit_and_attrs(scene, k, s.o, s.d, t_min, intersector,
                              time=time, alive=s.alive)
        sc = mat_ops.scatter(scene, U[:3], s.d, attrs)

        live = s.alive & attrs.valid
        # with NEE, emission along diffuse-scattered rays was already
        # counted by the shadow ray at the previous vertex
        emit_ok = live & ~s.prev_diffuse
        radiance = s.radiance + jnp.where(
            emit_ok[:, None], s.throughput * sc.emitted, 0.0)

        diffuse_now = live & (sc.interaction == INTER_DIFFUSE)
        if nee:
            from raytracer.ops.nee import direct_light
            dl = direct_light(scene, jax.random.fold_in(k, 53), attrs.p,
                              attrs.normal, sc.attenuation, diffuse_now,
                              intersector=intersector, alive=s.alive,
                              time=time)
            radiance = radiance + jnp.where(
                diffuse_now[:, None], s.throughput * dl, 0.0)

        if mis:
            from raytracer.ops.mis import mixture_reweight
            d_mis, w_mis = mixture_reweight(
                scene, jax.random.fold_in(k, 61), attrs.p, attrs.normal,
                sc.direction, diffuse_now, time=time)
            direction = jnp.where(diffuse_now[:, None], d_mis, sc.direction)
            attenuation = sc.attenuation * w_mis[:, None]
        else:
            direction = sc.direction
            attenuation = sc.attenuation
        cont = live & (sc.interaction != INTER_ABSORB)
        throughput = jnp.where(cont[:, None],
                               s.throughput * attenuation, s.throughput)
        if russian_roulette:
            p_surv = jnp.clip(jnp.max(throughput, axis=-1), 0.05, 1.0)
            do_rr = s.bounce >= RR_START_BOUNCE
            u = U[3]
            survive = ~do_rr | (u < p_surv)
            throughput = jnp.where((do_rr & cont & survive)[:, None],
                                   throughput / p_surv[:, None], throughput)
            cont = cont & survive
        new_o = spawn_origin(attrs.p, attrs.normal, direction, spawn_eps)
        o2 = jnp.where(cont[:, None], new_o, s.o)
        d2 = jnp.where(cont[:, None], direction, s.d)
        prev_diffuse = diffuse_now if nee else s.prev_diffuse
        return S(s.bounce + 1, o2, d2, throughput, radiance, cont,
                 prev_diffuse, s.rays + jnp.sum(s.alive))

    # Derive the initial carry from the ray arrays so that under shard_map
    # every component carries the same varying-manual-axes type as the loop
    # outputs (jax>=0.8 VMA check); origins are finite by construction.
    init = S(jnp.int32(0), o, d,
             jnp.ones_like(o), jnp.zeros_like(o),
             o[:, 0] == o[:, 0],
             o[:, 0] != o[:, 0],
             jnp.sum(jnp.zeros_like(o[:, 0], jnp.int32)))
    out = jax.lax.while_loop(cond, body, init)
    return TraceResult(out.radiance, out.rays)


@functools.partial(jax.jit, static_argnames=(
    "width", "height", "spp", "spp_chunk", "max_depth", "intersector",
    "russian_roulette", "nee", "mis"))
def render_fn(scene: Scene, key, *, width: int, height: int, spp: int,
              spp_chunk: int, max_depth: int, t_min: float,
              spawn_eps_rel: float, intersector: str = "auto",
              russian_roulette: bool = True, nee: bool = False,
              mis: bool = False):
    """Render the full image: fori_loop over sample chunks, each chunk a
    (H*W*spp_chunk)-ray wavefront. Returns ((H,W,3) linear image, rays)."""
    npix = width * height
    n_chunks = -(-spp // spp_chunk)
    pixel_ids = jnp.broadcast_to(
        jnp.arange(npix, dtype=jnp.int32)[None, :], (spp_chunk, npix)).reshape(-1)
    spawn_eps = spawn_eps_rel * scene.scale

    # Path-regeneration fast path: one while_loop where retired lanes spawn
    # their pixel's next sample instead of idling (wavefront_soa.
    # render_regen_soa); the fori_loop of fixed-depth wavefronts below is
    # the AoS reference.
    from raytracer.ops.dispatch import SOA_METHODS, _resolve
    # has_time=True: the regen wavefront draws per-sample shutter times
    # itself when the scene moves, so moving scenes ride it too
    method = _resolve(scene, intersector, has_time=True)
    if method in SOA_METHODS:
        from raytracer.models.wavefront_soa import render_regen_soa
        accum, rays, _steps = render_regen_soa(
            scene, key, width=width, height=height,
            lanes_per_pixel=spp_chunk, samples_per_lane=n_chunks,
            max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
            intersector=method, russian_roulette=russian_roulette, nee=nee,
            mis=mis)
        img = accum / (n_chunks * spp_chunk)
        return img.reshape(height, width, 3), rays

    def chunk(i, carry):
        accum, rays = carry
        k_cam = jax.random.fold_in(jax.random.fold_in(key, 7), i)
        k_trace = jax.random.fold_in(jax.random.fold_in(key, 11), i)
        o, d = camera_rays(scene.camera, k_cam, pixel_ids, width, height)
        time = None
        if scene.spheres.motion_marker.shape[0]:
            cam = scene.camera
            time = cam.time0 + jax.random.uniform(
                jax.random.fold_in(k_cam, 31), (o.shape[0],)) * (cam.time1 - cam.time0)
        res = trace_radiance(
            scene, o, d, k_trace, max_depth=max_depth, t_min=t_min,
            spawn_eps=spawn_eps, intersector=intersector, time=time,
            russian_roulette=russian_roulette, nee=nee, mis=mis)
        # rays metric = intersection calls executed; bounce 0 (all lanes
        # alive on entry) already counts the primary rays — do not add them
        # again.
        rad = res.radiance.reshape(spp_chunk, npix, 3).sum(axis=0)
        return accum + rad, rays + res.rays_traced

    accum, rays = jax.lax.fori_loop(
        0, n_chunks, chunk, (jnp.zeros((npix, 3), jnp.float32), jnp.int32(0)))
    img = accum / (n_chunks * spp_chunk)
    return img.reshape(height, width, 3), rays


@jax.jit
def _accum_batch(accum, img, w):
    """One fused device op per host batch: weighted image accumulate
    (one dispatch instead of several eager ops per batch)."""
    return accum + img * w


def render(scene: Scene, config: RenderConfig, key) -> tuple:
    """Convenience wrapper: returns ((H,W,3) linear image, ray count).
    Splits the sample budget into host-side dispatch batches of
    ``config.host_spp_batch`` (long single dispatches can trip the device)."""
    total = config.samples_per_pixel
    npix = config.width * config.height
    batch = max(1, min(config.host_spp_batch, total))
    # keep wavefronts under ~1.5M lanes (a cap not yet measured on the
    # GPU)
    spp_chunk = max(1, min(config.spp_chunk, batch,
                           max(1, 1_500_000 // npix)))
    n_batches = -(-total // batch)
    # All per-batch keys in ONE device dispatch (vs one eager fold_in
    # each). The table size is a fixed 256 (unless more batches are
    # needed) so the program shape — and hence its compile — does not
    # depend on samples_per_pixel: a small warm render then compiles
    # every program a long timed render will dispatch.
    keys = jax.vmap(lambda i: jax.random.fold_in(key, 1000 + i))(
        jnp.arange(max(256, n_batches)))
    done = 0
    accum = jnp.zeros((config.height, config.width, 3), jnp.float32)
    batch_rays = []   # int32 per batch; summed on HOST (the total can
    i = 0             # exceed int32 at 1000-spp scale)
    from raytracer.utils.timing import Progress
    prog = Progress(total=total, label="pt spp")
    while done < total:
        spp = min(batch, total - done)
        img, rays = render_fn(
            scene, keys[i], width=config.width,
            height=config.height, spp=spp, spp_chunk=min(spp_chunk, spp),
            max_depth=config.max_depth, t_min=config.t_min,
            spawn_eps_rel=config.spawn_eps_rel,
            intersector=config.intersector,
            russian_roulette=config.russian_roulette,
            nee=config.nee, mis=config.mis)
        accum = _accum_batch(accum, img, spp / total)
        batch_rays.append(rays)
        done += spp
        i += 1
        # rays shown only when the progress line renders (device sync)
        prog.tick(spp, rays=int(rays) if prog.enabled else 0.0)
    return accum, sum(int(r) for r in batch_rays)
