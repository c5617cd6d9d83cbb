"""Multi-chip render executor: shard_map over a ("px", "spp") device mesh.

The reference's execution model is a thread pool over contiguous image row
bands with mpsc result channels (camera.rs:66-128, SURVEY.md §2.24). The
device equivalent is a 2-D mesh:

- axis "px": data parallelism over pixels (each chip owns a pixel shard —
  the row-band analog, but load-balanced by construction since shards are
  interleaved only in flat pixel order);
- axis "spp": sample parallelism — chips along this axis render the same
  pixels with disjoint RNG streams and combine via ``psum`` (the
  mpsc-channel analog is an XLA collective, not a host channel).

The scene is replicated (it is tiny next to device memory); the image never
leaves the devices until the host save. Every card reaches every other at
the same rate, so the mesh shape follows the algorithm alone.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from raytracer.models.camera import camera_rays
from raytracer.models.path_tracer import trace_radiance
from raytracer.scene.types import Scene
from raytracer.utils.config import RenderConfig


def make_mesh(n_px: Optional[int] = None, n_spp: int = 1,
              devices=None) -> Mesh:
    """A ("px", "spp") mesh. Defaults to all devices on the px axis."""
    devices = list(devices if devices is not None else jax.devices())
    if n_px is None:
        n_px = len(devices) // n_spp
    assert n_px * n_spp == len(devices), (
        f"mesh {n_px}x{n_spp} != {len(devices)} devices")
    arr = np.asarray(devices).reshape(n_px, n_spp)
    return Mesh(arr, ("px", "spp"))


@functools.partial(
    jax.jit,
    static_argnames=("mesh", "width", "height", "spp", "spp_chunk",
                     "max_depth", "intersector", "nee"))
def render_sharded_fn(scene: Scene, key, *, mesh: Mesh, width: int,
                      height: int, spp: int, spp_chunk: int, max_depth: int,
                      t_min: float, spawn_eps_rel: float,
                      intersector: str = "auto", nee: bool = False):
    """Render the image across the mesh. Returns ((H,W,3) image, rays)."""
    n_px = mesh.shape["px"]
    n_spp = mesh.shape["spp"]
    npix = width * height
    # pad the flat pixel axis to a multiple of the px shards
    npix_pad = -(-npix // n_px) * n_px
    pixel_ids = jnp.arange(npix_pad, dtype=jnp.int32)
    # samples per chip on the spp axis, in chunks
    spp_local = -(-spp // n_spp)
    chunk = max(1, min(spp_chunk, spp_local))
    n_chunks = -(-spp_local // chunk)
    spawn_eps = spawn_eps_rel * scene.scale

    # Path-regeneration fast path per shard (same machinery as the
    # single-chip render_fn: regen + drain-compaction cascade): each chip
    # runs one regenerating wavefront over its BLOCK-PERMUTED pixel shard
    # (whole 16x16 blocks land on one chip, preserving the kernel's
    # block-cull coherence). Eligibility mirrors render_fn's (static).
    from raytracer.ops.dispatch import SOA_METHODS, _resolve
    # has_time=True: render_regen_soa draws per-sample shutter times itself
    # when the scene moves, so moving scenes ride the regen path
    # (mirrors models/path_tracer.render_fn)
    method = _resolve(scene, intersector, has_time=True)
    if (method in SOA_METHODS
            and (scene.media is None or not scene.media.kind.shape[0])):
        from raytracer.models.wavefront_soa import (
            block_order, render_regen_soa)
        perm, inv = block_order(width, height)
        perm_pad = np.concatenate(
            [perm, np.full(npix_pad - npix, npix - 1, perm.dtype)])
        slots = jnp.asarray(perm_pad)

        def shard_fn(scene_rep, key_rep, slots_shard):
            px_i = jax.lax.axis_index("px")
            spp_i = jax.lax.axis_index("spp")
            dev_key = jax.random.fold_in(
                jax.random.fold_in(key_rep, px_i), spp_i)
            accum, rays, _steps = render_regen_soa(
                scene_rep, dev_key, width=width, height=height,
                lanes_per_pixel=chunk, samples_per_lane=n_chunks,
                max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
                intersector=method, nee=nee, pixel_slots=slots_shard)
            accum = jax.lax.psum(accum, "spp")
            rays = jax.lax.psum(rays, ("px", "spp"))
            return accum, rays

        accum, rays = shard_map(
            shard_fn, mesh=mesh,
            in_specs=(P(), P(), P("px")),
            out_specs=(P("px"), P()),
            check_vma=False,
        )(scene, key, slots)
        img = accum[jnp.asarray(inv)] / (n_chunks * chunk * n_spp)
        return img.reshape(height, width, 3), rays[0] if rays.ndim else rays

    def shard_fn(scene_rep, key_rep, ids_shard):
        px_i = jax.lax.axis_index("px")
        spp_i = jax.lax.axis_index("spp")
        dev_key = jax.random.fold_in(jax.random.fold_in(key_rep, px_i), spp_i)
        n_local = ids_shard.shape[0]
        ids_rep = jnp.broadcast_to(ids_shard[None, :], (chunk, n_local)).reshape(-1)

        def chunk_body(i, carry):
            accum, rays = carry
            k_cam = jax.random.fold_in(jax.random.fold_in(dev_key, 7), i)
            k_trace = jax.random.fold_in(jax.random.fold_in(dev_key, 11), i)
            o, d = camera_rays(scene_rep.camera, k_cam, ids_rep, width, height)
            time = None
            if scene_rep.spheres.motion_marker.shape[0]:
                # per-ray shutter times (render_fn fallback parity) — without
                # them moving spheres would silently freeze at t=0
                cam = scene_rep.camera
                time = cam.time0 + jax.random.uniform(
                    jax.random.fold_in(k_cam, 31),
                    (o.shape[0],)) * (cam.time1 - cam.time0)
            res = trace_radiance(
                scene_rep, o, d, k_trace, max_depth=max_depth, t_min=t_min,
                spawn_eps=spawn_eps, intersector=intersector, nee=nee,
                time=time)
            rad = res.radiance.reshape(chunk, n_local, 3).sum(axis=0)
            # rays metric = intersections executed; bounce 0 already counts
            # the primaries (same fix as models/path_tracer.py)
            return accum + rad, rays + res.rays_traced

        # mark the fold accumulators as varying over the mesh axes (the
        # jax>=0.8 VMA checker requires loop carries to match the outputs)
        init = (jnp.zeros((n_local, 3), jnp.float32), jnp.int32(0))
        if hasattr(jax.lax, "pcast"):
            init = jax.tree_util.tree_map(
                lambda x: jax.lax.pcast(x, ("px", "spp"), to="varying"), init)
        elif hasattr(jax.lax, "pvary"):  # pragma: no cover
            init = jax.tree_util.tree_map(
                lambda x: jax.lax.pvary(x, ("px", "spp")), init)
        accum, rays = jax.lax.fori_loop(0, n_chunks, chunk_body, init)
        # combine sample-axis partials
        accum = jax.lax.psum(accum, "spp")
        rays = jax.lax.psum(rays, ("px", "spp"))
        return accum, rays

    accum, rays = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P("px")),
        out_specs=(P("px"), P()),
        # pallas_call outputs have no VMA annotation; replication of `rays`
        # is guaranteed by the psum over both axes above
        check_vma=False,
    )(scene, key, pixel_ids)

    img = accum[:npix] / (n_chunks * chunk * n_spp)
    return img.reshape(height, width, 3), rays[0] if rays.ndim else rays


def render(scene: Scene, config: RenderConfig, key, mesh: Optional[Mesh] = None):
    if mesh is None:
        mesh = make_mesh()
    return render_sharded_fn(
        scene, key, mesh=mesh, width=config.width, height=config.height,
        spp=config.samples_per_pixel, spp_chunk=config.spp_chunk,
        max_depth=config.max_depth, t_min=config.t_min,
        spawn_eps_rel=config.spawn_eps_rel, intersector=config.intersector,
        nee=config.nee)
