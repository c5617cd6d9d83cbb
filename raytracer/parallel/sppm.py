"""Multi-chip SPPM: photon all_gather + pixel-sharded measurement/update.

The communication design (SURVEY.md §5.8): each chip traces
photons_per_iter / n_devices photons with a device-unique key, the deposit
arrays are all_gathered (a few hundred MB/iter at reference scale —
trivially replicable), every chip builds identical photon grids, and the
per-pixel SPPM state lives SHARDED over the "px" axis — it is never
communicated at all. Final gather reuses parallel/render.py's machinery with
the per-pixel estimates riding alongside the sharded pixel ids.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from raytracer.models import sppm as sppm_model
from raytracer.models.camera import camera_rays
from raytracer.ops import photon_grid as pg
from raytracer.scene.types import Scene


@functools.partial(jax.jit, static_argnames=(
    "mesh", "width", "height", "n_photons", "max_photon_bounces",
    "max_camera_bounces", "grid_res", "k_per_cell", "intersector",
    "query_chunk", "query_impl"))
def sppm_iteration_sharded(scene: Scene, state, key, *, mesh: Mesh, width,
                           height, n_photons, max_photon_bounces,
                           max_camera_bounces, grid_res, k_per_cell, alpha,
                           k_global, k_caustic, t_min, photon_t_min,
                           spawn_eps_rel, intersector="auto",
                           query_chunk=2048, query_impl="dense"):
    """One SPPM iteration over the mesh. ``state`` arrays are padded to a
    multiple of the device count and sharded over ("px","spp") flattened."""
    assert mesh.shape["spp"] == 1, (
        "SPPM state is sharded over pixels; use a (n, 1) mesh "
        "(photons already use every device)")
    n_dev = mesh.devices.size
    npix = width * height
    npix_pad = -(-npix // n_dev) * n_dev
    n_ph_local = -(-n_photons // n_dev)
    spawn_eps = spawn_eps_rel * scene.scale
    extent = jnp.maximum(scene.bounds_max - scene.bounds_min, 1e-6)
    cap_radius = jnp.min(extent / jnp.asarray(grid_res, jnp.float32))

    def pad_pix(x):
        return jnp.pad(x, [(0, npix_pad - npix)] + [(0, 0)] * (x.ndim - 1))

    state_p = jax.tree_util.tree_map(
        lambda x: pad_pix(x) if x.ndim and x.shape[0] == npix else x, state)
    pixel_ids = jnp.arange(npix_pad, dtype=jnp.int32)

    def shard_fn(scene_rep, st, key_rep, ids_shard):
        dev = jax.lax.axis_index("px") * mesh.shape["spp"] \
            + jax.lax.axis_index("spp")
        k_iter = jax.random.fold_in(key_rep, st.iteration)
        k_ph = jax.random.fold_in(jax.random.fold_in(k_iter, 101), dev)
        k_meas = jax.random.fold_in(jax.random.fold_in(k_iter, 103), dev)

        # 1. local photon wavefront, then all_gather the deposits.
        # The regenerating SoA pass (same as the single-chip path) also
        # shrinks the per-shard deposit arrays the gather ships: slots ~
        # (window + bounces) * lanes instead of n_ph_local * bounces.
        if sppm_model._soa_eligible(scene_rep, intersector):
            from raytracer.models.wavefront_soa import (
                trace_photon_deposits_regen_soa)
            from raytracer.ops.dispatch import _resolve
            comps = trace_photon_deposits_regen_soa(
                scene_rep, k_ph, n_ph_local, max_photon_bounces,
                photon_t_min, spawn_eps, _resolve(scene_rep, intersector))
            (px_, py_, pz_, wr, wg, wb, nx_, ny_, nz_,
             valid, caustic) = comps
            pos = jnp.stack([px_, py_, pz_], -1)
            power = jnp.stack([wr, wg, wb], -1)
            norm = jnp.stack([nx_, ny_, nz_], -1)
        else:
            pos, power, norm, valid, caustic = (
                sppm_model.trace_photon_deposits(
                    scene_rep, k_ph, n_ph_local, max_photon_bounces,
                    photon_t_min, spawn_eps, intersector))
        # ceil(n_photons/n_dev)*n_dev photons are actually emitted while the
        # final gather normalizes by n_iterations*photons_per_iter — rescale
        # the deposited power so total flux matches exactly n_photons.
        power = power * (n_photons / (n_ph_local * n_dev))
        gather = lambda x: jax.lax.all_gather(
            x, ("px", "spp"), axis=0, tiled=True)
        pos, power, norm = gather(pos), gather(power), gather(norm)
        valid, caustic = gather(valid), gather(caustic)

        # 2. replicated grids (identical on every chip; compact=True matches
        #    the single-chip path's bf16 payloads bit-for-bit)
        g_grid = pg.build_grid(pos, power, norm, valid,
                               scene_rep.bounds_min, scene_rep.bounds_max,
                               grid_res, compact=True)
        c_grid = pg.build_grid(pos, power, norm, valid & caustic,
                               scene_rep.bounds_min, scene_rep.bounds_max,
                               grid_res, compact=True,
                               max_valid=n_ph_local * n_dev)

        # 3. local measurement points (pixels beyond npix are dead weight)
        pts = sppm_model.measurement_pass(
            scene_rep, k_meas, ids_shard, width, height, max_camera_bounces,
            t_min, spawn_eps, intersector)
        in_image = ids_shard < npix
        pts = pts._replace(valid=pts.valid & in_image)

        # 4. local stat update (state shard never leaves the chip)
        rg = jnp.minimum(jnp.sqrt(jnp.maximum(st.glob.radius2, 0.0)), cap_radius)
        rg = jnp.where(st.glob.photons > 0, rg, cap_radius)
        qg = sppm_model._query(g_grid, grid_res, pts.p, rg,
                               jnp.where(st.glob.photons > 0, rg, cap_radius),
                               k_per_cell, query_chunk, query_impl)
        glob = sppm_model._update_half(st.glob, pts, qg, k_global, alpha,
                                       cap_radius)
        rc = jnp.minimum(jnp.sqrt(jnp.maximum(st.caustic.radius2, 0.0)),
                         cap_radius)
        rc = jnp.where(st.caustic.photons > 0, rc, cap_radius)
        qc = sppm_model._query(c_grid, grid_res, pts.p, rc,
                               jnp.where(st.caustic.photons > 0, rc,
                                         cap_radius),
                               k_per_cell, query_chunk, query_impl)
        caus = sppm_model._update_half(st.caustic, pts, qc, k_caustic, alpha,
                                       cap_radius)
        return sppm_model.SPPMState(glob, caus, st.iteration + 1)

    state_spec = sppm_model.SPPMState(
        glob=sppm_model.SPPMHalf(P("px"), P("px"), P("px")),
        caustic=sppm_model.SPPMHalf(P("px"), P("px"), P("px")),
        iteration=P())
    out = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), state_spec, P(), P("px")),
        out_specs=state_spec,
        check_vma=False,
    )(scene, state_p, key, pixel_ids)
    return jax.tree_util.tree_map(
        lambda x: x[:npix] if x.ndim and x.shape[0] == npix_pad else x, out)


@functools.partial(jax.jit, static_argnames=(
    "mesh", "width", "height", "spp", "spp_chunk", "max_depth",
    "intersector"))
def sppm_gather_sharded(scene: Scene, state, key, *, mesh: Mesh, width,
                        height, spp, spp_chunk, max_depth, t_min,
                        spawn_eps_rel, n_total_photons, intersector="auto"):
    """Sharded final gather: the executor role of camera.rs:66-128 driving
    sample_ray, over the same ("px", "spp") mesh as parallel/render.py.
    The per-pixel density estimates ride the pixel shard (they are part of
    the SPPM state and never leave their chip); sample-axis partials
    combine via psum. Returns ((H, W, 3) image, rays)."""
    n_px = mesh.shape["px"]
    n_spp = mesh.shape["spp"]
    npix = width * height
    npix_pad = -(-npix // n_px) * n_px
    pixel_ids = jnp.arange(npix_pad, dtype=jnp.int32)
    est = sppm_model.density_estimates(state, n_total_photons)
    est = jnp.pad(est, [(0, npix_pad - npix), (0, 0)])
    spp_local = -(-spp // n_spp)
    chunk = max(1, min(spp_chunk, spp_local))
    n_chunks = -(-spp_local // chunk)
    spawn_eps = spawn_eps_rel * scene.scale

    # regen + drain-cascade per shard (same machinery as gather_fn's
    # single-chip fast path); pixels ride block-permuted so whole 16x16
    # blocks land on one chip
    if sppm_model._soa_eligible(scene, intersector):
        import numpy as _np
        from raytracer.ops.dispatch import _resolve
        method = _resolve(scene, intersector)
        from raytracer.models.wavefront_soa import (
            block_order, gather_regen_soa)
        perm, inv = block_order(width, height)
        perm_pad = _np.concatenate(
            [perm, _np.full(npix_pad - npix, npix - 1, perm.dtype)])
        slots = jnp.asarray(perm_pad)
        est_slots = est[slots]   # est rows in slot order, sharded alongside

        def shard_fn_regen(scene_rep, key_rep, slots_shard, est_shard):
            px_i = jax.lax.axis_index("px")
            spp_i = jax.lax.axis_index("spp")
            dev_key = jax.random.fold_in(
                jax.random.fold_in(key_rep, px_i), spp_i)
            accum, rays, _steps = gather_regen_soa(
                scene_rep, est_shard, dev_key, width=width, height=height,
                lanes_per_pixel=chunk, samples_per_lane=n_chunks,
                max_depth=max_depth, t_min=t_min, spawn_eps=spawn_eps,
                intersector=method, pixel_slots=slots_shard)
            accum = jax.lax.psum(accum, "spp")
            rays = jax.lax.psum(rays, ("px", "spp"))
            return accum, rays

        accum, rays = shard_map(
            shard_fn_regen, mesh=mesh,
            in_specs=(P(), P(), P("px"), P("px")),
            out_specs=(P("px"), P()),
            check_vma=False,
        )(scene, key, slots, est_slots)
        img = accum[jnp.asarray(inv)] / (n_chunks * chunk * n_spp)
        return img.reshape(height, width, 3), rays[0] if rays.ndim else rays

    def shard_fn(scene_rep, key_rep, ids_shard, est_shard):
        px_i = jax.lax.axis_index("px")
        spp_i = jax.lax.axis_index("spp")
        dev_key = jax.random.fold_in(jax.random.fold_in(key_rep, px_i), spp_i)
        n_local = ids_shard.shape[0]
        ids_rep = jnp.broadcast_to(
            ids_shard[None, :], (chunk, n_local)).reshape(-1)
        est_rep = jnp.broadcast_to(
            est_shard[None], (chunk, n_local, 3)).reshape(-1, 3)

        def chunk_body(i, carry):
            accum, rays = carry
            k_cam = jax.random.fold_in(jax.random.fold_in(dev_key, 17), i)
            k_walk = jax.random.fold_in(jax.random.fold_in(dev_key, 19), i)
            o, d = camera_rays(scene_rep.camera, k_cam, ids_rep, width,
                               height)
            radiance, r = sppm_model.gather_walk(
                scene_rep, o, d, est_rep, k_walk, max_depth=max_depth,
                t_min=t_min, spawn_eps=spawn_eps, intersector=intersector)
            rad = radiance.reshape(chunk, n_local, 3).sum(axis=0)
            return accum + rad, rays + r

        init = (jnp.zeros((n_local, 3), jnp.float32), jnp.int32(0))
        if hasattr(jax.lax, "pcast"):
            init = jax.tree_util.tree_map(
                lambda x: jax.lax.pcast(x, ("px", "spp"), to="varying"), init)
        elif hasattr(jax.lax, "pvary"):  # pragma: no cover
            init = jax.tree_util.tree_map(
                lambda x: jax.lax.pvary(x, ("px", "spp")), init)
        accum, rays = jax.lax.fori_loop(0, n_chunks, chunk_body, init)
        accum = jax.lax.psum(accum, "spp")
        rays = jax.lax.psum(rays, ("px", "spp"))
        return accum, rays

    accum, rays = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(), P(), P("px"), P("px")),
        out_specs=(P("px"), P()),
        check_vma=False,
    )(scene, key, pixel_ids, est)
    img = accum[:npix] / (n_chunks * chunk * n_spp)
    return img.reshape(height, width, 3), rays[0] if rays.ndim else rays


def render_sppm(scene: Scene, config, key, mesh: Mesh = None, state=None,
                checkpoint_cb=None):
    """Full multi-chip SPPM render: sharded iterations + sharded gather
    (the mesh analog of models/sppm.render). Returns (image, rays, state)."""
    from raytracer.parallel.render import make_mesh
    if mesh is None:
        mesh = make_mesh()
    sp = config.sppm
    if scene.lights.kind.shape[0] == 0:
        raise ValueError("SPPM requires at least one light in the scene")
    if scene.spheres.motion_marker.shape[0]:
        raise ValueError(
            "SPPM does not support motion blur (see models/sppm.render); "
            "use the PT integrator for moving scenes")
    npix = config.width * config.height
    if state is None:
        state = sppm_model.init_state(npix)
    grid_res, _r0 = pg.choose_grid_resolution(
        scene.bounds_min, scene.bounds_max, sp.photons_per_iter, sp.k_global)
    kw = dict(
        mesh=mesh, width=config.width, height=config.height,
        n_photons=sp.photons_per_iter,
        max_photon_bounces=sp.max_photon_bounces,
        max_camera_bounces=sp.max_camera_bounces,
        grid_res=grid_res, k_per_cell=sp.max_photons_per_cell,
        alpha=sp.alpha, k_global=sp.k_global, k_caustic=sp.k_caustic,
        t_min=config.t_min, photon_t_min=1e-4,
        spawn_eps_rel=config.spawn_eps_rel,
        intersector=config.intersector, query_impl=sp.query_impl)
    for _i in range(int(state.iteration), sp.n_iterations):
        state = sppm_iteration_sharded(scene, state, key, **kw)
        if checkpoint_cb is not None:
            checkpoint_cb(state)

    n_total = sp.n_iterations * sp.photons_per_iter
    total = config.samples_per_pixel
    # same per-dispatch lane budgets as models/sppm.gather_batching (not
    # yet measured on the GPU), scaled by the device count since each
    # chip only traces its pixel shard.
    # budgets are per-CHIP lane counts; only the "px" axis shards the
    # per-chunk lanes (the spp axis replicates pixels with other streams),
    # so scale by n_px, not the device count
    n_px = mesh.shape["px"]
    lane_budget = max(1, 16_000_000 * n_px // npix)
    chunk_budget = max(1, 1_500_000 * n_px // npix)
    batch = max(1, min(config.host_spp_batch, total, lane_budget))
    done, i, rays_total, accum = 0, 0, 0, None
    while done < total:
        spp = min(batch, total - done)
        img, rays = sppm_gather_sharded(
            scene, state, jax.random.fold_in(jax.random.fold_in(key, 23), i),
            mesh=mesh, width=config.width, height=config.height, spp=spp,
            spp_chunk=max(1, min(config.spp_chunk, spp, chunk_budget)),
            max_depth=config.max_depth, t_min=config.t_min,
            spawn_eps_rel=config.spawn_eps_rel, n_total_photons=n_total,
            intersector=config.intersector)
        w = spp / total
        accum = img * w if accum is None else accum + img * w
        rays_total += int(rays)
        done += spp
        i += 1
    return accum, rays_total, state
