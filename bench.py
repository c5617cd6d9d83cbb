"""Benchmark harness (needs an NVIDIA GPU; exits non-zero elsewhere).

Headline metric: Mrays/s per card rendering data/scene_500.json at 800x600;
also reports extrapolated wall-clock to 1000 spp. Rays counted = executed
ray-bounce intersections (primaries are bounce 0; nothing is
double-counted — SURVEY.md §5.5).

Prints ONE JSON line: {"metric", "value", "unit", "device", ...extras},
with the device kind, count and the card's power limit. Extras carry the
reference-equivalent depth-50 numbers (photon_mapper.rs:334 walk cap), the
large-scene cases, and the SPPM iteration times (Cornell, exact photon
query). The benchmark's cells are not defined yet (ROADMAP Speed 1).
"""

from __future__ import annotations

import json
import subprocess
import sys
import time


def _timed(fn, *args, **kw):
    import jax
    out = fn(*args, **kw)
    jax.block_until_ready(out)       # warmup/compile
    t0 = time.time()
    out = fn(*args, **kw)
    jax.block_until_ready(out)
    return out, time.time() - t0


def main():
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"bench.py: needs a GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        return 2
    from raytracer.models import path_tracer as pt
    from raytracer.scene.loader import load_scene
    from raytracer.utils import compile_cache
    compile_cache.enable()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()

    width, height = 800, 600
    spp_timed = 32          # timed sample count (steady-state throughput)
    spp_chunk = 1

    scene = load_scene("data/scene_500.json", aspect_ratio=width / height)
    key = jax.random.PRNGKey(1)

    def run(sc, depth, rr):
        kw = dict(width=width, height=height, spp=spp_timed,
                  spp_chunk=spp_chunk, max_depth=depth, t_min=1e-3,
                  spawn_eps_rel=1e-5, russian_roulette=rr)
        (img, rays), dt = _timed(pt.render_fn, sc, key, **kw)
        return int(rays), dt

    # depth-16 throughput, no RR (alive-lane count is then an honest
    # denominator)
    rays_p, dt_p = run(scene, 16, rr=False)
    mrays = rays_p / dt_p / 1e6
    # production config (RR)
    _, dt_rr = run(scene, 16, rr=True)
    # reference-equivalent walk cap (photon_mapper.rs:334): depth 50 + RR
    rays50, dt50 = run(scene, 50, rr=True)

    # large scenes: a 64k-sphere field
    from raytracer.scene.builtin import sphere_field
    fscene = sphere_field(65536)
    rays_f, dt_f = run(fscene, 16, rr=True)
    mrays_field = rays_f / dt_f / 1e6

    # 160k spheres, 8 spp
    f2scene = sphere_field(163840)
    kw2 = dict(width=width, height=height, spp=8, spp_chunk=1, max_depth=16,
               t_min=1e-3, spawn_eps_rel=1e-5, intersector="auto",
               russian_roulette=True)
    (img2, rays_f2), dt_f2 = _timed(pt.render_fn, f2scene, key, **kw2)
    mrays_field2 = int(rays_f2) / dt_f2 / 1e6

    # 124k-TRIANGLE mesh field (25 bunnies): the reference's "big mesh"
    # case (bvh.rs:60-101 over mesh.rs leaves)
    from raytracer.scene.builtin import bunny_field
    mscene = bunny_field(25)
    (img3, rays_m), dt_m = _timed(pt.render_fn, mscene, key, **kw2)
    mrays_mesh = int(rays_m) / dt_m / 1e6

    # motion blur (extension): 1000 moving spheres, regen per-sample
    # shutter times
    from raytracer.scene.builtin import motion_field
    moscene = motion_field(1000)
    (img4, rays_mo), dt_mo = _timed(pt.render_fn, moscene, key, **kw2)
    mrays_motion = int(rays_mo) / dt_mo / 1e6

    # scene_10 at 400x225@100spp, scene_200_no_bvh (405 spheres) at the
    # headline geometry
    s10 = load_scene("data/scene_10.json", aspect_ratio=400 / 225)
    kw10 = dict(width=400, height=225, spp=100, spp_chunk=1, max_depth=16,
                t_min=1e-3, spawn_eps_rel=1e-5, russian_roulette=True)
    (_, rays_10), dt_10 = _timed(pt.render_fn, s10, key, **kw10)
    s200 = load_scene("data/scene_200_no_bvh.json",
                      aspect_ratio=width / height)
    rays_200, dt_200 = run(s200, 16, rr=True)

    # measured wall-clock to 1000 spp at 800x600 on scene_500, production
    # config (RR, depth 16): 20 host dispatches of 50 spp (one compiled
    # program)
    from raytracer.utils.config import RenderConfig as _RC
    cfg1000 = _RC(width=width, height=height, samples_per_pixel=1000,
                  max_depth=16, spp_chunk=1, host_spp_batch=50)
    # warm through render() itself (2 batches of 50): compiles the exact
    # dispatch set of the timed run — render_fn(spp=50), the fixed-shape
    # key table, and the jitted batch accumulate
    warm, _ = pt.render(scene, _RC(width=width, height=height,
                                   samples_per_pixel=100, max_depth=16,
                                   spp_chunk=1, host_spp_batch=50), key)
    jax.block_until_ready(warm)
    t0 = time.time()
    img1000, _rays1000 = pt.render(scene, cfg1000, key)
    jax.block_until_ready(img1000)
    dt_1000 = time.time() - t0

    # volumetric-media tax: cornell_smoke (medium.rs:26-53) against plain
    # Cornell at identical settings
    from raytracer.scene.builtin import cornell_smoke
    from raytracer.scene.builtin import cornell_box as _cbox
    kw_sm = dict(width=400, height=400, spp=32, spp_chunk=4, max_depth=16,
                 t_min=1e-3, spawn_eps_rel=1e-5)
    (img_sm, _), dt_smoke = _timed(pt.render_fn, cornell_smoke(), key,
                                   **kw_sm)
    (img_cb, _), dt_cb = _timed(pt.render_fn, _cbox(), key, **kw_sm)

    # SPPM iteration (the reference's actual algorithm): Cornell 400x400,
    # 250k photons, exact photon query
    from raytracer.models import sppm
    from raytracer.ops import photon_grid as pg
    from raytracer.scene.builtin import cornell_box
    cscene = cornell_box(with_mesh=True)
    grid_res, _ = pg.choose_grid_resolution(
        cscene.bounds_min, cscene.bounds_max, 250_000, 100)
    skw = dict(width=400, height=400, n_photons=250_000,
               max_photon_bounces=16, max_camera_bounces=50,
               grid_res=grid_res, k_per_cell=64, alpha=0.7, k_global=100,
               k_caustic=50, t_min=1e-3, photon_t_min=1e-4,
               spawn_eps_rel=1e-5, intersector="auto", query_impl="dense")
    st = sppm.init_state(400 * 400)
    st = sppm.sppm_iteration(cscene, st, key, **skw)
    jax.block_until_ready(st.glob.flux)
    t0 = time.time()
    st = sppm.sppm_iteration(cscene, st, key, **skw)
    jax.block_until_ready(st.glob.flux)
    dt_sppm = time.time() - t0

    # reference-scale SPPM iteration: 800x800, 500k photons/iter
    # (photon_mapper.rs:148-149 defaults)
    grid_res8, _ = pg.choose_grid_resolution(
        cscene.bounds_min, cscene.bounds_max, 500_000, 100)
    skw8 = dict(skw, width=800, height=800, n_photons=500_000,
                grid_res=grid_res8)
    st8 = sppm.init_state(800 * 800)
    st8 = sppm.sppm_iteration(cscene, st8, key, **skw8)
    jax.block_until_ready(st8.glob.flux)
    t0 = time.time()
    st8 = sppm.sppm_iteration(cscene, st8, key, **skw8)
    jax.block_until_ready(st8.glob.flux)
    dt_sppm8 = time.time() - t0

    # THE reference workload end to end (main.rs:57-71's own Total print):
    # Cornell 800x800, 50 SPPM iterations x 500k photons, 256-spp depth-50
    # final gather — RenderConfig() defaults ARE the reference constants.
    # Warm the EXACT programs first (blocked iteration + 800x800 gather) so
    # the timed run measures sustained throughput; the one-time compiles
    # are reported apart as set-up.
    from raytracer.utils.config import RenderConfig
    t_w0 = time.time()
    sppm.warm_render_programs(cscene, RenderConfig(), jax.random.PRNGKey(9))
    dt_full_warmup = time.time() - t_w0
    t0 = time.time()
    img_full, _, _ = sppm.render(cscene, RenderConfig(),
                                 jax.random.PRNGKey(9))
    jax.block_until_ready(img_full)
    dt_full = time.time() - t0

    # the goldens' Monte-Carlo bands on the card (chip_smoke.golden_checks)
    from chip_smoke import SmokeFailure, golden_checks
    try:
        golden_checks()
        golden_failures = []
    except SmokeFailure as e:
        golden_failures = [str(e)]

    result = {
        "metric": "Mrays/s per card scene_500 800x600 (wavefront PT, depth<=16)",
        "value": round(mrays, 2),
        "unit": "Mrays/s",
        "device": {"platform": devs[0].platform,
                   "kind": devs[0].device_kind, "count": len(devs),
                   "name_power_limit": card},
        "wallclock_s_per_32spp": round(dt_p, 3),
        "wallclock_s_per_32spp_rr": round(dt_rr, 3),
        "s_to_1000spp_measured": round(dt_1000, 1),
        "extrapolated_s_to_1000spp": round(dt_rr * (1000 / spp_timed), 1),
        "depth50_rr_s_per_32spp": round(dt50, 3),
        "depth50_mrays": round(rays50 / dt50 / 1e6, 2),
        "depth50_extrapolated_s_to_1000spp": round(dt50 * (1000 / spp_timed), 1),
        "sppm_iter_s_400x400_250k": round(dt_sppm, 2),
        "sppm_iter_s_800x800_500k": round(dt_sppm8, 2),
        "sppm_full_800_s": round(dt_full, 1),
        "sppm_full_800_compile_warmup_s": round(dt_full_warmup, 1),
        "mrays_field64k": round(mrays_field, 2),
        "field64k_s_per_32spp": round(dt_f, 3),
        "mrays_field160k": round(mrays_field2, 2),
        "field160k_s_per_8spp": round(dt_f2, 3),
        "mrays_mesh124k": round(mrays_mesh, 2),
        "mesh124k_s_per_8spp": round(dt_m, 3),
        "mrays_motion1k": round(mrays_motion, 2),
        "motion1k_s_per_8spp": round(dt_mo, 3),
        "mrays_scene10": round(int(rays_10) / dt_10 / 1e6, 2),
        "scene10_s_per_100spp_400x225": round(dt_10, 3),
        "mrays_scene200": round(rays_200 / dt_200 / 1e6, 2),
        "scene200_s_per_32spp": round(dt_200, 3),
        "smoke_s_per_32spp_400": round(dt_smoke, 3),
        "cornell_s_per_32spp_400": round(dt_cb, 3),
        "media_tax_x": round(dt_smoke / dt_cb, 2),
        "numeric_ok": not golden_failures,
        "numeric_failures": golden_failures,
    }
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
