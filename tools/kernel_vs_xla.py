"""Time each GPU kernel against the plain XLA path it replaces, end to end
through the normal entry points, on one NVIDIA GPU.

    python tools/kernel_vs_xla.py [--parts sweep,pt,sppm400,sppm800]
                                  [--scenes NAME,...] [--out FILE]

- closest hit: ``render_fn`` PT at 800x600, depth 16 with Russian roulette,
  ``intersector="pallas"`` against ``"xla"``, on scene_500 (32 spp),
  sphere_field(65536), bunny_field(25) and motion_field(1000) (8 spp each);
- photon query: one SPPM iteration on Cornell at 400x400 with 250k photons
  (part ``sppm400``) and at 800x800 with 500k photons (``sppm800``), the
  kernel against the plain XLA query.

Each pair is timed in turns (kernel, xla, xla, kernel) after a warm-up run
that compiles both, with ``block_until_ready``. The part ``sweep`` times
one full-frame closest-hit bounce for several block/chunk/warp settings and
runs the renders with the fastest (by summed time). ``--parts`` picks the
parts (default ``pt,sppm400,sppm800``), ``--scenes`` the PT scenes
(default all four). Prints one JSON object. Exits non-zero off the
GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


def timed(fn):
    import jax
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    return time.perf_counter() - t0


def turns(kernel, xla):
    """Warm both, then kernel, xla, xla, kernel. Returns the two lists."""
    timed(kernel)
    timed(xla)
    k, x = [timed(kernel)], [timed(xla)]
    x.append(timed(xla))
    k.append(timed(kernel))
    return k, x


def sweep(scenes):
    import jax
    import jax.numpy as jnp
    from chip_smoke import frame_rays
    from raytracer.ops import pallas_intersect as pi
    configs = [(64, 32, 2), (64, 32, 4), (128, 32, 4), (128, 32, 2),
               (64, 64, 2), (64, 16, 2), (32, 32, 1)]
    rows = {}
    rays = {name: (sc, frame_rays(sc, 800, 600)) for name, sc in scenes}
    for cfg in configs:
        pi.BLOCK, pi.CHUNK, pi.NUM_WARPS = cfg
        total = 0.0
        for name, (sc, (o, d, t)) in rays.items():
            fn = jax.jit(lambda sc, o, d, t: pi.intersect_pallas(
                sc, o, d, 1e-3, jnp.inf, time=t))
            timed(lambda: fn(sc, o, d, t))
            ms = 1e3 * min(timed(lambda: fn(sc, o, d, t)) for _ in range(3))
            rows.setdefault(str(cfg), {})[name] = ms
            total += ms
        rows[str(cfg)]["total"] = total
        print(f"sweep block/chunk/warps {cfg}: {rows[str(cfg)]}", flush=True)
    best = min(configs, key=lambda c: rows[str(c)]["total"])
    pi.BLOCK, pi.CHUNK, pi.NUM_WARPS = best
    return rows, best


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--parts", default="pt,sppm400,sppm800",
                   help="comma-separated subset of "
                        "sweep,pt,sppm400,sppm800")
    p.add_argument("--scenes", default=None,
                   help="comma-separated PT scene names (default all)")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    parts = set(args.parts.split(","))
    if not parts <= {"sweep", "pt", "sppm400", "sppm800"}:
        p.error(f"unknown part in {args.parts!r}")

    import jax
    if jax.devices()[0].platform != "gpu":
        print("kernel_vs_xla: needs a GPU", file=sys.stderr)
        return 2
    from raytracer.models import path_tracer as pt
    from raytracer.models import sppm
    from raytracer.ops import pallas_intersect as pi
    from raytracer.ops import pallas_photon
    from raytracer.ops import photon_grid as pg
    from raytracer.scene.builtin import (
        bunny_field, cornell_box, motion_field, sphere_field)
    from raytracer.scene.loader import load_scene
    from raytracer.utils import compile_cache
    compile_cache.enable()

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    out = {"card": smi, "device_kind": jax.devices()[0].device_kind}
    w, h = 800, 600
    scenes = [
        ("scene_500", load_scene(os.path.join(HERE, "data",
                                              "scene_500.json"),
                                 aspect_ratio=w / h), 32),
        ("sphere_field_65536", sphere_field(65536), 8),
        ("bunny_field_25", bunny_field(25), 8),
        ("motion_field_1000", motion_field(1000), 8),
    ]
    if args.scenes:
        keep = args.scenes.split(",")
        unknown = set(keep) - {n for n, _, _ in scenes}
        if unknown:
            p.error(f"unknown scenes {sorted(unknown)}")
        scenes = [s for s in scenes if s[0] in keep]
    if "sweep" in parts:
        out["sweep"], best = sweep([(n, s) for n, s, _ in scenes])
        out["chosen"] = best
    out["kernel_config"] = {"block": pi.BLOCK, "chunk": pi.CHUNK,
                            "num_warps": pi.NUM_WARPS}

    key = jax.random.PRNGKey(1)
    pt_rows = {}
    for name, scene, spp in scenes:
        if "pt" not in parts:
            break
        kw = dict(width=w, height=h, spp=spp, spp_chunk=1, max_depth=16,
                  t_min=1e-3, spawn_eps_rel=1e-5, russian_roulette=True)
        rays = {}

        def run(isec):
            img, r = pt.render_fn(scene, key, intersector=isec, **kw)
            rays[isec] = r
            return img
        k, x = turns(lambda: run("pallas"), lambda: run("xla"))
        pt_rows[name] = {"spp": spp, "kernel_s": k, "xla_s": x,
                         "rays_kernel": int(rays["pallas"]),
                         "rays_xla": int(rays["xla"])}
        print(f"pt {name}: {pt_rows[name]}", flush=True)
    out["pt_800x600_depth16_rr"] = pt_rows

    scene = cornell_box(with_mesh=True)
    sppm_rows = {}
    kernel_query = pallas_photon.query_photons
    for width, n_ph in ((400, 250_000), (800, 500_000)):
        if f"sppm{width}" not in parts:
            continue
        grid_res, _ = pg.choose_grid_resolution(
            scene.bounds_min, scene.bounds_max, n_ph, 100)
        kw = dict(width=width, height=width, n_photons=n_ph,
                  max_photon_bounces=16, max_camera_bounces=50,
                  grid_res=grid_res, k_per_cell=64, alpha=0.7,
                  k_global=100, k_caustic=50, t_min=1e-3,
                  photon_t_min=1e-4, spawn_eps_rel=1e-5, intersector="auto")
        st0 = sppm.init_state(width * width)
        blocked = width * width > (1 << 18)

        def iteration(query):
            pallas_photon.query_photons = query
            try:
                jax.clear_caches()
                if blocked:
                    st = sppm.sppm_iteration_blocked(
                        scene, st0, key, pixel_block=1 << 18, **kw)
                else:
                    st = sppm.sppm_iteration(scene, st0, key, **kw)
                st = jax.block_until_ready(st)
                t0 = time.perf_counter()
                for _ in range(2):
                    if blocked:
                        st = sppm.sppm_iteration_blocked(
                            scene, st, key, pixel_block=1 << 18, **kw)
                    else:
                        st = sppm.sppm_iteration(scene, st, key, **kw)
                jax.block_until_ready(st)
                return (time.perf_counter() - t0) / 2
            finally:
                pallas_photon.query_photons = kernel_query

        kq = [iteration(kernel_query)]
        xq = [iteration(pallas_photon.query_photons_xla)]
        xq.append(iteration(pallas_photon.query_photons_xla))
        kq.append(iteration(kernel_query))
        sppm_rows[f"{width}x{width}_{n_ph}"] = {
            "kernel_s_per_iter": kq, "xla_s_per_iter": xq}
        print(f"sppm {width}: {sppm_rows[f'{width}x{width}_{n_ph}']}",
              flush=True)
    out["sppm_iteration"] = sppm_rows
    print(json.dumps(out))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
