"""Smoke test of the renderer on NVIDIA GPUs, through its user entry points.

    python chip_smoke.py          # one card: device, kernels, main path
    python chip_smoke.py --four   # four cards: the sharded renders only

Phases (one card):
1. device: exits non-zero unless JAX runs on a GPU; prints the card.
2. kernels: compiles each GPU kernel at real widths, prints its memory
   analysis, and compares it with its XLA reference (closest hit on one
   full-frame bounce of four scenes; the photon query on a Cornell map of
   500k photons). Checks that the main path's lowered program calls the
   Triton kernel whenever dispatch chose it.
3. main path: PT on data/scene_500.json at 800x600 (32 spp, depth 16,
   Russian roulette), SPPM on Cornell at 800x800 (500k photons per
   iteration, 2 iterations, 16-spp depth-50 gather), and cornell_smoke at
   400x400 (32 spp) through the CLI; every image finite and non-black; the
   golden images at 32x32 within their Monte-Carlo bands.

With ``--four`` only the sharded paths run: parallel PT on scene_500 over
a (4,1) and a (2,2) mesh and parallel SPPM at the SPPM sizes above, each
compared with the same job on device 0.

Any failed check exits non-zero. The last line of a passing run is one JSON
object naming the device. Times printed here include compilation: they are
smoke timings, not benchmark numbers.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "tests", "golden")


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


# ------------------------------------------------------------------ device

def device_phase(n_devices: int):
    import jax
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX platform {devs[0].platform!r})",
              file=sys.stderr)
        sys.exit(2)
    check(len(devs) >= n_devices,
          f"need {n_devices} GPUs, JAX sees {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    for line in smi.stdout.strip().splitlines():
        print(line.strip())
    from raytracer.native import runtime as native_rt
    print(f"device_kind={devs[0].device_kind} devices={len(devs)} "
          f"jax={jax.__version__} native_lib={native_rt.available()}")
    from raytracer.utils import compile_cache
    print(f"compile cache: {compile_cache.enable()}")
    return devs


def peak_bytes(dev):
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use", 0)


# ----------------------------------------------------------------- kernels

def frame_rays(scene, width, height, seed=0):
    """One full frame of primary rays in the renderer's pixel-block lane
    order, with shutter times on moving scenes."""
    import jax
    import jax.numpy as jnp
    from raytracer.models.camera import camera_rays
    from raytracer.models.wavefront_soa import block_order
    perm, _ = block_order(width, height)
    key = jax.random.PRNGKey(seed)
    o, d = jax.jit(camera_rays, static_argnums=(3, 4))(
        scene.camera, key, jnp.asarray(perm), width, height)
    t = None
    if scene.spheres.motion_marker.shape[0]:
        t = jax.random.uniform(jax.random.fold_in(key, 1), (o.shape[0],))
        t = scene.camera.time0 + t * (scene.camera.time1 - scene.camera.time0)
    return o, d, t


def compare_hits(name, ref, got):
    """t within a relative 1e-5; winner identical on >= 99.99% of rays and
    every mismatch a tie (both t within 1e-5 t)."""
    t1, t2 = np.asarray(ref.t), np.asarray(got.t)
    ty1, ty2 = np.asarray(ref.prim_type), np.asarray(got.prim_type)
    ix1, ix2 = np.asarray(ref.prim_idx), np.asarray(got.prim_idx)
    hit1, hit2 = np.isfinite(t1), np.isfinite(t2)
    both = hit1 & hit2
    rel = np.abs(t1[both] - t2[both]) / np.maximum(np.abs(t1[both]), 1e-30)
    same = (hit1 == hit2) & (~hit1 | ((ty1 == ty2) & (ix1 == ix2)))
    mism = ~same
    with np.errstate(invalid="ignore"):        # inf - inf on double misses
        tie = both & (np.abs(t1 - t2) <= 1e-5 * np.abs(t1))
    frac = same.mean()
    print(f"  {name}: rays={t1.size} hit={hit1.mean():.4f} "
          f"max_rel_t={rel.max() if rel.size else 0.0:.3e} "
          f"winner_same={frac:.6f} mismatches={int(mism.sum())} "
          f"non_tie_mismatches={int((mism & ~tie).sum())}")
    check(rel.size == 0 or rel.max() <= 1e-5,
          f"{name}: t differs by relative {rel.max():.3e} > 1e-5")
    check(frac >= 0.9999, f"{name}: winner agreement {frac:.6f} < 0.9999")
    check(not (mism & ~tie).any(),
          f"{name}: {int((mism & ~tie).sum())} winner mismatches are not ties")


def closest_hit_checks(w=800, h=600):
    import jax
    import jax.numpy as jnp
    from raytracer.ops.intersect import intersect_bruteforce
    from raytracer.ops.pallas_intersect import intersect_pallas
    from raytracer.scene.builtin import (
        bunny_field, motion_field, sphere_field)
    from raytracer.scene.loader import load_scene

    scenes = [
        ("scene_500", lambda: load_scene(
            os.path.join(HERE, "data", "scene_500.json"),
            aspect_ratio=w / h)),
        ("sphere_field_65536", lambda: sphere_field(65536)),
        ("bunny_field_25", lambda: bunny_field(25)),
        ("motion_field_1000", lambda: motion_field(1000)),
    ]

    def kernel(scene, o, d, t):
        return intersect_pallas(scene, o, d, 1e-3, jnp.inf, time=t)

    def reference(scene, o, d, t):
        return intersect_bruteforce(scene, o, d, 1e-3, jnp.inf, time=t)

    for name, make in scenes:
        scene = make()
        o, d, t = frame_rays(scene, w, h)
        t0 = time.time()
        compiled = jax.jit(kernel).lower(scene, o, d, t).compile()
        print(f"  {name}: kernel compiled in {time.time() - t0:.1f} s; "
              f"memory {compiled.memory_analysis()}")
        got = jax.block_until_ready(compiled(scene, o, d, t))
        with jax.default_matmul_precision("highest"):
            ref = jax.block_until_ready(jax.jit(reference)(scene, o, d, t))
        compare_hits(name, ref, got)


def photon_query_check(w=800, n_ph=500_000, n_pts=1 << 18):
    import jax
    import jax.numpy as jnp
    from raytracer.models import sppm
    from raytracer.ops import photon_grid as pg
    from raytracer.ops.pallas_photon import (
        query_photons, query_photons_xla)
    from raytracer.scene.builtin import cornell_box

    scene = cornell_box()
    grid_res, _ = pg.choose_grid_resolution(
        scene.bounds_min, scene.bounds_max, n_ph, 100)
    key = jax.random.PRNGKey(3)
    g, _c = sppm.photon_grids(
        scene, key, jnp.int32(0), n_photons=n_ph, max_photon_bounces=16,
        grid_res=grid_res, photon_t_min=1e-4, spawn_eps_rel=1e-5)
    pts = jax.jit(sppm.measurement_pass, static_argnums=(3, 4, 5, 8))(
        scene, key, jnp.arange(n_pts, dtype=jnp.int32), w, w, 50, 1e-3,
        1e-5 * scene.scale, "auto")
    extent = jnp.maximum(scene.bounds_max - scene.bounds_min, 1e-6)
    cap = jnp.min(extent / jnp.asarray(grid_res, jnp.float32))
    # cell-sorted points, as models/sppm._sorted_dual_query queries them
    inv_cell = jnp.asarray(grid_res, jnp.float32) / extent
    ci = jnp.clip(jnp.floor((pts.p - scene.bounds_min) * inv_cell)
                  .astype(jnp.int32), 0, jnp.asarray(grid_res) - 1)
    order = jnp.argsort((ci[:, 0] * grid_res[1] + ci[:, 1]) * grid_res[2]
                        + ci[:, 2])
    points = pts.p[order]
    radius = jnp.full((n_pts,), 0.5, jnp.float32) * cap
    valid = jnp.arange(g.pos.shape[0]) < g.n_valid
    args = (g.pos, g.power.astype(jnp.float32), g.norm.astype(jnp.float32),
            valid, points, radius, cap)
    t0 = time.time()
    compiled = jax.jit(query_photons).lower(*args).compile()
    print(f"  photon_query: kernel compiled in {time.time() - t0:.1f} s; "
          f"memory {compiled.memory_analysis()}")
    got = jax.block_until_ready(compiled(*args))
    ref = jax.block_until_ready(jax.jit(query_photons_xla)(*args))
    for field in ("count_r", "count_cap"):
        a, b = np.asarray(getattr(ref, field)), np.asarray(getattr(got, field))
        check(np.array_equal(a, b),
              f"photon_query {field}: {int((a != b).sum())} counts differ")
    worst = 0.0
    for field in ("flux_r", "flux_cap"):
        a, b = np.asarray(getattr(ref, field)), np.asarray(getattr(got, field))
        err = np.abs(a - b) / np.maximum(np.abs(a), 1e-6 * np.abs(a).max())
        worst = max(worst, float(err.max()))
    print(f"  photon_query: points={n_pts} photons_valid={int(g.n_valid)} "
          f"mean_count_cap={float(np.asarray(ref.count_cap).mean()):.1f} "
          f"counts exact, max_rel_flux={worst:.3e}")
    check(worst <= 1e-4, f"photon_query flux differs by relative {worst:.3e}")


def lowering_check():
    import jax
    from raytracer.models import path_tracer as pt
    from raytracer.ops.dispatch import _resolve
    from raytracer.scene.loader import load_scene
    scene = load_scene(os.path.join(HERE, "data", "scene_500.json"),
                       aspect_ratio=800 / 600)
    method = _resolve(scene, "auto", has_time=True)
    txt = pt.render_fn.lower(
        scene, jax.random.PRNGKey(0), width=800, height=600, spp=32,
        spp_chunk=1, max_depth=16, t_min=1e-3, spawn_eps_rel=1e-5).as_text()
    has = "__gpu$xla.gpu.triton" in txt
    print(f"  render_fn(scene_500): auto -> {method!r}; Triton custom call "
          f"in lowered HLO: {has}")
    if method == "pallas":
        check(has, "dispatch chose the kernel but the lowered render "
                   "program has no Triton custom call")


# --------------------------------------------------------------- main path

def image_ok(name, img):
    img = np.asarray(img)
    check(np.isfinite(img).all(), f"{name}: non-finite pixels")
    check(img.mean() > 1e-4 and img.max() > 0.0,
          f"{name}: black image (mean {img.mean():.3e})")
    print(f"  {name}: shape={img.shape} mean={img.mean():.5f} finite")


def band_failures(img, ref):
    """Monte-Carlo bands of tests/test_golden.py in gamma space: global
    mean within 5%, p95 |diff| < 0.30, mean |diff| < 0.08."""
    a = np.sqrt(np.clip(np.asarray(img), 0, None))
    b = np.sqrt(np.clip(np.asarray(ref), 0, None))
    diff = np.abs(a - b)
    out = []
    if not abs(a.mean() - b.mean()) < 0.05 * max(b.mean(), 1e-6):
        out.append(f"mean {a.mean():.4f} vs {b.mean():.4f}")
    if not np.percentile(diff, 95) < 0.30:
        out.append(f"p95 diff {np.percentile(diff, 95):.3f}")
    if not diff.mean() < 0.08:
        out.append(f"mean diff {diff.mean():.3f}")
    return out


def golden_checks():
    """The two goldens whose truth matches the current transport
    (tests/test_golden.py). The motion-field golden predates the spawn-
    epsilon change and fails its band on the CPU as well (ROADMAP
    Design 6), so it is not a check here."""
    import jax
    from raytracer.models import path_tracer, sppm
    from raytracer.scene.builtin import cornell_box, three_spheres
    from raytracer.utils.config import RenderConfig, SPPMConfig
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=64,
                       spp_chunk=8, max_depth=12)
    img, _ = path_tracer.render(three_spheres(1.0), cfg,
                                jax.random.PRNGKey(7))
    jobs = [("three_spheres_32.npz", img)]
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=32,
                       spp_chunk=8, max_depth=12,
                       sppm=SPPMConfig(n_iterations=4, photons_per_iter=20000,
                                       max_photon_bounces=8,
                                       max_camera_bounces=12,
                                       max_photons_per_cell=64))
    img, _, _ = sppm.render(cornell_box(with_mesh=True), cfg,
                            jax.random.PRNGKey(7))
    jobs.append(("cornell_sppm_32.npz", img))
    for name, img in jobs:
        ref = np.load(os.path.join(GOLDEN, name))["img"]
        fails = band_failures(img, ref)
        print(f"  golden {name}: {'ok' if not fails else fails}")
        check(not fails, f"golden {name} outside its bands: {fails}")


def read_png(path):
    """(H, W, 3) uint8 from an 8-bit RGB PNG written by utils/image.py,
    without Pillow. Both of its encoders write every row unfiltered."""
    import struct
    import zlib
    data = open(path, "rb").read()
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    check(not raw[:, 0].any(), f"{path}: filtered PNG rows")
    return raw[:, 1:].reshape(h, w, 3)


def main_path_phase(dev):
    import jax
    from raytracer import cli
    from raytracer.models import path_tracer, sppm
    from raytracer.scene.builtin import cornell_box
    from raytracer.scene.loader import load_scene
    from raytracer.utils.config import RenderConfig, SPPMConfig

    t0 = time.time()
    scene = load_scene(os.path.join(HERE, "data", "scene_500.json"),
                       aspect_ratio=800 / 600)
    cfg = RenderConfig(width=800, height=600, samples_per_pixel=32,
                       spp_chunk=1, max_depth=16, russian_roulette=True)
    img, rays = path_tracer.render(scene, cfg, jax.random.PRNGKey(1))
    img = jax.block_until_ready(img)
    print(f"  pt scene_500 800x600 32spp: smoke wall {time.time() - t0:.1f} s"
          f" (with compilation), rays={rays}, "
          f"peak_bytes_in_use={peak_bytes(dev)}")
    image_ok("pt scene_500", img)

    t0 = time.time()
    cfg = RenderConfig(width=800, height=800, samples_per_pixel=16,
                       max_depth=50,
                       sppm=SPPMConfig(n_iterations=2,
                                       photons_per_iter=500_000))
    img, rays, _ = sppm.render(cornell_box(), cfg, jax.random.PRNGKey(2))
    img = jax.block_until_ready(img)
    print(f"  sppm cornell 800x800 2x500k + 16spp gather: smoke wall "
          f"{time.time() - t0:.1f} s (with compilation), rays={rays}, "
          f"peak_bytes_in_use={peak_bytes(dev)}")
    image_ok("sppm cornell", img)

    out = os.path.join(HERE, "output", "chip_smoke", "smoke_400.png")
    t0 = time.time()
    rc = cli.main(["render", "--scene", "smoke", "--integrator", "pt",
                   "--width", "400", "--height", "400", "--spp", "32",
                   "--max-depth", "16", "--out", out])
    check(rc == 0, f"cli render of cornell_smoke returned {rc}")
    print(f"  cli cornell_smoke 400x400 32spp: smoke wall "
          f"{time.time() - t0:.1f} s (with compilation)")
    img8 = read_png(out)
    check(img8.shape == (400, 400, 3), f"smoke png shape {img8.shape}")
    check(img8.mean() > 1.0, f"smoke png black (mean {img8.mean():.3f})")
    print(f"  cornell_smoke png: mean={img8.mean():.2f}/255")

    golden_checks()


# -------------------------------------------------------------- four cards

def four_phase(devs, pt_size=(800, 600, 32), sppm_size=(800, 500_000)):
    import jax
    from raytracer.models import path_tracer, sppm
    from raytracer.parallel import render as prender
    from raytracer.parallel.sppm import render_sppm
    from raytracer.scene.builtin import cornell_box
    from raytracer.scene.loader import load_scene
    from raytracer.utils.config import RenderConfig, SPPMConfig

    devs = devs[:4]

    def compare(name, img, ref):
        image_ok(name, img)
        m, r = float(np.mean(img)), float(np.mean(ref))
        fails = band_failures(img, ref)
        print(f"  {name}: mean {m:.5f} vs device-0 {r:.5f} "
              f"({abs(m - r) / r:.4%}); bands {'ok' if not fails else fails}")
        check(abs(m - r) <= 0.01 * r, f"{name}: mean off by >1%")
        check(not fails, f"{name}: outside the bands: {fails}")

    def all_devices_worked(name):
        peaks = [peak_bytes(d) for d in devs]
        print(f"  {name}: peak_bytes_in_use per device {peaks}")
        check(all(p > 0 for p in peaks), f"{name}: idle device {peaks}")

    w, h, spp = pt_size
    scene = load_scene(os.path.join(HERE, "data", "scene_500.json"),
                       aspect_ratio=w / h)
    cfg = RenderConfig(width=w, height=h, samples_per_pixel=spp,
                       spp_chunk=1, max_depth=16, russian_roulette=True)
    with jax.default_device(devs[0]):
        ref, _ = path_tracer.render(scene, cfg, jax.random.PRNGKey(1))
        ref = np.asarray(jax.block_until_ready(ref))
    for n_px, n_spp in ((4, 1), (2, 2)):
        mesh = prender.make_mesh(n_px=n_px, n_spp=n_spp, devices=devs)
        t0 = time.time()
        img, rays = prender.render(scene, cfg, jax.random.PRNGKey(1), mesh)
        img = np.asarray(jax.block_until_ready(img))
        print(f"  pt scene_500 mesh ({n_px},{n_spp}): smoke wall "
              f"{time.time() - t0:.1f} s (with compilation), rays={int(rays)}")
        compare(f"pt scene_500 ({n_px},{n_spp})", img, ref)
    all_devices_worked("pt")

    w, n_ph = sppm_size
    cfg = RenderConfig(width=w, height=w, samples_per_pixel=16,
                       max_depth=50,
                       sppm=SPPMConfig(n_iterations=2,
                                       photons_per_iter=n_ph))
    scene = cornell_box()
    with jax.default_device(devs[0]):
        ref, _, _ = sppm.render(scene, cfg, jax.random.PRNGKey(2))
        ref = np.asarray(jax.block_until_ready(ref))
    mesh = prender.make_mesh(n_px=4, n_spp=1, devices=devs)
    t0 = time.time()
    img, rays, _ = render_sppm(scene, cfg, jax.random.PRNGKey(2), mesh)
    img = np.asarray(jax.block_until_ready(img))
    print(f"  sppm cornell mesh (4,1): smoke wall {time.time() - t0:.1f} s "
          f"(with compilation), rays={rays}")
    compare("sppm cornell (4,1)", img, ref)
    all_devices_worked("sppm")


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    four = "--four" in argv
    devs = device_phase(4 if four else 1)
    phases = ([("four cards", lambda: four_phase(devs))] if four else [
        ("closest-hit kernel", closest_hit_checks),
        ("photon-query kernel", photon_query_check),
        ("main-path lowering", lowering_check),
        ("main path", lambda: main_path_phase(devs[0])),
    ])
    for name, fn in phases:
        t0 = time.time()
        print(f"phase {name}:", flush=True)
        fn()
        print(f"phase {name}: ok ({time.time() - t0:.1f} s)", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        sys.exit(1)
