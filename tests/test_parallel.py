"""Multi-chip sharding tests on the 8-virtual-CPU-device mesh."""

import jax
import pytest
import numpy as np

from raytracer.parallel import render as prender
from raytracer.models import path_tracer
from raytracer.scene.builtin import three_spheres
from raytracer.utils.config import RenderConfig


def cfg(**kw):
    base = dict(width=32, height=24, samples_per_pixel=8, spp_chunk=4,
                max_depth=6)
    base.update(kw)
    return RenderConfig(**base)


def test_8dev_mesh_available():
    assert len(jax.devices()) == 8


@pytest.mark.slow
def test_px_sharded_render_runs(key):
    scene = three_spheres(aspect_ratio=32 / 24)
    mesh = prender.make_mesh(n_px=8, n_spp=1)
    img, rays = prender.render(scene, cfg(), key, mesh)
    img = np.asarray(img)
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all() and img.max() > 0.01
    assert int(rays) > 0


@pytest.mark.slow
def test_2d_mesh_px_times_spp(key):
    scene = three_spheres(aspect_ratio=32 / 24)
    mesh = prender.make_mesh(n_px=4, n_spp=2)
    img, rays = prender.render(scene, cfg(), key, mesh)
    img = np.asarray(img)
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all() and img.max() > 0.01


@pytest.mark.slow
def test_sharded_vs_single_device_statistics(key):
    """Sharded and single-device renders use different RNG partitions, so
    images agree statistically, not bitwise: compare means.

    256 spp + NEE cut the estimator's direct-light variance enough for a
    6% band (measured worst over 5 seeds: 3.5%; without NEE the same spp
    still spreads 6.9%) — tight enough to catch a systematic few-percent
    flux bug in the sharded path, which the old 15% band at 32 spp let
    through."""
    scene = three_spheres(aspect_ratio=1.0)
    c = cfg(width=16, height=16, samples_per_pixel=256, spp_chunk=8,
            nee=True)
    img1, _ = path_tracer.render(scene, c, key)
    mesh = prender.make_mesh(n_px=8, n_spp=1)
    img2, _ = prender.render(scene, c, key, mesh)
    m1 = float(np.asarray(img1).mean())
    m2 = float(np.asarray(img2).mean())
    assert abs(m1 - m2) / max(m1, 1e-6) < 0.06


@pytest.mark.slow
def test_spp_axis_psum_equivalence(key):
    """A (1,8) spp-only mesh must average 8 independent sample streams —
    the image should be *less* noisy than a single shard, same mean."""
    scene = three_spheres(aspect_ratio=1.0)
    c = cfg(width=16, height=16, samples_per_pixel=8, spp_chunk=1)
    mesh = prender.make_mesh(n_px=1, n_spp=8)
    img, rays = prender.render(scene, c, key, mesh)
    assert np.isfinite(np.asarray(img)).all()
    # 8 chips x ceil(8/8)=1 sample each + primaries counted once per chip
    assert int(rays) >= 16 * 16 * 8


@pytest.mark.slow
def test_pixel_padding_nondivisible(key):
    """npix not divisible by n_px exercises the pad path."""
    scene = three_spheres(aspect_ratio=30 / 22)
    c = cfg(width=30, height=22)   # 660 pixels, not divisible by 8
    mesh = prender.make_mesh(n_px=8, n_spp=1)
    img, _ = prender.render(scene, c, key, mesh)
    assert np.asarray(img).shape == (22, 30, 3)
    assert np.isfinite(np.asarray(img)).all()


@pytest.mark.slow
def test_sharded_motion_blur_threads_times(key):
    """Moving scenes must draw per-sample shutter times under shard_map
    (parallel/render.py regen + fallback paths). A silent t=0 freeze —
    the pre-fix behavior — leaves the sweep's far end black: the emissive
    sphere travels from x=-3 (t=0) to x=+3 (t=1), so blur must reach the
    right columns. Sharded and single-chip means over that region agree
    statistically (independent RNG partitions)."""
    from raytracer.scene import SceneBuilder

    b = SceneBuilder()
    lit = b.diffuse_light(b.constant_texture((4.0, 4.0, 4.0)))
    b.add_moving_sphere((-3.0, 0.0, 0.0), (3.0, 0.0, 0.0), 1.0, lit)
    b.set_camera((0.0, 0.0, 12.0), (0.0, 0.0, 0.0), time0=0.0, time1=1.0)
    scene = b.compile(aspect_ratio=1.0)

    c = cfg(width=32, height=32, samples_per_pixel=32, spp_chunk=8,
            max_depth=4)
    mesh = prender.make_mesh(n_px=8, n_spp=1)
    img_sh, _ = prender.render(scene, c, key, mesh)
    right_sh = float(np.asarray(img_sh)[:, 20:, :].mean())
    assert right_sh > 1e-3  # frozen-at-t0 renders this region exactly 0

    img1, _ = path_tracer.render(scene, c, key)
    right1 = float(np.asarray(img1)[:, 20:, :].mean())
    assert abs(right_sh - right1) / max(right1, 1e-6) < 0.25
