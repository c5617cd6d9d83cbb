"""Sharded SPPM iteration on the 8-virtual-device mesh."""

import numpy as np
import pytest

from raytracer.models import sppm as sppm_model
from raytracer.parallel import render as prender
from raytracer.parallel.sppm import sppm_iteration_sharded
from raytracer.scene.builtin import cornell_box


def run_iters(n_iters, key):
    scene = cornell_box(with_mesh=False)
    W = H = 24
    state = sppm_model.init_state(W * H)
    mesh = prender.make_mesh(n_px=8, n_spp=1)
    kw = dict(mesh=mesh, width=W, height=H, n_photons=8000,
              max_photon_bounces=6, max_camera_bounces=8,
              grid_res=(8, 8, 8), k_per_cell=32, alpha=0.7,
              k_global=100.0, k_caustic=50.0, t_min=1e-3, photon_t_min=1e-4,
              spawn_eps_rel=1e-4, query_chunk=128)
    for _ in range(n_iters):
        state = sppm_iteration_sharded(scene, state, key, **kw)
    return scene, state


@pytest.mark.slow
def test_sharded_sppm_state_behaves(key):
    scene, state = run_iters(2, key)
    g = state.glob
    photons = np.asarray(g.photons)
    assert int(state.iteration) == 2
    assert (photons > 0).mean() > 0.2          # plenty of pixels touched
    r2 = np.asarray(g.radius2)[photons > 0]
    assert np.isfinite(r2).all() and (r2 > 0).all()
    flux = np.asarray(g.flux)
    assert np.isfinite(flux).all() and flux.max() > 0


@pytest.mark.slow
def test_sharded_sppm_gather_image(key):
    scene, state = run_iters(2, key)
    img, rays = sppm_model.gather_fn(
        scene, state, key, width=24, height=24, spp=4, spp_chunk=2,
        max_depth=8, t_min=1e-3, spawn_eps_rel=1e-4,
        n_total_photons=2 * 8000)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert img[6:18, 6:18].mean() > 0.01  # lit interior


@pytest.mark.slow
def test_sharded_gather_matches_single_device(key):
    """The SHARDED final gather must agree statistically with the
    single-device gather_fn on the same state (camera.rs:66-128 executor
    parity across the mesh)."""
    from raytracer.parallel.sppm import sppm_gather_sharded
    scene, state = run_iters(2, key)
    mesh = prender.make_mesh(n_px=4, n_spp=2)
    common = dict(width=24, height=24, max_depth=8, t_min=1e-3,
                  spawn_eps_rel=1e-4, n_total_photons=2 * 8000)
    img1, rays1 = sppm_model.gather_fn(scene, state, key, spp=128,
                                       spp_chunk=8, **common)
    img2, rays2 = sppm_gather_sharded(scene, state, key, mesh=mesh, spp=128,
                                      spp_chunk=8, **common)
    img1, img2 = np.asarray(img1), np.asarray(img2)
    assert np.isfinite(img2).all()
    assert int(rays2) > 0
    # different RNG streams -> MC noise; compare means over the interior.
    # At 128 spp the measured worst-over-5-seeds deviation is 0.41% (the
    # gather estimator is low-variance: density estimates + specular Le),
    # so 3% catches any systematic flux bug while staying noise-proof.
    m1 = img1[4:20, 4:20].mean()
    m2 = img2[4:20, 4:20].mean()
    assert abs(m1 - m2) / max(m1, 1e-9) < 0.03, (m1, m2)


@pytest.mark.slow
def test_sharded_full_render_smoke(key):
    """render_sppm end to end (iterations + gather) on the CPU mesh."""
    import dataclasses
    from raytracer.parallel.sppm import render_sppm
    from raytracer.utils.config import RenderConfig, SPPMConfig
    scene = cornell_box(with_mesh=False)
    cfg = RenderConfig(
        width=16, height=16, samples_per_pixel=2, max_depth=6, spp_chunk=2,
        sppm=SPPMConfig(n_iterations=1, photons_per_iter=4000,
                        max_photon_bounces=4, max_camera_bounces=6))
    mesh = prender.make_mesh(n_px=8, n_spp=1)
    img, rays, state = render_sppm(scene, cfg, key, mesh=mesh)
    img = np.asarray(img)
    assert img.shape == (16, 16, 3)
    assert np.isfinite(img).all()
    assert int(state.iteration) == 1
