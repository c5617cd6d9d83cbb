"""SPPM integrator tests (tiny Cornell on CPU)."""

import jax
import pytest
import numpy as np

from raytracer.models import path_tracer, sppm
from raytracer.scene.builtin import cornell_box
from raytracer.utils.config import RenderConfig, SPPMConfig


def tiny_config(**kw):
    base = dict(
        width=24, height=24, samples_per_pixel=4, spp_chunk=2, max_depth=8,
        sppm=SPPMConfig(n_iterations=3, photons_per_iter=8000,
                        max_photon_bounces=6, max_camera_bounces=8,
                        max_photons_per_cell=32))
    base.update(kw)
    return RenderConfig(**base)


@pytest.mark.slow
def test_sppm_cornell_bright_and_finite(key):
    """The SPPM Cornell image must be far brighter than the naive-PT one:
    the light's photon power carries scale=1e6 (scene.rs:31) while its Le
    texture is only (1,1,1)."""
    scene = cornell_box(with_mesh=False)
    cfg = tiny_config()
    img, rays, state = sppm.render(scene, cfg, key)
    img = np.asarray(img)
    assert img.shape == (24, 24, 3)
    assert np.isfinite(img).all()
    img_pt, _ = path_tracer.render(scene, cfg, key)
    # compare interior region (borders are black in both)
    box = (slice(6, 18), slice(6, 18))
    assert img[box].mean() > 5.0 * float(np.asarray(img_pt)[box].mean())
    assert img[box].mean() > 0.05


@pytest.mark.slow
def test_sppm_state_evolves(key):
    scene = cornell_box(with_mesh=False)
    cfg = tiny_config()
    states = []
    img, rays, state = sppm.render(scene, cfg, key,
                                   checkpoint_cb=lambda s: states.append(s))
    assert len(states) == 3
    assert int(state.iteration) == 3
    # radii shrink monotonically where photons accumulate
    r1 = np.asarray(states[0].glob.radius2)
    r3 = np.asarray(states[2].glob.radius2)
    touched = (np.asarray(states[0].glob.photons) > 0) & \
              (np.asarray(states[2].glob.photons) > 0)
    assert touched.sum() > 50
    assert (r3[touched] <= r1[touched] + 1e-9).all()
    # photon counts only grow
    assert (np.asarray(states[2].glob.photons)[touched]
            >= np.asarray(states[0].glob.photons)[touched]).all()


@pytest.mark.slow
def test_sppm_resume_from_state(key):
    """Checkpoint/resume: rendering 1+2 iterations from a saved state equals
    running 3 straight (same keys)."""
    scene = cornell_box(with_mesh=False)
    cfg = tiny_config()
    img_a, _, state_a = sppm.render(scene, cfg, key)

    cfg1 = tiny_config(sppm=SPPMConfig(
        n_iterations=1, photons_per_iter=8000, max_photon_bounces=6,
        max_camera_bounces=8, max_photons_per_cell=32))
    _, _, state_1 = sppm.render(scene, cfg1, key)
    img_b, _, state_b = sppm.render(scene, cfg, key, state=state_1)
    np.testing.assert_allclose(np.asarray(state_a.glob.flux),
                               np.asarray(state_b.glob.flux), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(img_a), np.asarray(img_b),
                               rtol=1e-4, atol=1e-5)


def test_emit_photons_soa_matches_aos(key):
    """Component-wise emission must reproduce the AoS draws exactly (same
    threefry split structure)."""
    from raytracer.models.wavefront_soa import emit_photons_soa
    from raytracer.ops.lights import emit_photons
    scene = cornell_box(with_mesh=False)
    ph = emit_photons(scene.lights, key, 512)
    ox, oy, oz, dx, dy, dz, wr, wg, wb = emit_photons_soa(
        scene.lights, key, 512)
    np.testing.assert_allclose(np.asarray(ph.origin),
                               np.stack([ox, oy, oz], -1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ph.dir),
                               np.stack([dx, dy, dz], -1), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(ph.power),
                               np.stack([wr, wg, wb], -1), rtol=1e-6)


@pytest.mark.slow
def test_photon_regen_flux_matches_plain(key):
    """The regenerating photon pass is a different (but unbiased) stream
    assignment over the same per-photon process: total deposited flux and
    deposit counts must agree with the plain scan within MC tolerance, and
    the spawn budget must be met exactly."""
    from raytracer.models.wavefront_soa import (
        trace_photon_deposits_regen_soa, trace_photon_deposits_soa)
    scene = cornell_box(with_mesh=False)
    B, MB = 20000, 8
    eps = 1e-4 * float(scene.scale)
    plain = trace_photon_deposits_soa(scene, key, B, MB, 1e-4, eps, "xla")
    (rg, spawned) = trace_photon_deposits_regen_soa(
        scene, jax.random.fold_in(key, 1), B, MB, 1e-4, eps, "xla",
        lanes=4096, return_spawned=True)  # lanes << B -> exercises budget
    assert int(spawned) == B
    def tot(c):
        v = np.asarray(c[9])
        flux = np.stack([np.asarray(c[3]), np.asarray(c[4]),
                         np.asarray(c[5])], -1)[v]
        return flux.sum(0), v.sum(), np.asarray(c[10])[v].sum()
    f_p, n_p, c_p = tot(plain)
    f_r, n_r, c_r = tot(rg)
    assert abs(n_r - n_p) / n_p < 0.05           # deposit count
    np.testing.assert_allclose(f_r, f_p, rtol=0.05)   # total flux
    assert c_r <= B and c_p <= B                  # caustic <= one per path
    assert abs(c_r - c_p) / max(c_p, 1) < 0.25    # caustic count (small N)


@pytest.mark.slow
def test_photon_regen_budget_respected(key):
    """B <= lanes: the whole budget spawns at init, no rescale."""
    from raytracer.models.wavefront_soa import (
        trace_photon_deposits_regen_soa)
    scene = cornell_box(with_mesh=False)
    eps = 1e-4 * float(scene.scale)
    comps, spawned = trace_photon_deposits_regen_soa(
        scene, key, 8000, 6, 1e-4, eps, "xla", lanes=8000,
        return_spawned=True)
    assert int(spawned) == 8000          # B <= lanes: all spawn at init
    assert np.asarray(comps[9]).sum() > 0


@pytest.mark.slow
def test_photon_regen_window_close_rescale(key):
    """Force the window to close before the budget is spent: spawned < B,
    and the nominal/actual power rescale must keep the total deposited
    flux an unbiased estimate of the full-budget run's (same expectation
    per NOMINAL photon, since the estimator divides by B downstream)."""
    from raytracer.models.wavefront_soa import (
        trace_photon_deposits_regen_soa)
    scene = cornell_box(with_mesh=False)
    eps = 1e-4 * float(scene.scale)
    B, MB = 24000, 6

    def tot_flux(comps):
        v = np.asarray(comps[9])
        return np.stack([np.asarray(comps[3]), np.asarray(comps[4]),
                         np.asarray(comps[5])], -1)[v].sum(0)

    full, sp_full = trace_photon_deposits_regen_soa(
        scene, key, B, MB, 1e-4, eps, "xla", lanes=4096,
        return_spawned=True)
    short, sp_short = trace_photon_deposits_regen_soa(
        scene, jax.random.fold_in(key, 1), B, MB, 1e-4, eps, "xla",
        lanes=4096, return_spawned=True, spawn_window=3)
    assert int(sp_full) == B
    assert int(sp_short) < B             # window closed early
    f_full = tot_flux(full)
    f_short = tot_flux(short)
    # rescaled totals estimate the same quantity; ~9-12k photons actually
    # spawn, so a 12% band is ~4 sigma of the per-photon flux variance
    np.testing.assert_allclose(f_short, f_full, rtol=0.12)
