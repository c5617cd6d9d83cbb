"""Golden-image regression tests with Monte-Carlo tolerance bands
(SURVEY.md §4: the reference's only integration test is a human looking at
the CI artifact; these are the automated version — mean/percentile bands,
not pixel-exact, so backend/version FP drift doesn't false-alarm while real
transport regressions do).

These goldens are self-generated regression ANCHORS; absolute correctness
is established separately by tests/test_reference_parity.py (independent
f64 oracle) and the analytic oracles in test_render/test_nee."""

import os

import jax
import pytest
import numpy as np

from raytracer.models import path_tracer, sppm
from raytracer.scene.builtin import cornell_box, three_spheres
from raytracer.utils.config import RenderConfig, SPPMConfig

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def check_against(golden_name, img):
    ref = np.load(os.path.join(GOLDEN, golden_name))["img"]
    img = np.asarray(img)
    assert img.shape == ref.shape
    # gamma space comparisons (matches what a viewer sees)
    a = np.sqrt(np.clip(img, 0, None))
    b = np.sqrt(np.clip(ref, 0, None))
    # global brightness within 5%
    assert abs(a.mean() - b.mean()) < 0.05 * max(b.mean(), 1e-6), (
        f"mean {a.mean():.4f} vs golden {b.mean():.4f}")
    # per-pixel: 95th percentile of |diff| under MC-noise band
    diff = np.abs(a - b)
    assert np.percentile(diff, 95) < 0.30, (
        f"p95 diff {np.percentile(diff, 95):.3f}")
    assert diff.mean() < 0.08, f"mean diff {diff.mean():.3f}"


@pytest.mark.slow
def test_golden_three_spheres():
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=64, spp_chunk=8,
                       max_depth=12)
    img, _ = path_tracer.render(three_spheres(1.0), cfg, jax.random.PRNGKey(7))
    check_against("three_spheres_32.npz", img)


@pytest.mark.slow
def test_golden_cornell_sppm():
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=32, spp_chunk=8,
                       max_depth=12,
                       sppm=SPPMConfig(n_iterations=4, photons_per_iter=20000,
                                       max_photon_bounces=8,
                                       max_camera_bounces=12,
                                       max_photons_per_cell=64))
    img, _, _ = sppm.render(cornell_box(with_mesh=True), cfg,
                            jax.random.PRNGKey(7))
    check_against("cornell_sppm_32.npz", img)


@pytest.mark.slow
def test_golden_motion_field():
    """Regression anchor for the motion-blur path (kernel velocity rows +
    regen per-sample times): a different seed partition or a c+v*t change
    shifts the blur and trips the bands."""
    from raytracer.scene.builtin import motion_field
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=64, spp_chunk=8,
                       max_depth=8)
    img, _ = path_tracer.render(motion_field(64, aspect_ratio=1.0), cfg,
                                jax.random.PRNGKey(7))
    check_against("motion_field_32.npz", img)
