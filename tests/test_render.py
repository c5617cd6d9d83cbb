"""End-to-end render smoke tests on tiny images (CPU)."""

import pytest
import jax
import numpy as np

from raytracer.models import path_tracer
from raytracer.scene.builtin import cornell_box, three_spheres
from raytracer.utils.config import RenderConfig


def small_config(**kw):
    base = dict(width=32, height=32, samples_per_pixel=8, spp_chunk=4,
                max_depth=8)
    base.update(kw)
    return RenderConfig(**base)


@pytest.mark.slow
def test_three_spheres_renders_nonblack(key):
    scene = three_spheres(aspect_ratio=1.0)
    img, rays = path_tracer.render(scene, small_config(), key)
    img = np.asarray(img)
    assert img.shape == (32, 32, 3)
    assert np.all(np.isfinite(img))
    assert img.max() > 0.01          # the light is visible
    assert int(rays) > 32 * 32 * 8   # at least one bounce on average


@pytest.mark.slow
def test_cornell_renders(key):
    scene = cornell_box(with_mesh=True)
    img, rays = path_tracer.render(scene, small_config(samples_per_pixel=16), key)
    img = np.asarray(img)
    assert np.all(np.isfinite(img))
    # The box occupies the central ~55% of the frame (vfov 50 at distance
    # 1078 vs a 555-unit box); the border is black like the reference.
    # The area light (x 213-343, z 227-332 @ y=554) projects to roughly
    # rows 6-8, cols 14-18 at 32x32 — it must be directly visible & bright.
    assert img[4:11, 12:20].max() > 0.3
    # Direct view of the red wall (x=555, image-left band) vs blue (x=0,
    # image-right): u = cross(vup, w) points -x so +x is image-left.
    left = img[8:24, 7:9].mean(axis=(0, 1))
    right = img[8:24, 23:25].mean(axis=(0, 1))
    assert left[0] > left[2]   # red dominant
    assert right[2] > right[0]  # blue dominant


def test_render_deterministic(key):
    scene = three_spheres(aspect_ratio=1.0)
    img1, _ = path_tracer.render(scene, small_config(), key)
    img2, _ = path_tracer.render(scene, small_config(), key)
    np.testing.assert_array_equal(np.asarray(img1), np.asarray(img2))


@pytest.mark.slow
def test_empty_and_lightless_scenes_render_black(key):
    """Regression: zero-length material table used to crash the gather in
    scatter(); empty/lightless scenes must render black and finite."""
    from raytracer.scene import SceneBuilder
    empty = SceneBuilder()
    empty.set_camera((0, 0, 1), (0, 0, -1), vfov=60, aspect_ratio=1.0)
    img, _ = path_tracer.render(empty.compile(), small_config(), key)
    assert np.asarray(img).max() == 0.0 and np.isfinite(np.asarray(img)).all()

    nolight = SceneBuilder()
    m = nolight.lambertian(nolight.constant_texture((0.5, 0.5, 0.5)))
    nolight.add_sphere((0, 0, -2), 1.0, m)
    nolight.set_camera((0, 0, 1), (0, 0, -1), vfov=60, aspect_ratio=1.0)
    img2, _ = path_tracer.render(nolight.compile(), small_config(), key)
    assert np.asarray(img2).max() == 0.0 and np.isfinite(np.asarray(img2)).all()


def test_seed_changes_noise(key):
    scene = three_spheres(aspect_ratio=1.0)
    img1, _ = path_tracer.render(scene, small_config(), jax.random.PRNGKey(1))
    img2, _ = path_tracer.render(scene, small_config(), jax.random.PRNGKey(2))
    assert np.abs(np.asarray(img1) - np.asarray(img2)).max() > 0
