"""Scene-file loader tests against the shipped data/ files (SURVEY.md §2.21)."""

import os

import jax
import numpy as np
import pytest

from raytracer.models import path_tracer
from raytracer.scene.loader import load_scene
from raytracer.utils.config import RenderConfig

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def test_scene_10_counts():
    s = load_scene(os.path.join(DATA, "scene_10.json"))
    assert s.spheres.radius.shape[0] == 25
    # 11 DiffuseLight spheres register as photon lights
    assert s.lights.kind.shape[0] == 11
    np.testing.assert_allclose(float(s.lights.prob.sum()), 1.0, rtol=1e-5)


def test_scene_200_no_bvh_counts():
    s = load_scene(os.path.join(DATA, "scene_200_no_bvh.json"))
    assert s.spheres.radius.shape[0] == 405


def test_scene_500_counts():
    s = load_scene(os.path.join(DATA, "scene_500.json"))
    assert s.spheres.radius.shape[0] == 1005


def test_yaml_equals_json():
    sj = load_scene(os.path.join(DATA, "scene_10.json"))
    sy = load_scene(os.path.join(DATA, "scene_10.yaml"))
    np.testing.assert_allclose(np.asarray(sj.spheres.center),
                               np.asarray(sy.spheres.center))
    np.testing.assert_allclose(np.asarray(sj.spheres.radius),
                               np.asarray(sy.spheres.radius))
    np.testing.assert_array_equal(np.asarray(sj.materials.kind),
                                  np.asarray(sy.materials.kind))


def test_test_json_variant_schema():
    s = load_scene(os.path.join(DATA, "test.json"))
    assert s.spheres.radius.shape[0] == 1
    assert float(s.spheres.radius[0]) == 100.0


def test_camera_fields():
    s = load_scene(os.path.join(DATA, "scene_10.json"))
    np.testing.assert_allclose(np.asarray(s.camera.origin), [-6, 2, -6])
    # lens radius = aperture/2 = 0.05 (camera.rs:53)
    np.testing.assert_allclose(float(s.camera.lens_radius), 0.05)


def test_material_dedup():
    s = load_scene(os.path.join(DATA, "scene_500.json"))
    # 1005 spheres but far fewer unique materials
    assert s.materials.kind.shape[0] < 1005


@pytest.mark.slow
def test_render_scene_10(key):
    s = load_scene(os.path.join(DATA, "scene_10.json"))
    cfg = RenderConfig(width=40, height=40, samples_per_pixel=8, spp_chunk=4,
                       max_depth=8)
    img, rays = path_tracer.render(s, cfg, key)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert img.max() > 0.05  # glowing marble scene is clearly non-black


def test_bad_file_fails_fast(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text('{"objects": {"type": "Frobnicator"}, "camera": {}}')
    with pytest.raises(ValueError, match="Frobnicator"):
        load_scene(str(p))


def test_moving_sphere_extension_schema(tmp_path):
    """MovingSphere {center0, center1} (extension — SURVEY.md §8: the
    reference files carry no motion) plus camera time0/time1 compile to a
    motion-marked scene that sweeps over the shutter."""
    import json
    doc = {
        "objects": {"type": "HitableList", "items": [
            {"type": "MovingSphere",
             "center0": {"x": -2.0, "y": 0.0, "z": 0.0},
             "center1": {"x": 2.0, "y": 0.0, "z": 0.0},
             "radius": 1.0,
             "material": {"type": "Lambertian", "albedo": {
                 "type": "ConstantTexture",
                 "color": {"x": 0.5, "y": 0.5, "z": 0.5}}}},
            {"type": "Sphere",
             "center": {"x": 0.0, "y": -101.0, "z": 0.0},
             "center1": {"x": 0.0, "y": -100.0, "z": 0.0},
             "radius": 100.0,
             "material": {"type": "Lambertian", "albedo": {
                 "type": "ConstantTexture",
                 "color": {"x": 0.5, "y": 0.5, "z": 0.5}}}},
        ]},
        "camera": {"look_from": {"x": 0.0, "y": 0.0, "z": 10.0},
                   "look_at": {"x": 0.0, "y": 0.0, "z": 0.0},
                   "vup": {"x": 0.0, "y": 1.0, "z": 0.0},
                   "vfov": 40.0, "time0": 0.25, "time1": 0.75},
    }
    p = tmp_path / "motion.json"
    p.write_text(json.dumps(doc))
    s = load_scene(str(p))
    assert s.spheres.motion_marker.shape[0] == 1   # scene is motion-marked
    assert s.spheres.velocity.shape[0] == 2        # per-sphere velocities
    v = np.asarray(s.spheres.velocity)
    np.testing.assert_allclose(sorted(np.abs(v).max(1)), [1.0, 4.0])
    np.testing.assert_allclose(float(s.camera.time0), 0.25)
    np.testing.assert_allclose(float(s.camera.time1), 0.75)


def test_sppm_rejects_motion_scenes():
    """SPPM has no shutter-time dimension; a moving scene must fail fast
    instead of silently freezing at t=0 (failure-detection parity,
    SURVEY.md §5.3)."""
    import jax
    from raytracer.models import sppm
    from raytracer.scene import SceneBuilder
    from raytracer.utils.config import RenderConfig, SPPMConfig

    b = SceneBuilder()
    b.add_sphere_light((0.0, 5.0, 0.0), 1.0, (4.0, 4.0, 4.0), 1.0)
    m = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    b.add_moving_sphere((-1.0, 0.0, 0.0), (1.0, 0.0, 0.0), 1.0, m)
    b.set_camera((0.0, 0.0, 10.0), (0.0, 0.0, 0.0), time0=0.0, time1=1.0)
    scene = b.compile()
    cfg = RenderConfig(width=8, height=8, samples_per_pixel=1,
                       sppm=SPPMConfig(n_iterations=1, photons_per_iter=128))
    with pytest.raises(ValueError, match="motion"):
        sppm.render(scene, cfg, jax.random.PRNGKey(0))
