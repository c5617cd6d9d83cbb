"""SoA wavefront loops vs the AoS reference implementations.

The SoA paths (models/wavefront_soa.py) must be statistically equivalent
to the (N,3) AoS paths they replaced — same transport, same key streams.
The AoS loops remain in the tree for media/motion-blur/bruteforce scenes,
so these tests pin the two implementations together."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.models import path_tracer as pt
from raytracer.models import sppm as sppm_model
from raytracer.models.camera import camera_rays
from raytracer.scene.builtin import cornell_box, three_spheres
from raytracer.scene.loader import load_scene

import os
DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def _trace_aos(scene, o, d, key, **kw):
    """Call the AoS loop directly (bypassing the SoA dispatch) by asking
    for the bruteforce intersector, which takes the AoS reference loops."""
    return pt.trace_radiance(scene, o, d, key, intersector="bruteforce",
                             **kw)


@pytest.mark.slow
def test_soa_matches_aos_cornell():
    scene = cornell_box(with_mesh=True)
    n = 4096
    key = jax.random.PRNGKey(0)
    pix = jnp.arange(n, dtype=jnp.int32) % (64 * 64)
    o, d = camera_rays(scene.camera, key, pix, 64, 64)
    kw = dict(max_depth=8, t_min=1e-3, spawn_eps=0.1)
    r_soa = pt.trace_radiance(scene, o, d, key, intersector="xla", **kw)
    r_aos = _trace_aos(scene, o, d, key, **kw)
    # identical keys -> identical random streams; only FP association
    # differs between the component-wise and vector forms
    np.testing.assert_allclose(np.asarray(r_soa.radiance),
                               np.asarray(r_aos.radiance),
                               rtol=2e-3, atol=2e-3)
    assert int(r_soa.rays_traced) == int(r_aos.rays_traced)


@pytest.mark.slow
def test_soa_matches_aos_scene500_checker():
    scene = load_scene(os.path.join(DATA, "scene_500.json"))
    n = 4096
    rng = np.random.default_rng(1)
    o = jnp.asarray(rng.uniform([-11, 0.5, -11], [11, 3, 11], (n, 3)),
                    jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    key = jax.random.PRNGKey(2)
    kw = dict(max_depth=6, t_min=1e-3, spawn_eps=2.5e-3)
    r_soa = pt.trace_radiance(scene, o, d, key, intersector="xla", **kw)
    r_aos = _trace_aos(scene, o, d, key, **kw)
    np.testing.assert_allclose(np.asarray(r_soa.radiance),
                               np.asarray(r_aos.radiance),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.slow
def test_soa_measurement_matches_aos():
    scene = cornell_box(with_mesh=False)
    key = jax.random.PRNGKey(3)
    ids = jnp.arange(32 * 32, dtype=jnp.int32)
    kw = dict(width=32, height=32, max_depth=8, t_min=1e-3, spawn_eps=0.1)
    m_soa = sppm_model.measurement_pass(scene, key, ids,
                                        intersector="xla", **kw)
    m_aos = sppm_model.measurement_pass(scene, key, ids,
                                        intersector="bruteforce", **kw)
    v1, v2 = np.asarray(m_soa.valid), np.asarray(m_aos.valid)
    assert (v1 == v2).mean() > 0.999
    both = v1 & v2
    np.testing.assert_allclose(np.asarray(m_soa.p)[both],
                               np.asarray(m_aos.p)[both],
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(np.asarray(m_soa.bsdf)[both],
                               np.asarray(m_aos.bsdf)[both],
                               rtol=1e-3, atol=1e-3)


@pytest.mark.slow
def test_soa_gather_matches_aos():
    scene = cornell_box(with_mesh=False)
    n = 1024
    key = jax.random.PRNGKey(4)
    pix = jnp.arange(n, dtype=jnp.int32)
    o, d = camera_rays(scene.camera, key, pix, 32, 32)
    est = jnp.full((n, 3), 0.25, jnp.float32)
    kw = dict(max_depth=8, t_min=1e-3, spawn_eps=0.1)
    r_soa, rays_soa = sppm_model.gather_walk(scene, o, d, est, key,
                                             intersector="xla", **kw)
    r_aos, rays_aos = sppm_model.gather_walk(scene, o, d, est, key,
                                             intersector="bruteforce", **kw)
    np.testing.assert_allclose(np.asarray(r_soa), np.asarray(r_aos),
                               rtol=2e-3, atol=2e-3)
    assert int(rays_soa) == int(rays_aos)


@pytest.mark.slow
def test_soa_image_texture_scene():
    """Image textures take the stacked-gather fallback inside the SoA
    texture eval; an earthmap sphere must shade identically."""
    from raytracer.scene import SceneBuilder
    from PIL import Image
    tex_dir = os.path.join(os.path.dirname(__file__), "..", "texture")
    img = np.asarray(Image.open(os.path.join(tex_dir, "earthmap.jpg"))
                     .convert("RGB"))
    b = SceneBuilder()
    m = b.lambertian(b.image_texture(img))
    b.add_sphere((0, 0, -4), 2.0, m)
    lm = b.diffuse_light(b.constant_texture((4, 4, 4)))
    b.add_sphere((0, 6, -4), 1.0, lm)
    scene = b.compile()
    n = 2048
    rng = np.random.default_rng(6)
    o = jnp.zeros((n, 3), jnp.float32)
    d = jnp.asarray(np.stack([rng.uniform(-0.5, 0.5, n),
                              rng.uniform(-0.5, 0.5, n),
                              -np.ones(n)], -1), jnp.float32)
    key = jax.random.PRNGKey(5)
    kw = dict(max_depth=4, t_min=1e-3, spawn_eps=1e-3)
    r_soa = pt.trace_radiance(scene, o, d, key, intersector="xla", **kw)
    r_aos = _trace_aos(scene, o, d, key, **kw)
    np.testing.assert_allclose(np.asarray(r_soa.radiance),
                               np.asarray(r_aos.radiance),
                               rtol=2e-3, atol=2e-3)


@pytest.fixture(autouse=True, scope="module")
def _fresh_compile_state():
    """The drain-cascade tests compile the largest programs in the suite
    (multi-level while_loops, several pallas programs each); after ~150
    accumulated test compiles in one process, XLA:CPU segfaulted inside
    backend_compile on exactly these programs (reproducibly, full-suite
    only — both suite halves pass in isolation). Dropping the accumulated
    executables first avoids whatever compiler state trips it."""
    import jax
    jax.clear_caches()
    yield


@pytest.mark.slow
def test_regen_drain_compaction_unbiased(key):
    """The two-phase drain (one-shot compaction of straggler lanes into a
    small wavefront) is a pure state reorganization: phase-1 streams are
    identical to the single-loop path up to the compaction point, every
    sample completes under the same law, and the per-pixel sums must agree
    with the single-loop render within MC tolerance. Also: determinism and
    exact per-pixel sample accounting (rays > 0, finite)."""
    from raytracer.models import wavefront_soa as ws
    scene = three_spheres(1.0)
    kw = dict(width=24, height=16, lanes_per_pixel=2, samples_per_lane=8,
              max_depth=8, t_min=1e-3, spawn_eps=0.01, intersector="xla",
              russian_roulette=True)
    img1, rays1, steps1 = ws.render_regen_soa(scene, key, **kw)  # single-loop
    old_min = ws.DRAIN_MIN_LANES
    try:
        ws.DRAIN_MIN_LANES = 256     # force a two-level cascade
        img2, rays2, steps2 = ws.render_regen_soa(scene, key, **kw)
        img2b, rays2b, _ = ws.render_regen_soa(scene, key, **kw)
    finally:
        ws.DRAIN_MIN_LANES = old_min
    np.testing.assert_array_equal(np.asarray(img2), np.asarray(img2b))
    assert int(rays2) == int(rays2b)
    assert np.isfinite(np.asarray(img2)).all()
    spp = 16
    m1 = np.asarray(img1).mean() / spp
    m2 = np.asarray(img2).mean() / spp
    # same estimator, different post-compaction streams -> MC band
    assert abs(m1 - m2) / max(m1, 1e-9) < 0.06, (m1, m2)


@pytest.mark.slow
def test_gather_regen_drain_compaction(key):
    """Same two-phase drain check for the SPPM gather twin."""
    from raytracer.models import wavefront_soa as ws
    scene = cornell_box(with_mesh=False)
    npix = 24 * 24
    est = jnp.ones((npix, 3), jnp.float32) * 0.3
    kw = dict(width=24, height=24, lanes_per_pixel=2, samples_per_lane=6,
              max_depth=12, t_min=1e-3, spawn_eps=0.05, intersector="xla")
    a1, r1, _ = ws.gather_regen_soa(scene, est, key, **kw)
    old_min = ws.DRAIN_MIN_LANES
    try:
        ws.DRAIN_MIN_LANES = 256     # force a two-level cascade
        a2, r2, _ = ws.gather_regen_soa(scene, est, key, **kw)
    finally:
        ws.DRAIN_MIN_LANES = old_min
    assert np.isfinite(np.asarray(a2)).all()
    m1 = np.asarray(a1).mean()
    m2 = np.asarray(a2).mean()
    assert abs(m1 - m2) / max(m1, 1e-9) < 0.06, (m1, m2)


@pytest.mark.slow
def test_sorted_bounce_bitwise_matches_unsorted(key):
    """bounce_step(sort=True) Morton-permutes lanes around the kernel call
    and inverse-permutes the outputs; lanes are independent and their
    uniform rows travel with them, so every output must be BIT-identical
    to the unsorted call (mixed alive)."""
    from raytracer.models.wavefront_soa import bounce_step
    scene = three_spheres()
    n = 2048
    k1, k2, k3 = jax.random.split(key, 3)
    o = jax.random.uniform(k1, (n, 3), minval=-6, maxval=6)
    d = jax.random.normal(k2, (n, 3))
    d = d / jnp.linalg.norm(d, axis=-1, keepdims=True)
    alive = jax.random.uniform(k3, (n,)) > 0.3
    U = jax.random.uniform(jax.random.fold_in(key, 5), (4, n))
    comps = [o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2]]
    kw = dict(t_min=1e-3, spawn_eps=1e-3, intersector="xla")
    b0 = bounce_step(scene, U, *comps, alive, sort=False, **kw)
    b1 = bounce_step(scene, U, *comps, alive, sort=True, **kw)
    for name, x, y in zip(b0._fields, b0, b1):
        assert np.array_equal(np.asarray(x), np.asarray(y)), name


def test_use_sort_gate():
    """Sort is OFF unless the variable asks for it, and only ever wraps
    the kernel (the sorted path stays bit-identical, pinned by
    test_sorted_bounce_bitwise_matches_unsorted)."""
    import os
    from raytracer.models.wavefront_soa import use_sort
    from raytracer.scene.builtin import sphere_field
    small = three_spheres()
    big = sphere_field(8192)
    assert not use_sort(small, "pallas")
    assert not use_sort(big, "pallas")
    assert not use_sort(big, "xla")
    os.environ["RAYTRACER_RAY_SORT"] = "1"
    try:
        assert use_sort(small, "pallas")
        assert use_sort(big, "pallas")
        assert not use_sort(big, "xla")
    finally:
        os.environ.pop("RAYTRACER_RAY_SORT", None)


