"""Per-primitive intersection oracle tests (the reference has none — this is
the upgrade demanded by SURVEY.md §4)."""

import jax.numpy as jnp
import numpy as np

from raytracer.ops import intersect as ix
from raytracer.scene import SceneBuilder
from raytracer.scene.types import PRIM_RECT, PRIM_TRIANGLE


def rays(*pairs):
    o = jnp.array([p[0] for p in pairs], jnp.float32)
    d = jnp.array([p[1] for p in pairs], jnp.float32)
    return o, d


def build_sphere_scene():
    b = SceneBuilder()
    m = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    b.add_sphere((0, 0, -2), 1.0, m)
    b.add_sphere((5, 0, -2), 1.0, m)
    return b.compile()


class TestSphere:
    def test_direct_hit(self):
        s = build_sphere_scene()
        o, d = rays(([0, 0, 0], [0, 0, -1]))
        t, i = ix.sphere_closest(o, d, s.spheres, 1e-3, jnp.inf)
        np.testing.assert_allclose(np.asarray(t), [1.0], rtol=1e-5)
        assert int(i[0]) == 0

    def test_miss(self):
        s = build_sphere_scene()
        o, d = rays(([0, 0, 0], [0, 1, 0]))
        t, _ = ix.sphere_closest(o, d, s.spheres, 1e-3, jnp.inf)
        assert np.isinf(np.asarray(t))[0]

    def test_inside_sphere_takes_far_root(self):
        s = build_sphere_scene()
        o, d = rays(([0, 0, -2], [0, 0, -1]))  # at center
        t, _ = ix.sphere_closest(o, d, s.spheres, 1e-3, jnp.inf)
        np.testing.assert_allclose(np.asarray(t), [1.0], rtol=1e-5)

    def test_t_window_excludes_near_root(self):
        s = build_sphere_scene()
        o, d = rays(([0, 0, 0], [0, 0, -1]))
        # t_min beyond near root 1.0 -> far root 3.0 (sphere.rs:36-43)
        t, _ = ix.sphere_closest(o, d, s.spheres, 1.5, jnp.inf)
        np.testing.assert_allclose(np.asarray(t), [3.0], rtol=1e-5)

    def test_unnormalized_dir(self):
        s = build_sphere_scene()
        o, d = rays(([0, 0, 0], [0, 0, -10]))
        t, _ = ix.sphere_closest(o, d, s.spheres, 1e-4, jnp.inf)
        np.testing.assert_allclose(np.asarray(t), [0.1], rtol=1e-5)

    def test_closest_of_two(self):
        s = build_sphere_scene()
        o, d = rays(([5, 0, 5], [0, 0, -1]))
        t, i = ix.sphere_closest(o, d, s.spheres, 1e-3, jnp.inf)
        assert int(i[0]) == 1
        np.testing.assert_allclose(np.asarray(t), [6.0], rtol=1e-5)

    def test_chunking_matches_unchunked(self, key):
        import jax
        b = SceneBuilder()
        m = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
        rng = np.random.default_rng(0)
        for _ in range(777):  # deliberately not a chunk multiple
            b.add_sphere(rng.uniform(-10, 10, 3), rng.uniform(0.1, 1.0), m)
        s = b.compile()
        o = jnp.asarray(rng.uniform(-12, 12, (256, 3)), jnp.float32)
        d = jnp.asarray(rng.normal(size=(256, 3)), jnp.float32)
        t1, i1 = ix.sphere_closest(o, d, s.spheres, 1e-3, jnp.inf, chunk=64)
        t2, i2 = ix.sphere_closest(o, d, s.spheres, 1e-3, jnp.inf, chunk=1024)
        t1, t2 = np.asarray(t1), np.asarray(t2)
        # XLA fuses the quadratic differently per shape (FMA contraction), so
        # grazing hits may wobble ~1e-4; require agreement within that.
        both_hit = np.isfinite(t1) & np.isfinite(t2)
        assert (np.isfinite(t1) == np.isfinite(t2)).mean() > 0.99
        np.testing.assert_allclose(t1[both_hit], t2[both_hit], atol=5e-3, rtol=1e-4)
        assert (np.asarray(i1) == np.asarray(i2)).mean() > 0.99


class TestRect:
    def build(self):
        b = SceneBuilder()
        m = b.lambertian(b.constant_texture((1, 1, 1)))
        b.add_xy_rect(0, 0, 2, 2, -3.0, m)   # z = -3 plane
        b.add_xz_rect(0, 0, 2, 2, 5.0, m)    # y = 5
        b.add_yz_rect(0, 0, 2, 2, -1.0, m)   # x = -1
        return b.compile()

    def test_xy_hit_and_uv(self):
        s = self.build()
        o, d = rays(([0.5, 1.0, 0.0], [0, 0, -1]))
        hit = ix.intersect_bruteforce(s, o, d, 1e-3, jnp.inf)
        attrs = ix.hit_attributes(s, o, d, hit)
        np.testing.assert_allclose(np.asarray(hit.t), [3.0], rtol=1e-5)
        assert int(hit.prim_type[0]) == PRIM_RECT
        # uv = ((x-x0)/(x1-x0), (y-y0)/(y1-y0)) rectangle.rs:32
        np.testing.assert_allclose(np.asarray(attrs.uv[0]), [0.25, 0.5], atol=1e-5)
        # normal flipped against ray: ray goes -z, outward normal +z
        np.testing.assert_allclose(np.asarray(attrs.normal[0]), [0, 0, 1], atol=1e-6)
        assert bool(attrs.front_face[0])

    def test_bounds_miss(self):
        s = self.build()
        o, d = rays(([3.0, 1.0, 0.0], [0, 0, -1]))
        hit = ix.intersect_bruteforce(s, o, d, 1e-3, jnp.inf)
        assert np.isinf(np.asarray(hit.t))[0]

    def test_parallel_ray_no_nan(self):
        s = self.build()
        o, d = rays(([0.5, 1.0, 0.0], [1, 0, 0]))  # parallel to XY plane
        hit = ix.intersect_bruteforce(s, o, d, 1e-3, jnp.inf)
        assert np.isinf(np.asarray(hit.t))[0]

    def test_yz_uv_order(self):
        s = self.build()
        o, d = rays(([2.0, 0.5, 1.5], [-1, 0, 0]))
        hit = ix.intersect_bruteforce(s, o, d, 1e-3, jnp.inf)
        attrs = ix.hit_attributes(s, o, d, hit)
        assert int(hit.prim_type[0]) == PRIM_RECT and int(hit.prim_idx[0]) == 2
        # uv = ((y-y0)/(y1-y0), (z-z0)/(z1-z0)) rectangle.rs:107
        np.testing.assert_allclose(np.asarray(attrs.uv[0]), [0.25, 0.75], atol=1e-5)


class TestTriangle:
    def build(self):
        b = SceneBuilder()
        m = b.lambertian(b.constant_texture((1, 1, 1)))
        pos = np.array([[0, 0, -2], [2, 0, -2], [0, 2, -2]], np.float32)
        idx = np.array([[0, 1, 2]], np.int32)
        nrm = np.array([[0, 0, 1]] * 3, np.float32)
        b.add_triangles(pos, idx, m, normals=nrm)
        return b.compile()

    def test_hit_inside(self):
        s = self.build()
        o, d = rays(([0.5, 0.5, 0.0], [0, 0, -1]))
        hit = ix.intersect_bruteforce(s, o, d, 1e-3, jnp.inf)
        attrs = ix.hit_attributes(s, o, d, hit)
        np.testing.assert_allclose(np.asarray(hit.t), [2.0], rtol=1e-5)
        assert int(hit.prim_type[0]) == PRIM_TRIANGLE
        np.testing.assert_allclose(np.asarray(attrs.normal[0]), [0, 0, 1], atol=1e-6)
        # triangle UV is (0,0) — mesh.rs:130-136
        np.testing.assert_allclose(np.asarray(attrs.uv[0]), [0, 0])

    def test_miss_outside(self):
        s = self.build()
        o, d = rays(([1.5, 1.5, 0.0], [0, 0, -1]))  # beyond hypotenuse
        hit = ix.intersect_bruteforce(s, o, d, 1e-3, jnp.inf)
        assert np.isinf(np.asarray(hit.t))[0]

    def test_edge_on_ray_is_miss(self):
        s = self.build()
        o, d = rays(([0.5, 0.5, 0.0], [1, 0, 0]))  # in-plane direction
        hit = ix.intersect_bruteforce(s, o, d, 1e-3, jnp.inf)
        assert np.isinf(np.asarray(hit.t))[0]


class TestUnified:
    def test_closest_across_types(self):
        b = SceneBuilder()
        m = b.lambertian(b.constant_texture((1, 1, 1)))
        b.add_sphere((0, 0, -5), 1.0, m)        # hit at t=4
        b.add_xy_rect(-1, -1, 1, 1, -2.0, m)    # hit at t=2 (closer)
        s = b.compile()
        o, d = rays(([0, 0, 0], [0, 0, -1]))
        hit = ix.intersect_bruteforce(s, o, d, 1e-3, jnp.inf)
        assert int(hit.prim_type[0]) == PRIM_RECT
        np.testing.assert_allclose(np.asarray(hit.t), [2.0], rtol=1e-5)

    def test_sphere_uv_poles(self):
        b = SceneBuilder()
        m = b.lambertian(b.constant_texture((1, 1, 1)))
        b.add_sphere((0, 0, 0), 1.0, m)
        s = b.compile()
        o, d = rays(([0, 3, 0], [0, -1, 0]))  # hits north pole
        hit = ix.intersect_bruteforce(s, o, d, 1e-3, jnp.inf)
        attrs = ix.hit_attributes(s, o, d, hit)
        # get_uv (sphere.rs:16-21): theta=acos(-y), at y=+1 -> v=1
        np.testing.assert_allclose(float(attrs.uv[0, 1]), 1.0, atol=1e-4)
