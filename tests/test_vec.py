"""Port of the reference Vec3 unit suite (vec3.rs:425-564) to batched ops,
plus batched-broadcast cases the reference cannot express."""

import jax.numpy as jnp
import numpy as np

from raytracer.ops import vec


def v(x, y, z):
    return jnp.array([x, y, z], dtype=jnp.float32)


class TestArithmetic:
    # vec3.rs test_add / test_sub / test_mul(dot) / elemul / scalar ops
    def test_add(self):
        np.testing.assert_allclose(v(1, 0, -1) + v(2, 4, 6), v(3, 4, 5))

    def test_sub(self):
        np.testing.assert_allclose(v(1, 0, -1) - v(2, 4, 6), v(-1, -4, -7))

    def test_dot(self):
        # (1,0,-1) . (2,4,6) = -4   vec3.rs test_mul
        assert vec.dot(v(1, 0, -1), v(2, 4, 6)) == -4.0

    def test_elemul(self):
        np.testing.assert_allclose(v(1, 0, -1) * v(2, 4, 6), v(2, 0, -6))

    def test_cross(self):
        # (1,2,3) x (2,3,4) = (-1,2,-1)  vec3.rs test_cross pattern
        np.testing.assert_allclose(
            vec.cross(v(1, 2, 3), v(2, 3, 4)), v(-1, 2, -1), atol=1e-6)

    def test_neg(self):
        np.testing.assert_allclose(-v(1, -2, 3), v(-1, 2, -3))

    def test_scalar_mul_div(self):
        np.testing.assert_allclose(v(1, 0, -1) * 2.0, v(2, 0, -2))
        np.testing.assert_allclose(v(2, 4, 6) / 2.0, v(1, 2, 3))

    def test_squared_length_length(self):
        assert vec.squared_length(v(1, 2, 3)) == 14.0
        np.testing.assert_allclose(vec.length(v(3, 4, 0)), 5.0)

    def test_unit(self):
        np.testing.assert_allclose(vec.unit(v(10, 0, 0)), v(1, 0, 0))
        u = vec.unit(v(1, 1, 1))
        np.testing.assert_allclose(vec.length(u), 1.0, rtol=1e-6)

    def test_unit_zero_is_guarded(self):
        # The reference panics (vec3.rs:559-563); we define unit(0) = 0 so
        # masked-out lanes can't poison a batch with NaNs.
        np.testing.assert_allclose(vec.unit(v(0, 0, 0)), v(0, 0, 0))
        assert not np.any(np.isnan(np.asarray(vec.unit(v(0, 0, 0)))))

    def test_near_zero(self):
        assert bool(vec.near_zero(v(1e-9, 0, -1e-9)))
        assert not bool(vec.near_zero(v(1e-7, 0, 0)))

    def test_index_convention(self):
        a = v(7, 8, 9)
        assert a[0] == 7 and a[1] == 8 and a[2] == 9


class TestOptics:
    def test_reflect(self):
        # 45-degree mirror: (1,-1,0) off n=(0,1,0) -> (1,1,0). vec3.rs:163
        np.testing.assert_allclose(vec.reflect(v(1, -1, 0), v(0, 1, 0)), v(1, 1, 0))

    def test_reflect_preserves_length(self):
        d = vec.unit(v(0.3, -0.8, 0.5))
        r = vec.reflect(d, v(0, 1, 0))
        np.testing.assert_allclose(vec.length(r), 1.0, rtol=1e-6)

    def test_refract_straight_through(self):
        # eta=1 must leave the ray unchanged
        d = vec.unit(v(0.2, -0.9, 0.1))
        np.testing.assert_allclose(vec.refract(d, v(0, 1, 0), 1.0), d, atol=1e-6)

    def test_refract_snell(self):
        # 45 deg incidence, eta = 0.5: sin(theta_t) = 0.5*sin(45)
        d = vec.unit(v(1, -1, 0))
        t = vec.refract(d, v(0, 1, 0), 0.5)
        sin_out = float(t[0]) / float(vec.length(t))
        np.testing.assert_allclose(sin_out, 0.5 * np.sin(np.pi / 4), rtol=1e-5)


class TestBatched:
    def test_broadcast_dot(self):
        a = jnp.ones((4, 5, 3))
        b = jnp.ones((5, 3)) * 2
        assert vec.dot(a, b).shape == (4, 5)
        np.testing.assert_allclose(vec.dot(a, b), 6.0 * np.ones((4, 5)))

    def test_batched_unit(self):
        a = jnp.array([[3, 0, 0], [0, 0, 0], [0, 4, 3]], dtype=jnp.float32)
        u = vec.unit(a)
        np.testing.assert_allclose(np.asarray(vec.length(u)), [1, 0, 1], atol=1e-6)


class TestGamma:
    def test_to_rgb8(self):
        # vec3.rs:223-231: floor(sqrt(c).clamp(0,1)*255)
        c = v(0.25, 1.0, 4.0)
        np.testing.assert_array_equal(np.asarray(vec.to_rgb8(c)), [127, 255, 255])

    def test_roundtrip_dark(self):
        c = v(0.0, 0.0, 0.0)
        np.testing.assert_array_equal(np.asarray(vec.to_rgb8(c)), [0, 0, 0])

    def test_from_rgb8(self):
        rgb = jnp.array([255, 0, 51], dtype=jnp.uint8)
        np.testing.assert_allclose(np.asarray(vec.from_rgb8(rgb)), [1.0, 0.0, 0.2])


class TestTransforms:
    def test_transform_point_translation(self):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [1, 2, 3]
        np.testing.assert_allclose(
            vec.transform_point(v(0, 0, 0), jnp.array(m)), v(1, 2, 3))

    def test_transform_dir_ignores_translation(self):
        m = np.eye(4, dtype=np.float32)
        m[:3, 3] = [1, 2, 3]
        np.testing.assert_allclose(
            vec.transform_dir(v(1, 0, 0), jnp.array(m)), v(1, 0, 0))

    def test_transform_scale(self):
        m = np.diag([2.0, 3.0, 4.0, 1.0]).astype(np.float32)
        np.testing.assert_allclose(
            vec.transform_point(v(1, 1, 1), jnp.array(m)), v(2, 3, 4))
