"""Distribution tests for the closed-form samplers (replacing the rejection
loops of vec3.rs:111-162). We check moments/supports, not exact streams."""

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.ops import sampling, vec

N = 200_000


def test_uniform_sphere_is_on_surface(key):
    d = sampling.uniform_sphere(key, (N,))
    np.testing.assert_allclose(np.asarray(vec.length(d)), 1.0, atol=1e-5)


def test_uniform_sphere_moments(key):
    d = np.asarray(sampling.uniform_sphere(key, (N,)))
    # mean ~ 0, E[z^2] = 1/3 per component
    assert np.all(np.abs(d.mean(axis=0)) < 0.01)
    np.testing.assert_allclose((d ** 2).mean(axis=0), 1 / 3, atol=0.01)


def test_uniform_hemisphere_respects_normal(key):
    n = jnp.broadcast_to(vec.unit(jnp.array([1.0, 2.0, -0.5])), (N, 3))
    d = sampling.uniform_hemisphere(key, n)
    assert np.all(np.asarray(vec.dot(d, n)) > 0.0)


def test_uniform_disk_support_and_density(key):
    p = np.asarray(sampling.uniform_disk(key, (N,)))
    r2 = (p ** 2).sum(axis=-1)
    assert np.all(r2 <= 1.0 + 1e-6)
    # uniform density => r^2 ~ U(0,1)
    np.testing.assert_allclose(r2.mean(), 0.5, atol=0.01)
    assert np.abs(p.mean(axis=0)).max() < 0.01


def test_lambertian_dir_cosine_weighted(key):
    n = jnp.broadcast_to(jnp.array([0.0, 0.0, 1.0]), (N, 3))
    d = vec.unit(sampling.lambertian_dir(key, n))
    cos = np.asarray(d[..., 2])
    assert np.all(cos > -1e-6)
    # cosine-weighted: E[cos] = 2/3
    np.testing.assert_allclose(cos.mean(), 2 / 3, atol=0.01)


def test_lambertian_near_zero_guard():
    # Force the degenerate case: direction exactly opposite the normal is
    # measure-zero, but the guard must keep outputs finite regardless.
    k = jax.random.PRNGKey(3)
    n = jnp.broadcast_to(jnp.array([0.0, 1.0, 0.0]), (1024, 3))
    d = sampling.lambertian_dir(k, n)
    assert np.all(np.isfinite(np.asarray(d)))
    assert not np.any(np.asarray(vec.near_zero(d)))


def test_determinism(key):
    a = sampling.uniform_sphere(key, (64,))
    b = sampling.uniform_sphere(key, (64,))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
