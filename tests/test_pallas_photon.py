"""Exact photon queries — the GPU kernel (interpret mode on CPU) and its
plain XLA form — vs a numpy direct-sum oracle. Unlike the grid query there
is no per-cell cap, so the oracle is an exact direct sum."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.ops import pallas_photon as pp
from raytracer.ops import photon_grid as pg

query_photons = functools.partial(pp.query_photons, interpret=True)


def oracle(pos, power, norm, valid, points, radius, cap):
    fr = np.zeros((len(points), 3))
    cr = np.zeros(len(points))
    fc = np.zeros((len(points), 3))
    cc = np.zeros(len(points))
    for i, (p, r) in enumerate(zip(points, radius)):
        d = pos - p
        d2 = (d * d).sum(1)
        un = d / np.maximum(np.sqrt(d2), 1e-10)[:, None]
        disk = np.abs((norm * un).sum(1))
        w = (1 - disk)[:, None] * power
        in_r = valid & (d2 <= r * r)
        in_c = valid & (d2 <= cap * cap)
        fr[i] = w[in_r].sum(0)
        cr[i] = in_r.sum()
        fc[i] = w[in_c].sum(0)
        cc[i] = in_c.sum()
    return fr, cr, fc, cc


def make(seed, n_ph=3000, n_pts=300):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1, 1, (n_ph, 3))
    power = rng.uniform(0, 2, (n_ph, 3))
    norm = rng.normal(size=(n_ph, 3))
    norm /= np.linalg.norm(norm, axis=1, keepdims=True)
    valid = rng.random(n_ph) < 0.8
    points = rng.uniform(-1, 1, (n_pts, 3))
    radius = rng.uniform(0.05, 0.3, n_pts)
    return pos, power, norm, valid, points, radius


def test_dense_query_matches_oracle():
    pos, power, norm, valid, points, radius = make(0)
    cap = 0.35
    q = query_photons(jnp.asarray(pos, jnp.float32),
                      jnp.asarray(power, jnp.float32),
                      jnp.asarray(norm, jnp.float32),
                      jnp.asarray(valid),
                      jnp.asarray(points, jnp.float32),
                      jnp.asarray(radius, jnp.float32), cap)
    fr, cr, fc, cc = oracle(pos, power, norm, valid, points, radius, cap)
    # counts are exact; flux sums in f32 in another order than the oracle
    np.testing.assert_array_equal(np.asarray(q.count_r), cr)
    np.testing.assert_array_equal(np.asarray(q.count_cap), cc)
    np.testing.assert_allclose(np.asarray(q.flux_r), fr, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(np.asarray(q.flux_cap), fc, rtol=2e-2,
                               atol=2e-2)


def test_dense_query_radius_exceeds_cell():
    """Radii larger than any grid cell are fine (no 27-cell truncation)."""
    pos, power, norm, valid, points, _ = make(1, n_ph=2000, n_pts=100)
    radius = np.full(100, 0.9)  # huge radius, covers most of the cube
    q = query_photons(jnp.asarray(pos, jnp.float32),
                      jnp.asarray(power, jnp.float32),
                      jnp.asarray(norm, jnp.float32),
                      jnp.asarray(valid),
                      jnp.asarray(points, jnp.float32),
                      jnp.asarray(radius, jnp.float32), 0.9)
    fr, cr, _, _ = oracle(pos, power, norm, valid, points, radius, 0.9)
    np.testing.assert_array_equal(np.asarray(q.count_r), cr)
    np.testing.assert_allclose(np.asarray(q.flux_r), fr, rtol=2e-2, atol=5e-2)


def test_dense_query_from_sorted_grid():
    """Querying the cell-sorted grid arrays gives the same result as raw
    order (the sort only improves culling)."""
    pos, power, norm, valid, points, radius = make(2)
    cap = 0.3
    bmin = jnp.asarray([-1.2, -1.2, -1.2], jnp.float32)
    bmax = jnp.asarray([1.2, 1.2, 1.2], jnp.float32)
    grid = pg.build_grid(jnp.asarray(pos, jnp.float32),
                         jnp.asarray(power, jnp.float32),
                         jnp.asarray(norm, jnp.float32),
                         jnp.asarray(valid), bmin, bmax, (8, 8, 8))
    n_valid = int(grid.n_valid)
    sorted_valid = jnp.arange(pos.shape[0]) < n_valid
    q = query_photons(grid.pos, grid.power.astype(jnp.float32),
                      grid.norm.astype(jnp.float32), sorted_valid,
                      jnp.asarray(points, jnp.float32),
                      jnp.asarray(radius, jnp.float32), cap)
    fr, cr, fc, cc = oracle(pos, power, norm, valid, points, radius, cap)
    np.testing.assert_array_equal(np.asarray(q.count_r), cr)
    np.testing.assert_array_equal(np.asarray(q.count_cap), cc)
    np.testing.assert_allclose(np.asarray(q.flux_r), fr, rtol=2e-2, atol=2e-2)


def test_dense_query_empty_photons():
    pos, power, norm, valid, points, radius = make(3, n_ph=500)
    q = query_photons(jnp.asarray(pos, jnp.float32),
                      jnp.asarray(power, jnp.float32),
                      jnp.asarray(norm, jnp.float32),
                      jnp.zeros(500, bool),
                      jnp.asarray(points, jnp.float32),
                      jnp.asarray(radius, jnp.float32), 0.3)
    assert np.asarray(q.count_r).sum() == 0
    assert np.abs(np.asarray(q.flux_cap)).sum() == 0


def _args(seed, n_ph=3000, n_pts=300):
    pos, power, norm, valid, points, radius = make(seed, n_ph, n_pts)
    return (jnp.asarray(pos, jnp.float32), jnp.asarray(power, jnp.float32),
            jnp.asarray(norm, jnp.float32), jnp.asarray(valid),
            jnp.asarray(points, jnp.float32),
            jnp.asarray(radius, jnp.float32))


@pytest.mark.parametrize("chunk", [256, 1024])
def test_xla_query_matches_oracle(chunk):
    """The plain XLA form (the reference and the off-GPU path); the chunk
    loop stops after the last valid photon, whatever the chunk width."""
    pos, power, norm, valid, points, radius = make(4)
    q = pp.query_photons_xla(*_args(4), 0.35, chunk=chunk)
    fr, cr, fc, cc = oracle(pos, power, norm, valid, points, radius, 0.35)
    np.testing.assert_array_equal(np.asarray(q.count_r), cr)
    np.testing.assert_array_equal(np.asarray(q.count_cap), cc)
    np.testing.assert_allclose(np.asarray(q.flux_r), fr, rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(np.asarray(q.flux_cap), fc, rtol=1e-4,
                               atol=1e-4)


def test_photon_kernel_lowers_for_cuda():
    args = _args(5, n_ph=2000, n_pts=200)
    text = jax.jit(lambda *a: pp.query_photons(*a, 0.3)).trace(
        *args).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert 'name = "photon_query"' in text


def test_photon_kernel_requires_interpret_off_gpu():
    with pytest.raises(ValueError, match="interpret"):
        jax.jit(lambda *a: pp.query_photons(*a, 0.3))(*_args(6, 1000, 100))
