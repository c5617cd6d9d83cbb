"""Uniform-grid photon map vs brute-force radius-search oracle."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from raytracer.ops import photon_grid as pg

RES = (8, 8, 8)
BMIN = np.zeros(3, np.float32)
BMAX = np.ones(3, np.float32) * 10.0


def make_photons(n=5000, seed=0):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 10, (n, 3)).astype(np.float32)
    power = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    norm = rng.normal(size=(n, 3)).astype(np.float32)
    norm /= np.linalg.norm(norm, axis=-1, keepdims=True)
    valid = rng.uniform(size=n) < 0.8
    return pos, power, norm, valid


def oracle(pos, power, norm, valid, points, radius):
    flux = np.zeros((len(points), 3), np.float32)
    count = np.zeros(len(points), np.float32)
    for i, (p, r) in enumerate(zip(points, radius)):
        d = pos - p
        d2 = (d * d).sum(-1)
        within = valid & (d2 <= r * r)
        for j in np.nonzero(within)[0]:
            delta = pos[j] - p
            l = np.linalg.norm(delta)
            u = delta / l if l > 0 else np.zeros(3)
            disk = abs(float(norm[j] @ u))
            flux[i] += power[j] * (1.0 - disk)
            count[i] += 1
    return flux, count


def test_grid_query_matches_oracle(key):
    pos, power, norm, valid = make_photons()
    grid = pg.build_grid(jnp.asarray(pos), jnp.asarray(power),
                         jnp.asarray(norm), jnp.asarray(valid),
                         jnp.asarray(BMIN), jnp.asarray(BMAX), RES)
    assert int(grid.n_valid) == valid.sum()
    rng = np.random.default_rng(1)
    points = rng.uniform(1, 9, (64, 3)).astype(np.float32)
    cap = 10.0 / 8  # one cell
    radius = rng.uniform(0.2, cap, 64).astype(np.float32)
    q = jax.jit(lambda pts, r: pg.query_grid_chunked(
        grid, RES, pts, r, cap, k_per_cell=64, chunk=32))(
        jnp.asarray(points), jnp.asarray(radius))
    flux_ref, cnt_ref = oracle(pos, power, norm, valid, points, radius)
    np.testing.assert_allclose(np.asarray(q.count_r), cnt_ref)
    np.testing.assert_allclose(np.asarray(q.flux_r), flux_ref,
                               rtol=1e-4, atol=1e-4)
    # cap-radius counts too
    flux_cap, cnt_cap = oracle(pos, power, norm, valid, points,
                               np.full(64, cap, np.float32))
    np.testing.assert_allclose(np.asarray(q.count_cap), cnt_cap)
    np.testing.assert_allclose(np.asarray(q.flux_cap), flux_cap,
                               rtol=1e-4, atol=1e-4)


@pytest.mark.slow
def test_invalid_photons_excluded():
    pos, power, norm, valid = make_photons(1000, seed=2)
    valid[:] = False
    grid = pg.build_grid(jnp.asarray(pos), jnp.asarray(power),
                         jnp.asarray(norm), jnp.asarray(valid),
                         jnp.asarray(BMIN), jnp.asarray(BMAX), RES)
    assert int(grid.n_valid) == 0
    pts = jnp.asarray(np.full((8, 3), 5.0, np.float32))
    q = pg.query_grid(grid, RES, pts, jnp.full((8,), 1.0), 1.25, 32)
    assert np.asarray(q.count_cap).sum() == 0


def test_out_of_bounds_points_safe():
    pos, power, norm, valid = make_photons(500, seed=3)
    grid = pg.build_grid(jnp.asarray(pos), jnp.asarray(power),
                         jnp.asarray(norm), jnp.asarray(valid),
                         jnp.asarray(BMIN), jnp.asarray(BMAX), RES)
    pts = jnp.asarray([[-5.0, -5.0, -5.0], [50.0, 50.0, 50.0]], jnp.float32)
    q = pg.query_grid(grid, RES, pts, jnp.full((2,), 1.0), 1.25, 32)
    assert np.isfinite(np.asarray(q.flux_r)).all()


def test_resolution_heuristic():
    res, r0 = pg.choose_grid_resolution(
        np.zeros(3), np.array([555.0, 555.0, 555.0]), 500_000, 100)
    assert all(2 <= r <= 64 for r in res)
    assert 5.0 < r0 < 25.0
