"""The kernels compiled for the card vs their XLA references. These need
an NVIDIA GPU: they skip elsewhere (the ``gpu`` fixture) and run on the
card with ``RAYTRACER_TEST_GPU=1 python -m pytest -m gpu``."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.ops import intersect as ix
from raytracer.ops import pallas_photon as pp
from raytracer.ops.pallas_intersect import intersect_pallas
from raytracer.scene.builtin import cornell_box
from raytracer.scene.loader import load_scene

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["scene_500", "cornell"])
def test_closest_hit_kernel_on_gpu(gpu, name):
    if name == "scene_500":
        scene = load_scene(os.path.join(DATA, "scene_500.json"))
        lo, hi = [-12, -6, -12], [12, 6, 12]
    else:
        scene = cornell_box(with_mesh=True)
        lo, hi = [50, 50, -700], [500, 500, 500]
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform(lo, hi, (65536, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(65536, 3)), jnp.float32)
    got = jax.jit(lambda o, d: intersect_pallas(scene, o, d, 1e-3,
                                                jnp.inf))(o, d)
    with jax.default_matmul_precision("highest"):
        ref = jax.jit(lambda o, d: ix.intersect_bruteforce(
            scene, o, d, 1e-3, jnp.inf))(o, d)
    t1, t2 = np.asarray(ref.t), np.asarray(got.t)
    same = ((np.asarray(ref.prim_type) == np.asarray(got.prim_type))
            & (np.asarray(ref.prim_idx) == np.asarray(got.prim_idx)))
    assert same.mean() >= 0.9999
    both = np.isfinite(t1) & np.isfinite(t2) & same
    np.testing.assert_allclose(t2[both], t1[both], rtol=1e-4)


@pytest.mark.gpu
def test_photon_kernel_on_gpu(gpu):
    rng = np.random.default_rng(1)
    n_ph, n_pts = 200_000, 20_000
    pos = jnp.asarray(rng.uniform(-1, 1, (n_ph, 3)), jnp.float32)
    power = jnp.asarray(rng.uniform(0, 2, (n_ph, 3)), jnp.float32)
    norm = rng.normal(size=(n_ph, 3))
    norm = jnp.asarray(norm / np.linalg.norm(norm, axis=1, keepdims=True),
                       jnp.float32)
    valid = jnp.asarray(rng.random(n_ph) < 0.8)
    points = jnp.asarray(rng.uniform(-1, 1, (n_pts, 3)), jnp.float32)
    radius = jnp.asarray(rng.uniform(0.01, 0.05, n_pts), jnp.float32)
    args = (pos, power, norm, valid, points, radius, 0.06)
    got = jax.jit(pp.query_photons)(*args)
    ref = jax.jit(pp.query_photons_xla)(*args)
    np.testing.assert_array_equal(np.asarray(got.count_r),
                                  np.asarray(ref.count_r))
    np.testing.assert_array_equal(np.asarray(got.count_cap),
                                  np.asarray(ref.count_cap))
    np.testing.assert_allclose(np.asarray(got.flux_r),
                               np.asarray(ref.flux_r), rtol=1e-4, atol=1e-4)
