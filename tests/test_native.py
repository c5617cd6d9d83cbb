"""Native C++ runtime tests (BVH builder + PNG encoder via ctypes).

Skipped gracefully if g++ is unavailable — every native entry point has a
pure-Python fallback, and these tests pin the shared layout contract."""

import numpy as np
import pytest

from raytracer.native import runtime as native_rt
from raytracer.ops.bvh import _build_flat_python

pytestmark = pytest.mark.skipif(not native_rt.available(),
                                reason="native library unavailable")


def boxes(n=333, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    e = rng.uniform(0.01, 1, (n, 3)).astype(np.float32)
    return c - e, c + e


def test_bvh_layout_contract():
    pmin, pmax = boxes()
    nm, nx, left, right, is_leaf, order = native_rt.bvh_build(pmin, pmax, 4)
    py = _build_flat_python(pmin, pmax, 4)
    assert nm.shape == py[0].shape  # same node count for median split
    np.testing.assert_allclose(nm[0], py[0][0], atol=1e-6)  # same root box
    np.testing.assert_allclose(nx[0], py[1][0], atol=1e-6)
    n = pmin.shape[0]
    covered = np.zeros(n, bool)
    for s, c in zip(left[is_leaf], right[is_leaf]):
        assert 0 < c <= 4
        assert not covered[s:s + c].any()  # no overlap
        covered[s:s + c] = True
    assert covered.all()
    assert sorted(order.tolist()) == list(range(n))


def test_bvh_single_prim():
    pmin, pmax = boxes(1)
    nm, nx, left, right, is_leaf, order = native_rt.bvh_build(pmin, pmax, 4)
    assert nm.shape[0] == 1 and bool(is_leaf[0])
    assert left[0] == 0 and right[0] == 1


def test_bvh_traversal_with_native_build():
    import jax.numpy as jnp
    import jax
    from raytracer.ops import bvh as bvh_ops
    from raytracer.ops import intersect as ix
    from raytracer.scene import SceneBuilder
    rng = np.random.default_rng(3)
    b = SceneBuilder()
    m = b.lambertian(b.constant_texture((0.5, 0.5, 0.5)))
    for _ in range(200):
        b.add_sphere(rng.uniform(-10, 10, 3), rng.uniform(0.1, 0.8), m)
    scene = b.compile()
    scene_b = bvh_ops.build_bvh(scene, use_native=True)
    o = jnp.asarray(rng.uniform(-12, 12, (512, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(512, 3)), jnp.float32)
    h1 = jax.jit(lambda: ix.intersect_bruteforce(scene, o, d, 1e-3, jnp.inf))()
    h2 = jax.jit(lambda: bvh_ops.intersect_bvh(scene_b, o, d, 1e-3, jnp.inf))()
    t1, t2 = np.asarray(h1.t), np.asarray(h2.t)
    assert ((np.isfinite(t1) == np.isfinite(t2)).mean()) > 0.995
    both = np.isfinite(t1) & np.isfinite(t2)
    np.testing.assert_allclose(t1[both], t2[both], rtol=1e-4, atol=1e-3)


def test_png_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    img = rng.integers(0, 256, (64, 80, 3), dtype=np.uint8)
    path = str(tmp_path / "t.png")
    assert native_rt.write_png(path, img)
    from PIL import Image
    back = np.asarray(Image.open(path))
    np.testing.assert_array_equal(back, img)
