"""BVH property tests: traversal must agree with brute force on random rays
(the role scene_200_no_bvh plays in the reference's data set — SURVEY.md §4)."""

import pytest
import os

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.ops import bvh as bvh_ops
from raytracer.ops import intersect as ix
from raytracer.scene.builtin import cornell_box
from raytracer.scene.loader import load_scene

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def random_rays(n, lo, hi, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(lo, hi, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return jnp.asarray(o), jnp.asarray(d)


def assert_matches_bruteforce(scene, o, d, t_min=1e-3):
    scene_b = bvh_ops.build_bvh(scene, use_native=False)
    h_bf = jax.jit(lambda o, d: ix.intersect_bruteforce(scene, o, d, t_min, jnp.inf))(o, d)
    h_bvh = jax.jit(lambda o, d: bvh_ops.intersect_bvh(scene_b, o, d, t_min, jnp.inf))(o, d)
    t1, t2 = np.asarray(h_bf.t), np.asarray(h_bvh.t)
    finite_agree = np.isfinite(t1) == np.isfinite(t2)
    assert finite_agree.mean() > 0.995, f"hit/miss disagreement {1-finite_agree.mean():.4f}"
    both = np.isfinite(t1) & np.isfinite(t2)
    np.testing.assert_allclose(t1[both], t2[both], rtol=1e-4, atol=1e-3)
    # winning primitive can differ only at coincident surfaces; allow 1%
    same = (np.asarray(h_bf.prim_type)[both] == np.asarray(h_bvh.prim_type)[both])
    assert same.mean() > 0.99


def test_bvh_matches_bruteforce_spheres():
    scene = load_scene(os.path.join(DATA, "scene_200_no_bvh.json"))
    o, d = random_rays(2048, [-12, -6, -12], [12, 6, 12])
    assert_matches_bruteforce(scene, o, d)


def test_bvh_matches_bruteforce_scene500():
    scene = load_scene(os.path.join(DATA, "scene_500.json"))
    o, d = random_rays(2048, [-12, -6, -12], [12, 6, 12], seed=1)
    assert_matches_bruteforce(scene, o, d)


def test_bvh_matches_bruteforce_mixed_types():
    scene = cornell_box(with_mesh=True)  # spheres + rects + triangles
    o, d = random_rays(2048, [50, 50, -700], [500, 500, 500], seed=2)
    assert_matches_bruteforce(scene, o, d)


def test_bvh_flat_arrays_wellformed():
    scene = load_scene(os.path.join(DATA, "scene_500.json"))
    scene = bvh_ops.build_bvh(scene, use_native=False)
    b = scene.bvh
    n_nodes = b.left.shape[0]
    n_prims = b.prim_type.shape[0]
    assert n_prims == 1005
    is_leaf = np.asarray(b.is_leaf)
    left = np.asarray(b.left)
    right = np.asarray(b.right)
    # interior children in range
    assert np.all(left[~is_leaf] < n_nodes) and np.all(right[~is_leaf] < n_nodes)
    # leaves cover every primitive exactly once
    covered = np.zeros(n_prims, bool)
    for s, c in zip(left[is_leaf], right[is_leaf]):
        assert c <= bvh_ops.LEAF_SIZE
        covered[s:s + c] = True
    assert covered.all()
    # root box contains all prim boxes
    pmin, pmax, _, _ = bvh_ops.primitive_aabbs(scene)
    assert np.all(np.asarray(b.node_min[0]) <= pmin.min(0) + 1e-5)
    assert np.all(np.asarray(b.node_max[0]) >= pmax.max(0) - 1e-5)


@pytest.mark.slow
def test_render_with_bvh_matches_bruteforce_image(key):
    from raytracer.models import path_tracer as pt
    scene = load_scene(os.path.join(DATA, "scene_10.json"))
    scene_b = bvh_ops.build_bvh(scene, use_native=False)
    kw = dict(width=24, height=24, spp=8, spp_chunk=4, max_depth=6,
              t_min=1e-3, spawn_eps_rel=1e-4)
    img1, _ = pt.render_fn(scene, key, intersector="bruteforce", **kw)
    img2, _ = pt.render_fn(scene_b, key, intersector="bvh", **kw)
    # identical RNG stream + identical hits => images should be very close
    np.testing.assert_allclose(np.asarray(img1), np.asarray(img2),
                               atol=5e-2)
