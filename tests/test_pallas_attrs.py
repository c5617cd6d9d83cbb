"""Winner-data attribute decode (ops/closest_hit.winner_data +
wavefront_soa.attrs_soa, the SoA wavefront's seam) on the kernel's winners
(interpret mode) vs the gather-based HitRecord oracle."""

import jax
import jax.numpy as jnp
import numpy as np

from raytracer.models.wavefront_soa import attrs_soa
from raytracer.ops import intersect as ix
from raytracer.ops.closest_hit import winner_data
from raytracer.ops.pallas_intersect import intersect_pallas
from raytracer.scene.builtin import cornell_box
from raytracer.scene.loader import load_scene

import os
DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def decode(scene, o, d):
    hit = intersect_pallas(scene, o, d, 1e-3, jnp.inf, interpret=True)
    data = winner_data(scene, o, d, hit)
    h, f = attrs_soa(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                     hit.t, hit.prim_type, data)
    mat_id = jnp.round(data[-1]).astype(jnp.int32)
    return h, f, mat_id


def compare(scene, o, d):
    h2, feats2, mat2 = jax.jit(lambda o, d: decode(scene, o, d))(o, d)
    attrs1 = jax.jit(
        lambda o, d: ix.hit_attributes(
            scene, o, d, ix.intersect_bruteforce(scene, o, d, 1e-3, jnp.inf))
    )(o, d)
    v1 = np.asarray(attrs1.valid)
    v2 = np.asarray(h2.valid)
    agree = v1 == v2
    assert agree.mean() > 0.995
    both = v1 & v2
    # same winning primitive required for attribute comparison
    same = both & (np.asarray(attrs1.mat_id) == np.asarray(mat2))
    assert same.mean() / max(both.mean(), 1e-9) > 0.98
    p2 = np.stack([np.asarray(h2.px), np.asarray(h2.py),
                   np.asarray(h2.pz)], -1)
    n2 = np.stack([np.asarray(h2.nx), np.asarray(h2.ny),
                   np.asarray(h2.nz)], -1)
    uv2 = np.stack([np.asarray(h2.u), np.asarray(h2.v)], -1)
    np.testing.assert_allclose(np.asarray(attrs1.p)[same], p2[same],
                               rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(np.asarray(attrs1.normal)[same], n2[same],
                               atol=2e-3)
    np.testing.assert_allclose(np.asarray(attrs1.uv)[same], uv2[same],
                               atol=2e-3)
    np.testing.assert_array_equal(np.asarray(attrs1.front_face)[same],
                                  np.asarray(h2.front)[same])
    # gathered features must equal the table rows for winner materials
    from raytracer.ops.materials import fetch_mat_features
    ref = fetch_mat_features(scene, attrs1.mat_id)
    np.testing.assert_array_equal(np.asarray(ref.kind)[same],
                                  np.asarray(feats2.kind)[same])
    c0 = np.stack([np.asarray(feats2.c0r), np.asarray(feats2.c0g),
                   np.asarray(feats2.c0b)], -1)
    np.testing.assert_allclose(np.asarray(ref.color0)[same], c0[same],
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.fuzz)[same],
                               np.asarray(feats2.fuzz)[same], atol=1e-6)
    np.testing.assert_allclose(np.asarray(ref.ir)[same],
                               np.asarray(feats2.ir)[same], atol=1e-5)


def test_attrs_cornell_mixed():
    scene = cornell_box(with_mesh=True)
    rng = np.random.default_rng(0)
    o = jnp.asarray(rng.uniform([50, 50, -700], [500, 500, 500], (512, 3)),
                    jnp.float32)
    d = jnp.asarray(rng.normal(size=(512, 3)), jnp.float32)
    compare(scene, o, d)


def test_attrs_scene10():
    scene = load_scene(os.path.join(DATA, "scene_10.json"))
    rng = np.random.default_rng(1)
    o = jnp.asarray(rng.uniform(-8, 8, (512, 3)), jnp.float32)
    d = jnp.asarray(rng.normal(size=(512, 3)), jnp.float32)
    compare(scene, o, d)
