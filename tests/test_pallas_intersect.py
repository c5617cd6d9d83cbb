"""GPU closest-hit kernel (Triton route) vs the XLA brute-force oracle, in
Pallas interpret mode on CPU; plus its CUDA lowering, which this machine
can produce without a card, and the dispatch rules that choose it."""

import os

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from raytracer.ops import dispatch
from raytracer.ops import intersect as ix
from raytracer.ops.closest_hit import N_SLOTS, winner_data
from raytracer.ops.pallas_intersect import intersect_pallas
from raytracer.scene import SceneBuilder
from raytracer.scene.builtin import cornell_box, motion_field
from raytracer.scene.loader import load_scene

DATA = os.path.join(os.path.dirname(__file__), "..", "data")


def kernel(scene, o, d, t_min=1e-3, t_max=jnp.inf, **kw):
    return intersect_pallas(scene, o, d, t_min, t_max, interpret=True, **kw)


def check_agreement(scene, o, d, t_min=1e-3, t_max=jnp.inf):
    h1 = jax.jit(lambda o, d: ix.intersect_bruteforce(scene, o, d, t_min, t_max))(o, d)
    h2 = jax.jit(lambda o, d: kernel(scene, o, d, t_min, t_max))(o, d)
    t1, t2 = np.asarray(h1.t), np.asarray(h2.t)
    agree = np.isfinite(t1) == np.isfinite(t2)
    assert agree.mean() > 0.995, f"hit/miss disagreement {1 - agree.mean():.4f}"
    both = np.isfinite(t1) & np.isfinite(t2)
    np.testing.assert_allclose(t1[both], t2[both], rtol=1e-4, atol=1e-3)
    same_type = np.asarray(h1.prim_type)[both] == np.asarray(h2.prim_type)[both]
    assert same_type.mean() > 0.99


def rays(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return (jnp.asarray(rng.uniform(lo, hi, (n, 3)), jnp.float32),
            jnp.asarray(rng.normal(size=(n, 3)), jnp.float32))


def _bunny_scene():
    from raytracer.scene.builder import trs_matrix
    from raytracer.utils.obj import load_obj
    mesh = load_obj(os.path.join(DATA, "mesh", "bun315.obj"))
    b = SceneBuilder()
    white = b.lambertian(b.constant_texture((0.73, 0.73, 0.73)))
    b.add_triangles(mesh.positions, mesh.indices, white,
                    normals=mesh.normals,
                    transform=trs_matrix((0, 0, 0), (20, 20, 20), (0, 0, 0)))
    b.add_sphere((0.0, -1000.0, 0.0), 998.0, white)
    return b.compile()


def test_pallas_spheres_scene500():
    scene = load_scene(os.path.join(DATA, "scene_500.json"))
    o, d = rays(512, [-12, -6, -12], [12, 6, 12], 0)
    check_agreement(scene, o, d)


def test_pallas_mixed_cornell():
    scene = cornell_box(with_mesh=True)
    o, d = rays(512, [50, 50, -700], [500, 500, 500], 1)
    check_agreement(scene, o, d)


def test_pallas_nonmultiple_ray_count():
    scene = cornell_box(with_mesh=False)
    o, d = rays(333, [50, 50, -700], [500, 500, 500], 2)  # not BLOCK-aligned
    check_agreement(scene, o, d)


def test_pallas_single_type_tables():
    b = SceneBuilder()
    m = b.lambertian(b.constant_texture((1, 1, 1)))
    b.add_sphere((0, 0, -3), 1.0, m)
    scene = b.compile()  # rects/tris empty -> their stages are skipped
    o = jnp.array([[0.0, 0, 0], [0, 5, 0]], jnp.float32)
    d = jnp.array([[0.0, 0, -1], [0, 1, 0]], jnp.float32)
    h = kernel(scene, o, d)
    np.testing.assert_allclose(float(h.t[0]), 2.0, rtol=1e-5)
    assert np.isinf(np.asarray(h.t))[1]


def test_pallas_respects_tmax():
    b = SceneBuilder()
    m = b.lambertian(b.constant_texture((1, 1, 1)))
    b.add_sphere((0, 0, -3), 1.0, m)
    scene = b.compile()
    o = jnp.array([[0.0, 0, 0]], jnp.float32)
    d = jnp.array([[0.0, 0, -1]], jnp.float32)
    h = kernel(scene, o, d, 1e-3, 1.5)  # hit is at t=2
    assert np.isinf(np.asarray(h.t))[0]


def _lowering_case(name):
    if name == "spheres":
        scene = load_scene(os.path.join(DATA, "scene_500.json"))
    elif name == "cornell":
        scene = cornell_box(with_mesh=True)
    elif name == "mesh":
        scene = _bunny_scene()
    else:
        scene = motion_field(64)
    o, d = rays(300, [-5, -5, -5], [5, 5, 5], 3)
    t = jnp.linspace(0.0, 1.0, 300) if name == "motion" else None
    return scene, o, d, t


@pytest.mark.parametrize("name", ["spheres", "cornell", "mesh", "motion"])
def test_kernel_lowers_for_cuda(name):
    """The kernel lowers to XLA's Triton custom call for CUDA — checkable
    without a card, before any GPU compile."""
    scene, o, d, t = _lowering_case(name)
    fn = jax.jit(lambda o, d, t: intersect_pallas(scene, o, d, 1e-3,
                                                  jnp.inf, time=t))
    text = fn.trace(o, d, t).lower(lowering_platforms=("cuda",)).as_text()
    assert "__gpu$xla.gpu.triton" in text
    assert 'name = "closest_hit"' in text


def test_kernel_requires_interpret_off_gpu():
    """Off a GPU the kernel runs only when the caller asks for the
    interpreter; it never falls back to it on its own."""
    scene = cornell_box(with_mesh=False)
    o, d = rays(64, [50, 50, -700], [500, 500, 500], 4)
    with pytest.raises(ValueError, match="interpret"):
        jax.jit(lambda o, d: intersect_pallas(scene, o, d, 1e-3,
                                              jnp.inf))(o, d)


def test_xla_winner_data_matches_kernel():
    """Winner rows gathered for the XLA closest hit equal those gathered
    for the kernel's (same winners on Cornell with its mesh)."""
    scene = cornell_box(with_mesh=True)
    o, d = rays(512, [50, 50, -700], [500, 500, 500], 5)
    h1 = jax.jit(lambda o, d: ix.intersect_bruteforce(scene, o, d, 1e-3,
                                                      jnp.inf))(o, d)
    h2 = jax.jit(lambda o, d: kernel(scene, o, d))(o, d)
    w1 = np.asarray(winner_data(scene, o, d, h1))
    w2 = np.asarray(winner_data(scene, o, d, h2))
    assert w1.shape == (N_SLOTS, 512)
    same = ((np.asarray(h1.prim_type) == np.asarray(h2.prim_type))
            & (np.asarray(h1.prim_idx) == np.asarray(h2.prim_idx)))
    assert same.mean() > 0.99
    assert np.isfinite(np.asarray(h1.t))[same].any()
    np.testing.assert_allclose(w1[:, same], w2[:, same], rtol=1e-4,
                               atol=1e-4)


def test_resolve_platform_rules(monkeypatch):
    scene = cornell_box()
    assert dispatch._resolve(scene, "auto") == "xla"          # CPU
    assert dispatch._resolve(scene, "bruteforce") == "bruteforce"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert dispatch._resolve(scene, "auto") == "pallas"
    assert dispatch._resolve(scene, "xla") == "xla"
    assert set(dispatch.SOA_METHODS) == {"pallas", "xla"}


@pytest.mark.slow
def test_pallas_mesh_and_alive_masking():
    """A Morton-ordered multi-chunk triangle table agrees with the brute
    force; dead lanes report a miss and do no work."""
    scene = _bunny_scene()
    o, d = rays(256, [-6, -4, -6], [6, 4, 6], 6)
    check_agreement(scene, o, d)
    alive = jnp.arange(256) % 3 != 0
    h = jax.jit(lambda o, d: kernel(scene, o, d, alive=alive))(o, d)
    assert np.isinf(np.asarray(h.t))[~np.asarray(alive)].all()
