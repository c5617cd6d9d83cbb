"""Motion blur on the kernel path (extension; the reference Ray is
timeless, ray.rs:3-6 — SURVEY.md §8, driver config 5).

Moving-sphere scenes pack velocity rows (pallas_intersect.SPH_VEL_ROW),
the kernel tests c + v*t_ray, cull boxes dilate over the camera shutter,
and the gathered winner rows carry the effective center c + v*t, so attrs
are motion-agnostic. Dispatch routes moving scenes to the SoA intersectors
only when the caller supplies per-ray times; the regen wavefront draws one
time per sample and carries it per lane. Kernels run in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import functools

from raytracer.models.wavefront_soa import attrs_soa
from raytracer.ops.closest_hit import winner_data
from raytracer.ops.intersect import hit_attributes, intersect_bruteforce
from raytracer.ops.pallas_intersect import intersect_pallas
from raytracer.scene import SceneBuilder

intersect_pallas = functools.partial(intersect_pallas, interpret=True)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


def _moving_field(n=300, extent=10.0, vmax=6.0, seed=0, with_rect=True):
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.lambertian(b.constant_texture((1.0, 1.0, 1.0)))
    for _ in range(n):
        c = rng.uniform(-extent, extent, 3)
        v = rng.uniform(-vmax, vmax, 3)
        b.add_moving_sphere(tuple(c), tuple(c + v),
                            float(rng.uniform(0.2, 1.0)), m)
    if with_rect:
        b.add_xz_rect(-extent - 2, -extent - 2, extent + 2, extent + 2,
                      -extent - 1, m)
    b.set_camera((0, 0, 3 * extent), (0, 0, 0), time0=0.0, time1=1.0)
    return b.compile()


def _rand_rays(n, extent, seed=1):
    rng = np.random.default_rng(seed)
    o = jnp.asarray(rng.uniform(-1.5 * extent, 1.5 * extent, (n, 3)),
                    jnp.float32)
    d = jnp.asarray(rng.normal(size=(n, 3)), jnp.float32)
    tm = jnp.asarray(rng.uniform(0.0, 1.0, (n,)), jnp.float32)
    return o, d, tm


def _assert_hits_equal(hb, hp, tb_tol=2e-4, rtol=1e-5):
    tb, tp = np.asarray(hb.t), np.asarray(hp.t)
    np.testing.assert_array_equal(np.isfinite(tb), np.isfinite(tp))
    both = np.isfinite(tb)
    np.testing.assert_allclose(tb[both], tp[both], rtol=rtol, atol=tb_tol)
    np.testing.assert_array_equal(np.asarray(hb.prim_type)[both],
                                  np.asarray(hp.prim_type)[both])
    np.testing.assert_array_equal(np.asarray(hb.prim_idx)[both],
                                  np.asarray(hp.prim_idx)[both])


@pytest.mark.slow
def test_motion_kernel_matches_bruteforce():
    """Fast movers (|v| up to 6 over the shutter) exercise the dilated
    cull AABBs: a sphere found only near its t=1 position must not be
    culled by its t=0 box."""
    scene = _moving_field()
    o, d, tm = _rand_rays(1024, 10.0)
    hb = intersect_bruteforce(scene, o, d, 1e-3, jnp.inf, time=tm)
    hp = intersect_pallas(scene, o, d, 1e-3, jnp.inf, time=tm)
    _assert_hits_equal(hb, hp)


@pytest.mark.slow
def test_motion_attrs_effective_center():
    """Winner normals/points must come from the EFFECTIVE center c + v*t
    (closest_hit.winner_data), matching the XLA hit_attributes(time)."""
    scene = _moving_field()
    o, d, tm = _rand_rays(1024, 10.0, seed=2)
    hb = intersect_bruteforce(scene, o, d, 1e-3, jnp.inf, time=tm)
    hp = intersect_pallas(scene, o, d, 1e-3, jnp.inf, time=tm)
    h, _ = attrs_soa(o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                     hp.t, hp.prim_type,
                     winner_data(scene, o, d, hp, time=tm))
    ab = hit_attributes(scene, o, d, hb, time=tm)
    sel = np.isfinite(np.asarray(hb.t))
    normal = np.stack([np.asarray(h.nx), np.asarray(h.ny),
                       np.asarray(h.nz)], -1)
    p = np.stack([np.asarray(h.px), np.asarray(h.py), np.asarray(h.pz)], -1)
    np.testing.assert_allclose(np.asarray(ab.normal)[sel], normal[sel],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(ab.p)[sel], p[sel],
                               rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(np.asarray(ab.front_face)[sel],
                                  np.asarray(h.front)[sel])


def test_motion_resolve_rules(monkeypatch):
    from raytracer.ops import dispatch
    scene = _moving_field(n=10)
    # off the GPU, moving scenes with per-ray times take the XLA SoA path
    assert dispatch._resolve(scene, "auto", has_time=True) == "xla"
    assert dispatch._resolve(scene, "auto", has_time=False) == "bruteforce"
    assert dispatch._resolve(scene, "bvh", has_time=True) == "xla"
    assert dispatch._resolve(scene, "bruteforce", has_time=True) == "bruteforce"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert dispatch._resolve(scene, "auto", has_time=True) == "pallas"
    assert dispatch._resolve(scene, "auto", has_time=False) == "bruteforce"


@pytest.mark.slow
def test_motion_render_regen_matches_aos(key):
    """render_fn routes moving scenes through the regenerating SoA
    wavefront (per-sample shutter times in the lane carry); flux must
    match the AoS bruteforce chunk loop within MC noise, and repeat runs
    must be bit-identical."""
    from raytracer.models import path_tracer as pt
    b = SceneBuilder()
    g = b.lambertian(b.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    m = b.lambertian(b.constant_texture((0.7, 0.3, 0.3)))
    lt = b.diffuse_light(b.constant_texture((7.0, 7.0, 7.0)))
    b.add_sphere((0, -1000, 0), 1000.0, g)
    b.add_moving_sphere((-2, 1, 0), (-2, 1.6, 0), 1.0, m)
    b.add_moving_sphere((2, 1, 0), (2.8, 1, 0), 1.0, m)
    b.add_xz_rect(-1.5, -1.5, 1.5, 1.5, 6.0, lt)
    b.set_camera((0, 2, 12), (0, 1, 0), vfov=30, time0=0.0, time1=1.0)
    scene = b.compile()
    kw = dict(width=64, height=48, spp=64, spp_chunk=2, max_depth=8,
              t_min=1e-3, spawn_eps_rel=1e-4)
    img_k, _ = pt.render_fn(scene, key, intersector="auto", **kw)
    img_b, _ = pt.render_fn(scene, key, intersector="bruteforce", **kw)
    assert np.isfinite(np.asarray(img_k)).all()
    mk = float(jnp.mean(img_k))
    mb = float(jnp.mean(img_b))
    assert abs(mk - mb) / mb < 0.06, (mk, mb)
    img_k2, _ = pt.render_fn(scene, key, intersector="auto", **kw)
    np.testing.assert_array_equal(np.asarray(img_k), np.asarray(img_k2))
    # the shutter must actually smear: a zero-width shutter (time1=time0)
    # renders a visibly different image than the full shutter
    b2 = SceneBuilder()
    g2 = b2.lambertian(b2.checker_texture((0.2, 0.3, 0.1), (0.9, 0.9, 0.9)))
    m2 = b2.lambertian(b2.constant_texture((0.7, 0.3, 0.3)))
    lt2 = b2.diffuse_light(b2.constant_texture((7.0, 7.0, 7.0)))
    b2.add_sphere((0, -1000, 0), 1000.0, g2)
    b2.add_moving_sphere((-2, 1, 0), (-2, 1.6, 0), 1.0, m2)
    b2.add_moving_sphere((2, 1, 0), (2.8, 1, 0), 1.0, m2)
    b2.add_xz_rect(-1.5, -1.5, 1.5, 1.5, 6.0, lt2)
    b2.set_camera((0, 2, 12), (0, 1, 0), vfov=30, time0=0.0, time1=0.0)
    frozen = b2.compile()
    img_f, _ = pt.render_fn(frozen, key, intersector="auto", **kw)
    assert float(jnp.abs(img_f - img_k).max()) > 0.01
