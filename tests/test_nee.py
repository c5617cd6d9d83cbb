"""PT+NEE mode: same mean as plain PT, lower variance. Uses the Cornell
direct-lighting analytic oracle: radiance at the floor point under the
light via one diffuse bounce is

    albedo/pi * Int Le cos(theta) cos(theta') / r^2 dA ~= 0.01046

for the white floor (albedo 0.73) and the (213,343)x(227,332) rect light at
y=554 with Le=(1,1,1) (scene.rs:26-32)."""

import jax
import pytest
import jax.numpy as jnp
import numpy as np

from raytracer.models.path_tracer import trace_radiance
from raytracer.scene.builtin import cornell_box

ORACLE = 0.01046


def shoot(nee, n, seed, max_depth=2):
    scene = cornell_box(with_mesh=False)
    o = jnp.broadcast_to(jnp.asarray([278.0, 120.0, 278.0]), (n, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (n, 3))
    res = trace_radiance(scene, o, d, jax.random.PRNGKey(seed),
                         max_depth=max_depth, t_min=1e-3, spawn_eps=0.05,
                         russian_roulette=False, nee=nee)
    return np.asarray(res.radiance)


@pytest.mark.slow
def test_nee_matches_analytic_direct_lighting():
    # NEE at max_depth=1: exactly the direct term (one shadow ray; its
    # variance is the light-area sampling only, tiny vs plain PT's)
    rad = shoot(nee=True, n=16384, seed=0, max_depth=1)
    mean = rad.mean(0).mean()
    np.testing.assert_allclose(mean, ORACLE, rtol=0.05)


@pytest.mark.slow
def test_nee_same_mean_as_plain_pt():
    # NEE extends every diffuse path by one light connection, so
    # NEE(depth D) covers the same transport as plain PT(depth D+1)
    r_pt = shoot(nee=False, n=65536, seed=1, max_depth=2)
    r_ne = shoot(nee=True, n=8192, seed=2, max_depth=1)
    m_pt = r_pt.mean(0).mean()
    m_ne = r_ne.mean(0).mean()
    # plain PT needs 8x the samples for comparable error; tolerances reflect
    # its ~4-8% MC noise at 65k
    np.testing.assert_allclose(m_ne, m_pt, rtol=0.12)


@pytest.mark.slow
def test_nee_lower_variance():
    r_pt = shoot(nee=False, n=8192, seed=3, max_depth=2)
    r_ne = shoot(nee=True, n=8192, seed=4, max_depth=1)
    v_pt = r_pt.sum(1).var()
    v_ne = r_ne.sum(1).var()
    assert v_ne < v_pt / 5.0, (v_pt, v_ne)


@pytest.mark.slow
def test_nee_two_sided_rect_light():
    """Surfaces ABOVE the light plane must still get direct light under
    NEE: emission in this framework is two-sided, so the rect cos term is
    two-sided too (regression for the one-sided bug that zeroed all direct
    light above the plane in --nee mode). Uses a mid-height light panel
    with a diffuse ceiling well above it."""
    from raytracer.scene import SceneBuilder
    b = SceneBuilder()
    white = b.lambertian(b.constant_texture((0.73, 0.73, 0.73)))
    b.add_rect(1, 500.0, 0.0, 555.0, 0.0, 555.0, white)   # ceiling y=500
    b.add_xzrect_light(213.0, 227.0, 343.0, 332.0, 300.0, (1.0, 1.0, 1.0),
                       1.0)                                # panel y=300
    scene = b.compile()

    def shoot_up(nee, depth, seed, count):
        # straight up from under the ceiling, outside the panel's extent
        oo = jnp.broadcast_to(jnp.asarray([278.0, 400.0, 278.0]), (count, 3))
        dd = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (count, 3))
        res = trace_radiance(scene, oo, dd, jax.random.PRNGKey(seed),
                             max_depth=depth, t_min=1e-3, spawn_eps=0.05,
                             russian_roulette=False, nee=nee)
        return np.asarray(res.radiance)

    m_ne = shoot_up(True, 1, 10, 8192).mean(0).mean()
    m_pt = shoot_up(False, 2, 11, 65536).mean(0).mean()
    assert m_ne > 1e-4, "ceiling lost all direct light under NEE"
    np.testing.assert_allclose(m_ne, m_pt, rtol=0.15)


@pytest.mark.slow
def test_nee_full_render_finite():
    """render_fn with nee on a small Cornell image: finite, lit interior."""
    from raytracer.models.path_tracer import render_fn
    scene = cornell_box(with_mesh=False)
    img, rays = render_fn(scene, jax.random.PRNGKey(0), width=32, height=32,
                          spp=8, spp_chunk=4, max_depth=6, t_min=1e-3,
                          spawn_eps_rel=1e-4, nee=True)
    img = np.asarray(img)
    assert np.isfinite(img).all()
    assert img[8:24, 8:24].mean() > 1e-3


@pytest.mark.slow
def test_nee_many_lights_single_shadow_cast():
    """direct_light picks ONE light per lane with
    the power-proportional categorical (light.rs:220-225 analog) instead of
    unrolling a shadow cast per registered light. Mean must match plain PT
    on a many-emitter scene, and the trace must contain exactly ONE
    intersect per NEE bounce regardless of light count."""
    import numpy as np
    from raytracer.scene import SceneBuilder

    b = SceneBuilder()
    white = b.lambertian(b.constant_texture((0.73, 0.73, 0.73)))
    b.add_rect(1, 0.0, -20.0, 20.0, -20.0, 20.0, white)  # floor y=0
    rng = np.random.RandomState(7)
    for i in range(20):                                   # 20 emitters
        x, z = rng.uniform(-12, 12, 2)
        b.add_sphere_light((float(x), 8.0, float(z)), 0.6,
                           (2.0, 2.0, 2.0), 1.0)
    scene = b.compile()

    def shoot_down(nee, depth, seed, count):
        o = jnp.broadcast_to(jnp.asarray([0.0, 3.0, 0.0]), (count, 3))
        d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (count, 3))
        res = trace_radiance(scene, o, d, jax.random.PRNGKey(seed),
                             max_depth=depth, t_min=1e-3, spawn_eps=0.01,
                             russian_roulette=False, nee=nee)
        return np.asarray(res.radiance)

    m_ne = shoot_down(True, 1, 20, 16384).mean(0).mean()
    m_pt = shoot_down(False, 2, 21, 65536).mean(0).mean()
    assert m_ne > 1e-4
    np.testing.assert_allclose(m_ne, m_pt, rtol=0.15)

    # one compile, one shadow intersect per bounce: count intersect calls
    # in the jaxpr via the pallas custom calls is brittle; instead pin that
    # a 501-emitter scene TRACES at all (the per-light loop would unroll
    # 501 shadow casts and take minutes to even trace)
    b2 = SceneBuilder()
    w2 = b2.lambertian(b2.constant_texture((0.5, 0.5, 0.5)))
    b2.add_rect(1, 0.0, -40.0, 40.0, -40.0, 40.0, w2)
    for i in range(501):
        x, z = rng.uniform(-30, 30, 2)
        b2.add_sphere_light((float(x), 10.0, float(z)), 0.3,
                            (2.0, 2.0, 2.0), 1.0)
    many = b2.compile()
    o = jnp.broadcast_to(jnp.asarray([0.0, 2.0, 0.0]), (256, 3))
    d = jnp.broadcast_to(jnp.asarray([0.0, -1.0, 0.0]), (256, 3))
    res = trace_radiance(many, o, d, jax.random.PRNGKey(3), max_depth=1,
                         t_min=1e-3, spawn_eps=0.01,
                         russian_roulette=False, nee=True)
    rad = np.asarray(res.radiance)
    assert np.isfinite(rad).all() and rad.mean() > 0.0


def test_nee_moving_emitter_samples_time_correct_position():
    """A moving emitter's light record carries its
    velocity, so NEE shadow samples evaluate the center at the shading
    ray's shutter time instead of silently using the t=0 position."""
    import numpy as np
    from raytracer.ops.nee import direct_light
    from raytracer.scene import SceneBuilder

    b = SceneBuilder()
    b.set_camera((0, 2, 10), (0, 1, 0), time0=0.0, time1=1.0)
    white = b.lambertian(b.constant_texture((0.73, 0.73, 0.73)))
    b.add_rect(1, 0.0, -20.0, 20.0, -20.0, 20.0, white)
    # emitter sweeps x: -6 (t=0) -> +6 (t=1) at height 4
    b.add_sphere_light((-6.0, 4.0, 0.0), 0.5, (4.0, 4.0, 4.0), 1.0,
                       center1=(6.0, 4.0, 0.0))
    scene = b.compile()
    assert np.allclose(np.asarray(scene.lights.vel), [[12.0, 0.0, 0.0]])

    n = 4096
    p = jnp.broadcast_to(jnp.asarray([6.0, 0.0, 0.0]), (n, 3))   # under t=1
    nrm = jnp.broadcast_to(jnp.asarray([0.0, 1.0, 0.0]), (n, 3))
    alb = jnp.ones((n, 3), jnp.float32) * 0.73
    valid = jnp.ones((n,), bool)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def dl(t):
        return direct_light(scene, key, p, nrm, alb, valid,
                            intersector="xla",
                            time=jnp.full((n,), t, jnp.float32))

    at_t1 = float(np.asarray(dl(1.0)).mean())   # emitter overhead
    at_t0 = float(np.asarray(dl(0.0)).mean())   # emitter 12 units away
    assert at_t1 > 4.0 * max(at_t0, 1e-6), (at_t0, at_t1)

    # and the shadow geometry moves too: at t=1 the emitter sphere sits at
    # +6 overhead, so its own body must NOT shadow the connection (the
    # sample point is on the facing hemisphere) — finite positive light
    assert at_t1 > 1e-3


@pytest.mark.slow
def test_nee_close_light_immune_to_global_eps():
    """The shadow estimator's CONTRIBUTION geometry must come from the true
    surface point: scene.scale is global, so a huge background primitive
    (radius-1000 ground) makes 1e-4*scale comparable to small nearby
    emitters, and the old offset-then-measure form (p + 0.35*n) computed
    direct light from ABOVE a resting radius-0.2 light — losing ~35% of
    the near-field direct term (scene_500's --nee image lost 32% of its
    mean). Pin: NEE with the huge global eps stays within MC noise of the
    eps-converged plain-PT image."""
    import jax.numpy as jnp
    from raytracer.scene.builder import SceneBuilder
    from raytracer.models.path_tracer import trace_radiance

    b = SceneBuilder()
    ground = b.lambertian(b.constant_texture((0.6, 0.6, 0.6)))
    b.add_sphere((0, -1000.0, 0), 1000.0, ground)
    b.add_sphere_light((0, 0.2, 0), 0.2, (4.0, 4.0, 4.0), 1.0)
    b.set_camera(look_from=(0, 2, 8), look_at=(0, 1, 0), vup=(0, 1, 0),
                 vfov=40, aspect_ratio=1.0, aperture=0.0, focus_dist=8.0)
    s = b.compile()
    n = 120000
    x = jnp.linspace(0.3, 1.0, n)
    o = jnp.stack([x, jnp.full((n,), 1.5), jnp.zeros(n)], -1)
    d = jnp.tile(jnp.asarray([[0.0, -1.0, 0.0]]), (n, 1))
    key = jax.random.PRNGKey(5)
    # truth: plain PT with a tiny spawn offset (eps far below the light
    # radius; PT needs no shadow machinery and converges to the exact
    # direct term)
    truth = trace_radiance(s, o, d, key, max_depth=2, t_min=1e-3,
                           spawn_eps=1e-6 * s.scale,
                           intersector="auto").radiance
    # NEE with the huge global offset (1e-4 * scale = 0.35 > the light's
    # radius): the direct term must still be computed from the true
    # surface points
    nee = trace_radiance(s, o, d, key, max_depth=2, t_min=1e-3,
                         spawn_eps=1e-4 * s.scale, intersector="auto",
                         nee=True).radiance
    m_t, m_n = float(truth.mean()), float(nee.mean())
    assert abs(m_n - m_t) / m_t < 0.15, (m_t, m_n)
