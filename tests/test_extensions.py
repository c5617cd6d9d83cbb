"""Capability extensions: media (volumes), NEE, Perlin noise, image
textures, bunny mesh, transform rotation."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from raytracer.models import path_tracer
from raytracer.ops import intersect as ix
from raytracer.ops import materials as mat_ops
from raytracer.ops.nee import sample_li
from raytracer.scene import SceneBuilder
from raytracer.scene.builder import trs_matrix
from raytracer.utils.config import RenderConfig
from raytracer.utils.obj import load_obj

DATA = os.path.join(os.path.dirname(__file__), "..", "data")
TEXTURE = os.path.join(os.path.dirname(__file__), "..", "texture")


class TestMedia:
    def scene(self, density=2.0):
        b = SceneBuilder()
        light = b.diffuse_light(b.constant_texture((4, 4, 4)))
        b.add_sphere((0, 0, -6), 1.0, light)
        b.add_constant_medium_sphere((0, 0, -3), 1.0, density,
                                     b.constant_texture((1, 1, 1)))
        b.set_camera((0, 0, 0), (0, 0, -1), vfov=40, aspect_ratio=1.0)
        return b.compile()

    @pytest.mark.slow
    def test_medium_attenuates_light(self, key):
        cfg = RenderConfig(width=24, height=24, samples_per_pixel=32,
                           spp_chunk=8, max_depth=16)
        img_fog, _ = path_tracer.render(self.scene(4.0), cfg, key)
        # same geometry without the medium
        b = SceneBuilder()
        light = b.diffuse_light(b.constant_texture((4, 4, 4)))
        b.add_sphere((0, 0, -6), 1.0, light)
        b.set_camera((0, 0, 0), (0, 0, -1), vfov=40, aspect_ratio=1.0)
        img_clear, _ = path_tracer.render(b.compile(), cfg, key)
        c = (slice(9, 15), slice(9, 15))
        fog = float(np.asarray(img_fog)[c].mean())
        clear = float(np.asarray(img_clear)[c].mean())
        # isotropic white fog scatters light out of the direct view
        assert fog < clear
        assert fog > 0.0  # but some light still comes through / scatters in
        assert np.isfinite(np.asarray(img_fog)).all()

    @pytest.mark.slow
    def test_density_monotonic(self, key):
        """Denser fog scatters more rays before they exit the slab."""
        from raytracer.ops.media import apply_media
        scene_lo = self.scene(0.5)
        scene_hi = self.scene(8.0)
        n = 4096
        o = jnp.broadcast_to(jnp.array([0.0, 0.0, 0.0]), (n, 3))
        d = jnp.broadcast_to(jnp.array([0.0, 0.0, -1.0]), (n, 3))
        miss = ix.Hit(jnp.full((n,), jnp.inf), jnp.full((n,), -1, jnp.int32),
                      jnp.full((n,), -1, jnp.int32))
        attrs_none = ix.hit_attributes(scene_lo, o, d, miss)
        a_lo = apply_media(scene_lo.media, key, o, d, attrs_none, 1e-3)
        a_hi = apply_media(scene_hi.media, key, o, d, attrs_none, 1e-3)
        assert float(jnp.mean(a_hi.valid)) > float(jnp.mean(a_lo.valid))
        # scatter points lie inside the boundary [2,4] along -z
        t = np.asarray(a_hi.t)[np.asarray(a_hi.valid)]
        assert (t >= 2.0 - 1e-3).all() and (t <= 4.0 + 1e-3).all()


class TestNEE:
    @pytest.mark.slow
    def test_direct_light_visibility(self, key):
        b = SceneBuilder()
        white = b.lambertian(b.constant_texture((0.75, 0.75, 0.75)))
        b.add_xz_rect(-10, -10, 10, 10, 0.0, white)           # floor
        b.add_xzrect_light(-1, -1, 1, 1, 5.0, (1, 1, 1), 10.0)
        # occluder between floor-point A and the light
        b.add_box((-0.5, 2.0, -0.5), (0.5, 2.5, 0.5), white)
        scene = b.compile()
        pts = jnp.array([[0.0, 0.0, 0.0],    # under the occluder
                         [5.0, 0.0, 0.0]],   # clear view
                        jnp.float32)
        # start below the occluder (y=1.5 < box bottom 2.0) so both rays
        # land on the floor; the first floor point sits in the box shadow
        o = pts + jnp.array([0.0, 1.5, 0.0])
        d = jnp.broadcast_to(jnp.array([0.0, -1.0, 0.0]), (2, 3))
        hit = ix.intersect_bruteforce(scene, o, d, 1e-3, jnp.inf)
        attrs = ix.hit_attributes(scene, o, d, hit)
        li = np.asarray(sample_li(scene, key, attrs, n_samples=16,
                                  intersector="bruteforce"))
        assert li[1].mean() > 0.1          # lit point sees the light
        assert li[0].mean() < li[1].mean() * 0.2  # shadowed point mostly dark


class TestNoise:
    def test_marble_range_and_variation(self):
        b = SceneBuilder()
        m = b.lambertian(b.noise_texture(scale=4.0))
        b.add_sphere((0, 0, 0), 2.0, m)
        scene = b.compile()
        assert scene.textures.noise_marker.shape[0] == 1
        rng = np.random.default_rng(0)
        p = jnp.asarray(rng.uniform(-2, 2, (1024, 3)), jnp.float32)
        tex_id = jnp.zeros((1024,), jnp.int32)
        c = np.asarray(mat_ops.eval_texture(scene, tex_id, p,
                                            jnp.zeros((1024, 2))))
        assert (c >= 0.0).all() and (c <= 1.0).all()
        assert c.std() > 0.05  # actually varies
        # grayscale marble
        np.testing.assert_allclose(c[:, 0], c[:, 1])

    def test_scenes_without_noise_have_no_marker(self):
        b = SceneBuilder()
        b.lambertian(b.constant_texture((1, 1, 1)))
        assert b.compile().textures.noise_marker.shape[0] == 0


class TestImageTexture:
    def test_earthmap(self, key):
        from PIL import Image
        img = np.asarray(Image.open(os.path.join(TEXTURE, "earthmap.jpg"))
                         .convert("RGB"))
        b = SceneBuilder()
        m = b.lambertian(b.image_texture(img))
        b.add_sphere((0, 0, 0), 2.0, m)
        scene = b.compile()
        assert scene.images.shape[0] == 1
        # UV (0.5, 0.5) ~ pacific blue-ish; (v flip handled in eval)
        tex_id = jnp.asarray(np.full(4, int(scene.materials.tex_id[m])), jnp.int32)
        uv = jnp.array([[0.5, 0.5], [0.0, 0.5], [0.25, 0.8], [0.9, 0.2]],
                       jnp.float32)
        c = np.asarray(mat_ops.eval_texture(scene, tex_id,
                                            jnp.zeros((4, 3)), uv))
        assert (c >= 0).all() and (c <= 1).all()
        assert c.std() > 0.01  # samples differ across the map


class TestBunny:
    @pytest.mark.slow
    def test_bunny_loads_and_intersects(self):
        mesh = load_obj(os.path.join(DATA, "mesh", "bun315.obj"))
        assert mesh.indices.shape[0] > 300
        b = SceneBuilder()
        white = b.lambertian(b.constant_texture((0.73, 0.73, 0.73)))
        m = trs_matrix((0, 0, 0), (20, 20, 20), (0, 0, 0))
        b.add_triangles(mesh.positions, mesh.indices, white,
                        normals=mesh.normals, transform=m)
        scene = b.compile()
        from raytracer.ops import bvh as bvh_ops
        scene_b = bvh_ops.build_bvh(scene)
        lo = np.asarray(scene.bounds_min)
        hi = np.asarray(scene.bounds_max)
        mid = (lo + hi) / 2
        # rays from outside toward the bunny
        o = jnp.asarray(np.tile(mid + [0, 0, hi[2] - lo[2] + 2], (64, 1)),
                        jnp.float32)
        rng = np.random.default_rng(0)
        targets = rng.uniform(lo, hi, (64, 3))
        d = jnp.asarray(targets - np.asarray(o), jnp.float32)
        h1 = ix.intersect_bruteforce(scene, o, d, 1e-4, jnp.inf)
        h2 = bvh_ops.intersect_bvh(scene_b, o, d, 1e-4, jnp.inf)
        t1, t2 = np.asarray(h1.t), np.asarray(h2.t)
        assert np.isfinite(t1).sum() > 10  # plenty of hits
        assert (np.isfinite(t1) == np.isfinite(t2)).all()
        both = np.isfinite(t1)
        np.testing.assert_allclose(t1[both], t2[both], rtol=1e-4, atol=1e-4)


class TestMotionBlur:
    def build(self, moving: bool):
        b = SceneBuilder()
        lightm = b.diffuse_light(b.constant_texture((5, 5, 5)))
        if moving:
            b.add_moving_sphere((-1.5, 0, -4), (1.5, 0, -4), 0.5, lightm)
        else:
            b.add_sphere((-1.5, 0, -4), 0.5, lightm)
        b.set_camera((0, 0, 0), (0, 0, -1), vfov=60, aspect_ratio=1.0,
                     time0=0.0, time1=1.0)
        return b.compile()

    @pytest.mark.slow
    def test_moving_sphere_smears(self, key):
        cfg = RenderConfig(width=32, height=32, samples_per_pixel=16,
                           spp_chunk=4, max_depth=3)
        img_m = np.asarray(path_tracer.render(self.build(True), cfg, key)[0])
        img_s = np.asarray(path_tracer.render(self.build(False), cfg, key)[0])
        row = img_m[14:18].mean(axis=(0, 2))   # middle rows, across columns
        row_s = img_s[14:18].mean(axis=(0, 2))
        # static: bright only on the left; moving: energy spread to the right
        left = slice(0, 12)
        right = slice(20, 32)
        assert row_s[left].max() > 0.2 and row_s[right].max() < 1e-3
        assert row[right].max() > 0.05          # smear reaches the right
        assert row[left].max() < row_s[left].max()  # per-column dimmer

    def test_exact_time_intersection(self):
        """At time t the sphere center is c + v*t — verify the quadratic's
        expanded motion terms give the exact hit distance."""
        import jax.numpy as jnp
        b = SceneBuilder()
        m = b.lambertian(b.constant_texture((1, 1, 1)))
        b.add_moving_sphere((0, 0, -5), (4, 0, -5), 1.0, m)  # v = (4,0,0)
        b.set_camera((0, 0, 0), (0, 0, -1), time0=0.0, time1=1.0)
        scene = b.compile()
        # at t=0.5 center is (2,0,-5); aim straight at it
        o = jnp.array([[2.0, 0.0, 0.0]], jnp.float32)
        d = jnp.array([[0.0, 0.0, -1.0]], jnp.float32)
        t_ray = jnp.array([0.5], jnp.float32)
        t0, _ = ix.sphere_closest(o, d, scene.spheres, 1e-3, jnp.inf,
                                  time=t_ray)
        np.testing.assert_allclose(float(t0[0]), 4.0, rtol=1e-5)
        # at t=0 that same ray passes 2 units from the center -> miss
        t1, _ = ix.sphere_closest(o, d, scene.spheres, 1e-3, jnp.inf,
                                  time=jnp.zeros(1))
        assert np.isinf(np.asarray(t1))[0]

    @pytest.mark.slow
    def test_zero_shutter_matches_static(self, key):
        """time0 == time1 == 0 must reproduce the static image exactly."""
        b = SceneBuilder()
        m = b.diffuse_light(b.constant_texture((5, 5, 5)))
        b.add_moving_sphere((0, 0, -4), (3, 0, -4), 0.5, m)
        b.set_camera((0, 0, 0), (0, 0, -1), vfov=60, aspect_ratio=1.0,
                     time0=0.0, time1=0.0)
        scene_m = b.compile()
        b2 = SceneBuilder()
        m2 = b2.diffuse_light(b2.constant_texture((5, 5, 5)))
        b2.add_sphere((0, 0, -4), 0.5, m2)
        b2.set_camera((0, 0, 0), (0, 0, -1), vfov=60, aspect_ratio=1.0)
        scene_s = b2.compile()
        cfg = RenderConfig(width=16, height=16, samples_per_pixel=4,
                           spp_chunk=4, max_depth=2, intersector="bruteforce")
        img_m = np.asarray(path_tracer.render(scene_m, cfg, key)[0])
        img_s = np.asarray(path_tracer.render(scene_s, cfg, key)[0])
        np.testing.assert_allclose(img_m, img_s, atol=1e-5)


class TestTransformRotation:
    def test_rotated_box_hits(self):
        # 45-degree rotated unit square (two triangles) about y
        pos = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                       np.float32)
        idx = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        m = trs_matrix((0, 45, 0), (1, 1, 1), (0, 0, -3))
        b = SceneBuilder()
        mat = b.lambertian(b.constant_texture((1, 1, 1)))
        b.add_triangles(pos, idx, mat, transform=m)
        scene = b.compile()
        o = jnp.array([[0.0, 0, 0]], jnp.float32)
        d = jnp.array([[0.0, 0, -1]], jnp.float32)
        hit = ix.intersect_bruteforce(scene, o, d, 1e-3, jnp.inf)
        np.testing.assert_allclose(float(hit.t[0]), 3.0, rtol=1e-5)
        attrs = ix.hit_attributes(scene, o, d, hit)
        # normal rotated 45 deg about y, flipped toward the ray
        nrm = np.asarray(attrs.normal[0])
        s = 1 / np.sqrt(2)
        np.testing.assert_allclose(np.abs(nrm), [s, 0, s], atol=1e-5)


@pytest.mark.slow
def test_cornell_smoke_builtin(key):
    """cornell_smoke: media at render scale (book-2 cornell_smoke class).
    Must render finite and nonzero end-to-end — through the SoA wavefront
    (apply_media_soa free-flight override) — and the
    smoke must attenuate the scene overall: the dark smoke box absorbs
    light the plain box walls would reflect."""
    from raytracer.scene.builtin import cornell_box, cornell_smoke
    cfg = RenderConfig(width=32, height=32, samples_per_pixel=16,
                       spp_chunk=4, max_depth=12)
    img_s, _ = path_tracer.render(cornell_smoke(), cfg, key)
    img_c, _ = path_tracer.render(cornell_box(with_mesh=False), cfg, key)
    a_s, a_c = np.asarray(img_s), np.asarray(img_c)
    assert np.isfinite(a_s).all()
    assert a_s.mean() > 0.0
    assert a_s.mean() < a_c.mean()


@pytest.mark.slow
def test_media_soa_matches_aos(key):
    """The SoA media path (wavefront_soa.bounce_step + apply_media_soa,
    PRIM_MEDIA winner override) must agree with the AoS reference loop
    (path_tracer's (N,3) wavefront + ops/media.apply_media) in
    expectation: same fold-29 free-flight streams, same isotropic phase
    semantics. MC band on the same render config."""
    from raytracer.scene.builtin import cornell_smoke
    scene = cornell_smoke()
    kw = dict(width=24, height=24, spp=24, spp_chunk=4, max_depth=10,
              t_min=1e-3, spawn_eps_rel=1e-4, russian_roulette=True)
    img_soa, rays_soa = path_tracer.render_fn(scene, key,
                                              intersector="xla", **kw)
    img_aos, rays_aos = path_tracer.render_fn(scene, key,
                                              intersector="bruteforce", **kw)
    a, b = np.asarray(img_soa), np.asarray(img_aos)
    assert np.isfinite(a).all() and int(rays_soa) > 0
    # gamma-space comparison (MC noise at 24spp)
    ga, gb = np.sqrt(np.clip(a, 0, None)), np.sqrt(np.clip(b, 0, None))
    assert abs(ga.mean() - gb.mean()) < 0.05 * max(gb.mean(), 1e-6), (
        ga.mean(), gb.mean())
    assert np.abs(ga - gb).mean() < 0.08


@pytest.mark.slow
def test_media_soa_isotropic_scatter_and_override():
    """Unit-level: apply_media_soa overrides the winner exactly where the
    free-flight event lands inside the boundary ahead of the geometric
    hit, and the resulting PRIM_MEDIA record flows through attrs_soa /
    scatter_soa as an isotropic phase event (uniform-sphere direction,
    albedo attenuation, INTER_DIFFUSE)."""
    import jax
    import jax.numpy as jnp
    from raytracer.models.wavefront_soa import attrs_soa, scatter_soa
    from raytracer.ops.media import apply_media_soa
    from raytracer.ops.closest_hit import N_SLOTS
    from raytracer.scene import SceneBuilder
    from raytracer.scene.types import PRIM_MEDIA, INTER_DIFFUSE

    b = SceneBuilder()
    m = b.lambertian(b.constant_texture((1.0, 1.0, 1.0)))
    b.add_sphere((0.0, 0.0, -50.0), 1.0, m)   # far geometry behind the fog
    b.add_constant_medium_box((-5.0, -5.0, -20.0), (5.0, 5.0, -2.0),
                              5.0, b.constant_texture((0.3, 0.6, 0.9)))
    scene = b.compile()
    n = 8
    ox = oy = jnp.zeros((n,), jnp.float32)
    oz = jnp.zeros((n,), jnp.float32)
    dx = dy = jnp.zeros((n,), jnp.float32)
    dz = jnp.full((n,), -1.0, jnp.float32)
    t = jnp.full((n,), 49.0, jnp.float32)     # geometric hit at z=-49
    ty = jnp.zeros((n,), jnp.float32)
    data = jnp.zeros((N_SLOTS, n), jnp.float32)
    t2, ty2, data2 = apply_media_soa(scene, jax.random.PRNGKey(0),
                                     ox, oy, oz, dx, dy, dz, t, ty, data,
                                     1e-3)
    t2 = np.asarray(t2)
    ty2 = np.asarray(ty2)
    # density 5 over an 18-unit window: every ray scatters in the fog
    assert (ty2 == PRIM_MEDIA).all()
    assert ((t2 > 2.0) & (t2 < 20.0)).all()

    h, f = attrs_soa(ox, oy, oz, dx, dy, dz, jnp.asarray(t2),
                     jnp.asarray(ty2), data2)
    np.testing.assert_allclose(np.asarray(h.nx), -1.0, atol=1e-6)  # flipped
    sc = scatter_soa(scene, jax.random.PRNGKey(1), dx, dy, dz, h, f)
    assert (np.asarray(sc.interaction) == INTER_DIFFUSE).all()
    np.testing.assert_allclose(np.asarray(sc.ar), 0.3, atol=1e-6)
    np.testing.assert_allclose(np.asarray(sc.ab), 0.9, atol=1e-6)
    # isotropic: direction is the raw unit-sphere draw, not normal-coupled
    d3 = np.stack([np.asarray(sc.dx), np.asarray(sc.dy),
                   np.asarray(sc.dz)], -1)
    np.testing.assert_allclose(np.linalg.norm(d3, axis=-1), 1.0, atol=1e-5)
