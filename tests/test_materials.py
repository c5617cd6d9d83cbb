"""Material scatter semantics tests (material.rs:92-212)."""

import pytest
import jax
import jax.numpy as jnp
import numpy as np

from raytracer.ops import intersect as ix
from raytracer.ops import materials as mops
from raytracer.ops import vec
from raytracer.scene import SceneBuilder
from raytracer.scene.types import (
    INTER_ABSORB, INTER_DIFFUSE, INTER_REFLECT, INTER_REFRACT, INTER_SPECULAR,
)

FRAC_1_PI = 0.3183098861837907


def hit_on(scene, o, d):
    o = jnp.asarray(o, jnp.float32)[None]
    d = jnp.asarray(d, jnp.float32)[None]
    hit = ix.intersect_bruteforce(scene, o, d, 1e-3, jnp.inf)
    return o, d, ix.hit_attributes(scene, o, d, hit)


def repeat_hit(attrs, o, d, n):
    tile = lambda a: jnp.broadcast_to(a, (n,) + a.shape[1:])
    return (tile(o), tile(d),
            ix.HitAttrs(*[tile(x) for x in attrs]))


class TestLambertian:
    def scene(self):
        b = SceneBuilder()
        m = b.lambertian(b.constant_texture((0.7, 0.3, 0.1)))
        b.add_xz_rect(-10, -10, 10, 10, 0.0, m)
        return b.compile()

    @pytest.mark.slow
    def test_diffuse_interaction_and_attenuation(self, key):
        s = self.scene()
        o, d, attrs = hit_on(s, [0, 2, 0], [0, -1, 0])
        o, d, attrs = repeat_hit(attrs, o, d, 4096)
        sc = mops.scatter(s, key, d, attrs)
        assert np.all(np.asarray(sc.interaction) == INTER_DIFFUSE)
        np.testing.assert_allclose(np.asarray(sc.attenuation[0]),
                                   [0.7, 0.3, 0.1], atol=1e-6)
        np.testing.assert_allclose(np.asarray(sc.emitted), 0.0)
        # all scatter dirs in upper hemisphere
        up = np.asarray(sc.direction[:, 1])
        assert np.all(up > -1e-6)


class TestMetal:
    def scene(self, fuzz):
        b = SceneBuilder()
        m = b.metal(b.constant_texture((0.9, 0.9, 0.9)), fuzz)
        b.add_xz_rect(-10, -10, 10, 10, 0.0, m)
        return b.compile()

    def test_perfect_mirror(self, key):
        s = self.scene(0.0)
        o, d, attrs = hit_on(s, [-1, 1, 0], [1, -1, 0])
        sc = mops.scatter(s, key, d, attrs)
        assert int(sc.interaction[0]) == INTER_SPECULAR
        got = np.asarray(vec.unit(sc.direction))[0]
        np.testing.assert_allclose(got, np.array([1, 1, 0]) / np.sqrt(2), atol=1e-5)

    def test_fuzzy_spread_and_absorb(self, key):
        s = self.scene(0.8)
        o, d, attrs = hit_on(s, [-1, 0.02, 0], [1, -0.02, 0])  # grazing
        o, d, attrs = repeat_hit(attrs, o, d, 4096)
        sc = mops.scatter(s, key, d, attrs)
        inter = np.asarray(sc.interaction)
        # grazing + large fuzz must absorb some lanes (material.rs:133-137)
        assert (inter == INTER_ABSORB).sum() > 0
        assert (inter == INTER_SPECULAR).sum() > 0
        spec = inter == INTER_SPECULAR
        assert np.all(np.asarray(vec.dot(sc.direction, attrs.normal))[spec] > 0)


class TestDielectric:
    def scene(self, ir=1.5):
        b = SceneBuilder()
        m = b.dielectric(ir)
        b.add_xz_rect(-10, -10, 10, 10, 0.0, m)
        return b.compile()

    def test_normal_incidence_mostly_refracts(self, key):
        s = self.scene(1.5)
        o, d, attrs = hit_on(s, [0, 2, 0], [0, -1, 0])
        o, d, attrs = repeat_hit(attrs, o, d, 8192)
        sc = mops.scatter(s, key, d, attrs)
        inter = np.asarray(sc.interaction)
        frac_reflect = (inter == INTER_REFLECT).mean()
        # Schlick at normal incidence, ir=1.5: r0 = 0.04
        assert abs(frac_reflect - 0.04) < 0.01
        refr = inter == INTER_REFRACT
        # refracted rays continue downward through the surface
        assert np.all(np.asarray(sc.direction[:, 1])[refr] < 0)

    @pytest.mark.slow
    def test_total_internal_reflection(self, key):
        s = self.scene(1.5)
        # ray from below (inside medium, front_face=False), grazing up:
        # sin > 1/1.5 -> TIR always reflects
        o, d, attrs = hit_on(s, [0, -1, 0], [1, 0.3, 0])
        assert not bool(attrs.front_face[0])
        o, d, attrs = repeat_hit(attrs, o, d, 1024)
        sc = mops.scatter(s, key, d, attrs)
        assert np.all(np.asarray(sc.interaction) == INTER_REFLECT)

    def test_attenuation_is_tint(self, key):
        b = SceneBuilder()
        m = b.dielectric(1.5, b.constant_texture((0.9, 0.5, 0.1)))
        b.add_xz_rect(-10, -10, 10, 10, 0.0, m)
        s = b.compile()
        o, d, attrs = hit_on(s, [0, 2, 0], [0, -1, 0])
        sc = mops.scatter(s, jax.random.PRNGKey(0), d, attrs)
        np.testing.assert_allclose(np.asarray(sc.attenuation[0]),
                                   [0.9, 0.5, 0.1], atol=1e-6)


class TestDiffuseLight:
    def scene(self):
        b = SceneBuilder()
        m = b.diffuse_light(b.constant_texture((3.0, 2.0, 1.0)))
        b.add_xz_rect(-10, -10, 10, 10, 0.0, m)
        return b.compile()

    def test_emits_and_scatters(self, key):
        """The reference's DiffuseLight BOTH emits and diffusely scatters
        with bsdf 1/pi (material.rs:201-212)."""
        s = self.scene()
        o, d, attrs = hit_on(s, [0, 2, 0], [0, -1, 0])
        sc = mops.scatter(s, key, d, attrs)
        assert int(sc.interaction[0]) == INTER_DIFFUSE
        np.testing.assert_allclose(np.asarray(sc.emitted[0]), [3, 2, 1], atol=1e-5)
        np.testing.assert_allclose(np.asarray(sc.attenuation[0]),
                                   FRAC_1_PI, atol=1e-6)


class TestChecker:
    def test_world_space_checker(self, key):
        b = SceneBuilder()
        m = b.lambertian(b.checker_texture((1, 0, 0), (0, 1, 0)))
        b.add_xz_rect(-100, -100, 100, 100, 0.0, m)
        s = b.compile()
        # sin(10x)sin(10y)sin(10z) at p=(0.5,0,0.5): y=0 -> sines=0 -> not <0
        # -> color1 (material.rs:58-68)
        tex_id = jnp.zeros((1,), jnp.int32) + int(np.asarray(s.materials.tex_id[m]))
        p = jnp.array([[0.5, 0.0, 0.5]], jnp.float32)
        c = mops.eval_texture(s, tex_id, p, jnp.zeros((1, 2)))
        np.testing.assert_allclose(np.asarray(c[0]), [0, 1, 0], atol=1e-6)


class TestPhotonRR:
    def test_power_renormalization(self, key):
        b = SceneBuilder()
        m = b.lambertian(b.constant_texture((0.8, 0.4, 0.2)))
        b.add_xz_rect(-10, -10, 10, 10, 0.0, m)
        s = b.compile()
        o, d, attrs = hit_on(s, [0, 2, 0], [0, -1, 0])
        o, d, attrs = repeat_hit(attrs, o, d, 8192)
        power = jnp.ones((8192, 3))
        sc, new_power = mops.scatter_photon(s, key, d, attrs, power)
        inter = np.asarray(sc.interaction)
        surv = inter != INTER_ABSORB
        # survival prob = max(f) = 0.8 (material.rs:36-38)
        assert abs(surv.mean() - 0.8) < 0.02
        # surviving photons carry power * f / max(f) = (1, 0.5, 0.25)
        np.testing.assert_allclose(np.asarray(new_power)[surv][0],
                                   [1.0, 0.5, 0.25], atol=1e-5)
