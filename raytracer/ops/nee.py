"""Next-event estimation / direct light sampling — the reference's
``Light::sample_li`` (light.rs:107-124 sphere, :170-183 rect; summed over
lights by AllLights::sample_li, light.rs:229-234).

NOTE: the reference never calls sample_li from its active integrator (SPPM
covers direct lighting via photons + emission) — this ships for capability
parity and for a PT+NEE mode. Reference quirks preserved: shadow rays start
exactly at the surface point with the (1e-4, t-1e-4) window; each light's
estimate is averaged over its own samples then *summed* over lights (no
selection pdf); the contribution is flux ⊙ bsdf * max(0, n·dir) with no
distance falloff (the reference's /r^2 term is commented out, light.rs:120).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer.ops import materials as mat_ops
from raytracer.ops import sampling, vec
from raytracer.ops.dispatch import intersect_scene
from raytracer.ops.intersect import HitAttrs
from raytracer.scene.types import LIGHT_SPHERE, Scene


def sample_li(scene: Scene, key, attrs: HitAttrs, n_samples: int = 4,
              intersector: str = "auto"):
    """Direct radiance at each shading point: (N, 3).

    Estimator parity with the reference's sum-over-lights (AllLights::
    sample_li, light.rs:229-234) WITHOUT the per-light unroll: each
    (lane, sample) picks ONE light by the power-proportional categorical
    (light.rs:220-225's WeightedIndex) and weights its contribution by
    1/prob — E[contrib/prob] = sum over lights of contrib, so the mean
    matches the reference while the trace holds one shadow cast per
    sample regardless of registered-light count (scene_500 registers 501
    emitters; the old loop compiled ~2000 casts). Reference quirks kept:
    shadow window (1e-4, dist-1e-4), no distance falloff (light.rs:120 is
    commented out), contribution = flux ⊙ bsdf * max(0, n·dir)."""
    n = attrs.p.shape[0]
    lights = scene.lights
    n_lights = lights.kind.shape[0]
    if n_lights == 0:
        return jnp.zeros((n, 3), jnp.float32)
    bsdf_color = mat_ops.bsdf(scene, attrs.mat_id, attrs.p, attrs.uv)
    total = jnp.zeros((n, 3), jnp.float32)

    for s in range(n_samples):
        k = jax.random.fold_in(key, s)
        k_pick, k1, k2 = jax.random.split(k, 3)
        if n_lights == 1:
            idx = jnp.zeros((n,), jnp.int32)
            inv_prob = 1.0
        else:
            idx = jax.random.categorical(k_pick, lights.log_prob,
                                         shape=(n,))
            inv_prob = jnp.exp(-lights.log_prob)[idx][:, None]
        kind = lights.kind[idx]                 # (N,) per-lane params
        p0 = lights.p0[idx]                     # (N, 3)
        p1 = lights.p1[idx]
        r0 = lights.r0[idx][:, None]
        flux = lights.flux[idx]
        # sphere light: hemisphere toward the shading point
        # (light.rs:110-113)
        center_to_p = vec.unit(attrs.p - p0)
        sph_pt = p0 + sampling.uniform_hemisphere(k1, center_to_p) * r0
        # rect light: uniform point on the area (light.rs:148-154)
        uv = jax.random.uniform(k2, (n, 2))
        rect_pt = jnp.stack([
            p0[:, 0] + (p1[:, 0] - p0[:, 0]) * uv[:, 0],
            p0[:, 1],
            p0[:, 2] + (p1[:, 2] - p0[:, 2]) * uv[:, 1],
        ], axis=-1)
        point = jnp.where((kind == LIGHT_SPHERE)[:, None], sph_pt, rect_pt)
        to_light = point - attrs.p
        dist = jnp.sqrt(vec.dot(to_light, to_light))
        dir_ = to_light / jnp.maximum(dist, 1e-12)[:, None]
        hit = intersect_scene(scene, attrs.p, dir_, 1e-4,
                              jnp.maximum(dist - 1e-4, 1e-4), intersector)
        visible = ~jnp.isfinite(hit.t)
        cos_term = jnp.maximum(vec.dot(attrs.normal, dir_), 0.0)
        contrib = flux * inv_prob * bsdf_color * cos_term[:, None]
        total = total + jnp.where((visible & attrs.valid)[:, None],
                                  contrib, 0.0)
    return total / n_samples


PI = 3.141592653589793


def direct_light(scene: Scene, key, p, normal, albedo, valid,
                 n_samples: int = 1, intersector: str = "auto", alive=None,
                 time=None):
    """Consistent next-event estimation for the PT+NEE mode (``--nee``).

    Unlike :func:`sample_li` (a faithful port of the reference's dead code,
    quirks included), this is a proper area-sampling estimator matched to
    the framework's path-tracer conventions (cosine-weighted diffuse scatter
    with attenuation = albedo, i.e. f_r = albedo/pi):

        L_d = Le * (albedo/pi) * cos(theta) * cos(theta') / r^2 / pdf_area

    with pdf_area = 1/A (rect) or 1/(2 pi r0^2) (sphere, hemisphere facing
    the shading point). Paired with emission-skip on diffuse-scattered rays
    in the tracer, PT+NEE keeps the plain PT mean while cutting variance on
    direct-lit scenes (tests/test_nee.py).

    CONTRACT (--nee correctness requires both; plain PT needs neither):
    - every emitter must have a registered light record (add_sphere_light /
      add_rect_light or the loader paths). The tracer skips BRDF-sampled
      emission after EVERY diffuse bounce, so an emissive DiffuseLight
      without a record (SceneBuilder.diffuse_light alone) loses its energy
      under --nee;
    - emit textures must be CONSTANT: the light record's flux is the emit
      texture's mean color, so a non-constant emit texture would make the
      shadow-ray estimator disagree with BRDF-sampled emission (the loader
      only produces constant emits; checker/image emitters would need
      texture evaluation at the sampled light point here).

    MANY LIGHTS: each lane picks ONE light per
    sample with the power-proportional categorical of lights.log_prob (the
    AllLights analog, light.rs:220-225) and weights by 1/prob — one shadow
    cast per bounce regardless of light count. The previous per-light
    Python loop unrolled a full intersect_scene per registered light:
    scene_500's 501 loader-registered emitters would have compiled 501
    shadow casts per bounce. Unbiased: E[contrib_pick/prob] = sum over
    lights of contrib. The per-lane light parameters are 8 tiny (L,) table
    gathers."""
    n = p.shape[0]
    lights = scene.lights
    n_lights = lights.kind.shape[0]
    if n_lights == 0:
        return jnp.zeros((n, 3), jnp.float32)
    total = jnp.zeros((n, 3), jnp.float32)

    for s in range(n_samples):
        k = jax.random.fold_in(jax.random.fold_in(key, 1000), s)
        k_pick, k1, k2 = jax.random.split(k, 3)
        if n_lights == 1:
            idx = jnp.zeros((n,), jnp.int32)    # prob 1: same estimator
            inv_prob = 1.0
        else:
            idx = jax.random.categorical(k_pick, lights.log_prob,
                                         shape=(n,))
            inv_prob = jnp.exp(-lights.log_prob)[idx][:, None]
        kind = lights.kind[idx]                 # (N,) per-lane light params
        p0 = lights.p0[idx]                     # (N, 3)
        if time is not None:
            # moving emitters: sample the center at the shadow ray's
            # shutter time (the sphere geometry moves with the same
            # velocity in the primitive table)
            p0 = p0 + lights.vel[idx] * jnp.asarray(
                time, jnp.float32)[:, None]
        p1 = lights.p1[idx]
        r0 = lights.r0[idx][:, None]
        flux = lights.flux[idx]
        # sphere: uniform point on the hemisphere facing the point
        center_to_p = vec.unit(p - p0)
        sph_pt = p0 + sampling.uniform_hemisphere(k1, center_to_p) * r0
        sph_n = vec.unit(sph_pt - p0)
        sph_inv_pdf = 2.0 * PI * r0[:, 0] * r0[:, 0]
        # rect (XZ plane at y = p0[1], normal facing down like
        # XZRectLight's emission, light.rs:158-166)
        uv = jax.random.uniform(k2, (n, 2))
        rect_pt = jnp.stack([
            p0[:, 0] + (p1[:, 0] - p0[:, 0]) * uv[:, 0],
            p0[:, 1],
            p0[:, 2] + (p1[:, 2] - p0[:, 2]) * uv[:, 1],
        ], axis=-1)
        rect_n = jnp.broadcast_to(
            jnp.asarray([0.0, -1.0, 0.0], jnp.float32), (n, 3))
        rect_inv_pdf = jnp.abs((p1[:, 0] - p0[:, 0])
                               * (p1[:, 2] - p0[:, 2]))

        is_sph = (kind == LIGHT_SPHERE)[:, None]
        point = jnp.where(is_sph, sph_pt, rect_pt)
        n_l = jnp.where(is_sph, sph_n, rect_n)
        inv_pdf = jnp.where(is_sph[:, 0], sph_inv_pdf, rect_inv_pdf)

        # Contribution geometry (dist/cos/geom) is computed from the TRUE
        # surface point: measuring it from an offset origin biases the
        # estimator whenever the offset is comparable to the light
        # distance. That is not hypothetical — scene.scale is global, so
        # scene_500's radius-1000 ground sphere makes 1e-4*scale = 0.35,
        # LARGER than its radius-0.2 resting emitters; measuring
        # everything from p + 0.35*n, i.e. from above the lights, lost 32%
        # of the image mean under --nee. The offset exists only to keep the occlusion ray off the
        # emitting/receiving surfaces (f32 acne), so it applies to the
        # intersect origin alone and is clamped to a tenth of the light
        # distance (Cornell-scale behavior unchanged: there
        # 1e-4*scale=0.055 << 0.1*dist).
        to_light = point - p
        dist2 = jnp.maximum(vec.dot(to_light, to_light), 1e-12)
        dist = jnp.sqrt(dist2)
        dir_ = to_light / dist[:, None]
        cos_p = jnp.maximum(vec.dot(normal, dir_), 0.0)
        # rect lights EMIT two-sided in this framework (materials.py
        # returns Le with no front-face check), so the rect cos term is
        # two-sided too; a sphere light's far side is never visible
        cos_l = jnp.where(is_sph[:, 0],
                          jnp.maximum(vec.dot(n_l, -dir_), 0.0),
                          jnp.abs(vec.dot(n_l, -dir_)))
        geom = cos_p * cos_l / dist2 * inv_pdf
        candidate = valid & (geom > 0.0)
        eps_sh = jnp.minimum(1e-4 * scene.scale, 0.1 * dist)
        p_sh = p + normal * eps_sh[:, None]
        to_sh = point - p_sh
        dist_sh = jnp.sqrt(jnp.maximum(vec.dot(to_sh, to_sh), 1e-12))
        dir_sh = to_sh / dist_sh[:, None]
        # shadow rays inherit the shading ray's shutter time so
        # moving occluders are tested where the camera ray saw them
        hit = intersect_scene(scene, p_sh, dir_sh, 1e-3, dist_sh * 0.999,
                              intersector, time=time,
                              alive=(candidate if alive is None
                                     else candidate & alive))
        visible = ~jnp.isfinite(hit.t)
        contrib = flux * inv_prob * (albedo / PI) * geom[:, None]
        total = total + jnp.where((visible & candidate)[:, None],
                                  contrib, 0.0)
    return total / n_samples
