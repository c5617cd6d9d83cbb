"""Mixture-PDF importance sampling at diffuse vertices (``--mis``).

Book-3 ("Ray Tracing: The Rest of Your Life") style BRDF/light mixture
sampling — an EXTENSION: the reference has no PDF classes anywhere (no
`pdf.rs`; SURVEY.md §8), its diffuse scatter is plain cosine sampling
(material.rs:92-113). With probability 1/2 a diffuse bounce keeps the
cosine-sampled direction, else it samples a direction toward a
power-categorical-picked light (sphere lights via cone sampling, rect
lights via uniform-area sampling — the same light table NEE uses,
light.rs:220-225 analog). No shadow rays: occlusion is resolved by the
bounce ray itself, so the estimator stays single-kernel per bounce.

Weighting preserves every reference scatter quirk by construction: plain
PT multiplies throughput by ``attenuation`` under cosine sampling, i.e.
the integrand is f(d) = attenuation * pdf_cos(d); under the mixture the
multiplier becomes f(d)/pdf_mix(d) = attenuation * pdf_cos(d)/pdf_mix(d)
— one scalar reweight, no material-specific branching, so DiffuseLight's
emit-AND-scatter 1/pi quirk (material.rs:201-208) carries through
unchanged and the mean matches plain PT exactly.

pdf_mix(d) = 0.5 * pdf_cos(d) + 0.5 * sum_j prob_j * pdf_j(d), evaluated
in closed form against every light record ((N, L) broadcast — pure math,
no intersections):
- sphere j: uniform-solid-angle cone toward the sphere, pdf =
  1/(2 pi (1 - cos_theta_max)) inside the cone, 0 outside
  (cos_theta_max = sqrt(1 - r^2/dist^2));
- rect j (XZ plane): uniform area point, solid-angle pdf =
  dist^2 / (|cos_l| * area) when the direction pierces the rect.
Moving emitters evaluate their center at the lane's shutter time
(lights.vel — same rule as ops/nee.py)."""

from __future__ import annotations

import jax
import jax.numpy as jnp

from raytracer.ops import vec

from raytracer.scene.types import LIGHT_SPHERE, Scene

PI = 3.141592653589793
TWO_PI = 6.283185307179586


def _light_centers(lights, time):
    """(L, 3) static centers -> (N?, L, 3) time-evaluated centers."""
    p0 = lights.p0[None]                                     # (1, L, 3)
    if time is not None:
        p0 = p0 + lights.vel[None] * jnp.asarray(
            time, jnp.float32)[:, None, None]                # (N, L, 3)
    return p0


def sample_light_dir(scene: Scene, key, p, time=None):
    """One direction toward a power-picked light per lane.
    Returns (N, 3) unit directions (zero vector when no light exists)."""
    lights = scene.lights
    n = p.shape[0]
    n_lights = lights.kind.shape[0]
    if n_lights == 0:
        return jnp.zeros((n, 3), jnp.float32)
    k_pick, k1, k2 = jax.random.split(key, 3)
    if n_lights == 1:
        idx = jnp.zeros((n,), jnp.int32)
    else:
        idx = jax.random.categorical(k_pick, lights.log_prob, shape=(n,))
    kind = lights.kind[idx]
    c = _light_centers(lights, time)                         # (N|1, L, 3)
    c = jnp.take_along_axis(
        jnp.broadcast_to(c, (n, n_lights, 3)), idx[:, None, None], 1)[:, 0]
    p1 = lights.p1[idx]
    r = lights.r0[idx]

    # sphere: uniform direction in the cone subtending the sphere
    to_c = c - p
    dist2 = jnp.maximum(vec.dot(to_c, to_c), 1e-12)
    dist = jnp.sqrt(dist2)
    axis = to_c / dist[:, None]
    cos_max = jnp.sqrt(jnp.clip(1.0 - r * r / dist2, 0.0, 1.0))
    u1, u2 = jax.random.uniform(k1, (n,)), jax.random.uniform(k2, (n,))
    z = 1.0 + u1 * (cos_max - 1.0)                           # [cos_max, 1]
    phi = TWO_PI * u2
    s = jnp.sqrt(jnp.maximum(0.0, 1.0 - z * z))
    # orthonormal frame around axis
    h = jnp.where(jnp.abs(axis[:, 0:1]) > 0.9,
                  jnp.asarray([0.0, 1.0, 0.0]),
                  jnp.asarray([1.0, 0.0, 0.0]))
    t1 = vec.unit(vec.cross(axis, h), eps=1e-30)
    t2 = vec.cross(axis, t1)
    d_sph = (axis * z[:, None] + t1 * (s * jnp.cos(phi))[:, None]
             + t2 * (s * jnp.sin(phi))[:, None])

    # rect: uniform point on the XZ rect (p0..p1 at y = p0.y)
    pt = jnp.stack([
        c[:, 0] + (p1[:, 0] - c[:, 0]) * u1,
        c[:, 1],
        c[:, 2] + (p1[:, 2] - c[:, 2]) * u2,
    ], axis=-1)
    d_rect = vec.unit(pt - p)

    return jnp.where((kind == LIGHT_SPHERE)[:, None], d_sph, d_rect)


def light_pdf(scene: Scene, p, d, time=None):
    """Solid-angle pdf of ``sample_light_dir`` producing unit direction
    ``d`` from ``p`` — the power-weighted mixture over all lights,
    evaluated in closed form ((N, L) broadcast, no ray casts)."""
    lights = scene.lights
    n = p.shape[0]
    n_lights = lights.kind.shape[0]
    if n_lights == 0:
        return jnp.zeros((n,), jnp.float32)
    c = jnp.broadcast_to(_light_centers(lights, time),
                         (n, n_lights, 3))                   # (N, L, 3)
    is_sph = (lights.kind == LIGHT_SPHERE)[None]             # (1, L)
    r = lights.r0[None]                                      # (1, L)

    to_c = c - p[:, None]                                    # (N, L, 3)
    dist2 = jnp.maximum(jnp.sum(to_c * to_c, -1), 1e-12)     # (N, L)
    cos_max = jnp.sqrt(jnp.clip(1.0 - r * r / dist2, 0.0, 1.0))
    cos_d = jnp.sum(to_c * d[:, None], -1) / jnp.sqrt(dist2)
    in_cone = cos_d >= cos_max
    pdf_sph = jnp.where(in_cone,
                        1.0 / (TWO_PI * jnp.maximum(1.0 - cos_max, 1e-8)),
                        0.0)

    # rect: direction pierces the XZ plane inside the bounds
    y = lights.p0[None, :, 1]                                # (1, L)
    x0 = jnp.minimum(lights.p0[:, 0], lights.p1[:, 0])[None]
    x1 = jnp.maximum(lights.p0[:, 0], lights.p1[:, 0])[None]
    z0 = jnp.minimum(lights.p0[:, 2], lights.p1[:, 2])[None]
    z1 = jnp.maximum(lights.p0[:, 2], lights.p1[:, 2])[None]
    dy = d[:, None, 1]                                       # (N, 1)
    t = (y - p[:, None, 1]) / jnp.where(jnp.abs(dy) < 1e-9, 1e-9, dy)
    hx = p[:, None, 0] + t * d[:, None, 0]
    hz = p[:, None, 2] + t * d[:, None, 2]
    on_rect = ((t > 1e-4) & (hx >= x0) & (hx <= x1)
               & (hz >= z0) & (hz <= z1))
    area = jnp.maximum((x1 - x0) * (z1 - z0), 1e-12)
    pdf_rect = jnp.where(on_rect,
                         t * t / (jnp.maximum(jnp.abs(dy), 1e-8) * area),
                         0.0)

    pdf_j = jnp.where(is_sph, pdf_sph, pdf_rect)             # (N, L)
    return jnp.sum(lights.prob[None] * pdf_j, -1)            # (N,)


def mixture_reweight(scene: Scene, key, p, normal, d_cos, diffuse,
                     time=None):
    """The ``--mis`` diffuse-vertex resample: returns (d_new, w) where
    ``d_new`` (N, 3) replaces the scatter direction on diffuse lanes and
    ``w`` (N,) multiplies the throughput update (1 on non-diffuse lanes).

    w = pdf_cos(d_new) / pdf_mix(d_new): plain PT's throughput *=
    attenuation assumes cosine sampling, so the mixture estimator just
    reweights by the pdf ratio — mean provably unchanged, variance down
    wherever light sampling finds what cosine sampling misses."""
    n_lights = scene.lights.kind.shape[0]
    d_unit = vec.unit(d_cos, eps=1e-30)
    if n_lights == 0:
        return d_unit, jnp.ones((p.shape[0],), jnp.float32)
    k_choice, k_light = jax.random.split(key)
    pick_light = jax.random.uniform(k_choice, (p.shape[0],)) < 0.5
    d_light = sample_light_dir(scene, k_light, p, time=time)
    d_new = jnp.where((pick_light & diffuse)[:, None], d_light, d_unit)

    pdf_cos = jnp.maximum(vec.dot(normal, d_new), 0.0) / PI
    pdf_l = light_pdf(scene, p, d_new, time=time)
    pdf_mix = 0.5 * pdf_cos + 0.5 * pdf_l
    w = jnp.where(pdf_mix > 1e-12, pdf_cos / jnp.maximum(pdf_mix, 1e-12),
                  0.0)
    return d_new, jnp.where(diffuse, w, 1.0)
