"""Branch-free batched texture evaluation and material scatter.

The reference dispatches virtually on ``Arc<dyn Material>`` per ray
(material.rs:21-46). Here all four material models are evaluated for the
whole batch and the result is selected by material-kind code — branch-free
lanes instead of divergent per-ray dispatch.

Semantics matched (material.rs):
- Lambertian: dir = n + random_unit_vector (near-zero guard), attenuation =
  albedo texture, Interaction::Diffuse              material.rs:92-113
- Metal: dir = reflect(unit(d), n) + fuzz*unit_sphere; absorb when the
  scattered dir leaves below the surface             material.rs:115-139
- Dielectric: Schlick reflectance, TIR, stochastic reflect/refract choice,
  attenuation = albedo tint                          material.rs:141-188
- DiffuseLight: emits its texture AND scatters diffusely with bsdf 1/pi —
  the reference's unusual double behavior            material.rs:191-212
- Isotropic (volumes): uniform-sphere scatter        material.rs:213-231
- scatter_photon: Russian roulette with survival max(f) and power
  renormalization power * f / max(f)                 material.rs:27-45
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from raytracer.ops import sampling, vec
from raytracer.ops.intersect import HitAttrs
from raytracer.scene.types import (
    INTER_ABSORB, INTER_DIFFUSE, INTER_REFLECT, INTER_REFRACT, INTER_SPECULAR,
    MAT_DIELECTRIC, MAT_DIFFUSE_LIGHT, MAT_ISOTROPIC, MAT_LAMBERTIAN, MAT_METAL,
    TEX_CHECKER, TEX_IMAGE, TEX_NOISE, Scene,
)

FRAC_1_PI = 0.3183098861837907


class Scatter(NamedTuple):
    interaction: jnp.ndarray  # (N,) int32 Interaction code
    direction: jnp.ndarray    # (N, 3) next ray dir (unnormalized, like ref)
    attenuation: jnp.ndarray  # (N, 3) the reference's Some(f) value
    emitted: jnp.ndarray      # (N, 3) Le at this hit


class MatFeatures(NamedTuple):
    """Per-lane material+texture record, fetched in ONE one-hot matmul
    (`onehot(mat_id) @ features`; on the GPU a plain gather may be faster —
    not measured, ROADMAP perf_opt candidates). Texture fields are
    denormalized through tex_id at trace time (tables are tiny)."""
    kind: jnp.ndarray       # (N,) int32
    fuzz: jnp.ndarray       # (N,)
    ir: jnp.ndarray         # (N,)
    tex_kind: jnp.ndarray   # (N,) int32
    color0: jnp.ndarray     # (N, 3)
    color1: jnp.ndarray     # (N, 3)
    image_id: jnp.ndarray   # (N,) int32
    tex_id: jnp.ndarray     # (N,) int32


MAT_ONEHOT_MAX = 128  # beyond this the (N,M) one-hot outweighs the gathers


def fetch_mat_features(scene: Scene, mat_id) -> MatFeatures:
    m = scene.materials
    t = scene.textures
    n_mat = m.kind.shape[0]
    if n_mat == 0 or n_mat > MAT_ONEHOT_MAX:
        tex_id = m.tex_id[mat_id]
        return MatFeatures(m.kind[mat_id], m.fuzz[mat_id], m.ir[mat_id],
                           t.kind[tex_id], t.color0[tex_id], t.color1[tex_id],
                           t.image_id[tex_id], tex_id)
    # denormalize texture columns into the material rows (M is tiny)
    tex_of_mat = m.tex_id
    feats = jnp.concatenate([
        m.kind[:, None].astype(jnp.float32),
        m.fuzz[:, None], m.ir[:, None],
        t.kind[tex_of_mat][:, None].astype(jnp.float32),
        t.color0[tex_of_mat], t.color1[tex_of_mat],
        t.image_id[tex_of_mat][:, None].astype(jnp.float32),
        tex_of_mat[:, None].astype(jnp.float32),
    ], axis=1)                                             # (M, 12)
    onehot = (mat_id[:, None] == jnp.arange(n_mat, dtype=mat_id.dtype)[None]
              ).astype(jnp.float32)                        # (N, M)
    out = jnp.matmul(onehot, feats, precision=jax.lax.Precision.HIGHEST)
    return MatFeatures(
        kind=out[:, 0].astype(jnp.int32), fuzz=out[:, 1], ir=out[:, 2],
        tex_kind=out[:, 3].astype(jnp.int32), color0=out[:, 4:7],
        color1=out[:, 7:10], image_id=out[:, 10].astype(jnp.int32),
        tex_id=out[:, 11].astype(jnp.int32))


def eval_texture_from(scene: Scene, f: MatFeatures, p, uv):
    """Texture fetch from prefetched features (material.rs:48-84)."""
    sines = (jnp.sin(10.0 * p[..., 0]) * jnp.sin(10.0 * p[..., 1])
             * jnp.sin(10.0 * p[..., 2]))
    checker = jnp.where((sines < 0.0)[..., None], f.color0, f.color1)
    out = jnp.where((f.tex_kind == TEX_CHECKER)[..., None], checker, f.color0)
    if scene.images.shape[0]:
        img_id = jnp.maximum(f.image_id, 0)
        wh = scene.image_wh[img_id]
        w = wh[..., 0].astype(p.dtype)
        h = wh[..., 1].astype(p.dtype)
        u = jnp.clip(uv[..., 0], 0.0, 1.0)
        v = 1.0 - jnp.clip(uv[..., 1], 0.0, 1.0)
        x = jnp.clip(jnp.floor(w * u).astype(jnp.int32), 0, wh[..., 0] - 1)
        y = jnp.clip(jnp.floor(h * v).astype(jnp.int32), 0, wh[..., 1] - 1)
        img_color = scene.images[img_id, y, x]
        out = jnp.where((f.tex_kind == TEX_IMAGE)[..., None], img_color, out)
    if scene.textures.noise_marker.shape[0]:
        from raytracer.ops import noise as noise_ops
        marble = (noise_ops.marble(p, f.color0[..., 0])[..., None]
                  * jnp.ones_like(out))
        out = jnp.where((f.tex_kind == TEX_NOISE)[..., None], marble, out)
    return out


def eval_texture(scene: Scene, tex_id, p, uv):
    """Texture fetch by id (material.rs:48-84)."""
    tex = scene.textures
    kind = tex.kind[tex_id]
    c0 = tex.color0[tex_id]
    c1 = tex.color1[tex_id]
    # Checker: sign of sin(10x)sin(10y)sin(10z), world-space. material.rs:58-68
    sines = (jnp.sin(10.0 * p[..., 0]) * jnp.sin(10.0 * p[..., 1])
             * jnp.sin(10.0 * p[..., 2]))
    checker = jnp.where((sines < 0.0)[..., None], c0, c1)
    out = jnp.where((kind == TEX_CHECKER)[..., None], checker, c0)
    if tex.noise_marker.shape[0]:
        # Perlin marble (driver extension; scale packed in color0[...,0])
        from raytracer.ops import noise as noise_ops
        scale = tex.color0[tex_id][..., 0]
        marble = noise_ops.marble(p, scale)[..., None] * jnp.ones_like(out)
        out = jnp.where((kind == TEX_NOISE)[..., None], marble, out)
    if scene.images.shape[0]:
        # Nearest-texel fetch, clamped UV, v-flip. material.rs:70-84
        img_id = jnp.maximum(tex.image_id[tex_id], 0)
        wh = scene.image_wh[img_id]
        w = wh[..., 0].astype(p.dtype)
        h = wh[..., 1].astype(p.dtype)
        u = jnp.clip(uv[..., 0], 0.0, 1.0)
        v = 1.0 - jnp.clip(uv[..., 1], 0.0, 1.0)
        x = jnp.clip(jnp.floor(w * u).astype(jnp.int32), 0, wh[..., 0] - 1)
        y = jnp.clip(jnp.floor(h * v).astype(jnp.int32), 0, wh[..., 1] - 1)
        img_color = scene.images[img_id, y, x]
        out = jnp.where((kind == TEX_IMAGE)[..., None], img_color, out)
    return out


def bsdf(scene: Scene, mat_id, p, uv):
    """The reference's Material::bsdf: albedo texture for surface materials,
    the constant 1/pi for diffuse lights (material.rs:106,127,158,202)."""
    if scene.materials.kind.shape[0] == 0:
        return jnp.zeros(p.shape[:-1] + (3,), p.dtype)
    f = fetch_mat_features(scene, mat_id)
    albedo = eval_texture_from(scene, f, p, uv)
    is_light = f.kind == MAT_DIFFUSE_LIGHT
    return jnp.where(is_light[..., None], FRAC_1_PI, albedo)


def emitted(scene: Scene, attrs: HitAttrs):
    """Le: diffuse lights return their emit texture, others 0
    (material.rs:24-26,209-211)."""
    m = scene.materials
    if m.kind.shape[0] == 0:
        return jnp.zeros_like(attrs.p)
    e = eval_texture(scene, m.tex_id[attrs.mat_id], attrs.p, attrs.uv)
    is_light = m.kind[attrs.mat_id] == MAT_DIFFUSE_LIGHT
    return jnp.where((is_light & attrs.valid)[..., None], e, 0.0)


def _uni3(rng, n):
    """PRNG key -> one batched (3, n) uniform draw; prepared (>=3, n) rows
    pass through (models/wavefront_soa.py row layout U_SPH1/U_SPH2/U_DIEL).
    Material kinds are exclusive per lane, so the single unit-sphere pair
    (rows 0-1) serves the diffuse, metal-fuzz, AND isotropic draws."""
    if hasattr(rng, "dtype") and rng.dtype == jnp.float32:
        return rng
    return jax.random.uniform(rng, (3, n))


def scatter(scene: Scene, rng, d_in, attrs: HitAttrs) -> Scatter:
    """Batched Material::scatter over all kinds with where-select.
    ``rng``: PRNG key or prepared (>=3, n) uniform rows."""
    m = scene.materials
    if m.kind.shape[0] == 0:  # empty scene: every lane absorbs (static)
        n = d_in.shape[0]
        return Scatter(jnp.full((n,), INTER_ABSORB, jnp.int32), d_in,
                       jnp.zeros((n, 3), d_in.dtype), jnp.zeros((n, 3), d_in.dtype))
    f = fetch_mat_features(scene, attrs.mat_id)
    kind = f.kind
    normal = attrs.normal
    n = d_in.shape[0]
    uni = _uni3(rng, n)
    sph = sampling.uniform_sphere_from(uni[0], uni[1])

    albedo = eval_texture_from(scene, f, attrs.p, attrs.uv)

    # Lambertian / DiffuseLight scatter dir (material.rs:92-98)
    diff_dir = normal + sph
    diff_dir = jnp.where(vec.near_zero(diff_dir)[..., None],
                         normal, diff_dir)

    # Metal (material.rs:130-138)
    unit_d = vec.unit(d_in)
    refl = vec.reflect(unit_d, normal)
    metal_dir = refl + f.fuzz[:, None] * sph
    metal_ok = vec.dot(metal_dir, normal) > 0.0

    # Dielectric (material.rs:161-187)
    ir = jnp.maximum(f.ir, 1e-6)
    ratio = jnp.where(attrs.front_face, 1.0 / ir, ir)
    cos_theta = jnp.minimum(vec.dot(-unit_d, normal), 1.0)
    sin_theta = jnp.sqrt(jnp.maximum(0.0, 1.0 - cos_theta * cos_theta))
    cannot_refract = ratio * sin_theta > 1.0
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    reflectance = r0 + (1.0 - r0) * (1.0 - cos_theta) ** 5    # material.rs:150-154
    do_reflect = cannot_refract | (reflectance > uni[2])
    diel_dir = jnp.where(do_reflect[:, None],
                         refl, vec.refract(unit_d, normal, ratio))

    # Isotropic (volume phase function; shares the sphere pair — kinds
    # are exclusive per lane)
    iso_dir = sph

    is_lam = kind == MAT_LAMBERTIAN
    is_metal = kind == MAT_METAL
    is_diel = kind == MAT_DIELECTRIC
    is_light = kind == MAT_DIFFUSE_LIGHT
    is_iso = kind == MAT_ISOTROPIC

    direction = jnp.where((is_lam | is_light)[:, None], diff_dir,
                jnp.where(is_metal[:, None], metal_dir,
                jnp.where(is_diel[:, None], diel_dir, iso_dir)))

    attenuation = jnp.where(is_light[:, None],
                            jnp.full_like(albedo, FRAC_1_PI), albedo)

    interaction = jnp.where(is_lam | is_light | is_iso, INTER_DIFFUSE,
                  jnp.where(is_metal,
                            jnp.where(metal_ok, INTER_SPECULAR, INTER_ABSORB),
                  jnp.where(do_reflect, INTER_REFLECT, INTER_REFRACT)))
    interaction = jnp.where(attrs.valid, interaction, INTER_ABSORB).astype(jnp.int32)

    le = jnp.where((is_light & attrs.valid)[:, None], albedo, 0.0)

    return Scatter(interaction, direction, attenuation, le)


def scatter_photon(scene: Scene, rng, d_in, attrs: HitAttrs, power):
    """Photon bounce with Russian roulette (material.rs:27-45): survival
    probability h = max(f); surviving photons carry power * f / h.
    ``rng``: PRNG key or prepared (>=4, n) uniform rows (row 3 = RR)."""
    if hasattr(rng, "dtype") and rng.dtype == jnp.float32:
        uni = rng
    else:
        uni = jax.random.uniform(rng, (4, d_in.shape[0]))
    s = scatter(scene, uni[:3], d_in, attrs)
    h = jnp.max(s.attenuation, axis=-1)
    survive = uni[3] <= h
    interaction = jnp.where(survive, s.interaction, INTER_ABSORB)
    new_power = power * s.attenuation / jnp.maximum(h, 1e-12)[:, None]
    new_power = jnp.where(survive[:, None], new_power, power)
    return Scatter(interaction, s.direction, s.attenuation, s.emitted), new_power
