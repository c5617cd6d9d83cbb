"""Device-resident scene representation: flat struct-of-arrays tables.

The reference's scene is an ``Arc<dyn Hitable>`` object graph (world.rs:8-12)
with virtual dispatch per node. The device equivalent is a pytree of flat
arrays: primitives are type-segregated tables addressed by integer ids,
materials/textures/lights are parallel tables, and the camera is a small
parameter record. The whole Scene is immutable and lives on device; under
``jit`` it traces once per shape.

Kind/type codes are module constants (the reference's enums — Interaction,
material types, texture types — become small ints selected with jnp.where).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import jax.numpy as jnp

# Material kinds (material.rs concrete impls)
MAT_LAMBERTIAN = 0     # material.rs:89-113
MAT_METAL = 1          # material.rs:115-139
MAT_DIELECTRIC = 2     # material.rs:141-188
MAT_DIFFUSE_LIGHT = 3  # material.rs:191-212 (emits AND scatters diffusely)
MAT_ISOTROPIC = 4      # material.rs:213-231 (commented out in ref; capability)

# Texture kinds (material.rs:48-84; NOISE is a driver-requested extension —
# the reference has no Perlin, SURVEY.md §8)
TEX_CONSTANT = 0
TEX_CHECKER = 1
TEX_IMAGE = 2
TEX_NOISE = 3

# Light kinds (light.rs)
LIGHT_SPHERE = 0       # SphereDiffuseLight light.rs:67-125
LIGHT_XZRECT = 1       # XZRectLight light.rs:127-184

# Primitive type codes (for the unified hit record / BVH leaves)
PRIM_SPHERE = 0
PRIM_RECT = 1
PRIM_TRIANGLE = 2
PRIM_MEDIA = 3         # SoA winner override: medium scatter event
                       # (medium.rs:26-53 via ops/media.apply_media_soa)

# Interaction codes (material.rs:10-16)
INTER_DIFFUSE = 0
INTER_SPECULAR = 1
INTER_ABSORB = 2
INTER_REFLECT = 3
INTER_REFRACT = 4


class Textures(NamedTuple):
    """Texture table. kind selects constant/checker/image (material.rs:48-84).

    - constant: color0
    - checker:  sign of sin(10x)sin(10y)sin(10z) picks color0 (<0) else color1
                (material.rs:58-68 — world-space, not UV)
    - image:    nearest-texel fetch from ``images[image_id]`` with clamped UV
                and v-flip (material.rs:70-84)
    """
    kind: jnp.ndarray      # (T,) int32
    color0: jnp.ndarray    # (T, 3)  (noise textures pack their scale in [.,0])
    color1: jnp.ndarray    # (T, 3)
    image_id: jnp.ndarray  # (T,) int32 (-1 if none)
    # static shape-flag: (1,) if any noise texture exists else (0,) — lets
    # jitted texture eval skip the Perlin octaves entirely when unused
    noise_marker: jnp.ndarray = jnp.zeros((0,), jnp.int32)


class Materials(NamedTuple):
    """Material table (material.rs:21-212). ``tex_id`` is the albedo texture
    for lambertian/metal/dielectric and the *emit* texture for diffuse
    lights (whose bsdf is the constant 1/pi, material.rs:202-204)."""
    kind: jnp.ndarray    # (M,) int32
    tex_id: jnp.ndarray  # (M,) int32
    fuzz: jnp.ndarray    # (M,) metal fuzz radius
    ir: jnp.ndarray      # (M,) dielectric refraction index


class Spheres(NamedTuple):
    """Sphere table (sphere.rs:8-12). ``velocity`` supports motion blur
    (driver-config extension; the reference's Ray has no time, ray.rs:3-6):
    center(t) = center + velocity * t over the camera shutter [0, 1].
    ``motion_marker`` is a static shape-flag: (1,) if any sphere moves."""
    center: jnp.ndarray  # (S, 3)
    radius: jnp.ndarray  # (S,)
    mat_id: jnp.ndarray  # (S,) int32
    velocity: jnp.ndarray = jnp.zeros((0, 3), jnp.float32)  # (S, 3) or (0,3)
    motion_marker: jnp.ndarray = jnp.zeros((0,), jnp.int32)


class Rects(NamedTuple):
    """Axis-aligned rectangle table — the reference's three rect types
    (rectangle.rs XY/XZ/YZ) collapse into one record parameterized by the
    plane-normal axis. In-plane axes (a, b) are the two non-normal axes in
    ascending order, matching the reference's UV convention
    (rectangle.rs:32,70,107)."""
    axis: jnp.ndarray    # (R,) int32: 0 => x=k (YZ), 1 => y=k (XZ), 2 => z=k (XY)
    k: jnp.ndarray       # (R,) plane offset
    a0: jnp.ndarray      # (R,) lower bound, first in-plane axis
    a1: jnp.ndarray      # (R,)
    b0: jnp.ndarray      # (R,) lower bound, second in-plane axis
    b1: jnp.ndarray      # (R,)
    mat_id: jnp.ndarray  # (R,) int32


class Triangles(NamedTuple):
    """Triangle soup with precomputed edges (mesh.rs:56-137 Möller–Trumbore
    operates on v0, e1 = v1-v0, e2 = v2-v0). Vertex normals are pre-gathered
    per-triangle for interpolation (mesh.rs:104); transforms are baked at
    scene-compile time (transform.rs semantics, scenes are static)."""
    v0: jnp.ndarray      # (T, 3)
    e1: jnp.ndarray      # (T, 3)
    e2: jnp.ndarray      # (T, 3)
    n0: jnp.ndarray      # (T, 3)
    n1: jnp.ndarray      # (T, 3)
    n2: jnp.ndarray      # (T, 3)
    mat_id: jnp.ndarray  # (T,) int32


class Lights(NamedTuple):
    """Emitter table (light.rs:61-235). Geometry lives in the primitive
    tables too (lights are hitable, scene.rs:86); this table drives photon
    emission and NEE. ``prob`` is the power-proportional pick distribution
    (AllLights::new, light.rs:202-216)."""
    kind: jnp.ndarray    # (L,) int32
    # sphere light: p0 = center, r0 = radius
    # xzrect light: p0 = (x0, y, z0), p1 = (x1, y, z1)
    p0: jnp.ndarray      # (L, 3)
    p1: jnp.ndarray      # (L, 3)
    r0: jnp.ndarray      # (L,)
    flux: jnp.ndarray    # (L, 3)
    scale: jnp.ndarray   # (L,)
    prob: jnp.ndarray    # (L,)
    log_prob: jnp.ndarray  # (L,) log(prob) for jax.random.categorical
    # motion extension: a moving emitter's center is p0 + vel*t; NEE shadow
    # samples evaluate the light at the shading ray's shutter time (the
    # sphere GEOMETRY moves in the primitive table, so a static record
    # would sample the t=0 position)
    vel: jnp.ndarray     # (L, 3)


class Camera(NamedTuple):
    """Thin-lens camera, precomputed like camera.rs:24-55."""
    origin: jnp.ndarray            # (3,)
    lower_left_corner: jnp.ndarray  # (3,)
    horizontal: jnp.ndarray        # (3,)
    vertical: jnp.ndarray          # (3,)
    u: jnp.ndarray                 # (3,)
    v: jnp.ndarray                 # (3,)
    w: jnp.ndarray                 # (3,)
    lens_radius: jnp.ndarray       # () scalar
    # shutter window for motion blur (extension; 0 = instantaneous)
    time0: jnp.ndarray = jnp.float32(0.0)
    time1: jnp.ndarray = jnp.float32(0.0)


class BVH(NamedTuple):
    """Flat BVH over the unified primitive list (replaces bvh.rs:29-106's
    ``Arc`` tree). Interior node i covers [node_min[i], node_max[i]] with
    children left[i]/right[i]; leaves store a contiguous primitive range in
    the reordered (prim_type, prim_idx) arrays."""
    node_min: jnp.ndarray    # (N, 3)
    node_max: jnp.ndarray    # (N, 3)
    left: jnp.ndarray        # (N,) int32 child or first-prim offset (leaf)
    right: jnp.ndarray       # (N,) int32 child or prim count (leaf)
    is_leaf: jnp.ndarray     # (N,) bool
    prim_type: jnp.ndarray   # (P,) int32 reordered primitive types
    prim_idx: jnp.ndarray    # (P,) int32 reordered per-type indices


class Scene(NamedTuple):
    """The world: all tables + camera + bounds. One immutable pytree."""
    spheres: Spheres
    rects: Rects
    triangles: Triangles
    materials: Materials
    textures: Textures
    images: jnp.ndarray        # (I, IH, IW, 3) f32 atlas (I may be 0)
    image_wh: jnp.ndarray      # (I, 2) int32 true (w, h) per image
    lights: Lights
    camera: Camera
    bounds_min: jnp.ndarray    # (3,) scene AABB (for photon grids, eps scale)
    bounds_max: jnp.ndarray    # (3,)
    bvh: Optional[BVH] = None
    media: Optional["Media"] = None  # constant-density volumes (ops/media.py)

    @property
    def n_primitives(self):
        return (self.spheres.radius.shape[0] + self.rects.k.shape[0]
                + self.triangles.mat_id.shape[0])

    @property
    def scale(self):
        """Characteristic scene scale (diagonal length) for f32 epsilons."""
        return jnp.sqrt(jnp.sum((self.bounds_max - self.bounds_min) ** 2))
