"""Intersection strategy dispatch.

``method``:
- "pallas": the closest-hit kernel (ops/pallas_intersect.py), compiled for
  the GPU through Pallas' Triton route. It lowers for the GPU only;
- "xla": the XLA brute-force closest hit (ops/intersect.py). Off the GPU,
  and on the GPU wherever the kernel did not win, it is the default;
- "bruteforce": the same XLA closest hit, but on the fixed-depth AoS
  reference loops instead of the regenerating SoA wavefront;
- "bvh": flat-BVH traversal (AoS loops; needs ``scene.bvh``);
- "auto": "pallas" on a GPU (the kernel beat the XLA brute force end to
  end on every scene measured, PERF.md), else "bvh" when the scene carries
  a BVH, else "xla". The choice is made at trace time and baked into the
  jitted program.

"pallas" and "xla" run the SoA wavefront (models/wavefront_soa.py); the
integrators test membership in ``SOA_METHODS``.
"""

from __future__ import annotations

import jax

from raytracer.ops.intersect import Hit, intersect_bruteforce
from raytracer.scene.types import Scene

SOA_METHODS = ("pallas", "xla")


def _resolve(scene: Scene, method: str, has_time: bool = False) -> str:
    # Motion blur needs per-ray times; without them (a caller with no
    # shutter model) moving scenes take the AoS brute force, which tests
    # the t=0 centers. The BVH has no motion support.
    moving = bool(scene.spheres.motion_marker.shape[0])
    if moving and not has_time:
        return "bruteforce"
    if method != "auto":
        if moving and method == "bvh":
            return "xla"
        return method
    if jax.default_backend() == "gpu":
        return "pallas"
    if scene.bvh is not None and not moving:
        return "bvh"
    return "xla"


def intersect_scene(scene: Scene, o, d, t_min, t_max,
                    method: str = "auto", time=None, alive=None) -> Hit:
    """Closest hit by ``method``. ``alive`` (N,) bool marks lanes whose
    result the caller discards; the kernel skips their work."""
    method = _resolve(scene, method, has_time=time is not None)
    if method == "pallas":
        from raytracer.ops.pallas_intersect import intersect_pallas
        return intersect_pallas(scene, o, d, t_min, t_max, alive=alive,
                                time=time)
    if method == "bvh":
        if scene.bvh is None:
            raise ValueError("scene has no BVH; build it with ops.bvh.build_bvh")
        from raytracer.ops.bvh import intersect_bvh
        return intersect_bvh(scene, o, d, t_min, t_max)
    return intersect_bruteforce(scene, o, d, t_min, t_max, time=time)


def intersect_and_attrs(scene: Scene, o, d, t_min, t_max,
                        method: str = "auto", time=None, alive=None):
    """Closest hit + HitRecord attributes. Returns (hit, attrs)."""
    from raytracer.ops.intersect import hit_attributes
    hit = intersect_scene(scene, o, d, t_min, t_max, method, time=time,
                          alive=alive)
    return hit, hit_attributes(scene, o, d, hit, time=time)
