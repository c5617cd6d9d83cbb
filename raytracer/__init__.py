"""raytracer — a JAX/XLA/Pallas rendering framework for NVIDIA GPUs.

A ground-up re-design of the capabilities of BlackCloud37/rust-raytracer
(a Rust CPU SPPM renderer) for accelerators:

- every entity (ray, hit, primitive, material, texture, light, photon) is a
  struct-of-arrays ``jnp`` table addressed by integer ids — no pointer graphs;
- all hot paths are batched, branch-free, and jit-compiled once per shape;
- parallelism is a ``jax.sharding.Mesh`` over pixel/sample axes driven by
  ``shard_map`` (the reference's thread pool over image rows becomes a device
  mesh over pixel tiles);
- randomness is counter-based (threefry) keyed by (pixel, sample, bounce) —
  fully deterministic and reproducible across shardings.

Reference parity map lives in SURVEY.md at the repo root; docstrings cite
`/root/reference` files as `file:line` for the behavior they match.
"""

__version__ = "0.1.0"

from raytracer.utils.config import RenderConfig, SPPMConfig  # noqa: F401
