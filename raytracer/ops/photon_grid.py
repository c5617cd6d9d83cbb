"""Uniform-grid photon map — the batched replacement for the reference's kd-tree
(photon_mapper.rs:268-275 builds two `kd_tree::KdTree`s per iteration;
queries at photon_mapper.rs:85,105).

Design: photons are binned into a dense axis-aligned grid over the scene
bounds, sorted by linearized cell id, and cell extents are recovered with
one searchsorted. A fixed-radius query gathers up to K candidates from each
of the 27 neighbor cells (static shapes; masked) — valid because query radii
are capped at one cell size, and SPPM radii only *shrink* from their init.

Both query kinds the reference needs are served from one gather:
- ``estimate_flux_within_radius`` (photon_mapper.rs:102-114): flux and count
  within the pixel's current radius;
- the kNN radius *init* (``estimate_flux_by_count``, photon_mapper.rs:82-99)
  is replaced by a density-based init: count m within the cap radius h gives
  r0^2 = h^2 * k/m (expected-count-k radius under local uniform density),
  flux0 = flux_h * min(1, k/m). The SPPM alpha-recursion washes init
  differences out over iterations.

Photon payload: position, power, surface normal. The reference also stores
the incident direction and passes it to ``bsdf`` (photon_mapper.rs:95) — but
every material's bsdf ignores it (material.rs:106,127,158,202), so it is not
stored. The disk factor |n_ph . unit(p_ph - p)| (photon_mapper.rs:77-79)
weights each photon by 1 - disk_factor.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from raytracer.ops import vec


class PhotonGrid(NamedTuple):
    pos: jnp.ndarray         # (P, 3) sorted by cell id
    power: jnp.ndarray       # (P, 3)
    norm: jnp.ndarray        # (P, 3)
    cell_start: jnp.ndarray  # (C+1,) int32 prefix offsets
    bmin: jnp.ndarray        # (3,)
    inv_cell: jnp.ndarray    # (3,)
    n_valid: jnp.ndarray     # () int32


def _cell_ids(pos, bmin, inv_cell, res: Tuple[int, int, int]):
    ci = jnp.floor((pos - bmin) * inv_cell).astype(jnp.int32)
    ci = jnp.clip(ci, 0, jnp.asarray(res, jnp.int32) - 1)
    return (ci[..., 0] * res[1] + ci[..., 1]) * res[2] + ci[..., 2], ci


def build_grid(pos, power, norm, valid, bmin, bmax,
               res: Tuple[int, int, int], compact: bool = False,
               max_valid: int = None) -> PhotonGrid:
    """Sort photons by cell. Invalid photons sort past the end (sentinel).

    ``compact`` stores power/norm as bf16 (queries are HBM-bound on the
    gathered candidate payloads; positions stay f32 for the distance test —
    the ~0.4% flux error is far below Monte-Carlo noise).

    ``max_valid``: a STATIC upper bound on the valid count, when the caller
    can prove one (e.g. caustic deposits are <= one per photon path,
    photon_mapper.rs:249-251 — first-diffuse-after-specular-prefix). The
    sorted-array gathers and the grid payload then shrink from the full
    deposit-slot count to the bound; since every valid photon sorts before
    the sentinel tail, truncation at >= n_valid is exact."""
    n_cells = res[0] * res[1] * res[2]
    extent = jnp.maximum(bmax - bmin, 1e-6)
    inv_cell = jnp.asarray(res, jnp.float32) / extent
    cid, _ = _cell_ids(pos, bmin, inv_cell, res)
    cid = jnp.where(valid, cid, n_cells)  # sentinel: past last cell
    order = jnp.argsort(cid)
    if max_valid is not None and max_valid < order.shape[0]:
        order = order[:max_valid]
    cid_sorted = cid[order]
    cell_start = jnp.searchsorted(cid_sorted, jnp.arange(n_cells + 1),
                                  method="scan_unrolled").astype(jnp.int32)
    payload = jnp.bfloat16 if compact else jnp.float32
    return PhotonGrid(
        pos=pos[order], power=power[order].astype(payload),
        norm=norm[order].astype(payload),
        cell_start=cell_start, bmin=bmin, inv_cell=inv_cell,
        n_valid=jnp.sum(valid).astype(jnp.int32))


class QueryResult(NamedTuple):
    flux_r: jnp.ndarray    # (N, 3) sum of power*(1-disk) within radius r
    count_r: jnp.ndarray   # (N,)
    flux_cap: jnp.ndarray  # (N, 3) same within the cap radius h
    count_cap: jnp.ndarray  # (N,)


def query_grid(grid: PhotonGrid, res: Tuple[int, int, int], points, radius,
               cap_radius, k_per_cell: int) -> QueryResult:
    """Dual fixed-radius gather around each point (27 cells, K-capped).

    ``radius`` is per-point (clamped by the caller to <= cap_radius, which
    must be <= one cell extent). Returns sums for both the per-point radius
    and the cap radius in a single pass.
    """
    n = points.shape[0]
    n_cells = res[0] * res[1] * res[2]
    p_total = grid.pos.shape[0]
    _, ci = _cell_ids(points, grid.bmin, grid.inv_cell, res)
    r2 = radius * radius
    # cap_radius may be scalar or per-point (the callers tighten it to the
    # pixel's own radius once initialized)
    cap2 = jnp.broadcast_to(jnp.asarray(cap_radius, jnp.float32),
                            (n,)) ** 2
    res_arr = jnp.asarray(res, jnp.int32)

    # All 27 neighbor offsets in one fused pass (a python loop over offsets
    # compiles to thousands of tiny serialized kernels — launch-bound).
    offs = jnp.asarray([(dx, dy, dz)
                        for dx in (-1, 0, 1)
                        for dy in (-1, 0, 1)
                        for dz in (-1, 0, 1)], jnp.int32)        # (27, 3)
    cc = ci[:, None, :] + offs[None]                             # (N, 27, 3)
    in_grid = jnp.all((cc >= 0) & (cc < res_arr), axis=-1)       # (N, 27)
    cid = (cc[..., 0] * res[1] + cc[..., 1]) * res[2] + cc[..., 2]
    cid = jnp.clip(cid, 0, n_cells - 1)
    start = grid.cell_start[cid]                                 # (N, 27)
    end = grid.cell_start[cid + 1]
    k_ar = jnp.arange(k_per_cell, dtype=jnp.int32)
    idx = (start[..., None] + k_ar[None, None]).reshape(n, -1)   # (N, 27K)
    m = ((start[..., None] + k_ar[None, None])
         < end[..., None]) & in_grid[..., None]                  # (N,27,K)
    m = m.reshape(n, -1)
    # masked lanes fetch row 0 (single hot line instead of junk rows)
    idx = jnp.where(m, jnp.clip(idx, 0, max(p_total - 1, 0)), 0)

    ppos = grid.pos[idx]                                         # (N, 27K, 3)
    ppow = grid.power[idx].astype(jnp.float32)
    pnrm = grid.norm[idx].astype(jnp.float32)
    delta = ppos - points[:, None, :]
    d2 = jnp.sum(delta * delta, axis=-1)
    disk = jnp.abs(jnp.sum(pnrm * vec.unit(delta), axis=-1))
    w = (1.0 - disk)[..., None] * ppow                           # (N, 27K, 3)
    in_r = m & (d2 <= r2[:, None])
    in_cap = m & (d2 <= cap2[:, None])
    flux_r = jnp.sum(jnp.where(in_r[..., None], w, 0.0), axis=1)
    cnt_r = jnp.sum(in_r, axis=1).astype(jnp.float32)
    flux_cap = jnp.sum(jnp.where(in_cap[..., None], w, 0.0), axis=1)
    cnt_cap = jnp.sum(in_cap, axis=1).astype(jnp.float32)
    return QueryResult(flux_r, cnt_r, flux_cap, cnt_cap)


def query_grid_chunked(grid: PhotonGrid, res, points, radius, cap_radius,
                       k_per_cell: int, chunk: int = 2048) -> QueryResult:
    """lax.map over point chunks to bound the (chunk, 27*K) gather memory."""
    n = points.shape[0]
    n_pad = -(-n // chunk) * chunk
    pad = n_pad - n

    def pad0(x, fill=0.0):
        return jnp.pad(x, [(0, pad)] + [(0, 0)] * (x.ndim - 1),
                       constant_values=fill)

    pts = pad0(points).reshape(n_pad // chunk, chunk, 3)
    rad = pad0(radius).reshape(n_pad // chunk, chunk)
    cap = pad0(jnp.broadcast_to(
        jnp.asarray(cap_radius, jnp.float32), (n,))).reshape(
        n_pad // chunk, chunk)

    def one(args):
        p, r, c = args
        return query_grid(grid, res, p, r, c, k_per_cell)

    out = jax.lax.map(one, (pts, rad, cap))
    return QueryResult(*[x.reshape((n_pad,) + x.shape[2:])[:n] for x in out])


def choose_grid_resolution(bounds_min, bounds_max, n_photons: int,
                           k_nearest: int, max_res: int = 64):
    """Host-side heuristic: cell size ~ the expected kNN init radius
    r0 = sqrt(k * A / (pi * P)) with A ~ the bbox surface area. Static per
    render (shapes under jit depend on it)."""
    import numpy as np
    bmin = np.asarray(bounds_min, np.float64)
    bmax = np.asarray(bounds_max, np.float64)
    ext = np.maximum(bmax - bmin, 1e-6)
    area = 2.0 * (ext[0] * ext[1] + ext[1] * ext[2] + ext[0] * ext[2])
    r0 = float(np.sqrt(max(k_nearest, 1) * area / (np.pi * max(n_photons, 1))))
    res = tuple(int(np.clip(np.ceil(e / max(r0, 1e-6)), 2, max_res))
                for e in ext)
    return res, r0
