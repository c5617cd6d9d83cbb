"""Exact fixed-radius photon queries: a GPU kernel (Pallas, Triton route)
and its plain XLA reference.

Both return, for every query point, the reference kd-tree's
``within_radius`` sums (photon_mapper.rs:77-79,105): over every valid photon
within the point's radius, the count and the power weighted by
(1 - |n_ph . unit(delta)|); and the same within the point's cap radius.
Unlike the grid query (ops/photon_grid.py::query_grid) there is no per-cell
candidate cap and no 27-cell truncation. Counts are exact; flux is summed
in f32.

``query_photons_xla`` is the plain form: a loop over photon chunks up to
the last chunk that holds a valid photon, every point against every photon
of the chunk. It is the reference, and the path off the GPU.

``query_photons`` is the kernel. A program owns BLOCK query points. Photons
arrive cell-sorted (build_grid's order), so a CHUNK of consecutive photons
is spatially compact. XLA computes, for each block, which chunks lie within
the block's reach (block bounding box grown by its largest radius), packed
as bits, and the band [lo, hi) of chunks between the first and last one.
The program walks its band, skips chunks whose bit is clear, and runs the
pair math of a live chunk in (BLOCK, SUB) tiles. Off a GPU the kernel runs
only with ``interpret=True``, which the tests pass explicitly.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from raytracer.ops.photon_grid import QueryResult

BLOCK = 64        # query points per program
CHUNK = 1024      # photons per culled chunk
SUB = 64          # photons per pair tile inside a chunk
NUM_WARPS = 4
XLA_CHUNK = 1024  # photons per step of the XLA reference loop
BIG = 3.0e38


def _pair_sums(px, py, pz, r2, cap2, qx, qy, qz, pw, nm):
    """The eight within-radius sums of points (columns) against photons
    (rows): flux_r rgb, count_r, flux_cap rgb, count_cap."""
    dx, dy, dz = qx - px, qy - py, qz - pz
    d2 = dx * dx + dy * dy + dz * dz
    nd = nm[0] * dx + nm[1] * dy + nm[2] * dz
    s = 1.0 - jnp.abs(nd) * jax.lax.rsqrt(jnp.maximum(d2, 1e-20))
    in_r = d2 <= r2
    in_c = d2 <= cap2
    w_r = jnp.where(in_r, s, 0.0)
    w_c = jnp.where(in_c, s, 0.0)
    return (jnp.sum(w_r * pw[0], axis=1), jnp.sum(w_r * pw[1], axis=1),
            jnp.sum(w_r * pw[2], axis=1),
            jnp.sum(jnp.where(in_r, 1.0, 0.0), axis=1),
            jnp.sum(w_c * pw[0], axis=1), jnp.sum(w_c * pw[1], axis=1),
            jnp.sum(w_c * pw[2], axis=1),
            jnp.sum(jnp.where(in_c, 1.0, 0.0), axis=1))


def _result(sums, n):
    fr = jnp.stack(sums[0:3], -1)[:n]
    fc = jnp.stack(sums[4:7], -1)[:n]
    return QueryResult(flux_r=fr, count_r=sums[3][:n], flux_cap=fc,
                       count_cap=sums[7][:n])


def _radii(points, radius, cap_radius):
    n = points.shape[0]
    r = jnp.broadcast_to(jnp.asarray(radius, jnp.float32), (n,))
    cap = jnp.broadcast_to(jnp.asarray(cap_radius, jnp.float32), (n,))
    return r * r, cap * cap


def _photon_rows(pos, power, norm, valid, chunk: int):
    """(3, P) positions (invalid photons at BIG: never within a radius) and
    (6, P) power+normal rows, padded to a ``chunk`` multiple."""
    p = pos.shape[0]
    pad = max(chunk, -(-p // chunk) * chunk) - p
    posx = jnp.where(valid[:, None], pos.astype(jnp.float32), BIG)
    posx = jnp.pad(posx, [(0, pad), (0, 0)], constant_values=BIG)
    pay = jnp.concatenate([power, norm], 1).astype(jnp.float32)
    pay = jnp.pad(pay, [(0, pad), (0, 0)])
    return posx.T, pay.T


def query_photons_xla(pos, power, norm, valid, points, radius, cap_radius,
                      chunk: int = XLA_CHUNK) -> QueryResult:
    """Plain XLA exact query: every point against every photon chunk up to
    the last chunk holding a valid photon."""
    n = points.shape[0]
    r2, cap2 = _radii(points, radius, cap_radius)
    posx, pay = _photon_rows(pos, power, norm, valid, chunk)
    last = jnp.max(jnp.where(valid, jnp.arange(valid.shape[0]), -1))
    n_live = (last + chunk) // chunk               # chunks up to the last
    cols = [points[:, i:i + 1].astype(jnp.float32) for i in range(3)]

    def body(j, acc):
        q = jax.lax.dynamic_slice_in_dim(posx, j * chunk, chunk, 1)
        w = jax.lax.dynamic_slice_in_dim(pay, j * chunk, chunk, 1)
        sums = _pair_sums(*cols, r2[:, None], cap2[:, None],
                          q[0][None], q[1][None], q[2][None],
                          w[0:3, None], w[3:6, None])
        return tuple(a + b for a, b in zip(acc, sums))

    zero = tuple(jnp.zeros((n,), jnp.float32) for _ in range(8))
    return _result(jax.lax.fori_loop(0, n_live, body, zero), n)


def _query_kernel(band_ref, bits_ref, px_ref, py_ref, pz_ref, r2_ref,
                  cap2_ref, pos_ref, pay_ref, *out_refs, n_words: int):
    g = pl.program_id(0)
    px, py, pz, r2, cap2 = (ref[...][:, None] for ref in
                            (px_ref, py_ref, pz_ref, r2_ref, cap2_ref))

    def chunk(j, acc):
        word = bits_ref[g * n_words + j // 32]
        near = jnp.right_shift(word, j % 32) & 1

        def run(acc):
            def tile(s, acc):
                base = pl.multiple_of(j * CHUNK + s * SUB, SUB)
                q = [pos_ref[i, pl.ds(base, SUB)][None, :] for i in range(3)]
                w = [pay_ref[i, pl.ds(base, SUB)][None, :] for i in range(6)]
                sums = _pair_sums(px, py, pz, r2, cap2, *q, w[0:3], w[3:6])
                return tuple(a + b for a, b in zip(acc, sums))

            return jax.lax.fori_loop(0, CHUNK // SUB, tile, acc)

        return jax.lax.cond(near > 0, run, lambda a: a, acc)

    zero = tuple(jnp.zeros((BLOCK,), jnp.float32) for _ in range(8))
    acc = jax.lax.fori_loop(band_ref[2 * g], band_ref[2 * g + 1], chunk,
                            zero)
    for ref, a in zip(out_refs, acc):
        ref[...] = a


def query_photons(pos, power, norm, valid, points, radius, cap_radius, *,
                  interpret: bool = False) -> QueryResult:
    """Exact dual-radius query through the kernel (same result as
    query_photons_xla up to summation order). ``pos/power/norm`` (P, 3)
    photons with a (P,) validity mask; cell-sorted, valid-first order
    (build_grid's) keeps the bands short, any order is correct."""
    n = points.shape[0]
    r2, cap2 = _radii(points, radius, cap_radius)
    posx, pay = _photon_rows(pos, power, norm, valid, CHUNK)
    n_pad = -(-n // BLOCK) * BLOCK
    g_n = n_pad // BLOCK
    # padding points repeat the last point with negative radii: they match
    # nothing and leave the last block's bounding box unchanged
    pts = jnp.pad(points.astype(jnp.float32), [(0, n_pad - n), (0, 0)],
                  mode="edge")
    r2 = jnp.pad(r2, (0, n_pad - n), constant_values=-1.0)
    cap2 = jnp.pad(cap2, (0, n_pad - n), constant_values=-1.0)

    # per (block, chunk) reach test: block box + largest radius vs chunk box
    k = posx.shape[1] // CHUNK
    pc = posx.reshape(3, k, CHUNK)
    clo = jnp.min(pc, axis=2).T                                  # (K, 3)
    chi = jnp.max(jnp.where(pc < BIG, pc, -BIG), axis=2).T
    tp = pts.reshape(g_n, BLOCK, 3)
    reach2 = jnp.max(jnp.maximum(r2, cap2).reshape(g_n, BLOCK), axis=1)
    tlo, thi = tp.min(1), tp.max(1)                              # (G, 3)
    gap = jnp.maximum(jnp.maximum(clo[None] - thi[:, None],
                                  tlo[:, None] - chi[None]), 0.0)
    near = jnp.sum(gap * gap, axis=-1) <= reach2[:, None]        # (G, K)
    ks = jnp.arange(k, dtype=jnp.int32)
    lo = jnp.min(jnp.where(near, ks[None], k), axis=1)
    hi = jnp.max(jnp.where(near, ks[None] + 1, 0), axis=1)
    band = jnp.stack([jnp.minimum(lo, hi), hi], 1).reshape(-1)  # empty: [0,0)
    n_words = -(-k // 32)
    near = jnp.pad(near.astype(jnp.int32), [(0, 0), (0, n_words * 32 - k)])
    bits = jnp.sum(near.reshape(g_n, n_words, 32)
                   << jnp.arange(32, dtype=jnp.int32), axis=2,
                   dtype=jnp.int32).reshape(-1)

    row = pl.BlockSpec((BLOCK,), lambda i: (i,))
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,) * a.ndim)
    sums = pl.pallas_call(
        functools.partial(_query_kernel, n_words=n_words),
        grid=(g_n,),
        in_specs=[whole(band), whole(bits)] + [row] * 5
        + [whole(posx), whole(pay)],
        out_specs=[row] * 8,
        out_shape=[jax.ShapeDtypeStruct((n_pad,), jnp.float32)] * 8,
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        interpret=interpret,
        name="photon_query",
    )(band, bits, pts[:, 0], pts[:, 1], pts[:, 2], r2, cap2, posx, pay)
    return _result(sums, n)
