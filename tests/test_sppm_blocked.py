"""Blocked SPPM iteration must match the monolithic one (same keys) up to
the per-block measurement RNG; with one block covering everything and the
same key derivation they should be statistically equivalent and touch the
same structure."""

import numpy as np
import pytest

from raytracer.models import sppm
from raytracer.scene.builtin import cornell_box


KW = dict(width=24, height=24, n_photons=6000, max_photon_bounces=6,
          max_camera_bounces=8, grid_res=(8, 8, 8), k_per_cell=32,
          alpha=0.7, k_global=100.0, k_caustic=50.0, t_min=1e-3,
          photon_t_min=1e-4, spawn_eps_rel=1e-4, intersector="auto",
          query_chunk=128)


@pytest.mark.slow
def test_blocked_matches_monolithic_shapewise(key):
    scene = cornell_box(with_mesh=False)
    npix = 24 * 24
    s0 = sppm.init_state(npix)
    mono = sppm.sppm_iteration(scene, s0, key, **KW)
    blk = sppm.sppm_iteration_blocked(scene, s0, key, pixel_block=200, **KW)
    assert int(blk.iteration) == 1
    for a, b in ((mono.glob, blk.glob), (mono.caustic, blk.caustic)):
        assert np.asarray(b.flux).shape == np.asarray(a.flux).shape
        # same photon map + same grid -> touched-pixel structure similar
        ta = np.asarray(a.photons) > 0
        tb = np.asarray(b.photons) > 0
        assert abs(ta.mean() - tb.mean()) < 0.1
    assert np.isfinite(np.asarray(blk.glob.flux)).all()


@pytest.mark.slow
def test_blocked_nondivisible_tail(key):
    scene = cornell_box(with_mesh=False)
    npix = 24 * 24  # 576; block 500 leaves a 76-pixel tail
    s0 = sppm.init_state(npix)
    blk = sppm.sppm_iteration_blocked(scene, s0, key, pixel_block=500, **KW)
    g = np.asarray(blk.glob.photons)
    assert g.shape == (npix,)
    assert np.isfinite(np.asarray(blk.glob.flux)).all()
    assert (g > 0).mean() > 0.2
