"""SPPM state checkpoint/resume (SURVEY.md §5.4 — the reference's SPPM state
is inherently checkpointable between iterations but never persisted; here it
is a first-class feature: ``--checkpoint`` + ``--resume`` on the CLI)."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np

from raytracer.models.sppm import SPPMHalf, SPPMState

FORMAT_VERSION = 1


def save_state(path: str, state: SPPMState, seed: int):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {
        "version": FORMAT_VERSION,
        "seed": seed,
        "iteration": np.asarray(state.iteration),
        "g_flux": np.asarray(state.glob.flux),
        "g_radius2": np.asarray(state.glob.radius2),
        "g_photons": np.asarray(state.glob.photons),
        "c_flux": np.asarray(state.caustic.flux),
        "c_radius2": np.asarray(state.caustic.radius2),
        "c_photons": np.asarray(state.caustic.photons),
    }
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz" if os.path.exists(tmp + ".npz") else tmp, path)


def load_state(path: str):
    """Returns (state, seed). Fails fast on version/shape mismatch."""
    with np.load(path) as z:
        if int(z["version"]) != FORMAT_VERSION:
            raise ValueError(f"checkpoint version {int(z['version'])} != "
                             f"{FORMAT_VERSION}")
        state = SPPMState(
            glob=SPPMHalf(jnp.asarray(z["g_flux"]), jnp.asarray(z["g_radius2"]),
                          jnp.asarray(z["g_photons"])),
            caustic=SPPMHalf(jnp.asarray(z["c_flux"]), jnp.asarray(z["c_radius2"]),
                             jnp.asarray(z["c_photons"])),
            iteration=jnp.asarray(z["iteration"]),
        )
        return state, int(z["seed"])
