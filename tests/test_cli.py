"""CLI driver tests (subprocess-free: call main() in-process on tiny sizes)."""

import os

import numpy as np
import pytest

from raytracer.cli import main


@pytest.mark.slow
def test_render_pt_builtin(tmp_path):
    out = str(tmp_path / "pt.png")
    rc = main(["render", "--jax-cache", str(tmp_path / "jc"),
               "--scene", "spheres", "--integrator", "pt",
               "--width", "24", "--height", "24", "--spp", "4",
               "--max-depth", "4", "--out", out])
    assert rc == 0 and os.path.exists(out)
    from PIL import Image
    img = np.asarray(Image.open(out))
    assert img.shape == (24, 24, 3)
    assert img.max() > 0


@pytest.mark.slow
def test_render_scene_file_with_bvh(tmp_path):
    out = str(tmp_path / "s10.png")
    rc = main(["render", "--jax-cache", str(tmp_path / "jc"),
               "--scene", "data/scene_10.json", "--integrator", "pt",
               "--width", "20", "--height", "20", "--spp", "2",
               "--max-depth", "3", "--intersector", "bvh", "--out", out])
    assert rc == 0 and os.path.exists(out)


@pytest.mark.slow
def test_render_sppm_checkpoint_resume(tmp_path):
    out = str(tmp_path / "sppm.png")
    ck = str(tmp_path / "state.npz")
    rc = main(["render", "--jax-cache", str(tmp_path / "jc"),
               "--scene", "cornell", "--integrator", "sppm",
               "--width", "16", "--height", "16", "--spp", "2",
               "--max-depth", "4", "--sppm-iters", "2",
               "--sppm-photons", "2000", "--checkpoint", ck, "--out", out])
    assert rc == 0 and os.path.exists(out) and os.path.exists(ck)
    # resume one more iteration from the checkpoint
    out2 = str(tmp_path / "sppm2.png")
    rc = main(["render", "--jax-cache", str(tmp_path / "jc"),
               "--scene", "cornell", "--integrator", "sppm",
               "--width", "16", "--height", "16", "--spp", "2",
               "--max-depth", "4", "--sppm-iters", "3",
               "--sppm-photons", "2000", "--resume", ck, "--out", out2])
    assert rc == 0 and os.path.exists(out2)


@pytest.mark.slow
def test_sharded_cli(tmp_path):
    out = str(tmp_path / "shard.png")
    rc = main(["render", "--jax-cache", str(tmp_path / "jc"),
               "--scene", "spheres", "--integrator", "pt",
               "--width", "24", "--height", "24", "--spp", "4",
               "--max-depth", "4", "--sharded", "--out", out])
    assert rc == 0 and os.path.exists(out)


@pytest.mark.slow
def test_render_field_builtin(tmp_path):
    out = str(tmp_path / "field.png")
    rc = main(["render", "--jax-cache", str(tmp_path / "jc"),
               "--scene", "field:512", "--integrator", "pt",
               "--width", "24", "--height", "18", "--spp", "2",
               "--max-depth", "3", "--out", out])
    assert rc == 0 and os.path.exists(out)


@pytest.mark.slow
def test_render_motion_builtin(tmp_path):
    out = str(tmp_path / "motion.png")
    rc = main(["render", "--jax-cache", str(tmp_path / "jc"),
               "--scene", "motion:64", "--integrator", "pt",
               "--width", "24", "--height", "18", "--spp", "2",
               "--max-depth", "3", "--out", out])
    assert rc == 0 and os.path.exists(out)


def test_sppm_motion_fails_fast(tmp_path):
    with pytest.raises(ValueError, match="motion"):
        main(["render", "--jax-cache", str(tmp_path / "jc"),
              "--scene", "motion:16", "--integrator", "sppm",
              "--width", "8", "--height", "8", "--spp", "1",
              "--out", str(tmp_path / "x.png")])
