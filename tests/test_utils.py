"""Host-utility edge cases: OBJ parser, checkpoint format, PNG fallback."""

import os

import numpy as np
import pytest

from raytracer.utils import checkpoint as ckpt
from raytracer.utils.image import _write_png_python
from raytracer.utils.obj import load_obj


class TestObj:
    def test_quads_triangulate_and_negative_indices(self, tmp_path):
        p = tmp_path / "q.obj"
        p.write_text("""
v 0 0 0
v 1 0 0
v 1 1 0
v 0 1 0
vn 0 0 1
f 1//1 2//1 3//1 4//1
f -4//-1 -3//-1 -2//-1
""")
        m = load_obj(str(p))
        # quad fans into 2 tris + 1 more triangle
        assert m.indices.shape == (3, 3)
        assert m.normals is not None
        np.testing.assert_allclose(m.normals, [[0, 0, 1]] * len(m.normals))

    def test_first_object_only(self, tmp_path):
        p = tmp_path / "two.obj"
        p.write_text("""
o first
v 0 0 0
v 1 0 0
v 0 1 0
f 1 2 3
o second
v 5 5 5
v 6 5 5
v 5 6 5
f 4 5 6
""")
        m = load_obj(str(p))
        assert m.indices.shape == (1, 3)  # models[0] semantics (mesh.rs:159)
        m2 = load_obj(str(p), first_object_only=False)
        assert m2.indices.shape == (2, 3)

    def test_missing_normals_computed(self, tmp_path):
        p = tmp_path / "n.obj"
        p.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
        m = load_obj(str(p))
        assert m.normals is None  # builder computes area-weighted normals
        from raytracer.scene.builder import _vertex_normals
        n = _vertex_normals(m.positions, m.indices.astype(np.int64))
        np.testing.assert_allclose(n, [[0, 0, 1]] * 3, atol=1e-6)


class TestCheckpoint:
    def test_roundtrip_and_version_check(self, tmp_path):
        from raytracer.models.sppm import init_state
        s = init_state(16)
        path = str(tmp_path / "st.npz")
        ckpt.save_state(path, s, seed=5)
        s2, seed = ckpt.load_state(path)
        assert seed == 5
        assert int(s2.iteration) == 0
        assert np.asarray(s2.glob.flux).shape == (16, 3)

    def test_version_mismatch_fails_fast(self, tmp_path):
        path = str(tmp_path / "bad.npz")
        np.savez(path.replace(".npz", ""), version=999, seed=0)
        import os
        with pytest.raises(ValueError, match="version"):
            ckpt.load_state(path)


class TestPngFallback:
    def test_pure_python_png(self, tmp_path):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (20, 30, 3), dtype=np.uint8)
        path = str(tmp_path / "x.png")
        _write_png_python(path, img)
        from PIL import Image
        back = np.asarray(Image.open(path))
        np.testing.assert_array_equal(back, img)


@pytest.mark.parametrize("env_set", [True, False])
def test_compile_cache_placement(env_set, tmp_path, monkeypatch):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache sits
    at <repo>/output/.jax_cache whatever the working directory."""
    from raytracer.utils import compile_cache
    monkeypatch.chdir(tmp_path)
    env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "c")} if env_set else {}
    got = compile_cache.cache_dir(env)
    if env_set:
        assert got == str(tmp_path / "c")
    else:
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        assert got == os.path.join(repo, "output", ".jax_cache")
        assert os.path.isabs(got)
