"""Utility tests (reference analog: util/VectorUtilsTest.java + the
TextSearchExample similarity expectations)."""

import numpy as np
import pytest

from vector_db_tpu.utils import text_vectorizer as tv
from vector_db_tpu.utils import vector_utils as vu


class TestVectorUtils:
    def test_euclidean(self):
        assert vu.euclidean_distance([0, 3], [4, 0]) == pytest.approx(5.0)

    def test_squared(self):
        assert vu.squared_euclidean_distance([0, 3], [4, 0]) == pytest.approx(25.0)

    def test_cosine(self):
        assert vu.cosine_similarity([1, 0], [0, 1]) == pytest.approx(0.0)
        assert vu.cosine_similarity([2, 0], [5, 0]) == pytest.approx(1.0)
        assert vu.cosine_similarity([0, 0], [1, 1]) == 0.0

    def test_normalize(self):
        v = vu.normalize([3.0, 4.0])
        np.testing.assert_allclose(v, [0.6, 0.8], rtol=1e-6)
        np.testing.assert_allclose(vu.normalize([0.0, 0.0]), [0.0, 0.0])

    def test_quantize_roundtrip(self, rng):
        v = rng.standard_normal(64).astype(np.float32)
        q, lo, scale = vu.quantize(v)
        back = vu.dequantize(q, lo, scale)
        assert np.abs(back - v).max() <= scale  # within one quantization step

    def test_dim_mismatch(self):
        with pytest.raises(ValueError):
            vu.euclidean_distance([1.0], [1.0, 2.0])


class TestTextVectorizer:
    def test_deterministic(self):
        a = tv.text_to_vector("hello world", 128)
        b = tv.text_to_vector("hello world", 128)
        np.testing.assert_array_equal(a, b)

    def test_normalized(self):
        v = tv.text_to_vector("some text", 128)
        assert np.linalg.norm(v) == pytest.approx(1.0, abs=1e-5)

    def test_similar_texts_closer_than_different(self):
        # one-char edit should be much closer than unrelated text
        # (reference: TextVectorizer.java:92-105 leave-one-out features)
        base = tv.text_to_vector("machine learning", 256)
        near = tv.text_to_vector("machine learnins", 256)
        far = tv.text_to_vector("zebra crossing!!", 256)
        assert tv.cosine_similarity(base, near) > tv.cosine_similarity(base, far)

    def test_empty_raises(self):
        with pytest.raises(ValueError):
            tv.text_to_vector("", 64)

    def test_generate_similar(self):
        v = tv.text_to_vector("hello", 128)
        s = tv.generate_similar_vector(v, noise=0.1)
        assert tv.cosine_similarity(v, s) > 0.9


class TestCompileCache:
    """One rule for JAX's persistent compile cache (utils/compile_cache):
    JAX_COMPILATION_CACHE_DIR when it is set, else one fixed directory in
    the checkout that .gitignore lists."""

    def test_env_var_set_is_used_as_is(self, tmp_path):
        import jax

        from vector_db_tpu.utils.compile_cache import (compile_cache_dir,
                                                       enable_compile_cache)

        env = {"JAX_COMPILATION_CACHE_DIR": str(tmp_path)}
        assert compile_cache_dir(env) == str(tmp_path)
        before = jax.config.jax_compilation_cache_dir
        try:
            assert enable_compile_cache(environ=env) == str(tmp_path)
            assert jax.config.jax_compilation_cache_dir == str(tmp_path)
        finally:
            jax.config.update("jax_compilation_cache_dir", before)

    def test_env_var_unset_uses_the_checkout(self):
        import os

        from vector_db_tpu.utils.compile_cache import compile_cache_dir

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        path = compile_cache_dir({})
        assert os.path.dirname(path) == root
        name = os.path.basename(path)
        with open(os.path.join(root, ".gitignore")) as f:
            assert f"{name}/" in f.read().split()

    def test_entry_points_set_no_other_directory(self):
        import os

        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        for rel in ("bench.py", "chip_smoke.py", "tests/conftest.py"):
            with open(os.path.join(root, rel)) as f:
                src = f.read()
            assert "jax_compilation_cache_dir" not in src, rel
            assert "enable_compile_cache" in src, rel
