"""chip_smoke.py on the CPU: it refuses to run off the GPU, its plain
reference is an exact top-k, and every phase's control flow runs at a tiny
size (the pool-scan kernel in interpret mode, the sharded phase on four of
the eight virtual CPU devices)."""

import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["chip_smoke"] = mod      # dataclasses resolve annotations here
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def no_floors(smoke):
    """Every floor 0: the tiny corpora below say nothing about recall at
    scale; exactness is asserted where a path is exact."""
    return {name: 0.0 for name in smoke.FLOORS}


@pytest.fixture(scope="module")
def tiny(smoke):
    return smoke.Sizes(
        dim=64, rows=4096, ingest_chunk=1024, queries=24, k=10,
        reopen_queries=4, delete_frac=0.01, index_dim=32, index_rows=1500,
        index_queries=12, kernel_rows=4096, kernel_width=512,
        kernel_calls=2, shard_rows=4096, shard_churn=64)


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def _no_result(stdout):
    for line in stdout.splitlines():
        try:
            if json.loads(line).get("ok"):
                return False
        except (ValueError, AttributeError):
            continue
    return True


@pytest.mark.parametrize("args", [[], ["--chips", "4"]],
                         ids=["one_card", "four_cards"])
def test_refuses_without_gpu(args):
    p = _run([SCRIPT, *args], ROOT)
    assert p.returncode != 0
    assert _no_result(p.stdout)
    assert "no GPU" in p.stderr


def test_refuses_outside_checkout(smoke, tmp_path, monkeypatch):
    """A copy of the script alone must not pick up a package from
    elsewhere."""
    monkeypatch.setattr(smoke, "ROOT", str(tmp_path))
    with pytest.raises(ImportError):
        smoke._import_package()


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_reference_matches_numpy(smoke, metric):
    r = np.random.default_rng(3)
    x = r.standard_normal((1000, 24)).astype(np.float32)
    q = r.standard_normal((7, 24)).astype(np.float32)
    alive = r.random(1000) > 0.2
    got = smoke.reference_topk(q, x, 10, metric=metric, alive=alive,
                               block=256)
    if metric == "cosine":
        xn = x / np.linalg.norm(x, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        d = -(qn.astype(np.float64) @ xn.T.astype(np.float64))
    else:
        d = ((q[:, None, :].astype(np.float64) - x[None]) ** 2).sum(-1)
    d[:, ~alive] = np.inf
    want = np.argsort(d, axis=1, kind="stable")[:, :10]
    np.testing.assert_array_equal(got, want)


def test_recall_and_result_ids(smoke):
    from vector_db_tpu.core.types import make_results

    rows = [make_results([3, 1, 2], [0.1, 0.2, 0.3], "l2"),
            make_results([5], [0.0], "l2")]
    ids = smoke.result_ids(rows, 3)
    np.testing.assert_array_equal(ids, [[3, 1, 2], [5, -1, -1]])
    assert smoke.recall_at(ids, np.asarray([[1, 2, 9], [5, 6, 7]]), 3) == (
        pytest.approx((2 / 3 + 1 / 3) / 2))
    with pytest.raises(AssertionError):
        smoke.check("x", 0.5, 0.9, "f32", 0.1)


def test_phase_flagship_tiny(smoke, tiny, no_floors, tmp_path, monkeypatch):
    monkeypatch.setattr(smoke, "STORE_DIR", str(tmp_path / "store"))
    smoke.phase_flagship(tiny, 42, dict(no_floors, scan_exact=0.99))


def test_phase_compressed_tiny(smoke, tiny, no_floors):
    smoke.phase_compressed(tiny, 42, no_floors)


def test_phase_indexes_tiny(smoke, tiny, no_floors):
    smoke.phase_indexes(tiny, 42, dict(no_floors, brute=0.99))


def test_phase_kernel_tiny(smoke, tiny):
    med = smoke.phase_kernel(tiny, 42, ["cpu"], kernel="interpret")
    assert set(med) == {"interpret", "xla"}


def test_phase_sharded_tiny(smoke, tiny, no_floors):
    smoke.phase_sharded(tiny, 42, n_cards=4, floors=no_floors)


def test_shard_capacity_keeps_full_pool_width(smoke):
    from vector_db_tpu.ops.pool_scan import preserved_pool_width

    cap = smoke._shard_capacity(4_000_000, 4096, 4)
    assert cap >= 4_004_096
    assert preserved_pool_width(cap // 4) == 2048
