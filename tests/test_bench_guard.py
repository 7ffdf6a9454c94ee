"""The repo-root bench entrypoint: one JSON line, f32/i16 best-of.

bench.main() measures f32 and i16 (storage policy "best") and reports the
faster, with the other under "alt", and the device the run used.  These
tests drive it with mocked measurements; a failing candidate is a failure
of the benchmark, never skipped.
"""

import json

import pytest

import bench as bench_entry

_DEVICE = {"platform": "gpu", "kind": "mock", "count": 1}


@pytest.fixture
def bench_env(monkeypatch):
    monkeypatch.setenv("LBM_BENCH_GRID", "1024x1024")
    monkeypatch.delenv("LBM_BENCH_STEPS", raising=False)
    monkeypatch.delenv("LBM_BENCH_VARIANT", raising=False)
    monkeypatch.delenv("LBM_BENCH_STORAGE", raising=False)


def _mock_measurements(monkeypatch, values):
    """Feed successive run_bench results; record call count."""
    calls = []

    def fake_run_bench(**kwargs):
        v = values[min(len(calls), len(values) - 1)]
        calls.append(kwargs)
        if isinstance(v, Exception):
            raise v
        return {
            "metric": "MLUPS 1024x1024 mock",
            "value": v,
            "unit": "MLUPS",
            "vs_baseline": round(v / 1796.0, 3),
            "storage": kwargs.get("storage", "f32"),
            "device": _DEVICE,
        }

    import lbm_tpu.tools.bench as tools_bench

    monkeypatch.setattr(tools_bench, "run_bench", fake_run_bench)
    return calls


def test_healthy_reading_no_retry(bench_env, monkeypatch, capsys):
    # Default storage "best": one f32 pass + one i16 candidate; the tie
    # keeps f32 as the reported storage.
    calls = _mock_measurements(monkeypatch, [15000.0])
    assert bench_entry.main() == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["value"] == 15000.0
    assert out["storage"] == "f32"
    assert out["alt"]["storage"] == "i16"
    assert len(calls) == 2
    assert [c["storage"] for c in calls] == ["f32", "i16"]


def test_best_storage_reports_the_faster_candidate(bench_env, monkeypatch, capsys):
    # i16 measures faster than f32 -> it becomes the headline, f32 the alt.
    calls = _mock_measurements(monkeypatch, [15000.0, 19000.0])
    assert bench_entry.main() == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["value"] == 19000.0
    assert out["storage"] == "i16"
    assert out["alt"] == {
        "metric": "MLUPS 1024x1024 mock", "value": 15000.0, "storage": "f32",
    }
    assert len(calls) == 2


def test_explicit_storage_skips_the_candidate(bench_env, monkeypatch, capsys):
    monkeypatch.setenv("LBM_BENCH_STORAGE", "f32")
    calls = _mock_measurements(monkeypatch, [15000.0])
    assert bench_entry.main() == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["value"] == 15000.0
    assert "alt" not in out
    assert len(calls) == 1


def test_bench_line_names_the_device(bench_env, monkeypatch, capsys):
    _mock_measurements(monkeypatch, [15000.0])
    assert bench_entry.main() == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["device"] == _DEVICE


def test_failing_i16_candidate_fails_the_benchmark(bench_env, monkeypatch):
    # i16 runs on every path now: a failure there is a failure, not a
    # skipped candidate.
    _mock_measurements(monkeypatch, [15000.0, RuntimeError("i16 broke")])
    with pytest.raises(RuntimeError, match="i16 broke"):
        bench_entry.main()
