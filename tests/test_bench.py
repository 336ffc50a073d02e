"""Smoke test for the benchmark entry point (tiny sizes, CPU)."""

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).absolute().parent.parent))


def test_bench_main_smoke(monkeypatch, capsys):
    import bench

    monkeypatch.setattr(bench, "BATCH", 2048)
    monkeypatch.setattr(bench, "GRID_BATCH", 64)
    monkeypatch.setattr(bench, "N_WALKERS", 256)
    monkeypatch.setattr(bench, "N_STEPS", 2)
    monkeypatch.setattr(bench, "N_ITER", 1)
    monkeypatch.setattr(bench, "N_WINDOWS", 1)
    monkeypatch.setattr(bench, "N_PROBE", 4)
    bench.main()
    line = capsys.readouterr().out.strip().splitlines()[-1]
    out = json.loads(line)
    assert out["metric"] == "zheng07_wp_xi_ell_predictions_per_sec"
    assert out["value"] > 0
    assert out["device_kind"] == "cpu"
    assert "power_limit" in out
    for key in ("ensemble_walker_steps_per_sec",
                "grid64_predictions_per_sec"):
        assert out[key] > 0
    # Accuracy gates: wp relative (well-conditioned), xi scale-normalized.
    assert out["wp_f32_max_rel_err_vs_f64"] < 5e-6
    assert out["xi_ell_f32_scaled_err_vs_f64"] < 5e-6
    assert out["grid64_f32_scaled_err_vs_f64"] < 5e-6
