"""Headline benchmark: MLUPS on the 1024x1024 reference scene, single device.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "storage",
"alt", "device"}.  vs_baseline compares against the reference's best
published configuration for this grid: fully-async MPI on 80 cores =
1796 MLUPS (README.md:129, derived in BASELINE.md).

Default storage policy "best" measures f32 and i16 and reports the faster
("storage" names the winner, "alt" records the other) — the same rule the
reference's headline follows: its published number is the fastest variant
inside the 1% golden contract (the stale-halo async build).

Environment: LBM_BENCH_GRID, LBM_BENCH_STEPS, LBM_BENCH_VARIANT,
LBM_BENCH_STORAGE (f32 | i16 | best), LBM_BENCH_REPEATS.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    from lbm_tpu.tools.bench import run_bench

    grid = os.environ.get("LBM_BENCH_GRID", "1024x1024")
    steps = os.environ.get("LBM_BENCH_STEPS")
    storage = os.environ.get("LBM_BENCH_STORAGE", "best")
    kwargs = dict(
        grid=grid,
        variant=os.environ.get("LBM_BENCH_VARIANT", "auto"),
        steps=int(steps) if steps else None,
        repeats=int(os.environ.get("LBM_BENCH_REPEATS", "4")),
    )
    storages = ("f32", "i16") if storage == "best" else (storage,)
    reports = [run_bench(**kwargs, storage=s) for s in storages]
    reports.sort(key=lambda r: r["value"], reverse=True)
    best = reports[0]
    out = {
        "metric": best["metric"],
        "value": best["value"],
        "unit": best["unit"],
        "vs_baseline": best["vs_baseline"],
        "storage": best["storage"],
        "device": best["device"],
    }
    if len(reports) > 1:
        alt = reports[1]
        out["alt"] = {
            "metric": alt["metric"],
            "value": alt["value"],
            "storage": alt["storage"],
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
