"""Speedup plot: measured MLUPS vs the reference's published numbers.

Analog of Visualization/plo.py, which hard-codes the reference's published
runtimes (Visualization/plo.py:5-8) and plots async speedup per grid size.
Here the reference numbers are the baseline table and the measured numbers
come from bench reports.
"""

from __future__ import annotations

import json

from lbm_tpu.tools.bench import REFERENCE_BEST_MLUPS

# Published compute-phase runtimes (s) on IRIDIS 5, 80 cores
# (README.md:124-129).
REFERENCE_RUNTIMES = {
    "128x128": {"sync": 0.907, "semi-async": 0.859, "async": 0.413},
    "128x256": {"sync": 2.845, "semi-async": 2.511, "async": 1.421},
    "256x256": {"sync": 6.520, "semi-async": 5.388, "async": 3.425},
    "1024x1024": {"sync": 16.666, "semi-async": 13.731, "async": 11.675},
}


def render_speedup(reports: list[dict], output: str) -> str:
    """Plot measured MLUPS against the reference's best per grid.

    ``reports`` are dicts from tools.bench.run_bench (need keys grid, value).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    import numpy as np

    grids = [r["grid"] for r in reports]
    ours = [r["value"] for r in reports]
    ref = [REFERENCE_BEST_MLUPS.get(g, float("nan")) for g in grids]

    x = np.arange(len(grids))
    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(12, 5))
    width = 0.38
    ax1.bar(x - width / 2, ref, width, label="reference best (80 cores, async MPI)")
    ax1.bar(x + width / 2, ours, width, label="lbm_tpu (1 device)")
    ax1.set_xticks(x, grids)
    ax1.set_ylabel("MLUPS")
    ax1.set_title("Throughput")
    ax1.legend()

    speedup = [o / r if r else float("nan") for o, r in zip(ours, ref)]
    ax2.bar(x, speedup, color="tab:green")
    ax2.axhline(1.0, color="k", lw=0.8, ls="--")
    ax2.set_xticks(x, grids)
    ax2.set_ylabel("speedup vs reference best")
    ax2.set_title("Speedup vs. Grid Size (1 device / 80 CPU cores)")
    for xi, s in zip(x, speedup):
        ax2.text(xi, s, f"{s:.1f}x", ha="center", va="bottom")
    fig.tight_layout()
    fig.savefig(output, dpi=130)
    plt.close(fig)
    return output


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="Render a speedup plot from bench reports")
    parser.add_argument("reports", nargs="+", help="JSON bench report files (or JSON lines)")
    parser.add_argument("--output", default="speedup.png")
    args = parser.parse_args(argv)
    reports = []
    for path in args.reports:
        with open(path) as fp:
            for line in fp:
                line = line.strip()
                if line:
                    reports.append(json.loads(line))
    print(f"wrote {render_speedup(reports, args.output)}")
    return 0


if __name__ == "__main__":
    import sys

    sys.exit(main())
