"""Live performance plots: a copy of ``supereight_tpu/plots.py`` over the
port's ``eval/sweep.parse_frame_log`` — the headless equivalent of the
reference's Qt GUI stat plots (se_apps/qt/QtGUI.cpp:201-313, qcustomplot
panels of per-stage times and the camera track).

On a headless host there is no interactive window; "live" here means a
PNG that the CLI refreshes every ``rendering_rate`` frames
(``--plot-out``) and finalizes at exit, showing the same three panels
the reference plots: per-stage frame times, the frames-per-second
series, and the top-down camera trajectory (estimated vs ground truth
when available).
matplotlib is imported only when a plot is drawn.
"""

from typing import Optional, Sequence

import numpy as np

_STAGES = ("preprocessing", "tracking", "integration", "raycasting",
           "rendering")


def plot_run(rows: Sequence[dict], out_png: str,
             gt_xyz: Optional[np.ndarray] = None,
             est_xyz: Optional[np.ndarray] = None) -> None:
    """Render the run-so-far stats to ``out_png``.

    ``rows``: parsed frame-log rows (eval.sweep.parse_frame_log schema).
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    frames = [r["frame"] for r in rows]
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))

    ax = axes[0]
    for key in _STAGES:
        vals = [1e3 * r.get(key, 0.0) for r in rows]
        if any(vals):
            ax.plot(frames, vals, label=key, linewidth=0.9)
    ax.set_xlabel("frame")
    ax.set_ylabel("stage time (ms, wall)")
    ax.set_title("per-stage frame times")
    ax.legend(fontsize=7)

    ax = axes[1]
    comp = np.asarray([r.get("computation", 0.0) for r in rows])
    safe = np.where(comp > 0, comp, np.nan)
    ax.plot(frames, 1.0 / safe, linewidth=0.9)
    ax.set_xlabel("frame")
    ax.set_ylabel("computation fps (wall)")
    ax.set_title("throughput")

    ax = axes[2]
    if est_xyz is not None and len(est_xyz):
        e = np.asarray(est_xyz)
        ax.plot(e[:, 0], e[:, 2], label="estimated", linewidth=1.0)
    else:
        xs = [r.get("X", 0.0) for r in rows]
        zs = [r.get("Z", 0.0) for r in rows]
        ax.plot(xs, zs, label="estimated", linewidth=1.0)
    if gt_xyz is not None and len(gt_xyz):
        g = np.asarray(gt_xyz)
        ax.plot(g[:, 0], g[:, 2], "--", label="ground truth",
                linewidth=1.0)
    ax.set_xlabel("x (m)")
    ax.set_ylabel("z (m)")
    ax.set_title("trajectory (top-down)")
    ax.legend(fontsize=7)
    ax.set_aspect("equal", adjustable="datalim")

    fig.tight_layout()
    fig.savefig(out_png, dpi=110)
    plt.close(fig)


def plot_log_file(log_path: str, out_png: str) -> None:
    """Plot a finished run from its frame log."""
    from supereight_tpu_torch.eval.sweep import parse_frame_log
    plot_run(parse_frame_log(log_path), out_png)
