"""Training-curve PNGs (copy of ``unet_embroidery_seg_tpu/utils/plotting.py``).

``loss_curve.png`` and ``metrics_curve.png`` at dpi=300 inside the weights
folder, covering whichever metric set (binary or multiclass) the run
produced. matplotlib is imported inside the functions (its cache under
``.mpl-cache`` in the working directory), so the port's compute path needs
no plotting library.
"""

from __future__ import annotations

import logging
import os

_KNOWN_METRICS = (
    "Dice", "IoU", "Precision", "Recall", "Accuracy",
    "Pixel Accuracy", "Mean Accuracy", "Mean IoU", "Frequency Weighted IoU",
)


def _pyplot():
    os.environ.setdefault("MPLCONFIGDIR", ".mpl-cache")
    os.makedirs(os.environ["MPLCONFIGDIR"], exist_ok=True)
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.rcParams.update({
        "font.family": "serif",
        "font.serif": ["Times New Roman", "Times", "DejaVu Serif", "Liberation Serif"],
    })
    logging.getLogger("matplotlib.font_manager").setLevel(logging.ERROR)
    return plt


def _render(series: dict[str, list[float]], ylabel: str, path: str) -> None:
    """One labelled multi-line chart -> PNG."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(8, 6))
    for label, ys in series.items():
        ax.plot(range(1, len(ys) + 1), ys, label=label, linewidth=2)
    ax.set_xlabel("Epoch", fontsize=14)
    ax.set_ylabel(ylabel, fontsize=14)
    ax.tick_params(labelsize=12)
    ax.grid(True, which="both", linestyle="--", alpha=0.5)
    ax.legend(fontsize=12)
    fig.tight_layout()
    fig.savefig(path, dpi=300)
    plt.close(fig)


def plot_training_curves(train_losses, val_losses, val_metrics_history, weights_folder):
    _render(
        {"Train Loss": list(train_losses), "Val Loss": list(val_losses)},
        "Loss",
        os.path.join(weights_folder, "loss_curve.png"),
    )
    present = [k for k in _KNOWN_METRICS if val_metrics_history and k in val_metrics_history[0]]
    _render(
        {k: [float(m.get(k, 0.0)) for m in val_metrics_history] for k in present},
        "Score",
        os.path.join(weights_folder, "metrics_curve.png"),
    )
