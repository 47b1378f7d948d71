"""Progress and labeling views — counterpart of progressivex_tpu/io/visualizer.py
and of the reference's `progress_visualizer.h` (`ProgressVisualizer`,
`MultiHomographyVisualizer`).

  * `draw_labeling`: the final point-to-instance labeling over the points
    or correspondence pairs (colored matches over one or two images, or a
    bare scatter without images);
  * `draw_round_log`: the round-by-round trajectory of a fit from
    `Statistics.iterations` (proposal support, Tanimoto, PEARL energy, live
    instances);
  * `LiveProgress`: pass one as `progress_callback=` to any find* function
    and it renders (or logs) the labeling after every round, from the
    engine's event dicts (core/engine.py `_emit_progress`).

Matplotlib is imported only when something is drawn; every function takes
`save=` to write a PNG (headless) and shows the figure otherwise. The
drawing code is the JAX package's, so that the two write the same pixels.
"""

from __future__ import annotations

import numpy as np

# A qualitative palette (colorblind-safe Okabe-Ito + extras); outliers gray.
_PALETTE = [
    "#0072B2", "#E69F00", "#009E73", "#D55E00", "#CC79A7",
    "#56B4E9", "#F0E442", "#8B4513", "#7F3C8D", "#11A579",
]
_OUTLIER = "#B0B0B0"


def _colors(labels, k):
    return [
        _PALETTE[int(l) % len(_PALETTE)] if l < k else _OUTLIER
        for l in labels
    ]


def draw_labeling(corrs, labels, img1=None, img2=None, title=None,
                  save=None, point_size=12):
    """Render a labeling over correspondences.

    Args:
      corrs: [N, 2] points or [N, 4] correspondences [x1, y1, x2, y2].
      labels: [N] int labels (K = outlier class, reference convention).
      img1, img2: optional images; with both, correspondences render side
        by side with connecting lines like the reference visualizer.
      save: optional path — write a PNG instead of showing a window.
    """
    import matplotlib
    if save is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    corrs = np.asarray(corrs)
    labels = np.asarray(labels)
    k = int(labels.max()) if labels.size else 0
    if (labels == k).any():
        k = k  # last label is the outlier class by convention
    cols = _colors(labels, k)

    if corrs.shape[1] >= 4 and img1 is not None and img2 is not None:
        h1, w1 = np.asarray(img1).shape[:2]
        fig, ax = plt.subplots(figsize=(12, 6))
        canvas_h = max(h1, np.asarray(img2).shape[0])
        ax.imshow(np.asarray(img1), extent=[0, w1, canvas_h, 0])
        ax.imshow(np.asarray(img2), extent=[w1, w1 + np.asarray(img2).shape[1],
                                            canvas_h, 0])
        for (x1, y1, x2, y2), c in zip(corrs[:, :4], cols):
            ax.plot([x1, w1 + x2], [y1, y2], color=c, linewidth=0.5,
                    alpha=0.6)
        ax.scatter(corrs[:, 0], corrs[:, 1], c=cols, s=point_size)
        ax.scatter(w1 + corrs[:, 2], corrs[:, 3], c=cols, s=point_size)
        ax.set_axis_off()
    else:
        n_panels = 2 if corrs.shape[1] >= 4 else 1
        fig, axes = plt.subplots(1, n_panels, figsize=(6 * n_panels, 6))
        axes = np.atleast_1d(axes)
        axes[0].scatter(corrs[:, 0], corrs[:, 1], c=cols, s=point_size)
        if img1 is not None:
            axes[0].imshow(np.asarray(img1))
        axes[0].invert_yaxis()
        axes[0].set_title("view 1")
        if n_panels == 2:
            axes[1].scatter(corrs[:, 2], corrs[:, 3], c=cols, s=point_size)
            if img2 is not None:
                axes[1].imshow(np.asarray(img2))
            axes[1].invert_yaxis()
            axes[1].set_title("view 2")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if save is not None:
        fig.savefig(save, dpi=120)
        plt.close(fig)
        return save
    plt.show()
    return None


def draw_round_log(stats, title=None, save=None):
    """Plot the per-round trajectory of a fit from a Statistics object
    (api.Statistics with `iterations` populated) — the step-by-step
    progress view of the reference visualizer, condensed to one figure."""
    import matplotlib
    if save is not None:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    its = stats.iterations
    if not its:
        raise ValueError("Statistics has no per-round records")
    rounds = np.arange(len(its))
    fig, axes = plt.subplots(2, 2, figsize=(10, 6), sharex=True)
    acc = [it["accepted"] for it in its]
    axes[0, 0].bar(rounds, [it["proposal_inliers"] for it in its],
                   color=["#009E73" if a else "#D55E00" for a in acc])
    axes[0, 0].set_title("proposal support (green = accepted)")
    axes[0, 1].plot(rounds, [it["pearl_energy"] for it in its], "o-")
    axes[0, 1].set_title("PEARL energy")
    axes[1, 0].plot(rounds, [it["tanimoto"] for it in its], "o-")
    axes[1, 0].set_title("proposal Tanimoto vs compound")
    axes[1, 1].step(rounds, [it["active_models"] for it in its], where="mid")
    axes[1, 1].set_title("live instances")
    for ax in axes[1]:
        ax.set_xlabel("round")
    if title:
        fig.suptitle(title)
    fig.tight_layout()
    if save is not None:
        fig.savefig(save, dpi=120)
        plt.close(fig)
        return save
    plt.show()
    return None


class LiveProgress:
    """Per-round live view: pass an instance as `progress_callback=` to a
    find* function (the reference's ProgressVisualizer hook,
    progress_visualizer.h:18-247 / progressive_x.h:476-480).

    Modes:
      * data given  -> renders the evolving labeling to `save_pattern`
        (e.g. "round_{round:02d}.png") or an interactive window,
      * no data     -> logs one line per round to stderr.

    The engine calls it on the host after each pass of its round loop.
    """

    def __init__(self, data=None, save_pattern=None, log=True):
        self.data = None if data is None else np.asarray(data)
        self.save_pattern = save_pattern
        self.log = log
        self.events = []

    def __call__(self, ev):
        self.events.append(ev)
        if self.log:
            import sys

            print(
                f"[progressivex_tpu_torch] round {ev['round']}: "
                f"{'accepted' if ev['accepted'] else 'rejected'} "
                f"support={ev['inliers']} tanimoto={ev['tanimoto']:.3f} "
                f"energy={ev['energy']:.4g} instances={ev['n_active']}",
                file=sys.stderr,
            )
        if self.data is not None:
            save = (
                self.save_pattern.format(round=ev["round"])
                if self.save_pattern else None
            )
            n = self.data.shape[0]
            draw_labeling(
                self.data, np.asarray(ev["labels"])[:n],
                title=f"round {ev['round']}: {ev['n_active']} instances",
                save=save,
            )
