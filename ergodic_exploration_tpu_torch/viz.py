"""Map / trajectory / target rendering: the RViz replacement (port of
``ergodic_exploration_tpu/viz.py``).

Reference capability: the node's visualization publishers (predicted path as
``nav_msgs/Path``, target GMM markers; SURVEY.md sections 2 L5 and 6). Here
matplotlib renders the same artifacts for one scenario. Tensors are copied to
the host first; matplotlib is imported only by :func:`save_exploration_figure`
(``render_scenario`` draws on an axes the caller made).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def render_scenario(ax, domain, grid=None, phi=None, phi_shape=None, trajectory=None,
                    predicted=None, gmm=None, title: Optional[str] = None):
    """Draw one scenario's world + trajectory on a matplotlib axes.

    Args:
        ax: matplotlib axes.
        domain: Domain (unbatched).
        grid: optional GridMap (unbatched), drawn as an occupancy image.
        phi: optional (Ns,) target sample values, drawn as a heatmap.
        phi_shape: (nsx, nsy) lattice shape for ``phi``.
        trajectory: optional (T, 3) executed states (a line).
        predicted: optional (H+1, 3) predicted path (dashed).
        gmm: optional GaussianMixture; its component means drawn as markers.
    """
    o, L = _np(domain.origin), _np(domain.lengths)
    extent = [o[0], o[0] + L[0], o[1], o[1] + L[1]]
    if phi is not None and phi_shape is not None:
        img = _np(phi).reshape(phi_shape)  # [ix, iy]
        ax.imshow(img.T, origin="lower", extent=extent, cmap="viridis", alpha=0.8)
    if grid is not None:
        occ = np.ma.masked_less(_np(grid.data), 0.65)
        g0 = _np(grid.origin)
        h, w = grid.shape
        res = float(_np(grid.resolution))
        gext = [g0[0], g0[0] + w * res, g0[1], g0[1] + h * res]
        ax.imshow(occ, origin="lower", extent=gext, cmap="gray_r", vmin=0, vmax=1)
    if trajectory is not None:
        T = _np(trajectory)
        ax.plot(T[:, 0], T[:, 1], "w-", lw=1.5, label="executed")
        ax.plot(T[-1, 0], T[-1, 1], "wo", ms=5)
    if predicted is not None:
        P = _np(predicted)
        ax.plot(P[:, 0], P[:, 1], "r--", lw=1.0, label="predicted")
    if gmm is not None:
        M = _np(gmm.means)
        ax.plot(M[:, 0], M[:, 1], "r*", ms=12, label="target modes")
    ax.set_xlim(extent[0], extent[1])
    ax.set_ylim(extent[2], extent[3])
    ax.set_aspect("equal")
    if title:
        ax.set_title(title)


def save_exploration_figure(path: str, domain, out, scenario: int = 0, grid=None, phi=None,
                            phi_shape=None, gmm=None):
    """Render one scenario of an ``ExploreOutput`` to an image file, beside
    its ergodic-metric curve; returns ``path``."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, (ax1, ax2) = plt.subplots(1, 2, figsize=(11, 5))
    render_scenario(ax1, domain, grid=grid, phi=phi, phi_shape=phi_shape,
                    trajectory=_np(out.trajectory[:, scenario]), gmm=gmm,
                    title=f"scenario {scenario}")
    ax2.plot(_np(out.diag.ergodic_metric[:, scenario]))
    ax2.set_xlabel("tick")
    ax2.set_ylabel("ergodic metric")
    ax2.set_title("ergodic metric")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
    return path
