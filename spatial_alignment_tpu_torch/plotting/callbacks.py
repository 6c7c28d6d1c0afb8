"""Live training-visualization callbacks (matplotlib, host side).

The port's own copy of ``spatial_alignment_tpu/plotting/callbacks.py``, the
reference's four callbacks: scatter panels of observed against aligned
coordinates, coloured by an output column. Each takes numpy arrays or torch
tensors (on any device) and a model with ``view_idx``, ``n_views``,
``fixed_view_idx`` and ``eval()``: the port's ``VariationalGPSA`` or, with
``is_mle=True``, ``WarpGPMLE``. Each callback imports ``matplotlib`` when
it is called, never this module's import, and raises ``ImportError`` naming
it where it is not installed.

Each callback performs the reference's client-side fixed-view passthrough
correction: the fixed view's aligned coords are replaced by its observed
coords before plotting. The model already returns passthrough means, so the
correction is a no-op kept for user code that mutates ``X_aligned`` in
place.
"""

from __future__ import annotations

import numpy as np

SCATTER_POINT_SIZE = 50


def _require_matplotlib():
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "the plotting callbacks need matplotlib, which is not installed"
        ) from e


def _np(x):
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def _apply_fixed_view_passthrough(model, X, X_aligned, modality="expression"):
    if getattr(model, "fixed_view_idx", None) is None:
        return X_aligned
    fixed = model.fixed_view_idx
    fixed_list = fixed if isinstance(fixed, (list, tuple)) else [fixed]
    aligned = _np(X_aligned[modality]).copy()
    for vv in fixed_list:
        idx = model.view_idx[modality][vv]
        aligned[idx] = _np(X)[idx]
    out = dict(X_aligned)
    out[modality] = aligned
    return out


def callback_oned(
    model,
    X,
    Y,
    X_aligned,
    data_expression_ax,
    latent_expression_ax,
    prediction_ax=None,
    X_test=None,
    Y_pred=None,
    Y_test_true=None,
    X_test_aligned=None,
    F_samples=None,
):
    """1-D observed/aligned scatter panels (+ optional prediction panel)."""
    _require_matplotlib()
    from matplotlib.lines import Line2D

    model.eval()
    markers = list(Line2D.markers.keys())
    X = _np(X)
    Y = _np(Y)
    X_aligned = _apply_fixed_view_passthrough(model, X, X_aligned)
    aligned = _np(X_aligned["expression"])

    data_expression_ax.cla()
    latent_expression_ax.cla()
    data_expression_ax.set_title("Observed data")
    latent_expression_ax.set_title("Aligned data")
    data_expression_ax.set_xlabel("Spatial coordinate")
    latent_expression_ax.set_xlabel("Spatial coordinate")
    data_expression_ax.set_ylabel("Outcome")
    latent_expression_ax.set_ylabel("Outcome")
    data_expression_ax.set_xlim([X.min(), X.max()])
    latent_expression_ax.set_xlim([X.min(), X.max()])

    view_idx = model.view_idx["expression"]
    for vv in range(model.n_views):
        idx = view_idx[vv]
        for jj, color in zip(range(min(2, Y.shape[1])), ["blue", "orange"]):
            data_expression_ax.scatter(
                X[idx, 0],
                Y[idx, jj],
                label=f"View {vv + 1}",
                marker=markers[vv],
                s=SCATTER_POINT_SIZE,
                c=color,
            )
            latent_expression_ax.scatter(
                aligned[idx, 0],
                Y[idx, jj],
                c=color,
                label=f"View {vv + 1}",
                marker=markers[vv],
                s=SCATTER_POINT_SIZE,
            )
        if F_samples is not None:
            F = _np(F_samples)
            for jj, color in zip(range(min(2, F.shape[1])), ["red", "green"]):
                latent_expression_ax.scatter(
                    aligned[idx, 0],
                    F[idx, jj],
                    c=color,
                    marker=markers[vv],
                    s=SCATTER_POINT_SIZE,
                )

    if prediction_ax is not None and Y_pred is not None:
        prediction_ax.cla()
        prediction_ax.set_title("Predictions")
        prediction_ax.set_xlabel("True outcome")
        prediction_ax.set_ylabel("Predicted outcome")
        Yp = _np(Y_pred)
        Xta = _np(X_test_aligned["expression"])
        for jj, (color, marker) in enumerate([("blue", "^"), ("orange", "^")][: Yp.shape[1]]):
            latent_expression_ax.scatter(
                Xta[:, 0], Yp[:, jj], c=color, label="Prediction", marker=marker,
                s=SCATTER_POINT_SIZE,
            )
        Yt = _np(Y_test_true)
        prediction_ax.scatter(Yt[:, 0], Yp[:, 0], c="black", s=SCATTER_POINT_SIZE)
        if Yt.shape[1] > 1:
            prediction_ax.scatter(
                Yt[:, 1], Yp[:, 1], c="black", s=SCATTER_POINT_SIZE, marker="^"
            )

    data_expression_ax.legend()


def callback_twod(
    model,
    X,
    Y,
    X_aligned,
    data_expression_ax,
    latent_expression_ax,
    is_mle=False,
    gene_idx=0,
    s=200,
    include_legend=False,
):
    """2-D observed-vs-aligned scatter colored by one gene (the reference's
    seaborn styling as plain matplotlib with the viridis palette; the same
    panels)."""
    _require_matplotlib()
    X = _np(X)
    Y = _np(Y)
    if not is_mle:
        X_aligned = _apply_fixed_view_passthrough(model, X, X_aligned)
    aligned = _np(X_aligned["expression"])
    model.eval()
    markers = [".", "+", "^"]

    data_expression_ax.cla()
    latent_expression_ax.cla()
    data_expression_ax.set_title("Observed data")
    latent_expression_ax.set_title("Aligned data")

    view_idx = model.view_idx["expression"]
    for vv in range(model.n_views):
        idx = view_idx[vv]
        kw = dict(
            c=Y[idx, gene_idx],
            marker=markers[vv % len(markers)],
            s=s,
            linewidth=1.8,
            edgecolor="black",
            cmap="viridis",
            label=f"Observation {vv + 1}",
        )
        data_expression_ax.scatter(X[idx, 0], X[idx, 1], **kw)
        latent_expression_ax.scatter(aligned[idx, 0], aligned[idx, 1], **kw)
    if include_legend:
        data_expression_ax.legend()


def callback_twod_aligned_only(
    model,
    X,
    Y,
    X_aligned,
    latent_expression_ax1,
    latent_expression_ax2,
    is_mle=False,
    gene_idx=0,
):
    """Per-view aligned-only panels of the first two views."""
    _require_matplotlib()
    X = _np(X)
    Y = _np(Y)
    if not is_mle:
        X_aligned = _apply_fixed_view_passthrough(model, X, X_aligned)
    aligned = _np(X_aligned["expression"])
    model.eval()

    latent_expression_ax1.cla()
    latent_expression_ax2.cla()
    latent_expression_ax1.set_title("Observed data")
    latent_expression_ax2.set_title("Aligned data")

    view_idx = model.view_idx["expression"]
    for ax, vv in ((latent_expression_ax1, 0), (latent_expression_ax2, 1)):
        idx = view_idx[vv]
        ax.scatter(
            aligned[idx, 0],
            aligned[idx, 1],
            c=Y[idx, gene_idx].squeeze(),
            s=24,
            marker="h",
        )


def callback_twod_multimodal(
    model, data_dict, X_aligned, axes, rgb=False, scatterpoint_size=100
):
    """2x2 multimodal panels: observed/aligned expression + histology."""
    _require_matplotlib()
    model.eval()
    markers = [".", "+", "^"]
    for ax in axes:
        ax.cla()
    axes[0].set_title("Observed expression")
    axes[1].set_title("Aligned expression")
    axes[2].set_title("Observed histology")
    axes[3].set_title("Aligned histology")

    axis_counter = 0
    for mod in ["expression", "histology"]:
        curr_view_idx = model.view_idx[mod]
        coords = _np(data_dict[mod]["spatial_coords"])
        outputs = _np(data_dict[mod]["outputs"])
        aligned = _np(X_aligned[mod])
        for vv in range(model.n_views):
            idx = curr_view_idx[vv]
            if mod == "histology" and rgb:
                c = outputs[idx, :]
            else:
                c = outputs[idx, 0]
            kw = dict(
                c=c,
                label=f"View {vv + 1}",
                marker=markers[vv % len(markers)],
                s=scatterpoint_size,
            )
            axes[axis_counter].scatter(coords[idx, 0], coords[idx, 1], **kw)
            axes[axis_counter + 1].scatter(aligned[idx, 0], aligned[idx, 1], **kw)
        axis_counter += 2
