"""PyTorch port: the plotting callbacks draw what the JAX package's draw.

Each of the four callbacks runs twice on the same data and the same
``X_aligned`` arrays (Agg backend): once from the JAX package with its model
and numpy arrays, once from the port with its model and torch tensors. Every
axis must carry the same titles, labels and legend, and every collection the
same offsets, colour array, face and edge colours, sizes, marker path and
label. The fixed view's passthrough shows in the offsets: ``X_aligned`` is
moved off the observed coordinates everywhere, and the callbacks put the
fixed view back.
"""

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt
import numpy as np
import pytest
import torch

import spatial_alignment_tpu as sat
import spatial_alignment_tpu.plotting as jplot
import spatial_alignment_tpu_torch as tp
import spatial_alignment_tpu_torch.plotting as tplot

from conftest import make_two_view_data

torch.set_num_threads(1)


def _artists(ax):
    legend = ax.get_legend()
    return {
        "title": ax.get_title(), "xlabel": ax.get_xlabel(), "ylabel": ax.get_ylabel(),
        "xlim": ax.get_xlim(),
        "legend": None if legend is None else [t.get_text() for t in legend.get_texts()],
        "collections": [
            {"offsets": np.asarray(c.get_offsets()),
             "array": None if c.get_array() is None else np.asarray(c.get_array()),
             "facecolors": c.get_facecolors(), "edgecolors": c.get_edgecolors(),
             "sizes": c.get_sizes(), "linewidths": c.get_linewidths(),
             "marker": c.get_paths()[0].vertices, "label": c.get_label(),
             "cmap": c.get_cmap().name}
            for c in ax.collections
        ],
    }


def _assert_same(got, want):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want)
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _draw(callback, n_axes, *args, **kw):
    fig, axes = plt.subplots(1, n_axes)
    try:
        callback(*args, *axes, **kw) if n_axes != 4 else callback(*args, axes, **kw)
        return [_artists(ax) for ax in axes]
    finally:
        plt.close(fig)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _shifted(X, seed=1):
    return X + 0.2 * np.random.default_rng(seed).standard_normal(X.shape).astype(np.float32)


def _twod_models(mle):
    data = make_two_view_data(n_per_view=12, n_outputs=3)
    if mle:
        return (sat.WarpGPMLE(data, fixed_view_idx=0),
                tp.WarpGPMLE(data, fixed_view_idx=0, device="cpu"), data)
    kw = dict(m_X_per_view=6, m_G=6, fixed_view_idx=0)
    return (sat.VariationalGPSA(data, **kw), tp.VariationalGPSA(data, **kw, device="cpu"),
            data)


@pytest.mark.parametrize("mle", [False, True], ids=["vgpsa", "mle"])
@pytest.mark.parametrize("which", ["twod", "twod_aligned_only"])
def test_twod_callbacks_draw_as_jax(which, mle):
    jmodel, tmodel, data = _twod_models(mle)
    X, Y = data["expression"]["spatial_coords"], data["expression"]["outputs"]
    G = _shifted(X)
    kw = dict(is_mle=mle, gene_idx=1)
    if which == "twod":
        kw.update(s=80, include_legend=True)
    name = f"callback_{which}"
    want = _draw(getattr(jplot, name), 2, jmodel, X, Y, {"expression": G}, **kw)
    got = _draw(getattr(tplot, name), 2, tmodel, _t(X), _t(Y), {"expression": _t(G)}, **kw)
    _assert_same(got, want)
    fixed = tmodel.view_idx["expression"][0]
    on_observed = np.allclose(got[1]["collections"][0]["offsets"], X[fixed]) if (
        which == "twod") else np.allclose(got[0]["collections"][0]["offsets"], X[fixed])
    assert on_observed != mle  # the passthrough is the variational model's only


def test_oned_callback_draws_as_jax():
    rng = np.random.default_rng(2)
    data = {"expression": {
        "spatial_coords": np.linspace(-5, 5, 24).reshape(-1, 1).astype(np.float32),
        "outputs": rng.standard_normal((24, 2)).astype(np.float32),
        "n_samples_list": [12, 12]}}
    kw = dict(m_X_per_view=5, m_G=5, fixed_view_idx=0)
    jmodel = sat.VariationalGPSA(data, **kw)
    tmodel = tp.VariationalGPSA(data, **kw, device="cpu")
    X, Y = data["expression"]["spatial_coords"], data["expression"]["outputs"]
    G, F = _shifted(X), rng.standard_normal((24, 2)).astype(np.float32)
    Xt = rng.uniform(-5, 5, (6, 1)).astype(np.float32)
    Yp, Yt = rng.standard_normal((6, 2)), rng.standard_normal((6, 2))
    fig_axes = 3

    def run(plot, model, conv):
        fig, axes = plt.subplots(1, fig_axes)
        try:
            plot.callback_oned(model, conv(X), conv(Y), {"expression": conv(G)}, axes[0],
                               axes[1], prediction_ax=axes[2], X_test=conv(Xt),
                               Y_pred=conv(Yp), Y_test_true=conv(Yt),
                               X_test_aligned={"expression": conv(Xt)}, F_samples=conv(F))
            return [_artists(ax) for ax in axes]
        finally:
            plt.close(fig)

    want = run(jplot, jmodel, np.asarray)
    got = run(tplot, tmodel, _t)
    _assert_same(got, want)
    assert sum(len(a["collections"]) for a in got) == 2 * 2 + 2 * 2 * 2 + 2 + 2


@pytest.mark.parametrize("rgb", [False, True], ids=["first_channel", "rgb"])
def test_multimodal_callback_draws_as_jax(rgb):
    data = make_two_view_data(n_per_view=10, n_outputs=3)
    hist = make_two_view_data(n_per_view=8, n_outputs=3, seed=4)["expression"]
    hist["outputs"] = (1 + np.tanh(hist["outputs"])) / 2  # RGB in [0, 1]
    data["histology"] = hist
    kw = dict(m_X_per_view=5, m_G=5, fixed_view_idx=0, n_noise_variance_params=3)
    jmodel = sat.VariationalGPSA(data, **kw)
    tmodel = tp.VariationalGPSA(data, **kw, device="cpu")
    G = {m: _shifted(data[m]["spatial_coords"], seed=i) for i, m in enumerate(data)}
    tdata = {m: {k: (_t(v) if k != "n_samples_list" else v) for k, v in d.items()}
             for m, d in data.items()}
    opts = dict(rgb=rgb, scatterpoint_size=30)
    want = _draw(jplot.callback_twod_multimodal, 4, jmodel, data, G, **opts)
    got = _draw(tplot.callback_twod_multimodal, 4, tmodel, tdata,
                {m: _t(g) for m, g in G.items()}, **opts)
    _assert_same(got, want)
    assert [len(a["collections"]) for a in got] == [2, 2, 2, 2]
