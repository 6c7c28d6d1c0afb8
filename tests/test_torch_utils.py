"""PyTorch port: the numpy utilities copied from the JAX package
(``utils/preprocess.py``, ``utils/metrics.py``, ``utils/gsea.py``) give the
JAX package's results on the same seeded inputs, exactly (the same numpy
code), and every name of the JAX package's ``__all__`` resolves in the
port, with the stragglers (``distance_matrix``, ``core.mean_penalty``,
``linalg.safe_cholesky``, ``set_cholesky_impl``, the model shims).
"""

import types

import numpy as np
import pandas as pd
import pytest
import jax.numpy as jnp
import torch

import spatial_alignment_tpu as sat
import spatial_alignment_tpu.utils as jutils
from spatial_alignment_tpu.models import core as jcore
from spatial_alignment_tpu.models import vgpsa as jvgpsa
from spatial_alignment_tpu.ops import linalg as jlinalg
import spatial_alignment_tpu_torch as tp
import spatial_alignment_tpu_torch.utils as tutils
from spatial_alignment_tpu_torch.models import core as tcore
from spatial_alignment_tpu_torch.models import vgpsa as tvgpsa
from spatial_alignment_tpu_torch.ops import linalg as tlinalg
from spatial_alignment_tpu_torch.ops import trisolve

from conftest import make_two_view_data

torch.set_num_threads(1)


def _counts(seed=0, n=40, g=12):
    rng = np.random.default_rng(seed)
    return rng.poisson(rng.uniform(0.5, 20, (1, g)), (n, g)).astype(float)


def _coords(seed=1, n=40):
    return np.random.default_rng(seed).uniform(0, 10, (n, 2))


_GENES = [f"g{i}" for i in range(30)]
_SETS = {"a": _GENES[:6], "b": _GENES[4:14], "c": _GENES[20:23], "tiny": _GENES[:1]}
_STATS = np.random.default_rng(5).standard_normal(30)

# (name, call(module) -> result); each runs on both packages' modules.
_CASES = [
    ("polar_warp", lambda m: m.polar_warp(_coords(), 0.3, np.linspace(0, 6, 40))),
    ("get_st_coordinates", lambda m: m.get_st_coordinates(
        types.SimpleNamespace(index=["12.5x7", "3x4.25", "0x0"]))),
    ("compute_distance", lambda m: m.compute_distance(_coords(1), _coords(2))),
    ("make_pinwheel", lambda m: m.make_pinwheel(0.3, 0.05, 3, 20, 0.25,
                                                rs=np.random.RandomState(3))),
    ("compute_size_factors", lambda m: m.compute_size_factors(_counts())),
    ("poisson_deviance", lambda m: m.poisson_deviance(
        _counts(), m.compute_size_factors(_counts()))),
    ("deviance_feature_selection", lambda m: m.deviance_feature_selection(
        pd.DataFrame(_counts(2).T, index=[f"gene{i}" for i in range(12)]))),
    ("deviance_residuals", lambda m: m.deviance_residuals(_counts(3), 5.0)),
    ("pearson_residuals", lambda m: m.pearson_residuals(_counts(4), 10.0)),
    ("pearson_residuals_unclipped", lambda m: m.pearson_residuals(_counts(4), 10.0,
                                                                  clipping=False)),
    ("morans_i", lambda m: m.morans_i(_coords(), _counts(), n_neighbors=5)),
    ("morans_i_test", lambda m: m.morans_i_test(_coords(), _counts(1))),
    ("landmark_distances", lambda m: m.landmark_distances(_coords(1, 8), _coords(2, 8))),
    ("bh_fdr", lambda m: m.bh_fdr(np.random.default_rng(6).uniform(0, 1, 25))),
    ("enrichment_score", lambda m: m.enrichment_score(
        np.sort(_STATS)[::-1], np.arange(30) % 4 == 0)),
    ("permutation_gsea", lambda m: m.permutation_gsea(_GENES, _STATS, _SETS, n_perm=200,
                                                      seed=1)),
    ("fisher_exact_gsea", lambda m: m.fisher_exact_gsea(_GENES[:8], _GENES, _SETS)),
]


def _assert_same(got, want):
    if isinstance(want, dict):
        assert got.keys() == want.keys()
        for k in want:
            _assert_same(got[k], want[k])
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _assert_same(g, w)
    elif isinstance(want, str):
        assert got == want
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("name,call", _CASES, ids=[c[0] for c in _CASES])
def test_numpy_utils_equal_the_jax_packages(name, call):
    _assert_same(call(tutils), call(jutils))


def test_load_gmt_equals_the_jax_packages(tmp_path):
    path = tmp_path / "sets.gmt"
    path.write_text("set1\tdesc\tg1\tg2\tg3\nset2\t\tg4\n")
    assert tutils.load_gmt(str(path)) == jutils.load_gmt(str(path))


def test_every_jax_facade_name_resolves_in_the_port():
    for name in sat.__all__:
        assert hasattr(tp, name), name
        assert name in tp.__all__, name
    for name in dir(jutils):
        if not name.startswith("_") and callable(getattr(jutils, name)):
            assert hasattr(tutils, name), name
    assert tp.core is tcore and tp.WarpGPMLE.__name__ == "WarpGPMLE"
    assert tp.polar_warp is tutils.polar_warp


def test_stragglers_match_the_jax_package(monkeypatch):
    rng = np.random.default_rng(7)
    X, Y = rng.standard_normal((5, 2)), rng.standard_normal((3, 2))
    np.testing.assert_allclose(
        tvgpsa.distance_matrix(torch.from_numpy(X), torch.from_numpy(Y)).numpy(),
        np.asarray(jvgpsa.distance_matrix(jnp.asarray(X), jnp.asarray(Y))), rtol=1e-6)
    dd = make_two_view_data(n_per_view=10, n_outputs=2)
    jm = sat.VariationalGPSA(dd, m_X_per_view=4, m_G=4, mean_function="linear",
                             mean_penalty_param=0.5)
    tm = tp.VariationalGPSA(dd, m_X_per_view=4, m_G=4, mean_function="linear",
                            mean_penalty_param=0.5, device="cpu")
    hp = {**tm.consts, **tm.params}
    want = float(jcore.mean_penalty(jm.spec, {**jm.consts, **jm.params}))
    assert abs(float(tcore.mean_penalty(tm.spec, hp)) - want) <= 1e-6 * abs(want)
    assert tm.train() is tm and tm.eval() is tm and tm.to("cpu") is tm
    A = rng.standard_normal((3, 6, 6))
    A = (A @ A.transpose(0, 2, 1) + 6 * np.eye(6)).astype(np.float32)
    # float32 factors of a well-conditioned matrix by two routines.
    np.testing.assert_allclose(
        tlinalg.safe_cholesky(torch.from_numpy(A), 1e-3).numpy(),
        np.asarray(jlinalg.safe_cholesky(jnp.asarray(A), 1e-3)), rtol=1e-5, atol=1e-6)
    # set_cholesky_impl routes the solves of every call left at "auto".
    assert tlinalg.get_cholesky_impl() == "auto"
    with pytest.raises(ValueError, match="unknown cholesky impl"):
        tlinalg.set_cholesky_impl("bogus")
    monkeypatch.setattr(tlinalg, "_CHOLESKY_IMPL", "auto")
    L = torch.linalg.cholesky(torch.from_numpy(A))
    B = torch.from_numpy(rng.standard_normal((3, 6, 2))).float()
    trisolve.plain_calls = 0
    plain = tlinalg.tri_solve(L, B)
    assert trisolve.plain_calls == 0
    tlinalg.set_cholesky_impl("pallas")
    assert tlinalg.get_cholesky_impl() == "pallas"
    routed = tlinalg.tri_solve(L, B, impl="auto")
    assert trisolve.plain_calls == 1 and torch.allclose(routed, plain, rtol=1e-5, atol=1e-6)
    tlinalg.tri_solve(L, B, impl="xla")  # an explicit impl wins
    assert trisolve.plain_calls == 1
