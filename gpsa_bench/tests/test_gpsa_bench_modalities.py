"""Configurations with several modalities, and modalities without LMC
(the schema in ``datagen.py``), defined here and not in ``configs/``: at
CPU sizes a sound run through ``harness.setup``, the entry's first steps
and ``readings`` stays under the tightest limit the accepted cells set for
each number, and each planted fault breaks one."""

import copy
import json
import time
import types

import pytest
import torch

from conftest import ROOT, small

from gpsa_bench import byname, datagen

ACCEPTED = ("visium_m200.fit", "spots100k_m100.fit_minibatch", "visium_m200.fit_kernels")
GENERATOR = "two_modalities_test"
# Two views; uneven counts by modality and by view; A through LMC, B without.
SHAPES = {"A": ([40, 33], 6, 3), "B": ([25, 31], 3, None)}


def _tightest() -> dict:
    """Each number's smallest limit over the accepted cells' limits files."""
    out = {}
    for cell in ACCEPTED:
        for k, v in json.loads((ROOT / "gpsa_bench" / "limits" / f"{cell}.json").read_text()).items():
            out[k] = min(v, out.get(k, v))
    return out


def _make(data, gen, device):
    """Uniform spots on [0, 10]^2 a view, view 1 moved by a smooth warp,
    each modality's outputs smooth functions of the unwarped spot."""
    out = {}
    for mod, (nsl, P, _) in SHAPES.items():
        X, Y = [], []
        j = torch.arange(P, device=device)
        for v, n in enumerate(nsl):
            base = 10.0 * torch.rand((n, 2), generator=gen, device=device)
            warp = 0.4 * torch.stack([torch.sin(base[:, 0] / 2.0 + 1.0),
                                      torch.cos(base[:, 1] / 2.0)], 1)
            X.append(base + v * warp)
            Y.append(torch.sin(base[:, :1] * ((j % 3 + 1) / 3.0))
                     + torch.cos(base[:, 1:] * ((j % 2 + 1) / 2.0)))
        out[mod] = (torch.cat(X), torch.cat(Y), list(nsl))
    return out


@pytest.fixture
def two_modalities_generator(monkeypatch):
    module = types.ModuleType(GENERATOR)
    module.make, module.SPATIAL_DIMS = _make, 2
    module.points_per_view = lambda data: {mod: nsl for mod, (nsl, _, _) in SHAPES.items()}
    monkeypatch.setitem(byname._loaded, ("generators", GENERATOR), module)


def _two_modalities(harness) -> dict:
    """``visium_m200.fit`` with the two modalities of SHAPES, m = 16, three
    noise terms, S = 2, three epochs a call."""
    r = copy.deepcopy(harness.resolve(ACCEPTED[0]))
    cfg = r["config"]
    cfg["name"] = "two_modalities"
    cfg["data"] = {"generator": GENERATOR,
                   "n_outputs": {mod: P for mod, (_, P, _) in SHAPES.items()}}
    cfg["model"].update(m_X_per_view=16, m_G=16, n_noise_variance_params=3,
                        n_latent_gps={mod: L for mod, (_, _, L) in SHAPES.items()})
    cfg["train"]["S"] = 2
    r["traffic"]["n_epochs"] = 3
    return r


def _without_lmc(harness) -> dict:
    """``visium_m200.fit`` at CPU size with its one modality without LMC."""
    r = small(harness.resolve(ACCEPTED[0]))
    r["config"]["model"]["n_latent_gps"] = {"expression": None}
    return r


CONFIGS = {"two_modalities": _two_modalities, "expression_without_lmc": _without_lmc}


def _run(harness, name, seed=5):
    r = CONFIGS[name](harness)
    r["limits"] = _tightest()
    return harness.run_cell(name, seed, 0.2, False, time.perf_counter(), device="cpu",
                            resolved=r)


@pytest.fixture
def noise_index_swapped(monkeypatch):
    """Each modality's likelihood reads the other modality's noise term:
    the last M entries of ``noise_variance`` reversed where the loss takes
    the parameters."""
    from spatial_alignment_tpu_torch.models import core

    elbo = core.negative_elbo

    def swapped(spec, params, *args, **kwargs):
        M, nv = spec.n_modalities, params["noise_variance"]
        params = {**params, "noise_variance": torch.cat([nv[:-M], nv[-M:].flip(0)])}
        return elbo(spec, params, *args, **kwargs)

    monkeypatch.setattr(core, "negative_elbo", swapped)


@pytest.mark.usefixtures("two_modalities_generator")
@pytest.mark.parametrize("name", list(CONFIGS))
def test_a_sound_run_is_within_the_tightest_limits(harness, name):
    out = _run(harness, name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 3 and out["failed"] == 0
    assert set(out["checks"]) == set(_tightest())


@pytest.mark.usefixtures("two_modalities_generator")
@pytest.mark.parametrize("name, fault", [
    ("two_modalities", "half_batch"), ("two_modalities", "warp_mean_altered"),
    ("two_modalities", "noise_index_swapped"), ("expression_without_lmc", "half_batch"),
    ("expression_without_lmc", "warp_mean_altered")])
def test_a_planted_fault_breaks_a_limit(harness, name, fault, request):
    request.getfixturevalue(fault)
    out = _run(harness, name)
    assert not out["correct"], out["checks"]


@pytest.mark.usefixtures("two_modalities_generator")
def test_the_modalities_reach_the_model_and_the_start(harness):
    """The model gets each modality with its LMC or none and the three
    noise terms; the start has a W for A only, Xtilde from each view's
    points of both modalities."""
    r = _two_modalities(harness)
    data = datagen.make_data(r["config"], 5, "cpu")
    assert list(data) == ["A", "B"]
    init = harness.make_init(r["config"], data, 5)
    model = harness.build_model(r["config"], r["traffic"], data, 5, torch.device("cpu"))
    harness.install(model, init)
    assert [(m.name, m.n_latent, m.use_lmc) for m in model.spec.modalities] == [
        ("A", 3, True), ("B", 3, False)]
    assert init["noise_variance"].shape == (3,)
    assert "W/A" in init and "W/B" not in init
    assert init["Omega_sqt_F/B"].shape == (3, 16, 16) and init["delta_F/B"].shape == (16, 3)


@pytest.mark.usefixtures("two_modalities_generator")
def test_the_generator_must_give_what_the_configuration_states(harness):
    """Its modalities in the model's order, and the counts and widths that
    the work counts read from the configuration."""
    cfg = _two_modalities(harness)["config"]
    cfg["model"]["n_latent_gps"] = {"B": None, "A": 3}
    with pytest.raises(ValueError, match="modalities"):
        datagen.make_data(cfg, 5, "cpu")
    cfg = _two_modalities(harness)["config"]
    cfg["data"]["n_outputs"]["B"] = 4  # the generator makes 3
    with pytest.raises(ValueError, match="configuration states"):
        datagen.make_data(cfg, 5, "cpu")
