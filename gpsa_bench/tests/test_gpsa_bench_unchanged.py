"""The three accepted cells read what they read before configurations
could have several modalities: at ``conftest.small`` sizes, the data, the
starting parameters, the reference's losses over set-up's first steps and
its first-gradient norms equal, bit for bit, the values recorded with the
same arithmetic on the parent commit ``PARENT`` (where
``datagen.make_data`` gave one (coordinates, outputs, counts) triple and
``harness.make_init`` took the coordinates and counts); and
``work.step.step_flops`` at each cell's full sizes equals the parent's, so
``step_mfu`` reads the same."""

import hashlib

import pytest

from conftest import small

PARENT = "58b6d521701798ff02ae400676e104ae5592cd0f"
SEED = 3000000017
RECORDED = {
    "visium_m200.fit": {
        "data": [
            "13b6485c36ff9ae9a975e4d2",
            [144, 144]
        ],
        "init": "69fb6cfd9e6c342a866a4d30",
        "losses": [341113.1265158057, 323696.4587077116, 328918.7484372313],
        "grad_norms": {
            "noise_variance": 684017.7455702907,
            "warp_kernel_variances": 2798.713582842225,
            "warp_kernel_lengthscales": 4145.820605290917,
            "data_kernel_lengthscale": 8155.618050355865,
            "data_kernel_variance": 176470.11244935804,
            "Xtilde": 6686.0573264022105,
            "Gtilde": 11604.820619803233,
            "delta_G": 3768.7833231850923,
            "Omega_sqt_G": 1324.836457975222,
            "Omega_sqt_F/expression": 3309.7957069232416,
            "delta_F/expression": 8371.525422809389,
            "W/expression": 92554.04862567238
        },
        "step_flops": 53729937550.0
    },
    "spots100k_m100.fit_minibatch": {
        "data": [
            "7a52c12117b715652422d5b8",
            [576, 576]
        ],
        "init": "02b56ce327a74da4f11056b9",
        "losses": [19382.671440885933, 18729.93642315474, 17984.155507365576],
        "grad_norms": {
            "noise_variance": 20833.575185811413,
            "warp_kernel_variances": 314.4263392347025,
            "warp_kernel_lengthscales": 316.0898210018251,
            "data_kernel_lengthscale": 835.6644340622556,
            "data_kernel_variance": 7267.815778758882,
            "Xtilde": 448.3714637283841,
            "Gtilde": 808.5765224051762,
            "delta_G": 418.6685642216448,
            "Omega_sqt_G": 226.63307578263434,
            "Omega_sqt_F/expression": 310.48000818001566,
            "delta_F/expression": 1106.7010667319248,
            "W/expression": 4996.170787646274
        },
        "step_flops": 27209577632.0
    },
    "visium_m200.fit_kernels": {
        "data": [
            "13b6485c36ff9ae9a975e4d2",
            [144, 144]
        ],
        "init": "69fb6cfd9e6c342a866a4d30",
        "losses": [341113.1265158057, 323696.4587077116, 328918.7484372313],
        "grad_norms": {
            "noise_variance": 684017.7455702907,
            "warp_kernel_variances": 2798.713582842225,
            "warp_kernel_lengthscales": 4145.820605290917,
            "data_kernel_lengthscale": 8155.618050355865,
            "data_kernel_variance": 176470.11244935804,
            "Xtilde": 6686.0573264022105,
            "Gtilde": 11604.820619803233,
            "delta_G": 3768.7833231850923,
            "Omega_sqt_G": 1324.836457975222,
            "Omega_sqt_F/expression": 3309.7957069232416,
            "delta_F/expression": 8371.525422809389,
            "W/expression": 92554.04862567238
        },
        "step_flops": 53729937550.0
    }
}


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().cpu().contiguous()
        h.update(str((t.dtype, tuple(t.shape))).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()[:24]


@pytest.mark.parametrize("cell", list(RECORDED))
def test_data_start_and_reference_are_the_parents(harness, cell):
    from gpsa_bench import datagen, reference

    r = small(harness.resolve(cell))
    cfg, traffic = r["config"], r["traffic"]
    data = datagen.make_data(cfg, SEED, "cpu")
    assert list(data) == ["expression"]
    (X, Y, nsl), = data.values()
    init = harness.make_init(cfg, data, SEED)
    with harness._tf32_off():
        losses, grads, _ = harness.entry(traffic).follow(init, data, cfg, traffic, SEED,
                                                         reference.Precision())
    want = RECORDED[cell]
    assert [_digest([X, Y]), list(nsl)] == want["data"]
    assert _digest([init[k] for k in sorted(init)]) == want["init"]
    assert losses == want["losses"]
    assert {k: float(g.norm()) for k, g in grads.items()} == want["grad_norms"]


@pytest.mark.parametrize("cell", list(RECORDED))
def test_step_flops_at_full_size_are_the_parents(harness, cell):
    from gpsa_bench.work import step

    r = harness.resolve(cell)
    assert step.step_flops(r["config"], r["traffic"]) == RECORDED[cell]["step_flops"]


@pytest.mark.cuda
def test_the_start_repeats_on_the_card(harness):
    """At one seed, the start at ``visium_m200``'s full size is the same
    twice, bit for bit (the k-means centres' sums are taken on the host)."""
    import torch

    from gpsa_bench import datagen

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cfg = harness.resolve("visium_m200.fit")["config"]
    data = datagen.make_data(cfg, 7, "cuda")
    first, second = (harness.make_init(cfg, data, 7) for _ in range(2))
    assert all(torch.equal(first[k], second[k]) for k in first)
