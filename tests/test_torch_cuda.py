"""PyTorch port on the card: the CUDA Cholesky kernel against its plain
version, and the model's loss, gradients and training loop on the card
against the same computation on the CPU.

Every test here needs a CUDA device and nvcc (the kernel is built from
``csrc/`` at first use); without a device each one skips. The file imports
neither jax nor the JAX package, so it also runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: rel 1e-4 for factors of well-conditioned (cond < ~10) float32
input, where the kernel and the plain version eliminate in other orders;
rel 1e-4 on the loss and 1e-3 on gradients between card and CPU, where
every reduction of the step runs in another order.
"""

import math

import numpy as np
import pytest
import torch

from spatial_alignment_tpu_torch import VariationalGPSA
from spatial_alignment_tpu_torch.models import core
from spatial_alignment_tpu_torch.ops import cholesky as ch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernel has no CPU or interpret mode")
    return torch.device("cuda")


def _spd(rng, B, m):
    a = rng.standard_normal((B, m, m)).astype(np.float32)
    return (a @ np.swapaxes(a, -1, -2) / m + np.eye(m, dtype=np.float32)).astype(np.float32)


def _rel(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _tiny_data():
    rng = np.random.default_rng(0)
    X1 = rng.uniform(0, 10, (40, 2)).astype(np.float32)
    X = np.concatenate([X1, X1 + 0.1 * rng.standard_normal(X1.shape).astype(np.float32)])
    Y = np.stack([np.sin(X[:, 0] * (j + 1) / 3.0) + np.cos(X[:, 1]) for j in range(3)], 1)
    return {"expression": {"spatial_coords": X, "outputs": Y.astype(np.float32),
                           "n_samples_list": [40, 40]}}


@pytest.mark.parametrize("shape", [(2, 50, 50), (34, 50, 50), (14, 200, 200), (2, 256, 256)])
def test_cuda_kernel_matches_plain(cuda_device, shape):
    """Kernel vs plain version on the card: rel 1e-4 on well-conditioned
    input, the NaN contract, and one launch counted per call."""
    A = torch.from_numpy(_spd(np.random.default_rng(6), shape[0], shape[-1])).to(cuda_device)
    A[0] -= 3.0 * torch.eye(shape[-1], device=cuda_device)  # an indefinite lane
    before = ch.launches
    Lk = ch.cholesky_kernel(A)
    torch.cuda.synchronize()
    assert ch.launches == before + 1
    Lp = ch.cholesky_plain(A)
    lower = torch.tril(torch.ones(shape[-1], shape[-1], dtype=torch.bool, device=cuda_device))
    assert torch.isnan(Lk[0][lower]).all()
    assert (Lk[0][~lower] == 0).all()
    assert _rel(Lk[1:], Lp[1:]) <= 1e-4
    assert torch.count_nonzero(torch.triu(Lk[1:], 1)) == 0


def test_cuda_cholesky_gradient_matches_cpu(cuda_device):
    A = torch.from_numpy(_spd(np.random.default_rng(7), 3, 60))
    W = torch.from_numpy(np.random.default_rng(8).standard_normal(A.shape).astype(np.float32))
    grads = []
    for dev in (cuda_device, torch.device("cpu")):
        a = A.to(dev).requires_grad_(True)
        (ch.cholesky(a) * W.to(dev)).sum().backward()
        grads.append(a.grad)
    assert _rel(grads[0], grads[1]) <= 1e-3


def test_cuda_negative_elbo_matches_cpu(cuda_device):
    dd = _tiny_data()
    kw = dict(m_X_per_view=16, m_G=16, n_latent_gps={"expression": 2}, fixed_view_idx=0)
    S = 3
    rng = np.random.default_rng(1)
    wn = torch.from_numpy(rng.standard_normal((S, 2, 40, 2)).astype(np.float32))
    dn = torch.from_numpy(rng.standard_normal((S, 80, 2)).astype(np.float32))
    out = []
    for dev in (torch.device("cpu"), cuda_device):
        m = VariationalGPSA(dd, device=dev, **kw)
        with torch.no_grad():  # moderate lengthscales keep the Grams well conditioned
            m.params["warp_kernel_lengthscales"].fill_(math.log(2.0))
            m.params["data_kernel_lengthscale"].fill_(math.log(2.0))
        loss = core.negative_elbo(m.spec, m.params, m.consts, m._batch, S,
                                  warp_noise=wn.to(dev), data_noise={"expression": dn.to(dev)})
        loss.backward()
        out.append((loss.detach(), [p.grad for p in m.parameters()]))
    (lc, gc), (lg, gg) = out
    assert _rel(lg, lc) <= 1e-4
    for g, c in zip(gg, gc):
        assert _rel(g, c) <= 1e-3


def test_cuda_fit_launches_the_kernel_every_step(cuda_device):
    model = VariationalGPSA(_tiny_data(), m_X_per_view=16, m_G=16, fixed_view_idx=0,
                            device=cuda_device)
    ch.launches, ch.plain_calls = 0, 0
    losses = model.fit(n_epochs=5, S=2)
    assert np.isfinite(losses).all()
    assert ch.launches == 2 * 5  # the jitter probe and the final factorization
    assert ch.plain_calls == 0
