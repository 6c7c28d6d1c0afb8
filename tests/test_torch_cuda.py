"""PyTorch port on the card: each CUDA kernel (Cholesky, triangular solve,
quad-diag forward and backward, fused factor and inverse, cross-Gram)
against its plain version, and the model's loss, gradients and training
loop on the card against the same computation on the CPU, with the default
knobs, with the three kernel opt-ins and with the Gram switch.

Every test here needs a CUDA device and nvcc (the kernels are built from
``csrc/`` at first use); without a device each one skips. The file imports
neither jax nor the JAX package, so it also runs where only the port's
dependencies are installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Tolerances: rel 1e-4 for factors of well-conditioned (cond < ~10) float32
input, where the kernel and the plain version eliminate in other orders,
and likewise for solves, inverses and quad-diag sums (float32 sums of m
products in another order); rel 1e-4 on the loss and 1e-3 on gradients
between card and CPU, where every reduction of the step runs in another
order. The Gram kernel repeats its plain version's float32 operations in
the same order, so only the exp and sqrt of two libraries differ: rel 1e-5;
against the same arithmetic in float64, rel 1e-6. The expansion form
|x|^2 + |z|^2 - 2 x.z cancels: with |x|^2 <= 200 its squared distance is off
by up to about 6 * 2^-24 * 400 = 1.4e-4, which moves K / var by up to
1.4e-4 / (2 l^2) for rbf and three times that for matern32 (l >= e^-0.5:
2e-4 and 6e-4; held at 1e-3), and by sqrt(1.4e-4) / (2 l) = 1e-2 for
matern12, whose distance is the square root of the cancelled sum.
"""

import math

import numpy as np
import pytest
import torch

from spatial_alignment_tpu_torch import VariationalGPSA
from spatial_alignment_tpu_torch.models import core
from spatial_alignment_tpu_torch.ops import cholesky as ch
from spatial_alignment_tpu_torch.ops import factor, quad
from spatial_alignment_tpu_torch.ops import gram as gm
from spatial_alignment_tpu_torch.ops import trisolve as ts

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


def _factor(rng, B, m):
    return np.linalg.cholesky(_spd(rng, B, m).astype(np.float64)).astype(np.float32)


def _tiny_data():
    rng = np.random.default_rng(0)
    X1 = rng.uniform(0, 10, (40, 2)).astype(np.float32)
    X = np.concatenate([X1, X1 + 0.1 * rng.standard_normal(X1.shape).astype(np.float32)])
    Y = np.stack([np.sin(X[:, 0] * (j + 1) / 3.0) + np.cos(X[:, 1]) for j in range(3)], 1)
    return {"expression": {"spatial_coords": X, "outputs": Y.astype(np.float32),
                           "n_samples_list": [40, 40]}}


# The path's slabs, then ragged sizes: the edges of the 32-column panels
# (1, 31, 32, 33, 65), the 100k fit's m = 100, the last sizes of the
# shared-memory design (238 to 240), then the panel design above it (241,
# 256, 300, the m = 384 fit's slab, 512) and, past the largest panel shared
# memory holds (m = 1,160), the panel in global memory (1,201, 1,760); m not
# a multiple of 4 (241, 1,201) takes scalar loads.
_CHOL_SHAPES = [(2, 50, 50), (34, 50, 50), (14, 200, 200), (2, 256, 256), (14, 384, 384)] + [
    (5, m, m) for m in (1, 31, 32, 33, 65, 100, 200, 238, 239, 240, 241, 256, 300, 384, 512,
                        1201, 1760)]


@pytest.mark.parametrize("shape", _CHOL_SHAPES)
def test_cuda_kernel_matches_plain(cuda_device, shape):
    """Kernel vs plain version on the card: rel 1e-4 on well-conditioned
    input, the NaN contract (an indefinite lane, and with a batch of 5
    lanes whose failing pivot lies in the first, a middle and the last
    panel), one launch counted per call, two launches bit-equal, and L
    equal bit for bit to the column recurrence's (the reference entry) and
    to the fused factor's, at every m."""
    m = shape[-1]
    A = torch.from_numpy(_spd(np.random.default_rng(6), shape[0], m)).to(cuda_device)
    A[0] -= 3.0 * torch.eye(m, device=cuda_device)  # an indefinite lane
    if m == 1:
        A[0] = -1.0  # a 1 x 1 draw a^2 + 1 - 3 may stay positive
    bad = [0]
    if shape[0] >= 5:
        for lane, p in zip((1, 2, 3), (0, m // 2, m - 1)):
            A[lane, p, p] = -5.0
        bad += [1, 2, 3]
    assert ch.uses_shared_memory(m) == (m <= 240)
    assert ch.design(m) == ("smem" if m <= 240 else "panel_smem" if m <= 1160 else "panel_global")
    before = ch.launches
    Lk = ch.cholesky_kernel(A)
    Lk2 = ch.cholesky_kernel(A)
    torch.cuda.synchronize()
    assert ch.launches == before + 2
    assert torch.equal(Lk.view(torch.int32), Lk2.view(torch.int32))
    Lr = ch.cholesky_recurrence(A)
    Lf, _ = factor.cholesky_and_inverse_kernel(A)
    torch.cuda.synchronize()
    assert ch.launches == before + 2  # the reference counts no launch
    assert torch.equal(Lk.view(torch.int32), Lr.view(torch.int32))
    assert torch.equal(Lk.view(torch.int32), Lf.view(torch.int32))
    lower = torch.tril(torch.ones(m, m, dtype=torch.bool, device=cuda_device))
    for lane in bad:
        assert torch.isnan(Lk[lane][lower]).all()
        assert (Lk[lane][~lower] == 0).all()
    good = Lk[len(bad):]
    assert torch.isfinite(good).all()
    assert _rel(good, ch.cholesky_plain(A[len(bad):])) <= 1e-4
    assert torch.count_nonzero(torch.triu(good, 1)) == 0


@pytest.mark.parametrize("m", [241, 384, 512])
def test_cuda_panel_cluster_sizes_agree(cuda_device, m):
    """The Cholesky's panel design with 1, 2, 4 and 8 thread blocks a
    matrix (a cluster sharing the panel) gives the same L bit for bit, the
    recurrence's: every element takes the same operations in the same order
    whichever block does them, and a failing lane is NaN in every one. The
    kernel's own choice: a cluster of 4 from m = 384 on while the batch's
    clusters fit the card, else one block."""
    A = torch.from_numpy(_spd(np.random.default_rng(15), 5, m)).to(cuda_device)
    A[1, m // 2, m // 2] = -5.0  # a failing lane
    Lr = ch.cholesky_recurrence(A)
    assert ch.blocks_per_matrix(5, m) == (4 if m >= 384 else 1)
    assert ch.blocks_per_matrix(1000, m) == 1
    lower = torch.tril(torch.ones(m, m, dtype=torch.bool, device=cuda_device))
    for blocks in (1, 2, 4, 8):
        L = ch.cholesky_kernel(A, blocks=blocks)
        torch.cuda.synchronize()
        assert torch.equal(L.view(torch.int32), Lr.view(torch.int32)), blocks
        assert torch.isnan(L[1][lower]).all()


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


@pytest.mark.parametrize("opt_ins", [False, True], ids=["default", "opt_ins"])
def test_cuda_m384_fit_launches_the_kernels_every_step(cuda_device, opt_ins):
    """The m = 384 model (the panel designs of the Cholesky and the fused
    factor) fits with the kernels launched every step and no plain call:
    2 Cholesky launches a step by default; with the three opt-ins 1
    Cholesky, 1 fused factor, 8 solves, 2 quad-diag forward and 2 backward."""
    rng = np.random.default_rng(14)
    X1 = rng.uniform(0, 10, (400, 2)).astype(np.float32)
    X = np.concatenate([X1, X1 + 0.1 * rng.standard_normal(X1.shape).astype(np.float32)])
    Y = np.stack([np.sin(X[:, 0] * (j + 1) / 3.0) + np.cos(X[:, 1]) for j in range(3)], 1)
    dd = {"expression": {"spatial_coords": X, "outputs": Y.astype(np.float32),
                         "n_samples_list": [400, 400]}}
    model = VariationalGPSA(dd, m_X_per_view=384, m_G=384, n_latent_gps={"expression": 2},
                            fixed_view_idx=0, device=cuda_device,
                            **(OPT_INS if opt_ins else {}))
    assert model.spec.svgp_solve_mode == "mixed"
    ch.launches = ch.plain_calls = factor.launches = factor.plain_calls = 0
    ts.launches = ts.plain_calls = quad.fwd_launches = quad.bwd_launches = quad.plain_calls = 0
    losses = model.fit(n_epochs=3, S=2)
    assert np.isfinite(losses).all()
    per_step = (1, 1, 8, 2, 2) if opt_ins else (2, 0, 0, 0, 0)
    got = (ch.launches, factor.launches, ts.launches, quad.fwd_launches, quad.bwd_launches)
    assert got == tuple(3 * k for k in per_step)
    assert ch.plain_calls == factor.plain_calls == ts.plain_calls == quad.plain_calls == 0


OPT_INS = dict(cholesky_impl="pallas", quad_diag_impl="pallas", fused_factor_inverse="fused")

# The main path's solves (warp and data layers of the m = 200 fit), the
# m = 50 fit's width-N solves, then ragged sizes across the 32-row panels and
# the 32-column tiles, one factor per matrix and one shared by the batch:
# (L shape, B shape).
_SOLVES = [((1, 200, 200), (1, 200, 2)), ((200, 200), (200, 10)), ((50, 50), (5, 50, 200)),
           ((1, 50, 50), (1, 50, 100))]
_SOLVES += [((2, m, m), (2, m, n)) for m in (1, 31, 32, 33, 100, 200) for n in (1, 2, 10, 32, 33)]
_SOLVES += [((m, m), (3, m, n)) for m in (33, 200) for n in (2, 33)]
# Where two staged panels and the tile overrun a block's shared memory
# (m > 592 against 32 columns, m > 854 against 2), L is read from global
# memory.
_SOLVES += [((1, 600, 600), (1, 600, 33)), ((1, 900, 900), (1, 900, 2))]


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("l_shape,b_shape", _SOLVES)
def test_cuda_trisolve_matches_plain(cuda_device, l_shape, b_shape, trans):
    """Kernel vs plain version, one launch counted per call, two launches
    bit-equal; with one factor per matrix, a zero (forward) or NaN
    (transposed) pivot in the first matrix spreads through that matrix only,
    and the others are the clean solve's bit for bit."""
    rng = np.random.default_rng(9)
    m = l_shape[-1]
    L = torch.from_numpy(_factor(rng, math.prod(l_shape[:-2]), m).reshape(l_shape)).to(cuda_device)
    B = torch.from_numpy(rng.standard_normal(b_shape).astype(np.float32)).to(cuda_device)
    L = L.expand(b_shape[:-2] + L.shape[-2:])
    assert ts.uses_shared_memory(m, b_shape[-1]) == (m < 600)
    before = ts.launches
    X = ts.tri_solve_kernel(L, B, trans)
    X2 = ts.tri_solve_kernel(L, B, trans)
    torch.cuda.synchronize()
    assert ts.launches == before + 2
    assert torch.equal(X.view(torch.int32), X2.view(torch.int32))
    assert _rel(X, ts.tri_solve_plain(L, B, trans)) <= 1e-4
    if len(l_shape) == 3 and l_shape[0] > 1:
        Lbad = L.clone()
        Lbad[0, m // 2, m // 2] = float("nan") if trans else 0.0
        Xb = ts.tri_solve_kernel(Lbad, B, trans)
        Xp = ts.tri_solve_plain(Lbad, B, trans)
        torch.cuda.synchronize()
        assert not torch.isfinite(Xb[0]).all() and not torch.isfinite(Xp[0]).all()
        assert torch.equal(Xb[1:].view(torch.int32), X[1:].view(torch.int32))


@pytest.mark.parametrize("pivot", [float("nan"), 0.0])
@pytest.mark.parametrize("shape", [(2, 200, 200), (2, 50, 50), (2, 1, 1), (2, 31, 31),
                                   (2, 33, 33), (2, 100, 100)])
def test_cuda_tri_inverse_matches_plain(cuda_device, shape, pivot):
    m = shape[-1]
    L = torch.from_numpy(_factor(np.random.default_rng(10), shape[0], m)).to(cuda_device)
    L[0, min(5, m - 1), min(5, m - 1)] = pivot  # a bad pivot stays in its lane
    Inv = ts.tri_inverse_kernel(L)
    torch.cuda.synchronize()
    assert not torch.isfinite(Inv[0]).all()
    assert _rel(Inv[1:], ts.tri_inverse_plain(L[1:])) <= 1e-4
    assert torch.count_nonzero(torch.triu(Inv[1:], 1)) == 0


@pytest.mark.parametrize("scale_exp", [-80, 80])
@pytest.mark.parametrize("m", [33, 50, 200, 600])
def test_cuda_ieee_redo_matches_the_fast_path(cuda_device, m, scale_exp):
    """Input scaled by 2^(+-80) puts the divisions' operands outside the
    range of the branch-free fast paths (common.cuh div_rn), so the
    Cholesky, the fused factor and the solves redo their steps with IEEE
    operations. Scaling by a power of two is exact (every value stays
    normal), so the results must be the unscaled ones scaled, bit for bit:
    the fast path and the redo both round as IEEE division and square root.
    At m = 600 the solve reads L from global memory."""
    rng = np.random.default_rng(11)
    A = torch.from_numpy(_spd(rng, 3, m)).to(cuda_device)
    B = torch.from_numpy(rng.standard_normal((3, m, 33)).astype(np.float32)).to(cuda_device)
    s, r = 2.0**scale_exp, 2.0 ** (scale_exp // 2)  # A's scale, and its factor's

    def same(a, b):
        return torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))

    L = ch.cholesky_kernel(A)
    assert same(ch.cholesky_kernel(A * s), L * r)
    Lf, W = factor.cholesky_and_inverse_kernel(A)
    Lfs, Ws = factor.cholesky_and_inverse_kernel(A * s)
    assert same(Lfs, Lf * r) and same(Ws, W / r)
    for trans in (False, True):
        X = ts.tri_solve_kernel(L, B, trans)
        assert same(ts.tri_solve_kernel(L * s, B * s, trans), X)
    assert same(ts.tri_inverse_kernel(L * s), ts.tri_inverse_kernel(L) / s)


# The quad-diag's forms on the path: data layer (S, N, m) with shared
# (L, m, m), warp layer (V, N, m) with per-view (V, D, m, m), the m = 50
# fit's warp layer; then ragged shapes across the forward's 64-point and
# 64-column tiles and its depth stages of 32 (m = 37 and 50 are not
# multiples of 4 or 8: 4-byte copies, zero-filled edges), per group; the
# backward's 128-row blocks and 32-deep chunks (N = 130, m = 37 and 200
# end inside a chunk), each of its column-tile widths (m up to 64, 128,
# 200 and 256), an odd channel count; above m = 256, where two warps share
# each group of 16 rows of a 64-row block (m up to 384, and up to 512 with
# one chunk buffer), m = 257, 300, 301, 320, the m = 384 fit's data and
# warp layers, 385 and 512, both forms, ragged N (77, 130, 333: not a
# multiple of 64), odd L; and m = 520, past the tensor-core backward's
# widest m (the wide variant).
_QUADS = [((5, 8100, 200), (10, 200, 200)), ((1, 4050, 200), (1, 2, 200, 200)),
          ((5, 200, 50), (30, 50, 50)), ((1, 100, 50), (1, 2, 50, 50)),
          ((3, 130, 37), (3, 1, 37, 37)), ((3, 4050, 37), (3, 1, 37, 37)),
          ((3, 130, 50), (3, 1, 50, 50)), ((3, 4050, 200), (3, 1, 200, 200)),
          ((3, 130, 200), (3, 1, 200, 200)), ((2, 333, 129), (3, 129, 129)),
          ((2, 333, 256), (3, 256, 256)), ((2, 77, 300), (3, 300, 300)),
          ((3, 130, 301), (3, 3, 301, 301)),
          ((2, 77, 257), (3, 257, 257)), ((3, 130, 257), (3, 1, 257, 257)),
          ((2, 333, 320), (3, 320, 320)), ((3, 200, 320), (3, 2, 320, 320)),
          ((5, 4050, 384), (10, 384, 384)), ((1, 2025, 384), (1, 2, 384, 384)),
          ((2, 77, 384), (3, 384, 384)), ((3, 130, 385), (3, 3, 385, 385)),
          ((2, 77, 385), (1, 385, 385)), ((2, 130, 512), (3, 512, 512)),
          ((3, 77, 512), (3, 1, 512, 512)), ((2, 77, 520), (1, 520, 520))]


@pytest.mark.parametrize("transposed", [False, True])
@pytest.mark.parametrize("x_shape,f_shape", _QUADS)
def test_cuda_quad_matches_plain(cuda_device, x_shape, f_shape, transposed):
    """Forward and backward (3xTF32 tensor cores) against the plain
    versions, and two launches of each on the same input bit-equal; x by
    rows, or a transposed view as the model passes it (read in place)."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.standard_normal(x_shape).astype(np.float32)).to(cuda_device)
    if transposed:
        x = x.transpose(-1, -2).contiguous().transpose(-1, -2)
    F = torch.from_numpy((0.1 * rng.standard_normal(f_shape)).astype(np.float32)).to(cuda_device)
    dy = torch.from_numpy(
        rng.standard_normal((x_shape[0], f_shape[-3], x_shape[1])).astype(np.float32)
    ).to(cuda_device)
    f0, b0 = quad.fwd_launches, quad.bwd_launches
    y = quad.quad_fwd_kernel(x, F)
    y2 = quad.quad_fwd_kernel(x, F)
    dx, dF = quad.quad_bwd_kernel(x, F, dy)
    dx2, dF2 = quad.quad_bwd_kernel(x, F, dy)
    torch.cuda.synchronize()
    assert (quad.fwd_launches, quad.bwd_launches) == (f0 + 2, b0 + 2)
    assert torch.equal(y, y2)
    assert torch.equal(dx.view(torch.int32), dx2.view(torch.int32))
    assert torch.equal(dF.view(torch.int32), dF2.view(torch.int32))
    assert _rel(y, quad.quad_diag_plain(x, F)) <= 1e-4
    dx_p, dF_p = quad.quad_bwd_plain(x, F, dy)
    assert _rel(dx, dx_p) <= 1e-4
    assert _rel(dF, dF_p) <= 1e-4


# (x shape, F shape, the design's expected values): m = 200 keeps one warp
# a group of 16 rows (25 column tiles, 128-row blocks, three chunk
# buffers); the m = 384 fit's data and warp layers take
# 48 column tiles over two warps a row group, 64-row blocks, two buffers;
# m = 512 one buffer; above, the wide variant (no column tiles).
_QUAD_DESIGNS = [
    ((5, 4050, 200), (10, 200, 200),
     dict(column_tiles=25, block_rows=128, chunk=32, row_group_warps=1, stages_dx=3, stages_df=3)),
    ((1, 2025, 200), (1, 2, 200, 200),
     dict(column_tiles=25, block_rows=128, chunk=32, row_group_warps=1, stages_dx=3, stages_df=3)),
    ((5, 4050, 384), (10, 384, 384),
     dict(column_tiles=48, block_rows=64, chunk=32, row_group_warps=2, stages_dx=2, stages_df=2)),
    ((1, 2025, 384), (1, 2, 384, 384),
     dict(column_tiles=48, block_rows=64, chunk=32, row_group_warps=2, stages_dx=2, stages_df=2)),
    ((2, 130, 512), (3, 512, 512),
     dict(column_tiles=64, block_rows=64, chunk=32, row_group_warps=2, stages_dx=1, stages_df=1)),
    ((2, 77, 520), (1, 520, 520), dict(column_tiles=0, block_rows=64, chunk=64)),
]


@pytest.mark.parametrize("x_shape,f_shape,want", _QUAD_DESIGNS)
def test_cuda_quad_bwd_design(cuda_device, x_shape, f_shape, want):
    """What the backward launches (``bwd_design``) by m: the tensor-core
    design through m = 512, split over blocks so that the m = 384 warp
    layer's 32 row blocks fill the card."""
    G, N, m = x_shape
    n_groups = G if len(f_shape) == 4 else 1
    design = quad.bwd_design(G, N, m, f_shape[-3], n_groups)
    assert {k: design[k] for k in want} == want
    if want["column_tiles"]:
        assert design["blocks_per_sm_dx"] >= 1 and design["blocks_per_sm_df"] >= 1
    if x_shape == (1, 2025, 384):
        assert design["splits_dx"] > 1 and design["splits_df"] > 1


# The path's slabs, the edges of the shared-memory design's 32-column
# panels (1, 31, 32, 33, 65), the m = 100 slab, its largest size (240),
# then the panel design (241, 256, 300, the m = 384 fit's slab, 512) and,
# past the largest pair of panels shared memory holds (m = 596), the panels
# in global memory (600, 601, 900); m not a multiple of 4 (241, 601) takes
# scalar loads.
@pytest.mark.parametrize("shape", [(14, 200, 200), (34, 50, 50), (4, 256, 256), (5, 1, 1),
                                   (5, 31, 31), (5, 32, 32), (5, 33, 33), (5, 65, 65),
                                   (5, 100, 100), (5, 240, 240), (5, 241, 241), (5, 256, 256),
                                   (5, 300, 300), (14, 384, 384), (5, 512, 512),
                                   (5, 600, 600), (5, 601, 601), (5, 900, 900)])
def test_cuda_factor_matches_plain(cuda_device, shape):
    """Kernel vs plain version; indefinite lanes whose failing pivot lies in
    the first, a middle and the last panel; two launches bit-equal; L equal
    bit for bit to the column recurrence's; |L L^-1 - I| <= 1e-5."""
    m = shape[-1]
    A = torch.from_numpy(_spd(np.random.default_rng(12), shape[0], m)).to(cuda_device)
    failing = [0, m // 2, m - 1]  # pivots: lanes 0, 1 and 2 fail there
    for lane, p in enumerate(failing):
        A[lane, p, p] = -5.0
    assert factor.uses_shared_memory(m) == (m <= 240)
    assert factor.design(m) == ("smem" if m <= 240 else "panel_smem" if m <= 596
                                else "panel_global")
    before = factor.launches
    L, Linv = factor.cholesky_and_inverse_kernel(A)
    L2, Linv2 = factor.cholesky_and_inverse_kernel(A)
    torch.cuda.synchronize()
    assert factor.launches == before + 2
    assert torch.equal(L.view(torch.int32), L2.view(torch.int32))
    assert torch.equal(Linv.view(torch.int32), Linv2.view(torch.int32))
    assert torch.equal(L.view(torch.int32), ch.cholesky_recurrence(A).view(torch.int32))
    lower = torch.tril(torch.ones(m, m, dtype=torch.bool, device=cuda_device))
    n_bad = len(failing)
    for out in (L, Linv):
        for lane in range(n_bad):
            assert torch.isnan(out[lane][lower]).all()
            assert (out[lane][~lower] == 0).all()
        assert torch.isfinite(out[n_bad:]).all()
    Lp, Linvp = factor.cholesky_and_inverse_plain(A[n_bad:])
    assert _rel(L[n_bad:], Lp) <= 1e-4
    assert _rel(Linv[n_bad:], Linvp) <= 1e-4
    eye = torch.eye(m, dtype=torch.float64, device=cuda_device)
    assert float((L[n_bad:].double() @ Linv[n_bad:].double() - eye).abs().max()) <= 1e-5


def test_cuda_kernel_gradients_match_cpu(cuda_device):
    """Autograd through each new kernel on the card against the plain
    path on the CPU, same inputs and cotangents."""
    rng = np.random.default_rng(13)
    Lf = torch.from_numpy(_factor(rng, 2, 40))
    B = torch.from_numpy(rng.standard_normal((2, 40, 6)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((3, 70, 40)).astype(np.float32))
    F = torch.from_numpy((0.1 * rng.standard_normal((4, 40, 40))).astype(np.float32))
    A = torch.from_numpy(_spd(rng, 3, 40))
    cases = [
        lambda L, B, x, F, A: ts.tri_solve(L, B, False),
        lambda L, B, x, F, A: ts.tri_solve(L, B, True),
        lambda L, B, x, F, A: ts.tri_inverse(L),
        lambda L, B, x, F, A: quad.quad_diag(x, F),
        lambda L, B, x, F, A: torch.cat([t.flatten() for t in factor.cholesky_and_inverse(A)]),
    ]
    for fn in cases:
        grads = []
        for dev in (cuda_device, torch.device("cpu")):
            ins = [t.detach().to(dev).clone().requires_grad_(True) for t in (Lf, B, x, F, A)]
            out = fn(*ins)
            w = torch.from_numpy(
                np.random.default_rng(14).standard_normal(out.shape).astype(np.float32)
            ).to(dev)
            (out * w).sum().backward()
            grads.append([t.grad for t in ins])
        assert any(g is not None for g in grads[0])
        for g, c in zip(*grads):
            assert (g is None) == (c is None)
            if g is not None:
                assert _rel(g, c) <= 1e-3


def test_cuda_opt_in_negative_elbo_matches_cpu(cuda_device):
    dd = _tiny_data()
    kw = dict(m_X_per_view=16, m_G=16, n_latent_gps={"expression": 2}, fixed_view_idx=0,
              svgp_solve_mode="mixed", **OPT_INS)
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


@pytest.mark.parametrize("mode", ["mixed", "kl_inverse"])
def test_cuda_opt_in_fit_launches_every_kernel(cuda_device, mode):
    """Per step: one Cholesky probe (m < 64), one fused factor slab, eight
    substitutions (two cholesky_solves forward, their pullbacks backward),
    the quad-diag forward and backward in each layer; no plain version."""
    model = VariationalGPSA(_tiny_data(), m_X_per_view=16, m_G=16, fixed_view_idx=0,
                            svgp_solve_mode=mode, device=cuda_device, **OPT_INS)
    mods = (ch, ts, factor, quad)
    ch.launches = ts.launches = factor.launches = quad.fwd_launches = quad.bwd_launches = 0
    for mod in mods:
        mod.plain_calls = 0
    losses = model.fit(n_epochs=5, S=2)
    assert np.isfinite(losses).all()
    assert (ch.launches, factor.launches, ts.launches) == (5, 5, 8 * 5)
    assert (quad.fwd_launches, quad.bwd_launches) == (2 * 5, 2 * 5)
    assert all(mod.plain_calls == 0 for mod in mods)


# The Gram's shapes on the 100k-spot minibatch path (m = 100, B = 4096 per
# view, S = 5): warp layer with per-view parameters, data layer, the data
# layer in chunks of 2048, and predict() over 50,000 spots a view: (x1, x2,
# per-view parameters).
_GRAMS = [((1, 100, 2), (1, 4096, 2), True), ((100, 2), (5, 8192, 2), False),
          ((100, 2), (5, 2048, 2), False), ((1, 100, 2), (1, 50000, 2), True),
          ((100, 2), (1, 6250, 2), False), ((7, 3), (20, 3), False)]


def _gram_inputs(x1_shape, x2_shape, per_view, device, seed=15):
    rng = np.random.default_rng(seed)
    n_par = x1_shape[0] if per_view else 1
    x1 = rng.uniform(0, 10, x1_shape).astype(np.float32)
    x2 = rng.uniform(0, 10, x2_shape).astype(np.float32)
    ls = rng.uniform(-0.5, 1.0, n_par).astype(np.float32)
    var = rng.uniform(-1.0, 0.5, n_par).astype(np.float32)
    return [torch.from_numpy(a).to(device) for a in (x1, x2, ls, var)]


@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32"])
@pytest.mark.parametrize("x1_shape,x2_shape,per_view", _GRAMS)
def test_cuda_gram_matches_plain(cuda_device, x1_shape, x2_shape, per_view, kind):
    ins = _gram_inputs(x1_shape, x2_shape, per_view, cuda_device)
    before = gm.launches
    K = gm.gram_kernel(*ins, kind)
    torch.cuda.synchronize()
    assert gm.launches == before + 1
    Kp = gm.gram_plain(*ins, kind)
    assert K.shape == Kp.shape and K.dtype == torch.float32
    assert _rel(K, Kp) <= 1e-5
    assert _rel(K, gm.gram_plain(*(t.double() for t in ins), kind)) <= 1e-6
    # The expansion form, the unforced route (its cancellation: see above).
    tol = 1e-2 if kind == "matern12" else 1e-3
    assert _rel(K, gm.gram(*ins, kind, force=False)) <= tol


def _gram_into(ins, kind, out, offset):
    """Launch the kernel through its C entry into ``out`` from element
    ``offset`` on (an output view the wrapper never makes: 16-byte stores
    only where the output is aligned)."""
    x1, x2, ls, var = ins
    G = x2.shape[0] if x2.dim() == 3 else 1
    M, D = x1.shape[-2:]
    N = x2.shape[-2]
    per = ls.numel() > 1
    err = gm._library().sat_gram_f32(
        x1.data_ptr(), M * D if x1.dim() == 3 else 0, x2.data_ptr(), N * D if x2.dim() == 3 else 0,
        ls.data_ptr(), int(per), var.data_ptr(), int(per),
        out.data_ptr() + offset * out.element_size(), int(out.dtype == torch.bfloat16),
        G, M, N, D, gm._KINDS[kind], torch.cuda.current_stream().cuda_stream)
    assert err == 0
    return out[offset:offset + G * M * N].view(G, M, N)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("kind", ["rbf", "matern12", "matern32"])
@pytest.mark.parametrize("D", [1, 2, 3, 8])
def test_cuda_gram_edges(cuda_device, D, kind, out_dtype):
    """A row count that no cut of the rows divides evenly (67, prime, in
    ranges of unequal sizes), 130 rows over 2 column tiles (one row a
    block on 130 SMs or more), N not a multiple of 4 (1,001: the scalar
    edge), an output view off its 16-byte (bfloat16: 8-byte) alignment,
    D = 1 to 8; against the plain version (float32 rel 1e-5; bfloat16
    within its spacing, 2^-8), two launches bit-equal."""
    tol = 1e-5 if out_dtype == torch.float32 else 2.0**-8
    assert 1 < gm.design(2, 67, 4096)["row_splits"] < 67
    for x1_shape, x2_shape, per_view in (((67, D), (2, 4096, D), False),
                                         ((1, 130, D), (1, 1001, D), True),
                                         ((9, D), (3, 64, D), False)):
        ins = _gram_inputs(x1_shape, x2_shape, per_view, cuda_device, seed=17)
        K = gm.gram_kernel(*ins, kind, out_dtype=out_dtype)
        K2 = gm.gram_kernel(*ins, kind, out_dtype=out_dtype)
        Kp = gm.gram_plain(*ins, kind, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert K.dtype == out_dtype and K.shape == Kp.shape
        assert torch.equal(K.view(torch.int16 if out_dtype == torch.bfloat16 else torch.int32),
                           K2.view(torch.int16 if out_dtype == torch.bfloat16 else torch.int32))
        assert _rel(K.float(), Kp.float()) <= tol
        # The same values through an output that starts one element off.
        buf = torch.full((K.numel() + 1,), float("nan"), dtype=out_dtype, device=cuda_device)
        Ko = _gram_into(ins, kind, buf, 1)
        torch.cuda.synchronize()
        assert torch.equal(Ko.reshape(K.shape).float(), K.float())
        assert torch.isnan(buf[0].float())


def test_cuda_gram_bfloat16_store_and_empty(cuda_device):
    ins = _gram_inputs((100, 2), (5, 2048, 2), False, cuda_device)
    K = gm.gram_kernel(*ins, "matern32", out_dtype=torch.bfloat16)
    Kp = gm.gram_plain(*ins, "matern32", out_dtype=torch.bfloat16)
    assert K.dtype == torch.bfloat16
    assert _rel(K.float(), Kp.float()) <= 2.0**-8
    for x1_shape, x2_shape in (((0, 2), (3, 5, 2)), ((4, 2), (3, 0, 2))):
        x1, x2, ls, var = _gram_inputs(x1_shape, x2_shape, False, cuda_device)
        before = gm.launches
        assert gm.gram_kernel(x1, x2, ls, var).shape == (3, x1_shape[0], x2_shape[1])
        assert gm.launches == before


def test_cuda_gram_gradient_matches_cpu(cuda_device):
    """The forced Gram on the card (kernel forward, closed-form backward)
    against the forced Gram on the CPU (plain forward), same cotangent."""
    for x1_shape, x2_shape, per_view in (_GRAMS[0], _GRAMS[5]):
        grads = []
        for dev in (cuda_device, torch.device("cpu")):
            ins = [t.to(dev).requires_grad_(True)
                   for t in _gram_inputs(x1_shape, x2_shape, per_view, "cpu")]
            K = gm.gram(*ins, "matern32", force=True)
            w = torch.from_numpy(
                np.random.default_rng(16).standard_normal(K.shape).astype(np.float32)
            ).to(dev)
            (K * w).sum().backward()
            grads.append([t.grad for t in ins])
        for g, c in zip(*grads):
            assert _rel(g, c) <= 1e-3


@pytest.mark.parametrize("chunk", [None, 16])
def test_cuda_forced_minibatch_fit_launches_the_gram_kernel(cuda_device, chunk):
    """Under set_gram_force(True), every Gram of a minibatch step is the
    kernel: the warp layer's and the data layer's (one per chunk of the
    2 x 24 sub-batch points); the Cholesky's two launches are unchanged."""
    model = VariationalGPSA(_tiny_data(), m_X_per_view=16, m_G=16, fixed_view_idx=0,
                            data_chunk_size=chunk, device=cuda_device)
    gm.launches = gm.plain_calls = ch.launches = ch.plain_calls = 0
    gm.set_gram_force(True)
    try:
        losses = model.fit(n_epochs=5, S=2, minibatch_size=24)
    finally:
        gm.set_gram_force(None)
    assert np.isfinite(losses).all()
    assert gm.launches == (1 + (48 // 16 if chunk else 1)) * 5
    assert ch.launches == 2 * 5
    assert gm.plain_calls == ch.plain_calls == 0


# ---------------------------------------------------------------------------
# The training loop as a CUDA graph (models/train.py)
# ---------------------------------------------------------------------------


def _grid_data(n=400, seed=14):
    """Two views of ``n`` points, the second a jittered copy of the first."""
    rng = np.random.default_rng(seed)
    X1 = rng.uniform(0, 10, (n, 2)).astype(np.float32)
    X = np.concatenate([X1, X1 + 0.1 * rng.standard_normal(X1.shape).astype(np.float32)])
    Y = np.stack([np.sin(X[:, 0] * (j + 1) / 3.0) + np.cos(X[:, 1]) for j in range(3)], 1)
    return {"expression": {"spatial_coords": X, "outputs": Y.astype(np.float32),
                           "n_samples_list": [n, n]}}


def _graph_model(device, m, opt_ins=True, **kw):
    return VariationalGPSA(_grid_data(), m_X_per_view=m, m_G=m, n_latent_gps={"expression": 2},
                           fixed_view_idx=0, device=device, **(OPT_INS if opt_ins else {}), **kw)


def _eager_losses(model, n, **kw):
    step, _ = model.make_train_step(**kw)
    return np.array([float(step()) for _ in range(n)])


def _leaves_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.parameters(), b.parameters()))


@pytest.mark.parametrize("m,opt_ins,minibatch", [(50, True, None), (384, True, None),
                                                 (200, False, None), (100, False, 64)],
                         ids=["m50_opt_ins", "m384_opt_ins", "m200", "m100_minibatch"])
def test_cuda_captured_fit_matches_eager_steps(cuda_device, m, opt_ins, minibatch):
    """fit() replays one captured step; from the same parameters and
    generator state the eager make_train_step loop gives the same losses and
    parameters bit for bit (at m = 384 the Cholesky probe is a cluster
    launch, as is the quad forward)."""
    captured, eager = _graph_model(cuda_device, m, opt_ins), _graph_model(cuda_device, m, opt_ins)
    losses = captured.fit(n_epochs=6, S=2, minibatch_size=minibatch)
    assert captured._train_loop_cache["loop"].graph is not None
    want = _eager_losses(eager, 6, S=2, minibatch_size=minibatch)
    np.testing.assert_array_equal(losses, want)
    assert _leaves_equal(captured, eager)


def test_cuda_replays_draw_fresh_noise(cuda_device):
    """Under SGD at lr 0 the parameters stay put, so the losses differ by
    the noise alone: each replay draws anew, and the replays draw what
    eager steps from the same generator state draw."""
    frozen = lambda p: torch.optim.SGD(p, lr=0.0)
    a, b = _graph_model(cuda_device, 50), _graph_model(cuda_device, 50)
    losses = a.fit(n_epochs=3, S=2, optimizer=frozen)
    assert len(set(losses.tolist())) == 3
    np.testing.assert_array_equal(losses, _eager_losses(b, 3, S=2, optimizer=frozen))


def test_cuda_counters_equal_the_profilers_kernel_counts(cuda_device):
    """Over 5 replays the counters gain what the profiler saw launched: one
    Cholesky kernel, one factor, eight solves, two quad forwards and two
    backwards (a dx and a dF pass each) a step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from spatial_alignment_tpu_torch import ops

    model = _graph_model(cuda_device, 50)
    model.fit(n_epochs=1, S=2)  # capture outside the window
    before = ops.read_counters()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.fit(n_epochs=5, S=2)
        torch.cuda.synchronize()
    after = ops.read_counters()
    gained = {k: after[k] - before[k] for k in after}
    seen = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and "_kernel" in e.key:
            seen[e.key] = seen.get(e.key, 0) + e.count
    count = lambda *names: sum(c for k, c in seen.items() if any(n in k for n in names))
    chol = count("cholesky_smem_kernel", "cholesky_panel_kernel")
    assert gained["cholesky.launches"] == chol == 5
    assert gained["factor.launches"] == count("factor_smem_kernel", "factor_panel_kernel") == 5
    assert gained["trisolve.launches"] == count("trisolve_kernel") == 40
    assert gained["quad.fwd_launches"] == count("quad_fwd_kernel") == 10
    passes = count("quad_bwd_tc_kernel", "quad_dx_kernel", "quad_df_kernel")
    assert gained["quad.bwd_launches"] * 2 == passes == 20
    assert not any(v for k, v in gained.items() if k.endswith("plain_calls"))


@pytest.mark.parametrize("recipe", [None, "accurate"])
def test_cuda_resume_is_bit_for_bit(cuda_device, tmp_path, recipe):
    """fit(8) against fit(4), save, VariationalGPSA.load, fit(4,
    resume_from=): the same losses and parameters, Adam moments and the
    generator's offset restored (with the recipe over the total horizon)."""
    from spatial_alignment_tpu_torch.models.train import resolve_recipe as _resolve_recipe

    ref = _graph_model(cuda_device, 50)
    full = ref.fit(n_epochs=8, S=2, recipe=recipe)
    first = _graph_model(cuda_device, 50)
    opt8, temps8 = _resolve_recipe(recipe, 1e-2, 8, None, None)
    head = first.fit(n_epochs=4, S=2, optimizer=opt8, warp_temperature_schedule=temps8)
    path = str(tmp_path / "mid.npz")
    first.save(path)
    resumed = VariationalGPSA.load(path)
    tail = resumed.fit(n_epochs=4, S=2, recipe=recipe, resume_from=path)
    np.testing.assert_array_equal(np.concatenate([head, tail]), full)
    assert _leaves_equal(resumed, ref)
    assert resumed._epoch == 8


def test_cuda_non_capturable_optimizer_raises(cuda_device):
    model = _graph_model(cuda_device, 50)
    with pytest.raises(RuntimeError, match="Adam was built with capturable=False"):
        model.fit(n_epochs=2, S=2, optimizer=lambda p: torch.optim.Adam(p, lr=1e-2))


@pytest.mark.parametrize("mode", ["capturable_eager", "capturable_replayed", "noncapturable"])
def test_cuda_adam_matches_float64_adam(cuda_device, mode):
    """Five Adam steps on the same float32 gradients against optax's Adam
    formula in float64: the capturable Adam fit() uses on the card (its lr
    a float32 tensor, as the recipe's), stepped eagerly and replayed from
    the train loop's captured step, and the non-capturable one, whose bias
    corrections the host does. Each stays within float32 rounding: per step
    2^-24 |p| for rounding the parameter and 2^-16 lr for the update (some
    ulps of the quotient); without its bias corrections step 1's update
    would be about 3.2 lr instead of lr."""
    from spatial_alignment_tpu_torch.models.train import TrainLoop

    n, steps, lr, b1, b2, eps = 4096, 5, 1e-2, 0.9, 0.999, 1e-8
    rng = np.random.default_rng(21)
    p0 = rng.standard_normal(n).astype(np.float32)
    grads = rng.standard_normal((steps, n)).astype(np.float32)
    p, m, v, want = p0.astype(np.float64), 0.0, 0.0, []
    for t, g in enumerate(grads.astype(np.float64), 1):
        m, v = b1 * m + (1 - b1) * g, b2 * v + (1 - b2) * g * g
        p = p - lr * (m / (1 - b1**t)) / (np.sqrt(v / (1 - b2**t)) + eps)
        want.append(p)

    param = torch.tensor(p0, device=cuda_device, requires_grad=True)
    g = torch.zeros(n, device=cuda_device)
    if mode == "noncapturable":
        opt = torch.optim.Adam([param], lr=lr)
    else:
        opt = torch.optim.Adam([param], capturable=True,
                               lr=torch.tensor(lr, dtype=torch.float32, device=cuda_device))
    loop = None
    if mode == "capturable_replayed":
        # The loss's gradient with respect to the parameter is g exactly.
        loop = TrainLoop([("p", param)], lambda temp: (param * g).sum() * temp, opt,
                         torch.Generator(device=cuda_device))
        assert loop.graph is not None
    for t in range(steps):
        g.copy_(torch.from_numpy(grads[t]))
        if loop is not None:
            loop.run(np.ones(1, np.float32))
        else:
            param.grad = g.clone()
            opt.step()
        err = np.abs(param.detach().cpu().numpy().astype(np.float64) - want[t])
        limit = (t + 1) * (2.0**-24 * np.abs(want[t]).max() + 2.0**-16 * lr)
        assert err.max() <= limit, (mode, t, err.max(), limit)


# ---------------------------------------------------------------------------
# fit_multistart: the restart axis folded into each kernel's batch
# ---------------------------------------------------------------------------


def _vmapped(fn, *args, in_dims=0):
    """``torch.func.vmap(fn)`` over the leading restart axis, with the
    launches it made of each kernel."""
    from spatial_alignment_tpu_torch import ops

    before = ops.read_counters()
    out = torch.func.vmap(fn, in_dims=in_dims)(*args)
    torch.cuda.synchronize()
    after = ops.read_counters()
    return out, {k: after[k] - before[k] for k in after if after[k] != before[k]}


@pytest.mark.parametrize("kernel", ["cholesky", "trisolve", "trisolve_shared_rhs", "tri_inverse",
                                    "quad_shared", "quad_per_view", "factor", "gram"])
def test_cuda_kernels_at_restart_folded_shapes(cuda_device, kernel):
    """Each kernel under the restart vmap, R = 3 restarts of the shapes an
    m = 50 step hands it: one launch for all restarts, and each restart's
    result that restart's plain version's (rel 1e-4; the Gram 1e-5)."""
    rng = np.random.default_rng(30)
    R, dev = 3, cuda_device
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    if kernel == "cholesky":
        A = t(_spd(rng, R * 4, 50).reshape(R, 4, 50, 50))
        out, n = _vmapped(ch.cholesky, A)
        want = ch.cholesky_plain(A.cpu())
    elif kernel in ("trisolve", "trisolve_shared_rhs"):
        L = t(_factor(rng, R * 2, 50).reshape(R, 2, 50, 50))
        B = t(rng.standard_normal((2, 50, 5)).astype(np.float32))
        if kernel == "trisolve":
            B = B.expand(R, 2, 50, 5).contiguous() + 1.0
            out, n = _vmapped(lambda l, b: ts.tri_solve(l, b, True), L, B)
            want = ts.tri_solve_plain(L.cpu(), B.cpu(), True)
        else:  # the right-hand side the same for every restart
            out, n = _vmapped(lambda l, b: ts.tri_solve(l, b), L, B, in_dims=(0, None))
            want = ts.tri_solve_plain(L.cpu(), B.cpu().expand(R, 2, 50, 5))
    elif kernel == "tri_inverse":
        L = t(_factor(rng, R * 2, 50).reshape(R, 2, 50, 50))
        out, n = _vmapped(ts.tri_inverse, L)
        want = ts.tri_inverse_plain(L.cpu())
    elif kernel in ("quad_shared", "quad_per_view"):
        x = t(rng.standard_normal((R, 5, 300, 50)).astype(np.float32))
        f_shape = (R, 4, 50, 50) if kernel == "quad_shared" else (R, 5, 2, 50, 50)
        F = t(0.1 * rng.standard_normal(f_shape).astype(np.float32))
        out, n = _vmapped(quad.quad_diag, x, F)
        want = torch.stack([quad.quad_diag_plain(x[r].cpu(), F[r].cpu()) for r in range(R)])
    elif kernel == "factor":
        A = t(_spd(rng, R * 4, 50).reshape(R, 4, 50, 50))
        out, n = _vmapped(factor.cholesky_and_inverse, A)
        plain = factor.cholesky_and_inverse_plain(A.cpu())
        out, want = torch.stack(out), torch.stack(plain)
    else:  # gram: per-restart parameters, data points shared by the restarts
        x1 = t(rng.uniform(0, 10, (R, 50, 2)).astype(np.float32))
        x2 = t(rng.uniform(0, 10, (5, 400, 2)).astype(np.float32))
        ls, var = t(rng.uniform(-0.5, 1.0, R).astype(np.float32)), t(np.zeros(R, np.float32))
        out, n = _vmapped(lambda a, b, l, v: gm.gram(a, b, l, v, force=True), x1, x2, ls, var,
                          in_dims=(0, None, 0, 0))
        want = torch.stack([gm.gram_plain(x1[r].cpu(), x2.cpu(), ls[r].cpu(), var[r].cpu())
                            for r in range(R)])
        assert _rel(out, want) <= 1e-5 and n == {"gram.launches": 1}
        return
    assert _rel(out, want) <= 1e-4
    launched = {"cholesky": "cholesky.launches", "tri_inverse": "trisolve.launches",
                "factor": "factor.launches"}.get(kernel)
    if kernel.startswith("trisolve"):
        launched = "trisolve.launches"
    if kernel.startswith("quad"):
        launched = "quad.fwd_launches"
    assert n == {launched: 1}, n


def _restart_model(device, opt_ins, **kw):
    """The m = 50 grid model with lengthscales 0.7, which keep its Grams
    well conditioned (the m = 64 parity model's)."""
    model = _graph_model(device, 50, opt_ins, **kw)
    with torch.no_grad():
        model.params["warp_kernel_lengthscales"].fill_(math.log(0.7))
        model.params["data_kernel_lengthscale"].fill_(math.log(0.7))
    return model


def _restart_eager(model, values, n, S=2, minibatch=None):
    """n eager R-wide steps from the stacked ``values`` (a fresh Adam, the
    generator reseeded with 0, as ``_fit_restarts_vectorized`` starts)."""
    from spatial_alignment_tpu_torch.models._trees import leaves, tree_map

    R = leaves(values)[0].shape[0]
    params = tree_map(lambda v: v.detach().clone().requires_grad_(True), values)
    loss_fn = model._restart_step_loss(S, minibatch, R, params)
    opt = model._optimizer(None, 1e-2, leaves(params))
    model._gen.manual_seed(0)
    losses = []
    for _ in range(n):
        opt.zero_grad(set_to_none=True)
        loss = loss_fn(1.0)
        loss.sum().backward()
        opt.step()
        losses.append(loss.detach())
    return torch.stack(losses).cpu().numpy().astype(np.float64), params


@pytest.mark.parametrize("opt_ins,minibatch", [(False, None), (True, None), (False, 64)],
                         ids=["default", "opt_ins", "minibatch_forced_gram"])
def test_cuda_restart_step_captured_matches_eager(cuda_device, opt_ins, minibatch):
    """The R-wide step captured and replayed (``_fit_restarts_vectorized``)
    against the same step run eagerly from the same parameters and
    generator: losses and parameters bit for bit; each kernel launched as
    often a step as one restart's step launches it."""
    from spatial_alignment_tpu_torch import ops
    from spatial_alignment_tpu_torch.models._trees import leaves

    model = _restart_model(cuda_device, opt_ins)
    R, n = 3, 4
    gm.set_gram_force(True if minibatch else None)
    try:
        values = model._restart_inits(R, 0)
        before = ops.read_counters()
        params, losses = model._fit_restarts_vectorized(n, R, 0, S=2, minibatch_size=minibatch)
        after = ops.read_counters()
        assert model._vec_loop_cache["loop"].graph is not None
        want, eager = _restart_eager(model, values, n, minibatch=minibatch)
        per_step = model._vec_loop_cache["loop"].per_step
        one = model.make_train_loop(S=2, minibatch_size=minibatch).per_step
    finally:
        gm.set_gram_force(None)
    np.testing.assert_array_equal(losses.T, want)
    assert all(torch.equal(a, b) for a, b in zip(leaves(params), leaves(eager)))
    assert per_step == one and any(per_step.values())
    assert {k: after[k] - before[k] for k in after} == {k: n * v for k, v in per_step.items()}


@pytest.mark.parametrize("opt_ins", [False, True], ids=["default", "opt_ins"])
def test_cuda_restart_step_matches_each_restart_alone(cuda_device, opt_ins):
    """One R-wide loss and gradient against each restart's own, from the
    same parameters and draws: losses rel 1e-5, gradients rel 1e-3 per
    leaf (float32 in another summation order: batched products of another
    batch count, the quad backward's split over another grid)."""
    from spatial_alignment_tpu_torch.models._trees import leaves, tree_map

    model = _restart_model(cuda_device, opt_ins)
    R, S = 3, 2
    values = model._restart_inits(R, 0)
    with torch.no_grad():
        values["warp_kernel_lengthscales"].fill_(math.log(0.7))
        values["data_kernel_lengthscale"].fill_(math.log(0.7))
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    wn, dn, _ = core.draw_restart_noise(model.spec, R, S, gen, model.device)
    model._draw_restart_noise = lambda R_, S_: (wn, dn, None)
    params = tree_map(lambda v: v.clone().requires_grad_(True), values)
    losses = model._restart_step_loss(S, None, R, params)(1.0)
    losses.sum().backward()
    for r in range(R):
        alone = tree_map(lambda v: v[r].clone().requires_grad_(True), values)
        loss = core.negative_elbo(model.spec, alone, model.consts, model._batch, S, 1.0,
                                  warp_noise=wn[r], data_noise={k: v[r] for k, v in dn.items()})
        loss.backward()
        assert _rel(losses[r], loss) <= 1e-5
        for a, b in zip(leaves(params), leaves(alone)):
            assert _rel(a.grad[r], b.grad) <= 1e-3
