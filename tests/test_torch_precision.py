"""PyTorch port: the SVGP precision names (``ops/precision.py``).

On the CPU every name is the plain float32 product, as XLA's CPU products
are whatever the name: the port's loss and gradients with the names forced
to ``high``/``default`` equal the JAX package's with the same names, and
``precision.matmul`` equals ``@`` bit for bit. The TF32 mode itself runs
only on a card (``tests/test_torch_cuda.py``); here its autograd Function
is held against ``@`` on CPU tensors, where PyTorch's TF32 flag changes
nothing, and its scope is held to put PyTorch's flags back.

Tolerances: loss rel 1e-5 and gradients rel 2e-3 per leaf, as
``test_torch_model.py``; the Function's own backward against autograd's,
rel 1e-12 in float64 (another order of the same sums).
"""

import numpy as np
import pytest
import jax
import torch

from spatial_alignment_tpu.models import spec as jspec
from spatial_alignment_tpu_torch.models import core as tcore
from spatial_alignment_tpu_torch.models import spec as tspec
from spatial_alignment_tpu_torch.ops import precision, quad

from chip_smoke import error_bounds
from conftest import make_two_view_data
from test_torch_model import _jit_value_and_grad, _rel, jax_noise, leaf, model_pair

torch.set_num_threads(1)


def _data(n_total):
    rng = np.random.default_rng(0)
    n0 = n_total // 2
    X = rng.uniform(0, 10, (n_total, 2)).astype(np.float32)
    Y = rng.standard_normal((n_total, 1)).astype(np.float32)
    return {"expression": {"spatial_coords": X, "outputs": Y,
                           "n_samples_list": [n0, n_total - n0]}}


@pytest.mark.parametrize("n_total", [1999, 2000])
@pytest.mark.parametrize(
    "names",
    [("auto", "auto"), ("high", "auto"), ("highest", "default"), ("default", "follow"),
     ("auto", "high")],
)
def test_build_spec_resolves_names_as_jax(n_total, names):
    dd = _data(n_total)
    kw = dict(m_X_per_view=4, m_G=4, svgp_matmul_precision=names[0],
              svgp_variance_precision=names[1])
    want = jspec.build_spec(dd, **kw)
    got = tspec.build_spec(dd, **kw)
    pair = lambda s: (s.svgp_matmul_precision, s.svgp_variance_precision)
    assert pair(got) == pair(want)
    if names == ("auto", "auto"):
        assert pair(got) == (("high", "default") if n_total >= 2000 else ("highest", "follow"))


@pytest.mark.parametrize("name", ["default", "high", "highest"])
def test_matmul_on_the_cpu_is_the_plain_product(name):
    """Forward, both gradients and a vmap over a leading axis: bit for bit
    the plain ``@`` on CPU tensors, at every name."""
    rng = np.random.default_rng(1)
    a0 = torch.from_numpy(rng.standard_normal((3, 1, 17, 6)).astype(np.float32))
    b0 = torch.from_numpy(rng.standard_normal((4, 6, 6)).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal((3, 4, 17, 6)).astype(np.float32))
    outs = []
    for fn in (lambda a, b: precision.matmul(a, b, name), lambda a, b: a @ b):
        a, b = a0.clone().requires_grad_(True), b0.clone().requires_grad_(True)
        out = fn(a, b)
        out.backward(g)
        vm = torch.func.vmap(fn, in_dims=(0, None))(a0, b0)
        outs.append((out.detach(), a.grad, b.grad, vm))
    for x, y in zip(*outs):
        assert torch.equal(x, y)


def test_tf32_function_gradients_equal_autograd():
    """The TF32 mode's autograd Function, run on CPU tensors: its backward
    (with the broadcast dims summed out) equals autograd's through ``@``,
    in plain calls and under ``torch.func.vmap`` (its generated rule)."""
    rng = np.random.default_rng(2)
    cases = [((5, 1, 30, 8), (3, 8, 8)), ((4, 30, 8), (8, 3)), ((2, 7, 5), (2, 5, 5))]
    for sa, sb in cases:
        a = torch.from_numpy(rng.standard_normal(sa)).requires_grad_(True)
        b = torch.from_numpy(rng.standard_normal(sb)).requires_grad_(True)
        out = precision._Matmul.apply(a, b, "default")
        g = torch.from_numpy(rng.standard_normal(tuple(out.shape)))
        got = torch.autograd.grad(out, (a, b), g)
        want = torch.autograd.grad(a @ b, (a, b), g)
        assert torch.equal(out, a @ b)
        for x, y in zip(got, want):
            assert x.shape == y.shape and _rel(x, y) <= 1e-12
    R = torch.from_numpy(rng.standard_normal((3, 4, 9, 6))).requires_grad_(True)
    B = torch.from_numpy(rng.standard_normal((6, 2)))
    f = lambda r: precision._Matmul.apply(r, B, "default").square().sum()
    torch.func.vmap(f)(R).sum().backward()
    R2 = R.detach().clone().requires_grad_(True)
    (R2 @ B).square().sum().backward()
    assert _rel(R.grad, R2.grad) <= 1e-12


def _flags():
    """PyTorch's process-wide TF32 setting as each reader gives it (a legacy
    reader refuses after only the per-backend setter was used)."""
    mm = torch.backends.cuda.matmul
    out = []
    for read in (lambda: mm.allow_tf32, torch.get_float32_matmul_precision,
                 lambda: mm.fp32_precision):
        try:
            out.append(read())
        except RuntimeError:
            out.append("refused")
    return tuple(out)


_SETTINGS = {
    "untouched": lambda mm: None,
    "matmul_precision_medium": lambda mm: torch.set_float32_matmul_precision("medium"),
    "matmul_precision_high": lambda mm: torch.set_float32_matmul_precision("high"),
    "allow_tf32_true": lambda mm: setattr(mm, "allow_tf32", True),
    "allow_tf32_false": lambda mm: setattr(mm, "allow_tf32", False),
    "fp32_precision_tf32": lambda mm: setattr(mm, "fp32_precision", "tf32"),
    "fp32_precision_ieee": lambda mm: setattr(mm, "fp32_precision", "ieee"),
}


@pytest.mark.parametrize("setting", list(_SETTINGS))
def test_scope_puts_the_flags_back(setting):
    """From each way of setting PyTorch's TF32 flags: inside ``tf32(on)``
    cuBLAS TF32 reads on, inside ``tf32(off)`` off; after either, and after
    one left by an exception, every reader gives what it gave before."""
    mm = torch.backends.cuda.matmul
    start = _flags()
    try:
        _SETTINGS[setting](mm)
        before = _flags()
        for enabled in (True, False):
            with precision.tf32(enabled):
                assert mm.allow_tf32 is enabled and precision.tf32_enabled() is enabled
            assert _flags() == before
        with pytest.raises(RuntimeError, match="inside"):
            with precision.tf32(True):
                raise RuntimeError("inside")
        assert _flags() == before
    finally:
        torch.set_float32_matmul_precision(start[1])
        mm.fp32_precision = start[2]
    assert _flags() == start


def test_scope_leaves_cpu_tensors_alone():
    """On CPU tensors the scope and the product change no flag, and an
    unknown name is refused."""
    before = _flags()
    with pytest.raises(ValueError, match="precision must be"):
        precision.matmul(torch.zeros(2, 2), torch.zeros(2, 2), "bfloat16")
    with precision.scope("default", torch.zeros(1)):
        assert _flags() == before
    a = torch.randn(4, 3, requires_grad=True)
    precision.matmul(a, torch.randn(3, 2), "default").sum().backward()
    assert _flags() == before


_NAMED_CASES = [("mixed", "xla"), ("solve", "xla"), ("inverse", "xla"), ("mixed", "pallas")]


@pytest.mark.parametrize("mode,quad_impl", _NAMED_CASES,
                         ids=[f"{m}-{q}" for m, q in _NAMED_CASES])
def test_negative_elbo_with_names_matches_jax(mode, quad_impl):
    """Both names forced to high/default (what ``auto`` gives from 2,000
    points) on a small model: the port's loss and gradients on the CPU
    against the JAX package's with the same names. The port's opt-in quad
    route (its plain versions on the CPU, counted) takes the names too; the
    JAX side runs its default route there (its Pallas kernel cannot run
    under jit on the CPU)."""
    dd = make_two_view_data(n_per_view=24, n_outputs=3)
    kw = dict(m_X_per_view=8, m_G=8, n_latent_gps={"expression": 2}, fixed_view_idx=0,
              svgp_solve_mode=mode, svgp_matmul_precision="high",
              svgp_variance_precision="default")
    jm, tm = model_pair(dd, **kw)
    tm.spec = tm.spec.replace(quad_diag_impl=quad_impl)
    assert (tm.spec.svgp_matmul_precision, tm.spec.svgp_variance_precision) == ("high", "default")
    S, key = 2, jax.random.PRNGKey(5)
    loss_j, grads_j = _jit_value_and_grad(jm.spec, jm.params, jm.consts, jm._batch, key, S, 1.0)
    warp, data = jax_noise(jm.spec, key, S)
    quad.plain_calls = 0
    loss_t = tcore.negative_elbo(tm.spec, tm.params, tm.consts, tm._batch, S, 1.0,
                                 warp_noise=warp, data_noise=data)
    loss_t.backward()
    assert quad.plain_calls == (4 if quad_impl == "pallas" else 0)
    assert _rel(loss_t.detach(), loss_j) <= 1e-5
    for path, g in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        got = leaf(tm.params, path).grad
        assert _rel(got, g) <= 2e-3, (jax.tree_util.keystr(path), _rel(got, g))


def _round_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, nearest, ties away from
    zero), as ``cvt.rna.tf32.f32`` rounds the quad kernel's operands."""
    bits = t.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


@pytest.mark.parametrize("shared", [True, False], ids=["shared", "per_group"])
def test_quad_error_bounds_hold_a_tf32_emulation(shared):
    """``chip_smoke.error_bounds`` (the bound the card's checks hold the
    one-pass TF32 quad kernels to) holds an emulation of that mode on the
    CPU: every operand of every product rounded to TF32, float32 sums. It is held
    loose by no more than the bound's first-order slack allows: the worst
    element uses more than 1 % of it. The float32 plain version stays
    within the 3xTF32 bound."""
    rng = np.random.default_rng(3)
    G, N, m, L = 2, 50, 24, 3
    x = torch.from_numpy(rng.standard_normal((G, N, m)).astype(np.float32))
    F = torch.from_numpy((0.1 * rng.standard_normal((L, m, m) if shared else (G, L, m, m)))
                         .astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((G, L, N)).astype(np.float32))
    r = _round_tf32
    t = r(x).unsqueeze(1) @ r(F)
    out = t.square().sum(-1)
    w = 2.0 * dy.unsqueeze(-1) * t
    dx = (r(w) @ r(F).transpose(-1, -2)).sum(1)
    eq = "gni,gbnk->bik" if shared else "gni,gbnk->gbik"
    dF = torch.einsum(eq, r(x), r(w))
    ratios = []
    for got, (exact, bound) in zip((out, dx, dF), error_bounds(x, F, dy, "tf32")):
        ratio = float(((got.double() - exact).abs() / bound).max())
        assert ratio <= 1.0
        ratios.append(ratio)
    assert max(ratios) >= 0.01, ratios
    plain = (quad.quad_diag_plain(x, F), *quad.quad_bwd_plain(x, F, dy))
    for got, (exact, bound) in zip(plain, error_bounds(x, F, dy, "3xtf32")):
        assert float(((got.double() - exact).abs() / bound).max()) <= 1.0
