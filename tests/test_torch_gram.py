"""PyTorch port: the cross-Gram kernel's plain version and the forced route
of ``gram``, held against the JAX package's Pallas Gram kernel in interpret
mode on the same numpy inputs.

``gram_plain`` repeats ``_gram_kernel_body``'s arithmetic (direct
differences over the coordinates, then the kernel's exp / sqrt in the same
order), so it is held to rel 1e-6 against ``pallas_gram(..., interpret=True)``:
float32 with the same operation order, where only the exp and sqrt of two
libraries may differ by an ulp. A bfloat16 store is held to the bfloat16
spacing (rel 2^-8): a value that lands within an ulp of a rounding boundary
may round the other way. The forced ``gram`` (values and all four
gradients) is held to rel 1e-6 on values and 1e-4 on gradients, the
gradients' closed form summing m*N pairs in another order on each side;
3e-4 for matern12, whose closed form divides by the distance, so that
close pairs amplify float32 rounding (against a float64 reference the
JAX side's x1 gradient is off by 2e-4 on the per-view case, the port's by
4e-5).
"""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax.experimental.pallas import tpu as pltpu

from spatial_alignment_tpu.ops import pallas_gram as jpg
from spatial_alignment_tpu_torch.ops import gram as tg

# The suite runs in several worker processes on shared cores; PyTorch's
# default of one intra-op thread per core in each of them oversubscribes
# the machine and slows these tiny problems by orders of magnitude.
torch.set_num_threads(1)

KINDS = ["rbf", "matern12", "matern32"]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _t(x, grad=False):
    return torch.tensor(np.asarray(x), requires_grad=grad)


def _inputs(batched, seed=1):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, 5, (9, 2)).astype(np.float32)
    x2 = rng.uniform(0, 5, ((3, 13, 2) if batched else (13, 2))).astype(np.float32)
    return x1, x2, np.array([0.4], np.float32), np.array([-0.2], np.float32), rng


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("batched", [False, True], ids=["x2_2d", "x2_S_batched"])
def test_plain_matches_pallas_kernel_in_interpret_mode(kind, batched):
    x1, x2, ls, var, _ = _inputs(batched)
    want = jpg.pallas_gram(jnp.asarray(x1), jnp.asarray(x2), ls, var, kind, interpret=True)
    tg.plain_calls = 0
    got = tg.gram_plain(_t(x1), _t(x2), _t(ls), _t(var), kind)
    assert tg.plain_calls == 1
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    assert _rel(got, want) <= 1e-6, _rel(got, want)


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_plain_bfloat16_store_matches_pallas_kernel(kind):
    x1, x2, ls, var, _ = _inputs(True)
    want = jpg.pallas_gram(jnp.asarray(x1), jnp.asarray(x2), ls, var, kind, interpret=True,
                           out_dtype=jnp.bfloat16)
    got = tg.gram_plain(_t(x1), _t(x2), _t(ls), _t(var), kind, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert _rel(got.float(), np.asarray(want, np.float32)) <= 2.0**-8


@pytest.mark.parametrize("kind", KINDS)
def test_plain_per_view_matches_vmapped_pallas_kernel(kind):
    """The warp layer's layout: x1 (V, M, D), x2 (V, N, D) and one
    lengthscale / variance per view, against jax.vmap of the kernel."""
    rng = np.random.default_rng(2)
    x1 = rng.uniform(0, 5, (2, 7, 2)).astype(np.float32)
    x2 = rng.uniform(0, 5, (2, 11, 2)).astype(np.float32)
    ls = np.array([0.3, 0.9], np.float32)
    var = np.array([0.1, -0.4], np.float32)
    want = jax.vmap(lambda a, b, l, v: jpg.pallas_gram(a, b, l, v, kind, interpret=True))(
        x1, x2, ls, var
    )
    got = tg.gram_plain(_t(x1), _t(x2), _t(ls), _t(var), kind)
    assert _rel(got, want) <= 1e-6


def _jax_forced(fn):
    """Run ``fn`` with the JAX package's Gram switch on and its Pallas
    kernels in interpret mode (how its own CPU tests reach the kernel)."""
    jpg.set_gram_force(True)
    try:
        with pltpu.force_tpu_interpret_mode():
            return fn()
    finally:
        jpg.set_gram_force(None)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("layout", ["data", "per_view"])
def test_forced_gram_values_and_grads_match_jax(kind, layout):
    """``gram(force=True)`` on CPU tensors takes the plain version once and
    launches nothing; values and the gradients of all four inputs match JAX's
    forced gram (the data layer's shared x1 with an S-batched x2, and the warp
    layer's per-view parameters, vmapped on the JAX side)."""
    rng = np.random.default_rng(3)
    if layout == "data":
        x1, x2, ls, var, _ = _inputs(True, seed=3)
        jfn = lambda a, b, l, v: jpg.gram(a, b, l, v, kind, True)
    else:
        x1 = rng.uniform(0, 5, (2, 7, 2)).astype(np.float32)
        x2 = rng.uniform(0, 5, (2, 11, 2)).astype(np.float32)
        ls, var = np.array([0.3, 0.9], np.float32), np.array([0.1, -0.4], np.float32)
        jfn = jax.vmap(lambda a, b, l, v: jpg.gram(a, b, l, v, kind, True))
    g = rng.standard_normal(x2.shape[:-2] + (x1.shape[-2], x2.shape[-2])).astype(np.float32)

    def jax_side():
        loss = lambda *a: jnp.sum(jfn(*a) * g)
        return jfn(x1, x2, ls, var), jax.grad(loss, argnums=(0, 1, 2, 3))(x1, x2, ls, var)

    K_j, grads_j = _jax_forced(jax_side)
    ins = [_t(a, grad=True) for a in (x1, x2, ls, var)]
    tg.plain_calls, tg.launches = 0, 0
    K_t = tg.gram(*ins, kind, force=True)
    (K_t * _t(g)).sum().backward()
    assert (tg.plain_calls, tg.launches) == (1, 0)
    assert _rel(K_t.detach(), K_j) <= 1e-6
    tol = 3e-4 if kind == "matern12" else 1e-4
    for inp, gj in zip(ins, grads_j):
        assert inp.grad.shape == inp.shape
        assert _rel(inp.grad, gj) <= tol, (kind, _rel(inp.grad, gj))


def test_set_gram_force_resolution_and_restore():
    """JAX's order: an explicit ``force`` wins, else the switch, else the
    expansion form; the switch is read at call time and None restores it."""
    x1, x2, ls, var, _ = _inputs(True)
    ins = [_t(a) for a in (x1, x2, ls, var)]
    expansion = tg.gram(*ins)
    tg.plain_calls = 0
    try:
        tg.set_gram_force(True)
        forced = tg.gram(*ins)
        assert tg.plain_calls == 1
        tg.gram(*ins, force=False)
        assert tg.plain_calls == 1
        tg.set_gram_force(False)
        tg.gram(*ins)
        tg.gram(*ins, force=True)
        assert tg.plain_calls == 2
    finally:
        tg.set_gram_force(None)
    tg.gram(*ins)
    assert tg.plain_calls == 2
    assert tg._FORCE is None
    # The two forms agree to the expansion's cancellation error.
    assert _rel(forced, expansion) <= 1e-5


def test_kernel_refuses_what_it_cannot_take():
    x1 = torch.zeros(4, 9)
    with pytest.raises(ValueError, match="at most 8"):
        tg.gram_kernel(x1, torch.zeros(5, 9), torch.zeros(1), torch.zeros(1))
    with pytest.raises(ValueError, match="CUDA"):
        tg.gram_kernel(torch.zeros(4, 2), torch.zeros(5, 2), torch.zeros(1), torch.zeros(1))
    with pytest.raises(ValueError, match="unknown kernel kind"):
        tg.gram_plain(torch.zeros(4, 2), torch.zeros(5, 2), torch.zeros(1), torch.zeros(1), "x")
