"""The explicit-collective step: each rank's block of the ELBO, summed.

Counterpart of ``spatial_alignment_tpu/parallel/shardmap.py``. Rank (d, k)
of a (data, model) mesh holds the d-th contiguous block of every
modality's padded point axis and, for each modality the model axis shards
(:func:`.sharding.model_sharded`), the k-th block of its latent GPs
(``Omega_sqt_F``, ``delta_F``, the LMC rows of ``W``). It computes the warp
layer on its points, the data layer on its points and latents, the
likelihood of its points, and the KL terms.

**Noise.** Full batch: every rank draws the full ``(S, V, Ntot, D)`` warp
and ``(S, V*Np, L)`` data normals from its generator, which holds the same
state on every rank (one model, one seed), and slices out its block, so a
world of one draws and computes what the one-process step does, bit for
bit. Minibatch (stratified, as the JAX package's ``_local_minibatch``):
each data shard draws ``B / n_data`` points per view uniformly from its own
real points, weighted ``count / b``. JAX folds the shard's index into one
key; here the one generator draws every shard's uniform variates and
normals in one call and each shard takes its own, so the state a checkpoint
carries is one generator's, as JAX's is one key. Injected noise
(``warp_noise`` / ``data_noise``) has the one-process full-batch shapes.

**The gradient contract.** The loss value on every rank is the global
``-LL + KL``. What each rank backpropagates is its own objective

    -(LL_R / n_model + LL_P) + KL_R / (n_data n_model) + KL_P / n_data

where ``LL_R`` is the likelihood of its points in the modalities whose
observed outputs every model rank holds whole (those the model axis does not
shard, and the LMC ones, whose ``F_obs`` is summed over the model axis by
:class:`.collectives.SumOverGroup`, the cotangent summed back), ``LL_P`` that
of its own output channels of a sharded modality without LMC, ``KL_R`` the
warp terms and every replicated data term, ``KL_P`` the data KL of its own
latents. The replicated leaves' gradients are summed over the world and the
model-sharded leaves' over the data axis, each in one all-reduce of a
flattened buffer in the backward (:class:`.collectives.ReplicatedGrads`), so
after ``backward()`` every rank holds the one-process gradient: KL counted
once, the likelihood once per point. The optimizer then steps identically
on every rank and the replicated leaves stay equal bit for bit.

A step's collectives: one all-reduce of the (LL_R, LL_P, KL_P) triple over
the world in the forward, one of the replicated gradients over the world,
and, where the model axis shards a modality, one of the sharded gradients
over the data axis (when it has more than one rank) and two a sharded LMC
modality over the model axis (``F_obs`` and its cotangent; ``F_obs`` mean
and variance under ``analytic_data_likelihood``). No all-gather.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from ..models import core
from ..models._trees import named_leaves
from ..models.spec import ModelSpec
from .collectives import SumOverGroup, ValueOf, replicated
from .sharding import DATA_AXIS, MODEL_AXIS, comms, mesh_shape, model_sharded

_SHARDED_TREES = ("Omega_sqt_F", "delta_F", "W")


def _local_spec(spec: ModelSpec, n_shards: int, n_model: int = 1) -> ModelSpec:
    """Spec whose per-view padded sizes are the per-shard slice sizes, and
    whose model-sharded modalities have the rank's latents (and, without
    LMC, its output channels)."""
    sharded = model_sharded(spec, n_model)
    mods = []
    for m in spec.modalities:
        if m.n_padded % n_shards:
            raise ValueError(
                f"modality {m.name!r}: n_padded={m.n_padded} not divisible by "
                f"{n_shards} shards; construct the model with pad_multiple={n_shards}"
            )
        kw = dict(n_padded=m.n_padded // n_shards)
        if m.name in sharded:
            kw["n_latent"] = m.n_latent // n_model
            if not m.use_lmc:
                kw["n_outputs"] = m.n_outputs // n_model
        mods.append(dataclasses.replace(m, **kw))
    return spec.replace(modalities=tuple(mods))


def _set_path(tree: dict, path: str, value):
    *head, last = path.split("/")
    for p in head:
        tree = tree[p]
    tree[last] = value


def _rebuild(params: dict, by_path: dict) -> dict:
    out = {k: (dict(v) if isinstance(v, dict) else v) for k, v in params.items()}
    for path, value in by_path.items():
        _set_path(out, path, value)
    return out


class Executor:
    """The rank's part of the distributed negative ELBO for one spec and
    mesh (see the module doc). ``loss(params, batch, S, temp, generator,
    warp_noise, data_noise)`` takes the rank's blocks, as
    :func:`.sharding.distribute` leaves them on the model, and returns the
    global loss with the rank's objective's gradient."""

    def __init__(self, spec: ModelSpec, mesh, consts: dict, minibatch_size=None):
        shape = mesh_shape(mesh)
        self.spec, self.consts = spec, consts
        self.n_data, self.n_model = shape[DATA_AXIS], shape[MODEL_AXIS]
        self.d, self.k = mesh.get_local_rank(DATA_AXIS), mesh.get_local_rank(MODEL_AXIS)
        self.comms = comms(mesh)
        self.sharded = model_sharded(spec, self.n_model)
        self.lspec = _local_spec(spec, self.n_data, self.n_model)
        self.mb_lspec = None
        if minibatch_size is not None:
            if minibatch_size % self.n_data:
                raise ValueError(
                    f"minibatch_size={minibatch_size} not divisible by the "
                    f"data-axis size {self.n_data}"
                )
            self.mb_lspec = core.minibatch_spec(self.lspec, minibatch_size // self.n_data)

    # ------------------------------------------------------------------
    def _route(self, params: dict) -> dict:
        """The params through the gradient reductions: replicated leaves
        summed over the world, model-sharded ones over the data axis."""
        named = named_leaves(params)
        is_sh = [p.split("/")[0] in _SHARDED_TREES and p.split("/")[1] in self.sharded
                 for p, _ in named]
        rep = [(p, t) for (p, t), s in zip(named, is_sh) if not s]
        sh = [(p, t) for (p, t), s in zip(named, is_sh) if s]
        out = dict(zip([p for p, _ in rep],
                       replicated(self.comms["world"], [t for _, t in rep])))
        data = self.comms[DATA_AXIS] if self.n_data > 1 else None
        out.update(zip([p for p, _ in sh], replicated(data, [t for _, t in sh])))
        return _rebuild(params, out)

    def _latents(self, mod, x: torch.Tensor) -> torch.Tensor:
        """The rank's latents (last dim) of a full-width tensor."""
        if mod.name not in self.sharded:
            return x
        size = mod.n_latent // self.n_model
        return x.narrow(-1, self.k * size, size)

    def _slice_noise(self, lspec, wn, dn, n_points):
        """The rank's block of full warp noise (S, V, Ntot, D) and data
        noise {mod: (S, V*Np, L)}, Np = ``n_points[mod]`` full points."""
        parts, off = [], 0
        for m in lspec.modalities:
            parts.append(wn.narrow(2, off + self.d * m.n_padded, m.n_padded))
            off += n_points[m.name]
        wn_loc = torch.cat(parts, dim=2) if len(parts) > 1 else parts[0]
        if dn is None:
            return wn_loc.contiguous(), None
        dn_loc = {}
        for m_full, m in zip(self.spec.modalities, lspec.modalities):
            full = dn[m_full.name]
            S_ = full.shape[0]
            full = full.reshape(S_, self.spec.n_views, n_points[m.name], full.shape[-1])
            loc = self._latents(m_full, full.narrow(2, self.d * m.n_padded, m.n_padded))
            dn_loc[m.name] = loc.reshape(S_, self.spec.n_views * m.n_padded, m.n_latent)
        return wn_loc.contiguous(), dn_loc

    def _draw_full(self, S, generator, device, n_points):
        """Full-batch noise as the one-process step draws it: the warp
        normals, then each modality's data normals."""
        spec = self.spec
        Ntot = sum(n_points.values())
        wn = torch.randn((S, spec.n_views, Ntot, spec.n_spatial_dims),
                         generator=generator, device=device)
        if spec.analytic_data_likelihood:
            return wn, None
        dn = {m.name: torch.randn((S, spec.n_views * n_points[m.name], m.n_latent),
                                  generator=generator, device=device)
              for m in spec.modalities}
        return wn, dn

    def _minibatch(self, batch, S, generator):
        """(sub-batch, warp noise, data noise) of this data shard: every
        shard's uniform variates and normals drawn in one call each, in the
        order indices, warp, data; this shard's taken."""
        spec, mb = self.spec, self.mb_lspec
        dev = next(iter(batch.values()))["coords"].device
        V, nd = spec.n_views, self.n_data
        u = {m.name: torch.rand((nd, V, m.n_padded), generator=generator, device=dev)[self.d]
             for m in mb.modalities}
        sub = _local_minibatch(self.lspec, mb, batch, u)
        Ntot = sum(m.n_padded for m in mb.modalities)
        wn = torch.randn((nd, S, V, Ntot, spec.n_spatial_dims),
                         generator=generator, device=dev)[self.d]
        dn = None
        if not spec.analytic_data_likelihood:
            dn = {m_full.name: self._latents(m_full, torch.randn(
                (nd, S, V * m.n_padded, m_full.n_latent), generator=generator,
                device=dev)[self.d]) for m_full, m in zip(spec.modalities, mb.modalities)}
        return sub, wn, dn

    # ------------------------------------------------------------------
    def loss(self, params, batch, S: int, temp=1.0, generator=None,
             warp_noise=None, data_noise=None) -> torch.Tensor:
        spec = self.spec
        hp = dict(self.consts)
        hp.update(self._route(params))
        if self.mb_lspec is not None:
            lspec = self.mb_lspec
            batch, wn, dn = self._minibatch(batch, S, generator)
        else:
            lspec = self.lspec
            n_full = {m.name: m.n_padded for m in spec.modalities}
            if warp_noise is None:
                dev = next(iter(batch.values()))["coords"].device
                warp_noise, data_noise = self._draw_full(S, generator, dev, n_full)
            wn, dn = self._slice_noise(lspec, warp_noise, data_noise, n_full)
        model = self.comms[MODEL_AXIS]
        lmc = {m.name for m in spec.modalities if m.name in self.sharded and m.use_lmc}
        own = {m.name for m in spec.modalities if m.name in self.sharded and not m.use_lmc}
        if own:  # a sharded modality without LMC: the rank's own output channels
            batch = {m.name: dict(batch[m.name], outputs=batch[m.name]["outputs"].narrow(
                -1, self.k * m.n_outputs, m.n_outputs)) if m.name in own else batch[m.name]
                for m in lspec.modalities}
        ll, kl = core.elbo_parts(
            lspec, hp, batch, S, temp, warp_noise=wn, data_noise=dn,
            reduce_obs=lambda n, t: SumOverGroup.apply(model, t) if n in lmc else t)
        zero = lambda: torch.zeros((), dtype=hp["delta_G"].dtype, device=hp["delta_G"].device)
        KL_R, KL_P, LL_R, LL_P = zero(), zero(), zero(), zero()
        for name, part in kl:
            if name in self.sharded:
                KL_P = KL_P + part
            else:
                KL_R = KL_R + part
        for name, part in ll:
            if name in own:
                LL_P = LL_P + part
            else:
                LL_R = LL_R + part

        n_rep = self.n_data * self.n_model
        ll_obj = LL_R if self.n_model == 1 else LL_R / self.n_model
        kl_obj = KL_R if n_rep == 1 else KL_R / n_rep
        if own:
            ll_obj = ll_obj + LL_P
        if self.sharded:
            kl_obj = kl_obj + (KL_P if self.n_data == 1 else KL_P / self.n_data)
        objective = -ll_obj + kl_obj
        parts = self.comms["world"].all_reduce(torch.stack([LL_R, LL_P, KL_P]).detach())
        LL = parts[0] / self.n_model + parts[1]
        KL = KL_R.detach() + parts[2] / self.n_data
        return ValueOf.apply(objective, -LL + KL)


def make_shardmap_neg_elbo(spec: ModelSpec, mesh, consts: dict, S: int, minibatch_size=None):
    """Returns ``neg_elbo(params, batch, generator=None, *, warp_noise=None,
    data_noise=None) -> 0-d tensor``, run SPMD: every rank calls it with its
    blocks of the params and the batch (:func:`.sharding.distribute`'s
    layout) and gets the global negative ELBO, whose ``backward()`` leaves
    the global gradient in every leaf (module doc).

    ``generator`` takes the place of JAX's key: a ``torch.Generator`` in the
    same state on every rank. ``minibatch_size=B`` (global, divisible by the
    data-axis size) switches to stratified minibatch SVI: each shard draws
    B / n_data points per view from its own block, unbiased like the
    one-process ``core.subsample_batch`` and with no communication for the
    gather."""
    ex = Executor(spec, mesh, consts, minibatch_size=minibatch_size)

    def neg_elbo(params, batch, generator=None, *, warp_noise=None, data_noise=None):
        return ex.loss(params, batch, S, 1.0, generator, warp_noise, data_noise)

    return neg_elbo


def make_shardmap_train_step(
    spec: ModelSpec,
    mesh,
    consts: dict,
    S: int,
    lr: float = 1e-2,
    optimizer=None,
    minibatch_size=None,
):
    """A full training step through the explicit-collective executor.

    Returns ``(step, init)``: ``init(params)`` builds the optimizer over the
    rank's leaves (``optimizer(params)``, a factory, or Adam at ``lr``) and
    ``step(params, opt, batch, generator) -> (params, opt, loss)`` runs the
    loss, its backward (the gradients summed over the ranks inside) and the
    optimizer's step, updating ``params`` in place. ``generator`` takes the
    place of JAX's key (see :func:`make_shardmap_neg_elbo`)."""
    neg_elbo = make_shardmap_neg_elbo(spec, mesh, consts, S, minibatch_size)

    def init(params):
        from ..models._trees import leaves

        if optimizer is not None:
            return optimizer(leaves(params))
        return torch.optim.Adam(leaves(params), lr=lr)

    def step(params, opt, batch, generator=None):
        opt.zero_grad(set_to_none=True)
        loss = neg_elbo(params, batch, generator)
        loss.backward()
        opt.step()
        return params, opt, loss.detach()

    return step, init


def _local_minibatch(lspec: ModelSpec, mb_lspec: ModelSpec, batch, u: Dict[str, torch.Tensor]):
    """Stratified subsample of this shard's local point block from the
    uniform variates ``u`` ({mod: (V, b)}).

    Real points occupy a contiguous prefix of every local slice (the global
    prefix-padded layout split contiguously), so ``floor(u * count)`` with
    the local real count (from the mask) samples uniformly over real points
    only. The masks carry ``count_v / b`` weights; summed over shards by the
    likelihood's all-reduce this is the stratified unbiased estimator of the
    full-data likelihood. A shard whose slice is all padding gets weight 0
    (its gathered padding is multiplied out of the sum)."""
    sub = {}
    for m_local, m_mb in zip(lspec.modalities, mb_lspec.modalities):
        b = m_mb.n_padded
        bb = batch[m_local.name]
        count = bb["mask"].sum(dim=1)
        idx = torch.minimum(torch.floor(u[m_local.name] * count[:, None]),
                            torch.clamp_min(count[:, None] - 1.0, 0.0)).long()
        sub[m_local.name] = {
            "coords": torch.take_along_dim(bb["coords"], idx[..., None], dim=1),
            "outputs": torch.take_along_dim(bb["outputs"], idx[..., None], dim=1),
            "mask": (count[:, None] / b).expand(count.shape[0], b),
        }
    return sub
