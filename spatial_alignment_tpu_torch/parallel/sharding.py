"""Multi-GPU execution: the (data, model) mesh and each leaf's placement.

Counterpart of ``spatial_alignment_tpu/parallel/sharding.py``. The JAX
package is one controller over many devices; the port runs one process a
GPU (SPMD, launched by ``torchrun``): every rank builds the same model from
the same data and seed, then ``distribute(model, make_mesh(...))`` keeps on
each rank its own blocks and replicates the rest.

  * **data axis**: the point axis of each modality's padded layout, split
    into contiguous blocks (``pad_multiple`` makes it divide); the
    likelihood is a sum over points, all-reduced over the axis.
  * **model axis**: the latent GPs of ``Omega_sqt_F``, ``delta_F`` and the
    LMC rows ``W`` of every modality whose ``n_latent`` it divides; the
    observed outputs and the data layer's KL are summed over the axis.

``batch_shardings`` and ``param_shardings`` give each leaf's placement as
``torch.distributed.tensor`` placements, one per mesh dimension (data,
model): ``Shard(dim)`` or ``Replicate()`` (``torch.distributed.tensor``
is imported when they are made: it takes over a second). The step that
runs on this layout, with its explicit collectives, is :mod:`.shardmap`.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..models._trees import tree_map
from ..models.spec import ModelSpec
from .collectives import Comm

DATA_AXIS = "data"
MODEL_AXIS = "model"

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_mesh(
    n_devices: Optional[int] = None,
    model_parallel: int = 1,
    devices=None,
    backend: Optional[str] = None,
) -> DeviceMesh:
    """2-D (data, model) ``DeviceMesh`` over every rank of the default
    process group, ranks in row-major order (rank = data index x
    model_parallel + model index), as the JAX package reshapes its device
    list.

    ``devices``: the device type each rank runs on, ``"cuda"`` (None; each
    rank on ``cuda:LOCAL_RANK``) or ``"cpu"``. Without a default process
    group it is made from torchrun's environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``) with ``backend``, by default NCCL for
    CUDA and gloo for the CPU; with no such environment it raises. An
    existing group of another backend than that default is taken only when
    ``backend`` names it (gloo with CUDA tensors runs eagerly: its
    collectives cannot be captured). ``n_devices`` must equal the world
    size: a process owns one device, so there is no device list to cut.
    """
    dev_type = torch.device("cuda" if devices is None else devices).type
    if dev_type not in _BACKENDS:
        raise ValueError(f"devices must be 'cuda' or 'cpu', got {devices!r}")
    want = backend or _BACKENDS[dev_type]
    if not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ or "RANK" not in os.environ:
            raise RuntimeError(
                "make_mesh needs a process group: launch the script with torchrun "
                "(e.g. `torchrun --nproc-per-node 4 script.py`), which sets RANK and "
                "WORLD_SIZE, or call torch.distributed.init_process_group first"
            )
        if dev_type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group(want)
    elif dev_type == "cuda" and "LOCAL_RANK" in os.environ:
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
    if dist.get_backend() != want:
        raise RuntimeError(
            f"the default process group's backend is {dist.get_backend()!r}, not "
            f"{want!r} for {dev_type} models; pass backend={dist.get_backend()!r} to "
            "use it"
        )
    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(
            f"n_devices={n_devices} but the process group has {n} ranks: each rank "
            "owns one device, so the mesh spans the whole world"
        )
    if n % model_parallel:
        raise ValueError(f"{n} devices not divisible by model_parallel={model_parallel}")
    return init_device_mesh(dev_type, (n // model_parallel, model_parallel),
                            mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """{"data": n_data, "model": n_model}."""
    return {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}


def comms(mesh: DeviceMesh) -> Dict[str, Comm]:
    """The mesh's groups for :mod:`.collectives`: world, data and model."""
    shape = mesh_shape(mesh)
    return {
        "world": Comm("world", dist.group.WORLD, dist.get_world_size()),
        DATA_AXIS: Comm(DATA_AXIS, mesh.get_group(DATA_AXIS), shape[DATA_AXIS]),
        MODEL_AXIS: Comm(MODEL_AXIS, mesh.get_group(MODEL_AXIS), shape[MODEL_AXIS]),
    }


def model_sharded(spec: ModelSpec, n_model: int):
    """Names of the modalities whose latent GPs shard over a model axis of
    ``n_model`` ranks (``n_latent`` divisible, ``n_model`` > 1)."""
    if n_model <= 1:
        return set()
    return {mod.name for mod in spec.modalities if mod.n_latent % n_model == 0}


def batch_shardings(spec: ModelSpec, mesh: DeviceMesh):
    """{mod: {"coords", "outputs", "mask": placements}}: the point axis
    (dim 1) sharded over the data axis; requires each modality's n_padded
    to be a multiple of the data-axis size (use the model's
    ``pad_multiple`` constructor arg)."""
    from torch.distributed.tensor import Replicate, Shard

    n_data = mesh_shape(mesh)[DATA_AXIS]
    sh = {}
    for mod in spec.modalities:
        if mod.n_padded % n_data:
            raise ValueError(
                f"modality {mod.name!r}: n_padded={mod.n_padded} not divisible by "
                f"data-axis size {n_data}; construct the model with "
                f"pad_multiple={n_data}"
            )
        sh[mod.name] = {k: (Shard(1), Replicate()) for k in ("coords", "outputs", "mask")}
    return sh


def param_shardings(spec: ModelSpec, params: dict, mesh: DeviceMesh) -> dict:
    """Replicate everything except the per-latent-GP data-layer state, which
    shards over the model axis when L divides evenly."""
    from torch.distributed.tensor import Replicate, Shard

    repl = (Replicate(), Replicate())
    sh = tree_map(lambda _: repl, params)
    for name in model_sharded(spec, mesh_shape(mesh)[MODEL_AXIS]):
        mod = spec.modality(name)
        sh["Omega_sqt_F"][name] = (Replicate(), Shard(0))
        sh["delta_F"][name] = (Replicate(), Shard(1))
        if mod.use_lmc:
            sh["W"][name] = (Replicate(), Shard(0))
    return sh


def local_block(t: torch.Tensor, placements, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's contiguous block of a full tensor under ``placements``."""
    for i, p in enumerate(placements):
        if p.is_shard():
            n, k = mesh.size(i), mesh.get_local_rank(i)
            size = t.shape[p.dim] // n
            t = t.narrow(p.dim, k * size, size)
    return t.contiguous()


def gather_block(t: torch.Tensor, placements, mesh: DeviceMesh,
                 groups: Dict[str, Comm]) -> torch.Tensor:
    """The full tensor from this rank's block (all-gathers over each
    sharded mesh dimension; the inverse of :func:`local_block`)."""
    for i in reversed(range(len(placements))):
        p = placements[i]
        if p.is_shard() and mesh.size(i) > 1:
            t = groups[mesh.mesh_dim_names[i]].all_gather(t, dim=p.dim)
    return t


def distribute(model, mesh: DeviceMesh):
    """Keep on this rank its blocks of the model's params and packed batch
    under the mesh layout, and replicate the rest. Of the JAX package's two
    spec edits it makes one: ``merged_factor_dispatch`` is cleared where the
    model axis shards a modality; ``quad_diag_impl`` is kept (see below).

    After this, ``model.fit()`` and ``model.make_train_step()`` run the
    explicit-collective step of :mod:`.shardmap`, ``forward`` / ``predict``
    return full-size results on every rank, ``save`` writes the full
    parameters from rank 0, and ``fit_multistart`` spreads the restarts over
    the ranks. Returns the model (changed in place).
    """
    if model.device.type != mesh.device_type:
        raise ValueError(
            f"the model runs on {model.device.type}, the mesh on {mesh.device_type}"
        )
    # The JAX package sets quad_diag_impl="xla" here: its partitioner would
    # gather the sharded points around the Pallas call. Each rank here runs
    # the quad-diag kernel on its own block of rows, whose dF the replicated
    # gradients' all-reduce sums, so the model's choice stands.
    n_model = mesh_shape(mesh)[MODEL_AXIS]
    if model_sharded(model.spec, n_model):
        # Each rank holds its own latents of the Omega_sqt_F slabs: they are
        # factored (and their KL taken) apart from the replicated Grams.
        model.spec = dataclasses.replace(model.spec, merged_factor_dispatch=False)
    p_sh = param_shardings(model.spec, model.params, mesh)
    b_sh = batch_shardings(model.spec, mesh) if model._batch is not None else None
    full = tree_map(lambda t: t.detach().clone(), model.params)
    local = tree_map(lambda t, p: local_block(t, p, mesh).requires_grad_(True), full, p_sh)
    model.params = local
    if model._batch is not None:
        model._global_batch = model._batch
        model._batch = tree_map(lambda t, p: local_block(t, p, mesh), model._batch, b_sh)
    model._mesh = mesh
    model._comms = comms(mesh)
    # A cached loop holds the old tensors and the one-process step.
    model.__dict__.pop("_train_loop_cache", None)
    model.__dict__.pop("_vec_loop_cache", None)
    return model
