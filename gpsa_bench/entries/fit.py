"""The ``fit`` entry: ``VariationalGPSA.fit``, each call a fresh Adam over
the model's captured training step.

A module of ``entries/`` is what a traffic mix's ``"entry"`` names. It
gives the window's call (:func:`call`) and the Adam steps of every restart
that a call of ``n_epochs`` makes (:func:`steps`); set-up's first calls and
what the comparison reads of them (:func:`first_steps`), and the reference
through the same steps (:func:`follow`); and one eager loss and gradient of
the step, whose op calls the traced run times (:func:`loss_and_grad`).
"""

from __future__ import annotations

import torch

from gpsa_bench import reference
from gpsa_bench.harness import flat

# The fit() calls set-up makes before the window (the first captures the
# step): the reference follows their steps.
FIRST_CALLS = (1, 2)


def call(model, cfg: dict, traffic: dict, n_epochs: int):
    """One fit() call; its losses."""
    train = cfg["train"]
    return model.fit(n_epochs, lr=float(train["lr"]), S=int(train["S"]),
                     minibatch_size=traffic.get("minibatch_size"))


def steps(traffic: dict, n_epochs: int) -> int:
    return n_epochs


def first_steps(model, cfg: dict, traffic: dict) -> dict:
    """Set-up's first fit() calls, through the window's own call: the
    losses, the first gradient as Adam received it (its first moment after
    one step over 1 - beta1) and the parameters after the last step."""
    beta1 = float(cfg["train"]["betas"][0])
    losses, grads = [], None
    for n in FIRST_CALLS:
        losses.extend(float(v) for v in call(model, cfg, traffic, n))
        if grads is None:
            state = model._opt_state
            grads = {k: state[f"{k}/exp_avg"].detach().double() / (1.0 - beta1)
                     for k in flat(model.params)}
    params = {k: v.detach().clone() for k, v in flat(model.params).items()}
    return {"losses": losses, "grads": grads, "params": params}


def follow(init: dict, data: dict, cfg: dict, traffic: dict, seed: int,
           precision: reference.Precision) -> tuple:
    """The reference's (losses, first gradients, parameters) through the
    same steps on ``data`` ({modality: (coordinates, outputs, counts)}),
    its draws from a generator seeded as the model's."""
    return reference.follow(init, data, cfg, FIRST_CALLS, seed, precision,
                            minibatch=traffic.get("minibatch_size"))


def loss_and_grad(model, cfg: dict, traffic: dict):
    """One eager loss and gradient of the training objective, as a step
    computes them, leaving the parameters' .grad alone."""
    loss = model._loss_fn(traffic.get("minibatch_size"))(
        model.params, int(cfg["train"]["S"]), 1.0, None, None)
    torch.autograd.grad(loss, model.parameters(), allow_unused=True)
