"""Nested dicts of tensors (parameters, constants, batches): their leaves
in a fixed order, a map over several trees of one structure, and copies
between them."""

from __future__ import annotations

import torch


def leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in leaves(v)]
    return [tree]


def named_leaves(tree, prefix: str = "") -> list:
    """[(slash-joined path, leaf)] in :func:`leaves` order."""
    if isinstance(tree, dict):
        return [nl for k, v in tree.items() for nl in named_leaves(v, f"{prefix}{k}/")]
    return [(prefix[:-1], tree)]


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure, leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def tree_equal(a, b) -> bool:
    """Structure and value equality of two small tensor trees."""
    la, lb = named_leaves(a), named_leaves(b)
    return [n for n, _ in la] == [n for n, _ in lb] and all(
        x.shape == y.shape and torch.equal(x.cpu(), y.cpu()) for (_, x), (_, y) in zip(la, lb)
    )


def copy_into(dst, src):
    """Write tree ``src`` into the tensors of tree ``dst`` in place (a
    captured step keeps reading them)."""
    with torch.no_grad():
        for d, s in zip(leaves(dst), leaves(src)):
            d.copy_(s)
