"""Gene-set enrichment analysis (host-side numpy).

The port's copy of ``spatial_alignment_tpu/utils/gsea.py`` (the port imports
nothing of the JAX package). A Python replacement for the reference's R
handoff (its ST gene-variance GSEA script), which z-scales a per-gene statistic (aligned-expression variance), runs a
permutation preranked GSEA over GMT gene-set collections, and a Fisher-exact
test over the top-ranked hit genes. Both tests are implemented directly so
the pipeline runs without R/piano.

The enrichment score is the classic weighted Kolmogorov-Smirnov running-sum
statistic (Subramanian et al. 2005): walk the ranked gene list, stepping up
by |stat|^p (p=1) for set members and down uniformly otherwise; ES is the
maximum-magnitude excursion. Significance comes from permuting gene labels.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

__all__ = [
    "load_gmt",
    "bh_fdr",
    "enrichment_score",
    "permutation_gsea",
    "fisher_exact_gsea",
]


def load_gmt(path: str) -> Dict[str, List[str]]:
    """Parse a GMT gene-set file: ``name <tab> description <tab> gene...``."""
    sets: Dict[str, List[str]] = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                sets[parts[0]] = [g for g in parts[2:] if g]
    return sets


def bh_fdr(pvals: np.ndarray) -> np.ndarray:
    """Benjamini-Hochberg adjusted p-values."""
    p = np.asarray(pvals, dtype=float)
    n = p.size
    order = np.argsort(p)
    ranked = p[order] * n / (np.arange(n) + 1)
    # enforce monotonicity from the largest p down
    ranked = np.minimum.accumulate(ranked[::-1])[::-1]
    out = np.empty(n)
    out[order] = np.clip(ranked, 0.0, 1.0)
    return out


def enrichment_score(
    ranked_stats: np.ndarray, in_set: np.ndarray, p: float = 1.0
) -> float:
    """KS running-sum ES for one gene set over a DESCENDING-ranked stat list.

    ``in_set`` is a boolean mask aligned with ``ranked_stats``.
    """
    w = np.abs(ranked_stats) ** p
    hit_w = np.where(in_set, w, 0.0)
    total_hit = hit_w.sum()
    n_miss = int((~in_set).sum())
    if total_hit == 0 or n_miss == 0:
        return 0.0
    steps = hit_w / total_hit - (~in_set) / n_miss
    running = np.cumsum(steps)
    return float(running[np.argmax(np.abs(running))])


def permutation_gsea(
    gene_names: Sequence[str],
    gene_stats: np.ndarray,
    gene_sets: Dict[str, Sequence[str]],
    n_perm: int = 1000,
    min_size: int = 3,
    seed: int = 0,
) -> List[dict]:
    """Preranked GSEA with gene-label permutation nulls.

    Returns one record per (sufficiently represented) gene set:
    ``{pathway, size, ES, NES, pval, padj}``. NES = ES normalized by the
    mean |ES| of same-sign permutation ESs (Subramanian et al. convention).
    """
    gene_names = np.asarray(list(gene_names))
    stats = np.asarray(gene_stats, dtype=float)
    order = np.argsort(-stats)
    ranked_names = gene_names[order]
    ranked_stats = stats[order]
    name_pos = {g: i for i, g in enumerate(ranked_names)}
    rng = np.random.default_rng(seed)

    records = []
    masks = []
    for pathway, members in gene_sets.items():
        mask = np.zeros(len(ranked_names), dtype=bool)
        for g in members:
            i = name_pos.get(g)
            if i is not None:
                mask[i] = True
        size = int(mask.sum())
        if size >= min_size:
            records.append({"pathway": pathway, "size": size})
            masks.append(mask)
    if not records:
        return []

    es_obs = np.array([enrichment_score(ranked_stats, m) for m in masks])

    # Null: permute which genes carry the set labels (equivalently permute
    # the mask); the ranked stat vector stays fixed.
    null = np.empty((n_perm, len(records)))
    for t in range(n_perm):
        perm = rng.permutation(len(ranked_names))
        for j, m in enumerate(masks):
            null[t, j] = enrichment_score(ranked_stats, m[perm])

    pvals = np.empty(len(records))
    nes = np.empty(len(records))
    for j, es in enumerate(es_obs):
        same_sign = null[:, j][np.sign(null[:, j]) == np.sign(es)]
        if es == 0.0:
            pvals[j] = 1.0  # zero excursion = no evidence of enrichment
            nes[j] = 0.0
        elif same_sign.size == 0:
            pvals[j] = 1.0 / (n_perm + 1)
            nes[j] = 0.0
        else:
            pvals[j] = (1 + np.sum(np.abs(same_sign) >= abs(es))) / (
                1 + same_sign.size
            )
            nes[j] = es / np.mean(np.abs(same_sign))
    padj = bh_fdr(pvals)
    for j, rec in enumerate(records):
        rec.update(
            ES=float(es_obs[j]), NES=float(nes[j]), pval=float(pvals[j]), padj=float(padj[j])
        )
    records.sort(key=lambda r: r["padj"])
    return records


def fisher_exact_gsea(
    hit_genes: Sequence[str],
    all_genes: Sequence[str],
    gene_sets: Dict[str, Sequence[str]],
    min_size: int = 1,
) -> List[dict]:
    """Over-representation test of ``hit_genes`` in each gene set
    (one-sided Fisher exact over the ``all_genes`` universe), BH-adjusted.
    """
    from scipy.stats import fisher_exact

    universe = set(all_genes)
    hits = set(hit_genes) & universe
    records = []
    for pathway, members in gene_sets.items():
        in_set = set(members) & universe
        if len(in_set) < min_size:
            continue
        a = len(hits & in_set)
        b = len(hits - in_set)
        c = len(in_set - hits)
        d = len(universe) - a - b - c
        odds, p = fisher_exact([[a, b], [c, d]], alternative="greater")
        records.append(
            {
                "pathway": pathway,
                "n_hits_in_set": a,
                "set_size": len(in_set),
                "odds_ratio": float(odds),
                "pval": float(p),
            }
        )
    if records:
        padj = bh_fdr(np.array([r["pval"] for r in records]))
        for r, q in zip(records, padj):
            r["adj_pval"] = float(q)
        records.sort(key=lambda r: r["adj_pval"])
    return records
