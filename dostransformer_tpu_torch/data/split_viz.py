"""Split-balance statistics and their plot (reference utils.py:176, 243-245).

Counterpart of dostransformer_tpu/data/split_viz.py, the same statistics.
The reference's ``train_valid_test_split`` takes a ``plot`` flag and ships
``element_representation`` (utils.py:243-245), the fraction of an element's
samples that landed in a given split: the data behind a per-element
split-balance bar chart. This module gives the statistic, a per-element
table over named splits and a matplotlib rendering (matplotlib is imported
only inside the plot function; the package does not need it)::

    idx_tr, idx_va, idx_te = element_balanced_split(species_per_sample)
    stats = split_element_statistics(
        species_per_sample,
        {"train": idx_tr, "valid": idx_va, "test": idx_te})
    plot_split_statistics(stats, "splits.png")   # needs matplotlib
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Sequence

import numpy as np

__all__ = [
    "element_representation",
    "split_element_statistics",
    "plot_split_statistics",
]


def element_representation(members: Sequence[int],
                           split_idx: Sequence[int]) -> float:
    """Fraction of ``members`` (one element's sample indices) contained in
    ``split_idx`` (one split's sample indices) — utils.py:243-245 exactly,
    with the O(len*len) membership scan replaced by a set."""
    if len(members) == 0:
        return 0.0
    split = set(split_idx)
    return sum(1 for k in members if k in split) / len(members)


def split_element_statistics(
        species_per_sample: Sequence[Sequence[str]],
        splits: Mapping[str, Sequence[int]]) -> Dict[str, object]:
    """Per-element split-balance table.

    Args:
      species_per_sample: per-sample element-symbol lists (the splitter's
        input, utils.py:197-211 semantics — an element's member list is
        every sample containing it).
      splits: named index lists, e.g. ``{"train": [...], "valid": [...],
        "test": [...]}``.

    Returns a dict with ``species`` (sorted symbols), ``counts`` (samples
    containing each element, int array) and ``fractions`` (split name ->
    float array aligned with ``species``). Elements appearing in no sample
    are absent, matching the reference's empty-row drop (utils.py:219).
    """
    species = sorted({sp for row in species_per_sample for sp in row})
    members: Dict[str, List[int]] = {sp: [] for sp in species}
    for i, row in enumerate(species_per_sample):
        for sp in set(row):
            members[sp].append(i)
    counts = np.array([len(members[sp]) for sp in species], dtype=np.int64)
    fractions = {
        name: np.array([element_representation(members[sp], idx)
                        for sp in species], dtype=np.float64)
        for name, idx in splits.items()
    }
    return {"species": species, "counts": counts, "fractions": fractions}


# three categorical colours that stay apart on light and dark backgrounds
# and under colour-vision deficiency (the JAX package's palette)
_SERIES = ("#2a78d6", "#eb6834", "#1baf7a")
_SURFACE, _INK, _INK2 = "#fcfcfb", "#0b0b0b", "#52514e"


def plot_split_statistics(stats: Mapping[str, object], path: str,
                          per_row: int = 40) -> str:
    """Render the split-balance table as grouped per-element bars.

    One bar group per element, one thin bar per split, wrapped ``per_row``
    elements to an axes row so 100+ element corpora stay legible. Requires
    matplotlib (raises ImportError with guidance if absent); writes ``path``
    and returns it.
    """
    try:
        import matplotlib
    except ImportError as e:  # pragma: no cover - env-dependent
        raise ImportError(
            "plot_split_statistics needs matplotlib; install it or use "
            "split_element_statistics for the raw table") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    species: List[str] = list(stats["species"])
    fractions: Mapping[str, np.ndarray] = stats["fractions"]  # type: ignore
    names = list(fractions)
    n_rows = max(1, (len(species) + per_row - 1) // per_row)

    fig, axes = plt.subplots(
        n_rows, 1, figsize=(11, 2.1 * n_rows), squeeze=False,
        facecolor=_SURFACE)
    width = 0.8 / max(1, len(names))
    for r in range(n_rows):
        ax = axes[r][0]
        lo, hi = r * per_row, min(len(species), (r + 1) * per_row)
        x = np.arange(hi - lo)
        for j, name in enumerate(names):
            ax.bar(x + (j - (len(names) - 1) / 2) * width,
                   np.asarray(fractions[name])[lo:hi], width=width * 0.9,
                   color=_SERIES[j % len(_SERIES)], label=name if r == 0 else None)
        ax.set_xticks(x)
        ax.set_xticklabels(species[lo:hi], fontsize=7, color=_INK)
        # constant slot width across wrapped rows; a lone row hugs its data
        ax.set_xlim(-0.6, ((hi - lo) if n_rows == 1 else per_row) - 0.4)
        ax.set_ylim(0, 1)
        ax.set_facecolor(_SURFACE)
        ax.tick_params(colors=_INK2, labelsize=7)
        ax.grid(axis="y", color=_INK2, alpha=0.15, linewidth=0.5)
        for side in ("top", "right", "left"):
            ax.spines[side].set_visible(False)
        ax.spines["bottom"].set_color(_INK2)
    axes[0][0].legend(loc="lower right", bbox_to_anchor=(1.0, 1.0),
                      ncols=len(names), frameon=False, fontsize=8,
                      labelcolor=_INK)
    axes[0][0].set_title("per-element split representation",
                         fontsize=9, color=_INK, loc="left")
    fig.tight_layout()
    fig.savefig(path, dpi=150, facecolor=_SURFACE)
    plt.close(fig)
    return path
