"""Figure generation for analysis (a copy of ravvent_tpu/tools/plots.py).

Rebuild of the reference plotting suite (reference: make_plots.py,
analysis_utils.py:16-66), against the framework's APIs instead of stale
ones:

- raw signal with base-boundary markers (make_plots.py:15-51);
- event-detection illustration: t-stats + detected boundaries
  (make_plots.py:272-324);
- event-detection window grid-search heatmap (make_plots.py:193-269);
- learning curves from CSV logs (make_plots.py:327-397, analysis_utils.py);
- attention heatmaps from live model weights (make_plots.py:155-190, stale
  in the reference, working here): :func:`attention_alignment` computes the
  matrix with the port's model on the parameters' device;
- accuracy comparison bars (RNN types / data types, make_plots.py:113-153).

All functions take an optional ``out`` path; matplotlib uses the Agg
backend. It is imported inside each plotting function, so the module imports
where matplotlib is not installed.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ravvent_tpu_torch.data.event_detector import compute_tstats, detect_events
from ravvent_tpu_torch.models import attention as attn
from ravvent_tpu_torch.models import decoder as dec
from ravvent_tpu_torch.models.basecaller import encode_input


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_raw_with_bases(
    signal: np.ndarray,
    ranges: np.ndarray,
    bases: Sequence[str],
    start: int = 0,
    n_bases: int = 30,
    out: Optional[str] = None,
):
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 4))
    sel = ranges[start : start + n_bases]
    lo, hi = int(sel[0, 0]), int(sel[-1, 1])
    ax.plot(np.arange(lo, hi), signal[lo:hi], lw=0.8)
    for (s, e), b in zip(sel, bases[start : start + n_bases]):
        ax.axvline(s, color="gray", lw=0.5, alpha=0.6)
        ax.text((s + e) / 2, ax.get_ylim()[1], b.upper(), ha="center", va="top", fontsize=8)
    ax.set_xlabel("sample")
    ax.set_ylabel("current (DAC)")
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_event_detection(
    signal: np.ndarray, start: int = 0, length: int = 600, out: Optional[str] = None
):
    plt = _pyplot()

    seg = signal[start : start + length]
    t1 = compute_tstats(seg, 6, 9)
    t2 = compute_tstats(seg, 9, 9)
    ev = detect_events(seg)
    fig, axes = plt.subplots(2, 1, figsize=(12, 6), sharex=True)
    axes[0].plot(seg, lw=0.8)
    for s in ev[:, 0]:
        axes[0].axvline(s, color="red", lw=0.5, alpha=0.6)
    axes[0].set_ylabel("signal")
    axes[1].plot(t1, label="t-stat w=6", lw=0.8)
    axes[1].plot(t2, label="t-stat w=9", lw=0.8)
    axes[1].legend()
    axes[1].set_ylabel("t-stat")
    axes[1].set_xlabel("sample")
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_window_search_heatmap(
    results: Dict[Tuple[int, int], float], out: Optional[str] = None
):
    plt = _pyplot()
    wl1s = sorted({k[0] for k in results})
    wl2s = sorted({k[1] for k in results})
    grid = np.full((len(wl1s), len(wl2s)), np.nan)
    for (a, b), v in results.items():
        grid[wl1s.index(a), wl2s.index(b)] = v
    fig, ax = plt.subplots(figsize=(8, 5))
    im = ax.imshow(grid, aspect="auto", cmap="viridis")
    ax.set_xticks(range(len(wl2s)), wl2s)
    ax.set_yticks(range(len(wl1s)), wl1s)
    ax.set_xlabel("window_length2")
    ax.set_ylabel("window_length1")
    fig.colorbar(im, label="mean relative #events error")
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_learning_curves(csv_log_path: str, out: Optional[str] = None):
    plt = _pyplot()
    epochs, series = [], {}
    with open(csv_log_path) as f:
        reader = csv.DictReader(f)
        for row in reader:
            epochs.append(int(row["epoch"]))
            for k, v in row.items():
                if k != "epoch" and v != "":
                    series.setdefault(k, []).append(float(v))
    fig, axes = plt.subplots(1, 2, figsize=(12, 4))
    for k in ("loss", "val_loss"):
        if k in series:
            axes[0].plot(epochs[: len(series[k])], series[k], label=k)
    for k in ("acc", "val_acc"):
        if k in series:
            axes[1].plot(epochs[: len(series[k])], series[k], label=k)
    axes[0].set_xlabel("epoch"); axes[0].set_ylabel("loss"); axes[0].legend()
    axes[1].set_xlabel("epoch"); axes[1].set_ylabel("accuracy"); axes[1].legend()
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def attention_alignment(params, cfg, raw: np.ndarray, event: np.ndarray,
                        targets: np.ndarray) -> np.ndarray:
    """The teacher-forced attention alignment of the first batch item,
    [T, S] (T = targets' width - 1 decoder steps, S memory positions): the
    port's ``encode_input``, ``setup_memory`` and ``decoder_step`` on the
    parameters' device."""
    dev = params["decoder"]["fc"]["kernel"].device
    with torch.no_grad():
        enc_out, mask = encode_input(params, torch.as_tensor(raw, dtype=torch.float32, device=dev),
                                     torch.as_tensor(event, dtype=torch.float32, device=dev), cfg)
        mem = attn.setup_memory(params["decoder"]["attention"], enc_out, mask)
        dec_in = torch.as_tensor(np.asarray(targets)[:, :-1], dtype=torch.int64, device=dev)
        B, T = dec_in.shape
        state = dec.zero_state(params["decoder"], B, cfg.dec_units, cfg.cell_type, dev)
        aligns = []
        emb = dec.embed(dec_in[:, 0], cfg.vocab_size)
        for t in range(T):
            state, _logits, align = dec.decoder_step(
                params["decoder"], state, emb, mem, 1, cfg.effective_attention, cfg.cell_type
            )
            aligns.append(align[0, 0].cpu().numpy())
            if t + 1 < T:
                emb = dec.embed(dec_in[:, t + 1], cfg.vocab_size)
    return np.stack(aligns)


def plot_attention_weights(
    params, cfg, raw: np.ndarray, event: np.ndarray, targets: np.ndarray,
    out: Optional[str] = None,
):
    """Teacher-forced attention alignment heatmap for the first batch item
    (working replacement for the reference's stale attention plots)."""
    plt = _pyplot()
    A = attention_alignment(params, cfg, raw, event, targets)  # [T, S]
    fig, ax = plt.subplots(figsize=(10, 6))
    im = ax.imshow(A, aspect="auto", cmap="magma")
    ax.set_xlabel("encoder memory position")
    ax.set_ylabel("decoder step")
    fig.colorbar(im, label="attention")
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_accuracy_bars(
    labels: Sequence[str], values: Sequence[float], title: str = "",
    reference_values: Optional[Sequence[float]] = None, out: Optional[str] = None,
):
    """Grouped accuracy comparison (RNN ablation / data types)."""
    plt = _pyplot()
    x = np.arange(len(labels))
    fig, ax = plt.subplots(figsize=(8, 4))
    w = 0.38 if reference_values is not None else 0.6
    ax.bar(x - (w / 2 if reference_values is not None else 0), values, w, label="this work")
    if reference_values is not None:
        ax.bar(x + w / 2, reference_values, w, label="reference")
        ax.legend()
    ax.set_xticks(x, labels)
    ax.set_ylabel("identity / accuracy")
    ax.set_title(title)
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig


# Reference thesis headline curve: test accuracy vs #distinct 6-mers on the
# reduced-simulator sets (reference: make_plots.py:54-78, hard-coded values;
# guppy from make_plots.py:60). Keys are distinct-6-mer counts.
REFERENCE_REDUCED_ACCS = {
    "raw": {45: 0.9557888274973054, 450: 0.9165415772299397,
            1024: 0.9047021978693855, 2048: 0.8721022707489905,
            4096: 0.7893045198856405},
    "event": {45: 0.9499866626024884, 450: 0.9103404033787701,
              1024: 0.8924013682974483, 2048: 0.7982214934080496,
              4096: 0.6285224738382291},
    "joint": {45: 0.9648854692249131, 450: 0.9315182947112179,
              1024: 0.92731976799608, 2048: 0.9114789653329526,
              4096: 0.7822268080455914},
    "guppy": {45: 0.919906, 450: 0.922886, 1024: 0.926774,
              2048: 0.911608, 4096: 0.922477},
}


def plot_accuracy_vs_kmers(
    ours: Dict[str, Dict[int, float]],
    show_reference: bool = True,
    title: str = "",
    out: Optional[str] = None,
):
    """Accuracy vs fraction-of-appearing-6-mers difficulty curve
    (reference: make_plots.py:54-78).

    ``ours`` maps modality -> {vocab_size: identity in [0,1]}. The
    reference's committed curve (and the guppy baseline) is drawn dashed
    for visual comparison — the underlying protocols differ (see
    results/REF_SWEEP.md caveats), so this is orientation, not a contest.
    """
    plt = _pyplot()
    colors = {"raw": "tab:red", "event": "tab:blue", "joint": "tab:green"}
    fig, ax = plt.subplots(figsize=(6.5, 4.5))
    for mod, series in ours.items():
        ks = sorted(series)
        ax.plot([k / 4096 for k in ks], [series[k] for k in ks],
                marker="o", label=f"{mod} (this work)",
                color=colors.get(mod, "black"))
    if show_reference:
        for mod, series in REFERENCE_REDUCED_ACCS.items():
            ks = sorted(series)
            style = dict(linestyle="dotted", color="purple") if mod == "guppy" \
                else dict(linestyle="dashed", color=colors.get(mod, "gray"), alpha=0.6)
            ax.plot([k / 4096 for k in ks], [series[k] for k in ks],
                    label=(f"{mod} (reference)" if mod != "guppy" else "ONT guppy (ref)"),
                    **style)
    ax.set_xlabel("Fraction of all appearing 6-mers")
    ax.set_ylabel("Test identity / accuracy")
    ax.set_ylim((0.55, 1.0))
    ax.set_xlim((0, 1.02))
    ax.grid(True, alpha=0.3)
    ax.legend(loc="lower left", fontsize=8)
    if title:
        ax.set_title(title)
    if out:
        fig.savefig(out, dpi=150, bbox_inches="tight")
        plt.close(fig)
    return fig
