"""Attention visualization (the port's copy of mcan_vqa_tpu/utils/
visualize.py; reference core/exec.py:256-350, 1068-1295).

Covers the reference's full visualization surface:
  * both score-matrix recipes -- ``calc_mats`` (answer-guided: q.a, v.a,
    core/exec.py:1243-1264) and ``calc_mats_v2`` (AttFlat-weight-guided,
    core/exec.py:1267-1284) -- producing the five-matrix set
    {q-q, q-a, v-a, v-v, v-q} over valid rows / top-k selected regions
  * the box-mask overlay (image darkened outside the top-k attended boxes,
    box ids annotated; core/exec.py plot_boxes/plot_boxesv2:1068-1240)
  * alpha-weighted question text and multi-glimpse AttFlat panels

Everything renders from the output dictionary of ``MCANet.
forward_outputs`` (logits / q / v / masks / AttFlat weights / ``fused``,
the reference Net's 8-tuple, core/model/net.py:131) as numpy arrays. The
score matrices and the box geometry are numpy only, copied from the JAX
package; ``run_visualization`` runs the port's ``Trainer``. matplotlib is
imported inside the renderers, which raise an ImportError naming it where
it is missing. Original images are optional: with none available a white
canvas is used so the overlay geometry still renders; normalized (0..1)
boxes are scaled to the canvas.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or an ImportError that names
    matplotlib (the renderers need it; the matrices do not)."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "rendering the visualization needs matplotlib, which is not "
            "installed (the score matrices and the forward do not)") from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


# ---------------------------------------------------------------------------
# score matrices
# ---------------------------------------------------------------------------

def _valid(out: dict, index: int):
    """Masked q/v rows + attention weights for one example."""
    q = np.asarray(out["q"])[index]
    v = np.asarray(out["v"])[index]
    q_w = np.asarray(out["q_w"])[index]          # [T, glimpses]
    v_w = np.asarray(out["v_w"])[index]          # [R, glimpses]
    q_keep = ~np.asarray(out["q_mask"])[index, 0, 0]
    v_keep = ~np.asarray(out["v_mask"])[index, 0, 0]
    return (q[q_keep], v[v_keep], q_w[q_keep], v_w[v_keep],
            np.nonzero(v_keep)[0])


def calc_mats_v2(out: dict, index: int, top_k: int = 7,
                 glimpse: int = 0) -> Dict[str, np.ndarray]:
    """AttFlat-weight-guided matrices (reference: core/exec.py:1267-1284).

    qa = the question AttFlat weights; va = top-k image AttFlat weights;
    vv/vq use only the top-k selected regions. Raw dot products, as the
    reference computes them.
    """
    q, v, q_w, v_w, v_ids = _valid(out, index)
    k = min(top_k, v.shape[0])
    order = np.argsort(v_w[:, glimpse])[::-1][:k]
    sel_v = v[order]
    return {
        "qq": q @ q.T,
        "qa": q_w[:, glimpse:glimpse + 1],
        "va_values": v_w[order, glimpse:glimpse + 1],
        "va_indices": v_ids[order],
        "vv": sel_v @ sel_v.T,
        "vq": sel_v @ q.T,
    }


def calc_mats(out: dict, index: int, top_k: int = 7) -> Dict[str, np.ndarray]:
    """Answer-guided matrices (reference: core/exec.py:1243-1264): the fused
    answer feature ``a`` scores tokens (q·a) and regions (v·a); top-k regions
    by v·a. Requires flat_out_size == hidden_size (the reference has the
    same dimensional constraint — q [T,H] @ a [F] only types when H == F).
    """
    q, v, _, _, v_ids = _valid(out, index)
    a = np.asarray(out["fused"])[index]
    if a.shape[-1] != q.shape[-1]:
        raise ValueError(
            f"calc_mats needs flat_out_size == hidden_size "
            f"({a.shape[-1]} vs {q.shape[-1]}); use calc_mats_v2")
    qa = (q @ a)[:, None]
    va = (v @ a)[:, None]
    k = min(top_k, v.shape[0])
    order = np.argsort(va[:, 0])[::-1][:k]
    sel_v = v[order]
    return {
        "qq": q @ q.T,
        "qa": qa,
        "va_values": va[order],
        "va_indices": v_ids[order],
        "vv": sel_v @ sel_v.T,
        "vq": sel_v @ q.T,
    }


# ---------------------------------------------------------------------------
# rendering
# ---------------------------------------------------------------------------

def find_image_file(images_dir: str, image_id) -> Optional[str]:
    """Resolve the COCO photograph for ``image_id`` under ``images_dir``.

    The reference hardcodes ``datasets/{split}2014/COCO_{split}2014_
    000000{iid}.jpg`` and silently skips absent files (core/exec.py:323-324);
    here every conventional COCO naming variant is tried, both directly in
    ``images_dir`` and in the standard split subdirectories. Returns None
    when no file exists (the renderer then falls back to the white canvas).
    """
    try:
        iid = int(image_id)
    except (TypeError, ValueError):
        return None
    names = [f"COCO_{s}_{iid:012d}.jpg"
             for s in ("train2014", "val2014", "test2015")]
    names += [f"{iid}.jpg", f"{iid}.png", f"{iid:012d}.jpg"]
    for sub in ("", "train2014", "val2014", "test2015"):
        for n in names:
            p = os.path.join(images_dir, sub, n)
            if os.path.exists(p):
                return p
    return None


def load_image(path: str) -> np.ndarray:
    """Photo -> float RGB in [0, 1] (reference: core/exec.py:1082 —
    ``plt.imread(im_file) / 255``; imread already returns floats for PNG,
    so only uint8-range data is rescaled here)."""
    plt = _pyplot()
    im = np.asarray(plt.imread(path), np.float32)
    if im.max() > 1.5:
        im = im / 255.0
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=-1)
    return im[..., :3]   # drop any alpha channel


def _canvas_and_boxes(image: Optional[np.ndarray], bboxes: np.ndarray,
                      size=(480, 640)):
    """Image (or white canvas) + pixel-space xyxy boxes. Normalized (0..1)
    boxes scale to the canvas."""
    if image is None:
        image = np.ones(size + (3,), np.float32)
    im = np.asarray(image, np.float32)
    if im.max() > 1.5:
        im = im / 255.0
    if im.ndim == 2:
        im = np.repeat(im[..., None], 3, axis=-1)
    boxes = np.asarray(bboxes, np.float32)[:, :4].copy()
    if boxes.size and boxes.max() <= 1.5:   # normalized coords
        h, w = im.shape[:2]
        boxes[:, [0, 2]] *= w
        boxes[:, [1, 3]] *= h
    return im, boxes


def box_mask_overlay(ax, image: Optional[np.ndarray], bboxes: np.ndarray,
                     va_values: np.ndarray, va_indices: np.ndarray) -> None:
    """The reference's signature panel: keep each top box at brightness
    proportional to its attention weight, darken everything else, annotate
    box ids (reference: core/exec.py:1088-1106)."""
    im, boxes = _canvas_and_boxes(image, bboxes)
    vals = np.asarray(va_values, np.float32).reshape(-1)
    lo, rng = float(vals.min()), float(vals.max() - vals.min())
    if rng == 0.0:
        # degenerate: all top-k weights equal (single valid region,
        # uniform attention). (v-lo)/1.0 would give every box weight 0
        # and render an all-black overlay — show the boxes at full
        # brightness instead (the reference divides by zero and NaNs
        # here, so there is no quirk to preserve)
        lo, rng = lo - 1.0, 1.0
    all_masks = np.zeros(im.shape, np.float32)
    rng_colors = np.random.default_rng(0)
    for i, region in enumerate(np.asarray(va_indices).reshape(-1)):
        x0, y0, x1, y1 = boxes[int(region)]
        left, top = int(x0), int(y0)
        w, h = int(x1 - x0), int(y1 - y0)
        weight = (vals[i] - lo) / rng
        mask = np.zeros(im.shape, np.float32)
        mask[max(top, 0):top + h, max(left, 0):left + w] = weight
        all_masks = np.clip(np.maximum(all_masks, mask), 0, 1)
        ax.text(left, top, str(int(region)), ha="right", va="bottom",
                color=rng_colors.random(3))
    ax.imshow(im * all_masks)
    ax.set_title("top-box mask overlay")
    ax.axis("off")


def _alpha_text(fig, words, weights, x=0.01, y=0.96, fontsize=11) -> None:
    """Question words drawn with alpha = normalized attention
    (reference: core/exec.py:1149-1157)."""
    w = np.asarray(weights, np.float32).reshape(-1)
    # normalize by |max| (as the q-a heatmap does): mats="v1" passes RAW
    # q.a dot products which can be all-negative — dividing by a
    # negative max would invert the emphasis (least-attended word at
    # full opacity); negatives then clip to the 0.05 floor below
    w = w / (np.abs(w).max() + 1e-9)
    for i, word in enumerate(words[:14]):
        alpha = float(np.clip(w[i] if i < len(w) else 0.0, 0.05, 1.0))
        fig.text(x, y, word, alpha=alpha, fontsize=fontsize)
        x += 0.013 * (len(word) + 1)


def render_reference_panels(
    out: dict,
    index: int,
    save_path: str,
    question_tokens: Optional[list] = None,
    preds: Optional[list] = None,
    answers: Optional[list] = None,
    bboxes: Optional[np.ndarray] = None,
    image: Optional[np.ndarray] = None,
    mats: str = "v2",
    top_k: int = 7,
) -> str:
    """The reference's six-figure sheet (core/exec.py:1068-1163 plot_boxes):
    box-mask overlay + the five matrices {v-v, q-q, q-a, v-a, v-q} with
    token/region tick labels + alpha-weighted question text + pred/answer
    captions. ``mats`` picks the recipe: "v2" (AttFlat-guided, the live
    reference path) or "v1" (answer-guided calc_mats)."""
    plt = _pyplot()
    from matplotlib.gridspec import GridSpec

    m = (calc_mats_v2 if mats == "v2" else calc_mats)(out, index, top_k)
    words = question_tokens or [f"w{i}" for i in range(m["qq"].shape[0])]
    words = list(words)[:m["qq"].shape[0]]
    pred = (preds or ["?"])[0]
    region_ids = [str(int(r)) for r in m["va_indices"]]

    fig = plt.figure(figsize=(11, 9))
    gs = GridSpec(4, 4, fig)

    ax0 = fig.add_subplot(gs[:3, :3])
    if bboxes is not None:
        box_mask_overlay(ax0, image, bboxes, m["va_values"], m["va_indices"])
    else:
        ax0.bar(region_ids, m["va_values"][:, 0])
        ax0.set_title("top region attention (no boxes available)")

    ax1 = fig.add_subplot(gs[0, 3])
    ax1.imshow(m["vv"])
    ax1.set_title("v-v")
    ax1.set_xticks(range(len(region_ids)), region_ids, fontsize=6)
    ax1.set_yticks(range(len(region_ids)), region_ids, fontsize=6)

    ax2 = fig.add_subplot(gs[1, 3])
    ax2.imshow(m["qq"])
    ax2.set_title("q-q")
    ax2.set_xticks(range(len(words)), words, fontsize=6, rotation=-45,
                   ha="left", rotation_mode="anchor")
    ax2.set_yticks(range(len(words)), words, fontsize=6)

    ax3 = fig.add_subplot(gs[3, 0])
    qa = m["qa"] / (np.abs(m["qa"]).max() + 1e-9)
    ax3.imshow(qa)
    ax3.set_title("q-a")
    ax3.set_yticks(range(len(words)), words, fontsize=6)
    ax3.set_xticks([0], [pred], fontsize=6)

    ax4 = fig.add_subplot(gs[3, 1])
    ax4.imshow(m["va_values"])
    ax4.set_title("v-a")
    ax4.set_yticks(range(len(region_ids)), region_ids, fontsize=6)
    ax4.set_xticks([0], [pred], fontsize=6)

    ax5 = fig.add_subplot(gs[3, 3])
    ax5.imshow(m["vq"])
    ax5.set_title("v-q")
    ax5.set_yticks(range(len(region_ids)), region_ids, fontsize=6)
    ax5.set_xticks(range(len(words)), words, fontsize=6, rotation=-45,
                   ha="left", rotation_mode="anchor")

    _alpha_text(fig, words, m["qa"][:, 0])
    if preds or answers:
        fig.text(0.01, 0.89, f"preds: {preds}\nans: {answers}", fontsize=8)

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.savefig(save_path, dpi=80)
    plt.close(fig)
    return save_path


def visualize_example(
    out: dict,
    index: int,
    save_path: str,
    question_tokens: Optional[list] = None,
    answer: Optional[str] = None,
    bboxes: Optional[np.ndarray] = None,
    top_k: int = 7,
) -> str:
    """Summary sheet: AttFlat panels (every glimpse), top-k regions, and the
    normalized q-q/v-v/v-q similarity heatmaps. ``render_reference_panels``
    is the reference-exact six-figure counterpart."""
    plt = _pyplot()

    q, v, q_w, v_w, v_ids = _valid(out, index)
    nq, nv = q.shape[0], v.shape[0]
    glimpses = q_w.shape[1]

    fig, axes = plt.subplots(2, 3, figsize=(15, 8))

    # alpha-weighted question text (reference: core/exec.py:332-344)
    ax = axes[0, 0]
    ax.set_title("question attention")
    ax.axis("off")
    toks = question_tokens or [f"w{i}" for i in range(nq)]
    wmax = q_w[:, 0].max() + 1e-9
    for i, tok in enumerate(toks[:nq]):
        alpha = min(1.0, max(0.0, float(0.15 + 0.85 * q_w[i, 0] / wmax)))
        ax.text(0.02 + (i % 5) * 0.2, 0.9 - (i // 5) * 0.18, tok,
                alpha=alpha, fontsize=14)
    if answer:
        ax.text(0.02, 0.05, f"answer: {answer}", fontsize=12, color="tab:red")

    # region attention, one bar series per glimpse
    ax = axes[0, 1]
    width = 0.8 / glimpses
    for g in range(glimpses):
        ax.bar(np.arange(nv) + g * width, v_w[:, g], width=width,
               label=f"glimpse {g}" if glimpses > 1 else None)
    if glimpses > 1:
        ax.legend(fontsize=7)
    ax.set_title("region attention (AttFlat)")

    # top-k regions (reference picks top-7 boxes, core/exec.py:300-311)
    ax = axes[0, 2]
    top = np.argsort(v_w[:, 0])[::-1][:top_k]
    if bboxes is not None:
        ax.set_title(f"top-{top_k} boxes")
        for r in top:
            x0, y0, x1, y1 = np.asarray(bboxes)[v_ids[r]][:4]
            ax.add_patch(plt.Rectangle((x0, y0), x1 - x0, y1 - y0,
                                       fill=False, color="tab:orange"))
        bb = np.asarray(bboxes)
        ax.set_xlim(0, max(1.0, float(np.max(bb[:, 2]))))
        ax.set_ylim(max(1.0, float(np.max(bb[:, 3]))), 0)
    else:
        ax.set_title(f"top-{top_k} region ids")
        ax.bar(range(len(top)), v_w[top, 0])
        ax.set_xticks(range(len(top)), [str(v_ids[t]) for t in top])

    def _norm_sim(a, b):
        an = a / (np.linalg.norm(a, axis=-1, keepdims=True) + 1e-9)
        bn = b / (np.linalg.norm(b, axis=-1, keepdims=True) + 1e-9)
        return an @ bn.T

    for ax, (mat, title) in zip(
            axes[1], [(_norm_sim(q, q), "q-q"),
                      (_norm_sim(v, v), "v-v"),
                      (_norm_sim(v, q), "v-q")]):
        im = ax.imshow(mat, cmap="viridis")
        ax.set_title(f"{title} similarity")
        fig.colorbar(im, ax=ax, fraction=0.046)

    os.makedirs(os.path.dirname(save_path) or ".", exist_ok=True)
    fig.tight_layout()
    fig.savefig(save_path, dpi=80)
    plt.close(fig)
    return save_path


def visualization_outputs(trainer, dataset, limit: int = 8
                          ) -> Dict[str, np.ndarray]:
    """The first min(limit, len(dataset)) examples through the model's
    ``forward_outputs`` on ``trainer.device``: eval mode, no autograd, the
    weights the trainer holds; the output dictionary as numpy arrays. The
    batch is assembled example by example (JAX's branch for a dataset
    without ``batch_examples``, visualize.py:384-386)."""
    import torch

    n = min(limit, len(dataset))
    examples = [dataset.example(i) for i in range(n)]
    img = torch.as_tensor(np.stack([e["img"] for e in examples]),
                          dtype=torch.float32, device=trainer.device)
    ques = torch.as_tensor(np.stack([e["ques"] for e in examples]),
                           device=trainer.device)
    model = trainer.model
    was_training = model.training
    model.eval()
    try:
        with torch.no_grad():
            out = model.forward_outputs(img, ques)
    finally:
        model.train(was_training)
    return {k: v.float().cpu().numpy() if v.is_floating_point()
            else v.cpu().numpy() for k, v in out.items()}


def run_visualization(trainer, dataset, out_dir: str, limit: int = 8,
                      top_k_preds: int = 4,
                      images_dir: Optional[str] = None) -> int:
    """Drive the model over the first ``limit`` examples and render both the
    summary sheet and the reference six-figure sheet per example
    (reference flow: core/exec.py:256-350): ``example_{i}.png`` and
    ``example_{i}_mats.png`` under ``out_dir``. The trainer's state is
    restored from the checkpoint its config names
    (``ensure_state(resume=True)``) first. -> the number of examples.

    images_dir: directory holding the original COCO photographs (flat or
    with train2014/val2014/test2015 subdirs). When a photo resolves, the
    reference's signature artifact renders -- the attended-box mask
    multiplied over the actual image (core/exec.py:1082,1106); otherwise
    the white-canvas fallback keeps the overlay geometry visible."""
    _pyplot()                      # refuse before the forward, not after
    trainer.ensure_state(resume=True)
    out = visualization_outputs(trainer, dataset, limit)
    n = out["logits"].shape[0]
    probs = 1 / (1 + np.exp(-out["logits"]))
    for i in range(n):
        ans = None
        preds = None
        if trainer.ix_to_ans:
            top = probs[i].argsort()[-top_k_preds:][::-1]
            preds = [trainer.ix_to_ans.get(str(int(t)), str(int(t)))
                     for t in top]
            ans = preds[0]
        bboxes = dataset.bboxes(i) if hasattr(dataset, "bboxes") else None
        toks = (dataset.question_tokens(i)
                if hasattr(dataset, "question_tokens") else None)
        gt = None
        ans_list = getattr(dataset, "ans_list", None)
        if ans_list and i < len(ans_list):
            gt = [a["answer"] for a in ans_list[i].get("answers", [])][:4]
        image = None
        if images_dir and hasattr(dataset, "image_id"):
            f = find_image_file(images_dir, dataset.image_id(i))
            if f is not None:
                image = load_image(f)
        visualize_example(out, i, os.path.join(out_dir, f"example_{i}.png"),
                          question_tokens=toks, answer=ans, bboxes=bboxes)
        render_reference_panels(
            out, i, os.path.join(out_dir, f"example_{i}_mats.png"),
            question_tokens=toks, preds=preds, answers=gt, bboxes=bboxes,
            image=image)
    return n
