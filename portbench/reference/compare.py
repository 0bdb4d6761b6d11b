"""The numbers that decide ``correct``, each a gap between what the program
produced and what the reference works out again; a cell compares those its
``limits`` name.

Training (:func:`train_numbers`), on the draws that the benchmark handed
both sides:

  - ``adv_loss_gap``: the first step's losses, D's logistic loss and G's
    non-saturating loss of the first iteration (G's forward, D's forward on
    reals and fakes), each relative to ``max(|reference|, LOSS_FLOOR)``;
    the wider of the two;
  - ``r1_gap`` and ``path_gap``: the first iteration's R1 and path length
    penalties, each relative to the reference's;
  - ``d_grad_vec_gap``, ``g_grad_vec_gap`` and ``path_grad_vec_gap``: the
    gradients of the first iteration's ``d_step`` (D), ``g_step`` (G, with
    the battery) and ``g_reg_step`` (G's path length) as the optimizers get
    them, each leaf's as a vector: ``|prog - ref| / |ref|``; the median
    leaf. A gradient of the wrong sign, or one that leaves out a term, reads
    here, where the norms below do not;
  - ``battery0_gap``: the median over the battery's contrastive losses of
    each one's gap in the first iteration (before G has moved), relative to
    ``max(|reference|, LOSS_FLOOR)``;
  - ``change_gap``: each leaf's change over the checked iterations (Adam
    and the EMA), for G, D and G's EMA: the gap between the program's and
    the reference's norm, against the larger of the reference's norm of
    that leaf and of the median leaf; the worst leaf's;
  - ``change_median_gap``: the same gaps' median leaf, the widest of G's,
    D's and the EMA's.

Read beside them and not compared (no control or fault reads three times
their sound runs, so a limit on them could only fail sound runs; PERF.md
gives their readings): ``d_grad_gap`` (the median leaf's gap of ``d_step``'s
gradient norms: the net gradient of the reals' and the fakes' terms, which
cancel in part by a share that the seed sets), ``grad_gaps`` (the same for
each step kind's first gradient), ``worst_grad_gap`` (its worst leaf: a
scalar noise weight, whose gradient is a sum of millions of terms of either
sign), ``battery_gap`` (the median over the battery's contrastive losses of
each one's widest gap: the hair loss thresholds a mask, and the random
battery is chaotic in low precision), ``loss_gap`` (the first
iteration's step totals), ``r1_gap`` and ``path_gap`` (the first
iteration's penalties, relative to the reference's) and
``r1_grad_vec_gap`` (R1's gradient as a vector: double backward through D
in bf16).

Leaves whose reference gradient is under ``NOUGHT`` of the median leaf's (a
bias under a softmax, a bias under R1) are left out: of a step's gaps where
that step's gradient is so, of ``change_gap`` where every step's of their
module is (they move by round-off alone).

Serving (:func:`serve_numbers`): ``w_gap``, the widest gap of the assembled
w against the reference's largest ``|w|``, and ``img_worst_mae``, the largest
mean gap of one returned uint8 image from the reference's image quantised
alike, in levels.
"""

from __future__ import annotations

import numpy as np

LOSS_FLOOR = 0.01
NOUGHT = 1e-3


def loss_gap(prog: list[dict], ref: list[dict],
             keys=("d_loss", "d_r1_loss", "g_loss", "g_path_loss")) -> float:
    """The widest relative gap of the first iteration's losses ``keys``."""
    p, r = prog[0], ref[0]
    keys = [k for k in keys if k in r]
    if not all(k in p and np.isfinite(p[k]) for k in keys):
        return float("inf")
    return max(abs(p[k] - r[k]) / max(abs(r[k]), LOSS_FLOOR) for k in keys)


def rel_gap(prog: list[dict], ref: list[dict], key: str) -> float:
    """The first iteration's ``key`` relative to the reference's."""
    p, r = prog[0].get(key), ref[0].get(key)
    if r is None:
        return 0.0
    if p is None or not np.isfinite(p):
        return float("inf")
    return abs(p - r) / max(abs(r), 1e-30)


def battery_gap(prog: list[dict], ref: list[dict], losses: list[str]) -> float:
    gaps = []
    for k in losses:
        pairs = [(p[k], r[k]) for p, r in zip(prog, ref) if k in r]
        if not all(k in p and np.isfinite(p[k]) for p in prog[:len(pairs)]):
            return float("inf")
        gaps.append(max(abs(a - b) / max(abs(b), LOSS_FLOOR) for a, b in pairs))
    return float(np.median(gaps)) if gaps else 0.0


def _live(ref_grads: list[tuple[str, np.ndarray]], tag: str) -> np.ndarray | None:
    norms = [n for t, n in ref_grads if t == tag]
    if not norms:
        return None
    return np.any([n >= NOUGHT * np.median(n) for n in norms], axis=0)


def leaf_gaps(p: np.ndarray, r: np.ndarray, live: np.ndarray) -> np.ndarray:
    if p.shape != r.shape or not np.all(np.isfinite(p)):
        return np.array([np.inf])
    return np.abs(p - r)[live] / np.maximum(r, np.median(r[live]))[live]


def first_steps(grads: list[tuple[str, np.ndarray]], per_tag: dict[str, int]) -> list:
    """The first ``per_tag[tag]`` recorded steps of each optimizer."""
    out, seen = [], {}
    for t, n in grads:
        seen[t] = seen.get(t, 0) + 1
        if seen[t] <= per_tag.get(t, 0):
            out.append((t, n))
    return out


def step_gaps(prog: list, ref: list, per_tag: dict[str, int]) -> list[np.ndarray] | None:
    """Each compared step's leaf gaps, in step order; None when the program
    took other steps than the reference."""
    p, r = first_steps(prog, per_tag), first_steps(ref, per_tag)
    if len(p) != len(r) or any(a[0] != b[0] for a, b in zip(p, r)):
        return None
    return [leaf_gaps(np_, nr, nr >= NOUGHT * np.median(nr)) for (_, np_), (_, nr) in zip(p, r)]


def vector_gaps(prog: dict, ref: dict, per_tag: dict[str, int]) -> list[np.ndarray] | None:
    """Each first-iteration step's ``|prog - ref| / |ref|`` per live leaf
    (its whole gradient), in step order; None when the program took other
    steps than the reference."""
    p, r = prog["vectors"], ref["vectors"]
    norms = first_steps(ref["grads"], per_tag)
    if len(p) != len(r) or len(r) != len(norms) or any(a[0] != b[0] for a, b in zip(p, r)):
        return None
    out = []
    for (tag, a), (_, b), (_, nr) in zip(p, r, norms):
        if a.shape != b.shape or not np.all(np.isfinite(a)):
            out.append(np.array([np.inf]))
            continue
        edges = np.cumsum([0] + ref["sizes"][tag])
        live = nr >= NOUGHT * np.median(nr)
        gaps = []
        for i in np.flatnonzero(live):
            lo, hi = edges[i], edges[i + 1]
            den = np.linalg.norm(b[lo:hi])
            if den > 0:
                gaps.append(np.linalg.norm(a[lo:hi] - b[lo:hi]) / den)
        out.append(np.array(gaps))
    return out


def change_gap(prog: dict, ref: dict, ref_grads: list) -> float:
    worst = 0.0
    for k, r in ref.items():
        live = _live(ref_grads, "G" if k.startswith("G") else "D")
        worst = max(worst, float(np.max(leaf_gaps(prog[k], r, live))))
    return worst


def change_median_gap(prog: dict, ref: dict, ref_grads: list) -> float:
    widest = 0.0
    for k, r in ref.items():
        live = _live(ref_grads, "G" if k.startswith("G") else "D")
        widest = max(widest, float(np.median(leaf_gaps(prog[k], r, live))))
    return widest


def train_numbers(prog: dict, ref: dict, per_tag: dict[str, int], battery: list[str]) -> dict:
    """``per_tag``: the optimizer steps of the first iteration (D's first is
    ``d_step``); ``battery``: the metric names of the contrastive losses."""
    gaps = step_gaps(prog["grads"], ref["grads"], per_tag)
    medians = [float(np.median(g)) for g in gaps] if gaps else [float("inf")]
    vec = vector_gaps(prog, ref, per_tag)
    vec_medians = [float(np.median(g)) if len(g) else float("inf") for g in vec] if vec else []
    # the first iteration's steps in order: D's step and R1, G's step and path length
    by_step = dict(zip(("d_grad_vec_gap", "r1_grad_vec_gap", "g_grad_vec_gap",
                        "path_grad_vec_gap")[:len(vec_medians)], vec_medians))
    return {"adv_loss_gap": loss_gap(prog["losses"], ref["losses"], ("d_loss", "g_adv_loss")),
            "r1_gap": rel_gap(prog["losses"], ref["losses"], "d_r1_loss"),
            "path_gap": rel_gap(prog["losses"], ref["losses"], "g_path_loss"),
            **{k: by_step.get(k, float("inf")) for k in
               ("d_grad_vec_gap", "r1_grad_vec_gap", "g_grad_vec_gap", "path_grad_vec_gap")},
            "battery0_gap": battery_gap(prog["losses"][:1], ref["losses"][:1], battery),
            "change_gap": change_gap(prog["change"], ref["change"], ref["grads"]),
            "change_median_gap": change_median_gap(prog["change"], ref["change"], ref["grads"]),
            "d_grad_gap": medians[0],
            "battery_gap": battery_gap(prog["losses"], ref["losses"], battery),
            "loss_gap": loss_gap(prog["losses"], ref["losses"]),
            "grad_gaps": medians,
            "worst_grad_gap": max(float(np.max(g)) for g in gaps) if gaps else float("inf")}


def quantise(img01: np.ndarray) -> np.ndarray:
    """[0, 1] images to uint8 as the serving path does (round half to even)."""
    return np.round(np.clip(img01, 0.0, 1.0) * 255.0).astype(np.uint8)


def serve_numbers(pairs: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]) -> dict:
    """``pairs``: (program uint8 images, program w, reference uint8 images,
    reference w) per checked request. ``img_worst_mae`` is the largest mean
    gap of one image, in levels."""
    w_gap, worst = 0.0, 0.0
    for img, w, ref_img, ref_w in pairs:
        if img.shape != ref_img.shape or w.shape != ref_w.shape or not np.all(np.isfinite(w)):
            return {"w_gap": float("inf"), "img_worst_mae": float("inf")}
        w_gap = max(w_gap, float(np.max(np.abs(w - ref_w)) / max(np.max(np.abs(ref_w)), 1e-12)))
        gap = np.abs(img.astype(np.int16) - ref_img.astype(np.int16))
        worst = max(worst, float(gap.reshape(gap.shape[0], -1).mean(axis=1).max()))
    return {"w_gap": w_gap, "img_worst_mae": worst}


def train_detail(prog: dict, ref: dict, names: dict[str, list[str]],
                 first_iteration_steps: dict[str, int], top: int = 4) -> dict:
    """Where the training numbers come from: each loss's gap per iteration,
    and the worst leaves of each compared step and of each module's change,
    as ``[name, gap, program, reference]``."""
    out = {"losses": [{k: [p[k], r[k]] for k in r if k.endswith("_loss") and k in p}
                      for p, r in zip(prog["losses"], ref["losses"])]}

    def worst(p, r, live, leaf_names):
        scale = np.maximum(r, np.median(r[live]))
        gap = np.where(live, np.abs(p - r) / scale, 0.0)
        return [[leaf_names[i], float(gap[i]), float(p[i]), float(r[i])]
                for i in np.argsort(-gap)[:top]]

    steps = list(zip(first_steps(prog["grads"], first_iteration_steps),
                     first_steps(ref["grads"], first_iteration_steps)))
    out["grads"] = [[t, worst(p, r, r >= NOUGHT * np.median(r), names[t])]
                    for (t, p), (_, r) in steps]
    out["change"] = {k: worst(prog["change"][k], r, _live(ref["grads"], "G" if k.startswith("G")
                                                           else "D"), names[k[0]])
                     for k, r in ref["change"].items()}
    out["raw"] = {"grads": [[t, p.tolist(), r.tolist()] for (t, p), (_, r) in steps],
                  "change": {k: [prog["change"][k].tolist(), r.tolist()]
                             for k, r in ref["change"].items()},
                  "live": {t: _live(ref["grads"], t).tolist() for t in ("G", "D")}}
    return out
