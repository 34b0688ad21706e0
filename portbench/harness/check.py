"""The numbers that decide `correct`, each against its limit.

Serving: `rec_rel_l2`, the worst relative L2 distance of a kept slice's
reconstruction from the reference's, and `rec_rel_l2_median`, the median
slice's; for a cell with a yardstick, `rec_over_yardstick`, the median
slice's distance over the reference's own in the yardstick's precision
(the same seed, the same inputs): it reads the program's rounding against
what that precision costs on this seed's weights, which vary; and
`slice_over_yardstick`, the worst slice's own ratio (each kept slice's
distance over the yardstick's distance on that same slice), which a fault
in a few slots of a request moves where the median does not.

Training, over the checked steps (the program's record against the
reference's, both from the same weights, inputs and draws):

  loss_rel        the worst relative gap of a step's loss_all
  loss_rel_first  the first step's (a forward from the same weights)
  grad_norm_gap   the first step's gradients: the worst leaf's gap
                  between the program's norm and the reference's, over the
                  larger of the reference's norm of that leaf and of the
                  median leaf
  change_norm_gap the same of each parameter's change over the checked
                  steps
                  Both leave out the still leaves, whose reference
                  gradient is under a thousandth of the median leaf's
                  (a conv's bias before a norm: they move under Adam by
                  round-off alone).
  *_gap_median    the median leaf's gap instead of the worst's
  stats_gap       the same of each statistic's change (BatchNorm running
                  mean and variance, spectral-norm u and v)
"""

import math

import numpy as np
import torch

STILL = 1e-3  # a leaf whose reference gradient is under this share of the median's


def slice_rel_l2(got, want: dict) -> list:
    """|got - want| / |want| of every slice of the kept answers."""
    out = []
    for j, rec in got:
        for a, b in zip(np.asarray(rec, np.float64), np.asarray(want[j], np.float64)):
            out.append(float(np.linalg.norm(a - b) / np.linalg.norm(b)))
    return out


def serve_numbers(got, want: dict, yard=None) -> dict:
    """The serving numbers of the kept answers `got` [(key, answer)]
    against the reference's {key: answer}; with `yard`, the reference's
    own answers in the yardstick's precision."""
    errs = slice_rel_l2(got, want)
    out = {"rec_rel_l2": max(errs), "rec_rel_l2_median": float(np.median(errs))}
    if yard is not None:
        if [j for j, _ in yard] != [j for j, _ in got]:
            raise ValueError("the yardstick's answers are not those of the kept requests")
        own = slice_rel_l2(yard, want)
        out["rec_over_yardstick"] = out["rec_rel_l2_median"] / float(np.median(own))
        out["slice_over_yardstick"] = max(e / y for e, y in zip(errs, own))
    if not all(math.isfinite(e) for e in errs):
        out = {k: math.inf for k in out}
    return out


def _norm(t):
    return float(torch.linalg.vector_norm(t.double()))


def leaf_gaps(got: dict, want: dict) -> dict:
    """{leaf: |norm(got) - norm(want)| over max(norm(want), median of
    norm(want))}; leaves are the keys of `want`."""
    ref = {k: _norm(v) for k, v in want.items()}
    med = float(np.median(list(ref.values()))) if ref else 0.0
    if med == 0.0:
        return {}
    return {k: abs(_norm(got[k]) - r) / max(r, med) for k, r in ref.items()}


def norm_gap(got: dict, want: dict, pick=max) -> float:
    """The worst leaf's gap (`leaf_gaps`), or with `pick` another
    statistic of the leaves' gaps."""
    gaps = list(leaf_gaps(got, want).values())
    if not gaps:
        return 0.0
    return float(pick(gaps)) if all(math.isfinite(g) for g in gaps) else math.inf


def train_leaves(got: dict, want: dict, before: dict):
    """The leaves that the train numbers compare, as (got, want) dicts of
    the first step's gradients, the parameters' changes and the
    statistics' changes, still leaves left out of the first two."""
    g_got, g_want, d_got, d_want, s_got, s_want = {}, {}, {}, {}, {}, {}
    for net, grads in want["grads"].items():
        for k, g in grads.items():
            g_want[(net, k)] = g
            g_got[(net, k)] = got["grads"][net][k]
    med = float(np.median([_norm(g) for g in g_want.values()]))
    for net, after in want["after"].items():
        for k, w in after.items():
            change = w.double() - before[net][k].double()
            mine = got["after"][net][k].double() - before[net][k].double()
            if (net, k) in g_want:
                if _norm(g_want[(net, k)]) >= STILL * med:
                    d_want[(net, k)], d_got[(net, k)] = change, mine
            else:
                s_want[(net, k)], s_got[(net, k)] = change, mine
    still = {k for k, g in g_want.items() if _norm(g) < STILL * med}
    for k in still:
        del g_want[k], g_got[k]
    return (g_got, g_want), (d_got, d_want), (s_got, s_want)


def train_numbers(got: dict, want: dict, before: dict) -> dict:
    """{number: value} of the program's record `got` against the
    reference's `want`; `before`, the weights both started from."""
    losses = [abs(g - w) / abs(w) for g, w in zip(got["losses"], want["losses"])]
    loss = max(losses) if all(math.isfinite(x) for x in losses) else math.inf
    grads, changes, stats = train_leaves(got, want, before)
    return {"loss_rel": loss, "loss_rel_first": losses[0] if math.isfinite(losses[0]) else math.inf,
            "grad_norm_gap": norm_gap(*grads), "grad_gap_median": norm_gap(*grads, pick=np.median),
            "change_norm_gap": norm_gap(*changes),
            "change_gap_median": norm_gap(*changes, pick=np.median),
            "stats_gap": norm_gap(*stats)}


def judge(values: dict, limits: dict):
    """(correct, [(name, value, limit)]): each number that the cell's
    limits name, finite and at or under its limit. A limit whose number
    was not computed fails."""
    rows = [(k, values.get(k, math.inf), lim) for k, lim in limits.items()]
    ok = bool(rows) and all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
