"""What decides ``correct``: the program's served tokens against the plain
reference.

Once the window has closed and the program's state is freed, a sample of
the answered requests, drawn from the seed and holding the longest prompt
among them, goes to the reference in float32 with the weights drawn again
from the seed.  The reference reads each prompt with the tokens the
program served, and at each served position takes the gap by which the
served token's logit lies below its own best.  The widest gap is
compared with the cell's limit (``limits/<cell>.json``).  A greedy token
may differ
from the float32 pick only where the two best logits are nearly tied, so a
sound bfloat16 program reads a small widest gap; the control, the
reference with float8 matrix products in the program's place
(:func:`control_gaps`), reads a large one.
"""

from __future__ import annotations

import importlib

import numpy as np
import torch

from portbench import models, traffic

# the widest gap when no answered request could be compared: fails any limit
NO_SAMPLE = 1e9


def reference(family: str):
    """``reference/<family>.py``'s ``logits_at``."""
    return importlib.import_module(f"portbench.reference.{family}").logits_at


def sample(seed: int, prompts: dict, served: dict, tokens: int) -> list:
    """Message ids to check: the longest prompt first, then others in a
    seeded order, until the served tokens reach ``tokens``."""
    ids = sorted(prompts, key=lambda m: (-len(prompts[m]), m))
    if not ids:
        return []
    rest = ids[1:]
    order = traffic.rng(seed, traffic.SAMPLE_STREAM).permutation(len(rest))
    chosen = [ids[0]]
    total = len(served[ids[0]])
    for i in order:
        if total >= tokens:
            break
        chosen.append(rest[i])
        total += len(served[rest[i]])
    return chosen


def sequences(prompts: dict, served: dict, chosen: list, device):
    """Each chosen request's prompt with its served tokens (the last one
    is never an input), the positions that predict each served token,
    and the served tokens."""
    seqs, rows, targets = [], [], []
    for m in chosen:
        prompt = np.asarray(prompts[m], np.int64)
        tokens = np.asarray(served[m], np.int64)
        seqs.append(torch.from_numpy(
            np.concatenate([prompt, tokens[:-1]])).to(device))
        rows.append(torch.arange(len(prompt) - 1,
                                 len(prompt) + len(tokens) - 1,
                                 device=device))
        targets.append(torch.from_numpy(tokens).to(device))
    return seqs, rows, targets


def served_gaps(logits: list, targets: list) -> torch.Tensor:
    """Per served token: the reference's best logit minus the served
    token's."""
    return torch.cat([
        (lg.max(-1).values - lg.gather(-1, t[:, None])[:, 0])
        for lg, t in zip(logits, targets)])


def control_gaps(stacked, sizes, seqs, rows) -> torch.Tensor:
    """Per position: the float32 reference's best logit minus its logit
    of the token that the float8 reference puts first."""
    logits_at = reference(sizes.family)
    exact = logits_at(stacked, sizes, seqs, rows)
    low = logits_at(stacked, sizes, seqs, rows, precision="fp8")
    return served_gaps(exact, [lg.argmax(-1) for lg in low])


def serving_checks(ctx, prompts: dict, served: dict, unanswered: list,
                   generate_tokens: int) -> tuple[dict, float, float | None]:
    """``{name: [value, limit]}``: requests due and never answered, replies
    of the wrong length or outside the vocabulary, and the widest gap over
    the seeded sample (``max_gap``); the program's widest gap; and, where
    ``ctx.control`` asks for it, the control's on the same sample (else
    ``None``)."""
    sizes = ctx.sizes
    bad = [m for m, t in served.items()
           if len(t) != generate_tokens
           or any(not 0 <= x < sizes.vocab for x in t)]
    good = {m: served[m] for m in served if m not in bad}
    chosen = sample(ctx.seed, {m: prompts[m] for m in good}, good,
                    ctx.cell.traffic["check_tokens"])
    gap = NO_SAMPLE
    control = None
    if chosen:
        stacked = models.stacked_weights(sizes, ctx.seed, ctx.device)
        seqs, rows, targets = sequences(prompts, good, chosen, ctx.device)
        logits = reference(sizes.family)(stacked, sizes, seqs, rows)
        gap = float(served_gaps(logits, targets).max())
        del logits
        if ctx.control:
            control = float(control_gaps(stacked, sizes, seqs, rows).max())
        del stacked
    checks = {
        "unanswered": [len(unanswered), 0],
        "bad_replies": [len(bad), 0],
        "max_gap": [gap, ctx.cell.limits["max_gap"]["limit"]],
    }
    return checks, gap, control


def passed(checks: dict) -> bool:
    return all(value <= limit for value, limit in checks.values())
