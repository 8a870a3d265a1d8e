"""Versioned JSON checkpoints for the learned autoscaling policy.

The port's copy of ``kube_sqs_autoscaler_tpu/learn/checkpoint.py``: the
same files, kinds, schema, validation messages and content hash, so the
port deploys the reference's checkpoints (``LEARNED_POLICY.json``,
``SERVING_POLICY.json``) as they are.  A checkpoint is the flat float32
parameter vector plus the network geometry and feature-schema pins that
give those numbers meaning.  :func:`load_checkpoint` carries the vector
onto a device (the card unless the caller asks for the CPU) as a float32
tensor; every float32 is exactly representable as a JSON double, so
``save -> load`` reproduces ``theta`` bit for bit.

Validation happens at **load time, before the loop starts**: a missing
file, corrupt JSON, wrong kind, unknown schema version (including a
*future* one), geometry/parameter-count mismatch, or non-finite weights
all raise :class:`CheckpointError` with the reference's message.

``checkpoint_hash`` fingerprints the decision-relevant content (canonical
JSON of kind/schema/geometry/theta plus the effective feature-window pins
— free-form provenance metadata excluded); the controller stamps it into
``build_info{policy}`` and the flight-journal meta.
"""

from __future__ import annotations

import hashlib
import json
import math
import os
from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from ..device import resolve_device
from .network import DEFAULT_HIDDEN, N_FEATURES, param_count

#: Current checkpoint schema.  Version 1: flat one-hidden-layer MLP over
#: the 8-feature vector (``network.policy_features``'s declaration
#: order).  Bump ONLY with a loader for every prior version.
SCHEMA_VERSION = 1

#: ``kind`` discriminator: rejects feeding some other JSON artifact
#: (a BENCH file, a journal header) to ``--policy-checkpoint``.
KIND = "kube-sqs-autoscaler-tpu/learned-policy"


class CheckpointError(ValueError):
    """A checkpoint failed validation (missing/corrupt/incompatible)."""


#: Training-twin kinds.  A checkpoint's weights only mean something
#: relative to the world that trained them: a FLUID-twin policy reads
#: queue-depth features scaled by the reference gate thresholds and
#: actuates replica counts; a SERVING-twin policy reads the serving
#: plane's request-queue depth and actuates shard counts with reward in
#: tokens/s + time-over-TTFT-SLO + churn.  Deploying one where the
#: other is expected is silent garbage, so the kind is stamped into
#: checkpoint meta and enforced at LOAD time by every deployment seam
#: (``LearnedPolicy``, replay, the fluid rollout, the serving twin).
TWIN_FLUID = "fluid"
TWIN_SERVING = "serving"
TWIN_KINDS = (TWIN_FLUID, TWIN_SERVING)


def checkpoint_twin(checkpoint: "PolicyCheckpoint") -> str:
    """The twin kind a checkpoint was trained in.

    Missing stamp = ``fluid``: every checkpoint before the serving twin
    existed was trained in the fluid twin, so the default keeps old
    artifacts deployable without rewriting them.
    """
    return str(checkpoint.meta.get("twin", TWIN_FLUID))


def require_twin(
    checkpoint: "PolicyCheckpoint", expected: str, seam: str
) -> None:
    """Reject a checkpoint whose training twin doesn't match the
    deployment seam — a load-time :class:`CheckpointError` naming both
    sides, never silent garbage mid-tick."""
    kind = checkpoint_twin(checkpoint)
    if kind != expected:
        raise CheckpointError(
            f"checkpoint {checkpoint.hash} was trained in the {kind!r}"
            f" twin; {seam} deploys {expected!r}-twin checkpoints —"
            f" retrain for this seam (reward units:"
            f" {checkpoint.meta.get('reward_units', 'unrecorded')!r})"
        )


def require_no_knob_head(
    checkpoint: "PolicyCheckpoint", seam: str
) -> None:
    """Reject a knob-headed checkpoint at a seam that assumes the
    headless theta layout.  The knob head is GEOMETRY — it widens the
    output layer, changing what the flat theta means — so a seam that
    evaluates headless populations refuses it loudly, never mis-slices
    it silently."""
    if getattr(checkpoint, "knob_head", False):
        raise CheckpointError(
            f"checkpoint {checkpoint.hash} carries a knob-action head;"
            f" {seam} trains/evaluates the headless up/hold/down layout"
            " — deploy the knob head through LearnedPolicy +"
            " sched.KnobActuator instead"
        )


#: History-ring capacity the learned features run on, train and deploy.
#: Smaller than the forecasters' 128 default on purpose: the feature set
#: (EWMA level, 12-sample trend) saturates well below 64 samples, and
#: the scan's per-tick history roll is O(capacity) — at 64 a training
#: generation is ~2× cheaper.  Stamped into checkpoint meta by the
#: trainer so deployment rebuilds the identical feature window.
DEFAULT_HISTORY = 64

#: Reactive warm-up ticks before the network decides (same contract as
#: ``PredictivePolicy``); stamped into checkpoint meta alongside history.
DEFAULT_MIN_SAMPLES = 3


def checkpoint_history(checkpoint: PolicyCheckpoint) -> tuple[int, int]:
    """(history capacity, min_samples) a checkpoint was trained with.

    Read from checkpoint meta (the trainer stamps both); the defaults
    cover hand-built checkpoints.  Deployment MUST use these — the EWMA
    level feature sees the whole ring, so a different capacity silently
    changes what the trained weights mean.
    """
    return (
        int(checkpoint.meta.get("forecast_history", DEFAULT_HISTORY)),
        int(checkpoint.meta.get("min_samples", DEFAULT_MIN_SAMPLES)),
    )


@dataclass(frozen=True)
class PolicyCheckpoint:
    """One loaded (or freshly trained) policy checkpoint."""

    theta: torch.Tensor  # float32, param_count(hidden, knob_head)
    hidden: int = DEFAULT_HIDDEN
    #: provenance: trainer config, seeds, scenario names, reward weights —
    #: free-form, excluded from the content hash
    meta: dict[str, Any] = field(default_factory=dict)
    #: the grown action space: three extra knob-delta output
    #: logits.  Geometry, not provenance — validated against the
    #: parameter count below and keyed into the content hash.
    knob_head: bool = False

    def __post_init__(self):
        theta = self.theta
        if not isinstance(theta, torch.Tensor):
            theta = torch.as_tensor(np.asarray(theta, dtype=np.float32))
        theta = theta.to(torch.float32).contiguous()
        object.__setattr__(self, "theta", theta)
        if self.hidden < 1:
            raise CheckpointError(f"hidden must be >= 1, got {self.hidden}")
        if not isinstance(self.knob_head, bool):
            raise CheckpointError(
                f"knob_head must be a bool, got {self.knob_head!r}"
            )
        expected = param_count(self.hidden, self.knob_head)
        if theta.shape != (expected,):
            raise CheckpointError(
                f"theta has {theta.numel()} parameters; hidden={self.hidden}"
                f" with knob_head={self.knob_head} needs exactly"
                f" {expected}"
            )
        if not bool(torch.isfinite(theta).all()):
            raise CheckpointError("theta contains non-finite values")
        # The feature-window pins are decision-relevant (read by
        # checkpoint_history and hashed): a malformed value must be a
        # CheckpointError here, not an int() traceback mid-deployment.
        if not isinstance(self.meta, dict):
            raise CheckpointError(f"meta must be a mapping, got {self.meta!r}")
        for key, floor in (("forecast_history", 1), ("min_samples", 0)):
            if key in self.meta:
                value = self.meta[key]
                if (
                    not isinstance(value, int)
                    or isinstance(value, bool)
                    or value < floor
                ):
                    raise CheckpointError(
                        f"meta[{key!r}] must be an integer >= {floor},"
                        f" got {value!r}"
                    )
        if "twin" in self.meta and self.meta["twin"] not in TWIN_KINDS:
            raise CheckpointError(
                f"meta['twin'] must be one of {TWIN_KINDS}, got"
                f" {self.meta['twin']!r}"
            )

    @property
    def hash(self) -> str:
        """Content fingerprint (first 12 hex of sha256; see module doc)."""
        return checkpoint_hash(self)

    def to_dict(self) -> dict[str, Any]:
        data = {
            "kind": KIND,
            "schema": SCHEMA_VERSION,
            "hidden": int(self.hidden),
            "n_features": N_FEATURES,
            "theta": self.theta.tolist(),
            "meta": self.meta,
        }
        if self.knob_head:
            # absent for headless checkpoints so pre-knob files (and
            # their byte-for-byte round trips) are untouched
            data["knob_head"] = True
        return data


def checkpoint_hash(checkpoint: PolicyCheckpoint) -> str:
    """sha256 over the canonical decision-relevant JSON, truncated to 12
    hex chars (enough to discriminate checkpoints in a label value).

    float32 -> Python float -> ``json.dumps`` is exact (every float32 is
    a representable double with an exact shortest-repr), so two
    checkpoints hash equal iff their decisions are bitwise equal.  The
    effective feature-window pins (``checkpoint_history``) are hashed
    too: the EWMA level feature sees the whole ring, so identical theta
    over a different window is a *different policy* — free-form
    provenance in ``meta`` stays excluded.
    """
    history, min_samples = checkpoint_history(checkpoint)
    content = {
        "kind": KIND,
        "schema": SCHEMA_VERSION,
        "hidden": int(checkpoint.hidden),
        "n_features": N_FEATURES,
        "forecast_history": history,
        "min_samples": min_samples,
        "theta": checkpoint.theta.tolist(),
    }
    # the training twin is decision-relevant (it names the feature
    # semantics and actuation units); keyed in only for non-fluid kinds
    # so every pre-serving-twin checkpoint keeps its published hash
    if checkpoint_twin(checkpoint) != TWIN_FLUID:
        content["twin"] = checkpoint_twin(checkpoint)
    if checkpoint.knob_head:
        # geometry is decision-relevant; keyed in only when armed so
        # every headless checkpoint keeps its published hash
        content["knob_head"] = True
    canonical = json.dumps(content, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(canonical.encode("utf-8")).hexdigest()[:12]


def save_checkpoint(path: str, checkpoint: PolicyCheckpoint) -> str:
    """Write ``checkpoint`` as versioned JSON; returns its content hash.

    Write-then-rename so a crash mid-write never leaves a torn file where
    a valid checkpoint used to be (the loader would reject the torn tail,
    but the *previous* weights would be gone).
    """
    data = checkpoint.to_dict()
    tmp = f"{path}.tmp"
    with open(tmp, "w") as fh:
        json.dump(data, fh, indent=1)
        fh.write("\n")
    os.replace(tmp, path)
    return checkpoint_hash(checkpoint)


def load_checkpoint(path: str,
                    device: str | torch.device = "cuda") -> PolicyCheckpoint:
    """Load + validate a checkpoint; :class:`CheckpointError` on any defect.
    Its ``theta`` lands on ``device`` (``"cuda"`` by default; a missing
    card raises, after the file has been validated).

    Every message names the path and the specific failure — this runs at
    CLI startup, where "reject before the loop starts" is the contract
    (a corrupt checkpoint must never surface as a mid-tick policy error
    silently falling back to reactive).
    """
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        raise CheckpointError(f"checkpoint {path!r} does not exist") from None
    except (OSError, json.JSONDecodeError) as err:
        raise CheckpointError(
            f"checkpoint {path!r} is unreadable or corrupt: {err}"
        ) from None
    if not isinstance(data, dict):
        raise CheckpointError(
            f"checkpoint {path!r} is not a JSON object"
        )
    if data.get("kind") != KIND:
        raise CheckpointError(
            f"checkpoint {path!r} has kind {data.get('kind')!r}, expected"
            f" {KIND!r} (is this really a learned-policy checkpoint?)"
        )
    schema = data.get("schema")
    if not isinstance(schema, int) or schema < 1:
        raise CheckpointError(
            f"checkpoint {path!r} has invalid schema version {schema!r}"
        )
    if schema > SCHEMA_VERSION:
        raise CheckpointError(
            f"checkpoint {path!r} has schema version {schema}, newer than"
            f" this build supports ({SCHEMA_VERSION}) — upgrade the"
            " controller or re-train the policy"
        )
    if data.get("n_features") != N_FEATURES:
        raise CheckpointError(
            f"checkpoint {path!r} was trained on"
            f" {data.get('n_features')!r} features; this build's feature"
            f" vector has {N_FEATURES} — re-train"
        )
    hidden = data.get("hidden")
    if not isinstance(hidden, int):
        raise CheckpointError(
            f"checkpoint {path!r} has invalid hidden size {hidden!r}"
        )
    theta = data.get("theta")
    if not isinstance(theta, list) or not all(
        isinstance(w, (int, float)) and math.isfinite(w) for w in theta
    ):
        raise CheckpointError(
            f"checkpoint {path!r} theta must be a list of finite numbers"
        )
    meta = data.get("meta") or {}
    if not isinstance(meta, dict):
        raise CheckpointError(f"checkpoint {path!r} meta must be an object")
    knob_head = data.get("knob_head", False)
    if not isinstance(knob_head, bool):
        raise CheckpointError(
            f"checkpoint {path!r} knob_head must be a bool, got"
            f" {knob_head!r}"
        )
    try:
        return PolicyCheckpoint(
            theta=torch.as_tensor(np.asarray(theta, dtype=np.float32),
                                  device=resolve_device(device)),
            hidden=hidden,
            meta=meta,
            knob_head=knob_head,
        )
    except CheckpointError as err:
        raise CheckpointError(f"checkpoint {path!r}: {err}") from None
