"""Checkpoint and resume of the train state, in the port's own format.

Counterpart of ``kube_sqs_autoscaler_tpu/workloads/checkpoint.py``.  The
reference writes orbax checkpoints, which the port cannot read and does
not pretend to: each step here is a directory ``step_{step:08d}/`` holding
one ``state.pt``, a single :func:`torch.save` of plain tensors, ints and
nested dicts and lists, so it loads with ``torch.load(weights_only=True)``:

- ``params``: the parameter tree (a LoRA run's merged weights);
- ``optimizer``: the AdamW state, ``{"count", "mu", "nu"}`` with the
  moments in :func:`.train.param_leaves` order (``optax``'s names);
- ``step``: the number of optimizer steps taken;
- ``lora`` (LoRA runs): ``{"adapters", "optimizer"}``, what a resume of a
  fine-tune restores.

A step is written under a temporary name in the same directory and
renamed into place, so a killed trainer never leaves a half-written step
(a leftover temporary directory is ignored by resume and retention).  The
tensors are copied to host memory before :meth:`TrainCheckpointer.save`
returns, so ``wait=False`` overlaps only the disk write with training.

The ``model_config.json`` manifest that tells a serving worker the family
and dimensions is the reference's, byte for byte, with its ``layout``
records ``moe``, ``lora`` and ``pipeline``.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys
import threading
from pathlib import Path
from typing import Any

import torch

from .llama import LlamaConfig
from .model import ModelConfig

# the manifest the trainer writes next to its checkpoints, so a serving
# worker pointed at the directory rebuilds the exact architecture
MODEL_MANIFEST = "model_config.json"
STATE_FILE = "state.pt"
# what an orbax step directory of the JAX package holds in place of
# STATE_FILE (its metadata files, the OCDBT manifest, the data directory)
ORBAX_MARKERS = ("_CHECKPOINT_METADATA", "_METADATA", "manifest.ocdbt", "d")


class OrbaxCheckpointError(ValueError):
    """A step directory is the JAX package's orbax checkpoint, which the
    port does not read."""


def exit_refused(err: Exception):
    """Leave a binary as a usage error does: the message on stderr, exit
    status 2, no traceback."""
    print(f"error: {err}", file=sys.stderr, flush=True)
    raise SystemExit(2)


def save_model_manifest(directory: str | Path, family: str, config: Any,
                        layout: dict | None = None) -> Path:
    """Record ``family`` and the config's JSON-representable fields
    (``dtype`` is storage, not architecture, and is left out) as the
    reference's ``save_model_manifest`` writes them.  ``layout`` records a
    non-flat parameter layout (``{"kind": "moe", ...}``, ``{"kind":
    "lora", ...}``, ``{"kind": "pipeline", "n_stages": N}``)."""
    payload = {"family": family}
    for name, value in vars(config).items():
        if isinstance(value, (int, float, str, bool)):
            payload[name] = value
    if layout is not None:
        payload["layout"] = layout
    path = Path(directory) / MODEL_MANIFEST
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(payload, indent=2) + "\n")
    return path


def load_model_manifest(directory: str | Path) -> tuple[str, Any]:
    """``(family, config)`` from a checkpoint directory's manifest."""
    payload = json.loads((Path(directory) / MODEL_MANIFEST).read_text())
    payload.pop("layout", None)  # the parameter layout, not architecture
    family = payload.pop("family")
    if family == "llama":
        return family, LlamaConfig(**payload)
    return family, ModelConfig(**payload)


def load_model_layout(directory: str | Path) -> dict | None:
    """The manifest's parameter-layout record (``None`` = flat params)."""
    payload = json.loads((Path(directory) / MODEL_MANIFEST).read_text())
    return payload.get("layout")


def _to_host(tree, count: int):
    """The on-disk form of an in-memory state: tensors detached and copied
    to host memory (a copy, so training may go on updating them), an
    optimizer as its moments, anything else as it is."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().to("cpu", copy=True)
    if hasattr(tree, "moments"):
        return _to_host(tree.moments(count), count)
    if isinstance(tree, dict):
        return {key: _to_host(value, count) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_host(value, count) for value in tree]
    return tree


def _copy_into(live, saved, where: str) -> None:
    """Copy a saved tree into the live tensors of the same structure, in
    place (shapes and dtypes must match)."""
    if isinstance(live, torch.Tensor):
        if not isinstance(saved, torch.Tensor) or saved.shape != live.shape:
            raise ValueError(
                f"checkpoint {where}: saved "
                f"{getattr(saved, 'shape', type(saved).__name__)} for a "
                f"live tensor of shape {tuple(live.shape)}"
            )
        if saved.dtype != live.dtype:
            raise ValueError(f"checkpoint {where}: saved {saved.dtype} for "
                             f"a live {live.dtype} tensor")
        with torch.no_grad():
            live.copy_(saved)
        return
    if isinstance(live, dict):
        if not isinstance(saved, dict) or set(saved) != set(live):
            raise ValueError(
                f"checkpoint {where}: saved keys "
                f"{sorted(saved) if isinstance(saved, dict) else saved!r} "
                f"for live keys {sorted(live)}"
            )
        for key in live:
            _copy_into(live[key], saved[key], f"{where}.{key}")
        return
    if len(saved) != len(live):
        raise ValueError(f"checkpoint {where}: {len(saved)} saved entries "
                         f"for {len(live)} live ones")
    for i, (a, b) in enumerate(zip(live, saved)):
        _copy_into(a, b, f"{where}[{i}]")


def _to_device(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {key: _to_device(value, device) for key, value in tree.items()}
    if isinstance(tree, list):
        return [_to_device(value, device) for value in tree]
    return tree


class TrainCheckpointer:
    """Save and restore numbered train-state checkpoints under one
    directory.

    ``keep`` bounds retention: after each completed save only the newest
    ``keep`` step directories stay (0 or ``None`` keeps all)."""

    def __init__(self, directory: str | Path, keep: int | None = None):
        if keep is not None and keep < 0:
            raise ValueError(f"keep={keep} must be >= 0")
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.keep = keep or 0
        self._writer: threading.Thread | None = None
        self._write_error: BaseException | None = None

    def _path(self, step: int) -> Path:
        return self.directory / f"step_{step:08d}"

    def save(self, state: dict, wait: bool = True) -> Path:
        """Checkpoint ``state`` (``{"params", "optimizer", "step"}``, or a
        LoRA run's :func:`.lora.lora_checkpoint_state`).  The tensors are
        copied to host memory first; with ``wait=False`` the disk write
        runs on a thread that the next save (or
        :meth:`wait_until_finished`) joins.  Retention prunes only after a
        completed write."""
        step = int(state["step"])
        path = self._path(step)
        self.wait_until_finished()
        if path.exists():
            raise FileExistsError(f"step {step} is already saved at {path}")
        payload = _to_host(state, step)
        if wait:
            self._write(payload, path)
            self._prune()
            return path

        def write():
            try:
                self._write(payload, path)
            except BaseException as err:  # surfaced by the next join
                self._write_error = err

        self._writer = threading.Thread(target=write, name="checkpoint",
                                        daemon=True)
        self._writer.start()
        return path

    def _write(self, payload: dict, path: Path) -> None:
        tmp = path.with_name(f"{path.name}.tmp-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        tmp.mkdir()
        torch.save(payload, tmp / STATE_FILE)
        os.rename(tmp, path)  # atomic: the step appears whole or not at all

    def wait_until_finished(self) -> None:
        """Join an in-flight ``wait=False`` write (re-raising its error),
        then prune."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
            error, self._write_error = self._write_error, None
            if error is not None:
                raise error
            self._prune()

    def _steps(self) -> list[int]:
        # only whole step directories: a temporary name never matches
        return sorted(
            int(match.group(1))
            for p in self.directory.glob("step_*")
            if p.is_dir() and (match := re.fullmatch(r"step_(\d+)", p.name))
        )

    def _prune(self) -> None:
        if not self.keep:
            return
        for step in self._steps()[: -self.keep]:
            shutil.rmtree(self._path(step), ignore_errors=True)

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def load(self, step: int | None = None, mmap: bool = False) -> dict:
        """The raw payload of a step (latest by default), on the host."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        path = self._path(step)
        if not (path / STATE_FILE).exists() and any(
                (path / name).exists() for name in ORBAX_MARKERS):
            raise OrbaxCheckpointError(
                f"step {step} under {self.directory} is an orbax checkpoint "
                f"of the JAX package; the port reads only its own "
                f"{STATE_FILE} steps"
            )
        return torch.load(path / STATE_FILE, map_location="cpu",
                          weights_only=True, mmap=mmap)

    def restore(self, state: dict, step: int | None = None) -> dict:
        """Restore a step (latest by default) into ``state`` — a fresh
        train state of the same model, which supplies the structure,
        shapes, dtypes and devices — in place: the parameters, the AdamW
        moments and count, and the step.  Returns ``state``."""
        saved = self.load(step)
        _copy_into(state["params"], saved["params"], "params")
        state["optimizer"].load_moments(saved["optimizer"])
        state["step"] = int(saved["step"])
        return state

    def restore_lora(self, state: dict, step: int | None = None) -> dict:
        """Resume a LoRA run: restore only the adapter train state and the
        step (from :func:`.lora.lora_checkpoint_state`'s ``lora``) into
        ``state``, a fresh :func:`.lora.init_lora_train_state`.  The merged
        weights stay on disk; the trainer rebuilt the frozen base from the
        run's seed or HF source."""
        saved = self.load(step, mmap=True)
        if "lora" not in saved:
            raise ValueError(
                f"step {saved['step']} under {self.directory} has no "
                "restorable 'lora' adapter subtree — a checkpoint without "
                "the adapter state cannot be resumed (restart the "
                "fine-tune, or serve its merged weights)"
            )
        _copy_into(state["adapters"], saved["lora"]["adapters"], "adapters")
        state["optimizer"].load_moments(saved["lora"]["optimizer"])
        state["step"] = int(saved["step"])
        return state

    def restore_params(self, family: str, config: Any,
                       step: int | None = None, layout: dict | None = None,
                       device: str | torch.device = "cuda") -> dict:
        """Just the model weights, on ``device``, for serving: the file is
        memory-mapped, so the AdamW moments are never read.  A ``moe``
        layout is refused (the worker has no routed-expert forward); a
        ``pipeline`` layout's stage stacks come back in the flat serving
        layout (:func:`.pipeline.unstack_layers` /
        :func:`.pipeline.unstack_llama_layers`), so a checkpoint serves
        whatever parallelism trained it.
        An untied ``lm_head`` comes back when the checkpoint holds one."""
        kind = (layout or {}).get("kind")
        if kind == "moe":
            raise ValueError(
                "this checkpoint stores MoE expert weights (layout="
                f"{layout}); the serving worker has no routed-expert "
                "forward — serve a dense checkpoint, or load the MoE "
                "state with TrainCheckpointer.restore for training"
            )
        params = self.load(step, mmap=True)["params"]
        if kind == "pipeline":
            from .pipeline import unstack_layers, unstack_llama_layers

            if "stages" not in params:
                raise ValueError(
                    f"checkpoint under {self.directory} has no stage stacks "
                    f"for its pipeline layout ({layout})")
            params = (unstack_llama_layers if family == "llama"
                      else unstack_layers)(params)
        layers = params.get("layers", [])
        if (len(layers) != config.n_layers
                or tuple(params["embed"].shape)
                != (config.vocab_size, config.d_model)):
            raise ValueError(
                f"checkpoint under {self.directory} holds {len(layers)} "
                f"layers and an embedding of shape "
                f"{tuple(params['embed'].shape)}; the {family} manifest "
                f"describes {config}"
            )
        return _to_device(params, device)
