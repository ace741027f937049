"""Verified checkpoints: save, restore, resume, retention.

Counterpart of the reference package's `train/checkpoint.py`
(checkpoint.py:68-483) without orbax and without async saves. A step dir
`<root>/step_<k>/` holds `state.pt` (`torch.save` of the model's and the
optimizer's state dicts, `step` and `updates`), `config.json` (both
configs and the step), and `manifest.json` — one blake2b-128 digest and
byte count per file, written LAST, so its presence marks a save that
completed.

* `restore_checkpoint` deep-verifies the manifest first (knob
  CKPT_VERIFY, default on): a flipped byte raises `CheckpointCorrupt`
  before any byte reaches the model.
* `latest_step_dir` skips torn dirs; `restore_latest` walks newest to
  oldest past corrupt ones and returns the first that restores.
* `prune_checkpoints(root, keep)` deletes the oldest verified dirs so at
  most `keep` remain; the newest good one always survives.
* `restore_for_inference` loads the model's weights alone (the optimizer
  moments are never copied into memory); `weights_version` names them
  `step_N-<blake2b(manifest)[:8]>` for the serving front-end.

One format for every data-parallel recipe and world size: `state.pt`
holds whole tensors in the single recipe's layout, gathered from the
ranks' shards (parallel/sharding.py `full_state_dicts`, a collective every
rank joins) and written by rank 0 alone, which also writes the manifest;
the ranks meet at a barrier before a save returns. A restore reads and
verifies the files on rank 0, broadcasts them (or the failure) to every
rank, and each rank takes its own shards (`load_full_state`), so a
checkpoint restores under any recipe and world, as the reference's orbax
restores onto any sharding.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
from typing import Optional

import torch

from distributed_pytorch_tpu_torch import config as cfg_mod
from distributed_pytorch_tpu_torch.config import LLMConfig, TrainConfig
from distributed_pytorch_tpu_torch.parallel import context
from distributed_pytorch_tpu_torch.parallel import sharding
from distributed_pytorch_tpu_torch.train.state import TrainState

MANIFEST = "manifest.json"
STATE = "state.pt"
_HASH_CHUNK = 1 << 20


class CheckpointCorrupt(RuntimeError):
    """A step dir failed manifest verification (flipped bytes, truncated
    or missing files, torn save). Carries the violation list."""

    def __init__(self, path: str, violations: list[str]):
        super().__init__(f"checkpoint {path} failed verification: "
                         + "; ".join(violations[:4])
                         + (" …" if len(violations) > 4 else ""))
        self.path = path
        self.violations = violations

    def __reduce__(self):
        # rebuilt from (path, violations) when broadcast to the other ranks
        return type(self), (self.path, self.violations)


def _abs(path: str) -> str:
    return os.path.abspath(os.path.expanduser(path))


def _ckpt_files(path: str) -> list[str]:
    """Relative paths of every payload file under a step dir (the manifest
    and tmp leftovers excluded)."""
    out = []
    for dirpath, _, files in os.walk(path):
        for name in files:
            rel = os.path.relpath(os.path.join(dirpath, name), path)
            if rel == MANIFEST or name.endswith(".tmp"):
                continue
            out.append(rel)
    return sorted(out)


def _blake2b_file(path: str) -> str:
    h = hashlib.blake2b(digest_size=16)
    with open(path, "rb") as f:
        while chunk := f.read(_HASH_CHUNK):
            h.update(chunk)
    return h.hexdigest()


def _atomic_write(path: str, write) -> None:
    tmp = path + ".tmp"
    write(tmp)
    os.replace(tmp, path)


def write_manifest(path: str) -> str:
    """Write `manifest.json` for a durable step dir (tmp + rename)."""
    path = _abs(path)
    files = {rel: {"blake2b": _blake2b_file(os.path.join(path, rel)),
                   "bytes": os.path.getsize(os.path.join(path, rel))}
             for rel in _ckpt_files(path)}
    mpath = os.path.join(path, MANIFEST)

    def write(tmp):
        with open(tmp, "w") as f:
            json.dump({"version": 1, "files": files}, f, indent=1)

    _atomic_write(mpath, write)
    return mpath


def verify_manifest(path: str, *, deep: bool = True) -> list[str]:
    """Check a step dir against its manifest; [] = good. `deep=False`
    checks presence and byte counts only; `deep=True` also re-hashes
    every file."""
    path = _abs(path)
    mpath = os.path.join(path, MANIFEST)
    if not os.path.exists(mpath):
        return [f"{MANIFEST} missing (torn save)"]
    try:
        with open(mpath) as f:
            files = json.load(f)["files"]
    except (ValueError, KeyError) as e:
        return [f"{MANIFEST} unreadable: {e!r}"]
    violations = []
    for rel, meta in files.items():
        fp = os.path.join(path, rel)
        if not os.path.exists(fp):
            violations.append(f"{rel}: missing")
            continue
        size = os.path.getsize(fp)
        if size != meta["bytes"]:
            violations.append(f"{rel}: {size} bytes, manifest says "
                              f"{meta['bytes']} (truncated/torn)")
            continue
        if deep and _blake2b_file(fp) != meta["blake2b"]:
            violations.append(f"{rel}: blake2b mismatch (corrupt)")
    return violations


def weights_version(path: str) -> Optional[str]:
    """Identity string for the weights under a step dir:
    `<step_dir_basename>-<blake2b(manifest)[:8]>`. The manifest digests
    every payload file, so the version changes iff a weight byte changed.
    None when the dir has no manifest."""
    path = _abs(path)
    try:
        with open(os.path.join(path, MANIFEST), "rb") as f:
            digest = hashlib.blake2b(f.read(), digest_size=16).hexdigest()
    except OSError:
        return None
    return f"{os.path.basename(os.path.normpath(path))}-{digest[:8]}"


def _verify(path: str) -> None:
    """With a manifest and CKPT_VERIFY on, raise `CheckpointCorrupt` on a
    failed deep verification."""
    if os.path.exists(os.path.join(path, MANIFEST)) \
            and cfg_mod.knob("CKPT_VERIFY"):
        violations = verify_manifest(path, deep=True)
        if violations:
            raise CheckpointCorrupt(path, violations)


def save_checkpoint(path: str, state: TrainState,
                    model_cfg: Optional[LLMConfig] = None,
                    train_cfg: Optional[TrainConfig] = None) -> str:
    """Write `state` (and the configs) under `path`; blocks until the
    files are on disk, then writes the manifest. Every rank calls it."""
    path = _abs(path)
    model_sd, opt_sd = sharding.full_state_dicts(state.model,
                                                 state.optimizer)
    world = context.get_world()
    if world is None or world.is_main:
        _write_step_dir(path, {"model": model_sd, "optimizer": opt_sd,
                               "step": state.step,
                               "updates": state.updates},
                        state.step, model_cfg, train_cfg)
    context.barrier()
    return path


def _write_step_dir(path: str, payload: dict, step: int,
                    model_cfg: Optional[LLMConfig],
                    train_cfg: Optional[TrainConfig]) -> None:
    os.makedirs(path, exist_ok=True)
    _atomic_write(os.path.join(path, STATE),
                  lambda tmp: torch.save(payload, tmp))
    if model_cfg is not None:
        meta = {"model_config": dataclasses.asdict(model_cfg),
                "train_config": dataclasses.asdict(train_cfg)
                if train_cfg else {},
                "step": step}

        def write(tmp):
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=2)

        _atomic_write(os.path.join(path, "config.json"), write)
    write_manifest(path)


def load_configs(path: str) -> tuple[LLMConfig, TrainConfig, int]:
    with open(os.path.join(_abs(path), "config.json")) as f:
        meta = json.load(f)
    return (LLMConfig(**meta["model_config"]),
            TrainConfig(**meta["train_config"]), meta.get("step", 0))


def _load_payload(path: str) -> dict:
    """A step dir's verified payload, on the CPU."""
    _verify(path)
    return torch.load(os.path.join(path, STATE), map_location="cpu",
                      weights_only=True)


def _on_main(fn):
    """fn() run on rank 0 and its result, or the exception it raised,
    broadcast to every rank (fn() itself with no group)."""
    if not context.distributed():
        return fn()
    if context.get_world().is_main:
        try:
            out = ("ok", fn())
        except Exception as e:  # noqa: BLE001 — re-raised on every rank
            out = ("err", e)
    else:
        out = None
    kind, val = context.broadcast_object(out)
    if kind == "err":
        raise val
    return val


def _apply(payload: dict, state: TrainState) -> TrainState:
    sharding.load_full_state(state.model, state.optimizer,
                             payload["model"], payload["optimizer"],
                             context.get_world())
    state.step = int(payload["step"])
    state.updates = int(payload["updates"])
    return state


def restore_checkpoint(path: str, state: TrainState) -> TrainState:
    """Load a step dir into `state` (in place; returned), whatever the
    recipe it was written under. With a manifest and CKPT_VERIFY on, a
    failed deep verification raises `CheckpointCorrupt` before anything
    is loaded. Every rank calls it."""
    path = _abs(path)
    return _apply(_on_main(lambda: _load_payload(path)), state)


def restore_for_inference(path: str, model: torch.nn.Module
                          ) -> torch.nn.Module:
    """Load a step dir's model weights into `model` (in place; returned),
    verified as `restore_checkpoint` verifies. The file is memory-mapped
    and only the model's state dict is read, so the optimizer moments are
    never copied into memory; weights cast to the model's dtypes."""
    path = _abs(path)
    _verify(path)
    payload = torch.load(os.path.join(path, STATE), map_location="cpu",
                         mmap=True, weights_only=True)
    model.load_state_dict(payload["model"])
    return model


def _step_dirs(root: str) -> list[tuple[int, str]]:
    """(step, path) for every `step_*` dir under root, ascending."""
    root = _abs(root)
    if not os.path.isdir(root):
        return []
    return sorted((int(n[5:]), os.path.join(root, n))
                  for n in os.listdir(root)
                  if n.startswith("step_") and n[5:].isdigit())


def _complete_step_dir(path: str) -> bool:
    """Cheap screen: `state.pt` present and non-empty and, with a
    manifest, every listed file present at its recorded size."""
    sp = os.path.join(path, STATE)
    if not os.path.isfile(sp) or os.path.getsize(sp) == 0:
        return False
    if os.path.exists(os.path.join(path, MANIFEST)):
        return not verify_manifest(path, deep=False)
    return True


def latest_step_dir(root: str) -> Optional[str]:
    """The newest complete `step_*` dir under root, or None."""
    for _, path in reversed(_step_dirs(root)):
        if _complete_step_dir(path):
            return path
    return None


def restore_latest(root: str, state: TrainState
                   ) -> Optional[tuple[TrainState, str, list[str]]]:
    """Restore the newest good checkpoint under root into `state`, walking
    back past torn or corrupt dirs (on rank 0). Returns (state, path,
    skipped) or None when nothing restores. Every rank calls it."""
    def find():
        skipped: list[str] = []
        for _, path in reversed(_step_dirs(root)):
            if not _complete_step_dir(path):
                skipped.append(path)
                continue
            try:
                return _load_payload(path), path, skipped
            except Exception as e:  # noqa: BLE001 — an older dir may do
                skipped.append(f"{path} ({type(e).__name__})")
        return None

    found = _on_main(find)
    if found is None:
        return None
    payload, path, skipped = found
    return _apply(payload, state), path, skipped


def prune_checkpoints(root: str, keep: int) -> list[str]:
    """Delete the oldest verified step dirs so at most `keep` remain;
    returns the deleted paths. keep <= 0 keeps everything."""
    if keep <= 0:
        return []
    good = [p for _, p in _step_dirs(root)
            if os.path.exists(os.path.join(p, MANIFEST))
            and _complete_step_dir(p)]
    deleted = good[:-keep] if len(good) > keep else []
    for path in deleted:
        shutil.rmtree(path, ignore_errors=True)
    return deleted
