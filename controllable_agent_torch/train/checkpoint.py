"""Checkpoint / resume (mirror of ``controllable_agent_tpu/train/checkpoint.py``).

Same semantics: a payload {agent, replay, global_step, global_episode};
partial reload via ``only``/``exclude``; auto-resume from the latest
checkpoint. The format is the port's own, a directory of

  * ``agent.pt``: ``torch.save`` of a flat dict of CPU tensors, the agent's
    ``train_state()`` (parameters, targets, Adam moments and counts, the
    step) and, under ``generator``, the state of the workspace's
    ``torch.Generator``;
  * ``replay.pt``: the ReplayState's tensors and counters, only the filled
    slots of a ring that has not wrapped; with the static geometry in
    ``meta.json`` it restores without a pre-built template (a fresh
    workspace has no buffer yet);
  * ``meta.json``: the keys saved, the counters, the replay's geometry.

Files are read with ``weights_only=True``: a checkpoint holds tensors and
plain containers, nothing that runs on load.

Atomic write: the checkpoint directory is staged as ``<name>.tmp`` and
renamed, so a preempted job never sees a half-written checkpoint.
"""

from __future__ import annotations

import json
import shutil
import time
import typing as tp
from pathlib import Path

import torch

from ..data.replay import ReplayState
from ..utils.device import DeviceLike

STALE_TMP_SECONDS = 900


def _cpu(tree: tp.Mapping[str, torch.Tensor]) -> tp.Dict[str, torch.Tensor]:
    return {k: v.detach().cpu() for k, v in tree.items()}


def save_checkpoint(path: tp.Union[str, Path], payload: tp.Dict[str, tp.Any],
                    exclude: tp.Sequence[str] = ()) -> None:
    """payload keys: agent (a flat dict of tensors), replay (ReplayState or
    None), global_step, global_episode. ``exclude`` drops keys."""
    path = Path(path)
    payload = {k: v for k, v in payload.items()
               if k not in exclude and v is not None}
    meta: tp.Dict[str, tp.Any] = {
        "keys": sorted(payload.keys()),
        "global_step": int(payload.get("global_step", 0)),
        "global_episode": int(payload.get("global_episode", 0)),
    }
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    if "agent" in payload:
        torch.save(_cpu(payload["agent"]), tmp / "agent.pt")
    if "replay" in payload:
        replay = payload["replay"]
        meta["replay_statics"] = {
            "max_episodes": int(replay.max_episodes),
            "max_episode_length": int(replay.max_episode_length),
            "n_episodes": int(replay.n_episodes), "idx": int(replay.idx)}
        # a ring that has not wrapped holds its episodes in the first
        # n_episodes slots: only those are written, the rest is zeros
        rows = replay.max_episodes if replay.idx != replay.n_episodes else replay.n_episodes
        torch.save({"storage": _cpu({k: v[:rows] for k, v in replay.storage.items()}),
                    "ep_lengths": replay.ep_lengths[:rows].cpu()}, tmp / "replay.pt")
    (tmp / "meta.json").write_text(json.dumps(meta))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)


def load_checkpoint(path: tp.Union[str, Path],
                    only: tp.Optional[tp.Sequence[str]] = None,
                    exclude: tp.Sequence[str] = (),
                    device: DeviceLike = "cpu") -> tp.Dict[str, tp.Any]:
    """Restore a checkpoint: the saved subset that ``only``/``exclude``
    leave, plus global_step/global_episode. ``agent`` comes back as the flat
    dict of CPU tensors (``agent.load_train_state`` copies it in); ``replay``
    as a ReplayState on ``device``."""
    path = Path(path)
    # a leftover <name>.tmp means a save was interrupted mid-write; the
    # committed checkpoint at ``path`` is the valid one. Only a STALE tmp is
    # an orphan: a fresh one is most likely a live writer mid-save, and
    # deleting it under the writer corrupts the save.
    orphan = path.with_name(path.name + ".tmp")
    if orphan.exists():
        try:
            if time.time() - orphan.stat().st_mtime > STALE_TMP_SECONDS:
                shutil.rmtree(orphan)
        except OSError:
            pass  # racing a live writer: leave its tmp alone
    meta = json.loads((path / "meta.json").read_text())
    saved = [k for k in meta["keys"] if k not in ("global_step", "global_episode")]
    keys = [k for k in saved
            if (only is None or k in only) and k not in exclude]
    out: tp.Dict[str, tp.Any] = {
        "global_step": meta["global_step"],
        "global_episode": meta["global_episode"],
    }
    for k in keys:
        if k == "agent":
            out[k] = torch.load(path / "agent.pt", map_location="cpu",
                                weights_only=True)
        elif k == "replay":
            raw = torch.load(path / "replay.pt", map_location="cpu",
                             weights_only=True)
            statics = meta["replay_statics"]
            slots = statics["max_episodes"]

            def full(v: torch.Tensor) -> torch.Tensor:
                """The saved rows, zero-padded to the ring's slots, on ``device``."""
                out_v = torch.zeros((slots,) + tuple(v.shape[1:]), dtype=v.dtype, device=device)
                out_v[:v.shape[0]].copy_(v)
                return out_v

            out[k] = ReplayState(
                storage={name: full(v) for name, v in raw["storage"].items()},
                ep_lengths=full(raw["ep_lengths"]),
                n_episodes=statics["n_episodes"], idx=statics["idx"],
                max_episodes=statics["max_episodes"],
                max_episode_length=statics["max_episode_length"])
    return out
