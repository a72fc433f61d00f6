"""Read a checkpoint folder of the JAX package into the port's agent and replay.

``controllable_agent_tpu/train/checkpoint.py`` writes ``agent.msgpack``
(``flax.serialization.to_bytes`` of the agent's train state) and
``meta.json`` (the keys saved and the counters). This module decodes that
file with its own reader, since the port imports neither flax nor a msgpack
package: the msgpack subset flax writes (maps, arrays, strings, binary,
integers, floats, booleans, nil) plus flax's extension types, 1 for an
ndarray and 3 for a numpy scalar (both a packed ``(shape, dtype name,
bytes)``), and flax's chunked form of arrays above 2**30 bytes (a map with
``__msgpack_chunked_array__``, ``shape`` and ``chunks``).

Every array comes back as a ``torch.Tensor``: Adam's first moment is
bfloat16, which numpy lacks. The decoded tree is a nested dict named as
``flax.serialization.to_state_dict`` names it (dataclass fields by name,
tuples by position); ``convert.load_train_state`` takes it from there.
``replay.msgpack`` (the raw dict of JAX ``train/checkpoint.py:_replay_raw``:
``storage``, ``ep_lengths``, ``n_episodes``, ``idx``) with ``meta.json``'s
``replay_statics`` becomes the port's ``ReplayState`` (``load_replay``).
"""

from __future__ import annotations

import json
import struct
import typing as tp
from pathlib import Path

import torch

from ..convert import load_train_state
from ..data.replay import ReplayState
from ..utils.device import DeviceLike, resolve_device

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
_DTYPES = {name: getattr(torch, name) for name in (
    "float16", "float32", "float64", "bfloat16", "int8", "int16", "int32", "int64",
    "uint8", "bool")}
# type byte -> (struct format of the value or of the length, kind)
_SCALARS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_SIZED = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
          0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
          0xdc: (">H", "array"), 0xdd: (">I", "array"),
          0xde: (">H", "map"), 0xdf: (">I", "map"),
          0xc7: (">B", "ext"), 0xc8: (">H", "ext"), 0xc9: (">I", "ext")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data: bytes) -> None:
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside a value")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def number(self, fmt: str) -> tp.Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self) -> tp.Any:
        kind = self.number(">B")
        if kind <= 0x7f:
            return kind
        if kind >= 0xe0:
            return kind - 0x100
        if kind <= 0x8f:
            return self.container("map", kind & 0x0f)
        if kind <= 0x9f:
            return self.container("array", kind & 0x0f)
        if kind <= 0xbf:
            return self.container("str", kind & 0x1f)
        if kind == 0xc0:
            return None
        if kind in (0xc2, 0xc3):
            return kind == 0xc3
        if kind in _SCALARS:
            return self.number(_SCALARS[kind])
        if kind in _FIXEXT:
            return self.container("ext", _FIXEXT[kind])
        if kind in _SIZED:
            fmt, what = _SIZED[kind]
            return self.container(what, self.number(fmt))
        raise ValueError(f"msgpack type byte 0x{kind:02x} is not one that flax writes")

    def container(self, what: str, n: int) -> tp.Any:
        if what == "map":
            return {self.value(): self.value() for _ in range(n)}
        if what == "array":
            return [self.value() for _ in range(n)]
        if what == "str":
            return bytes(self.take(n)).decode("utf-8")
        if what == "bin":
            return bytes(self.take(n))
        code = self.number(">b")
        payload = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not one this reader knows")
        return _ndarray(payload)


def _ndarray(payload: bytes) -> torch.Tensor:
    shape, dtype_name, buffer = _Reader(payload).value()
    if isinstance(dtype_name, bytes):
        dtype_name = dtype_name.decode("ascii")
    if dtype_name not in _DTYPES:
        raise ValueError(f"array of dtype {dtype_name!r} in a checkpoint")
    if not buffer:
        return torch.zeros(tuple(shape), dtype=_DTYPES[dtype_name])
    # a copy: the tensor must not alias the immutable bytes it was read from
    return torch.frombuffer(bytearray(buffer), dtype=_DTYPES[dtype_name]).reshape(tuple(shape))


def _by_position(d: tp.Mapping[str, tp.Any]) -> tp.List[tp.Any]:
    return [d[str(i)] for i in range(len(d))]


def _unchunk(tree: tp.Any) -> tp.Any:
    if not isinstance(tree, dict):
        return tree
    if "__msgpack_chunked_array__" in tree:
        flat = torch.cat([chunk.reshape(-1) for chunk in _by_position(tree["chunks"])])
        return flat.reshape(tuple(_by_position(tree["shape"])))
    return {k: _unchunk(v) for k, v in tree.items()}


def restore(data: bytes) -> tp.Any:
    """The tree that ``flax.serialization.msgpack_restore`` gives for
    ``data``, with every array a ``torch.Tensor`` on the CPU."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(data):
        raise ValueError(f"{len(data) - reader.pos} bytes left after the msgpack value")
    return _unchunk(tree)


def load_agent(path: tp.Union[str, Path], agent: tp.Any) -> tp.Dict[str, int]:
    """Load ``path/agent.msgpack`` (the train state of the agent's kind:
    ``FBTrainState``, ``DDPGTrainState``, ``IntrinsicTrainState``,
    ``SFTrainState``, ``SFSVDTrainState``, ``DiscreteFBTrainState``,
    ``DiscreteSFTrainState``, ``APSTrainState``, ``NEWAPSTrainState``,
    ``UVFTrainState`` or ``GoalTrainState``) into
    ``agent`` in place; returns the counters of ``meta.json``."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    if "agent" not in meta["keys"]:
        raise ValueError(f"checkpoint {path} holds no agent")
    load_train_state(agent, restore((path / "agent.msgpack").read_bytes()))
    return {"global_step": int(meta["global_step"]),
            "global_episode": int(meta["global_episode"])}


def load_replay(path: tp.Union[str, Path], device: DeviceLike = None) -> ReplayState:
    """``path/replay.msgpack`` as the port's ``ReplayState`` on ``device``:
    every storage array as saved (all ``max_episodes`` slots, unfilled ones
    zero), ``ep_lengths`` as the port's int64, and ``n_episodes`` and ``idx``
    as the host counters the port keeps. The sampler reads only
    ``ep_lengths`` on the device (an empty slot has length 0), so no count
    of the fill level needs setting there."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    if "replay" not in meta["keys"]:
        raise ValueError(f"checkpoint {path} holds no replay")
    raw = restore((path / "replay.msgpack").read_bytes())
    statics = meta["replay_statics"]
    dev = resolve_device(device)
    return ReplayState(
        storage={name: v.to(dev) for name, v in raw["storage"].items()},
        ep_lengths=raw["ep_lengths"].to(dev, torch.int64),
        n_episodes=int(raw["n_episodes"]), idx=int(raw["idx"]),
        max_episodes=int(statics["max_episodes"]),
        max_episode_length=int(statics["max_episode_length"]))
