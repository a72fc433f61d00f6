"""Two-level goal-space / goal registries (mirror of
``controllable_agent_tpu/goals/registry.py``).

``goal_spaces`` groups feature extractors by domain, ``goals`` groups named
goal vectors by goal space. Goal-space functions are functions of a batched
*physics feature tensor* (each env documents its layout), so goal
extraction runs over a whole buffer on its device.

Implementation: one flat ``(group, name) -> fn`` table; the nested
``funcs`` view that call sites iterate is assembled on access.
"""

from __future__ import annotations

import typing as tp

F = tp.TypeVar("F", bound=tp.Callable)


class Register(tp.Generic[F]):
    def __init__(self) -> None:
        self._table: tp.Dict[tp.Tuple[str, str], F] = {}

    def __call__(self, group: str) -> tp.Callable[[F], F]:
        """Decorator: ``@registry("walker")`` files the function under
        (walker, fn.__name__)."""

        def add(fn: F) -> F:
            key = (group, fn.__name__)
            if key in self._table:
                raise ValueError(
                    f"duplicate registration: {fn.__name__!r} in {group!r}")
            self._table[key] = fn
            return fn

        return add

    @property
    def funcs(self) -> tp.Dict[str, tp.Dict[str, F]]:
        """Nested ``group -> {name: fn}`` view of the flat table."""
        out: tp.Dict[str, tp.Dict[str, F]] = {}
        for (group, name), fn in self._table.items():
            out.setdefault(group, {})[name] = fn
        return out

    def lookup(self, name: str) -> tp.Tuple[str, F]:
        """Find (group, fn) by function name across all groups."""
        for (group, fname), fn in self._table.items():
            if fname == name:
                return group, fn
        raise KeyError(name)


# goal_spaces: domain -> {space_name: physics_vector -> goal_vector}
goal_spaces: Register = Register()
# goals: space_name -> {task_name: () -> goal_vector}
goals: Register = Register()
