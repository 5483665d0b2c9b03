"""Random-pick ready queue — the source of schedule randomization.

Parity with reference madsim/src/sim/utils/mpsc.rs: the executor's ready
queue is drained by popping a *uniformly random* element via swap-remove
(mpsc.rs:73-83), so every run explores a different task interleaving and
the interleaving is fully determined by the seed.
"""

from __future__ import annotations

from typing import Generic, TypeVar

from .rand import GlobalRng

T = TypeVar("T")

__all__ = ["RandomQueue"]


class RandomQueue(Generic[T]):
    __slots__ = ("_items",)

    def __init__(self) -> None:
        self._items: list[T] = []

    def push(self, item: T) -> None:
        self._items.append(item)

    def try_pop_random(self, rng: GlobalRng) -> T | None:
        """Pop a uniformly random element (swap-remove; mpsc.rs:73-83)."""
        items = self._items
        n = len(items)
        if n == 0:
            return None
        i = rng.randrange(0, n) if n > 1 else 0
        items[i], items[-1] = items[-1], items[i]
        return items.pop()

    def __len__(self) -> int:
        return len(self._items)

    def clear(self) -> None:
        self._items.clear()
