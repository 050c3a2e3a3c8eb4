"""RNG discipline (counterpart of robust_object_detection_tpu/core/rng.py).

Randomness is explicit: one root seed per experiment, split along named
streams, nothing global. A stream hands out ``torch.Generator``s, each
seeded from (the stream's base seed, a counter) through numpy's
``SeedSequence``, so the counter is the stream's only state: a checkpoint
keeps the counters and a restored run draws what an uninterrupted one
would. Where the reference folds a counter into a JAX key, the port seeds
a generator; the numbers differ, the discipline is the same. Frozen-testset
generation is the one deliberate exception, as in the reference: it replays
numpy's MT19937 stream (data/testsets.py).
"""

from __future__ import annotations

from typing import Dict, Iterator, Union

import numpy as np
import torch

Device = Union[str, torch.device]


def fold_in(seed: int, data: int) -> int:
    """A 32-bit seed derived from (seed, data) (the CPU generator keeps no
    more than 32 bits of a seed)."""
    return int(np.random.SeedSequence([seed, data]).generate_state(1)[0])


def generator(seed: int, device: Device = "cpu") -> torch.Generator:
    return torch.Generator(device).manual_seed(seed)


class RngStream:
    """A named stream of generators: ``next()`` seeds a fresh generator
    from (base, counter) and advances the counter."""

    def __init__(self, base: int, counter: int = 0):
        self._base = base
        self._counter = counter

    @property
    def counter(self) -> int:
        return self._counter

    def next(self, device: Device = "cpu") -> torch.Generator:
        g = self.peek(0, device)
        self._counter += 1
        return g

    def peek(self, offset: int = 0, device: Device = "cpu"
             ) -> torch.Generator:
        return generator(fold_in(self._base, self._counter + offset), device)


class Rng:
    """Root RNG for an experiment: derive named streams deterministically."""

    def __init__(self, seed: int):
        self.seed = seed
        self._streams: Dict[str, RngStream] = {}

    def stream(self, name: str) -> RngStream:
        if name not in self._streams:
            # stable per-name base: fold in a hash of the name
            self._streams[name] = RngStream(
                fold_in(self.seed, _stable_hash(name)))
        return self._streams[name]

    def key(self, name: str, device: Device = "cpu") -> torch.Generator:
        """One-shot generator for `name` (no stream state)."""
        return generator(fold_in(self.seed, _stable_hash(name)), device)

    def state(self) -> Dict[str, int]:
        """Counters of all streams, for checkpointing."""
        return {k: s.counter for k, s in self._streams.items()}

    def restore(self, state: Dict[str, int]) -> None:
        for name, counter in state.items():
            self.stream(name)._counter = counter


def _stable_hash(name: str) -> int:
    """Deterministic 31-bit hash (python's hash() is salted per process)."""
    h = 2166136261
    for b in name.encode():
        h = ((h ^ b) * 16777619) & 0x7FFFFFFF
    return h


def key_iter(seed: int, device: Device = "cpu") -> Iterator[torch.Generator]:
    """Generators seeded from (seed, 0), (seed, 1), ..."""
    i = 0
    while True:
        yield generator(fold_in(seed, i), device)
        i += 1
