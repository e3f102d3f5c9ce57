"""What a run shares between the harness, the drivers and the metric
readers: the cell as it runs, the window's record and the sample of files
the check compares."""
from __future__ import annotations

import contextlib
import dataclasses
import random


class SlotSample:
    """The files the check compares, drawn from the seed by slot (an
    image's place in a call): the first and the last slot of each image
    size, where a batch's groups begin and end, then other slots drawn
    from the seed until there are k; for each slot the file of one call,
    drawn uniformly over the calls of the window (one draw a call)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.slots: dict = {}  # slot -> [calls offered, (index, file)]

    def choose(self, keys: list) -> None:
        """Pick the slots from the first call's key of each slot (its
        image's shape)."""
        first: dict = {}
        last: dict = {}
        for j, key in enumerate(keys):
            first.setdefault(key, j)
            last[key] = j
        pick = sorted(set(first.values()) | set(last.values()))
        rest = sorted(set(range(len(keys))) - set(pick))
        pick += self.rng.sample(rest, min(len(rest),
                                          max(0, self.k - len(pick))))
        self.slots = {j: [0, None] for j in pick}

    def offer(self, slot: int, item) -> None:
        s = self.slots.get(slot)
        if s is None:
            return
        s[0] += 1
        if self.rng.randrange(s[0]) == 0:
            s[1] = item

    @property
    def items(self) -> list:
        return [s[1] for s in self.slots.values() if s[1] is not None]


@dataclasses.dataclass
class Window:
    """The measured window's record, on the host's clock (seconds)."""
    t_start: float = 0.0
    t_end: float = 0.0
    attempted: int = 0   # images handed to the program
    returned: int = 0    # images whose file came back
    pixels: int = 0      # pixels of the images whose file came back
    out_bytes: int = 0   # bytes of the files that came back

    @property
    def seconds(self) -> float:
        return self.t_end - self.t_start


@dataclasses.dataclass
class Cell:
    """A cell as the drivers see it."""
    config: dict
    traffic: dict
    encode_config: object  # jpegtpu_torch.EncodeConfig
    pool: list             # uint8 images [h, w(, 3)] on the host
    device: str
    seconds: float
    sample: SlotSample
    spans: bool = False

    def span(self, name: str):
        """A profiler span in a traced run, nothing otherwise."""
        if not self.spans:
            return contextlib.nullcontext()
        from torch.profiler import record_function
        return record_function(name)

    def returned(self, window: Window, slot: int, index: int,
                 data: bytes) -> None:
        """Record the file of pool image `index`, in place `slot` of its
        call."""
        window.returned += 1
        window.out_bytes += len(data)
        window.pixels += self.pool[index].shape[0] * self.pool[index].shape[1]
        self.sample.offer(slot, (index, data))


@dataclasses.dataclass
class Run:
    """What the metric readers read."""
    setup_s: float
    window: Window
    trace: object          # trace.Summary, or None in an untraced run
    least_bytes: int       # the encode's least bytes (stats.least_bytes)
    peaks: dict            # the device's published peaks, or {}
