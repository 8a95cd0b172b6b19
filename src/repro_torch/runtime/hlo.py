"""Collective-traffic accounting for the dry run and the roofline.

Counterpart of ``repro/runtime/hlo.py``, under the reference's file name.
The port compiles no HLO: one process executes a sharding policy's
placement (``models/parallel.py``), and its ``Placement`` appends a record
for every collective it runs to ``Placement.recorder``: (kind, dtype, one
rank's operand dims, group).  The kinds and dtypes carry the reference's
HLO names ("all-reduce", "all-gather", "reduce-scatter"; "f32", "bf16"),
the dims the reference's text form ("8,128,64").  The operand bytes of one
rank count as a device's bytes, the reference's definition, and the
roofline divides them by the link bandwidth.

``shape_bytes``, ``CollectiveStats`` and the redundancy rule are the
reference's: a collective whose (kind, dtype, shape, group) signature
repeats is listed in ``redundant``.  ``collective_stats`` reads the
records where the reference reads HLO text; ``op_histogram`` the aten op
counts of the dry run's dispatch mode where the reference counts HLO op
names.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Dict, Iterable, List, Mapping, Tuple

_DTYPE_BYTES = {
    "pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8, "f64": 8,
    "c64": 8, "c128": 16, "s4": 1, "u4": 1, "f8e4m3fn": 1, "f8e5m2": 1,
}

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute", "ragged-all-to-all")

# (kind, dtype, dims, group): one collective, as Placement.record makes it
Record = Tuple[str, str, str, str]


def shape_bytes(dtype: str, dims: str) -> int:
    n = 1
    if dims:
        for d in dims.split(","):
            n *= int(d)
    return n * _DTYPE_BYTES.get(dtype, 4)


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]
    redundant: List[Tuple[str, str, int]]  # (kind, signature, occurrences)

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    @property
    def total_count(self) -> int:
        return sum(self.count_by_kind.values())


def collective_stats(records: Iterable[Record]) -> CollectiveStats:
    """Bytes and counts by kind of a run's collective records, and the
    signatures that repeat."""
    bytes_by: collections.Counter = collections.Counter()
    count_by: collections.Counter = collections.Counter()
    signatures: collections.Counter = collections.Counter()
    for kind, dtype, dims, group in records:
        if kind not in _COLLECTIVES:
            raise ValueError(f"unknown collective kind {kind!r}")
        bytes_by[kind] += shape_bytes(dtype, dims)
        count_by[kind] += 1
        signatures[(kind, str([(dtype, dims)]), group)] += 1
    redundant = [(k, sig, n) for (k, sig, g), n in signatures.items()
                 if n > 1]
    return CollectiveStats(dict(bytes_by), dict(count_by), redundant)


def op_histogram(counts: Mapping[str, int],
                 top: int = 20) -> List[Tuple[str, int]]:
    """The `top` most frequent aten ops of a run's op counts (the dry
    run's dispatch mode): a remat / redundancy smell."""
    return collections.Counter(counts).most_common(top)


__all__ = ["collective_stats", "CollectiveStats", "op_histogram",
           "shape_bytes", "Record"]
