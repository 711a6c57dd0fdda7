"""RecordReader SPI + file splits + stock readers.

Reference: datavec-api ``org/datavec/api/records/reader/RecordReader.java``
and impls (``impl/csv/CSVRecordReader``, ``impl/LineRecordReader``,
``impl/csv/CSVSequenceRecordReader``, ``impl/regex/RegexLineRecordReader``,
``impl/collection/CollectionRecordReader``, ``impl/misc/SVMLightRecordReader``)
plus ``org/datavec/api/split/{InputSplit,FileSplit,NumberedFileInputSplit}``.

The port of ``deeplearning4j_tpu/datavec/records.py``, the same readers:
the API is the reference's (initialize(split) / hasNext / next →
List[Writable]), and the numeric CSV bulk path ``loadAll()`` drops into
the port's own build of the C++ parser
(:func:`deeplearning4j_tpu_torch.native.csv_parse`).  ``shard`` and
``streaming`` are the producer pool's contract, as in the reference.
"""
from __future__ import annotations

import copy
import glob as _glob
import os
import re
from pathlib import Path
from typing import Iterator, List, Optional, Sequence

import numpy as np

from deeplearning4j_tpu_torch import native
from deeplearning4j_tpu_torch.datavec.writable import (DoubleWritable, IntWritable,
                                                       Text, Writable, writable)


# ------------------------------------------------------------- splits ----

class InputSplit:
    """Reference: org/datavec/api/split/InputSplit.java."""

    def locations(self) -> List[str]:
        raise NotImplementedError


class FileSplit(InputSplit):
    """A file, directory (recursive), or glob of input paths."""

    def __init__(self, path, allowFormats: Optional[Sequence[str]] = None,
                 recursive: bool = True):
        self._path = str(path)
        self._recursive = recursive
        self._formats = tuple(f.lstrip(".").lower() for f in allowFormats) \
            if allowFormats else None

    def locations(self) -> List[str]:
        p = Path(self._path)
        if p.is_dir():
            it = p.rglob("*") if self._recursive else p.glob("*")
            files = sorted(str(f) for f in it if f.is_file())
        elif any(ch in self._path for ch in "*?["):
            files = sorted(_glob.glob(self._path, recursive=self._recursive))
        else:
            files = [self._path]
        if self._formats:
            files = [f for f in files
                     if f.rsplit(".", 1)[-1].lower() in self._formats]
        return files


class NumberedFileInputSplit(InputSplit):
    """Reference: NumberedFileInputSplit — ``base_%d.ext`` over [min, max]."""

    def __init__(self, baseString: str, minIdx: int, maxIdx: int):
        self._base, self._lo, self._hi = baseString, minIdx, maxIdx

    def locations(self) -> List[str]:
        return [self._base % i for i in range(self._lo, self._hi + 1)]


class StringSplit(InputSplit):
    def __init__(self, data: str):
        self._data = data

    def locations(self) -> List[str]:
        return []

    @property
    def data(self) -> str:
        return self._data


# -------------------------------------------------------------- readers ----

class RecordReader:
    """SPI: initialize(split) → hasNext/next/reset; next() is one record =
    List[Writable]."""

    def initialize(self, split: InputSplit) -> None:
        raise NotImplementedError

    def hasNext(self) -> bool:
        raise NotImplementedError

    def next(self) -> List[Writable]:
        raise NotImplementedError

    def reset(self) -> None:
        raise NotImplementedError

    def __iter__(self) -> Iterator[List[Writable]]:
        self.reset()
        while self.hasNext():
            yield self.next()

    def streaming(self) -> bool:
        """True when ``next()`` does real decode work per record (CSV
        parse, file read, image decode) — the signal the fit paths use to
        engage the multi-process producer pool."""
        return False

    def shard(self, index: int, count: int) -> "RecordReader":
        """Return a reader over records ``i % count == index`` of this
        (already-initialized) reader — the deterministic per-worker shard
        assignment of the producer pool.  Readers that can slice their
        backing store override this; the default refuses so the pool
        falls back to batch-granularity ownership instead of silently
        duplicating records."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support record sharding")


def _shard_check(index: int, count: int) -> None:
    if count < 1 or not 0 <= index < count:
        raise ValueError(f"invalid shard {index}/{count}")


class SequenceRecordReader(RecordReader):
    """next() is one sequence = List[List[Writable]] (time-major)."""

    def nextSequence(self) -> List[List[Writable]]:
        raise NotImplementedError


class LineRecordReader(RecordReader):
    """Reference: impl/LineRecordReader — one Text writable per line."""

    def __init__(self):
        self._lines: List[str] = []
        self._i = 0

    def initialize(self, split: InputSplit) -> None:
        self._lines = []
        if isinstance(split, StringSplit):
            self._lines = split.data.splitlines()
        else:
            for loc in split.locations():
                with open(loc, "r", encoding="utf-8") as f:
                    self._lines.extend(f.read().splitlines())
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._lines)

    def next(self) -> List[Writable]:
        line = self._lines[self._i]
        self._i += 1
        return [Text(line)]

    def reset(self) -> None:
        self._i = 0

    def shard(self, index: int, count: int) -> "LineRecordReader":
        _shard_check(index, count)
        out = copy.copy(self)
        out._lines = self._lines[index::count]
        out._i = 0
        return out


def _parse_field(tok: str) -> Writable:
    tok = tok.strip()
    try:
        i = int(tok)
        return IntWritable(i)
    except ValueError:
        pass
    try:
        return DoubleWritable(float(tok))
    except ValueError:
        return Text(tok)


class CSVRecordReader(RecordReader):
    """Reference: impl/csv/CSVRecordReader — delimiter-split typed fields.

    ``loadAll()`` is the native bulk path: the whole split parses to one
    float32 matrix in the C++ kernel (falls back to the Writable path for
    non-numeric data).
    """

    def __init__(self, skipNumLines: int = 0, delimiter: str = ","):
        self.skipNumLines = skipNumLines
        self.delimiter = delimiter
        self._lines: List[str] = []
        self._raw: str = ""
        self._i = 0

    def initialize(self, split: InputSplit) -> None:
        # skipNumLines applies PER FILE (the reference skips per location —
        # every CSV in a directory has its own header).
        def body(text: str) -> List[str]:
            lines = [ln for ln in text.splitlines() if ln.strip()]
            return lines[self.skipNumLines:]

        if isinstance(split, StringSplit):
            self._lines = body(split.data)
        else:
            self._lines = []
            for loc in split.locations():
                with open(loc, "r", encoding="utf-8") as f:
                    self._lines.extend(body(f.read()))
        self._raw = "\n".join(self._lines)
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._lines)

    def next(self) -> List[Writable]:
        toks = self._lines[self._i].split(self.delimiter)
        self._i += 1
        return [_parse_field(t) for t in toks]

    def reset(self) -> None:
        self._i = 0

    def streaming(self) -> bool:
        return True     # field parse happens per next()

    def shard(self, index: int, count: int) -> "CSVRecordReader":
        _shard_check(index, count)
        out = copy.copy(self)
        out._lines = self._lines[index::count]
        out._raw = "\n".join(out._lines)
        out._i = 0
        return out

    def loadAll(self) -> np.ndarray:
        """All-numeric bulk load through the native parser.

        Falls back to the Writable path (numeric coercion per field) when
        the data is not purely numeric; Text fields raise ValueError there
        too — mixed-type data belongs in a TransformProcess first.
        """
        try:
            # headers were already stripped per file in initialize()
            return native.csv_parse(self._raw, delim=self.delimiter,
                                    skip_rows=0)
        except ValueError:
            rows = [[w.toDouble() for w in rec] for rec in self]
            return np.asarray(rows, dtype=np.float32)


class CSVSequenceRecordReader(SequenceRecordReader):
    """Reference: impl/csv/CSVSequenceRecordReader — one file per sequence,
    one time step per line."""

    def __init__(self, skipNumLines: int = 0, delimiter: str = ","):
        self.skipNumLines = skipNumLines
        self.delimiter = delimiter
        self._files: List[str] = []
        self._i = 0

    def initialize(self, split: InputSplit) -> None:
        self._files = split.locations()
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._files)

    def next(self) -> List[List[Writable]]:
        return self.nextSequence()

    def nextSequence(self) -> List[List[Writable]]:
        with open(self._files[self._i], "r", encoding="utf-8") as f:
            lines = [ln for ln in f.read().splitlines() if ln.strip()]
        self._i += 1
        return [[_parse_field(t) for t in ln.split(self.delimiter)]
                for ln in lines[self.skipNumLines:]]

    def reset(self) -> None:
        self._i = 0

    def streaming(self) -> bool:
        return True     # one file open + parse per sequence

    def shard(self, index: int, count: int) -> "CSVSequenceRecordReader":
        _shard_check(index, count)
        out = copy.copy(self)
        out._files = self._files[index::count]
        out._i = 0
        return out


class RegexLineRecordReader(RecordReader):
    """Reference: impl/regex/RegexLineRecordReader — regex groups → fields."""

    def __init__(self, regex: str, skipNumLines: int = 0):
        self._re = re.compile(regex)
        self.skipNumLines = skipNumLines
        self._inner = LineRecordReader()
        self._skipped = 0

    def initialize(self, split: InputSplit) -> None:
        self._inner.initialize(split)
        self._inner._i = self.skipNumLines

    def hasNext(self) -> bool:
        return self._inner.hasNext()

    def next(self) -> List[Writable]:
        line = self._inner.next()[0].toString()
        m = self._re.match(line)
        if m is None:
            raise ValueError(f"line does not match: {line!r}")
        return [_parse_field(g) for g in m.groups()]

    def reset(self) -> None:
        self._inner.reset()
        self._inner._i = self.skipNumLines


class CollectionRecordReader(RecordReader):
    """Reference: impl/collection/CollectionRecordReader — in-memory rows."""

    def __init__(self, records: Sequence[Sequence]):
        self._records = [[writable(v) for v in row] for row in records]
        self._i = 0

    def initialize(self, split: Optional[InputSplit] = None) -> None:
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._records)

    def next(self) -> List[Writable]:
        row = self._records[self._i]
        self._i += 1
        return list(row)

    def reset(self) -> None:
        self._i = 0

    def shard(self, index: int, count: int) -> "CollectionRecordReader":
        _shard_check(index, count)
        out = copy.copy(self)
        out._records = self._records[index::count]
        out._i = 0
        return out


class CollectionSequenceRecordReader(SequenceRecordReader):
    def __init__(self, sequences: Sequence[Sequence[Sequence]]):
        self._seqs = [[[writable(v) for v in step] for step in seq]
                      for seq in sequences]
        self._i = 0

    def initialize(self, split: Optional[InputSplit] = None) -> None:
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._seqs)

    def next(self):
        return self.nextSequence()

    def nextSequence(self):
        s = self._seqs[self._i]
        self._i += 1
        return [list(step) for step in s]

    def reset(self) -> None:
        self._i = 0

    def shard(self, index: int, count: int
              ) -> "CollectionSequenceRecordReader":
        _shard_check(index, count)
        out = copy.copy(self)
        out._seqs = self._seqs[index::count]
        out._i = 0
        return out


class SVMLightRecordReader(RecordReader):
    """Reference: impl/misc/SVMLightRecordReader — ``label idx:val ...``."""

    def __init__(self, numFeatures: int, zeroBasedIndexing: bool = False):
        self.numFeatures = numFeatures
        self.zeroBased = zeroBasedIndexing
        self._inner = LineRecordReader()

    def initialize(self, split: InputSplit) -> None:
        self._inner.initialize(split)

    def hasNext(self) -> bool:
        return self._inner.hasNext()

    def next(self) -> List[Writable]:
        line = self._inner.next()[0].toString().split("#", 1)[0].strip()
        parts = line.split()
        label = _parse_field(parts[0])
        row = np.zeros(self.numFeatures, dtype=np.float64)
        for tok in parts[1:]:
            idx, val = tok.split(":")
            i = int(idx) - (0 if self.zeroBased else 1)
            row[i] = float(val)
        return [DoubleWritable(v) for v in row] + [label]

    def reset(self) -> None:
        self._inner.reset()

    def streaming(self) -> bool:
        return True     # sparse-row parse per next()

    def shard(self, index: int, count: int) -> "SVMLightRecordReader":
        out = copy.copy(self)
        out._inner = self._inner.shard(index, count)
        return out
