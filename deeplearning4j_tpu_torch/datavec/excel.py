"""Excel (.xlsx) record reader — the port of
``deeplearning4j_tpu/datavec/excel.py``, which is stdlib only, kept as a
copy on the port's records and writables.

Reference: ``datavec-excel`` ``ExcelRecordReader`` (POI-backed).  No POI
and no openpyxl exist in this image, but .xlsx is a ZIP of
SpreadsheetML XML — this reader parses it with ``zipfile`` +
``xml.etree`` directly (the same from-scratch stance as the ONNX
protobuf decoder).  Legacy binary ``.xls`` (OLE compound files) is NOT
supported — convert to .xlsx.

Cell handling: shared strings (``t="s"``), inline strings
(``t="inlineStr"``), booleans (``t="b"``) and numbers; blank cells
inside the used range become empty Text.  ``writeXlsx`` emits a minimal
valid workbook (inline strings only) — enough for round trips and for
producing fixtures without any external library.
"""
from __future__ import annotations

import re
import zipfile
from typing import List, Optional
from xml.etree import ElementTree as ET
from xml.sax.saxutils import escape

from deeplearning4j_tpu_torch.datavec.records import RecordReader
from deeplearning4j_tpu_torch.datavec.writable import (DoubleWritable,
                                                 IntWritable, Text,
                                                 Writable)

__all__ = ["ExcelRecordReader", "writeXlsx"]

_NS = "{http://schemas.openxmlformats.org/spreadsheetml/2006/main}"


def _col_index(ref: str) -> int:
    """'A1' -> 0, 'AB7' -> 27."""
    idx = 0
    for ch in ref:
        if ch.isalpha():
            idx = idx * 26 + (ord(ch.upper()) - ord("A") + 1)
        else:
            break
    return idx - 1


def _to_writable(raw: str) -> Writable:
    try:
        f = float(raw)
        if f.is_integer() and "." not in raw and "e" not in raw.lower():
            return IntWritable(int(raw))
        return DoubleWritable(f)
    except ValueError:
        return Text(raw)


class ExcelRecordReader(RecordReader):
    """Rows of the first (or named) worksheet as records."""

    def __init__(self, sheetIndex: int = 0, skipNumLines: int = 0):
        self.sheetIndex = sheetIndex
        self.skipNumLines = skipNumLines
        self._rows: List[List[Writable]] = []
        self._i = 0

    def initialize(self, path: str) -> "ExcelRecordReader":
        with zipfile.ZipFile(path) as z:
            shared: List[str] = []
            if "xl/sharedStrings.xml" in z.namelist():
                root = ET.fromstring(z.read("xl/sharedStrings.xml"))
                for si in root.iter(f"{_NS}si"):
                    shared.append("".join(t.text or ""
                                          for t in si.iter(f"{_NS}t")))
            sheets = sorted(n for n in z.namelist()
                            if re.match(r"xl/worksheets/sheet\d+\.xml$", n))
            if self.sheetIndex >= len(sheets):
                raise ValueError(f"sheet {self.sheetIndex} not in {sheets}")
            root = ET.fromstring(z.read(sheets[self.sheetIndex]))
            rows: List[List[Writable]] = []
            for row in root.iter(f"{_NS}row"):
                cells: List[Optional[Writable]] = []
                for c in row.iter(f"{_NS}c"):
                    ref = c.get("r", "")
                    ci = _col_index(ref) if ref else len(cells)
                    while len(cells) <= ci:
                        cells.append(None)
                    ctype = c.get("t", "n")
                    if ctype == "inlineStr":
                        txt = "".join(t.text or ""
                                      for t in c.iter(f"{_NS}t"))
                        cells[ci] = Text(txt)
                        continue
                    v = c.find(f"{_NS}v")
                    raw = v.text if v is not None and v.text else ""
                    if ctype == "s":
                        cells[ci] = Text(shared[int(raw)])
                    elif ctype == "b":
                        cells[ci] = IntWritable(int(raw or 0))
                    elif raw == "":
                        cells[ci] = Text("")
                    else:
                        cells[ci] = _to_writable(raw)
                rows.append([c if c is not None else Text("")
                             for c in cells])
        self._rows = rows[self.skipNumLines:]
        self._i = 0
        return self

    def hasNext(self) -> bool:
        return self._i < len(self._rows)

    def next(self) -> List[Writable]:
        r = self._rows[self._i]
        self._i += 1
        return r

    def reset(self) -> None:
        self._i = 0


def writeXlsx(path: str, rows: List[List[object]]) -> None:
    """Minimal valid .xlsx writer (inline strings; stdlib only)."""
    def cell(ci, ri, val):
        ref = ""
        c = ci
        while c >= 0:
            ref = chr(ord("A") + c % 26) + ref
            c = c // 26 - 1
        ref = f"{ref}{ri + 1}"
        if isinstance(val, (int, float)) and not isinstance(val, bool):
            return f'<c r="{ref}"><v>{val}</v></c>'
        return (f'<c r="{ref}" t="inlineStr"><is><t>'
                f"{escape(str(val))}</t></is></c>")

    body = "".join(
        f'<row r="{ri + 1}">'
        + "".join(cell(ci, ri, v) for ci, v in enumerate(row))
        + "</row>"
        for ri, row in enumerate(rows))
    sheet = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<worksheet xmlns="http://schemas.openxmlformats.org/'
             'spreadsheetml/2006/main"><sheetData>'
             f"{body}</sheetData></worksheet>")
    workbook = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
                '<workbook xmlns="http://schemas.openxmlformats.org/'
                'spreadsheetml/2006/main" '
                'xmlns:r="http://schemas.openxmlformats.org/'
                'officeDocument/2006/relationships">'
                '<sheets><sheet name="Sheet1" sheetId="1" r:id="rId1"/>'
                "</sheets></workbook>")
    wb_rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
               '<Relationships xmlns="http://schemas.openxmlformats.org/'
               'package/2006/relationships">'
               '<Relationship Id="rId1" Type="http://schemas.'
               'openxmlformats.org/officeDocument/2006/relationships/'
               'worksheet" Target="worksheets/sheet1.xml"/>'
               "</Relationships>")
    rels = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
            '<Relationships xmlns="http://schemas.openxmlformats.org/'
            'package/2006/relationships">'
            '<Relationship Id="rId1" Type="http://schemas.openxmlformats'
            '.org/officeDocument/2006/relationships/officeDocument" '
            'Target="xl/workbook.xml"/></Relationships>')
    types = ('<?xml version="1.0" encoding="UTF-8" standalone="yes"?>'
             '<Types xmlns="http://schemas.openxmlformats.org/package/'
             '2006/content-types">'
             '<Default Extension="rels" ContentType="application/vnd.'
             'openxmlformats-package.relationships+xml"/>'
             '<Default Extension="xml" ContentType="application/xml"/>'
             '<Override PartName="/xl/workbook.xml" ContentType='
             '"application/vnd.openxmlformats-officedocument.'
             'spreadsheetml.sheet.main+xml"/>'
             '<Override PartName="/xl/worksheets/sheet1.xml" ContentType='
             '"application/vnd.openxmlformats-officedocument.'
             'spreadsheetml.worksheet+xml"/></Types>')
    with zipfile.ZipFile(path, "w", zipfile.ZIP_DEFLATED) as z:
        z.writestr("[Content_Types].xml", types)
        z.writestr("_rels/.rels", rels)
        z.writestr("xl/workbook.xml", workbook)
        z.writestr("xl/_rels/workbook.xml.rels", wb_rels)
        z.writestr("xl/worksheets/sheet1.xml", sheet)
