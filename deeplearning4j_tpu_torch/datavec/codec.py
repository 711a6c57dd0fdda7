"""Video/codec ETL — frame-sequence records; the port of
``deeplearning4j_tpu/datavec/codec.py``.

Reference: ``datavec-data-codec`` (``CodecRecordReader`` — decodes video
into per-frame sequence records with startFrame/numFrames/ravel conf keys;
the reference shells into JCodec/FFmpeg).  The reference decodes GIF
with PIL, which the H100 machine lacks; here the decoder is the port's
own (``datavec/gif.py``, PIL's frames and compositing) and ``outputHW``
resizes with PIL's default filter for an RGB image, BICUBIC
(``png.resize_bicubic``) — raw numpy ``.npy`` clips shaped (T, H, W, C)
load as before.  The record shape contract is identical: one sequence per
file, one flattened frame per step.
"""
from __future__ import annotations

import os
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datavec.records import (InputSplit,
                                                SequenceRecordReader)
from deeplearning4j_tpu_torch.datavec.gif import read_gif
from deeplearning4j_tpu_torch.datavec.png import resize_bicubic
from deeplearning4j_tpu_torch.datavec.writable import (FloatWritable,
                                                       NDArrayWritable,
                                                       Writable)

__all__ = ["CodecRecordReader"]


def _gif_frames(path: str) -> np.ndarray:
    return read_gif(path).astype(np.float32) / 255.0     # (T, H, W, C)


def _resize_frame(f: np.ndarray, h: int, w: int) -> np.ndarray:
    """``Image.fromarray((f * 255).astype(np.uint8)).resize((w, h))`` of
    one (H, W, C) frame, with PIL's refusals: one channel is a type PIL
    cannot take (``TypeError``); two and four (LA, RGBA: PIL resizes them
    premultiplied) are not ported."""
    a = (f * 255).astype(np.uint8)
    c = a.shape[-1]
    if c == 3:
        out = resize_bicubic(a, h, w)
    elif c in (2, 4):
        raise NotImplementedError(
            f"resizing a {c}-channel frame (PIL's premultiplied "
            f"{'LA' if c == 2 else 'RGBA'} resize) is not ported")
    else:
        raise TypeError(f"Cannot handle this data type: (1, 1, {c}), |u1")
    return out.astype(np.float32) / 255.0


class CodecRecordReader(SequenceRecordReader):
    """One sequence record per clip file; one frame per sequence step.

    Conf keys mirror the reference's ``CodecRecordReader``:
    ``startFrame``, ``numFrames`` (0 = all), ``ravel`` (True flattens each
    frame to a float vector; False keeps an NDArrayWritable per frame),
    ``outputHW`` optional (h, w) resize.
    """

    def __init__(self, startFrame: int = 0, numFrames: int = 0,
                 ravel: bool = False,
                 outputHW: Optional[tuple] = None):
        self.startFrame = int(startFrame)
        self.numFrames = int(numFrames)
        self.ravel = bool(ravel)
        self.outputHW = tuple(outputHW) if outputHW else None
        self._files: List[str] = []
        self._i = 0

    def initialize(self, split: InputSplit) -> None:
        exts = (".gif", ".npy")
        self._files = [p for p in split.locations()
                       if os.path.splitext(p)[1].lower() in exts]
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._files)

    def _decode(self, path: str) -> np.ndarray:
        if path.lower().endswith(".npy"):
            clip = np.load(path).astype(np.float32)
            if clip.ndim == 3:               # (T, H, W) -> add channel
                clip = clip[..., None]
        else:
            clip = _gif_frames(path)
        lo = self.startFrame
        hi = lo + self.numFrames if self.numFrames else clip.shape[0]
        clip = clip[lo:hi]
        if self.outputHW is not None:
            h, w = self.outputHW
            clip = np.stack([_resize_frame(f, h, w) for f in clip])
        return clip

    def nextSequence(self) -> List[List[Writable]]:
        clip = self._decode(self._files[self._i])
        self._i += 1
        if self.ravel:
            return [[FloatWritable(float(v)) for v in frame.reshape(-1)]
                    for frame in clip]
        return [[NDArrayWritable(frame)] for frame in clip]

    # SequenceRecordReader API parity
    next = nextSequence

    def reset(self) -> None:
        self._i = 0
