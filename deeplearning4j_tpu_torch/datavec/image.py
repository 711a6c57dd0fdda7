"""Image ETL: loader, record reader, augmentation transforms.

Reference: datavec-data-image ``NativeImageLoader`` (JavaCPP OpenCV),
``ImageRecordReader`` (label from parent dir), and the ``ImageTransform``
family (Crop/Flip/Rotate/Color/Scale + ``PipelineImageTransform``).

The port of ``deeplearning4j_tpu/datavec/image.py``: NumPy on the host (no
OpenCV JNI); output is CHW float32 like the reference's NCHW convention,
feeding the NCHW conv stack.  The reference decodes with PIL, which the
H100 machine lacks, so PNG and binary PGM/PPM files go through the port's
own codec (:mod:`.png`), whose conversion, bilinear resize and float
rotation give PIL's pixels; other formats go to PIL where it is installed
and raise naming the format where it is not.  The rotation always takes
the PIL route (the reference's PIL-less branch, which snaps the angle to
a multiple of 90 degrees, is not what it computes where PIL exists).
Augmentation draws from ``np.random.RandomState(seed)`` as in the
reference, so a seeded pipeline gives the same pixels in both packages.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

from deeplearning4j_tpu_torch.datavec import png as _png
from deeplearning4j_tpu_torch.datavec.records import (FileSplit,  # noqa: F401
                                                      InputSplit,
                                                      RecordReader,
                                                      _shard_check)
from deeplearning4j_tpu_torch.datavec.writable import (IntWritable, NDArrayWritable,
                                                 Writable)



def _pil():
    """PIL's ``Image`` module, or None where PIL is not installed."""
    try:
        from PIL import Image
        return Image
    except Exception:
        return None


def _decode(path, mode: str, height: int, width: int) -> np.ndarray:
    """The file's pixels converted to ``mode`` (L or RGB) and resized to
    (height, width) with PIL's BILINEAR rule: uint8 (h, w) or (h, w, 3)."""
    with open(path, "rb") as f:
        head = f.read(16)
    if _png.is_native_format(head):
        px, src_mode, palette = _png.read_image(path)
        arr = _png.convert(px, src_mode, palette, mode)
        return _png.resize_bilinear(arr, height, width)
    Image = _pil()
    if Image is None:
        kind = os.path.splitext(str(path))[1].lstrip(".").upper() \
            or repr(head[:8])
        raise RuntimeError(
            f"{path}: decoding {kind} files needs PIL, which is not "
            "installed (the port reads PNG and binary PGM/PPM itself)")
    img = Image.open(path).convert(mode)
    img = img.resize((width, height), Image.BILINEAR)
    return np.asarray(img)


class NativeImageLoader:
    """Decode an image file/array to CHW float32.

    Reference: datavec-data-image ``loader/NativeImageLoader.java``.
    """

    def __init__(self, height: int, width: int, channels: int = 3):
        self.height, self.width, self.channels = height, width, channels

    def asMatrix(self, src) -> np.ndarray:
        if isinstance(src, np.ndarray):
            arr = src
            if arr.ndim == 2:
                arr = arr[:, :, None]
        else:
            arr = _decode(src, "L" if self.channels == 1 else "RGB",
                          self.height, self.width).astype(np.float32)
            if arr.ndim == 2:
                arr = arr[:, :, None]
        if arr.shape[:2] != (self.height, self.width):
            arr = _resize(arr, self.height, self.width)
        return np.ascontiguousarray(
            arr.astype(np.float32).transpose(2, 0, 1))  # HWC -> CHW


def _resize(arr: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resize for raw arrays (PIL path resizes already)."""
    ys = (np.arange(h) * arr.shape[0] / h).astype(int)
    xs = (np.arange(w) * arr.shape[1] / w).astype(int)
    return arr[ys][:, xs]


# ----------------------------------------------------------- transforms ----

class ImageTransform:
    """SPI (reference: transform/ImageTransform.java): CHW -> CHW."""

    def transform(self, chw: np.ndarray, rng: np.random.RandomState
                  ) -> np.ndarray:
        raise NotImplementedError


class FlipImageTransform(ImageTransform):
    """Reference: FlipImageTransform — mode: 0 vertical, 1 horizontal,
    -1 both; None = random horizontal."""

    def __init__(self, flipMode: Optional[int] = 1):
        self.flipMode = flipMode

    def transform(self, chw, rng):
        mode = self.flipMode
        if mode is None:
            mode = 1 if rng.rand() < 0.5 else -2  # -2 = no-op
        if mode == 1:
            return chw[:, :, ::-1]
        if mode == 0:
            return chw[:, ::-1, :]
        if mode == -1:
            return chw[:, ::-1, ::-1]
        return chw


class CropImageTransform(ImageTransform):
    """Random crop of up to crop pixels per edge, resized back."""

    def __init__(self, crop: int):
        self.crop = crop

    def transform(self, chw, rng):
        c, h, w = chw.shape
        t, b = rng.randint(0, self.crop + 1), rng.randint(0, self.crop + 1)
        l, r = rng.randint(0, self.crop + 1), rng.randint(0, self.crop + 1)
        cut = chw[:, t:h - b or h, l:w - r or w]
        return _resize(cut.transpose(1, 2, 0), h, w).transpose(2, 0, 1)


class RotateImageTransform(ImageTransform):
    """Random rotation in [-angle, angle] degrees about the centre, each
    channel bilinear in float32 as PIL's ``"F"``-mode ``rotate`` (a uint8
    round trip would wrap values outside 0-255), zero outside."""

    def __init__(self, angle: float):
        self.angle = angle

    def transform(self, chw, rng):
        a = rng.uniform(-self.angle, self.angle)
        return np.stack([_png.rotate_bilinear_f(ch, a) for ch in chw])


class ColorConversionTransform(ImageTransform):
    """Brightness/contrast jitter (reference class converts colorspace; the
    augmentation intent — photometric variation — is the same)."""

    def __init__(self, brightness: float = 0.2, contrast: float = 0.2):
        self.brightness, self.contrast = brightness, contrast

    def transform(self, chw, rng):
        b = 1.0 + rng.uniform(-self.brightness, self.brightness)
        c = 1.0 + rng.uniform(-self.contrast, self.contrast)
        mean = chw.mean()
        return ((chw - mean) * c + mean) * b


class ScaleImageTransform(ImageTransform):
    def __init__(self, delta: float):
        self.delta = delta

    def transform(self, chw, rng):
        c, h, w = chw.shape
        s = 1.0 + rng.uniform(-self.delta, self.delta)
        nh, nw = max(1, int(h * s)), max(1, int(w * s))
        scaled = _resize(chw.transpose(1, 2, 0), nh, nw)
        return _resize(scaled, h, w).transpose(2, 0, 1)


class PipelineImageTransform(ImageTransform):
    """Reference: PipelineImageTransform — sequence of (transform, prob)."""

    def __init__(self, *steps, shuffle: bool = False):
        self.steps: List[Tuple[ImageTransform, float]] = []
        for s in steps:
            if isinstance(s, tuple):
                self.steps.append(s)
            else:
                self.steps.append((s, 1.0))
        self.shuffle = shuffle

    def transform(self, chw, rng):
        order = list(range(len(self.steps)))
        if self.shuffle:
            rng.shuffle(order)
        for i in order:
            t, p = self.steps[i]
            if rng.rand() <= p:
                chw = t.transform(chw, rng)
        return chw


# -------------------------------------------------------------- reader ----

class ParentPathLabelGenerator:
    """Reference: api ``ParentPathLabelGenerator`` — label = parent dir."""

    def getLabelForPath(self, path: str) -> str:
        return Path(path).parent.name


class ImageRecordReader(RecordReader):
    """Reference: ImageRecordReader — record = [image NDArray, label index].

    Labels enumerate sorted unique values from the label generator over the
    split (the reference's behavior with ParentPathLabelGenerator).
    """

    def __init__(self, height: int, width: int, channels: int = 3,
                 labelGenerator: Optional[ParentPathLabelGenerator] = None,
                 imageTransform: Optional[ImageTransform] = None,
                 seed: int = 0):
        self.loader = NativeImageLoader(height, width, channels)
        self.labelGenerator = labelGenerator
        self.imageTransform = imageTransform
        self._seed = seed
        self._rng = np.random.RandomState(seed)
        self._files: List[str] = []
        self._labels: List[str] = []
        self._i = 0

    def initialize(self, split: InputSplit) -> None:
        self._files = split.locations()
        if self.labelGenerator is not None:
            self._labels = sorted({self.labelGenerator.getLabelForPath(f)
                                   for f in self._files})
        self._i = 0

    def getLabels(self) -> List[str]:
        return list(self._labels)

    def numLabels(self) -> int:
        return len(self._labels)

    def hasNext(self) -> bool:
        return self._i < len(self._files)

    def next(self) -> List[Writable]:
        f = self._files[self._i]
        self._i += 1
        chw = self.loader.asMatrix(f)
        if self.imageTransform is not None:
            chw = self.imageTransform.transform(chw, self._rng)
        rec: List[Writable] = [NDArrayWritable(chw)]
        if self.labelGenerator is not None:
            lbl = self.labelGenerator.getLabelForPath(f)
            rec.append(IntWritable(self._labels.index(lbl)))
        return rec

    def reset(self) -> None:
        self._i = 0

    def streaming(self) -> bool:
        return True     # file decode + augmentation per next()

    def setEpoch(self, epoch: int) -> None:
        """Producer-pool epoch signal: re-derive the augmentation RNG so
        the pool's frozen-pickle worker generations don't replay the
        same augmented batches every epoch (deterministic in
        (seed, epoch), matching the seeded-pipeline reproducibility
        contract)."""
        self._rng = np.random.RandomState(
            (self._seed + 1000003 * (int(epoch) + 1)) % (2**31 - 1))

    def shard(self, index: int, count: int) -> "ImageRecordReader":
        """Producer-pool shard: every worker keeps the FULL label
        vocabulary (computed from the whole split at initialize) but
        decodes only its ``i % count == index`` slice of the files."""
        import copy
        _shard_check(index, count)
        out = copy.copy(self)
        out._files = self._files[index::count]
        out._rng = np.random.RandomState(self._rng.randint(2**31 - 1)
                                         + index)
        out._i = 0
        return out
