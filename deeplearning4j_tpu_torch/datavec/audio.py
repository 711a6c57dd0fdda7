"""Audio ETL — wav reading + feature extraction; the port of
``deeplearning4j_tpu/datavec/audio.py`` (stdlib ``wave`` and numpy, kept
as a copy so the features are the reference's bit for bit).

Reference: datavec-data-audio (``WavFileRecordReader``,
``NativeAudioRecordReader`` and the jAudio/MusicG feature wrappers —
SURVEY.md §2.4).  The reference shells into native audio libs; here the
decode is stdlib ``wave`` + numpy and the features (spectrogram /
log-mel / MFCC) are plain-numpy DSP — host-side ETL stays on the CPU, the
TPU only sees the resulting feature tensors.
"""
from __future__ import annotations

import math
import wave
from typing import List, Optional

import numpy as np

from deeplearning4j_tpu_torch.datavec.records import InputSplit, RecordReader
from deeplearning4j_tpu_torch.datavec.writable import FloatWritable, Writable

__all__ = ["read_wav", "spectrogram", "mel_filterbank", "mfcc",
           "WavFileRecordReader", "AudioFeatureRecordReader"]


def read_wav(path: str):
    """Decode a PCM wav file -> (float32 samples in [-1, 1], sample rate).
    Multi-channel audio is averaged to mono (reference behavior)."""
    with wave.open(path, "rb") as w:
        n = w.getnframes()
        sw = w.getsampwidth()
        ch = w.getnchannels()
        rate = w.getframerate()
        raw = w.readframes(n)
    if sw == 2:
        x = np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    elif sw == 1:
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sw == 4:
        x = np.frombuffer(raw, np.int32).astype(np.float32) / 2147483648.0
    else:
        raise ValueError(f"Unsupported wav sample width: {sw}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, rate


def spectrogram(x: np.ndarray, frameLength: int = 256,
                hop: Optional[int] = None, window: str = "hann"
                ) -> np.ndarray:
    """Magnitude STFT, (frames, frameLength//2 + 1)."""
    hop = hop or frameLength // 2
    if len(x) < frameLength:
        x = np.pad(x, (0, frameLength - len(x)))
    nf = 1 + (len(x) - frameLength) // hop
    w = np.hanning(frameLength) if window == "hann" else \
        np.ones(frameLength, np.float64)
    frames = np.stack([x[i * hop:i * hop + frameLength] * w
                       for i in range(nf)])
    return np.abs(np.fft.rfft(frames, axis=-1)).astype(np.float32)


def mel_filterbank(numFilters: int, fftBins: int, sampleRate: int
                   ) -> np.ndarray:
    """Triangular mel filterbank, (numFilters, fftBins)."""
    def hz2mel(f):
        return 2595.0 * math.log10(1.0 + f / 700.0)

    def mel2hz(m):
        return 700.0 * (10 ** (m / 2595.0) - 1.0)

    low, high = hz2mel(0), hz2mel(sampleRate / 2)
    pts = np.array([mel2hz(m) for m in
                    np.linspace(low, high, numFilters + 2)])
    bins = np.floor((fftBins - 1) * 2 * pts / sampleRate).astype(int)
    bins = np.clip(bins, 0, fftBins - 1)
    fb = np.zeros((numFilters, fftBins), np.float32)
    for i in range(numFilters):
        a, b, c = bins[i], bins[i + 1], bins[i + 2]
        for j in range(a, b):
            if b > a:
                fb[i, j] = (j - a) / (b - a)
        for j in range(b, c):
            if c > b:
                fb[i, j] = (c - j) / (c - b)
    return fb


def mfcc(x: np.ndarray, sampleRate: int, numCoefficients: int = 13,
         numFilters: int = 26, frameLength: int = 256,
         hop: Optional[int] = None) -> np.ndarray:
    """MFCCs (frames, numCoefficients): log-mel energies -> DCT-II."""
    spec = spectrogram(x, frameLength, hop)                # (F, bins)
    fb = mel_filterbank(numFilters, spec.shape[1], sampleRate)
    mel = np.log(np.maximum(spec ** 2 @ fb.T, 1e-10))      # (F, M)
    m = mel.shape[1]
    # orthonormal DCT-II basis
    basis = np.cos(np.pi / m * (np.arange(m) + 0.5)[None, :]
                   * np.arange(numCoefficients)[:, None])
    basis *= np.sqrt(2.0 / m)
    basis[0] *= math.sqrt(0.5)
    return (mel @ basis.T).astype(np.float32)


class WavFileRecordReader(RecordReader):
    """One record per wav file: the raw mono waveform as FloatWritables
    (reference: WavFileRecordReader)."""

    def __init__(self):
        self._files: List[str] = []
        self._i = 0

    def initialize(self, split: InputSplit) -> None:
        self._files = [p for p in split.locations()
                       if p.lower().endswith(".wav")]
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._files)

    def next(self) -> List[Writable]:
        x, _rate = read_wav(self._files[self._i])
        self._i += 1
        return [FloatWritable(float(v)) for v in x]

    def reset(self) -> None:
        self._i = 0


class AudioFeatureRecordReader(RecordReader):
    """One record per wav file: extracted features, flattened row-major
    (``features``: "waveform" | "spectrogram" | "mfcc").  The 2-D feature
    shape is exposed as ``featureShape`` after the first ``next()`` so
    iterator glue can reshape for conv nets."""

    def __init__(self, features: str = "mfcc", numCoefficients: int = 13,
                 frameLength: int = 256, hop: Optional[int] = None):
        if features not in ("waveform", "spectrogram", "mfcc"):
            raise ValueError(f"Unknown audio features: {features}")
        self.features = features
        self.numCoefficients = numCoefficients
        self.frameLength = frameLength
        self.hop = hop
        self.featureShape = None
        self._files: List[str] = []
        self._i = 0

    def initialize(self, split: InputSplit) -> None:
        self._files = [p for p in split.locations()
                       if p.lower().endswith(".wav")]
        self._i = 0

    def hasNext(self) -> bool:
        return self._i < len(self._files)

    def next(self) -> List[Writable]:
        x, rate = read_wav(self._files[self._i])
        self._i += 1
        if self.features == "waveform":
            feats = x[None, :]
        elif self.features == "spectrogram":
            feats = spectrogram(x, self.frameLength, self.hop)
        else:
            feats = mfcc(x, rate, self.numCoefficients, 26,
                         self.frameLength, self.hop)
        self.featureShape = feats.shape
        return [FloatWritable(float(v)) for v in feats.reshape(-1)]

    def reset(self) -> None:
        self._i = 0
