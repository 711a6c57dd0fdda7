"""A stand-in for ``deeplearning4j_tpu/datavec/audio.py``, the WAV reader and
its spectrogram / MFCC features: it waits for ROADMAP "A12 datavec formats".
Its public names keep the reference's import paths and raise naming that
item when built or called."""
from deeplearning4j_tpu_torch import unported

_ITEM = "A12 datavec formats"

__all__ = ["AudioFeatureRecordReader",
           "WavFileRecordReader",
           "mel_filterbank",
           "mfcc",
           "read_wav",
           "spectrogram"]

AudioFeatureRecordReader = unported("AudioFeatureRecordReader", _ITEM)
WavFileRecordReader = unported("WavFileRecordReader", _ITEM)
mel_filterbank = unported("mel_filterbank", _ITEM)
mfcc = unported("mfcc", _ITEM)
read_wav = unported("read_wav", _ITEM)
spectrogram = unported("spectrogram", _ITEM)
