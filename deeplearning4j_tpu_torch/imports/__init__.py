"""Model import: TF GraphDef and ONNX ModelProto -> SameDiff, Keras ``.h5``
and ``.keras`` -> MultiLayerNetwork / ComputationGraph (the port of
``deeplearning4j_tpu/imports``).

Ported: ``TFGraphMapper`` (with the port's own GraphDef decoder, so no
tensorflow is needed), ``GraphRunner``, ``OnnxImporter`` /
``importOnnxModel`` (with the port's own ModelProto reader, so no
``onnx`` package is needed) and ``KerasModelImport`` (with the port's own
HDF5 reader, ``hdf5.py``, so neither h5py nor keras is needed).
"""
from deeplearning4j_tpu_torch.imports.graphrunner import GraphRunner  # noqa: F401
from deeplearning4j_tpu_torch.imports.keras_import import (  # noqa: F401
    KerasModelImport)
from deeplearning4j_tpu_torch.imports.onnx_import import (  # noqa: F401
    OnnxImporter, importOnnxModel)
from deeplearning4j_tpu_torch.imports.tf_import import TFGraphMapper  # noqa: F401

__all__ = ["TFGraphMapper", "GraphRunner", "OnnxImporter",
           "importOnnxModel", "KerasModelImport"]
