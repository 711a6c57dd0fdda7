"""Model import: TF GraphDef and ONNX ModelProto -> SameDiff (the port
of ``deeplearning4j_tpu/imports``).

Ported: ``TFGraphMapper`` (with the port's own GraphDef decoder, so no
tensorflow is needed), ``GraphRunner``, and ``OnnxImporter`` /
``importOnnxModel`` (with the port's own ModelProto reader, so no
``onnx`` package is needed).  The Keras importer waits for ROADMAP A12d;
its entry points raise naming that item.
"""
from deeplearning4j_tpu_torch.imports.graphrunner import GraphRunner  # noqa: F401
from deeplearning4j_tpu_torch.imports.onnx_import import (  # noqa: F401
    OnnxImporter, importOnnxModel)
from deeplearning4j_tpu_torch.imports.tf_import import TFGraphMapper  # noqa: F401

__all__ = ["TFGraphMapper", "GraphRunner", "OnnxImporter",
           "importOnnxModel", "KerasModelImport"]

_KERAS = "the Keras importer is not ported yet (ROADMAP A12d)"


class KerasModelImport:
    """Reference: ``deeplearning4j_tpu/imports/keras_import.py``."""

    @staticmethod
    def importKerasModelAndWeights(*args, **kwargs):
        raise NotImplementedError(
            f"KerasModelImport.importKerasModelAndWeights: {_KERAS}")

    @staticmethod
    def importKerasSequentialModelAndWeights(*args, **kwargs):
        raise NotImplementedError(
            f"KerasModelImport.importKerasSequentialModelAndWeights: "
            f"{_KERAS}")
