"""Model import: TF GraphDef -> SameDiff (the port of
``deeplearning4j_tpu/imports``).

Ported: ``TFGraphMapper`` (with the port's own GraphDef decoder, so no
tensorflow is needed) and ``GraphRunner``.  The ONNX importer waits for
ROADMAP A12c and the Keras importer for A12d; their entry points raise
naming those items.
"""
from deeplearning4j_tpu_torch.imports.graphrunner import GraphRunner  # noqa: F401
from deeplearning4j_tpu_torch.imports.tf_import import TFGraphMapper  # noqa: F401

__all__ = ["TFGraphMapper", "GraphRunner", "OnnxImporter",
           "importOnnxModel", "KerasModelImport"]

_ONNX = "the ONNX importer is not ported yet (ROADMAP A12c)"
_KERAS = "the Keras importer is not ported yet (ROADMAP A12d)"


class OnnxImporter:
    """Reference: ``deeplearning4j_tpu/imports/onnx_import.py``."""

    @staticmethod
    def importModel(*args, **kwargs):
        raise NotImplementedError(f"OnnxImporter.importModel: {_ONNX}")


def importOnnxModel(*args, **kwargs):
    raise NotImplementedError(f"importOnnxModel: {_ONNX}")


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
