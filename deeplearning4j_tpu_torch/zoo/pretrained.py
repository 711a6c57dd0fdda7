"""Pretrained weights for the zoo — the port of ``deeplearning4j_tpu/zoo/
pretrained.py`` (the reference's ``ZooModel.initPretrained``: resolve,
restore, and the Keras-h5 transplant).

The download step is a local weight repository: checkpoints live under
``$DL4J_TPU_DATA_DIR/pretrained`` (default ``~/.deeplearning4j_tpu/
pretrained``) as ``<ModelName>_<TYPE>.zip`` (a ``ModelSerializer`` zip,
written by either package) or ``<ModelName>_<TYPE>.h5`` (a Keras model,
whose weights are transplanted into the zoo architecture by position and
shape).  Both routes land on the requested device (``cuda`` unless the
caller passes another); the h5 route reads the file with the port's Keras
importer and HDF5 reader.
"""
from __future__ import annotations

import logging
import os
from typing import List, Optional, Tuple

__all__ = ["weightsDir", "resolvePretrained", "transplant", "loadPretrained"]


def weightsDir() -> str:
    """The local weight repository (reference: ``ZooModel.rootCacheDir``)."""
    root = os.environ.get("DL4J_TPU_DATA_DIR",
                          os.path.expanduser("~/.deeplearning4j_tpu"))
    return os.path.join(root, "pretrained")


def resolvePretrained(modelName: str, pretrainedType: str) -> Optional[str]:
    """``<repo>/<ModelName>_<TYPE>.{zip,h5}``; the first that exists."""
    d = weightsDir()
    for ext in (".zip", ".h5"):
        p = os.path.join(d, f"{modelName}_{pretrainedType.upper()}{ext}")
        if os.path.exists(p):
            return p
    return None


def _weighty_layers(net) -> List[Tuple[str, dict]]:
    """(key, param dict) of each layer with parameters, in network order."""
    from deeplearning4j_tpu_torch.models.graph import ComputationGraph
    if isinstance(net, ComputationGraph):
        return [(n, net.params_[n]) for n in net.conf.topoOrder
                if net.params_.get(n)]
    keys = sorted((k for k in net.params_ if net.params_[k]), key=int)
    return [(k, net.params_[k]) for k in keys]


def _same_shapes(sp, dp) -> bool:
    common = [k for k in dp if k in sp]
    return bool(common) and all(tuple(sp[k].shape) == tuple(dp[k].shape)
                                for k in common)


def _copy_matching(src, dst):
    """Copy each entry of ``src`` into ``dst`` whose key and shape match,
    onto the device of ``dst``'s entry."""
    for k, v in dst.items():
        if k in src and tuple(src[k].shape) == tuple(v.shape):
            dst[k] = src[k].detach().to(v.device).clone()


def transplant(src, dst, strict: bool = False) -> List[str]:
    """Copy parameters (and BatchNormalization state) from ``src`` into
    ``dst`` by layer position and shape; the reference's pairing rules:

    - equal counts of layers with parameters: layer i to layer i;
    - otherwise a forward scan for the next source layer of the same
      shapes, with a warning (an error under ``strict``) where more than one
      consecutive source layer matches.

    Layers that match nothing are skipped unless ``strict``.  Returns the
    keys of the ``dst`` layers that received weights."""
    src_layers = _weighty_layers(src)
    dst_layers = _weighty_layers(dst)
    positional = len(src_layers) == len(dst_layers)
    loaded: List[str] = []
    si = 0
    for di, (dk, dp) in enumerate(dst_layers):
        matched = None
        if positional:
            if _same_shapes(src_layers[di][1], dp):
                matched = di
        else:
            candidates = []
            for j in range(si, len(src_layers)):
                if _same_shapes(src_layers[j][1], dp):
                    candidates.append(j)
                    if len(candidates) > 1:
                        break
            if len(candidates) > 1:
                msg = (f"transplant: dst layer {dk} has multiple "
                       f"same-shaped source candidates (layers "
                       f"{[src_layers[j][0] for j in candidates]}) — "
                       "positional mapping may be wrong; pass strict=True "
                       "to refuse, or align the architectures")
                if strict:
                    raise ValueError(msg)
                logging.getLogger("deeplearning4j_tpu_torch").warning(msg)
            matched = candidates[0] if candidates else None
        if matched is None:
            if strict:
                raise ValueError(
                    f"transplant: no source layer matches dst layer {dk} "
                    f"(shapes { {k: tuple(v.shape) for k, v in dp.items()} })")
            continue
        s_key, sp = src_layers[matched]
        _copy_matching(sp, dp)
        s_state = src.state_.get(s_key)
        d_state = dst.state_.get(dk)
        if s_state and d_state:
            _copy_matching(s_state, d_state)
        loaded.append(dk)
        si = matched + 1
    if strict and len(loaded) != len(dst_layers):
        raise ValueError("transplant: not all dst layers were loaded")
    return loaded


def loadPretrained(model, pretrainedType: str = "IMAGENET",
                   path: Optional[str] = None, device=None):
    """``ZooModel.initPretrained``: the checkpoint from the local
    repository (or ``path``), restored (.zip) onto ``device`` or
    transplanted (.h5) into the model's architecture."""
    name = type(model).__name__
    p = path or resolvePretrained(name, pretrainedType)
    if p is None:
        raise RuntimeError(
            f"{name}: no pretrained checkpoint for type "
            f"{pretrainedType!r}. This environment has no network egress; "
            f"place {name}_{pretrainedType.upper()}.zip (ModelSerializer "
            f"format) or .h5 (Keras) under {weightsDir()}, or pass "
            "initPretrained(path=...).")
    if p.endswith(".zip"):
        from deeplearning4j_tpu_torch.utils import ModelSerializer
        # the zoo's graphs are the models with a graphBuilder
        if hasattr(model, "graphBuilder"):
            return ModelSerializer.restoreComputationGraph(p, device=device)
        return ModelSerializer.restoreMultiLayerNetwork(p, device=device)
    if p.endswith(".h5"):
        from deeplearning4j_tpu_torch.imports import KerasModelImport
        imported = KerasModelImport.importKerasModelAndWeights(
            p, device=device)
        net = model.init(device=device)
        if not transplant(imported, net):
            raise ValueError(
                f"{name}: transplant from {p} matched no layers "
                "(architecture mismatch)")
        return net
    raise ValueError(f"Unsupported pretrained checkpoint format: {p}")
