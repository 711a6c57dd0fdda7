"""Pooled embedding-bag layer for the recommender tier — the port of
``deeplearning4j_tpu/nn/conf/embedding.py``.

The table is one (numEmbeddings, embeddingDim) parameter; a lookup is
two-phase, as the reference's is: ids are deduplicated first (host-side
per row in ``RaggedFeatureReader``, then batch-wide with a fixed-size
unique here), only the unique rows are gathered, and the bag pools them
with its per-id weights (the padding mask times the dedup multiplicity)
under a ``sum`` or ``mean`` combiner.

The reference row-shards the table over a mesh's ``model`` axis (the
``rowShardedParamKeys`` plan hook, read by its mesh trainer) and spells
the exchange out in ``embedding_lookup_table_parallel``, a ``shard_map``
over the mesh.  A mesh's model axis waits for ROADMAP A10b: the hook is
here (it names ``W``), and the explicit table-parallel lookup raises
naming A10b.  On one
card the table is dense, and the Adam update is the reference's: the
whole table moves every step (rows with no gradient move through their
moments), no sparse gradient.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weight
# the canonical hash lives with the ingestion pipeline (pure numpy);
# re-exported so layer users get hashing and lookup from one place
from deeplearning4j_tpu_torch.datavec.pipeline import hash_feature  # noqa: F401

__all__ = ["ShardedEmbeddingBag", "bag_lookup", "bag_lookup_dedup",
           "embedding_lookup_table_parallel", "hash_feature",
           "alltoall_bytes_per_lookup"]


def _pool(e, weights, combiner: str):
    """Weighted sum over the bag axis: ``e`` (R, S, D) × ``weights``
    (R, S) → (R, D).  Weights carry both the padding mask and host-side
    dedup multiplicity counts."""
    pooled = (e * weights[..., None]).sum(dim=1)
    if combiner == "mean":
        pooled = pooled / torch.clamp(weights.sum(dim=1), min=1.0)[..., None]
    return pooled


def bag_lookup(W, ids, weights, combiner: str = "sum"):
    """Plain lookup: gather every id, pool.  (R, S) ids → (R, D)."""
    return _pool(F.embedding(ids.long(), W), weights, combiner)


def bag_lookup_dedup(W, ids, weights, combiner: str = "sum",
                     dedupSize: int = 0):
    """Two-phase lookup: batch-wide dedup into a fixed-size buffer, gather
    only the unique rows, scatter back through the inverse map, pool.

    ``dedupSize`` bounds the unique-id buffer; 0 means ``ids.numel()``
    (lossless).  Below the batch's distinct count the reference's
    ``jnp.unique(size=, fill_value=0)`` keeps the smallest ids, and each
    dropped id's inverse index, past the buffer, reads the buffer's last
    row (JAX clamps an out-of-range gather) and gets no gradient back
    (XLA's scatter-add drops an out-of-range update): this does the same,
    so the same rows are dropped, stand in and learn."""
    flat = ids.reshape(-1).long()
    n = flat.shape[0]
    size = min(int(dedupSize), n) if dedupSize else n
    uniq, inv = torch.unique(flat, sorted=True, return_inverse=True)
    if uniq.shape[0] >= size:
        uniq = uniq[:size]
    else:
        uniq = torch.cat([uniq, uniq.new_zeros(size - uniq.shape[0])])
    # F.embedding, not W[idx]: its backward is a sorted segment sum, where
    # advanced indexing's accumulate kernel takes ~0.9 s for a 10M-row
    # table on an H100 (ROADMAP, Not queued)
    e = F.embedding(inv.clamp(max=size - 1), F.embedding(uniq, W))
    if size < n:
        # XLA's gather clamps the out-of-range read, but the scatter-add of
        # its gradient drops it: a dropped id reads the last row and sends
        # that row nothing back
        e = torch.where((inv >= size)[:, None], e.detach(), e)
    return _pool(e.reshape(*ids.shape, -1), weights, combiner)


def alltoall_bytes_per_lookup(numRanks: int, uniqSize: int,
                              embeddingDim: int,
                              rowBytes: int = 4, idBytes: int = 4) -> int:
    """Interconnect bytes one table-parallel lookup moves (per model
    group): the id request all-to-all + the resolved-row all-to-all + the
    row all-gather.  Static — feeds the
    ``dl4j_tpu_recsys_alltoall_bytes_total`` counter."""
    ids_phase = numRanks * uniqSize * idBytes
    rows_phase = numRanks * uniqSize * embeddingDim * rowBytes
    gather_phase = numRanks * uniqSize * embeddingDim * rowBytes
    return ids_phase + rows_phase + gather_phase


def embedding_lookup_table_parallel(mesh, W, ids, weights=None,
                                    combiner: str = "sum",
                                    dedupSize: int = 0,
                                    axis_name: str = "model",
                                    data_axis: str = "data"):
    """The reference's explicit table-parallel lookup, a ``shard_map``
    over a device mesh's model axis: it waits for ROADMAP A10b, so it
    raises."""
    raise NotImplementedError(
        "embedding_lookup_table_parallel shards the table over a device "
        "mesh's model axis, which waits for ROADMAP A10b")


@register_layer
@dataclasses.dataclass
class ShardedEmbeddingBag(BaseLayer):
    """Pooled embedding lookup over bags of hashed feature ids.

    Input (FF): (b, numFields * bagSize) float-encoded int ids (the fit
    path keeps features float32; ids are exact up to 2**24, so no cast to
    a half type may touch them).  ``featuresMask`` of the same shape
    carries per-id weights: 0 pads ragged bags, >1 carries host-side dedup
    multiplicity from ``RaggedFeatureReader``.  Output: (b, numFields *
    embeddingDim) pooled field embeddings.

    ``rowShardedParamKeys`` names the table for a mesh plan (ROADMAP
    A10b); on one card the table is dense.  Ids that arrive in a half type
    raise (ROADMAP C26: the reference looks up the rounded ids).
    """
    numEmbeddings: int = 0
    embeddingDim: int = 0
    numFields: int = 1
    bagSize: int = 0
    combiner: str = "sum"          # | "mean"
    dedupSize: int = 0             # 0 = lossless (ids.numel()) buffer

    acceptsMask = True             # featuresMask = per-id bag weights

    def preferredFormat(self):
        return "FF"

    def inferNIn(self, inputType):
        if not self.bagSize:
            if inputType.size % self.numFields:
                raise ValueError(
                    f"input size {inputType.size} not divisible by "
                    f"numFields {self.numFields}")
            self.bagSize = inputType.size // self.numFields

    def getOutputType(self, inputType):
        return InputType.feedForward(self.numFields * self.embeddingDim)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        return {"W": init_weight(
            gen, (self.numEmbeddings, self.embeddingDim),
            self.numEmbeddings, self.embeddingDim,
            self.weightInit or "XAVIER", dtype, device)}

    def rowShardedParamKeys(self):
        """Params whose LEADING dim row-shards over the model axis."""
        return ("W",)

    def forward(self, params, x, train, gen, state, mask=None):
        if x.dtype not in (torch.float32, torch.float64) and \
                x.is_floating_point():
            raise TypeError(
                f"ShardedEmbeddingBag ids arrived as {x.dtype}: a half type "
                "holds integers exactly only up to 2048 / 256 — keep the "
                "features float32")
        ids = x.long()
        b = x.shape[0]
        w = mask.to(x.dtype) if mask is not None \
            else torch.ones(x.shape, dtype=x.dtype, device=x.device)
        # bag width comes from the BATCH, not the config: the ragged
        # reader pads each batch to the smallest bucket that fits
        ids2 = ids.reshape(b * self.numFields, -1)
        w2 = w.reshape(b * self.numFields, -1)
        pooled = bag_lookup_dedup(params["W"], ids2, w2, self.combiner,
                                  self.dedupSize)
        return pooled.reshape(b, self.numFields * self.embeddingDim), state
