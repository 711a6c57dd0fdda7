"""Write the weight-stripped BERT-base ONNX model, its manifest, and two
narrow BERT exports.

    python tests/fixtures/make_onnx_bert_skeleton.py

The model is HuggingFace ``BertModel(BertConfig(), add_pooling_layer=False)``
with eager attention: the published bert-base-uncased widths (12 layers,
hidden 768, 12 heads, FFN 3072, vocab 30522, 512 positions, type vocab 2),
randomly initialised from a seed (nothing is downloaded).  It is exported
through a thin wrapper that builds the additive attention mask by
broadcasting, ``(1 - mask[:, None, None, :]) * finfo(float32).min``, and
returns ``encoder(embeddings(ids, token types), mask).last_hidden_state``
(the same values as ``BertModel``'s forward).  Inputs ``input_ids``,
``attention_mask`` and ``token_type_ids``, each int64 [32, 128] (the usual
fine-tuning batch); output ``last_hidden_state``.  torch's TorchScript
exporter writes it (``dynamo=False``, opset 17); ``_add_onnxscript_fn``,
the exporter's one step that needs the ``onnx`` package, is bypassed as
``tools/make_onnx_fixture.py`` does (these models hold no onnxscript
function).

BERT-base is ~435 MB, too large to commit.  ``strip`` drops ``raw_data``
(TensorProto field 9) from every initializer (GraphProto field 5) over
4,096 bytes, working on the wire bytes (no ``onnx`` package), and the
manifest beside the ``.onnx`` lists what was dropped (name, dtype, shape)
in order.  A reader refills them from a seed before importing
(``chip_smoke._fill_stripped_initializers``).

The same code writes two narrow exports (2 layers, hidden 64, 4 heads, FFN
128, vocab 1000, 32 positions, batch 2 x 16), each with every weight:
- ``onnx_bert_narrow_b2_t16.onnx`` through the wrapper, with its torch
  golden ``onnx_bert_narrow_b2_t16_io.npz`` (inputs and output);
- ``onnx_bert_narrow_hf_default.onnx``, HF's ``BertModel`` forward with
  its default (SDPA) attention exported as it is: its attention mask goes
  through a ConstantOfShape -> Equal -> Where -> Expand chain that the
  importer does not fold.

Needs torch and transformers.
"""
from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
STEM = os.path.join(HERE, "onnx_bert_base_b32_t128_skeleton")
NARROW_STEM = os.path.join(HERE, "onnx_bert_narrow_b2_t16")
HF_DEFAULT = os.path.join(HERE, "onnx_bert_narrow_hf_default.onnx")
BATCH, SEQ = 32, 128
NARROW = dict(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
              intermediate_size=128, vocab_size=1000,
              max_position_embeddings=32)
NARROW_BATCH, NARROW_SEQ = 2, 16
STRIP_BYTES = 4096
INPUTS = ["input_ids", "attention_mask", "token_type_ids"]
OPSET = 17
# TensorProto.DataType -> numpy name, for the manifest
_DTYPES = {1: "float32", 6: "int32", 7: "int64", 9: "bool", 10: "float16",
           11: "float64"}


# ---------------------------------------------------------------------------
# wire format: enough to walk ModelProto -> GraphProto -> TensorProto and
# write the bytes back with one field dropped
# ---------------------------------------------------------------------------
def _varint(buf: bytes, i: int):
    shift = result = 0
    while True:
        b = buf[i]
        i += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, i
        shift += 7


def _encode_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def spans(buf: bytes):
    """Yield (field number, wire type, value, the field's whole bytes)."""
    i, n = 0, len(buf)
    while i < n:
        start = i
        key, i = _varint(buf, i)
        fnum, wt = key >> 3, key & 7
        if wt == 0:
            val, i = _varint(buf, i)
        elif wt == 1:
            val, i = buf[i:i + 8], i + 8
        elif wt == 2:
            ln, i = _varint(buf, i)
            val, i = buf[i:i + ln], i + ln
        elif wt == 5:
            val, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"unsupported wire type {wt}")
        yield fnum, wt, val, buf[start:i]


def field(fnum: int, payload: bytes) -> bytes:
    """A length-delimited field."""
    return _encode_varint((fnum << 3) | 2) + _encode_varint(len(payload)) \
        + payload


def rewrite_initializers(model: bytes, fn) -> bytes:
    """``model`` with each initializer's bytes replaced by
    ``fn(tensor bytes)``; every other byte is kept as it was."""
    out = bytearray()
    for fnum, wt, val, raw in spans(model):
        if fnum != 7 or wt != 2:                  # ModelProto.graph
            out += raw
            continue
        graph = bytearray()
        for gf, gwt, gval, graw in spans(val):
            graph += field(5, fn(gval)) if gf == 5 and gwt == 2 else graw
        out += field(7, bytes(graph))
    return bytes(out)


def tensor_header(tensor: bytes):
    """(name, dtype name, dims, raw_data length) of a TensorProto."""
    name, dtype, dims, raw = "", "float32", [], 0
    for f, wt, v, _ in spans(tensor):
        if f == 1:
            if wt == 2:                           # packed dims
                j = 0
                while j < len(v):
                    d, j = _varint(v, j)
                    dims.append(d)
            else:
                dims.append(v)
        elif f == 2:
            dtype = _DTYPES[v]
        elif f == 8:
            name = v.decode()
        elif f == 9:
            raw = len(v)
    return name, dtype, dims, raw


def strip(model: bytes, strip_bytes: int = STRIP_BYTES):
    """(the model without the raw_data of its initializers over
    ``strip_bytes``, the manifest of what was dropped)."""
    stripped = []

    def drop(tensor: bytes) -> bytes:
        name, dtype, dims, raw = tensor_header(tensor)
        if raw <= strip_bytes:
            return tensor
        stripped.append({"name": name, "dtype": dtype, "shape": dims})
        return b"".join(r for f, _wt, _v, r in spans(tensor) if f != 9)

    out = rewrite_initializers(model, drop)
    return out, {"strip_bytes": strip_bytes, "stripped": stripped}


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------
def _bert(config_kw, seed=0, eager=True):
    """BertModel without its pooler, from ``seed``; eager attention, or
    HF's default (SDPA) when ``eager`` is false.  Both draw the same
    weights."""
    import torch
    from transformers import BertConfig, BertModel
    torch.manual_seed(seed)
    config = BertConfig(**config_kw)
    if eager:
        config._attn_implementation = "eager"
    return BertModel(config, add_pooling_layer=False).eval()


def _wrapper(bert):
    import torch

    class Encoder(torch.nn.Module):
        """BertModel's forward with the additive mask built by
        broadcasting (no Equal/Where chain in the export)."""

        def __init__(self):
            super().__init__()
            self.bert = bert

        def forward(self, input_ids, attention_mask, token_type_ids):
            ext = (1.0 - attention_mask[:, None, None, :].float()) \
                * torch.finfo(torch.float32).min
            emb = self.bert.embeddings(input_ids=input_ids,
                                       token_type_ids=token_type_ids)
            return self.bert.encoder(emb,
                                     attention_mask=ext).last_hidden_state

    return Encoder().eval()


def _hf_default(bert):
    """HF's own forward, returning ``last_hidden_state``."""
    import torch

    class Default(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.bert = bert

        def forward(self, input_ids, attention_mask, token_type_ids):
            return self.bert(input_ids=input_ids,
                             attention_mask=attention_mask,
                             token_type_ids=token_type_ids).last_hidden_state

    return Default().eval()


def inputs(batch, seq, vocab, seed=0):
    """Seeded int64 ids, a mask that pads the last quarter of every other
    row, token types 0 then 1."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(0, vocab, (batch, seq)).astype(np.int64)
    mask = np.ones((batch, seq), np.int64)
    mask[::2, seq - seq // 4:] = 0
    tt = np.zeros((batch, seq), np.int64)
    tt[:, seq // 2:] = 1
    return ids, mask, tt


def export(module, batch, seq, vocab) -> bytes:
    """The module exported by torch's TorchScript exporter, as bytes."""
    import io

    import torch
    import torch.onnx._internal.torchscript_exporter.onnx_proto_utils as opu
    opu._add_onnxscript_fn = lambda model_bytes, custom_opsets: model_bytes
    args = tuple(torch.from_numpy(a) for a in inputs(batch, seq, vocab))
    buf = io.BytesIO()
    with torch.no_grad():
        torch.onnx.export(module, args, buf, dynamo=False,
                          opset_version=OPSET, input_names=INPUTS,
                          output_names=["last_hidden_state"])
    return buf.getvalue()


def node_ops(model: bytes):
    """The op type of every node of the graph, in order."""
    ops = []
    for f, _wt, v, _ in spans(model):
        if f == 7:
            for gf, _gwt, gv, _ in spans(v):
                if gf == 1:
                    ops += [nv.decode() for nf, _n, nv, _ in spans(gv)
                            if nf == 4]
    return ops


def main():
    import torch
    from collections import Counter

    # BERT-base, stripped
    model = export(_wrapper(_bert({})), BATCH, SEQ, 30522)
    full = len(model)
    model, manifest = strip(model)
    ops = node_ops(model)
    manifest = {"model": "BertModel(BertConfig(), add_pooling_layer=False)"
                         " through the broadcast-mask wrapper",
                "batch": BATCH, "seq": SEQ, "opset": OPSET,
                "full_bytes": full, "nodes": len(ops),
                "ops": dict(sorted(Counter(ops).items())), **manifest}
    with open(STEM + ".onnx", "wb") as f:
        f.write(model)
    with open(STEM + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"{STEM}.onnx: {len(model)} bytes (of {full}), {len(ops)} nodes, "
          f"{len(manifest['stripped'])} initializers stripped")

    # the narrow exports, every weight kept
    bert = _bert(NARROW)
    b, t, v = NARROW_BATCH, NARROW_SEQ, NARROW["vocab_size"]
    enc = _wrapper(bert)
    with open(NARROW_STEM + ".onnx", "wb") as f:
        f.write(export(enc, b, t, v))
    ids, mask, tt = inputs(b, t, v)
    with torch.no_grad():
        y = enc(*(torch.from_numpy(a) for a in (ids, mask, tt))).numpy()
    np.savez(NARROW_STEM + "_io.npz", input_ids=ids, attention_mask=mask,
             token_type_ids=tt, y=y)
    with open(HF_DEFAULT, "wb") as f:
        f.write(export(_hf_default(_bert(NARROW, eager=False)), b, t, v))
    for p in (NARROW_STEM + ".onnx", HF_DEFAULT):
        print(f"{p}: {os.path.getsize(p)} bytes")


if __name__ == "__main__":
    main()
