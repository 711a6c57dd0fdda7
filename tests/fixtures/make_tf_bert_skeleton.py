"""Write the weight-stripped frozen BERT-base GraphDef and its manifest.

    python tests/fixtures/make_tf_bert_skeleton.py

The model is HuggingFace ``TFBertModel(BertConfig())``: the published
bert-base-uncased widths (12 layers, hidden 768, 12 heads, FFN 3072, vocab
30522, 512 positions, type vocab 2), randomly initialised (nothing is
downloaded).  Its ``tf.function`` takes ``input_ids`` and
``attention_mask``, int32 [32, 128] (the usual fine-tuning batch), and
returns ``last_hidden_state``; ``convert_variables_to_constants_v2``
freezes it.

A frozen BERT-base is ~438 MB, too large to commit.  This script clears the
``tensor_content`` of every Const over 4,096 bytes (its dtype and shape
stay, and so does every node), and writes beside the ``.pb`` a manifest of
the stripped Consts (name, dtype, shape).  A reader refills them from a
seed before importing (``chip_smoke._fill_stripped_consts``).

Needs the tensorflow and transformers packages.
"""
from __future__ import annotations

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
STEM = os.path.join(HERE, "tf_bert_base_b32_t128_skeleton")
BATCH, SEQ = 32, 128
STRIP_BYTES = 4096


def frozen_bert_base():
    """(frozen concrete function, its GraphDef) of BERT-base at
    BATCH × SEQ."""
    import tensorflow as tf
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    from transformers import BertConfig, TFBertModel
    model = TFBertModel(BertConfig())

    @tf.function(input_signature=[tf.TensorSpec([BATCH, SEQ], tf.int32),
                                  tf.TensorSpec([BATCH, SEQ], tf.int32)])
    def f(input_ids, attention_mask):
        return model(input_ids=input_ids,
                     attention_mask=attention_mask).last_hidden_state

    frozen = convert_variables_to_constants_v2(f.get_concrete_function())
    return frozen, frozen.graph.as_graph_def()


def strip(gd):
    """Clear the content of every Const over STRIP_BYTES in place; the
    manifest of what was cleared."""
    from tensorflow.python.framework import dtypes
    stripped = []
    for node in gd.node:
        if node.op != "Const":
            continue
        t = node.attr["value"].tensor
        if len(t.tensor_content) <= STRIP_BYTES:
            continue
        stripped.append({
            "name": node.name,
            "dtype": dtypes.as_dtype(t.dtype).name,
            "shape": [int(d.size) for d in t.tensor_shape.dim]})
        t.tensor_content = b""
    return {"model": "TFBertModel(BertConfig())", "batch": BATCH,
            "seq": SEQ, "strip_bytes": STRIP_BYTES,
            "nodes": len(gd.node), "stripped": stripped}


def main():
    _frozen, gd = frozen_bert_base()
    manifest = strip(gd)
    with open(STEM + ".pb", "wb") as f:
        f.write(gd.SerializeToString())
    with open(STEM + ".json", "w") as f:
        json.dump(manifest, f, indent=1)
    print(f"{STEM}.pb: {os.path.getsize(STEM + '.pb')} bytes, "
          f"{manifest['nodes']} nodes, {len(manifest['stripped'])} "
          "Consts stripped")


if __name__ == "__main__":
    main()
