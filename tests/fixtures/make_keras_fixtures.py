"""Write the Keras import fixtures: a weight-stripped ResNet-50 ``.h5``,
the long-context Keras transformer ``.h5``, a narrow ``.keras`` archive,
keras's outputs for each, and an h5py manifest of every HDF5 file.

    python tests/fixtures/make_keras_fixtures.py

Every size, seed and name comes from ``chip_smoke.KERAS`` (the phases
that read these files); nothing is downloaded.

- ``keras_resnet50_skeleton.h5``: ``keras.applications.ResNet50(
  weights=None)`` (224 x 224 x 3, 1000 classes) saved as ``.h5`` (about
  103 MB), then every dataset refilled in the file's visit order by
  ``chip_smoke._keras_refill_all`` from ``resnet_seed``, the refilled file
  loaded back by ``keras.models.load_model`` and run on
  ``RandomState(resnet_input_seed)`` normal images of ``resnet_batch``
  (keras's ``avg_pool`` features and probabilities go into the ``.npz``).
  The committed file is a copy with every group, attribute and dataset
  but the datasets' storage left unallocated (h5py reads them as zeros):
  a reader refills them by the same rule.
- ``keras_transformer_t2048.h5``: keras.io's "Text classification with
  Transformer" block at the widths of ``bench.py``'s long-context net
  (see ``chip_smoke.KERAS``), keras's random weights from ``keras_seed``,
  every weight kept, with keras's probabilities and pooled features on
  ``RandomState(transformer_input_seed)`` normal inputs.
- ``keras_narrow_v3.keras``: a narrow keras-3 archive (Conv1D,
  MultiHeadAttention, Add, LayerNormalization, Bidirectional LSTM,
  GlobalAveragePooling1D, Dense softmax), compiled with Adam, with
  keras's outputs on ``RandomState(v3_input_seed)`` inputs.
- ``keras_fixtures_io.npz``: those outputs.
- ``keras_fixtures_manifest.json``: per HDF5 file (the two ``.h5`` and the
  archive's ``model.weights.h5``), its groups, its datasets (shape, dtype,
  whether storage is allocated) and each object's attribute names, read
  with h5py.

Needs keras 3, tensorflow and h5py.
"""
from __future__ import annotations

import io
import json
import os
import sys
import tempfile
import zipfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(os.path.dirname(HERE)))

from chip_smoke import KERAS, _keras_refill_all  # noqa: E402


def _datasets(f):
    """``(path, shape)`` of every dataset of an h5py file, in visit order."""
    import h5py
    out = []
    f.visititems(lambda n, o: out.append((n, o.shape))
                 if isinstance(o, h5py.Dataset) else None)
    return out


def _copy_attrs(src, dst):
    for name in src.attrs:
        dst.attrs.create(name, src.attrs[name],
                         dtype=src.attrs.get_id(name).dtype)


def strip(src_path, dst_path):
    """Copy ``src_path`` to ``dst_path`` with every group and attribute
    and every dataset's shape and dtype, leaving the datasets' storage
    unallocated."""
    import h5py
    with h5py.File(src_path, "r") as src, h5py.File(dst_path, "w") as dst:
        _copy_attrs(src, dst)

        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                dst.create_dataset(name, shape=obj.shape, dtype=obj.dtype)
            else:
                dst.create_group(name)
            _copy_attrs(obj, dst[name])
        src.visititems(visit)


def manifest(f):
    """Groups, datasets and attribute names of an h5py file."""
    import h5py
    groups, datasets, attrs = [], {}, {"/": sorted(f.attrs)}

    def visit(name, obj):
        attrs[name] = sorted(obj.attrs)
        if isinstance(obj, h5py.Dataset):
            datasets[name] = [list(obj.shape), obj.dtype.str,
                              obj.id.get_storage_size() > 0]
        else:
            groups.append(name)
    f.visititems(visit)
    return {"groups": groups, "datasets": datasets, "attrs": attrs}


def _resnet(tmp):
    import h5py
    import keras
    c = KERAS
    full = os.path.join(tmp, "resnet50_full.h5")
    keras.applications.ResNet50(weights=None).save(full)
    with h5py.File(full, "r+") as f:
        filled = _keras_refill_all(_datasets(f), c["resnet_seed"])
        for path, value in filled.items():
            f[path][...] = value
    model = keras.models.load_model(full, compile=False)
    x = np.random.RandomState(c["resnet_input_seed"]).standard_normal(
        (c["resnet_batch"], 224, 224, 3)).astype(np.float32)
    feats = keras.Model(model.inputs, model.get_layer("avg_pool").output)
    out = {"resnet_avg_pool": np.asarray(feats(x)),
           "resnet_probs": np.asarray(model(x))}
    strip(full, os.path.join(HERE, c["resnet"]))
    print(f"ResNet-50: {model.count_params()} params, {len(filled)} "
          "datasets refilled")
    return out


def _transformer():
    import keras
    from keras import layers
    c = KERAS
    keras.utils.set_random_seed(c["keras_seed"])
    inp = keras.Input(shape=(c["t"], c["d"]))
    x = inp
    for _ in range(c["blocks"]):
        attn = layers.MultiHeadAttention(num_heads=c["heads"],
                                         key_dim=c["key_dim"])(x, x)
        attn = layers.Dropout(0.1)(attn)
        x = layers.LayerNormalization(epsilon=1e-6)(layers.Add()([x, attn]))
        ffn = layers.Dense(c["ff"], activation="relu")(x)
        ffn = layers.Dense(c["d"])(ffn)
        ffn = layers.Dropout(0.1)(ffn)
        x = layers.LayerNormalization(epsilon=1e-6)(layers.Add()([x, ffn]))
    pooled = layers.GlobalAveragePooling1D(name="pool")(x)
    out = layers.Dense(c["classes"], activation="softmax")(pooled)
    model = keras.Model(inp, out)
    model.save(os.path.join(HERE, c["transformer"]))
    x = np.random.RandomState(c["transformer_input_seed"]).standard_normal(
        (c["batch"], c["t"], c["d"])).astype(np.float32)
    pool = keras.Model(model.inputs, model.get_layer("pool").output)
    print(f"transformer: {model.count_params()} params")
    return {"transformer_pool": np.asarray(pool(x)),
            "transformer_probs": np.asarray(model(x))}


def _narrow_v3():
    import keras
    from keras import layers
    c = KERAS
    keras.utils.set_random_seed(c["keras_seed"])
    _, t, f = c["v3_shape"]
    inp = keras.Input(shape=(t, f))
    x = layers.Conv1D(8, 3, padding="same", activation="relu")(inp)
    att = layers.MultiHeadAttention(num_heads=2, key_dim=4)(x, x)
    x = layers.LayerNormalization()(layers.Add()([x, att]))
    x = layers.Bidirectional(layers.LSTM(4, return_sequences=True))(x)
    x = layers.GlobalAveragePooling1D()(x)
    out = layers.Dense(3, activation="softmax")(x)
    model = keras.Model(inp, out)
    model.compile(optimizer=keras.optimizers.Adam(learning_rate=3e-3),
                  loss="categorical_crossentropy")
    model.save(os.path.join(HERE, c["v3"]))
    x = np.random.RandomState(c["v3_input_seed"]).standard_normal(
        c["v3_shape"]).astype(np.float32)
    return {"v3_probs": np.asarray(model(x))}


def main():
    import h5py
    c = KERAS
    io_arrays = {}
    with tempfile.TemporaryDirectory() as tmp:
        io_arrays.update(_resnet(tmp))
    io_arrays.update(_transformer())
    io_arrays.update(_narrow_v3())
    np.savez(os.path.join(HERE, c["io"]), **io_arrays)
    man = {}
    for name in (c["resnet"], c["transformer"]):
        with h5py.File(os.path.join(HERE, name), "r") as f:
            man[name] = manifest(f)
    with zipfile.ZipFile(os.path.join(HERE, c["v3"])) as z:
        raw = z.read("model.weights.h5")
    with h5py.File(io.BytesIO(raw), "r") as f:
        man[c["v3"] + ":model.weights.h5"] = manifest(f)
    with open(os.path.join(HERE, c["manifest"]), "w") as fh:
        json.dump(man, fh, indent=0, sort_keys=True)
    for name in (c["resnet"], c["transformer"], c["v3"], c["io"],
                 c["manifest"]):
        print(name, os.path.getsize(os.path.join(HERE, name)), "bytes")


if __name__ == "__main__":
    main()
