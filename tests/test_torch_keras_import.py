"""The Keras importer (ROADMAP A12d) against the reference's importer and
keras's own forward.

Each model of the reference's Keras tests (``test_keras_breadth.py``,
``test_keras_breadth2.py``, ``test_keras_v3_format.py``,
``test_keras_applications.py``, ``test_import_breadth.py`` and the Keras
part of ``test_imports.py``) is built with keras 3 (or the legacy
``tf_keras`` where the reference's test uses it), saved as ``.h5`` and,
for the keras-3 ones, as ``.keras``, and imported by both packages: the
port's output is held to keras's at the reference test's tolerance and to
the reference importer's at ``REF_TOL`` (the same float32 weights through
two frameworks).  The port's importer reads the files with its own HDF5
reader; the reference's with h5py.  Then the updaters from
``training_config`` / ``compile_config``, the refusals, the custom and
Lambda registries, fine-tuning, the serializer, ROADMAP C8, and the
committed fixtures of ``tests/fixtures/make_keras_fixtures.py``.
"""
import os

import numpy as np
import pytest
import torch

keras = pytest.importorskip("keras")
pytest.importorskip("h5py")

from deeplearning4j_tpu.imports import \
    KerasModelImport as JImport  # noqa: E402
from deeplearning4j_tpu_torch.imports import KerasModelImport  # noqa: E402
from deeplearning4j_tpu_torch.models import ComputationGraph  # noqa: E402

pytestmark = pytest.mark.torch_port

L = keras.layers
FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
#: the port's output against the reference importer's (both float32)
REF_TOL = dict(atol=1e-5, rtol=1e-4)


def _to_ours(x):
    if x.ndim == 3:                       # (b, t, f)   -> (b, f, t)
        return np.transpose(x, (0, 2, 1))
    if x.ndim == 4:                       # NHWC        -> NCHW
        return np.transpose(x, (0, 3, 1, 2))
    if x.ndim == 5:                       # (b,d,h,w,c) -> NCDHW
        return np.transpose(x, (0, 4, 1, 2, 3))
    return x


def _to_keras(y):
    y = np.asarray(y)
    if y.ndim == 3:
        return np.transpose(y, (0, 2, 1))
    if y.ndim == 4:
        return np.transpose(y, (0, 2, 3, 1))
    if y.ndim == 5:
        return np.transpose(y, (0, 2, 3, 4, 1))
    return y


def _outputs(net, xs):
    """Every output of ``net`` on keras-layout inputs, in keras layout."""
    out = net.output(*[_to_ours(x) for x in xs])
    if isinstance(out, dict):
        out = list(out.values())
    if not isinstance(out, (list, tuple)):
        out = [out]
    return [_to_keras(np.asarray(o.numpy() if hasattr(o, "numpy") else o))
            for o in out]


def _rng(seed):
    return np.random.RandomState(seed)


# ---------------------------------------------------------------------------
# the reference tests' models: name -> () -> (model, inputs, atol)
# ---------------------------------------------------------------------------

def _seq(*layers):
    return keras.Sequential(list(layers))


def _transformer_block():
    inp = keras.Input(shape=(6, 8))
    att = L.MultiHeadAttention(num_heads=2, key_dim=4, name="mha")(inp, inp)
    x = L.LayerNormalization(name="ln1")(L.Add()([inp, att]))
    f = L.Dense(8)(L.Dense(16, activation="relu")(x))
    out = L.LayerNormalization(name="ln2")(L.Add()([x, f]))
    return keras.Model(inp, out), [_rng(2).randn(4, 6, 8)], 3e-4


def _two_heads():
    inp = keras.Input(shape=(6,))
    model = keras.Model(inp, [L.Dense(3, name="head_a")(inp),
                              L.Dense(2, name="head_b")(inp)])
    return model, [_rng(1).randn(4, 6)], 1e-4


def _bn_set(model, i, rng):
    n = model.layers[i].get_weights()[0].shape[0]
    model.layers[i].set_weights([rng.rand(n) + .5, rng.randn(n),
                                 rng.randn(n), rng.rand(n) + .5])
    return model


def _mobilenet_style():
    keras.utils.set_random_seed(42)

    def block(x, filters, stride=1):
        x = L.DepthwiseConv2D(3, strides=stride, padding="same",
                              use_bias=False)(x)
        x = L.Activation("relu6")(L.BatchNormalization()(x))
        x = L.Conv2D(filters, 1, use_bias=False)(x)
        return L.Activation("relu6")(L.BatchNormalization()(x))

    inp = keras.Input(shape=(32, 32, 3))
    x = L.Activation("relu6")(L.BatchNormalization()(
        L.Conv2D(8, 3, strides=2, padding="same")(inp)))
    x = block(block(block(x, 16), 24, stride=2), 24)
    out = L.Dense(5, activation="softmax")(L.GlobalAveragePooling2D()(x))
    return keras.Model(inp, out), [_rng(21).randn(4, 32, 32, 3)], 2e-3


def _prelu(model, shape, seed):
    model.layers[-1].set_weights([_rng(seed).rand(*shape)])
    return model


def _functional_prelu3d():
    inp = keras.Input(shape=(3, 4, 4, 2))
    s = L.Add()([L.Conv3D(3, 2, name="c3a")(inp),
                 L.Conv3D(3, 2, name="c3b")(inp)])
    model = keras.Model(inp, L.PReLU(shared_axes=[1, 2, 3], name="pr")(s))
    model.get_layer("pr").set_weights([_rng(16).rand(1, 1, 1, 3)])
    return model, [_rng(16).randn(2, 3, 4, 4, 2)], 3e-4


def _masked(x, steps):
    for b, t in steps:
        x[b, t:] = 0.0
    return x


def _residual_dense():
    inp = keras.Input(shape=(10,))
    h = L.Dense(10, activation="relu")(inp)
    out = L.Dense(3, activation="softmax")(L.Add()([h, L.Dense(10)(h)]))
    return keras.Model(inp, out), [_rng(11).randn(4, 10)], 1e-4


def _concat_dense():
    inp = keras.Input(shape=(6,))
    cat = L.Concatenate()([L.Dense(4, activation="tanh")(inp),
                           L.Dense(5, activation="relu")(inp)])
    out = L.Dense(2, activation="softmax")(cat)
    return keras.Model(inp, out), [_rng(12).randn(3, 6)], 1e-4


def _conv_residual_flatten():
    inp = keras.Input(shape=(8, 8, 3))
    c1 = L.Conv2D(4, 3, padding="same", activation="relu")(inp)
    added = L.Add()([c1, L.Conv2D(4, 3, padding="same")(c1)])
    out = L.Dense(3, activation="softmax")(L.Flatten()(added))
    return keras.Model(inp, out), [_rng(13).randn(2, 8, 8, 3)], 1e-3


def _multi_input():
    in1, in2 = keras.Input(shape=(5,)), keras.Input(shape=(7,))
    m = L.Average()([L.Dense(6, activation="relu")(in1),
                     L.Dense(6, activation="relu")(in2)])
    model = keras.Model([in1, in2], L.Dense(2, activation="softmax")(m))
    return model, [_rng(14).randn(3, 5), _rng(15).randn(3, 7)], 1e-4


def _minimum():
    inp = keras.Input(shape=(6,))
    out = L.Minimum()([L.Dense(4, name="a")(inp), L.Dense(4, name="b")(inp)])
    return keras.Model(inp, out), [_rng(6).randn(3, 6)], 1e-4


def _functional_chain():
    inp = keras.Input(shape=(10,))
    out = L.Dense(3, activation="softmax")(L.Dense(8, activation="relu")(inp))
    return keras.Model(inp, out), [_rng(8).randn(4, 10)], 1e-4


def _v3_transformer():
    inp = keras.Input(shape=(6, 8))
    att = L.MultiHeadAttention(num_heads=2, key_dim=4, name="mha")(inp, inp)
    out = L.LayerNormalization()(L.Add()([inp, att]))
    return keras.Model(inp, out), [_rng(5).randn(2, 6, 8)], 3e-4


def _bn_trained():
    m = _seq(L.Input(shape=(6,)), L.Dense(4), L.BatchNormalization())
    m.compile(optimizer="adam", loss="mse")
    rng = _rng(6)
    m.fit(rng.randn(32, 6), rng.randn(32, 4), epochs=2, verbose=0)
    return m, [rng.randn(4, 6)], 3e-4


MODELS = {
    # test_keras_breadth.py
    "layernorm_dense_stack": lambda: (_seq(
        L.Input(shape=(10,)), L.Dense(16, activation="relu"),
        L.LayerNormalization(), L.Dense(4)), [_rng(0).randn(5, 10)], 1e-4),
    "layernorm_on_sequence": lambda: (_seq(
        L.Input(shape=(6, 8)), L.LayerNormalization(),
        L.LSTM(5, return_sequences=True)), [_rng(1).randn(3, 6, 8)], 1e-4),
    "transformer_encoder_block": _transformer_block,
    "multi_head_output": _two_heads,
    "time_distributed_conv_lstm": lambda: (_seq(
        L.Input(shape=(5, 10, 10, 1)),
        L.TimeDistributed(L.Conv2D(3, 3, activation="relu")),
        L.TimeDistributed(L.MaxPooling2D(2)),
        L.TimeDistributed(L.Flatten()), L.LSTM(7), L.Dense(4)),
        [_rng(3).randn(2, 5, 10, 10, 1)], 1e-3),
    "time_distributed_dense": lambda: (_seq(
        L.Input(shape=(6, 9)),
        L.TimeDistributed(L.Dense(5, activation="tanh")),
        L.LSTM(4, return_sequences=True)), [_rng(4).randn(3, 6, 9)], 1e-4),
    "reshape_permute_conv": lambda: (_seq(
        L.Input(shape=(24,)), L.Reshape((4, 3, 2)), L.Permute((3, 1, 2)),
        L.Conv2D(2, 1), L.Flatten(), L.Dense(3)), [_rng(5).randn(4, 24)],
        1e-4),
    "conv3d_stack": lambda: (_seq(
        L.Input(shape=(6, 8, 8, 2)), L.Conv3D(3, 2, activation="relu"),
        L.MaxPooling3D(2), L.Flatten(), L.Dense(4)),
        [_rng(6).randn(2, 6, 8, 8, 2)], 1e-3),
    "gaussian_noise_dropout": lambda: (_seq(
        L.Input(shape=(7,)), L.Dense(9, activation="selu"),
        L.GaussianNoise(0.3), L.GaussianDropout(0.2), L.AlphaDropout(0.1),
        L.Dense(3)), [_rng(7).randn(5, 7)], 1e-4),
    **{f"bidirectional_{cell.__name__}_{rs}": (
        lambda cell=cell, rs=rs: (_seq(
            L.Input(shape=(7, 5)), L.Bidirectional(cell(6,
                                                        return_sequences=rs)),
            L.Dense(3)), [_rng(14).randn(4, 7, 5)], 2e-3))
       for cell in (L.GRU, L.SimpleRNN) for rs in (True, False)},
    **{f"bidirectional_last_step_{m}": (
        lambda m=m: (_seq(
            L.Input(shape=(7, 5)), L.Bidirectional(L.LSTM(6), merge_mode=m),
            L.Dense(3)), [_rng(8).randn(4, 7, 5)], 1e-3))
       for m in ("concat", "sum")},
    "sequence_labeling_head": lambda: (_seq(
        L.Input(shape=(7, 5)), L.LSTM(6, return_sequences=True),
        L.Dense(3, activation="softmax")), [_rng(15).randn(4, 7, 5)], 1e-4),
    "crop_pad_1d": lambda: (_seq(
        L.Input(shape=(12, 5)), L.ZeroPadding1D(2),
        L.Conv1D(6, 3, activation="relu"), L.Cropping1D((1, 2)),
        L.Flatten(), L.Dense(3)), [_rng(17).randn(4, 12, 5)], 1e-4),
    "flatten_after_conv1d": lambda: (_seq(
        L.Input(shape=(12, 5)),
        L.Conv1D(8, 3, padding="same", activation="relu"),
        L.MaxPooling1D(2), L.Flatten(), L.Dense(3)),
        [_rng(9).randn(4, 12, 5)], 1e-4),
    "flatten_after_td_dense": lambda: (_seq(
        L.Input(shape=(7, 5)), L.TimeDistributed(L.Dense(12)), L.Flatten(),
        L.Dense(3)), [_rng(11).randn(4, 7, 5)], 1e-4),
    "embedding_flatten_dense": lambda: (_seq(
        L.Input(shape=(10,)), L.Embedding(50, 8), L.Flatten(), L.Dense(3)),
        [_rng(12).randint(0, 50, (4, 10)).astype(np.float32)], 1e-4),
    "layernorm_positive_axis": lambda: (_seq(
        L.Input(shape=(6, 8)), L.LayerNormalization(axis=2),
        L.LSTM(4, return_sequences=True)), [_rng(13).randn(3, 6, 8)], 1e-4),
    "mobilenet_style": _mobilenet_style,
    # test_keras_breadth2.py
    "softmax_layer": lambda: (_seq(
        L.Input(shape=(6,)), L.Dense(4), L.Softmax()), [_rng(0).randn(5, 6)],
        1e-4),
    "softmax_on_sequence": lambda: (_seq(
        L.Input(shape=(5, 3)), L.SimpleRNN(4, return_sequences=True),
        L.Softmax()), [_rng(14).randn(2, 5, 3)], 3e-4),
    "softmax_on_conv_map": lambda: (_seq(
        L.Input(shape=(4, 4, 3)), L.Conv2D(5, 2), L.Softmax()),
        [_rng(15).randn(2, 4, 4, 3)], 3e-4),
    "prelu_dense": lambda: (_prelu(_seq(
        L.Input(shape=(5,)), L.Dense(7), L.PReLU()), (7,), 2),
        [_rng(2).randn(4, 5)], 1e-4),
    "prelu_conv_shared_axes": lambda: (_prelu(_seq(
        L.Input(shape=(6, 6, 3)), L.Conv2D(4, 3), L.PReLU(shared_axes=[1, 2])),
        (1, 1, 4), 3), [_rng(3).randn(2, 6, 6, 3)], 1e-4),
    "repeat_vector_lstm": lambda: (_seq(
        L.Input(shape=(5,)), L.Dense(4), L.RepeatVector(6),
        L.LSTM(3, return_sequences=True)), [_rng(4).randn(2, 5)], 1e-4),
    "upsampling1d": lambda: (_seq(
        L.Input(shape=(5, 3)), L.Conv1D(4, 2), L.UpSampling1D(size=3)),
        [_rng(5).randn(2, 5, 3)], 1e-4),
    "minimum_merge": _minimum,
    "zeropad3d_conv3d_crop3d": lambda: (_seq(
        L.Input(shape=(4, 5, 5, 2)), L.ZeroPadding3D(padding=(1, 1, 1)),
        L.Conv3D(3, 2), L.Cropping3D(cropping=((1, 0), (0, 1), (1, 1)))),
        [_rng(7).randn(2, 4, 5, 5, 2)], 1e-4),
    "upsampling3d": lambda: (_seq(
        L.Input(shape=(3, 3, 3, 2)), L.Conv3D(2, 2),
        L.UpSampling3D(size=(2, 1, 2))), [_rng(8).randn(2, 3, 3, 3, 2)], 1e-4),
    "functional_conv3d_prelu": _functional_prelu3d,
    "conv3d_transpose": lambda: (_seq(
        L.Input(shape=(3, 4, 4, 2)),
        L.Conv3DTranspose(3, 2, strides=(2, 2, 2))),
        [_rng(9).randn(2, 3, 4, 4, 2)], 1e-4),
    "masking_lstm_last_step": lambda: (_seq(
        L.Input(shape=(6, 4)), L.Masking(mask_value=0.0), L.LSTM(5)),
        [_masked(_rng(10).randn(3, 6, 4), [(0, 4), (1, 5)])], 3e-4),
    "masking_nonzero_value": lambda: (_seq(
        L.Input(shape=(4, 3)), L.Masking(mask_value=7.0), L.LSTM(4)),
        [_sevens(_rng(13).randn(2, 4, 3))], 3e-4),
    "flatten_relu_dense": lambda: (_seq(
        L.Input(shape=(4, 4, 3)), L.Conv2D(5, 2), L.Flatten(), L.ReLU(),
        L.Dense(3)), [_rng(17).randn(2, 4, 4, 3)], 3e-4),
    # test_keras_v3_format.py
    "v3_conv_flatten_dense": lambda: (_seq(
        L.Input(shape=(8, 8, 3)), L.Conv2D(4, 3, activation="relu"),
        L.Flatten(), L.Dense(10, activation="relu"), L.Dense(2)),
        [_rng(1).randn(2, 8, 8, 3)], 1e-4),
    "v3_lstm_gru_stack": lambda: (_seq(
        L.Input(shape=(6, 4)), L.LSTM(5, return_sequences=True), L.GRU(3)),
        [_rng(2).randn(3, 6, 4)], 3e-4),
    "v3_bidirectional_sequences": lambda: (_seq(
        L.Input(shape=(5, 3)),
        L.Bidirectional(L.LSTM(4, return_sequences=True))),
        [_rng(3).randn(2, 5, 3)], 3e-4),
    "v3_functional_transformer": _v3_transformer,
    "v3_batchnorm_running_stats": _bn_trained,
    # test_imports.py
    "dense_mlp": lambda: (_seq(
        L.Input(shape=(10,)), L.Dense(16, activation="relu"),
        L.Dense(8, activation="tanh"), L.Dense(3, activation="softmax")),
        [_rng(0).randn(6, 10)], 1e-4),
    "cnn_flatten_dense": lambda: (_seq(
        L.Input(shape=(12, 12, 1)), L.Conv2D(4, 3, activation="relu"),
        L.MaxPooling2D(2), L.Flatten(), L.Dense(10, activation="softmax")),
        [_rng(1).randn(3, 12, 12, 1)], 1e-4),
    "conv_same_padding_bn": lambda: (_bn_set(_seq(
        L.Input(shape=(8, 8, 3)), L.Conv2D(6, 3, padding="same"),
        L.BatchNormalization(), L.Activation("relu"), L.AveragePooling2D(2),
        L.Flatten(), L.Dense(4, activation="softmax")), 1, _rng(2)),
        [_rng(6).randn(2, 8, 8, 3)], 1e-3),
    "bn_scale_false": lambda: (_bn_scale_false(), [_rng(3).randn(4, 6)],
                               1e-3),
    "activation_layer_classes": lambda: (_seq(
        L.Input(shape=(6,)), L.Dense(8), L.LeakyReLU(negative_slope=0.2),
        L.Dense(5), L.ELU(), L.Dense(4), L.ReLU(),
        L.Dense(3, activation="softmax")), [_rng(5).randn(4, 6)], 1e-4),
    "spatial_dropout": lambda: (_seq(
        L.Input(shape=(8, 8, 3)), L.Conv2D(4, 3, padding="same"),
        L.SpatialDropout2D(0.4), L.Flatten(),
        L.Dense(2, activation="softmax")), [_rng(6).rand(2, 8, 8, 3)], 1e-4),
    "conv1d_stack": lambda: (_seq(
        L.Input(shape=(12, 5)),
        L.Conv1D(8, 3, padding="same", activation="relu"),
        L.MaxPooling1D(2), L.Conv1D(6, 3, padding="same"),
        L.GlobalAveragePooling1D(), L.Dense(3, activation="softmax")),
        [_rng(9).randn(4, 12, 5)], 1e-4),
    **{f"bidirectional_lstm_{m}": (
        lambda m=m: (_seq(
            L.Input(shape=(7, 5)),
            L.Bidirectional(L.LSTM(6, return_sequences=True), merge_mode=m)),
            [_rng(11).randn(4, 7, 5)], 1e-4))
       for m in ("concat", "sum")},
    "activation_params": lambda: (_seq(
        L.Input(shape=(6,)), L.Dense(8), L.ELU(alpha=0.4), L.Dense(5),
        L.ReLU(negative_slope=0.2), L.Dense(3)), [_rng(7).randn(4, 6)], 1e-4),
    "lstm_last_step": lambda: (_seq(
        L.Input(shape=(5, 8)), L.LSTM(7), L.Dense(3, activation="softmax")),
        [_rng(4).randn(2, 5, 8)], 1e-3),
    "pool_same": lambda: (_seq(
        L.Input(shape=(7, 7, 2)), L.MaxPooling2D(2, padding="same"),
        L.Flatten(), L.Dense(3, activation="softmax")),
        [_rng(5).randn(2, 7, 7, 2)], 1e-4),
    "pool_unequal_stride": lambda: (_seq(
        L.Input(shape=(12, 12, 1)), L.MaxPooling2D(pool_size=3, strides=2),
        L.Flatten(), L.Dense(3, activation="softmax")),
        [_rng(6).randn(2, 12, 12, 1)], 1e-4),
    "dilated_conv": lambda: (_seq(
        L.Input(shape=(10, 10, 1)),
        L.Conv2D(3, 3, dilation_rate=2, activation="relu"), L.Flatten(),
        L.Dense(2, activation="softmax")), [_rng(7).randn(2, 10, 10, 1)],
        1e-4),
    "functional_linear_chain": _functional_chain,
    "separable_depthwise": lambda: (_seq(
        L.Input(shape=(10, 10, 3)),
        L.SeparableConv2D(8, 3, padding="same", activation="relu"),
        L.DepthwiseConv2D(3, depth_multiplier=2), L.GlobalAveragePooling2D(),
        L.Dense(4, activation="softmax")), [_rng(0).randn(2, 10, 10, 3)],
        1e-3),
    "conv_transpose_up_pad_crop": lambda: (_seq(
        L.Input(shape=(6, 6, 2)), L.Conv2DTranspose(4, 2, strides=2),
        L.UpSampling2D(2), L.ZeroPadding2D(1), L.Cropping2D(2),
        L.GlobalMaxPooling2D(), L.Dense(3, activation="softmax")),
        [_rng(1).randn(2, 6, 6, 2)], 1e-3),
    "simplernn_gru": lambda: (_seq(
        L.Input(shape=(7, 5)), L.SimpleRNN(6, return_sequences=True),
        L.GRU(4, reset_after=False), L.Dense(3, activation="softmax")),
        [_rng(2).randn(2, 7, 5)], 1e-4),
    "gru_reset_after": lambda: (_seq(
        L.Input(shape=(5, 4)), L.GRU(3, reset_after=True),
        L.Dense(2, activation="softmax")), [_rng(3).randn(2, 5, 4)], 1e-4),
    "residual_dense": _residual_dense,
    "concat_dense": _concat_dense,
    "conv_residual_flatten": _conv_residual_flatten,
    "multi_input_average": _multi_input,
}


def _sevens(x):
    x[0, 3] = 7.0
    x[1, 1] = 7.0
    return x


def _bn_scale_false():
    m = _seq(L.Input(shape=(6,)), L.BatchNormalization(scale=False),
             L.Dense(3, activation="softmax"))
    m.layers[0].set_weights([_rng(0).randn(6), _rng(1).randn(6),
                             _rng(2).rand(6) + .5])
    return m


#: the reference tests' models saved by the legacy keras 2 (``tf_keras``):
#: classes keras 3 dropped, written in keras 2's h5 layout (fixed-length
#: name strings, ``model_config`` as bytes)
LEGACY = {
    **{f"thresholded_relu_{theta}": (
        lambda tfk, theta=theta: (tfk.Sequential([
            tfk.layers.Input(shape=(8,)), tfk.layers.Dense(6),
            tfk.layers.ThresholdedReLU(theta=theta)]),
            [_rng(1).randn(4, 8)], 1e-4))
       for theta in (1.0, 0.6)},
    "locally_connected_2d": lambda tfk: (tfk.Sequential([
        tfk.layers.Input(shape=(6, 6, 3)),
        tfk.layers.LocallyConnected2D(4, (2, 2), strides=(2, 2),
                                      activation="relu"),
        tfk.layers.Flatten(), tfk.layers.Dense(3)]),
        [_rng(20).randn(2, 6, 6, 3)], 3e-4),
    "locally_connected_1d": lambda tfk: (tfk.Sequential([
        tfk.layers.Input(shape=(7, 3)),
        tfk.layers.LocallyConnected1D(4, 2, activation="tanh")]),
        [_rng(21).randn(2, 7, 3)], 3e-4),
}
#: the keras-3 models the reference's tests save as ``.keras`` (the
#: ``v3_`` ones only so)
V3 = [n for n in MODELS if n.startswith("v3_")] + [
    "transformer_encoder_block", "conv_same_padding_bn",
    "multi_input_average"]
H5 = [n for n in MODELS if not n.startswith("v3_")]


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """name, ext -> (keras model, keras-layout inputs, atol, path), each
    model built and saved once."""
    cache = {}
    root = tmp_path_factory.mktemp("keras")

    def get(name, ext):
        if name not in cache:
            if name in LEGACY:
                model, xs, atol = LEGACY[name](
                    pytest.importorskip("tf_keras"))
            else:
                model, xs, atol = MODELS[name]()
            cache[name] = (model, [np.asarray(x, np.float32) for x in xs],
                           atol, {})
        model, xs, atol, paths = cache[name]
        if ext not in paths:
            paths[ext] = str(root / f"{name}{ext}")
            model.save(paths[ext])
        return model, xs, atol, paths[ext]
    return get


def _keras_outputs(model, xs):
    out = model(xs if len(xs) > 1 else xs[0])
    return [np.asarray(o) for o in (out if isinstance(out, (list, tuple))
                                    else [out])]


def _check(saved, name, ext):
    model, xs, atol, path = saved(name, ext)
    net = KerasModelImport.importKerasModelAndWeights(path, device="cpu")
    jnet = JImport.importKerasModelAndWeights(path)
    assert type(net).__name__ == type(jnet).__name__
    ours, ref = _outputs(net, xs), _outputs(jnet, xs)
    want = _keras_outputs(model, xs)
    assert len(ours) == len(ref) == len(want)
    for o, r, w in zip(ours, ref, want):
        assert o.shape == r.shape == w.shape
        np.testing.assert_allclose(o, w, atol=atol, rtol=1e-3)
        np.testing.assert_allclose(o, r, **REF_TOL)
    return net, jnet


@pytest.mark.parametrize("name", H5 + list(LEGACY))
def test_h5_import_matches_keras_and_the_reference(saved, name):
    _check(saved, name, ".h5")


@pytest.mark.parametrize("name", V3)
def test_keras_archive_import_matches_keras_and_the_reference(saved, name):
    _check(saved, name, ".keras")


def test_imported_attention_weights_land_in_keras_layout(saved):
    """``KerasMultiHeadAttention`` takes keras's 3-D kernels as they are:
    (nIn, h, keyDim) for q, k, v and (h, valueDim, nOut) for the output."""
    model, _xs, _atol, path = saved("transformer_encoder_block", ".h5")
    net = KerasModelImport.importKerasModelAndWeights(path, device="cpu")
    want = model.get_layer("mha").get_weights()
    got = net.params_["mha"]
    for key, w in zip(("Wq", "bq", "Wk", "bk", "Wv", "bv", "Wo", "bo"), want):
        assert tuple(got[key].shape) == w.shape
        np.testing.assert_array_equal(got[key].numpy(), w)


def test_multi_head_output_model_imports_as_a_graph(saved):
    net, _ = _check(saved, "multi_head_output", ".h5")
    assert isinstance(net, ComputationGraph)
    assert net.conf.outputs == ["head_a", "head_b"]


def _compiled(optimizer, loss="mse", units=2, act=None):
    m = _seq(L.Input(shape=(4,)), L.Dense(units, activation=act))
    if optimizer is not None:
        m.compile(optimizer=optimizer, loss=loss)
    return m


@pytest.mark.parametrize("ext", [".h5", ".keras"])
def test_training_config_maps_the_updater(tmp_path, ext):
    """keras's compile state (``training_config`` in an h5,
    ``compile_config`` in a ``.keras``) becomes the global updater, with
    fresh optimizer state for it, in both packages; fit then works."""
    from deeplearning4j_tpu_torch.datasets import DataSet
    cases = [(keras.optimizers.Adam(learning_rate=3e-3), "Adam",
              {"learningRate": 3e-3}),
             (keras.optimizers.SGD(learning_rate=0.05, momentum=0.9,
                                   nesterov=True), "Nesterovs",
              {"learningRate": 0.05, "momentum": 0.9})]
    for i, (opt, cls, fields) in enumerate(cases):
        p = str(tmp_path / f"m{i}{ext}")
        _compiled(opt, "categorical_crossentropy", act="softmax").save(p)
        net = KerasModelImport.importKerasModelAndWeights(p, device="cpu")
        jnet = JImport.importKerasModelAndWeights(p)
        up, jup = net.conf.globalConf["updater"], \
            jnet.conf.globalConf["updater"]
        assert type(up).__name__ == type(jup).__name__ == cls
        for k, v in fields.items():
            assert getattr(up, k) == pytest.approx(v, rel=1e-6)
            assert getattr(up, k) == pytest.approx(getattr(jup, k))
        rng = _rng(20)
        net.fit(DataSet(rng.randn(8, 4).astype(np.float32),
                        np.eye(2, dtype=np.float32)[rng.randint(0, 2, 8)]))
        assert np.isfinite(net.score())


@pytest.mark.parametrize("ext,word", [(".h5", "training_config"),
                                      (".keras", "compile_config")])
def test_uncompiled_model_refuses_under_enforce(tmp_path, ext, word):
    p = str(tmp_path / f"m{ext}")
    _compiled(None).save(p)
    up = KerasModelImport.importKerasSequentialModelAndWeights(
        p, device="cpu").conf.globalConf.get("updater")
    jup = JImport.importKerasSequentialModelAndWeights(
        p).conf.globalConf.get("updater")
    assert up.toJson() == jup.toJson()          # the builder's default
    for imp, kw in ((KerasModelImport, {"device": "cpu"}), (JImport, {})):
        with pytest.raises(ValueError, match=word):
            imp.importKerasSequentialModelAndWeights(
                p, enforceTrainingConfig=True, **kw)


def _cross_attention():
    inp = keras.Input(shape=(6, 8))
    att = L.MultiHeadAttention(num_heads=2, key_dim=4)(inp, L.Dense(8)(inp))
    return keras.Model(inp, att)


REFUSALS = {
    "cross_attention": (_cross_attention, ".h5", "cross-attention"),
    "flatten_prelu": (lambda: _seq(
        L.Input(shape=(4, 4, 3)), L.Conv2D(5, 2), L.Flatten(), L.PReLU(),
        L.Dense(3)), ".h5", "Flatten"),
    "flatten_softmax": (lambda: _seq(
        L.Input(shape=(4, 4, 3)), L.Conv2D(5, 2), L.Flatten(), L.Softmax(),
        L.Dense(3)), ".h5", "Flatten"),
    "normalization_invert": (lambda: _seq(
        L.Input(shape=(3,)), L.Normalization(
            axis=-1, mean=[0.0, 0.0, 0.0], variance=[1.0, 1.0, 1.0],
            invert=True)), ".keras", "invert"),
    "normalization_axis": (lambda: _seq(
        L.Input(shape=(8, 8, 3)), L.Normalization(
            axis=1, mean=np.zeros((8, 1, 1)), variance=np.ones((8, 1, 1)))),
        ".keras", "axis"),
    "unregistered_lambda": (lambda: _seq(
        L.Input(shape=(6,)), L.Dense(5, activation="relu"),
        L.Lambda(lambda t: t * 2.0, name="double_it"), L.Dense(3)), ".h5",
        "double_it"),
}


@pytest.mark.parametrize("name", list(REFUSALS))
def test_refusals_are_the_references(tmp_path, name):
    build, ext, word = REFUSALS[name]
    p = str(tmp_path / f"m{ext}")
    build().save(p)
    for imp, kw in ((KerasModelImport, {"device": "cpu"}), (JImport, {})):
        with pytest.raises(ValueError, match=word):
            imp.importKerasModelAndWeights(p, **kw)


def test_lambda_and_custom_layer_registries(tmp_path, monkeypatch):
    """``registerLambdaLayer`` substitutes any port layer for a Lambda by
    its name; ``registerCustomLayer`` maps a custom class to one."""
    import deeplearning4j_tpu_torch.imports.keras_import as ki
    from deeplearning4j_tpu_torch.nn.conf.layers import ActivationLayer
    from deeplearning4j_tpu_torch.nn.conf.misc import RescaleLayer
    monkeypatch.setattr(ki, "_LAMBDA_LAYERS", {})
    monkeypatch.setattr(ki, "_CUSTOM_LAYERS", {})

    class Clipper(L.Layer):
        def call(self, t):
            return keras.ops.clip(t, -1.0, 1.0)

    x = _rng(0).randn(4, 6).astype(np.float32)
    for i, (layer, register) in enumerate([
            (L.Lambda(lambda t: t * 2.0, name="double_it"),
             lambda: KerasModelImport.registerLambdaLayer(
                 "double_it", RescaleLayer(scale=2.0))),
            (Clipper(), lambda: KerasModelImport.registerCustomLayer(
                "Clipper", lambda cfg: ActivationLayer(
                    activation="hardtanh")))]):
        model = _seq(L.Input(shape=(6,)), L.Dense(5, activation="tanh"),
                     L.Dense(5), layer, L.Dense(3, activation="softmax"))
        p = str(tmp_path / f"m{i}.h5")
        model.save(p)
        register()
        net = KerasModelImport.importKerasModelAndWeights(p, device="cpu")
        np.testing.assert_allclose(net.output(x).numpy(),
                                   np.asarray(model(x)), atol=1e-5)


def test_sequence_labeling_head_fits_as_the_reference(saved):
    """A final per-step softmax Dense becomes ``RnnOutputLayer``: the
    imported net fits, its first Adam step equal to the reference's, and
    its score falls."""
    from deeplearning4j_tpu.datasets import DataSet as JDataSet
    from deeplearning4j_tpu.learning import Adam as JAdam
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.learning import Adam
    _model, xs, _atol, path = saved("sequence_labeling_head", ".h5")
    net = KerasModelImport.importKerasModelAndWeights(path, device="cpu")
    jnet = JImport.importKerasModelAndWeights(path)
    rng = _rng(16)
    y = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (4, 7))] \
        .transpose(0, 2, 1).copy()
    f = np.ascontiguousarray(_to_ours(xs[0]))
    net.conf.globalConf["updater"] = Adam(1e-2)
    jnet.conf.globalConf["updater"] = JAdam(1e-2)
    net._initOptState()
    jnet._initOptState()
    net.fit(DataSet(f, y))
    jnet.fit(JDataSet(f, y))
    assert net.score() == pytest.approx(jnet.score(), rel=1e-5)
    for k, lp in net.params_.items():
        for n, v in lp.items():
            np.testing.assert_allclose(v.numpy(), np.asarray(
                jnet.params_[k][n]), atol=1e-6, err_msg=f"{k}/{n}")
    s0 = net.score(DataSet(f, y))
    for _ in range(10):
        net.fit(DataSet(f, y))
    assert net.score(DataSet(f, y)) < s0


def test_mobilenet_style_import_fine_tunes(saved):
    from deeplearning4j_tpu_torch.datasets import DataSet
    from deeplearning4j_tpu_torch.learning import Adam
    _model, _xs, _atol, path = saved("mobilenet_style", ".h5")
    net = KerasModelImport.importKerasModelAndWeights(path, device="cpu")
    rng = _rng(22)
    ds = DataSet(rng.randn(8, 3, 32, 32).astype(np.float32),
                 np.eye(5, dtype=np.float32)[rng.randint(0, 5, 8)])
    net.conf.globalConf["updater"] = Adam(1e-3)
    net._initOptState()
    net.fit(ds)
    s0 = net.score(ds)
    for _ in range(20):
        net.fit(ds)
    assert net.score(ds) < s0


def test_imported_net_survives_the_serializer(saved, tmp_path):
    from deeplearning4j_tpu_torch.utils import ModelSerializer
    _model, xs, _atol, path = saved("layernorm_dense_stack", ".h5")
    net = KerasModelImport.importKerasModelAndWeights(path, device="cpu")
    zp = str(tmp_path / "net.zip")
    ModelSerializer.writeModel(net, zp, saveUpdater=False)
    back = ModelSerializer.restoreMultiLayerNetwork(zp, device="cpu")
    assert torch.equal(back.output(xs[0]).torch, net.output(xs[0]).torch)


def test_c8_keras2_hard_sigmoid_imports_with_keras3_semantics(tmp_path):
    """ROADMAP C8, a reference fault the port keeps: ``_KERAS2_SEMANTICS``
    is never set, so a keras-2 file's ``hard_sigmoid`` (clip(0.2x + 0.5))
    imports as keras 3's relu6(x + 3) / 6 in both packages."""
    tfk = pytest.importorskip("tf_keras")
    model = tfk.Sequential([tfk.layers.Input(shape=(4,)),
                            tfk.layers.Dense(6),
                            tfk.layers.Activation("hard_sigmoid")])
    model.layers[0].set_weights([_rng(1).randn(4, 6).astype(np.float32) * 3,
                                 np.zeros(6, np.float32)])
    p = str(tmp_path / "k2.h5")
    model.save(p)
    x = _rng(2).randn(16, 4).astype(np.float32)
    ours = KerasModelImport.importKerasModelAndWeights(
        p, device="cpu").output(x).numpy()
    ref = np.asarray(JImport.importKerasModelAndWeights(p).output(x).numpy())
    z = x @ model.layers[0].get_weights()[0]
    np.testing.assert_allclose(ours, ref, atol=1e-6)
    np.testing.assert_allclose(ours, np.clip(z + 3.0, 0.0, 6.0) / 6.0,
                               atol=1e-6)
    keras2 = model.predict(x, verbose=0)
    np.testing.assert_allclose(keras2, np.clip(0.2 * z + 0.5, 0, 1),
                               atol=1e-6)
    assert np.abs(ours - keras2).max() > 0.03


APPLICATIONS = {
    "MobileNetV2": dict(),
    "EfficientNetB0": dict(),
    "MobileNetV3Small": dict(include_preprocessing=False),
}


@pytest.mark.parametrize("name", list(APPLICATIONS))
def test_keras_applications_import(tmp_path, name):
    """keras.applications at 64 x 64, 10 classes, saved as ``.keras``,
    against keras's forward.  At keras's initial weights every
    BatchNormalization is the identity and the activations fade to ~1e-9
    (the output is 0.1 everywhere), so the BatchNormalization statistics
    and scales are refilled first by ``chip_smoke._keras_refill``
    (gamma 1 + 0.1·N, beta and mean 0.1·N, variance U(0.5, 1.5)).  The
    reference's import of these graphs (10-15 s each here) is held in
    ``test_keras_applications.py``; the port's graph builder is the same
    code, held to it on every model above."""
    from chip_smoke import _keras_refill
    model = getattr(keras.applications, name)(
        weights=None, input_shape=(64, 64, 3), classes=10,
        **APPLICATIONS[name])
    rng = _rng(3)
    for w in model.weights:
        leaf = w.path.rsplit("/", 1)[-1]
        if leaf in ("gamma", "beta", "moving_mean", "moving_variance"):
            w.assign(_keras_refill(w.path, tuple(w.shape), rng))
    p = str(tmp_path / f"{name}.keras")
    model.save(p)
    net = KerasModelImport.importKerasModelAndWeights(p, device="cpu")
    x = _rng(0).randn(2, 64, 64, 3).astype(np.float32)
    want = np.asarray(model(x))
    assert want.std() > 1e-3          # not the uniform 0.1 of dead nets
    np.testing.assert_allclose(net.output(_to_ours(x)).numpy(), want,
                               atol=5e-4, rtol=1e-3)


def test_normalization_constructor_stats(tmp_path):
    m = _seq(L.Input(shape=(3,)), L.Normalization(
        axis=-1, mean=[1.0, 2.0, 3.0], variance=[4.0, 4.0, 4.0]),
        L.Dense(2))
    p = str(tmp_path / "m.keras")
    m.save(p)
    x = _rng(1).randn(4, 3).astype(np.float32)
    ours = KerasModelImport.importKerasModelAndWeights(
        p, device="cpu").output(x).numpy()
    np.testing.assert_allclose(ours, np.asarray(m(x)), atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(ours, np.asarray(
        JImport.importKerasModelAndWeights(p).output(x).numpy()), **REF_TOL)


# ---------------------------------------------------------------------------
# the committed fixtures (tests/fixtures/make_keras_fixtures.py)
# ---------------------------------------------------------------------------

def _fixture(key):
    from chip_smoke import KERAS
    return os.path.join(FIXTURES, KERAS[key])


def test_long_context_transformer_fixture_matches_keras():
    """The t-2048 Keras transformer: a graph of two KerasMultiHeadAttention
    blocks whose output on the first seeded input (batch 1 here, dense
    attention on the CPU) is keras's committed output."""
    from chip_smoke import KERAS as c
    net = KerasModelImport.importKerasModelAndWeights(
        _fixture("transformer"), device="cpu")
    assert isinstance(net, ComputationGraph)
    assert net.numParams() == 266_250
    kinds = [type(n[0]).__name__ for n in net.conf.nodes.values()]
    assert kinds.count("KerasMultiHeadAttention") == c["blocks"]
    io = np.load(_fixture("io"))
    x = np.random.RandomState(c["transformer_input_seed"]).standard_normal(
        (c["batch"], c["t"], c["d"])).astype(np.float32)[:1]
    xin = torch.from_numpy(np.ascontiguousarray(_to_ours(x)))
    with torch.no_grad():
        acts, _, _ = net._forward(net.params_, net.state_, (xin,), False,
                                  None)
    np.testing.assert_allclose(acts["pool"].numpy(),
                               io["transformer_pool"][:1], atol=2e-5,
                               rtol=1e-4)
    np.testing.assert_allclose(net.output(xin).numpy(),
                               io["transformer_probs"][:1], atol=2e-6)


def test_narrow_keras_archive_fixture_matches_keras_and_the_reference():
    from chip_smoke import KERAS as c
    x = np.random.RandomState(c["v3_input_seed"]).standard_normal(
        c["v3_shape"]).astype(np.float32)
    want = np.load(_fixture("io"))["v3_probs"]
    net = KerasModelImport.importKerasModelAndWeights(_fixture("v3"),
                                                      device="cpu")
    ours = net.output(_to_ours(x)).numpy()
    ref = JImport.importKerasModelAndWeights(_fixture("v3")).output(
        _to_ours(x)).numpy()
    np.testing.assert_allclose(ours, want, atol=2e-6)
    np.testing.assert_allclose(ours, np.asarray(ref), **REF_TOL)
    assert type(net.conf.globalConf["updater"]).__name__ == "Adam"


def test_resnet50_skeleton_imports_at_full_width():
    """Keras's ResNet-50, weight-stripped: the port's reader decodes it,
    every dataset unallocated; the refill of ``chip_smoke`` and the
    importer's ``_build_net`` give a graph of keras's 25,636,712 numbers
    (parameters and BatchNormalization statistics), each refilled value
    in place.  No forward: that is the card's (``chip_smoke``'s
    ``keras_resnet50`` phase, against keras's committed outputs)."""
    import chip_smoke
    f, filled, net = chip_smoke._keras_resnet_import(device="cpu")
    assert len(filled) == 320
    params = sum(v.numel() for lp in net.params_.values()
                 for v in lp.values())
    state = sum(v.numel() for st in net.state_.values()
                for v in st.values())
    assert params + state == chip_smoke.KERAS["resnet_params"]
    key = next(k for k in filled if k.endswith("conv1_conv/kernel"))
    w = filled[key]
    np.testing.assert_array_equal(net.params_["conv1_conv"]["W"].numpy(),
                                  w.transpose(3, 2, 0, 1))
    key = next(k for k in filled if k.endswith("conv1_bn/moving_variance"))
    np.testing.assert_array_equal(net.state_["conv1_bn"]["var"].numpy(),
                                  filled[key])


def test_chunked_weight_names_fall_back_to_the_visit_order(tmp_path):
    """keras splits a name list longer than 64,512 bytes into
    ``weight_names0``, ``weight_names1``, ...; neither importer reads the
    chunks: ``_WeightStore.get`` finds no ``weight_names`` and collects the
    group's datasets in visit order (names ascending), in both packages."""
    import h5py
    from deeplearning4j_tpu.imports.keras_import import \
        _WeightStore as JStore
    from deeplearning4j_tpu_torch.imports import hdf5
    from deeplearning4j_tpu_torch.imports.keras_import import _WeightStore
    p = str(tmp_path / "chunked.h5")
    rng = _rng(0)
    with h5py.File(p, "w") as f:
        g = f.create_group("model_weights/dense")
        g.create_dataset("dense/kernel", data=rng.randn(3, 2))
        g.create_dataset("dense/bias", data=rng.randn(2))
        g.attrs["weight_names0"] = np.array([b"dense/kernel"])
        g.attrs["weight_names1"] = np.array([b"dense/bias"])
    with h5py.File(p, "r") as jf:
        ref = JStore(jf).get("dense")
    got = _WeightStore(hdf5.File(p)).get("dense")
    assert [w.shape for w in got] == [w.shape for w in ref] == [(2,), (3, 2)]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a, b)
