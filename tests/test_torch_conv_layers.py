"""Port parity: the rest of ``nn/conf/layers.py`` (ELU, leaky ReLU,
dropout, the embeddings, LRN), all of ``nn/conf/convolutional.py`` and all
of ``nn/conf/convolutional3d.py`` against the JAX package.

Each layer runs its forward in both packages on the same seeded numpy
parameters and input, then the gradients of sum(output · R) with respect
to every parameter and the input (``jax.grad`` against autograd); a loss
layer's per-example score and its gradient with respect to the output.
Both compute in float32 and differ by summation order only, so values and
gradients hold to 1e-5 (absolute and relative) unless a case says
otherwise.  Every layer's reference JSON loads in the port and is given
back byte for byte.
"""
import jax
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from deeplearning4j_tpu.nn.conf import convolutional as jconv
from deeplearning4j_tpu.nn.conf import convolutional3d as j3d
from deeplearning4j_tpu.nn.conf import layers as jlayers
from deeplearning4j_tpu_torch.nn.conf import convolutional as tconv
from deeplearning4j_tpu_torch.nn.conf import convolutional3d as t3d
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers

from _torch_parity import _json_round_trip, _layer_parity, _loss_parity

pytestmark = pytest.mark.torch_port


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _pair(name, mod_j, mod_t, **kw):
    return getattr(mod_j, name)(**kw), getattr(mod_t, name)(**kw)


# ---------------------------------------------------------------------------
# the rest of layers.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,alpha", [("ELULayer", 1.0), ("ELULayer", 0.3),
                                        ("LeakyReLULayer", 0.3),
                                        ("LeakyReLULayer", 0.01)])
def test_parameterised_activations(name, alpha):
    rng = np.random.RandomState(1)
    jl, tl = _pair(name, jlayers, tlayers, alpha=alpha)
    _layer_parity(jl, tl, {}, _rand(rng, 3, 4, 5))


def test_dropout_layer_is_identity_at_inference_and_keeps_moments():
    """Its bits come from the port's generator, so it is held at inference
    (identity) and by its moments: a kept fraction of 0.5 ± 0.01 over 2e5
    draws, each kept value scaled by 1/0.5."""
    jl, tl = _pair("DropoutLayer", jlayers, tlayers)
    assert jl.dropOut == tl.dropOut == 0.5
    rng = np.random.RandomState(2)
    _layer_parity(jl, tl, {}, _rand(rng, 4, 6))
    x = torch.ones(200_000)
    gen = torch.Generator().manual_seed(0)
    y, _ = tl.forward({}, x, True, gen, {})
    kept = (y != 0).float().mean().item()
    assert abs(kept - 0.5) < 0.01
    assert torch.all((y == 0) | (y == 2.0))


def test_embedding_layer_and_out_of_range_ids():
    """In-range ids (b,) and (b, 1) with gradients; then jnp.take's rules:
    [-n, 0) counts from the end, ids outside [-n, n) give a row of NaN."""
    rng = np.random.RandomState(3)
    W, b = _rand(rng, 7, 4), _rand(rng, 4)
    for hasBias in (False, True):
        kw = dict(nIn=7, nOut=4, hasBias=hasBias, activation="tanh")
        jl, tl = _pair("EmbeddingLayer", jlayers, tlayers, **kw)
        p = {"W": W, "b": b} if hasBias else {"W": W}
        _layer_parity(jl, tl, p, np.array([0, 3, 6, 3], np.float32))
        _layer_parity(jl, tl, p, np.array([[1], [5], [2]], np.int32))
    jl, tl = _pair("EmbeddingLayer", jlayers, tlayers, nIn=7, nOut=4)
    ids = np.array([-1, -7, -8, 7, 9, 2], np.int32)
    out, ref = _layer_parity(jl, tl, {"W": W}, ids, grad=False)
    assert np.isnan(ref[2:5]).all() and not np.isnan(ref[[0, 1, 5]]).any()


@pytest.mark.parametrize("shape", [(3, 5), (3, 1, 5)])
def test_embedding_sequence_layer(shape):
    rng = np.random.RandomState(4)
    kw = dict(nIn=9, nOut=3, inputLength=5, hasBias=True)
    jl, tl = _pair("EmbeddingSequenceLayer", jlayers, tlayers, **kw)
    ids = rng.randint(0, 9, shape).astype(np.int32)
    out, _ = _layer_parity(jl, tl, {"W": _rand(rng, 9, 3),
                                    "b": _rand(rng, 3)}, ids)
    assert tuple(out.shape) == (3, 3, 5)
    ids[0, ..., 1] = 11          # out of range: NaN in both
    _layer_parity(jl, tl, {"W": _rand(rng, 9, 3), "b": _rand(rng, 3)}, ids,
                  grad=False)


@pytest.mark.parametrize("n,c", [(5.0, 7), (3.0, 2), (4.0, 6)])
def test_local_response_normalization(n, c):
    """k + alpha·Σx² over int(n) channels, zero-padded by n // 2: not
    ``F.local_response_norm``, which divides alpha by n."""
    rng = np.random.RandomState(5)
    kw = dict(n=n, k=2.0, alpha=1e-2, beta=0.75)
    jl, tl = _pair("LocalResponseNormalization", jlayers, tlayers, **kw)
    x = _rand(rng, 2, c, 4, 3, scale=3.0)
    out, ref = _layer_parity(jl, tl, {}, x)
    if n % 2:
        lrn = F.local_response_norm(torch.from_numpy(x), int(n), alpha=1e-2,
                                    beta=0.75, k=2.0)
        assert not np.allclose(lrn.numpy(), ref, atol=1e-5)


# ---------------------------------------------------------------------------
# convolutional.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [2, (2, 3), (1, 2)])
def test_upsampling2d(size):
    rng = np.random.RandomState(6)
    jl, tl = _pair("Upsampling2D", jconv, tconv, size=size)
    _layer_parity(jl, tl, {}, _rand(rng, 2, 3, 3, 4))


def test_upsampling1d():
    rng = np.random.RandomState(7)
    jl, tl = _pair("Upsampling1D", jconv, tconv, size=3)
    _layer_parity(jl, tl, {}, _rand(rng, 2, 3, 5))


@pytest.mark.parametrize("padding", [(1, 2, 0, 3), (2, 1), 1])
def test_zero_padding(padding):
    rng = np.random.RandomState(8)
    jl, tl = _pair("ZeroPaddingLayer", jconv, tconv, padding=padding)
    _layer_parity(jl, tl, {}, _rand(rng, 2, 2, 4, 5))


@pytest.mark.parametrize("cropping", [(1, 0, 2, 1), (1, 2), (0, 0, 0, 0)])
def test_cropping2d(cropping):
    rng = np.random.RandomState(9)
    jl, tl = _pair("Cropping2D", jconv, tconv, cropping=cropping)
    _layer_parity(jl, tl, {}, _rand(rng, 2, 2, 6, 7))


DECONV_CASES = [  # (mode, kernel, stride, padding, in h, in w)
    ("Truncate", (2, 2), (2, 2), (0, 0), 4, 5),
    ("Truncate", (3, 3), (2, 2), (1, 1), 5, 4),
    ("Truncate", (4, 3), (3, 1), (1, 0), 3, 4),
    ("Same", (3, 3), (2, 2), (0, 0), 4, 5),
    ("Same", (4, 4), (2, 2), (0, 0), 3, 3),
    ("Same", (2, 3), (1, 2), (0, 0), 5, 4),
    ("Same", (5, 5), (3, 3), (0, 0), 2, 3),
]


@pytest.mark.parametrize("case", DECONV_CASES)
def test_deconvolution2d(case):
    """W (nOut, nIn, kh, kw), the flipped kernel over the input dilated by
    the stride, SAME's odd pad where the reference puts it."""
    mode, k, s, p, h, w = case
    rng = np.random.RandomState(10)
    kw = dict(nIn=3, nOut=4, kernelSize=k, stride=s, padding=p,
              convolutionMode=mode, activation="tanh")
    jl, tl = _pair("Deconvolution2D", jconv, tconv, **kw)
    params = {"W": _rand(rng, 4, 3, *k, scale=0.5), "b": _rand(rng, 4)}
    out, _ = _layer_parity(jl, tl, params, _rand(rng, 2, 3, h, w))
    from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
    it = tl.getOutputType(InputType.convolutional(h, w, 3))
    assert tuple(out.shape) == (2, 4, it.height, it.width)


@pytest.mark.parametrize("mode,k,s,dm,size", [
    ("Truncate", 3, 1, 1, 6), ("Truncate", 3, 2, 2, 7), ("Same", 3, 2, 1, 7),
    ("Same", 4, 1, 3, 5), ("Same", 5, 2, 2, 8)])
def test_depthwise_convolution2d(mode, k, s, dm, size):
    rng = np.random.RandomState(11)
    kw = dict(nIn=3, depthMultiplier=dm, kernelSize=(k, k), stride=(s, s),
              convolutionMode=mode, activation="relu")
    jl, tl = _pair("DepthwiseConvolution2D", jconv, tconv, **kw)
    jl.inferNIn(None), tl.inferNIn(None)
    params = {"W": _rand(rng, 3 * dm, 1, k, k), "b": _rand(rng, 3 * dm)}
    _layer_parity(jl, tl, params, _rand(rng, 2, 3, size, size + 1))


@pytest.mark.parametrize("mode,k,s,dm,size", [
    ("Truncate", 3, 1, 1, 6), ("Same", 3, 2, 2, 7), ("Same", 3, 1, 1, 5)])
def test_separable_convolution2d(mode, k, s, dm, size):
    rng = np.random.RandomState(12)
    kw = dict(nIn=3, nOut=5, depthMultiplier=dm, kernelSize=(k, k),
              stride=(s, s), convolutionMode=mode)
    jl, tl = _pair("SeparableConvolution2D", jconv, tconv, **kw)
    params = {"W": _rand(rng, 3 * dm, 1, k, k),
              "pW": _rand(rng, 5, 3 * dm, 1, 1), "b": _rand(rng, 5)}
    _layer_parity(jl, tl, params, _rand(rng, 2, 3, size, size))


@pytest.mark.parametrize("mode,k,s,d,p", [
    (None, 3, 1, 1, 0), ("Same", 4, 2, 1, 0), ("Same", 3, 1, 2, 0),
    ("Truncate", 3, 2, 1, 1), ("Truncate", 2, 1, 2, 0)])
def test_convolution1d(mode, k, s, d, p):
    """The default mode is Same; SAME pads as lax with the dilated
    kernel."""
    rng = np.random.RandomState(13)
    kw = dict(nIn=3, nOut=4, kernelSize=k, stride=s, dilation=d, padding=p,
              convolutionMode=mode, activation="tanh")
    jl, tl = _pair("Convolution1DLayer", jconv, tconv, **kw)
    params = {"W": _rand(rng, 4, 3, k), "b": _rand(rng, 4)}
    _layer_parity(jl, tl, params, _rand(rng, 2, 3, 9))


@pytest.mark.parametrize("pt", ["MAX", "AVG", "SUM", "max"])
@pytest.mark.parametrize("k,s,p", [(2, 2, 0), (3, 2, 1), (3, 1, 1)])
def test_subsampling1d(pt, k, s, p):
    rng = np.random.RandomState(14)
    kw = dict(poolingType=pt, kernelSize=k, stride=s, padding=p)
    jl, tl = _pair("Subsampling1DLayer", jconv, tconv, **kw)
    _layer_parity(jl, tl, {}, _rand(rng, 2, 3, 9))


@pytest.mark.parametrize("bs", [2, 3])
def test_space_to_depth_follows_the_reference_channel_order(bs):
    """Output channel (i·bs + j)·c + ch; ``F.pixel_unshuffle``'s order
    (ch·bs² + i·bs + j) fails this."""
    rng = np.random.RandomState(15)
    jl, tl = _pair("SpaceToDepthLayer", jconv, tconv, blockSize=bs)
    x = _rand(rng, 2, 3, 2 * bs, 3 * bs)
    out, ref = _layer_parity(jl, tl, {}, x)
    shuffled = F.pixel_unshuffle(torch.from_numpy(x), bs).numpy()
    assert shuffled.shape == ref.shape
    assert not np.allclose(shuffled, ref)


CNN_LOSS_CASES = [  # (loss, activation, mask kind)
    ("mcxent", "softmax", None), ("mcxent", "softmax", "b1hw"),
    ("xent", "sigmoid", None), ("xent", "sigmoid", "bchw"),
    ("mse", "identity", "bhw"), ("mse", "identity", None)]


@pytest.mark.parametrize("loss,act,mask_kind", CNN_LOSS_CASES)
def test_cnn_loss_layer(loss, act, mask_kind):
    """Per-pixel loss averaged over pixels; softmax runs over channels; a
    (b, 1|c, h, w) mask keeps a pixel where any channel is unmasked, a
    (b, h, w) mask is per pixel."""
    rng = np.random.RandomState(16)
    b, c, h, w = 2, 3, 4, 5
    jl, tl = _pair("CnnLossLayer", jconv, tconv, lossFunction=loss,
                   activation=act)
    x = _rand(rng, b, c, h, w)
    out, ref = _layer_parity(jl, tl, {}, x)
    if loss == "mcxent":
        labels = np.eye(c, dtype=np.float32)[rng.randint(0, c, (b, h, w))]
        labels = labels.transpose(0, 3, 1, 2).copy()
    else:
        labels = rng.rand(b, c, h, w).astype(np.float32)
    mask = {None: None,
            "b1hw": (rng.rand(b, 1, h, w) > 0.3).astype(np.float32),
            "bchw": (rng.rand(b, c, h, w) > 0.6).astype(np.float32),
            "bhw": (rng.rand(b, h, w) > 0.3).astype(np.float32)}[mask_kind]
    _loss_parity(jl, tl, labels, ref.copy(), mask)


def _yolo_labels(rng, b, nC, h, w, boxes):
    """DL4J's YOLO labels (b, 4 + nC, h, w): per (example, row, col) a box
    [x1, y1, x2, y2] in grid units and a one-hot class; zero elsewhere."""
    lab = np.zeros((b, 4 + nC, h, w), np.float32)
    for (e, i, j, bw, bh, cls) in boxes:
        cx, cy = j + 0.3, i + 0.6
        lab[e, 0:4, i, j] = (cx - bw / 2, cy - bh / 2, cx + bw / 2,
                             cy + bh / 2)
        lab[e, 4 + cls, i, j] = 1.0
    return lab


YOLO_ANCHORS = np.array([[1.0, 2.0], [2.0, 1.0], [1.5, 1.5]])


@pytest.mark.parametrize("boxes", [
    # (example, row, col, box w, box h, class)
    [(0, 1, 2, 1.4, 0.9, 0), (1, 0, 0, 0.7, 1.8, 2), (1, 2, 3, 2.5, 2.5, 1)],
    # a square box: anchors (1, 2) and (2, 1) tie on IOU with it; the
    # first wins in both packages
    [(0, 0, 1, 1.0, 1.0, 1), (0, 2, 2, 2.0, 2.0, 0), (1, 1, 1, 0.5, 0.5, 2)],
    # no object at all: only the no-object confidence term
    []])
def test_yolo2_output_layer_score_and_gradient(boxes):
    """Score and its gradient with respect to the network output, with
    empty cells, anchors tied on IOU and responsible anchors chosen by the
    first maximum."""
    rng = np.random.RandomState(17)
    b, nC, h, w = 2, 3, 3, 4
    nB = len(YOLO_ANCHORS)
    kw = dict(boundingBoxes=YOLO_ANCHORS, lambdaCoord=5.0, lambdaNoObj=0.5)
    jl, tl = _pair("Yolo2OutputLayer", jconv, tconv, **kw)
    out = _rand(rng, b, nB * (5 + nC), h, w)
    _layer_parity(jl, tl, {}, out)
    labels = _yolo_labels(rng, b, nC, h, w, boxes)
    got, ref = _loss_parity(jl, tl, labels, out)
    assert np.isfinite(ref).all() and (ref > 0).all()


def test_yolo2_output_layer_reads_the_references_string_form():
    """ROADMAP C16: the reference's JSON writes ``boundingBoxes`` as
    numpy's str; the port's layer parses that string back to the (B, 2)
    anchors and keeps the string, so its JSON is the reference's."""
    jl = jconv.Yolo2OutputLayer(boundingBoxes=np.asarray(
        ((0.57273, 0.677385), (1.87446, 2.06253), (3.33843, 5.47434))))
    layer, ref, back = _json_round_trip(jl)
    assert ref == back
    assert isinstance(layer.boundingBoxes, str)
    np.testing.assert_array_equal(layer.anchors(), jl.boundingBoxes)
    listed = tconv.Yolo2OutputLayer(boundingBoxes=[[1, 2], [3, 4]])
    np.testing.assert_array_equal(listed.anchors(), [[1.0, 2.0],
                                                     [3.0, 4.0]])


# ---------------------------------------------------------------------------
# convolutional3d.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode,k,s,d", [
    ("Truncate", (2, 2, 2), (1, 1, 1), (1, 1, 1)),
    ("Same", (3, 3, 3), (1, 2, 2), (1, 1, 1)),
    ("Same", (2, 3, 2), (2, 1, 2), (1, 1, 1)),
    ("Truncate", (2, 2, 2), (1, 1, 1), (2, 1, 1))])
def test_convolution3d(mode, k, s, d):
    rng = np.random.RandomState(18)
    kw = dict(nIn=2, nOut=3, kernelSize=k, stride=s, dilation=d,
              convolutionMode=mode, activation="relu")
    jl, tl = _pair("Convolution3D", j3d, t3d, **kw)
    params = {"W": _rand(rng, 3, 2, *k), "b": _rand(rng, 3)}
    _layer_parity(jl, tl, params, _rand(rng, 2, 2, 4, 5, 5))


@pytest.mark.parametrize("pt", ["MAX", "AVG"])
@pytest.mark.parametrize("mode,k,s,p", [
    (None, (2, 2, 2), (2, 2, 2), (0, 0, 0)),
    ("Same", (2, 3, 3), (2, 2, 2), (0, 0, 0)),
    (None, (1, 2, 2), (1, 2, 2), (0, 1, 1))])
def test_subsampling3d(pt, mode, k, s, p):
    rng = np.random.RandomState(19)
    kw = dict(poolingType=pt, kernelSize=k, stride=s, padding=p,
              convolutionMode=mode)
    jl, tl = _pair("Subsampling3DLayer", j3d, t3d, **kw)
    _layer_parity(jl, tl, {}, _rand(rng, 2, 2, 4, 5, 5))


def test_upsampling_cropping_and_padding_3d():
    rng = np.random.RandomState(20)
    x = _rand(rng, 2, 2, 3, 4, 5)
    for name, kw in [("Upsampling3D", dict(size=(1, 2, 3))),
                     ("Cropping3D", dict(cropDepth=(1, 0), cropHeight=(1, 2),
                                         cropWidth=(0, 2))),
                     ("ZeroPadding3DLayer", dict(padDepth=(1, 0),
                                                 padHeight=(2, 1),
                                                 padWidth=(0, 3)))]:
        jl, tl = _pair(name, j3d, t3d, **kw)
        _layer_parity(jl, tl, {}, x)


@pytest.mark.parametrize("mode,k,s,p", [
    ("Truncate", (2, 2, 2), (1, 1, 1), (0, 0, 0)),
    ("Truncate", (3, 2, 3), (2, 2, 1), (1, 0, 1)),
    ("Same", (3, 3, 2), (2, 1, 2), (0, 0, 0))])
def test_deconvolution3d(mode, k, s, p):
    rng = np.random.RandomState(21)
    kw = dict(nIn=2, nOut=3, kernelSize=k, stride=s, padding=p,
              convolutionMode=mode)
    jl, tl = _pair("Deconvolution3D", j3d, t3d, **kw)
    params = {"W": _rand(rng, 3, 2, *k, scale=0.5), "b": _rand(rng, 3)}
    _layer_parity(jl, tl, params, _rand(rng, 2, 2, 3, 3, 4))


@pytest.mark.parametrize("shared", [(), (2, 3)])
def test_prelu(shared):
    rng = np.random.RandomState(22)
    jl, tl = _pair("PReLULayer", j3d, t3d, inputShape=(3, 4, 5),
                   sharedAxes=shared)
    alpha = _rand(rng, *jl._alphaShape())
    _layer_parity(jl, tl, {"alpha": alpha}, _rand(rng, 2, 3, 4, 5))


@pytest.mark.parametrize("k,s,p", [((2, 2), (1, 1), (0, 0)),
                                   ((3, 2), (2, 1), (1, 0))])
def test_locally_connected2d(k, s, p):
    rng = np.random.RandomState(23)
    kw = dict(nIn=2, nOut=3, kernelSize=k, stride=s, padding=p,
              inputSize=(5, 6), activation="tanh")
    jl, tl = _pair("LocallyConnected2D", j3d, t3d, **kw)
    oh, ow = jl._outSpatial()
    params = {"W": _rand(rng, oh * ow, 2 * k[0] * k[1], 3),
              "b": _rand(rng, 3)}
    _layer_parity(jl, tl, params, _rand(rng, 2, 2, 5, 6))


@pytest.mark.parametrize("k,s,p", [(2, 1, 0), (3, 2, 1)])
def test_locally_connected1d(k, s, p):
    rng = np.random.RandomState(24)
    kw = dict(nIn=2, nOut=3, kernelSize=k, stride=s, padding=p, inputSize=7)
    jl, tl = _pair("LocallyConnected1D", j3d, t3d, **kw)
    params = {"W": _rand(rng, jl._outT(), 2 * k, 3), "b": _rand(rng, 3)}
    _layer_parity(jl, tl, params, _rand(rng, 2, 2, 7))


# ---------------------------------------------------------------------------
# JSON: every class of the three modules loads from the reference's JSON
# ---------------------------------------------------------------------------

JSON_LAYERS = [
    (jlayers, "ELULayer", dict(alpha=0.5)),
    (jlayers, "LeakyReLULayer", dict(alpha=0.2)),
    (jlayers, "DropoutLayer", dict(dropOut=0.7)),
    (jlayers, "EmbeddingLayer", dict(nIn=5, nOut=3, hasBias=True)),
    (jlayers, "EmbeddingSequenceLayer", dict(nIn=5, nOut=3, inputLength=4)),
    (jlayers, "LocalResponseNormalization", dict(n=3.0, alpha=1e-3)),
    (jconv, "Upsampling2D", dict(size=(2, 3))),
    (jconv, "Upsampling1D", dict(size=2)),
    (jconv, "ZeroPaddingLayer", dict(padding=(1, 2))),
    (jconv, "Cropping2D", dict(cropping=(1, 0, 2, 1))),
    (jconv, "Deconvolution2D", dict(nIn=2, nOut=3, kernelSize=(3, 3),
                                    convolutionMode="Same")),
    (jconv, "DepthwiseConvolution2D", dict(nIn=2, depthMultiplier=2)),
    (jconv, "SeparableConvolution2D", dict(nIn=2, nOut=4)),
    (jconv, "Convolution1DLayer", dict(nIn=2, nOut=4, dilation=2)),
    (jconv, "Subsampling1DLayer", dict(poolingType="AVG", padding=1)),
    (jconv, "SpaceToDepthLayer", dict(blockSize=2)),
    (jconv, "CnnLossLayer", dict(lossFunction="xent", activation="sigmoid")),
    (jconv, "Yolo2OutputLayer", dict(boundingBoxes=YOLO_ANCHORS)),
    (j3d, "Convolution3D", dict(nIn=2, nOut=3, kernelSize=(1, 2, 3))),
    (j3d, "Subsampling3DLayer", dict(poolingType="AVG")),
    (j3d, "Upsampling3D", dict(size=(1, 2, 2))),
    (j3d, "Cropping3D", dict(cropDepth=(1, 0))),
    (j3d, "ZeroPadding3DLayer", dict(padWidth=(1, 2))),
    (j3d, "Deconvolution3D", dict(nIn=2, nOut=3, stride=(2, 1, 1))),
    (j3d, "PReLULayer", dict(inputShape=(3, 4), sharedAxes=(2,))),
    (j3d, "LocallyConnected2D", dict(nIn=2, nOut=3, inputSize=(5, 5))),
    (j3d, "LocallyConnected1D", dict(nIn=2, nOut=3, inputSize=6)),
]


@pytest.mark.parametrize("mod,name,kw", JSON_LAYERS,
                         ids=[n for _m, n, _k in JSON_LAYERS])
def test_reference_json_loads_and_round_trips(mod, name, kw):
    layer, ref, back = _json_round_trip(getattr(mod, name)(**kw))
    assert type(layer).__name__ == name
    assert back == ref


def test_every_class_of_the_modules_is_registered():
    """``layer_from_json`` knows every layer class the three reference
    modules register."""
    from deeplearning4j_tpu.nn.conf.layers import _LAYER_REGISTRY as REF
    mods = {jlayers.__name__, jconv.__name__, j3d.__name__}
    names = sorted(n for n, c in REF.items() if c.__module__ in mods)
    assert len(names) == 33
    assert [n for n in names if n not in tlayers._LAYER_REGISTRY] == []


def test_yolo2_in_a_multilayer_network_fits_like_the_reference():
    """One Adam step of a conv + Yolo2OutputLayer net in both packages from
    the same parameters: the loss and the updated parameters to 1e-5."""
    import deeplearning4j_tpu.learning as jlearn
    import deeplearning4j_tpu.models as jmodels
    import deeplearning4j_tpu.nn.conf as jc
    import deeplearning4j_tpu_torch.learning as tlearn
    import deeplearning4j_tpu_torch.models as tmodels
    import deeplearning4j_tpu_torch.nn.conf as tc

    def conf(c, L, Y, learn):
        return (c.NeuralNetConfiguration.builder().seed(1)
                .updater(learn.Adam(1e-2)).list()
                .layer(L.ConvolutionLayer.builder().nOut(3 * 7)
                       .kernelSize(3, 3).convolutionMode("Same").build())
                .layer(Y.Yolo2OutputLayer.builder()
                       .boundingBoxes(YOLO_ANCHORS).build())
                .setInputType(c.InputType.convolutional(3, 4, 2)).build())

    jnet = jmodels.MultiLayerNetwork(conf(jc, jlayers, jconv, jlearn))
    jnet.init()
    net = tmodels.MultiLayerNetwork(conf(tc, tlayers, tconv, tlearn),
                                    device="cpu").init(
        params=jax.tree.map(np.array, jnet.params_))
    rng = np.random.RandomState(25)
    x = _rand(rng, 2, 2, 3, 4)
    y = _yolo_labels(rng, 2, 2, 3, 4, [(0, 1, 2, 1.4, 0.9, 0),
                                       (1, 0, 0, 0.7, 1.8, 1)])
    import deeplearning4j_tpu.datasets as jds
    import deeplearning4j_tpu_torch.datasets as tds
    jnet.fit(jds.DataSet(x, y))
    net.fit(tds.DataSet(x, y))
    np.testing.assert_allclose(net.score(), jnet.score(), rtol=1e-5)
    np.testing.assert_allclose(net.params().numpy(),
                               np.asarray(jnet.params().jax), atol=1e-5)
