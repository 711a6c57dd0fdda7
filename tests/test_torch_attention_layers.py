"""The rest of ROADMAP A7 against the reference: ``SelfAttentionLayer``'s
KV-cached ``initCache`` / ``decodeStep``, ``LearnedSelfAttentionLayer``,
``RecurrentAttentionLayer`` and ``KerasMultiHeadAttention`` — outputs and
gradients (``_torch_parity._layer_parity``: the reference's parameters,
drawn by its ``initParams``, carried into the port's layer), their JSON
through ``layer_from_json``, the chained decode against the causal
forward, the dispatch of the imported attention to the flash kernels, and
ROADMAP C19."""
import jax
import numpy as np
import pytest
import torch

from _torch_parity import _json_round_trip, _layer_parity
from deeplearning4j_tpu.nn.conf import attention as jatt
from deeplearning4j_tpu.nn.conf.inputs import InputType as JInputType
from deeplearning4j_tpu_torch.nn.conf import attention as tatt
from deeplearning4j_tpu_torch.nn.conf import layers as tlayers
from deeplearning4j_tpu_torch.parallel import ring

pytestmark = pytest.mark.torch_port

B, NIN, T = 3, 12, 10
TOL = dict(atol=1e-5, rtol=1e-5)

#: (class name, constructor kwargs, with a key mask)
CASES = [
    ("SelfAttentionLayer", dict(nIn=NIN, nOut=8, nHeads=2, headSize=4,
                                causal=True), False),
    ("LearnedSelfAttentionLayer", dict(nIn=NIN, nOut=8, nHeads=2,
                                       headSize=4, nQueries=3), False),
    ("LearnedSelfAttentionLayer", dict(nIn=NIN, nOut=8, nHeads=2,
                                       headSize=4, nQueries=3), True),
    ("LearnedSelfAttentionLayer", dict(nIn=NIN, nHeads=1, nQueries=2,
                                       projectInput=False), False),
    ("RecurrentAttentionLayer", dict(nIn=NIN, nOut=6, nHeads=2,
                                     headSize=4), False),
    ("RecurrentAttentionLayer", dict(nIn=NIN, nOut=6, nHeads=2, headSize=4,
                                     activation="relu"), True),
    ("RecurrentAttentionLayer", dict(nIn=NIN, nOut=5, nHeads=1,
                                     projectInput=False), False),
    ("KerasMultiHeadAttention", dict(nIn=NIN, nHeads=3, keyDim=4), False),
    ("KerasMultiHeadAttention", dict(nIn=NIN, nHeads=2, keyDim=4,
                                     valueDim=5, nOut=7), True),
    ("KerasMultiHeadAttention", dict(nIn=NIN, nHeads=2, keyDim=3,
                                     hasBias=False), False),
]


def _pair(name, kw):
    jl = getattr(jatt, name)(**kw)
    tl = getattr(tatt, name)(**kw)
    it = JInputType.recurrent(NIN, T)
    jl.inferNIn(it)
    tl.inferNIn(it)
    return jl, tl


def _ref_params(jl, seed=0):
    """The reference's drawn parameters, numpy; its zero biases made
    random so that they count."""
    p = jl.initParams(jax.random.PRNGKey(seed),
                      JInputType.recurrent(NIN, T))
    rng = np.random.RandomState(seed + 1)
    return {k: (np.asarray(v) if k.startswith(("W", "Q")) else
                rng.randn(*np.shape(v)).astype(np.float32) * 0.1)
            for k, v in p.items()}


def _x_mask(seed=3):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, NIN, T).astype(np.float32)
    mask = np.ones((B, T), np.float32)
    mask[0, 7:] = 0.0
    mask[2, 4:] = 0.0
    return x, mask


@pytest.mark.parametrize("name,kw,masked", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_layer_forward_and_gradient_match_the_reference(name, kw, masked):
    jl, tl = _pair(name, kw)
    params = _ref_params(jl)
    x, mask = _x_mask()
    out, _ref = _layer_parity(jl, tl, params, x,
                              mask=mask if masked else None, **TOL)
    want = tl.getOutputType(JInputType.recurrent(NIN, T))
    assert tuple(out.shape) == (B, want.size, want.timeSeriesLength)


@pytest.mark.parametrize("name,kw,masked", CASES[::3],
                         ids=[c[0] for c in CASES[::3]])
def test_port_draws_the_references_parameter_shapes(name, kw, masked):
    """``initParams`` in the port: the reference's keys and shapes (the
    draws differ: two RNGs); what ``init(params=)`` carries fits."""
    jl, tl = _pair(name, kw)
    jp = jl.initParams(jax.random.PRNGKey(0), JInputType.recurrent(NIN, T))
    tp = tl.initParams(torch.Generator().manual_seed(0),
                       JInputType.recurrent(NIN, T), device="cpu")
    assert {k: tuple(np.shape(v)) for k, v in jp.items()} == \
        {k: tuple(v.shape) for k, v in tp.items()}
    assert tl.weightParamKeys() == jl.weightParamKeys()


@pytest.mark.parametrize("name,kw,masked", CASES,
                         ids=[f"{c[0]}-{i}" for i, c in enumerate(CASES)])
def test_reference_json_loads_in_the_port(name, kw, masked):
    jl, _ = _pair(name, kw)
    layer, ref, back = _json_round_trip(jl)
    assert type(layer).__name__ == name
    assert back == ref


def test_carried_keras_mha_params_run_in_a_port_net():
    """The 3-D ``KerasMultiHeadAttention`` weights cross through
    ``MultiLayerNetwork.init(params=)``: the two nets' outputs agree."""
    from _torch_parity import JAX, PORT
    import jax.numpy as jnp

    def conf(pkg):
        return (pkg.conf.NeuralNetConfiguration.builder().seed(3).list()
                .layer(pkg.att.KerasMultiHeadAttention(nHeads=2, keyDim=4))
                .layer(pkg.rec.RnnOutputLayer.builder("mse").nOut(3)
                       .activation("identity").build())
                .setInputType(pkg.conf.InputType.recurrent(NIN, T)).build())
    jnet = JAX.models.MultiLayerNetwork(conf(JAX)).init()
    params = jax.tree.map(np.asarray, jnet.params_)
    assert params["0"]["Wq"].shape == (NIN, 2, 4)
    net = PORT.models.MultiLayerNetwork(conf(PORT), device="cpu").init(
        params=params)
    x, _ = _x_mask()
    np.testing.assert_allclose(net.output(x).numpy(),
                               np.asarray(jnet.output(jnp.asarray(x))
                                          .numpy()), **TOL)


def _self_attention(causal=True, projectInput=True):
    kw = dict(nIn=NIN, causal=causal, projectInput=projectInput)
    kw.update(dict(nOut=8, nHeads=2, headSize=4) if projectInput
              else dict(nHeads=1))
    return _pair("SelfAttentionLayer", kw)


@pytest.mark.parametrize("projectInput", [True, False])
def test_chained_decode_steps_equal_the_causal_forward(projectInput):
    """``initCache`` + ``decodeStep`` fed the sequence in pieces give the
    causal forward, in the port and as the reference's decode does."""
    jl, tl = _self_attention(projectInput=projectInput)
    params = _ref_params(jl) if projectInput else {}
    x, _ = _x_mask()
    tp = {k: torch.tensor(v) for k, v in params.items()}
    full, _ = tl.forward(tp, torch.tensor(x), False, None, {})
    cache = tl.initCache(B, T + 2, device="cpu")
    jcache = jl.initCache(B, T + 2)
    jp = {k: jax.numpy.asarray(v) for k, v in params.items()}
    jdecode = jax.jit(jl.decodeStep)
    pieces, jpieces, pos = [], [], 0
    for n in (3, 1, 4, 2):
        y, cache = tl.decodeStep(tp, torch.tensor(x[:, :, pos:pos + n]),
                                 cache)
        jy, jcache = jdecode(jp, jax.numpy.asarray(x[:, :, pos:pos + n]),
                             jcache)
        pieces.append(y)
        jpieces.append(np.asarray(jy))
        pos += n
    assert cache.pos == T
    got = torch.cat(pieces, dim=2).numpy()
    np.testing.assert_allclose(got, full.numpy(), **TOL)
    np.testing.assert_allclose(got, np.concatenate(jpieces, axis=2), **TOL)


def test_cache_needs_a_causal_layer_and_lands_on_its_device():
    _, tl = _self_attention(causal=False)
    with pytest.raises(ValueError, match="causal=True"):
        tl.initCache(1, 4, device="cpu")
    _, tl = _self_attention()
    cache = tl.initCache(2, 6, device="cpu")
    assert tuple(cache.k.shape) == (2, 2, 6, 4) and cache.k.device.type \
        == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tl.initCache(2, 6)


def test_imported_attention_takes_the_flash_kernels():
    """The Keras transformer's attention, (4, 8, 2048, 16) float32 with no
    mask, dispatches to flash on CUDA; its q, k, v are transposed views,
    which the kernels' layout step copies to contiguous rows of the same
    values (no dense fallback)."""
    shape = (4, 8, 2048, 16)
    assert ring._auto_impl(shape, shape, shape, (torch.float32,) * 3,
                           False, True) == "flash"
    assert ring._auto_impl(shape, shape, shape, (torch.float32,) * 3,
                           True, True) == "dense"
    rng = np.random.RandomState(0)
    q, k, v = (torch.tensor(rng.randn(2, 40, 3, 8).astype(np.float32))
               .transpose(1, 2) for _ in range(3))
    assert not q.is_contiguous()
    *laid, dp = ring._flash_layout(q, k, v)
    assert dp == 8
    for a, b in zip(laid, (q, k, v)):
        assert a.is_contiguous() and torch.equal(a, b)
    flash = ring.dot_product_attention(q, k, v, impl="flash")
    dense = ring.dot_product_attention(q, k, v, impl="dense")
    torch.testing.assert_close(flash, dense, atol=1e-5, rtol=1e-5)


def test_c19_attention_layers_import_and_load():
    """ROADMAP C19, repaired: the four A7 layers import from
    ``nn.conf.attention`` and load from the reference's JSON; a layer
    still unported names its own ROADMAP item, not A7."""
    from deeplearning4j_tpu_torch.nn.conf.attention import (  # noqa: F401
        KerasMultiHeadAttention, LearnedSelfAttentionLayer,
        RecurrentAttentionLayer, SelfAttentionLayer)
    jl = jatt.LearnedSelfAttentionLayer(nIn=4, nOut=4, nHeads=1, nQueries=2)
    assert type(_json_round_trip(jl)[0]) is LearnedSelfAttentionLayer
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    with pytest.raises(NotImplementedError, match="A10") as e:
        NeuralNetConfiguration.builder().list().pipelineStages(2)
    assert "A7" not in str(e.value) and "A4" not in str(e.value)
    # A12b's layers, once unported here too, load
    assert type(tlayers.layer_from_json(
        {"@class": "PixelShuffleLayer", "blockSize": 2})).__name__ == \
        "PixelShuffleLayer"
    # A11's layer, once unported here too, loads
    assert type(tlayers.layer_from_json(
        {"@class": "ShardedEmbeddingBag", "numEmbeddings": 4,
         "embeddingDim": 2})).__name__ == "ShardedEmbeddingBag"
