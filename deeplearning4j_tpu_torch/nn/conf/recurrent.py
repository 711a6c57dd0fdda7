"""Recurrent layers — the port of ``deeplearning4j_tpu/nn/conf/recurrent.py``
(the reference's ``conf/layers/{LSTM,GravesLSTM,GRU,SimpleRnn,
RnnOutputLayer,RnnLossLayer}.java``, ``conf/layers/recurrent/
{Bidirectional,LastTimeStep,TimeDistributed}.java`` and the imperative
``nn/layers/recurrent/**``).

The JAX package runs each layer as one ``lax.scan`` over time; here the
scan is a Python loop over t on torch tensors, the same ops on CUDA and on
the CPU (no ``torch.nn.LSTM``/``GRU`` or cuDNN RNN: their gate order,
peepholes and configurable gate activations differ).  The input projection
``x·W`` for all timesteps is one product hoisted out of the loop, as the
reference hoists it; only the recurrent product ``h·RW`` stays inside.

Data format (DL4J convention): RNN activations are ``(b, n, t)``; masks are
``(b, t)`` with 1 = present.  Masked steps output zeros and keep the
previous carry, so the final carry is each sequence's state at its last
valid step (what ``LastTimeStep`` and ``rnnTimeStep`` need).

LSTM gate columns go i, f, o, g along the 4·nOut axis; parameters keep the
reference's layout: W (nIn, 4h), RW (h, 4h), b (4h), forget-gate bias 1.0.
GravesLSTM adds peepholes pI, pF (reading c_(t-1)) and pO (reading c_t).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import (BaseLayer, DenseLayer,
                                                     Layer, LossLayer,
                                                     register_layer)
from deeplearning4j_tpu_torch.nn.lossfunctions import get_loss
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["BaseRecurrentLayer", "SimpleRnn", "LSTM", "GravesLSTM", "GRU",
           "Bidirectional", "BidirectionalMode", "LastTimeStep",
           "RnnOutputLayer", "RnnLossLayer", "TimeDistributed",
           "TimeDistributedFlatten"]


def _map(fn, *trees):
    """``fn`` over the leaves of carries of one structure (a tensor, a
    tuple of tensors or a dict of either)."""
    a = trees[0]
    if isinstance(a, dict):
        return {k: _map(fn, *(t[k] for t in trees)) for k in a}
    if isinstance(a, tuple):
        return tuple(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _masked_scan(cell, p, x_bnt, mask, carry0):
    """Run ``cell(p, carry, x_t) -> (new_carry, y_t)`` over time.

    ``x_bnt``: (b, n, t) pre-projected input; returns ((b, nOut, t),
    final_carry).  With a mask, masked steps output zeros and keep the
    previous carry."""
    xs = x_bnt.permute(2, 0, 1)                       # (t, b, n)
    # the carry's dtype follows the (possibly promoted) projected input
    carry = _map(lambda c: c.to(xs.dtype), carry0)
    ys = []
    if mask is None:
        for xt in xs:
            carry, y = cell(p, carry, xt)
            ys.append(y)
    else:
        ms = mask.t().to(xs.dtype)[..., None]         # (t, b, 1)
        for xt, mt in zip(xs, ms):
            new, y = cell(p, carry, xt)
            keep = mt > 0
            carry = _map(lambda n, o: torch.where(keep, n, o), new, carry)
            ys.append(y * mt)
    return torch.stack(ys, dim=2), carry              # (b, nOut, t)


def _project(x, params):
    """x·W + b for every timestep at once: (b, n, t) -> (b, k, t)."""
    return torch.einsum("bnt,nh->bht", x, params["W"]) \
        + params["b"][:, None]


@dataclasses.dataclass
class BaseRecurrentLayer(BaseLayer):
    """Common recurrent config (reference: ``BaseRecurrentLayer.java``)."""
    nIn: int = 0
    nOut: int = 0
    weightInitRecurrent: Optional[str] = None

    isRNN = True          # model dispatch: has scanSeq and carries
    acceptsMask = True

    def preferredFormat(self):
        return "RNN"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut, inputType.timeSeriesLength)

    # -- recurrence interface -------------------------------------------
    def initialCarry(self, batch: int, dtype, device):
        """Zero carry for a fresh sequence."""
        return torch.zeros((batch, self.nOut), dtype=dtype, device=device)

    def scanSeq(self, params, x, train, gen, carry, mask=None):
        """(b, nIn, t) -> ((b, nOut, t), final_carry)."""
        raise NotImplementedError

    def forward(self, params, x, train, gen, state, mask=None):
        y, _ = self.scanSeq(params, x, train, gen,
                            self.initialCarry(x.shape[0], x.dtype, x.device),
                            mask)
        return y, state

    def weightParamKeys(self):
        return ("W", "RW")

    def _rw_init(self):
        return self.weightInitRecurrent or self.weightInit or "XAVIER"

    def _weights(self, gen, width, dtype, device):
        """W (nIn, width) and RW (nOut, width), drawn in that order."""
        n, h = self.nIn, self.nOut
        return {"W": init_weight(gen, (n, width), n, width,
                                 self.weightInit or "XAVIER", dtype, device),
                "RW": init_weight(gen, (h, width), h, width,
                                  self._rw_init(), dtype, device)}


@register_layer
@dataclasses.dataclass
class SimpleRnn(BaseRecurrentLayer):
    """Vanilla RNN: h_t = act(x_t·W + h_(t-1)·RW + b).
    Reference: ``conf/layers/recurrent/SimpleRnn.java``."""

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        p = self._weights(gen, self.nOut, dtype, dev)
        p["b"] = torch.full((self.nOut,), float(self.biasInit or 0.0),
                            dtype=dtype, device=dev)
        return p

    def scanSeq(self, params, x, train, gen, carry, mask=None):
        x = self._dropin(x, train, gen)
        act = get_activation(self.activation or "tanh")

        def cell(p, h, xt):                      # xt: (b, nOut) projected
            h2 = act(xt + h @ p["RW"])
            return h2, h2

        return _masked_scan(cell, params, _project(x, params), mask, carry)


@register_layer
@dataclasses.dataclass
class LSTM(BaseRecurrentLayer):
    """LSTM without peepholes (reference: ``conf/layers/LSTM.java``,
    libnd4j's ``lstmLayer``).  Gate order i, f, o, g; forget-gate bias
    init 1.0 by default."""
    forgetGateBiasInit: float = 1.0
    gateActivationFunction: str = "sigmoid"

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        h = self.nOut
        p = self._weights(gen, 4 * h, dtype, dev)
        b = torch.zeros((4 * h,), dtype=dtype, device=dev)
        b[h:2 * h] = self.forgetGateBiasInit             # f-gate block
        p["b"] = b
        return p

    def initialCarry(self, batch, dtype, device):
        return (torch.zeros((batch, self.nOut), dtype=dtype, device=device),
                torch.zeros((batch, self.nOut), dtype=dtype, device=device))

    def scanSeq(self, params, x, train, gen, carry, mask=None):
        x = self._dropin(x, train, gen)
        h = self.nOut
        gate = get_activation(self.gateActivationFunction)
        act = get_activation(self.activation or "tanh")

        def cell(p, hc, xt):
            h_prev, c_prev = hc
            z = xt + h_prev @ p["RW"]
            i = gate(z[:, 0 * h:1 * h])
            f = gate(z[:, 1 * h:2 * h])
            o = gate(z[:, 2 * h:3 * h])
            g = act(z[:, 3 * h:4 * h])
            c = f * c_prev + i * g
            h2 = o * act(c)
            return (h2, c), h2

        return _masked_scan(cell, params, _project(x, params), mask, carry)


@register_layer
@dataclasses.dataclass
class GravesLSTM(LSTM):
    """LSTM with peephole connections (Graves 2013).  Reference:
    ``conf/layers/GravesLSTM.java`` — peepholes pI and pF read c_(t-1), pO
    reads c_t."""

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        p = super().initParams(gen, inputType, dtype, device)
        for k in ("pI", "pF", "pO"):
            p[k] = torch.zeros((self.nOut,), dtype=dtype,
                               device=p["W"].device)
        return p

    def scanSeq(self, params, x, train, gen, carry, mask=None):
        x = self._dropin(x, train, gen)
        h = self.nOut
        gate = get_activation(self.gateActivationFunction)
        act = get_activation(self.activation or "tanh")

        def cell(p, hc, xt):
            h_prev, c_prev = hc
            z = xt + h_prev @ p["RW"]
            i = gate(z[:, 0 * h:1 * h] + c_prev * p["pI"])
            f = gate(z[:, 1 * h:2 * h] + c_prev * p["pF"])
            g = act(z[:, 3 * h:4 * h])
            c = f * c_prev + i * g
            o = gate(z[:, 2 * h:3 * h] + c * p["pO"])
            h2 = o * act(c)
            return (h2, c), h2

        return _masked_scan(cell, params, _project(x, params), mask, carry)


@register_layer
@dataclasses.dataclass
class GRU(BaseRecurrentLayer):
    """Gated recurrent unit (reference: libnd4j ``gruCell``/``gru``); gate
    order r, u, then the candidate c.  ``resetAfter=True`` is the
    CuDNN-compatible GRU-v2 cell: the reset gate multiplies the candidate's
    recurrent projection after the product, ``c = act(xW + r*(h·R + b2))``,
    with a separate recurrent bias ``b2``."""
    gateActivationFunction: str = "sigmoid"
    resetAfter: bool = False

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        dev = resolve_device(device)
        h = self.nOut
        p = self._weights(gen, 3 * h, dtype, dev)
        p["b"] = torch.zeros((3 * h,), dtype=dtype, device=dev)
        if self.resetAfter:
            p["b2"] = torch.zeros((3 * h,), dtype=dtype, device=dev)
        return p

    def scanSeq(self, params, x, train, gen, carry, mask=None):
        x = self._dropin(x, train, gen)
        h = self.nOut
        gate = get_activation(self.gateActivationFunction)
        act = get_activation(self.activation or "tanh")

        if self.resetAfter:
            def cell(p, hp, xt):
                rp = hp @ p["RW"] + p["b2"]
                r = gate(xt[:, 0:h] + rp[:, 0:h])
                u = gate(xt[:, h:2 * h] + rp[:, h:2 * h])
                c = act(xt[:, 2 * h:3 * h] + r * rp[:, 2 * h:3 * h])
                h2 = u * hp + (1.0 - u) * c
                return h2, h2
        else:
            def cell(p, hp, xt):
                r = gate(xt[:, 0:h] + hp @ p["RW"][:, 0:h])
                u = gate(xt[:, h:2 * h] + hp @ p["RW"][:, h:2 * h])
                c = act(xt[:, 2 * h:3 * h]
                        + (r * hp) @ p["RW"][:, 2 * h:3 * h])
                h2 = u * hp + (1.0 - u) * c
                return h2, h2

        return _masked_scan(cell, params, _project(x, params), mask, carry)


class BidirectionalMode:
    ADD = "ADD"
    MUL = "MUL"
    AVERAGE = "AVERAGE"
    CONCAT = "CONCAT"


#: hyper-params the train step reads off a layer; wrappers delegate these
#: to the wrapped layer (which is where applyGlobalDefaults puts them)
_DELEGATED_HYPERPARAMS = ("l1", "l2", "weightDecay", "updater", "biasUpdater",
                          "gradientNormalization",
                          "gradientNormalizationThreshold", "dropOut",
                          "activation", "weightInit", "biasInit")


class _Wrapper:
    """Hyper-param delegation of a wrapper layer to the layer it wraps,
    held in the field named by ``_inner``."""
    _inner = "underlying"

    def __getattr__(self, name):
        if name in _DELEGATED_HYPERPARAMS:
            inner = self.__dict__.get(self._inner)
            return getattr(inner, name, None) if inner is not None else None
        raise AttributeError(name)

    def applyGlobalDefaults(self, g):
        getattr(self, self._inner).applyGlobalDefaults(g)

    def weightParamKeys(self):
        return getattr(self, self._inner).weightParamKeys()

    @classmethod
    def _fromJsonDict(cls, d: dict):
        from deeplearning4j_tpu_torch.nn.conf.layers import layer_from_json
        return cls(underlying=layer_from_json(d["underlying"]),
                   name=d.get("name"))

    def toJson(self) -> dict:
        return {"@class": type(self).__name__, "name": self.name,
                "underlying": self.underlying.toJson()}


def _merge(mode, a, b):
    """Bidirectional's merge of the two directions along the features."""
    if mode == BidirectionalMode.ADD:
        return a + b
    if mode == BidirectionalMode.MUL:
        return a * b
    if mode == BidirectionalMode.AVERAGE:
        return 0.5 * (a + b)
    return torch.cat([a, b], dim=1)


@register_layer
@dataclasses.dataclass
class Bidirectional(_Wrapper, Layer):
    """Wraps an RNN layer, running it forward and time-reversed.
    Reference: ``conf/layers/recurrent/Bidirectional.java`` (modes
    ADD/MUL/AVERAGE/CONCAT).

    Mask-aware reversal: the backward pass flips each sequence only within
    its valid length, so padded steps never seed the reverse scan."""
    fwd: Optional[BaseRecurrentLayer] = None
    mode: str = BidirectionalMode.CONCAT

    isRNN = True
    acceptsMask = True
    _inner = "fwd"

    @classmethod
    def _builderArgs(cls, b, *args):
        # Bidirectional.builder(mode, layer) or .builder(layer)
        for a in args:
            if isinstance(a, str):
                b._kw["mode"] = a
            else:
                b._kw["fwd"] = a

    def __init__(self, *args, name=None, fwd=None, mode=None,
                 returnSequences=True, **kw):
        # Bidirectional(LSTM(...)) or Bidirectional("ADD", LSTM(...))
        super().__init__(name=name)
        self.mode = mode or BidirectionalMode.CONCAT
        self.fwd = fwd
        for a in args:
            if isinstance(a, str):
                self.mode = a
            elif isinstance(a, Layer):
                self.fwd = a
        if self.fwd is None:
            raise ValueError("Bidirectional requires a wrapped RNN layer")
        # returnSequences=False: keras last-step semantics — the forward
        # scan's last valid output merged with the backward scan's own last
        # output (original position 0), emitted as FF
        self.returnSequences = bool(returnSequences)
        self.isRNN = self.returnSequences
        self._bwd = dataclasses.replace(self.fwd)

    def applyGlobalDefaults(self, g):
        self.fwd.applyGlobalDefaults(g)
        self._bwd = dataclasses.replace(self.fwd)

    def preferredFormat(self):
        return "RNN"

    def inferNIn(self, inputType):
        self.fwd.inferNIn(inputType)
        self._bwd = dataclasses.replace(self.fwd)

    def getOutputType(self, inputType):
        base = self.fwd.getOutputType(inputType)
        n = 2 * base.size if self.mode == BidirectionalMode.CONCAT \
            else base.size
        if not self.returnSequences:
            return InputType.feedForward(n)
        return InputType.recurrent(n, base.timeSeriesLength)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        return {"fwd": self.fwd.initParams(gen, inputType, dtype, device),
                "bwd": self._bwd.initParams(gen, inputType, dtype, device)}

    def initialCarry(self, batch, dtype, device):
        return {"fwd": self.fwd.initialCarry(batch, dtype, device),
                "bwd": self._bwd.initialCarry(batch, dtype, device)}

    @staticmethod
    def _reverse(x, mask):
        """Flip (b, n, t) along t within each sequence's valid length."""
        if mask is None:
            return torch.flip(x, dims=(2,))
        t = x.shape[2]
        lengths = mask.sum(dim=1).to(torch.int64)[:, None]        # (b, 1)
        idx = torch.arange(t, device=x.device)[None, :]           # (1, t)
        src = torch.where(idx < lengths, (lengths - 1 - idx) % t, idx)
        return torch.gather(x, 2, src[:, None, :].expand(-1, x.shape[1],
                                                         -1))

    def scanSeq(self, params, x, train, gen, carry, mask=None):
        yf, cf = self.fwd.scanSeq(params["fwd"], x, train, gen,
                                  carry["fwd"], mask)
        yb_r, cb = self._bwd.scanSeq(params["bwd"], self._reverse(x, mask),
                                     train, gen, carry["bwd"], mask)
        y = _merge(self.mode, yf, self._reverse(yb_r, mask))
        return y, {"fwd": cf, "bwd": cb}

    @staticmethod
    def _last_valid(y, mask):
        """(b, n, t) -> (b, n) at each sequence's last valid step."""
        if mask is None:
            return y[:, :, -1]
        idx = torch.clamp(mask.sum(dim=1).to(torch.int64) - 1, 0,
                          y.shape[2] - 1)
        return torch.gather(y, 2, idx[:, None, None].expand(
            -1, y.shape[1], 1))[:, :, 0]

    def forward(self, params, x, train, gen, state, mask=None):
        carry = self.initialCarry(x.shape[0], x.dtype, x.device)
        if self.returnSequences:
            y, _ = self.scanSeq(params, x, train, gen, carry, mask)
            return y, state
        yf, _ = self.fwd.scanSeq(params["fwd"], x, train, gen,
                                 carry["fwd"], mask)
        yb_r, _ = self._bwd.scanSeq(params["bwd"], self._reverse(x, mask),
                                    train, gen, carry["bwd"], mask)
        return _merge(self.mode, self._last_valid(yf, mask),
                      self._last_valid(yb_r, mask)), state

    def toJson(self) -> dict:
        return {"@class": "Bidirectional", "name": self.name,
                "mode": self.mode, "fwd": self.fwd.toJson(),
                "returnSequences": self.returnSequences}

    @classmethod
    def _fromJsonDict(cls, d: dict) -> "Bidirectional":
        from deeplearning4j_tpu_torch.nn.conf.layers import layer_from_json
        return cls(fwd=layer_from_json(d["fwd"]), mode=d.get("mode"),
                   name=d.get("name"),
                   returnSequences=d.get("returnSequences", True))


@register_layer
@dataclasses.dataclass
class LastTimeStep(_Wrapper, Layer):
    """Wraps an RNN layer, returning only the last valid time step as FF.
    Reference: ``conf/layers/recurrent/LastTimeStep.java`` (mask-aware)."""
    underlying: Optional[Layer] = None

    acceptsMask = True

    def __init__(self, underlying=None, name=None):
        super().__init__(name=name)
        if underlying is None:
            raise ValueError("LastTimeStep requires an underlying RNN layer")
        self.underlying = underlying

    def preferredFormat(self):
        return "RNN"

    def inferNIn(self, inputType):
        self.underlying.inferNIn(inputType)

    def getOutputType(self, inputType):
        rnn_out = self.underlying.getOutputType(inputType)
        return InputType.feedForward(rnn_out.size)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        return self.underlying.initParams(gen, inputType, dtype, device)

    def forward(self, params, x, train, gen, state, mask=None):
        carry0 = self.underlying.initialCarry(x.shape[0], x.dtype, x.device)
        y, _ = self.underlying.scanSeq(params, x, train, gen, carry0, mask)
        if mask is None:
            return y[:, :, -1], state
        # the last VALID step of each sequence: the last set position, so
        # masks with interior holes (from MaskingLayer) work too
        pos = torch.arange(1, y.shape[2] + 1, dtype=torch.float32,
                           device=y.device)
        idx = torch.argmax(mask.float() * pos[None, :], dim=1)      # (b,)
        return torch.gather(y, 2, idx[:, None, None].expand(
            -1, y.shape[1], 1))[:, :, 0], state


@register_layer
@dataclasses.dataclass
class RnnOutputLayer(DenseLayer):
    """Per-timestep dense + activation + loss over (b, n, t).
    Reference: ``conf/layers/RnnOutputLayer.java`` — the dense projection
    at every step, loss masked per (example, step)."""
    lossFunction: str = "mcxent"

    acceptsMask = True

    @classmethod
    def _builderArgs(cls, b, *args):
        if args:
            b._kw["lossFunction"] = args[0]

    def preferredFormat(self):
        return "RNN"

    def getOutputType(self, inputType):
        return InputType.recurrent(self.nOut, inputType.timeSeriesLength)

    def hasLoss(self) -> bool:
        return True

    def computeScore(self, labels, output, mask=None):
        """labels/output (b, nOut, t), mask (b, t) -> per-example scores."""
        return get_loss(self.lossFunction)(labels, output, mask)

    def forward(self, params, x, train, gen, state, mask=None):
        x = self._dropin(x, train, gen)
        y = torch.einsum("bnt,nh->bht", x, params["W"])
        if self.hasBias:
            y = y + params["b"][:, None]
        if (self.activation or "softmax") == "softmax":
            # softmax over the feature axis (axis 1 of (b, n, t))
            y = torch.softmax(y, dim=1)
        else:
            y = get_activation(self.activation)(y)
        if mask is not None:
            y = y * mask[:, None, :]
        return y, state


@register_layer
@dataclasses.dataclass
class RnnLossLayer(LossLayer):
    """Per-timestep loss without params.
    Reference: ``conf/layers/RnnLossLayer.java``."""

    acceptsMask = True

    def preferredFormat(self):
        return "RNN"

    def forward(self, params, x, train, gen, state, mask=None):
        if (self.activation or "identity") == "softmax":
            y = torch.softmax(x, dim=1)
        else:
            y = get_activation(self.activation or "identity")(x)
        if mask is not None:
            y = y * mask[:, None, :]
        return y, state


@register_layer
@dataclasses.dataclass
class TimeDistributed(_Wrapper, Layer):
    """Apply a wrapped layer independently at every time step.
    Reference: ``conf/layers/recurrent/TimeDistributed.java`` (an FF layer
    over ``(b, n, t)``); also a CNN layer over ``(b, c, d, h, w)`` (NCDHW,
    depth = time), frame by frame — the Keras
    ``TimeDistributed(Conv2D)`` import path."""
    underlying: Optional[Layer] = None

    def __init__(self, underlying=None, name=None):
        super().__init__(name=name)
        if underlying is None:
            raise ValueError("TimeDistributed requires an underlying layer")
        self.underlying = underlying

    def _step_type(self, inputType):
        if inputType.kind == "RNN":
            return InputType.feedForward(inputType.size)
        if inputType.kind == "CNN3D":
            return InputType.convolutional(inputType.height, inputType.width,
                                           inputType.channels)
        raise ValueError(
            f"TimeDistributed requires RNN or CNN3D input, got {inputType}")

    def inferNIn(self, inputType):
        self.underlying.inferNIn(self._step_type(inputType))

    def getOutputType(self, inputType):
        out = self.underlying.getOutputType(self._step_type(inputType))
        t = inputType.timeSeriesLength if inputType.kind == "RNN" \
            else inputType.depth
        if out.kind == "FF":
            return InputType.recurrent(out.size, t)
        if out.kind == "CNN":
            return InputType.convolutional3D(t, out.height, out.width,
                                             out.channels)
        raise ValueError(f"TimeDistributed: unsupported inner output {out}")

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        return self.underlying.initParams(gen, self._step_type(inputType),
                                          dtype, device)

    def initState(self, inputType, dtype=torch.float32, device=None):
        init = getattr(self.underlying, "initState", None)
        return init(self._step_type(inputType), dtype, device) if init \
            else {}

    def forward(self, params, x, train, gen, state):
        if x.dim() == 3:                      # (b, n, t): per-step FF
            b, n, t = x.shape
            flat = x.permute(0, 2, 1).reshape(b * t, n)
            y, st = self.underlying.forward(params, flat, train, gen, state)
            return y.reshape(b, t, -1).permute(0, 2, 1), st
        # (b, c, d, h, w): the inner CNN layer frame by frame.  Its state
        # (e.g. BN running stats) is read-only per frame and its updates
        # are dropped, as the reference's vmap drops them
        frames = [self.underlying.forward(params, x[:, :, i], train, gen,
                                          state)[0]
                  for i in range(x.shape[2])]
        return torch.stack(frames, dim=2), state


@register_layer
@dataclasses.dataclass
class TimeDistributedFlatten(Layer):
    """Flatten each frame of an NCDHW sequence to features, producing RNN
    ``(b, h*w*c, d)`` in Keras (h, w, c) feature order — so an imported
    downstream LSTM kernel's rows line up without permutation."""

    def getOutputType(self, inputType):
        if inputType.kind != "CNN3D":
            raise ValueError("TimeDistributedFlatten requires CNN3D input")
        return InputType.recurrent(
            inputType.height * inputType.width * inputType.channels,
            inputType.depth)

    def forward(self, params, x, train, gen, state):
        b, c, d, h, w = x.shape
        y = x.permute(0, 2, 3, 4, 1).reshape(b, d, h * w * c)
        return y.permute(0, 2, 1), state
