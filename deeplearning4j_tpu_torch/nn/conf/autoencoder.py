"""Plain (denoising) autoencoder layer — the port of
``deeplearning4j_tpu/nn/conf/autoencoder.py`` (the reference's
deeplearning4j-nn ``conf/layers/AutoEncoder.java`` +
``layers/feedforward/autoencoder/AutoEncoder.java``, BasePretrainNetwork):
tied-weight encode/decode with a visible bias and input corruption,
trained by ``MultiLayerNetwork.pretrain`` (``isPretrainLayer``).

Encode h = act(x·W + b); decode x' = act(h·Wᵀ + vb) (tied weights, a
separate visible bias); ``corruptionLevel`` zeroes that fraction of the
inputs during pretraining; ``pretrainLoss`` applies the configured loss
between the clean input and the reconstruction.  The supervised forward
is the encoder alone.

torch cannot draw the reference's ``jax.random.bernoulli`` bits, so the
loss has an inner form, :meth:`AutoEncoder.pretrainLossGivenMask`, that
takes the corruption mask explicitly; :meth:`AutoEncoder.pretrainLoss`
draws it from the ``torch.Generator`` it is given.
"""
from __future__ import annotations

import dataclasses

import torch

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["AutoEncoder"]


@register_layer
@dataclasses.dataclass
class AutoEncoder(BaseLayer):
    nIn: int = 0
    nOut: int = 0                      # hidden (code) size
    corruptionLevel: float = 0.3       # fraction of inputs zeroed
    sparsity: float = 0.0              # accepted for parity (unused)
    lossFunction: str = "mse"          # | "xent" (binary cross-entropy)

    isPretrainLayer = True

    def preferredFormat(self):
        # a FeedForwardLayer in the reference (BasePretrainNetwork)
        return "FF"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size

    def getOutputType(self, inputType):
        return InputType.feedForward(self.nOut)

    def weightParamKeys(self):
        return ("W",)

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        """W (nIn, nOut) from ``gen``, zero b (nOut,) and vb (nIn,), on
        ``device`` (``cuda`` unless the caller asks for another)."""
        dev = resolve_device(device)
        return {"W": init_weight(gen, (self.nIn, self.nOut), self.nIn,
                                 self.nOut, self.weightInit or "XAVIER",
                                 dtype, dev),
                "b": torch.zeros((self.nOut,), dtype=dtype, device=dev),
                "vb": torch.zeros((self.nIn,), dtype=dtype, device=dev)}

    # ------------------------------------------------------------------
    def _act(self):
        return get_activation(self.activation or "sigmoid")

    def encode(self, params, x):
        return self._act()(x @ params["W"] + params["b"])

    def decode(self, params, h):
        return self._act()(h @ params["W"].T + params["vb"])

    def forward(self, params, x, train, gen, state):
        # supervised mode: the encoder activation (reference activate())
        x = self._dropin(x, train, gen)
        return self.encode(params, x), state

    # ------------------------------------------------------------------
    def corruptionMask(self, x, gen):
        """The keep mask of the denoising corruption: True with
        probability ``1 - corruptionLevel``, drawn from ``gen`` on x's
        device; None when there is no corruption."""
        if not 0.0 < self.corruptionLevel < 1.0 or gen is None:
            return None
        return torch.rand(x.shape, generator=gen, device=x.device) < \
            1.0 - self.corruptionLevel

    def pretrainLoss(self, params, x, gen):
        """Reconstruction loss of the (corrupted-input) autoencoder — the
        quantity ``MultiLayerNetwork.pretrain`` minimizes; the corruption
        is drawn from ``gen``."""
        return self.pretrainLossGivenMask(params, x,
                                          self.corruptionMask(x, gen))

    def pretrainLossGivenMask(self, params, x, keep):
        """:meth:`pretrainLoss` with the keep mask given (None: no
        corruption)."""
        xc = x if keep is None else torch.where(
            torch.as_tensor(keep, device=x.device).bool(), x, 0.0)
        xr = self.decode(params, self.encode(params, xc))
        if self.lossFunction == "xent":
            eps = 1e-7
            xr = torch.clamp(xr, eps, 1.0 - eps)
            per = -torch.sum(x * torch.log(xr) + (1 - x) * torch.log(1 - xr),
                             dim=-1)
        else:
            per = torch.sum((x - xr) ** 2, dim=-1)
        return torch.mean(per)

    def reconstructionError(self, params, x):
        """Per-example clean reconstruction error (anomaly scoring)."""
        x = torch.as_tensor(x, device=params["W"].device)
        xr = self.decode(params, self.encode(params, x))
        return torch.sum((x - xr) ** 2, dim=-1)
