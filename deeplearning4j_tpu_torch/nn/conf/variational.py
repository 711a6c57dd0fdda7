"""Variational autoencoder layer — the port of
``deeplearning4j_tpu/nn/conf/variational.py`` (the reference's
deeplearning4j-nn ``conf/layers/variational/VariationalAutoencoder`` +
``layers/variational/VariationalAutoencoder.java``: the unsupervised
pretrain layer behind the anomaly-detection workflow).

An encoder MLP gives (mean, logvar) of q(z|x); the supervised forward
outputs the MEAN of q(z|x) (the reference's activate()); ``pretrainLoss``
is the negative ELBO with the reparameterization trick;
``reconstructionLogProbability`` is the importance-sampling estimate used
for anomaly scoring; ``generateAtMeanGivenZ`` decodes a latent point.
Reconstruction distributions: "gaussian" (the decoder emits mean and
logvar per feature) and "bernoulli" (logits).

torch cannot draw the reference's ``jax.random.normal(fold_in(key, s))``
bits, so each sampled quantity has an inner form that takes ε explicitly
(:meth:`VariationalAutoencoder.pretrainLossGivenNoise`,
:meth:`VariationalAutoencoder.reconstructionLogProbabilityGivenNoise`);
the public methods draw ε from the ``torch.Generator`` they are given.

Unlike the reference, which leaves this class out of its layer registry
(so its JSON does not load there, ROADMAP C20), the port registers it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch import resolve_device
from deeplearning4j_tpu_torch.nn.activations import get_activation
from deeplearning4j_tpu_torch.nn.conf.inputs import InputType
from deeplearning4j_tpu_torch.nn.conf.layers import BaseLayer, register_layer
from deeplearning4j_tpu_torch.nn.weights import init_weight

__all__ = ["VariationalAutoencoder"]

_LOG2PI = 1.8378770664093453


@register_layer
@dataclasses.dataclass
class VariationalAutoencoder(BaseLayer):
    nIn: int = 0
    nOut: int = 0                                   # latent size
    encoderLayerSizes: Tuple[int, ...] = (100,)
    decoderLayerSizes: Tuple[int, ...] = (100,)
    reconstructionDistribution: str = "gaussian"    # | "bernoulli"
    numSamples: int = 1

    isPretrainLayer = True

    def preferredFormat(self):
        # a FeedForwardLayer in the reference: CNN input auto-inserts
        # CnnToFeedForward (BasePretrainNetwork extends FeedForwardLayer)
        return "FF"

    def inferNIn(self, inputType):
        if not self.nIn:
            self.nIn = inputType.size

    def getOutputType(self, inputType):
        return InputType.feedForward(self.nOut)

    def weightParamKeys(self):
        return tuple(k for k in self._param_shapes() if k.startswith("W"))

    # ------------------------------------------------------------------
    def _param_shapes(self):
        shapes = {}
        prev = self.nIn
        for i, h in enumerate(self.encoderLayerSizes):
            shapes[f"We{i}"] = (prev, h)
            shapes[f"be{i}"] = (h,)
            prev = h
        shapes["Wmean"] = (prev, self.nOut)
        shapes["bmean"] = (self.nOut,)
        shapes["Wlogvar"] = (prev, self.nOut)
        shapes["blogvar"] = (self.nOut,)
        prev = self.nOut
        for i, h in enumerate(self.decoderLayerSizes):
            shapes[f"Wd{i}"] = (prev, h)
            shapes[f"bd{i}"] = (h,)
            prev = h
        outw = 2 * self.nIn if self.reconstructionDistribution == \
            "gaussian" else self.nIn
        shapes["Wout"] = (prev, outw)
        shapes["bout"] = (outw,)
        return shapes

    def initParams(self, gen, inputType, dtype=torch.float32, device=None):
        """The weights of :meth:`_param_shapes` drawn from ``gen`` in that
        order, the biases zero, on ``device`` (``cuda`` unless the caller
        asks for another)."""
        dev = resolve_device(device)
        wi = self.weightInit or "XAVIER"
        return {name: init_weight(gen, shape, shape[0], shape[-1], wi, dtype,
                                  dev)
                if name.startswith("W") else
                torch.zeros(shape, dtype=dtype, device=dev)
                for name, shape in self._param_shapes().items()}

    # ------------------------------------------------------------------
    def _encode(self, p, x):
        act = get_activation(self.activation or "relu")
        h = x
        for i in range(len(self.encoderLayerSizes)):
            h = act(h @ p[f"We{i}"] + p[f"be{i}"])
        return h @ p["Wmean"] + p["bmean"], h @ p["Wlogvar"] + p["blogvar"]

    def _decode(self, p, z):
        act = get_activation(self.activation or "relu")
        h = z
        for i in range(len(self.decoderLayerSizes)):
            h = act(h @ p[f"Wd{i}"] + p[f"bd{i}"])
        return h @ p["Wout"] + p["bout"]

    def _recon_logprob(self, dec_out, x):
        if self.reconstructionDistribution == "bernoulli":
            return torch.sum(x * F.logsigmoid(dec_out)
                             + (1 - x) * F.logsigmoid(-dec_out), -1)
        mean, logvar = torch.chunk(dec_out, 2, dim=-1)
        logvar = torch.clamp(logvar, -10.0, 10.0)
        return torch.sum(-0.5 * (_LOG2PI + logvar
                                 + (x - mean) ** 2 / torch.exp(logvar)), -1)

    def forward(self, params, x, train, gen, state):
        # supervised mode: the activation is the MEAN of q(z|x)
        # (reference VariationalAutoencoder.activate)
        x = self._dropin(x, train, gen)
        mean, _ = self._encode(params, x)
        return mean, state

    @staticmethod
    def _noise(like, n, gen):
        """``n`` standard normal draws of ``like``'s shape from ``gen``."""
        return torch.randn((n, *like.shape), generator=gen,
                           device=like.device, dtype=like.dtype)

    def _as_input(self, params, x):
        return torch.as_tensor(x, device=params["Wmean"].device,
                               dtype=params["Wmean"].dtype)

    # ------------------------------------------------------------------
    def pretrainLoss(self, params, x, gen):
        """Negative ELBO (mean over the batch), reparameterized with
        ``numSamples`` draws of ε from ``gen`` — the quantity
        ``MultiLayerNetwork.pretrain`` minimizes."""
        mean, logvar = self._encode(params, x)
        eps = self._noise(mean, max(1, self.numSamples), gen)
        return self._elbo_loss(params, x, mean, logvar, eps)

    def pretrainLossGivenNoise(self, params, x, eps):
        """:meth:`pretrainLoss` with ε given: (numSamples, b, nOut)."""
        mean, logvar = self._encode(params, x)
        eps = torch.as_tensor(eps, device=mean.device, dtype=mean.dtype)
        return self._elbo_loss(params, x, mean, logvar, eps)

    def _elbo_loss(self, params, x, mean, logvar, eps):
        total = 0.0
        for e in eps:
            z = mean + torch.exp(0.5 * logvar) * e
            total = total + self._recon_logprob(self._decode(params, z), x)
        recon = total / len(eps)
        kl = 0.5 * torch.sum(torch.exp(logvar) + mean ** 2 - 1.0 - logvar,
                             -1)
        return torch.mean(kl - recon)

    def reconstructionLogProbability(self, params, x, numSamples: int = 16,
                                     gen=None):
        """Importance-sampling estimate of log p(x) per example (reference
        API — the anomaly-detection score; higher = more 'normal'), ε
        drawn from ``gen`` (default: a generator seeded 0 on the
        parameters' device)."""
        x = self._as_input(params, x)
        mean, _ = self._encode(params, x)
        if gen is None:
            gen = torch.Generator(device=mean.device).manual_seed(0)
        return self.reconstructionLogProbabilityGivenNoise(
            params, x, self._noise(mean, numSamples, gen))

    def reconstructionLogProbabilityGivenNoise(self, params, x, eps):
        """:meth:`reconstructionLogProbability` with ε given:
        (numSamples, b, nOut)."""
        x = self._as_input(params, x)
        mean, logvar = self._encode(params, x)
        eps = torch.as_tensor(eps, device=mean.device, dtype=mean.dtype)
        comps = []
        for e in eps:
            z = mean + torch.exp(0.5 * logvar) * e
            log_px_z = self._recon_logprob(self._decode(params, z), x)
            log_pz = torch.sum(-0.5 * (_LOG2PI + z ** 2), -1)
            log_qz = torch.sum(-0.5 * (_LOG2PI + logvar + e ** 2), -1)
            comps.append(log_px_z + log_pz - log_qz)
        stacked = torch.stack(comps)
        return torch.logsumexp(stacked, dim=0) - math.log(float(len(eps)))

    def generateAtMeanGivenZ(self, params, z):
        """Decode latent points to the reconstruction-distribution mean."""
        dec = self._decode(params, self._as_input(params, z))
        if self.reconstructionDistribution == "bernoulli":
            return torch.sigmoid(dec)
        mean, _ = torch.chunk(dec, 2, dim=-1)
        return mean
