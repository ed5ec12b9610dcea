"""Encoder / decoder / classifier building blocks.

Port of ``joint_vae_tpu/models/layers.py`` (ref
module/vae_layers/layers.py): the encoder is an MLP with mu / log-var heads
(log-var clipped to +-20, or forced), an optional coded-sigma head and
optional one-hot label concatenation; the classifier is an MLP on z.
Submodule names follow the JAX parameter tree (``dense_projs``,
``dense_0``, ``head``...) so the weight bridge is a rename plus layouts.
"""

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.priors import PriorConfig
from ..parallel.mesh import draw_rows
from .conv import ACTIVATIONS

LOG_VAR_CLIP = 20.0


def onehot_encoding(y: torch.Tensor, num_labels: int,
                    dtype=torch.float32) -> torch.Tensor:
    """(...,) int -> (..., C) one-hot."""
    return F.one_hot(y.long(), num_labels).to(dtype)


class Dense(nn.Linear):
    """``nn.Linear`` computing in the model's compute dtype (flax
    ``nn.Dense(dtype=...)``): weight (out, in).  On a mesh that splits
    its outputs over 'model' (the classifier head), ``split``
    (``parallel/mesh.py::ClassSplit``) gathers the weight and bias rows
    where they are read."""

    split = None

    def __init__(self, in_features: int, out_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        w, b = self.weight, self.bias
        if self.split is not None:
            w = self.split.gather(w) if 'weight' in self.split.names else w
            b = self.split.gather(b) if 'bias' in self.split.names else b
        return F.linear(x.to(dt), w.to(dt), b.to(dt))


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: keep each element with probability
    1 - rate (a uniform draw from ``generator`` below 1 - rate) and scale
    the kept ones by 1 / (1 - rate); all zeros at rate 1.  On a mesh the
    draw is this rank's rows of the global batch's (``draw_rows``)."""
    if rate >= 1.0:
        return torch.zeros_like(x)
    keep = 1.0 - rate
    u = draw_rows(lambda s: torch.rand(s, generator=generator,
                                       device=x.device), x.shape)
    return torch.where(u < keep, x / keep, torch.zeros_like(x))


class MLP(nn.Module):
    """Dense + activation (+ dropout in training) stack over the last
    axis."""

    def __init__(self, in_features: int, dims: Sequence[int],
                 activation: str = 'relu', dtype=torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dims = tuple(dims)
        self.act = ACTIVATIONS[activation]
        self.dropout = dropout
        d = in_features
        for i, o in enumerate(self.dims):
            self.add_module('dense_{}'.format(i), Dense(d, o, dtype))
            d = o
        self.out_features = d

    def forward(self, x: torch.Tensor, train: bool = False,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        for i in range(len(self.dims)):
            x = self.act(getattr(self, 'dense_{}'.format(i))(x))
            if train and self.dropout:
                x = dropout(x, self.dropout, generator)
        return x


class Encoder(nn.Module):
    """MLP encoder with mu / log-var (and optional sigma) heads.

    Input: flattened features (..., D), plus one-hot labels (..., C)
    concatenated when ``y_is_coded``.  Output (mu, log_var, sigma-or-None)."""

    def __init__(self, input_dim: int, latent_dim: int, num_labels: int,
                 intermediate_dims: Sequence[int] = (64,),
                 y_is_coded: bool = False, activation: str = 'relu',
                 sigma_output_dim: int = 0, forced_variance: float = 0.0,
                 dtype=torch.float32, dropout: float = 0.0):
        super().__init__()
        self.y_is_coded = y_is_coded
        self.num_labels = num_labels
        self.forced_variance = forced_variance
        d_in = input_dim + (num_labels if y_is_coded else 0)
        self.dense_projs = MLP(d_in, intermediate_dims, activation, dtype,
                               dropout)
        u = self.dense_projs.out_features
        self.dense_mean = Dense(u, latent_dim, dtype)
        if not forced_variance:
            self.dense_log_var = Dense(u, latent_dim, dtype)
        self.sigma = Dense(u, sigma_output_dim, dtype) if sigma_output_dim else None

    def forward(self, x: torch.Tensor, y_onehot: Optional[torch.Tensor] = None,
                train: bool = False,
                generator: Optional[torch.Generator] = None):
        if self.y_is_coded:
            if y_onehot is None:
                raise ValueError('y is supposed to be an input of the net')
            x = torch.cat([x, y_onehot.expand(x.shape[:-1] + (self.num_labels,))
                           .to(x.dtype)], dim=-1)
        u = self.dense_projs(x, train, generator)
        z_mean = self.dense_mean(u)
        if self.forced_variance:
            z_log_var = torch.full_like(z_mean, math.log(self.forced_variance))
        else:
            z_log_var = torch.clamp(self.dense_log_var(u),
                                    -LOG_VAR_CLIP, LOG_VAR_CLIP)
        sigma = self.sigma(u) if self.sigma is not None else None
        return z_mean, z_log_var, sigma


class Classifier(nn.Module):
    """MLP classifier on z."""

    def __init__(self, latent_dim: int, num_labels: int,
                 intermediate_dims: Sequence[int] = (),
                 activation: str = 'relu', dtype=torch.float32):
        super().__init__()
        self.dims = tuple(intermediate_dims)
        self.act = ACTIVATIONS[activation]
        d = latent_dim
        for i, o in enumerate(self.dims):
            self.add_module('dense_{}'.format(i), Dense(d, o, dtype))
            d = o
        self.head = Dense(d, num_labels, dtype)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.dims)):
            z = self.act(getattr(self, 'dense_{}'.format(i))(z))
        return self.head(z)


class PriorParams(nn.Module):
    """Holds the prior parameters ``mean`` (P, K) and ``var_param``.
    Calling it gives them whole; on a mesh that splits them over 'model'
    (``split``) they are gathered, and :meth:`local` gives this rank's
    block of classes instead."""

    split = None

    def __init__(self, cfg: PriorConfig):
        super().__init__()
        self.cfg = cfg
        self.mean = nn.Parameter(torch.zeros(cfg.num_priors, cfg.dim))
        self.var_param = nn.Parameter(torch.ones(cfg.var_param_shape))

    def forward(self):
        p = {'mean': self.mean, 'var_param': self.var_param}
        if self.split is not None:
            p = {k: self.split.gather(v) if k in self.split.names else v
                 for k, v in p.items()}
        return p

    def local(self):
        """(this rank's block of the parameters, the gather along the class
        axis) when the classes are split over 'model', else None."""
        sp = self.split
        if sp is None or not self.cfg.conditional or 'mean' not in sp.names:
            return None
        return {'mean': self.mean, 'var_param': self.var_param}, sp.gather


def capacity(prior_mean: torch.Tensor, num_labels: int) -> torch.Tensor:
    """Upper bound of I(Z;Y) from the class dictionary."""
    m = prior_mean
    d2 = torch.sum(torch.square(m[:, None] - m[None]), dim=-1)
    return (np.log(num_labels)
            - torch.sum(torch.log(torch.sum(torch.exp(-d2 / 4), dim=0)))
            / num_labels)


def dict_min_distance(prior_mean: torch.Tensor) -> torch.Tensor:
    """Minimal pairwise distance between class means."""
    C = prior_mean.shape[0]
    d = torch.sqrt(torch.clamp(
        torch.sum(torch.square(prior_mean[:, None] - prior_mean[None]), dim=-1),
        min=0.0))
    max_norm = torch.amax(torch.linalg.vector_norm(prior_mean, dim=1))
    eye = torch.eye(C, dtype=prior_mean.dtype, device=prior_mean.device)
    return torch.amin(d + 2 * max_norm * eye)
