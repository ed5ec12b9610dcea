"""The plain reference of the benchmark's configurations: a joint
(conditional) VAE with conv features, an MLP encoder and decoder, a deconv
imager, a learned class-conditional gaussian prior with a scalar variance
per class, and the per-class IWAE estimate (the reference project's
``cvae.py``, its published ``mean(exp(delta)) + max`` form).

Plain PyTorch on NCHW tensors: ``F.conv2d`` for every conv,
``F.conv_transpose2d`` for every deconv, whatever lowering the program
uses.  It imports nothing of the program and takes only what the
benchmark makes from the seed (``harness/inputs.py``): the weights, in
their canonical layouts (a conv or deconv kernel ``(k, k, ci, co)``
correlation-oriented, a dense weight ``(out, in)``), the images and the
latent noise.  It computes in float32 (the caller sets TF32 off, or on for
the control), but for the few sums the configuration's program takes in
float64 (the KL's variance term, a difference of sums of K terms near 1).
"""

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

LOG_2PI = math.log(2 * math.pi)
LOG_VAR_CLIP = 20.0
ACT = {'relu': torch.relu, 'sigmoid': torch.sigmoid, 'linear': lambda x: x,
       None: lambda x: x}


def stack(W: Dict[str, torch.Tensor], prefix: str, layers, x: torch.Tensor
          ) -> torch.Tensor:
    """A conv stack (``features_stack`` or ``imager``) on NCHW ``x``."""
    for i, ly in enumerate(layers):
        t = ly['type']
        if t in ('conv', 'deconv'):
            name = '{}.{}_{}'.format(prefix, t, i)
            k, b = W[name + '.weight'], W[name + '.bias']
            if t == 'conv':
                x = F.conv2d(x, k.permute(3, 2, 0, 1), b, stride=ly['stride'],
                             padding=ly['pad'])
            else:
                x = F.conv_transpose2d(
                    x, torch.flip(k, (0, 1)).permute(2, 3, 0, 1), b,
                    stride=ly['stride'], padding=ly['pad'],
                    output_padding=ly.get('output_pad', 0))
            x = ACT[ly['act']](x)
        elif t == 'maxpool':
            x = F.max_pool2d(x, ly['k'], ly['stride'])
        else:
            x = F.avg_pool2d(x, ly['k'], ly['stride'])
    return x


def mlp(W, prefix: str, dims, u: torch.Tensor) -> torch.Tensor:
    for j in range(len(dims)):
        name = '{}.dense_{}'.format(prefix, j)
        u = torch.relu(F.linear(u, W[name + '.weight'], W[name + '.bias']))
    return u


def dense(W, name: str, u: torch.Tensor) -> torch.Tensor:
    return F.linear(u, W[name + '.weight'], W[name + '.bias'])


def encode(W, cfg, x: torch.Tensor):
    """x (N, C, H, W) in [0, 1] -> (mu, log_var), each (N, K)."""
    t = stack(W, 'features_stack', cfg['features_layers'], x)
    u = mlp(W, 'encoder.dense_projs', cfg['encoder'], t.flatten(1))
    mu = dense(W, 'encoder.dense_mean', u)
    log_var = torch.clamp(dense(W, 'encoder.dense_log_var', u),
                          -LOG_VAR_CLIP, LOG_VAR_CLIP)
    return mu, log_var


def decode(W, cfg, z: torch.Tensor) -> torch.Tensor:
    """z (..., K) -> reconstructions (..., C, H, W)."""
    lead = z.shape[:-1]
    u = mlp(W, 'decoder', cfg['decoder'], z.reshape(-1, z.shape[-1]))
    u = u.reshape((-1,) + tuple(cfg['imager_input']))
    out = stack(W, 'imager', cfg['imager_layers'], u)
    return out.reshape(lead + out.shape[1:])


def classify(W, cfg, z: torch.Tensor) -> torch.Tensor:
    u = mlp(W, 'classifier', cfg['classifier'], z)
    return dense(W, 'classifier.head', u)


def log_sigma(W, cfg) -> torch.Tensor:
    """log sigma of the output noise (a learned parameter or the
    configuration's constant)."""
    if cfg['sigma']['learned']:
        return W['sigma_param'].reshape(())
    return torch.log(torch.tensor(float(cfg['sigma']['value']),
                                  dtype=torch.float32,
                                  device=W['prior.mean'].device))


def reconstruction_terms(W, cfg, x: torch.Tensor, z_samples: torch.Tensor,
                         block: int = 0) -> torch.Tensor:
    """wmse per sample and image (S, N): the mean over pixels of
    ((x_reco - x) / sigma)^2, decoding ``block`` samples at a time (all at
    once for 0)."""
    sig = torch.exp(log_sigma(W, cfg))
    S = z_samples.shape[0]
    block = block or S
    out = []
    for s in range(0, S, block):
        xr = decode(W, cfg, z_samples[s:s + block])
        out.append(torch.mean(torch.square(xr / sig - x / sig),
                              dim=(-3, -2, -1)))
    return torch.cat(out)


def gaussian_kl(cfg, mean, vp, mu, log_var, y: Optional[torch.Tensor]):
    """KL(q(z|x) || p(z|c)) by its parts, for the class ``y`` of each
    input (N,), or for every class (C, N) when ``y`` is None."""
    K = cfg['latent_dim']
    lv64 = log_var.double()
    s2 = torch.square(vp)                                       # (C,)
    sum_var = torch.sum(torch.exp(lv64), dim=-1)                # (N,)
    log_det = torch.sum(lv64, dim=-1)
    ldp = -2.0 * K * torch.log(vp.double())                     # (C,)
    if y is None:
        dist = torch.sum(torch.square(mu[None] - mean[:, None]), -1) \
            * s2[:, None]                                       # (C, N)
        var_kl = (s2.double()[:, None] * sum_var[None] - log_det[None]
                  + ldp[:, None] - K).float()
    else:
        dist = torch.sum(torch.square(mu - mean[y]), -1) * s2[y]
        var_kl = (s2.double()[y] * sum_var - log_det + ldp[y] - K).float()
    return dist, var_kl, 0.5 * (dist + var_kl)


def score_batch(W, cfg, x: torch.Tensor, eps: torch.Tensor,
                methods, block: int = 0) -> Dict[str, torch.Tensor]:
    """What a scorer gives for a batch without labels: the label (argmax
    over classes of the IWAE estimate), the classifier's confidence (its
    top softmax, the logits averaged over the L samples), each method's
    score, the per-class losses it comes from and each image's least KL
    over the classes (the scale of ``soft``'s rounding).  ``eps`` (L+1, N, K)
    with row 0 zero."""
    D = x.shape[-1] * x.shape[-2] * x.shape[-3]
    K, C = cfg['latent_dim'], cfg['num_labels']
    mean, vp = W['prior.mean'], W['prior.var_param']
    mu, log_var = encode(W, cfg, x)
    z = mu[None] + torch.exp(0.5 * log_var)[None] * eps        # (L+1, N, K)
    z1 = z[1:]
    L = z1.shape[0]
    wmse_l = reconstruction_terms(W, cfg, x, z1, block)         # (L, N)
    ls = D * log_sigma(W, cfg)
    cross_x = 0.5 * D * (torch.mean(wmse_l, 0) + LOG_2PI) + ls
    log_iws = -0.5 * D * (wmse_l + LOG_2PI) - ls
    dist, _, kl = gaussian_kl(cfg, mean, vp, mu, log_var, None)
    total = cross_x[None] + cfg['beta'] * kl                    # (C, N)
    log_inv_q = (0.5 * (torch.sum(torch.square(eps[1:]), -1)
                        + torch.sum(log_var, -1)) + 0.5 * K * LOG_2PI)
    log_pxq = log_iws + log_inv_q                               # (L, N)
    s2 = torch.square(vp)
    ldp = -2.0 * K * torch.log(vp)
    iws = torch.empty((C, x.shape[0]), dtype=torch.float32, device=x.device)
    for c in range(C):
        lw = (log_pxq - 0.5 * K * LOG_2PI - 0.5 * ldp[c]
              - 0.5 * s2[c] * torch.sum(torch.square(z1 - mean[c]), -1))
        m = torch.amax(lw, 0)
        iws[c] = torch.mean(torch.exp(lw - m[None]), 0) + m
    logits = torch.mean(classify(W, cfg, z)[1:], 0) if L > 1 \
        else classify(W, cfg, z)[0]
    conf = torch.amax(torch.softmax(logits, -1), -1)
    logp = -total
    elbo = torch.amax(logp, 0)
    m_iws = torch.amax(iws, 0)
    score = {'elbo': elbo,
             'iws': torch.log(torch.sum(torch.exp(iws - m_iws[None]), 0))
             + m_iws + math.log(C),
             'zdist': torch.amax(-dist, 0),
             'mse': -cross_x,
             'soft': torch.amax(torch.softmax(-kl, 0), 0)}
    out = {'label': torch.argmax(iws, 0), 'confidence': conf, 'iws': iws,
           'kl_top': torch.amin(kl, 0),
           'scores': {m: score[m[:-3] if m.endswith('-2s') else m]
                      for m in methods}}
    return out


def train_loss(W, cfg, x: torch.Tensor, y: torch.Tensor,
               eps: torch.Tensor) -> torch.Tensor:
    """The batch mean of the training objective: the reconstruction's
    gaussian log-likelihood, gamma times the classifier's cross entropy
    (over every sample, the mean one too) and beta times the KL to the
    input's class prior.  ``eps`` (L+1, N, K), row 0 zero."""
    D = x.shape[-1] * x.shape[-2] * x.shape[-3]
    mu, log_var = encode(W, cfg, x)
    z = mu[None] + torch.exp(0.5 * log_var)[None] * eps
    wmse = torch.mean(reconstruction_terms(W, cfg, x, z[1:]), 0)
    cross_x = 0.5 * D * (wmse + LOG_2PI) + D * log_sigma(W, cfg)
    _, _, kl = gaussian_kl(cfg, W['prior.mean'], W['prior.var_param'], mu,
                           log_var, y)
    logp = torch.log_softmax(classify(W, cfg, z), -1)           # (L+1, N, C)
    cross_y = -torch.mean(torch.gather(
        logp, -1, y[None, :, None].expand(logp.shape[0], -1, 1))[..., 0], 0)
    total = cross_x + cfg['gamma'] * cross_y + cfg['beta'] * kl
    return torch.mean(total)


def trained_names(cfg, W) -> list:
    """The parameters a step moves: all but the prior's scalar variances
    (not learned in these configurations)."""
    return [k for k in W if k != 'prior.var_param']
