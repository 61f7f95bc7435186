"""Shared building blocks.

Layers keep float32 parameters and take the compute dtype as an argument,
casting weights at use.  Initialization follows torch defaults and is
drawn from an explicit ``torch.Generator`` by ``init_parameters_``:

* Linear/Conv/ConvTranspose weights and biases U(-1/sqrt(fan_in),
  1/sqrt(fan_in)), fan_in as torch reckons it;
* GRU weights and biases U(-1/sqrt(H), 1/sqrt(H));
* embeddings N(0, 1);
* layers marked ``init = "kaiming_normal_fan_out"`` (the SE-ResNet convs)
  N(0, 2/fan_out); ``init = "normal_0.01"`` (the TCN decoder) N(0, 0.01^2)
  with a zero bias; modules marked ``init = "normal_1/n"`` (the seq2seq
  attention's ``v``) each of their own parameters N(0, 1/n), n its size;
* weight-normed convs: v as a conv weight, g = ||v|| per output channel;
* batch norm keeps its constructor's scale 1, shift 0, running mean 0 and
  running var 1.
"""

from __future__ import annotations

import contextlib
import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from ha2g_torch.parallel.mesh import current_mesh, draw_rows


class Linear(nn.Linear):
    def forward(self, x, dtype: torch.dtype = torch.float32):
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.linear(x.to(dtype), self.weight.to(dtype), bias)


class Conv1d(nn.Conv1d):
    """Conv1d on (B, C, T)."""

    def forward(self, x, dtype: torch.dtype = torch.float32):
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


class Conv2d(nn.Conv2d):
    """Conv2d on (B, C, H, W)."""

    def forward(self, x, dtype: torch.dtype = torch.float32):
        bias = None if self.bias is None else self.bias.to(dtype)
        return self._conv_forward(x.to(dtype), self.weight.to(dtype), bias)


class ConvTranspose1d(nn.ConvTranspose1d):
    """ConvTranspose1d on (B, C, T)."""

    def forward(self, x, dtype: torch.dtype = torch.float32):
        bias = None if self.bias is None else self.bias.to(dtype)
        return F.conv_transpose1d(x.to(dtype), self.weight.to(dtype), bias,
                                  self.stride, self.padding,
                                  self.output_padding, self.groups,
                                  self.dilation)


class BatchNorm(nn.BatchNorm2d):
    """Batch norm over axis 1 (any rank), normalising in float32 and casting
    back to the compute dtype, eps 1e-5.

    Eval mode uses the running statistics.  Training mode is the JAX
    package's flax BatchNorm (momentum 0.9, torch's 0.1) with its sync-BN:
    statistics over the whole global batch.  In one process (or a mesh of
    one rank) that is the batch at hand, through torch's fused
    ``F.batch_norm``.  Under a mesh of several ranks they are taken in two
    passes, the mean from the sum and then the biased variance from the
    centred squares, each sum a differentiable all-reduce over the ranks,
    so every rank normalises with the global batch's statistics.  This
    holds only inside ``Mesh.part`` (the ``distributed_step`` around every
    system's ``train_step``): a forward outside it takes this rank's own
    statistics.  The running variance is updated with the biased variance
    (torch's own update would take the unbiased one), so the running
    statistics are updated here by hand, alike on every rank.
    ``update_stats`` False (``keep_running_stats``) normalises with the
    batch's statistics all the same and leaves the running ones alone, as
    the JAX package's auxiliary train-mode forwards do.
    """

    update_stats = True

    def forward(self, x, dtype: torch.dtype = torch.float32):
        xf = x.float()
        if not self.training:
            out = F.batch_norm(xf, self.running_mean, self.running_var,
                               self.weight, self.bias, False, 0.0, self.eps)
            return out.to(dtype)
        dims = [0, *range(2, xf.dim())]
        mesh = current_mesh()
        if mesh is None or mesh.world == 1:
            out = F.batch_norm(xf, None, None, self.weight, self.bias, True,
                               0.0, self.eps)
            if self.update_stats:
                with torch.no_grad():
                    var, mean = torch.var_mean(xf, dim=dims, unbiased=False)
                    self._update_running(mean, var)
            return out.to(dtype)
        shape = [1, -1] + [1] * (xf.dim() - 2)
        n = xf.numel() // xf.shape[1] * mesh.world
        mean = mesh.all_reduce(xf.sum(dims)) / n
        centred = xf - mean.view(shape)
        var = mesh.all_reduce((centred * centred).sum(dims)) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        out = centred * scale.view(shape) + self.bias.view(shape)
        if self.update_stats:
            with torch.no_grad():
                self._update_running(mean, var)
        return out.to(dtype)

    def _update_running(self, mean, var) -> None:
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(m * mean)
        self.running_var.mul_(1.0 - m).add_(m * var)


@contextlib.contextmanager
def keep_running_stats(module: nn.Module):
    """Within the block, no BatchNorm under ``module`` updates its running
    statistics (a train-mode forward whose statistics the JAX package
    throws away, ``mutable=False``)."""
    norms = [m for m in module.modules() if isinstance(m, BatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


def dropout(x, p: float, training: bool, generator: torch.Generator | None):
    """flax-style inverted dropout whose keep mask (probability 1 - p) is
    drawn from ``generator`` on its own device and moved to x's, so a CPU
    generator gives the same mask whatever device the model runs on; x's
    axis 0 is the batch, and a part of a global batch keeps its rows of the
    global batch's mask (``parallel.mesh.draw_rows``).  A no-op unless
    training with p > 0; then a generator is required."""
    if not training or p == 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in training mode needs a torch.Generator")
    keep = draw_rows(x.shape, lambda shape: torch.rand(
        shape, generator=generator, device=generator.device)) >= p
    return torch.where(keep.to(x.device), x / (1.0 - p), 0.0)


def leaky_relu(x, slope: float):
    return torch.where(x >= 0, x, slope * x)


def reparameterize(mu, logvar, generator: torch.Generator):
    """mu + eps * exp(logvar / 2), eps ~ N(0, I) drawn from ``generator`` on
    its own device and moved to mu's (so a CPU generator gives the same
    draw whatever device the model runs on); a part of a global batch keeps
    its rows of the global batch's draw."""
    std = torch.exp(0.5 * logvar)
    eps = draw_rows(std.shape, lambda shape: torch.randn(
        shape, generator=generator, device=generator.device,
        dtype=torch.float32))
    return mu + eps.to(device=std.device, dtype=std.dtype) * std


def _uniform_(t: torch.Tensor, bound: float, g: torch.Generator):
    t.uniform_(-bound, bound, generator=g)


@torch.no_grad()
def init_parameters_(root: nn.Module, generator: torch.Generator) -> None:
    """Initialize every parameter and buffer under ``root`` in a fixed module
    order from ``generator`` (parameters must lie on its device)."""
    from ha2g_torch.models.tcn import WeightNormConv1d
    from ha2g_torch.ops.gru import _GRUParams

    g = generator
    for m in root.modules():
        mode = getattr(m, "init", None)
        if isinstance(m, (nn.Linear, nn.Conv1d, nn.Conv2d,
                          nn.ConvTranspose1d)):
            # a transposed conv's weight is (in, out, k); torch takes its
            # fan-in from out * k all the same
            fan_in = m.weight[0].numel()
            if mode == "kaiming_normal_fan_out":
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out), generator=g)
            elif mode == "normal_0.01":
                m.weight.normal_(0.0, 0.01, generator=g)
            else:
                _uniform_(m.weight, 1.0 / math.sqrt(fan_in), g)
            if m.bias is not None:
                if mode == "normal_0.01":
                    m.bias.zero_()
                else:
                    _uniform_(m.bias, 1.0 / math.sqrt(fan_in), g)
        elif isinstance(m, nn.Embedding):
            m.weight.normal_(0.0, 1.0, generator=g)
        elif isinstance(m, WeightNormConv1d):
            fan_in = m.weight_v[0].numel()
            _uniform_(m.weight_v, 1.0 / math.sqrt(fan_in), g)
            m.weight_g.copy_(m.weight_v.flatten(1).norm(dim=1).view(-1, 1, 1))
            _uniform_(m.bias, 1.0 / math.sqrt(fan_in), g)
        elif isinstance(m, _GRUParams):
            for p in m.parameters(recurse=False):
                _uniform_(p, 1.0 / math.sqrt(m.hidden_size), g)
        elif mode == "normal_1/n":
            for p in m.parameters(recurse=False):
                p.normal_(0.0, 1.0 / math.sqrt(p.numel()), generator=g)
