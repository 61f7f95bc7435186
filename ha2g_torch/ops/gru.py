"""Multi-layer GRUs, batch-first, and the GRU cell stack of the seq2seq
decoder.

The port of ha2g_tpu/ops/gru.py (``GRU``, ``GRUCell``) with torch.nn.GRU's
parameter names (``weight_ih_l{l}``, ``weight_hh_l{l}``, ``bias_*`` and,
bidirectional, their ``_reverse`` twins), so the reference's state dicts
load directly:

* the input projection of all steps (and both directions) is one product,
  hoisted out of the recurrence;
* bidirectional: direction 1 reads the time-reversed stream, so both
  directions run in one recurrence, kernel B1 (``ops/gru_kernel.py``),
  differentiable through ``gru_recurrence_fn`` (kernel B1 forward, B1's
  backward kernel); outputs are re-reversed and concatenated [forward,
  backward];
* unidirectional (the joint embedding's context GRU): the JAX package runs
  this recurrence in ``lax.scan`` outside any Pallas kernel, and so does the
  port in plain PyTorch ops (``gru_step``), autograd giving the gradient;
* the final hidden state is layer-major, direction-minor, as torch's;
* dropout sits between layers (a no-op in eval mode), its masks drawn
  from the caller's generator.

``gru_step`` is one step's gate math with B1's precision: gates in float32,
the new hidden state rounded to the compute dtype.  ``GRUCell`` is the
unidirectional stack of single steps that the seq2seq decoder interleaves
with its attention (reference seq2seq_net.py:127,181).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ha2g_torch.models.common import dropout
from ha2g_torch.ops.gru_kernel import gru_recurrence_fn
from ha2g_torch.utils.spans import span

_SUFFIXES = ("", "_reverse")


def gru_step(xp_t, h, w_hh, b_hh):
    """One GRU step in torch's gate order (r, z, n): xp_t (..., 3H) the
    input projection, h (..., H), w_hh (H, 3H), b_hh (3H,) -> the new h in
    h's dtype; gates in float32."""
    H = h.shape[-1]
    hf = h.float()
    hh = (h @ w_hh).float() + b_hh.float()
    x = xp_t.float()
    r = torch.sigmoid(x[..., :H] + hh[..., :H])
    z = torch.sigmoid(x[..., H:2 * H] + hh[..., H:2 * H])
    n = torch.tanh(x[..., 2 * H:] + r * hh[..., 2 * H:])
    return ((1.0 - z) * n + z * hf).to(h.dtype)


class _GRUParams(nn.Module):
    """The parameters of ``n_layers`` GRU layers of ``n_dirs`` directions
    under torch.nn.GRU's names."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int,
                 n_dirs: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self._suffixes = _SUFFIXES[:n_dirs]
        H = hidden_size
        for layer in range(n_layers):
            in_dim = input_size if layer == 0 else n_dirs * H
            for sfx in self._suffixes:
                for name, shape in (("weight_ih", (3 * H, in_dim)),
                                    ("weight_hh", (3 * H, H)),
                                    ("bias_ih", (3 * H,)),
                                    ("bias_hh", (3 * H,))):
                    self.register_parameter(f"{name}_l{layer}{sfx}",
                                            nn.Parameter(torch.empty(shape)))

    def layer_params(self, layer: int, dtype):
        """-> (w_ih (in, 3H), w_hh (H, 3H), b_ih (3H,), b_hh (3H,)) of one
        layer in ``dtype``; bidirectional, each with a leading direction
        axis (2, ...), contiguous as B1 reads them."""
        def param(name, transpose):
            ps = [getattr(self, f"{name}_l{layer}{sfx}")
                  for sfx in self._suffixes]
            ps = [p.t() if transpose else p for p in ps]
            if len(ps) == 1:
                return ps[0].to(dtype)
            return torch.stack(ps).to(dtype).contiguous()
        return (param("weight_ih", True), param("weight_hh", True),
                param("bias_ih", False), param("bias_hh", False))


class GRU(_GRUParams):
    """(B, T, input_size) -> ((B, T, D * H), final hidden (D * n_layers, B,
    H)), D = 2 when ``bidirectional`` (on kernel B1), else 1 (plain ops)."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int = 1,
                 dropout: float = 0.0, bidirectional: bool = True):
        super().__init__(input_size, hidden_size, n_layers,
                         2 if bidirectional else 1)
        self.bidirectional = bidirectional
        self.dropout = dropout

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        B, T, _ = x.shape
        D, H = len(self._suffixes), self.hidden_size
        inp = x.to(dtype)
        h0 = torch.zeros((D, B, H), dtype=dtype, device=x.device)
        finals = []
        for layer in range(self.n_layers):
            with span("ha2g.model.gru_layer", layer):
                w_ih, w_hh, b_ih, b_hh = self.layer_params(layer, dtype)
                if self.bidirectional:
                    xp = torch.einsum("btd,ndg->tnbg", inp, w_ih) \
                        + b_ih[None, :, None]
                    xp = torch.cat([xp[:, :1], xp[:, 1:].flip(0)], dim=1)
                    outs = gru_recurrence_fn(xp.contiguous(), h0, w_hh, b_hh)
                    layer_out = torch.cat([outs[:, 0], outs[:, 1].flip(0)],
                                          dim=-1)              # (T, B, 2H)
                    finals.append(outs[-1])
                else:
                    xp = (inp @ w_ih + b_ih).transpose(0, 1)   # (T, B, 3H)
                    h, steps = h0[0], []
                    for t in range(T):
                        h = gru_step(xp[t], h, w_hh, b_hh)
                        steps.append(h)
                    layer_out = torch.stack(steps)             # (T, B, H)
                    finals.append(h[None])
                inp = layer_out.transpose(0, 1)
                if layer < self.n_layers - 1:
                    inp = dropout(inp, self.dropout, self.training, generator)
        return inp, torch.cat(finals, dim=0)


class GRUCell(_GRUParams):
    """A unidirectional stack of single GRU steps: (x (B, in), h (n_layers,
    B, H)) -> (out (B, H), new h (n_layers, B, H)).  A caller that steps
    many times passes ``weights(dtype)``, taken once, to each step."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__(input_size, hidden_size, n_layers, 1)
        self.dropout = dropout

    def weights(self, dtype: torch.dtype) -> list:
        """Every layer's ``layer_params`` in ``dtype``."""
        return [self.layer_params(layer, dtype)
                for layer in range(self.n_layers)]

    def forward(self, x, h, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None,
                weights: list | None = None):
        inp, h = x.to(dtype), h.to(dtype)
        new_h = []
        for layer, (w_ih, w_hh, b_ih, b_hh) in enumerate(
                weights or self.weights(dtype)):
            h_new = gru_step(inp @ w_ih + b_ih, h[layer], w_hh, b_hh)
            new_h.append(h_new)
            inp = h_new
            if layer < self.n_layers - 1:
                inp = dropout(inp, self.dropout, self.training, generator)
        return inp, torch.stack(new_h)
