"""Multi-layer bidirectional GRU, batch-first.

The port of ha2g_tpu/ops/gru.py::GRU with torch.nn.GRU's parameter names
(``weight_ih_l{l}``, ``weight_hh_l{l}``, ``bias_*`` and their ``_reverse``
twins), so the reference's state dicts load directly:

* the input projection of all steps and both directions is one product,
  hoisted out of the recurrence;
* direction 1 reads the time-reversed stream, so both directions run in
  one recurrence, kernel B1 (``ops/gru_kernel.py``);
* outputs are re-reversed and concatenated [forward, backward];
* the final hidden state is layer-major, direction-minor, as torch's;
* dropout sits between layers (a no-op in eval mode), its masks drawn
  from the caller's generator;
* the recurrence is differentiable (``gru_recurrence_fn``): kernel B1
  forward, a PyTorch-ops backward.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from ha2g_torch.models.common import dropout
from ha2g_torch.ops.gru_kernel import gru_recurrence_fn

_SUFFIXES = ("", "_reverse")


class GRU(nn.Module):
    """(B, T, input_size) -> ((B, T, 2H), final hidden (2*n_layers, B, H))."""

    def __init__(self, input_size: int, hidden_size: int, n_layers: int = 1,
                 dropout: float = 0.0):
        super().__init__()
        self.hidden_size = hidden_size
        self.n_layers = n_layers
        self.dropout = dropout
        H = hidden_size
        for layer in range(n_layers):
            in_dim = input_size if layer == 0 else 2 * H
            for sfx in _SUFFIXES:
                self.register_parameter(f"weight_ih_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * H, in_dim)))
                self.register_parameter(f"weight_hh_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * H, H)))
                self.register_parameter(f"bias_ih_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * H)))
                self.register_parameter(f"bias_hh_l{layer}{sfx}",
                                        nn.Parameter(torch.empty(3 * H)))

    def _stacked(self, name: str, layer: int, dtype, transpose: bool):
        ps = [getattr(self, f"{name}_l{layer}{sfx}") for sfx in _SUFFIXES]
        if transpose:
            ps = [p.t() for p in ps]
        return torch.stack(ps).to(dtype).contiguous()

    def forward(self, x: torch.Tensor, dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        B, T, _ = x.shape
        H = self.hidden_size
        inp = x.to(dtype)
        h0 = torch.zeros((2, B, H), dtype=dtype, device=x.device)
        finals = []
        for layer in range(self.n_layers):
            w_ih = self._stacked("weight_ih", layer, dtype, True)  # (2, in, 3H)
            w_hh = self._stacked("weight_hh", layer, dtype, True)  # (2, H, 3H)
            b_ih = self._stacked("bias_ih", layer, dtype, False)   # (2, 3H)
            b_hh = self._stacked("bias_hh", layer, dtype, False)
            xp = torch.einsum("btd,ndg->tnbg", inp, w_ih) + b_ih[None, :, None]
            xp = torch.cat([xp[:, :1], xp[:, 1:].flip(0)], dim=1).contiguous()
            outs = gru_recurrence_fn(xp, h0, w_hh, b_hh)       # (T, 2, B, H)
            finals.append(outs[-1])
            layer_out = torch.cat([outs[:, 0], outs[:, 1].flip(0)], dim=-1)
            inp = layer_out.transpose(0, 1)                     # (B, T, 2H)
            if layer < self.n_layers - 1:
                inp = dropout(inp, self.dropout, self.training, generator)
        return inp, torch.cat(finals, dim=0)
