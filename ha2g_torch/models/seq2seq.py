"""The seq2seq text-to-gesture baseline (Yoon et al. ICRA'19; the port of
ha2g_tpu/models/seq2seq.py, reference scripts/model/seq2seq_net.py): a
bidirectional GRU text encoder over padded word sequences, Bahdanau
attention, and an autoregressive per-frame GRU decoder teacher-forced for
the first n_pre_poses frames.  The state dict has the reference's keys
(``encoder.embedding``, ``encoder.gru.*``, ``decoder.decoder.{attn,
pre_linear, gru, out}.*``), the layout of ``ha2g_tpu/export_torch.py::
export_seq2seq``.

**The masked encoder runs on kernel B1 unchanged.**  The JAX encoder
(``MaskedBiGRUEncoder``) feeds each direction a stream whose valid tokens
sit at positions [0, len): the forward stream as it is, the backward
stream reversed within each sequence (``rev_idx``, the identity beyond
len).  It freezes the carry at t >= len, so at t < len its outputs are an
unmasked recurrence's outputs there; its final hidden state is the output
at len - 1; its outputs at t >= len are zeroed.  So the port runs the
plain recurrence on the same two streams (``gru_recurrence_fn``: B1
forward, B1's backward kernel), un-reverses the backward half with the
same ``rev_idx``, zeroes t >= len and gathers both directions' finals at
len - 1.  The gradient is exact too: the steps t >= len get a zero
cotangent (their outputs are zeroed and no final is taken there), so the
backward carries zeros through them.  A length of 0 never occurs (the
word sequences hold SOS and EOS); the encoder asserts len >= 1.

The decoder copies the reference's quirks as the JAX package has them:
the decoder's hidden state starts from ``enc_hidden[:n_layers]`` (layer
0's forward and backward finals for two layers), frames t < n_pre_poses
are teacher-forced, the first output frame is ``poses[:, 0]``, and the
step's one ``BatchNorm`` is called once a step (33 times a forward): in
train mode each call normalises with its own batch statistics and updates
the running ones in turn.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from ha2g_torch.models.common import BatchNorm, Linear, dropout
from ha2g_torch.ops.gru import GRU, GRUCell
from ha2g_torch.ops.gru_kernel import gru_recurrence_fn


class MaskedBiGRUEncoder(nn.Module):
    """Padded tokens (B, S) and lengths (B,) -> (outputs (B, S, H), the
    directions summed and zero at t >= len; final hidden (2 n_layers, B,
    H), layer-major, direction-minor).  Always float32, as the JAX
    encoder."""

    def __init__(self, n_words: int, embed_dim: int, hidden_size: int,
                 n_layers: int = 2, dropout: float = 0.1):
        super().__init__()
        self.embedding = nn.Embedding(n_words, embed_dim)
        self.gru = GRU(embed_dim, hidden_size, n_layers, dropout=dropout)

    def forward(self, tokens, lengths,
                generator: torch.Generator | None = None):
        B, S = tokens.shape
        H = self.gru.hidden_size
        lengths = lengths.long()
        torch._assert_async(torch.all(lengths >= 1),
                            "every word sequence needs a length >= 1")
        t = torch.arange(S, device=tokens.device)
        valid = t[None] < lengths[:, None]                       # (B, S)
        rev_idx = torch.where(valid, lengths[:, None] - 1 - t[None], t[None])
        rev = rev_idx[..., None]
        last = (lengths - 1).view(1, 1, B, 1).expand(1, 2, B, H)
        h0 = torch.zeros((2, B, H), device=tokens.device)
        inp = self.embedding(tokens)
        finals = []
        for layer in range(self.gru.n_layers):
            w_ih, w_hh, b_ih, b_hh = self.gru.layer_params(layer,
                                                           torch.float32)
            streams = torch.stack([
                inp, torch.take_along_dim(inp, rev.expand_as(inp), dim=1)])
            xp = torch.einsum("nbtd,ndg->tnbg", streams, w_ih) \
                + b_ih[None, :, None]
            outs = gru_recurrence_fn(xp.contiguous(), h0, w_hh, b_hh)
            finals.append(torch.gather(outs, 0, last)[0])       # (2, B, H)
            fwd, bwd = outs[:, 0].transpose(0, 1), outs[:, 1].transpose(0, 1)
            bwd = torch.take_along_dim(bwd, rev.expand_as(bwd), dim=1)
            inp = torch.cat([fwd, bwd], dim=-1) * valid[..., None]
            if layer < self.gru.n_layers - 1:
                inp = dropout(inp, self.gru.dropout, self.training,
                              generator)
        return inp[..., :H] + inp[..., H:], torch.cat(finals, dim=0)


class Attn(nn.Module):
    """Bahdanau additive attention (seq2seq_net.py:59-89): hidden (B, H),
    encoder outputs (B, S, H) -> weights (B, S), float32."""

    init = "normal_1/n"       # v ~ N(0, 1/H), the reference's

    def __init__(self, hidden_size: int):
        super().__init__()
        self.attn = Linear(2 * hidden_size, hidden_size)
        self.v = nn.Parameter(torch.empty(hidden_size))

    def forward(self, hidden, encoder_outputs,
                dtype: torch.dtype = torch.float32):
        h = hidden[:, None].expand(-1, encoder_outputs.shape[1], -1)
        energy = torch.tanh(self.attn(
            torch.cat([h.to(encoder_outputs.dtype), encoder_outputs], dim=2),
            dtype))
        scores = torch.einsum("bth,h->bt", energy.float(), self.v)
        return F.softmax(scores, dim=1)


class BahdanauDecoder(nn.Module):
    """One decoder step (seq2seq_net.py:94-187): attention context,
    pre-linear with batch norm and ReLU, the GRU cell stack, the output
    Linear.  Without the reference's optional speaker embedding, which no
    system of the JAX package builds."""

    def __init__(self, pose_dim: int, hidden_size: int, n_layers: int,
                 dropout: float):
        super().__init__()
        self.attn = Attn(hidden_size)
        self.pre_linear = nn.Sequential(Linear(pose_dim + hidden_size,
                                               hidden_size),
                                        BatchNorm(hidden_size), nn.ReLU())
        self.gru = GRUCell(hidden_size, hidden_size, n_layers, dropout)
        self.out = Linear(hidden_size, pose_dim)

    def forward(self, motion_input, last_hidden, encoder_outputs,
                dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None,
                cell_weights: list | None = None):
        """-> (pose (B, pose_dim) in ``dtype``, new hidden, attention
        weights); ``cell_weights`` the GRU cell's ``weights(dtype)``."""
        attn_w = self.attn(last_hidden[-1], encoder_outputs, dtype)
        context = torch.einsum("bt,bth->bh", attn_w, encoder_outputs.float())
        x = self.pre_linear[0](torch.cat([motion_input.float(), context],
                                         dim=1), dtype)
        x = F.relu(self.pre_linear[1](x, dtype))
        out, hidden = self.gru(x, last_hidden, dtype, generator,
                               cell_weights)
        return self.out(out, dtype), hidden, attn_w


class _Generator(nn.Module):
    """The reference's wrapper around the decoder step (seq2seq_net.py:
    192-216): its keys are ``decoder.decoder.*``."""

    def __init__(self, decoder: BahdanauDecoder):
        super().__init__()
        self.decoder = decoder


class Seq2SeqNet(nn.Module):
    """Text -> gesture seq2seq (seq2seq_net.py:217-254)."""

    def __init__(self, pose_dim: int, n_frames: int, n_words: int,
                 word_embed_dim: int = 300, hidden_size: int = 200,
                 n_layers: int = 2, dropout: float = 0.1,
                 n_pre_poses: int = 4):
        super().__init__()
        self.n_frames, self.n_pre_poses = n_frames, n_pre_poses
        self.n_layers = n_layers
        self.encoder = MaskedBiGRUEncoder(n_words, word_embed_dim,
                                          hidden_size, n_layers, dropout)
        self.decoder = _Generator(BahdanauDecoder(
            pose_dim, hidden_size, n_layers, dropout))

    def forward(self, in_text, text_lengths, poses,
                dtype: torch.dtype = torch.float32,
                generator: torch.Generator | None = None):
        """in_text (B, S) tokens, text_lengths (B,), poses (B, T,
        pose_dim) the teacher frames -> (B, T, pose_dim) float32."""
        enc_out, enc_hidden = self.encoder(in_text, text_lengths, generator)
        hidden = enc_hidden[:self.n_layers]
        step = self.decoder.decoder
        cell_weights = step.gru.weights(dtype)
        outputs = [poses[:, 0].float()]
        dec_in = poses[:, 0]
        for t in range(1, self.n_frames):
            out, hidden, _ = step(dec_in, hidden, enc_out, dtype,
                                  generator, cell_weights)
            outputs.append(out.float())
            dec_in = poses[:, t] if t < self.n_pre_poses else out
        return torch.stack(outputs, dim=1)
