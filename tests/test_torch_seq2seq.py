"""The seq2seq baseline of the port against the JAX package on the CPU in
fp32, TED Gesture at hidden 16 / 2 GRU layers / batch 4 / 10 frames, with
the weights and frozen randomness of tests/torch_text_baselines.py: the masked
bi-GRU encoder on ragged lengths (lengths 32 = the padded width and 2
among them; outputs, finals and their gradients within 1e-5), the
unidirectional GRU and the decoder's GRU cell stack against flax, the
whole net in eval and train mode (1e-4), one train step (the loss within
1e-5 relative; every gradient leaf, after the JAX system's own clip and
Adam, the 9 chained batch-norm updates, the post-Adam parameters at
tests/torch_train_parity.py's bounds, and Adam's second moments), a 3-window ``generate`` (with the
cubic smoothing across window joints) against the JAX synthesizer (1e-4),
and ``convert.seq2seq_state`` against ``ha2g_tpu.export_torch``
exactly.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import export_torch as et
from ha2g_tpu.models.seq2seq import MaskedBiGRUEncoder as JaxEncoder
from ha2g_tpu.ops.gru import GRU as JaxGRU
from ha2g_tpu.ops.gru import GRUCell as JaxGRUCell
from ha2g_tpu.synthesis import Seq2SeqSynthesizer as JaxSynthesizer
from tests.torch_baselines import N_WORDS, clips, vocabs
from tests.torch_text_baselines import (EMBED, HID, NL, S2S, S2S_POSES,
                                        WORD_SEQ, compare_second_moments,
                                        jax_setup, numpy_state, port_system,
                                        recorded_grads, train_batch,
                                        word_seqs, zero_grad_leaves)
from tests.torch_train_parity import compare_step

from ha2g_torch.convert import seq2seq_state
from ha2g_torch.ops.gru import GRU, GRUCell
from ha2g_torch.synthesis import make_synthesizer, polyfit_smooth
from ha2g_torch.train.baselines import clip_grad_norm_optax_

# the encoder: one recurrence in fp32 both sides (summation order)
ENCODER_ATOL = 1e-5
# whole modules: the attention, products and the decoder steps
ATOL = 1e-4
# the loss terms of one step, relative
METRIC_RTOL = 1e-5


def _encoder_io(seed):
    rng = np.random.default_rng(seed)
    tokens, lengths = word_seqs(rng, 6, [WORD_SEQ, 2, 17, 5, 31, 9])
    return tokens, lengths


def test_masked_encoder_matches_jax_on_ragged_lengths():
    """Outputs (zero past each length) and finals (the output at len - 1
    of both directions) of the port's encoder, B1's recurrence run on the
    per-sequence reversed stream, against the JAX package's masked scan;
    and the gradients of a weighted sum of both into the embedding table
    (the encoder's input) and every GRU weight."""
    _, state, _ = jax_setup(S2S)
    port = port_system(S2S).encoder
    params = state.params["MaskedBiGRUEncoder_0"]
    enc = JaxEncoder(n_words=N_WORDS, embed_dim=EMBED, hidden_size=HID,
                     n_layers=NL, dropout=0.0)
    tokens, lengths = _encoder_io(3)
    rng = np.random.default_rng(4)
    ct_out = rng.normal(size=(6, WORD_SEQ, HID)).astype(np.float32)
    ct_fin = rng.normal(size=(2 * NL, 6, HID)).astype(np.float32)

    def loss(p):
        out, fin = enc.apply({"params": p}, tokens, lengths)
        return jnp.sum(out * ct_out) + jnp.sum(fin * ct_fin), (out, fin)

    (_, (want_out, want_fin)), want_g = jax.jit(jax.value_and_grad(
        loss, has_aux=True))(params)
    out, fin = port(torch.from_numpy(tokens).long(),
                    torch.from_numpy(lengths))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=ENCODER_ATOL)
    np.testing.assert_allclose(fin.detach().numpy(), np.asarray(want_fin),
                               atol=ENCODER_ATOL)
    assert not out.detach().numpy()[1, 2:].any()     # length 2: zeros after
    ((out * torch.from_numpy(ct_out)).sum()
     + (fin * torch.from_numpy(ct_fin)).sum()).backward()
    np.testing.assert_allclose(port.embedding.weight.grad.numpy(),
                               np.asarray(want_g["embedding"]),
                               atol=ENCODER_ATOL)
    names = {"w_ih": "weight_ih", "w_hh": "weight_hh", "b_ih": "bias_ih",
             "b_hh": "bias_hh"}
    for layer in range(NL):
        for name, torch_name in names.items():
            have = np.stack([
                getattr(port.gru, f"{torch_name}_l{layer}{sfx}").grad.numpy()
                for sfx in ("", "_reverse")])
            want = np.asarray(want_g[f"{name}_l{layer}"])
            if name.startswith("w"):
                want = want.transpose(0, 2, 1)
            np.testing.assert_allclose(have, want, atol=ENCODER_ATOL,
                                       err_msg=f"{name}_l{layer}")


def test_encoder_rejects_a_zero_length():
    port = port_system(S2S).encoder
    tokens, lengths = _encoder_io(5)
    lengths[2] = 0
    with pytest.raises(RuntimeError, match="length >= 1"):
        port(torch.from_numpy(tokens).long(), torch.from_numpy(lengths))


def test_unidirectional_gru_and_cell_stack_match_jax():
    """``GRU(bidirectional=False)`` (plain recurrence, torch's key names
    without ``_reverse``) and ``GRUCell`` against flax on the same
    weights."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(3, 9, 5)).astype(np.float32)
    gru = GRU(5, 7, 2, bidirectional=False)
    cell = GRUCell(5, 7, 2)
    for m in (gru, cell):
        with torch.no_grad():
            for p in m.parameters():
                p.copy_(torch.from_numpy(rng.uniform(-0.4, 0.4, p.shape)
                                         .astype(np.float32)))
    assert all("reverse" not in k for k in gru.state_dict())

    def jax_params(m):
        out = {}
        for layer in range(2):
            for jn, tn in (("w_ih", "weight_ih"), ("w_hh", "weight_hh"),
                           ("b_ih", "bias_ih"), ("b_hh", "bias_hh")):
                v = getattr(m, f"{tn}_l{layer}").detach().numpy()
                out[f"{jn}_l{layer}"] = v.T if v.ndim == 2 else v
        return out

    p = jax_params(gru)
    want, want_h = jax.jit(JaxGRU(hidden_size=7, n_layers=2).apply)(
        {"params": {k: v[None] for k, v in p.items()}}, x)
    got, got_h = gru(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               atol=1e-5)
    h = rng.normal(size=(2, 3, 7)).astype(np.float32)
    want, want_h = jax.jit(JaxGRUCell(hidden_size=7, n_layers=2).apply)(
        {"params": jax_params(cell)}, x[:, 0], h)
    got, got_h = cell(torch.from_numpy(x[:, 0]), torch.from_numpy(h))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=1e-5)
    np.testing.assert_allclose(got_h.detach().numpy(), np.asarray(want_h),
                               atol=1e-5)


@pytest.mark.parametrize("train", [False, True])
def test_seq2seq_net_forward_matches_jax(train):
    """The whole net, teacher-forced for 4 frames: eval mode (running
    statistics) and train mode (the decoder step's batch norm on each of
    its 33 calls' batch statistics, chaining the running ones)."""
    system, state, _ = jax_setup(S2S)
    port = port_system(S2S)
    port.train(train)
    b = train_batch(S2S, 1)
    res = jax.jit(lambda v, *a: system.net.apply(
        v, *a, train=train, mutable=["batch_stats"] if train else False))(
        {"params": state.params, "batch_stats": state.batch_stats},
        b["word_seq"], b["word_lengths"], b["target"], b["vids"])
    want = res[0] if train else res
    got = port(torch.from_numpy(b["word_seq"]).long(),
               torch.from_numpy(b["word_lengths"]),
               torch.from_numpy(b["target"]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)
    np.testing.assert_array_equal(got.detach().numpy()[:, 0],
                                  b["target"][:, 0])
    if train:
        sd = port.state_dict()
        new = numpy_state(S2S, state.params, res[1]["batch_stats"])
        for k in ("running_mean", "running_var"):
            key = f"decoder.decoder.pre_linear.1.{k}"
            np.testing.assert_allclose(sd[key].numpy(), new[key],
                                       rtol=1e-4, atol=1e-6)


def test_train_step_matches_jax():
    """One Seq2SeqSystem step (Adam 0.9 / 0.999 after optax's clip at a
    global norm of 5) against the JAX system's own step; the loss's
    variance term is the norm over time."""
    system, state, _ = jax_setup(S2S)
    port = port_system(S2S)
    old = {k: v.detach().clone().numpy() for k, v in port.state_dict().items()}
    b = train_batch(S2S, 2)
    new_state, metrics = system.make_train_step()(
        state, {k: jnp.asarray(v) for k, v in b.items()},
        jax.random.PRNGKey(0))
    got = port.train_step(b, torch.Generator().manual_seed(0))
    assert set(got) == set(metrics) == {"loss"}
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]),
                               rtol=METRIC_RTOL)
    # the variance term: -sum over (B, pose_dim) of the norm over time
    out = port.eval_step(b, torch.Generator())[0]
    var = -torch.linalg.vector_norm(out, dim=1).sum() / out.numel()
    assert var.shape == () and float(var) < 0
    want_grads = numpy_state(S2S, recorded_grads(new_state.opt, port),
                             new_state.batch_stats)
    norm = np.sqrt(sum(float(np.sum(want_grads[k].astype(np.float64) ** 2))
                       for k, _ in port.named_parameters()))
    assert abs(norm - 5.0) < 1e-3, "the step's gradient should be clipped"
    cfg = port.cfg
    compare_step(got, metrics, port, old, want_grads,
                 numpy_state(S2S, new_state.params, new_state.batch_stats),
                 lr=cfg.learning_rate, d_lr=cfg.learning_rate, loose=(),
                 zero_grad=zero_grad_leaves(S2S))
    compare_second_moments(S2S, port, new_state, zero_grad_leaves(S2S))


def test_clip_follows_optax():
    """g / ||g|| * 5 at a norm of 5 or more, g as it is below."""
    for scale, clipped in ((1.0, False), (10.0, True)):
        p = torch.nn.Parameter(torch.zeros(3, 4))
        q = torch.nn.Parameter(torch.zeros(5))
        g = torch.arange(17, dtype=torch.float32) / 17 * scale
        p.grad, q.grad = g[:12].view(3, 4).clone(), g[12:].clone()
        norm = clip_grad_norm_optax_([p, q], 5.0)
        assert abs(float(norm) - float(g.norm())) < 1e-5
        want = g / g.norm() * 5.0 if clipped else g
        torch.testing.assert_close(torch.cat([p.grad.flatten(), q.grad]),
                                   want, rtol=0, atol=0)


def test_generate_matches_jax():
    """Three windows of word sequences (SOS..EOS, width 32), each window
    seeded with the last one's tail, cross-faded and smoothed across the
    joints, and faded out to the mean pose, against the JAX synthesizer."""
    system, state, _ = jax_setup(S2S)
    port = port_system(S2S)
    (jlang, _), (lang, _) = vocabs()
    audio, words, vids = clips(B=2, seconds=1.7, seed=5)
    want = JaxSynthesizer(system, state).generate(audio, words, jlang, vids,
                                                  fade_out=True)
    got = make_synthesizer(port, port.state_dict()).generate(
        audio, words, lang, vids, fade_out=True)
    assert got.shape == want.shape and got.shape[1] > 3 * S2S_POSES - 8
    np.testing.assert_allclose(got, np.asarray(want), atol=ATOL)
    smooth = polyfit_smooth(got[0], port.cfg)
    assert smooth.shape == got[0].shape


def test_state_conversion_matches_export_torch():
    """``convert.seq2seq_state`` of a JAX TrainState: the keys and values
    of ``export_seq2seq``, exactly, and the port's own state dict."""
    _, state, sd = jax_setup(S2S)
    params = jax.device_get(state.params)
    stats = jax.device_get(state.batch_stats)
    got = seq2seq_state(params, stats)
    want = et.export_seq2seq(params, stats, NL)
    assert got.keys() == want.keys() == sd.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], sd[k]), k
