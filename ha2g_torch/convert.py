"""Carry the JAX package's hierarchy parameters across to the port.

Input: the JAX ``HierarchySystem``'s ``params`` / ``batch_stats`` as nested
dicts of numpy arrays (flax module names as keys).  Output: a state dict
with the reference's torch key names (the layout of its ``gen_dict_*``,
``audio_dict``, ``text_dict`` and ``dis_dict``), which the port's modules
use.  Every conversion is a layout change only (so a tree of JAX
*gradients* converts to the port's ``.grad`` layout as well):

* Dense kernels (in, out) -> Linear weights (out, in);
* conv kernels (k.., in, out) -> (out, in, k..);
* direction-stacked GRU params (2, in, 3H) -> per-direction
  ``weight_ih_l{l}`` / ``weight_ih_l{l}_reverse`` (3H, in);
* weight-norm v (k, in, out) -> ``weight_v`` (out, in, k), g -> (out, 1, 1);
* batch norm scale/bias/mean/var -> weight/bias/running_mean/running_var;
* transposed-conv kernels (k, in, out) -> (in, out, k) with the spatial
  axis reversed (flax's ConvTranspose does not flip its kernel, torch's
  ConvTranspose1d does).

The FGD embedders convert the same way: ``embedding_net_pose_state`` (TED
Gesture's EmbeddingNet in pose mode) and ``motion_ae_state`` (TED
Expressive's MotionAE); so do the baselines' ``GanState`` trees {gen, dis}:
``multimodal_state`` and ``speech2gesture_state`` (``gen.*`` holds the
reference's ``gen_dict``, ``dis.*`` its ``dis_dict``); and the
single-network ``TrainState`` trees, whose state dict is the reference's
``gen_dict`` itself: ``seq2seq_state`` (``Seq2SeqNet``),
``embedding_net_full_state`` (joint_embedding's ``EmbeddingNet``), and
the two embedders above for gesture_autoencoder.  ``system_state`` picks
the conversion of a config's model.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _t(arr) -> torch.Tensor:
    return torch.from_numpy(np.array(arr, dtype=np.float32, copy=True))


def _linear(p: dict, sd: dict, key: str) -> None:
    sd[f"{key}.weight"] = _t(np.asarray(p["kernel"]).T)
    sd[f"{key}.bias"] = _t(p["bias"])


def _dense(p: dict, sd: dict, key: str) -> None:
    _linear(p["Dense_0"], sd, key)


def _conv(p: dict, sd: dict, key: str) -> None:
    k = np.asarray(p["kernel"])
    sd[f"{key}.weight"] = _t(np.moveaxis(k, (-1, -2), (0, 1)))
    if "bias" in p:
        sd[f"{key}.bias"] = _t(p["bias"])


def _bn(pp: dict, ss: dict, sd: dict, key: str) -> None:
    sd[f"{key}.weight"] = _t(pp["BatchNorm_0"]["scale"])
    sd[f"{key}.bias"] = _t(pp["BatchNorm_0"]["bias"])
    sd[f"{key}.running_mean"] = _t(ss["BatchNorm_0"]["mean"])
    sd[f"{key}.running_var"] = _t(ss["BatchNorm_0"]["var"])
    sd[f"{key}.num_batches_tracked"] = torch.tensor(0)


def _gru(p: dict, sd: dict, prefix: str, n_layers: int,
         bidirectional: bool = True) -> None:
    for layer in range(n_layers):
        for d, sfx in enumerate(("", "_reverse")[:1 + bidirectional]):
            s = f"_l{layer}{sfx}"
            sd[f"{prefix}.weight_ih{s}"] = _t(np.asarray(p[f"w_ih_l{layer}"])[d].T)
            sd[f"{prefix}.weight_hh{s}"] = _t(np.asarray(p[f"w_hh_l{layer}"])[d].T)
            sd[f"{prefix}.bias_ih{s}"] = _t(np.asarray(p[f"b_ih_l{layer}"])[d])
            sd[f"{prefix}.bias_hh{s}"] = _t(np.asarray(p[f"b_hh_l{layer}"])[d])


def _conv_transpose(p: dict, sd: dict, key: str) -> None:
    w = np.asarray(p["kernel"])[::-1].transpose(1, 2, 0)
    sd[f"{key}.weight"] = _t(w)
    sd[f"{key}.bias"] = _t(p["bias"])


def _weightnorm_conv(p: dict, sd: dict, key: str) -> None:
    sd[f"{key}.weight_v"] = _t(np.asarray(p["v"]).transpose(2, 1, 0))
    sd[f"{key}.weight_g"] = _t(np.asarray(p["g"]).reshape(-1, 1, 1))
    sd[f"{key}.bias"] = _t(p["b"])


def text_encoder_state(params: dict, n_layers: int,
                       prefix: str = "") -> dict[str, Any]:
    """TextEncoderTCN params -> reference TextEncoderTCN keys."""
    sd: dict[str, Any] = {f"{prefix}embedding.weight": _t(params["embedding"])}
    tcn = params["TemporalConvNet_0"]
    for i in range(n_layers):
        block = tcn[f"TemporalBlock_{i}"]
        key = f"{prefix}tcn.network.{i}"
        _weightnorm_conv(block["WeightNormConv1d_0"], sd, f"{key}.conv1")
        _weightnorm_conv(block["WeightNormConv1d_1"], sd, f"{key}.conv2")
        if "Conv_0" in block:
            _conv(block["Conv_0"], sd, f"{key}.downsample")
    _linear(params["Dense_0"], sd, f"{prefix}decoder")
    return sd


def generator_state(params: dict, n_layers: int) -> dict[str, Any]:
    """HierarchicalPoseGenerator params -> reference gen_dict keys."""
    sd = text_encoder_state(params["TextEncoderTCN_0"], n_layers,
                            prefix="text_encoder.")
    _gru(params["GRU_0"], sd, "gru", n_layers)
    _dense(params["Dense_0"], sd, "out.0")
    _dense(params["Dense_1"], sd, "out.2")
    if "SpeakerZ_0" in params:
        z = params["SpeakerZ_0"]
        sd["speaker_embedding.0.weight"] = _t(z["embedding"])
        _dense(z["Dense_0"], sd, "speaker_embedding.1")
        _dense(z["Dense_1"], sd, "speaker_mu")
        _dense(z["Dense_2"], sd, "speaker_logvar")
    return sd


def audio_encoder_state(params: dict, stats: dict, layers=(3, 4, 6, 3),
                        prefix: str = "") -> dict[str, Any]:
    """HierarchicalWavEncoder params + batch stats -> reference audio_dict
    keys (prefix 'feat_extractor.' for the checkpoint layout, '' for a bare
    ResNetSE)."""
    p, s = params["ResNetSE_0"], stats["ResNetSE_0"]
    sd: dict[str, Any] = {}
    _conv(p["Conv2d_0"]["Conv_0"], sd, f"{prefix}conv1")
    _bn(p["BatchNorm_0"], s["BatchNorm_0"], sd, f"{prefix}bn1")
    block_idx = 0
    for stage, n_blocks in enumerate(layers):
        for b in range(n_blocks):
            key = f"{prefix}layer{stage + 1}.{b}"
            bp = p[f"SEBasicBlock_{block_idx}"]
            bs = s[f"SEBasicBlock_{block_idx}"]
            _conv(bp["Conv2d_0"]["Conv_0"], sd, f"{key}.conv1")
            _bn(bp["BatchNorm_0"], bs["BatchNorm_0"], sd, f"{key}.bn1")
            _conv(bp["Conv2d_1"]["Conv_0"], sd, f"{key}.conv2")
            _bn(bp["BatchNorm_1"], bs["BatchNorm_1"], sd, f"{key}.bn2")
            _dense(bp["SELayer_0"]["Dense_0"], sd, f"{key}.se.fc.0")
            _dense(bp["SELayer_0"]["Dense_1"], sd, f"{key}.se.fc.2")
            if "Conv2d_2" in bp:
                _conv(bp["Conv2d_2"]["Conv_0"], sd, f"{key}.downsample.0")
                _bn(bp["BatchNorm_2"], bs["BatchNorm_2"], sd,
                    f"{key}.downsample.1")
            block_idx += 1
    for i, name in enumerate(("low", "mid", "high")):
        _conv(p[f"Conv2d_{i + 1}"]["Conv_0"], sd, f"{prefix}conv_{name}")
        _bn(p[f"BatchNorm_{i + 1}"], s[f"BatchNorm_{i + 1}"], sd,
            f"{prefix}bn_{name}")
        _dense(p[f"Dense_{i}"], sd, f"{prefix}fc_{name}")
    sd[f"{prefix}speaker_embedding.0.weight"] = _t(p["speaker_embedding"])
    _dense(p["Dense_3"], sd, f"{prefix}speaker_embedding.1")
    _dense(p["Dense_4"], sd, f"{prefix}fc1")
    _dense(p["Dense_5"], sd, f"{prefix}fc2")
    return sd


def discriminator_state(params: dict, stats: dict) -> dict[str, Any]:
    """ConvDiscriminator params + batch stats -> reference dis_dict keys
    (hierarchy_net.py:197-242)."""
    sd: dict[str, Any] = {}
    _conv(params["Conv1d_0"]["Conv_0"], sd, "pre_conv.0")
    _bn(params["BatchNorm_0"], stats["BatchNorm_0"], sd, "pre_conv.1")
    _conv(params["Conv1d_1"]["Conv_0"], sd, "pre_conv.3")
    _bn(params["BatchNorm_1"], stats["BatchNorm_1"], sd, "pre_conv.4")
    _conv(params["Conv1d_2"]["Conv_0"], sd, "pre_conv.6")
    _gru(params["GRU_0"], sd, "gru", 4)
    _dense(params["Dense_0"], sd, "out")
    _dense(params["Dense_1"], sd, "out2")
    return sd


def hierarchy_state(params: dict, batch_stats: dict,
                    n_layers: int) -> dict[str, Any]:
    """The JAX HierarchySystem's params/batch_stats -> the port's
    HierarchySystem state dict (``audio.*``, ``gens.{l}.*``, the standalone
    text encoder ``text.*`` and the discriminator ``dis.*``)."""
    sd = {f"audio.{k}": v for k, v in audio_encoder_state(
        params["audio"], batch_stats["audio"],
        prefix="feat_extractor.").items()}
    for level, gen in enumerate(params["gens"]):
        sd.update({f"gens.{level}.{k}": v
                   for k, v in generator_state(gen, n_layers).items()})
    sd.update({f"text.{k}": v for k, v in
               text_encoder_state(params["text"], n_layers).items()})
    sd.update({f"dis.{k}": v for k, v in discriminator_state(
        params["dis"], batch_stats["dis"]).items()})
    return sd


def _conv_norm_relu(p: dict, s: dict, sd: dict, key: str) -> None:
    _conv(p["Conv1d_0"]["Conv_0"], sd, f"{key}.0")
    _bn(p["BatchNorm_0"], s["BatchNorm_0"], sd, f"{key}.1")


def _pose_encoder(p: dict, s: dict, sd: dict, prefix: str) -> None:
    """PoseEncoderConv / MotionEncoderConv -> the reference's
    PoseEncoderConv keys (embedding_net.py:42-82)."""
    for i in range(3):
        _conv_norm_relu(p[f"ConvNormRelu1d_{i}"], s[f"ConvNormRelu1d_{i}"],
                        sd, f"{prefix}.net.{i}")
    _conv(p["Conv1d_0"]["Conv_0"], sd, f"{prefix}.net.3")
    _dense(p["Dense_0"], sd, f"{prefix}.out_net.0")
    _bn(p["BatchNorm_0"], s["BatchNorm_0"], sd, f"{prefix}.out_net.1")
    _dense(p["Dense_1"], sd, f"{prefix}.out_net.3")
    _bn(p["BatchNorm_1"], s["BatchNorm_1"], sd, f"{prefix}.out_net.4")
    _dense(p["Dense_2"], sd, f"{prefix}.out_net.6")
    if "Dense_3" in p:
        _dense(p["Dense_3"], sd, f"{prefix}.fc_mu")
        _dense(p["Dense_4"], sd, f"{prefix}.fc_logvar")


def _pose_decoder(p: dict, s: dict, sd: dict, prefix: str) -> None:
    """PoseDecoderConv / MotionDecoderConv -> the reference's
    PoseDecoderConv keys (embedding_net.py:165-217)."""
    _dense(p["Dense_0"], sd, f"{prefix}.pre_net.0")
    _bn(p["BatchNorm_0"], s["BatchNorm_0"], sd, f"{prefix}.pre_net.1")
    _dense(p["Dense_1"], sd, f"{prefix}.pre_net.3")
    _conv_transpose(p["ConvTranspose_0"], sd, f"{prefix}.net.0")
    _bn(p["BatchNorm_1"], s["BatchNorm_1"], sd, f"{prefix}.net.1")
    _conv_transpose(p["ConvTranspose_1"], sd, f"{prefix}.net.3")
    _bn(p["BatchNorm_2"], s["BatchNorm_2"], sd, f"{prefix}.net.4")
    _conv(p["Conv1d_0"]["Conv_0"], sd, f"{prefix}.net.6")
    _conv(p["Conv1d_1"]["Conv_0"], sd, f"{prefix}.net.7")


def embedding_net_pose_state(params: dict, batch_stats: dict
                             ) -> dict[str, Any]:
    """EmbeddingNet(mode="pose") params + batch stats -> the reference's
    gen_dict keys (``pose_encoder.*``, ``decoder.*``)."""
    sd: dict[str, Any] = {}
    _pose_encoder(params["PoseEncoderConv_0"],
                  batch_stats["PoseEncoderConv_0"], sd, "pose_encoder")
    _pose_decoder(params["PoseDecoderConv_0"],
                  batch_stats["PoseDecoderConv_0"], sd, "decoder")
    return sd


def motion_ae_state(params: dict, batch_stats: dict) -> dict[str, Any]:
    """MotionAE params + batch stats -> the reference's motion_ae keys
    (``encoder.*``, ``decoder.*``)."""
    sd: dict[str, Any] = {}
    _pose_encoder(params["MotionEncoderConv_0"],
                  batch_stats["MotionEncoderConv_0"], sd, "encoder")
    _pose_decoder(params["MotionDecoderConv_0"],
                  batch_stats["MotionDecoderConv_0"], sd, "decoder")
    return sd


def _n_layers(gru: dict) -> int:
    return sum(k.startswith("w_ih_l") for k in gru)


def _prefixed(prefix: str, sd: dict) -> dict[str, Any]:
    return {f"{prefix}{k}": v for k, v in sd.items()}


def wav_encoder_state(params: dict, stats: dict, sd: dict,
                      prefix: str = "audio_encoder") -> None:
    """WavEncoder params + batch stats -> the reference's
    ``feat_extractor`` Sequential keys (multimodal_context_net.py:9-28)."""
    for i, slot in enumerate((0, 3, 6, 9)):
        _conv(params[f"Conv1d_{i}"]["Conv_0"], sd,
              f"{prefix}.feat_extractor.{slot}")
    for i, slot in enumerate((1, 4, 7)):
        _bn(params[f"BatchNorm_{i}"], stats[f"BatchNorm_{i}"], sd,
            f"{prefix}.feat_extractor.{slot}")


def multimodal_state(params: dict, batch_stats: dict) -> dict[str, Any]:
    """The JAX MultimodalGanSystem's params / batch_stats {gen, dis} -> the
    port's state dict: ``gen.*`` the reference's PoseGenerator keys,
    ``dis.*`` its ConvDiscriminator keys."""
    gen, gen_stats = params["gen"], batch_stats["gen"]
    sd = generator_state(gen, _n_layers(gen["GRU_0"]))
    wav_encoder_state(gen["WavEncoder_0"], gen_stats["WavEncoder_0"], sd)
    return {**_prefixed("gen.", sd), **_prefixed(
        "dis.", discriminator_state(params["dis"], batch_stats["dis"]))}


def _s2g_cnr(p: dict, s: dict, sd: dict, key: str) -> None:
    _conv(p["Conv_0"], sd, f"{key}.0")
    _bn(p["BatchNorm_0"], s["BatchNorm_0"], sd, f"{key}.1")


def s2g_generator_state(params: dict, stats: dict) -> dict[str, Any]:
    """speech2gesture Generator params + batch stats -> the reference's
    keys (speech2gesture.py:200-231).  flax names the AudioEncoder's
    ConvNormRelus in call order: first_net 0-7, then down1.0, down1.1,
    down2 .. down6 as 8-14."""
    sd: dict[str, Any] = {}
    ae_p, ae_s = params["AudioEncoder_0"], stats["AudioEncoder_0"]
    keys = [f"first_net.{i}" for i in range(8)] + \
        ["down1.0", "down1.1"] + [f"down{i}" for i in range(2, 7)]
    for i, key in enumerate(keys):
        _s2g_cnr(ae_p[f"ConvNormRelu_{i}"], ae_s[f"ConvNormRelu_{i}"], sd,
                 f"audio_encoder.{key}")
    for i in range(5):
        _s2g_cnr(ae_p[f"UnetUp_{i}"]["ConvNormRelu_0"],
                 ae_s[f"UnetUp_{i}"]["ConvNormRelu_0"], sd,
                 f"audio_encoder.up{i + 1}.conv")
    _dense(params["Dense_0"], sd, "pre_pose_encoder.0")
    _bn(params["BatchNorm_0"], stats["BatchNorm_0"], sd, "pre_pose_encoder.1")
    _dense(params["Dense_1"], sd, "pre_pose_encoder.3")
    for i in range(4):
        _s2g_cnr(params[f"ConvNormRelu_{i}"], stats[f"ConvNormRelu_{i}"], sd,
                 f"decoder.{i}")
    _conv(params["Conv_0"], sd, "final_out")
    return sd


def s2g_discriminator_state(params: dict, stats: dict) -> dict[str, Any]:
    """speech2gesture Discriminator params + batch stats -> the
    reference's ``net`` Sequential keys (speech2gesture.py:234-250)."""
    sd: dict[str, Any] = {}
    _conv(params["Conv_0"], sd, "net.0")
    _s2g_cnr(params["ConvNormRelu_0"], stats["ConvNormRelu_0"], sd, "net.2")
    _s2g_cnr(params["ConvNormRelu_1"], stats["ConvNormRelu_1"], sd, "net.3")
    _conv(params["Conv_1"], sd, "net.4")
    return sd


def speech2gesture_state(params: dict, batch_stats: dict) -> dict[str, Any]:
    """The JAX S2GSystem's params / batch_stats {gen, dis} -> the port's
    state dict (``gen.*``, ``dis.*``, the reference's key names)."""
    return {**_prefixed("gen.", s2g_generator_state(params["gen"],
                                                    batch_stats["gen"])),
            **_prefixed("dis.", s2g_discriminator_state(params["dis"],
                                                        batch_stats["dis"]))}


def _gru_cell(p: dict, sd: dict, prefix: str, n_layers: int) -> None:
    """GRUCell params (no direction axis) -> unidirectional torch keys."""
    for layer in range(n_layers):
        sd[f"{prefix}.weight_ih_l{layer}"] = _t(np.asarray(p[f"w_ih_l{layer}"]).T)
        sd[f"{prefix}.weight_hh_l{layer}"] = _t(np.asarray(p[f"w_hh_l{layer}"]).T)
        sd[f"{prefix}.bias_ih_l{layer}"] = _t(p[f"b_ih_l{layer}"])
        sd[f"{prefix}.bias_hh_l{layer}"] = _t(p[f"b_hh_l{layer}"])


def seq2seq_state(params: dict, batch_stats: dict) -> dict[str, Any]:
    """The JAX Seq2SeqNet's params / batch_stats -> the reference's
    Seq2SeqNet keys (seq2seq_net.py:219-254): ``encoder.*``,
    ``decoder.decoder.*``."""
    enc = params["MaskedBiGRUEncoder_0"]
    n_layers = _n_layers(enc)
    sd: dict[str, Any] = {"encoder.embedding.weight": _t(enc["embedding"])}
    _gru(enc, sd, "encoder.gru", n_layers)
    pref = "decoder.decoder"
    dec = params["decoder_step"]
    _dense(dec["Attn_0"]["Dense_0"], sd, f"{pref}.attn.attn")
    sd[f"{pref}.attn.v"] = _t(dec["Attn_0"]["v"])
    _dense(dec["Dense_0"], sd, f"{pref}.pre_linear.0")
    _bn(dec["BatchNorm_0"], batch_stats["decoder_step"]["BatchNorm_0"], sd,
        f"{pref}.pre_linear.1")
    _gru_cell(dec["GRUCell_0"], sd, f"{pref}.gru", n_layers)
    _dense(dec["Dense_1"], sd, f"{pref}.out")
    return sd


def embedding_net_full_state(params: dict, batch_stats: dict
                             ) -> dict[str, Any]:
    """The JAX joint_embedding EmbeddingNet's params / batch_stats -> the
    reference's keys (embedding_net.py:260-294): ``context_encoder.*``
    (TCN, waveform encoder, unidirectional GRU, head), ``pose_encoder.*``
    and ``decoder.*`` (PoseDecoderGRU)."""
    ctx, ctx_s = params["ContextEncoder_0"], batch_stats["ContextEncoder_0"]
    tcn = ctx["TextEncoderTCN_0"]
    sd = text_encoder_state(
        tcn, sum(k.startswith("TemporalBlock_")
                 for k in tcn["TemporalConvNet_0"]),
        prefix="context_encoder.text_encoder.")
    wav_encoder_state(ctx["WavEncoder_0"], ctx_s["WavEncoder_0"], sd,
                      "context_encoder.audio_encoder")
    _gru(ctx["GRU_0"], sd, "context_encoder.gru", _n_layers(ctx["GRU_0"]),
         bidirectional=False)
    _dense(ctx["Dense_0"], sd, "context_encoder.out.0")
    _bn(ctx["BatchNorm_0"], ctx_s["BatchNorm_0"], sd, "context_encoder.out.1")
    _dense(ctx["Dense_1"], sd, "context_encoder.out.3")
    _dense(ctx["Dense_2"], sd, "context_encoder.fc_mu")
    _dense(ctx["Dense_3"], sd, "context_encoder.fc_logvar")
    _pose_encoder(params["PoseEncoderConv_0"],
                  batch_stats["PoseEncoderConv_0"], sd, "pose_encoder")
    dec, dec_s = params["PoseDecoderGRU_0"], batch_stats["PoseDecoderGRU_0"]
    _dense(dec["Dense_0"], sd, "decoder.pre_pose_net.0")
    _bn(dec["BatchNorm_0"], dec_s["BatchNorm_0"], sd,
        "decoder.pre_pose_net.1")
    _dense(dec["Dense_1"], sd, "decoder.pre_pose_net.3")
    _gru(dec["GRU_0"], sd, "decoder.gru", _n_layers(dec["GRU_0"]))
    _dense(dec["Dense_2"], sd, "decoder.out.0")
    _dense(dec["Dense_3"], sd, "decoder.out.2")
    return sd


def system_state(model: str, params: dict, batch_stats: dict,
                 n_layers: int) -> dict[str, Any]:
    """The port's state dict of a JAX training system of ``model`` (a
    hierarchy's ``params["gens"]`` a list by level)."""
    if model == "hierarchy":
        return hierarchy_state(params, batch_stats, n_layers)
    convert = {"multimodal_context": multimodal_state,
               "speech2gesture": speech2gesture_state,
               "seq2seq": seq2seq_state,
               "joint_embedding": embedding_net_full_state}.get(model)
    if model == "gesture_autoencoder":
        convert = motion_ae_state if "MotionEncoderConv_0" in params \
            else embedding_net_pose_state
    if convert is None:
        raise ValueError(f"no conversion for model {model!r}")
    return convert(params, batch_stats)
