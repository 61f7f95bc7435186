"""The GAN baselines (multimodal_context, speech2gesture) through the
port's surfaces on the CPU at a narrow width (hidden 16, 2 GRU layers,
fp32): ``cli train`` for two epochs on stored synthetic clips (GAN steps
in the second), ``eval --bc`` and ``synthesize --fade_out``; a reference
``.bin`` written by ``ha2g_tpu.export_torch`` and a JAX checkpoint
directory written by ``ha2g_tpu.checkpoint`` read back bit for bit, and
``export-checkpoint`` equal to ``export_torch`` tensor for tensor; one
``GestureService`` request and one HTTP request each, equal to the direct
``generate`` on the same padded batch; a speech2gesture live stream
against ``generate`` (1e-4, the hierarchy stream's bound against its
batch path); a multimodal stream refused; and the families ported after
these two building, their generic checkpoints going out and back.
"""

import ast
import base64
import contextlib
import functools
import io
import json
import math
import types
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import tests.torch_cpu  # noqa: F401  (one torch thread)
from ha2g_tpu import checkpoint as jckpt
from ha2g_tpu import export_torch as et
from tests.torch_baselines import (CONFIGS, MM, N_SPK, S2G, clips,
                                   jax_config, jax_setup, port_config,
                                   vocabs)
from tests.torch_serving import (http_server,  # noqa: F401  (fixture)
                                 no_thread_outlives_module)

from ha2g_torch import checkpoint as ckpt
from ha2g_torch import cli
from ha2g_torch.config import Config
from ha2g_torch.data.storage import save_clips
from ha2g_torch.data.synthetic import synthetic_clips
from ha2g_torch.serve import GestureService
from ha2g_torch.skeleton import TED_GESTURE
from ha2g_torch.synthesis import _window_layout
from ha2g_torch.train.loop import build_system

FAMILIES = (MM, S2G)
SR = 16000
# the live stream against the batch path (tests/test_torch_streaming.py)
STREAM_VS_BATCH = 1e-4


def _quiet(argv):
    with contextlib.redirect_stdout(io.StringIO()) as out:
        assert cli.main(argv) == 0
    return out.getvalue()


@functools.cache
def _trained(root: Path, model: str) -> Path:
    """Two epochs of ``cli train`` (warm-up 0: GAN steps in epoch 1) on
    two stored 4 s clips per split; -> the output directory."""
    data = root / "data"
    if not data.exists():
        save_clips(data / "train", synthetic_clips(
            TED_GESTURE, n_clips=2, clip_seconds=4.0, seed=0))
        save_clips(data / "val", synthetic_clips(
            TED_GESTURE, n_clips=2, clip_seconds=4.0, seed=1))
    out = root / model
    _quiet(["train", "--config", str(CONFIGS[model]), "--device", "cpu",
            "--hidden_size", "16", "--n_layers", "2", "--batch_size", "4",
            "--compute_dtype", "float32", "--epochs", "2",
            "--loss_warmup", "0", "--random_seed", "0",
            "--train_data_path", str(data / "train"),
            "--test_data_path", str(data / "val"),
            "--model_save_path", str(out), "--eval_net_path", ""])
    return out


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tmp_path_factory.mktemp("baselines")


@pytest.mark.parametrize("model", FAMILIES)
def test_train_eval_synthesize(root, model, tmp_path):
    out = _trained(root, model)
    rows = [json.loads(ln) for ln in
            (out / "history.jsonl").read_text().splitlines()]
    assert [r["epoch"] for r in rows] == [0, 1, 2]
    assert all(np.isfinite(v) for r in rows for v in r.values())
    for name in ("checkpoint_best", "checkpoint_final"):
        state = ckpt.read_state(out / name)
        assert {"model", "g_opt", "d_opt", "step"} <= set(state)
    assert ckpt.read_state(out / "checkpoint_final")["step"] > 0
    printed = _quiet(["eval", str(out / "checkpoint_final"), "--bc",
                      "--clips", str(root / "data" / "val"),
                      "--device", "cpu"])
    metrics = ast.literal_eval(printed.strip().splitlines()[-1])
    assert {"loss", "joint_mae", "accel", "BC"} <= set(metrics)
    assert all(np.isfinite(v) for v in metrics.values())
    poses = {}
    for extra in ((), ("--fade_out",)):
        npz = tmp_path / f"s{len(extra)}.npz"
        _quiet(["synthesize", str(out / "checkpoint_final"), "--n", "2",
                "--clips", str(root / "data" / "val"), "--device", "cpu",
                "--out", str(npz), *extra])
        poses[extra] = np.load(npz)["dir_vec"]
        assert poses[extra].shape[::2] == (2, 27)
        assert np.isfinite(poses[extra]).all()
    plain, faded = poses[()], poses[("--fade_out",)]
    # the fade covers 2 n_pre frames from the start of the last window's
    # padding: none for the spectrogram model, the zero padding of the
    # last raw waveform window for the multimodal one
    cfg = port_config(model)
    n_samples = int(4.0 * SR)
    unit, stride, W = _window_layout(cfg, 4.0)
    a0 = math.floor((W - 1) * stride / 4.0 * n_samples)
    pad_s = 0.0 if model == S2G else \
        (int(unit * SR) - (n_samples - a0)) / SR
    start = plain.shape[1] - int(pad_s * cfg.motion_resampling_framerate)
    assert faded.shape[1] == max(plain.shape[1], start + 8)
    np.testing.assert_array_equal(faded[:, :start], plain[:, :start])
    assert not np.array_equal(faded[:, start:start + 8],
                              plain[:, start:start + 8])


def _jax_artifacts(tmp: Path, model: str):
    """A JAX checkpoint directory and a reference .bin of jax_setup's
    weights, written by the JAX package."""
    system, state, sd = jax_setup(model)
    (jlang, jspeaker), _ = vocabs()
    jcfg = jax_config(port_config(model))
    jckpt.save_checkpoint(tmp / "jax", state, jcfg, jlang, jspeaker,
                          extra={"epoch": 3})
    ref = et.export_generic_checkpoint(state, jcfg, jlang, jspeaker, epoch=3)
    torch.save(ref, tmp / "ref.bin")
    return sd, ref


@pytest.mark.parametrize("model", FAMILIES)
def test_reference_bin_and_jax_directory_read_exactly(model, tmp_path):
    sd, ref = _jax_artifacts(tmp_path, model)
    _quiet(["import-checkpoint", str(tmp_path / "ref.bin"),
            str(tmp_path / "imported"), "--device", "cpu"])
    imported = ckpt.read_state(tmp_path / "imported")["model"]
    assert imported.keys() == sd.keys()
    assert all(torch.equal(imported[k], v) for k, v in sd.items())
    assert ckpt.load_config(tmp_path / "imported")[0].model == model
    _, _, _, system = cli.load_checkpoint_system(str(tmp_path / "jax"), "cpu")
    got = system.state_dict()
    assert all(torch.equal(got[k], v) for k, v in sd.items())
    # the JAX directory exports to the .bin export_torch wrote
    _quiet(["export-checkpoint", str(tmp_path / "jax"),
            str(tmp_path / "out.bin"), "--device", "cpu"])
    out = torch.load(tmp_path / "out.bin", weights_only=False)
    assert out["args"].model == model and out["epoch"] == 3
    for name in ("gen_dict", "dis_dict"):
        assert out[name].keys() == ref[name].keys()
        assert all(torch.equal(out[name][k], v)
                   for k, v in ref[name].items()), name
    with pytest.raises(ValueError, match="cannot be resumed"):
        ckpt.load_state(tmp_path / "jax", system)


def _post(url, obj):
    req = urllib.request.Request(url, data=json.dumps(obj).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


@pytest.fixture(scope="module", params=FAMILIES)
def service(request, tmp_path_factory):
    model = request.param
    _, _, sd = jax_setup(model)
    _, (lang, speaker) = vocabs()
    port = build_system(port_config(model), lang.n_words, N_SPK,
                        device="cpu")
    port.load_state_dict(sd, strict=True)
    path = tmp_path_factory.mktemp(model) / "checkpoint"
    ckpt.save_checkpoint(path, port, port.cfg, lang, speaker)
    svc = GestureService(str(path), max_clip_seconds=3.0, max_batch=4,
                         batch_window_ms=200.0, warm=False, device="cpu")
    yield svc
    svc.close()


def test_service_and_http_request_equal_direct_generate(service):
    """A request through the service and over HTTP: the row of the direct
    ``generate`` call on the same padded batch, bit for bit (``fused`` is
    the window loop for a baseline)."""
    audio, words, _ = clips(B=1, seconds=3.0, seed=8)
    got = service.synthesize(audio[0], words[0], vid=1, fused=True)
    req = types.SimpleNamespace(audio=audio[0], words=words[0], vid=1)
    batch, batch_words, vids = service.padded_batch([req])
    want = service.synth.generate(batch, batch_words, service.lang, vids)
    n = int(round(3.0 * service.fps))
    assert got.shape == (n, 27)
    np.testing.assert_array_equal(got, want[0, :n])
    with http_server(service) as url:
        with urllib.request.urlopen(url + "/healthz", timeout=60) as r:
            assert json.loads(r.read())["model"] == service.cfg.model
        code, resp = _post(url + "/synthesize", {
            "audio": base64.b64encode(audio[0].tobytes()).decode(),
            "words": words[0], "vid": 1})
        assert code == 200, resp
        poses = np.frombuffer(base64.b64decode(resp["dir_vec"]), "<f4")
        np.testing.assert_array_equal(poses.reshape(resp["shape"]), got)
        code, resp = _post(url + "/stream/open", {"vid": 0})
        if service.cfg.model == MM:
            assert code == 500 and "spec-windowed" in resp["error"]
        else:
            assert code == 200 and "stream_id" in resp
    assert service.stats["errors"] == 0


def test_stream_against_generate_or_refused(service):
    """speech2gesture streams (chunks of 0.3 s, the length unknown) within
    STREAM_VS_BATCH of ``generate``; multimodal_context is refused."""
    _, (lang, _) = vocabs()
    if service.cfg.model == MM:
        with pytest.raises(ValueError, match="spec-windowed"):
            service.open_stream(0)
        with pytest.raises(ValueError, match="spectrogram-windowed"):
            service.synth.stream(lang, 0)
        return
    audio, words, _ = clips(B=1, seconds=5.3, seed=9)
    want = service.synth.generate(audio, words, lang, np.array([2]))[0]
    stream = service.synth.stream(lang, 2)
    stream.feed(words=words[0])
    step = int(0.3 * SR)
    outs = [stream.feed(audio[0, i:i + step])
            for i in range(0, audio.shape[1], step)]
    got = np.concatenate(outs + [stream.finish()])
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=STREAM_VS_BATCH)


@pytest.mark.parametrize("model", ("seq2seq", "joint_embedding",
                                   "gesture_autoencoder"))
def test_families_left_raise_naming_a5(model, tmp_path):
    """The families that once raised here (ROADMAP A.5) are ported: each
    builds with the JAX package's batch keys; seq2seq's and
    joint_embedding's generic reference checkpoint goes out and back
    tensor for tensor, and an embedder's, which is not a generic one,
    raises ValueError."""
    from ha2g_torch import reference_ckpt as rc
    cfg = Config(model=model, hidden_size=8, n_layers=1, wordembed_dim=8)
    system = build_system(cfg, 8, 2, device="cpu")
    assert system.batch_keys == {
        "seq2seq": ("word_seq", "word_lengths", "target", "vids"),
        "joint_embedding": ("text", "audio", "target", "vids"),
        "gesture_autoencoder": ("target", "vids")}[model]
    state = system.state_dict()
    if model == "gesture_autoencoder":
        with pytest.raises(ValueError, match="no generic importer"):
            rc.import_generic_checkpoint({"gen_dict": state}, cfg)
        return
    ref = rc.export_generic_checkpoint(state, cfg)
    assert set(ref["gen_dict"]) == set(state) and "dis_dict" not in ref
    back = rc.import_generic_checkpoint(ref, cfg)
    assert all(torch.equal(back[k], v) for k, v in state.items())
